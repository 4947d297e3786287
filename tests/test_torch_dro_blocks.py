"""The DRO problem on the other block kinds against the JAX package: the
reduced mamba2-1.3b (Mamba2 SSD blocks, kernel B7) and recurrentgemma-9b
(RG-LRU blocks, B8, and local attention, B5), in f32 compute, with
``tests/_torch_dro.py``'s harness: the DRO value and per-client gradients,
one ``dense`` kgt_minimax round and the initial corrections of
``init_state``, on the reference's parameters and batches.

The port runs each check on two routes: the kernels' autograd Functions
with their plain forward swapped in for the launch (``"functions"``: the
forwards, plain backwards and ``vmap`` rules the card runs, each kernel
launched once a layer with the clients folded into its batch and the
cross-entropy once a client), and ``kernels=False``.

Tolerance: max |port − JAX| ≤ 1e-4·(1 + max|JAX|).
"""
import _torch_threads  # noqa: F401
import pytest

import _torch_dro as h

ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
ROUTES = ("functions", "kernels_false")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dro_value_and_per_client_gradients_match_jax(arch, route):
    h.check_value_and_grads(arch, route)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_kgt_minimax_round_matches_jax(arch, route):
    h.check_one_round(arch, "kgt_minimax", route)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arch", ARCHS)
def test_initial_corrections_match_jax(arch, route):
    h.check_initial_corrections(arch, route)
