"""The DRO parity harness shared by ``tests/test_torch_dro.py`` (reduced
qwen2-0.5b), ``tests/test_torch_dro_blocks.py`` (reduced mamba2-1.3b and
recurrentgemma-9b) and ``tests/test_torch_dro_frontends.py`` (reduced
granite-moe-1b-a400m, musicgen-medium and internvl2-76b): the reference's
inputs (codebook streams and prefix embeddings where the model takes
them), a state whose clients differ,
and the checks of the DRO value and its per-client gradients, one round on
``dense`` and the initial corrections of ``init_state``, each for one
architecture, in f32 compute, at the reference's own train-test sizes
(``tests/test_system.py::_args``: n = 2, K = 2, batch 2 × 32 tokens, 4
groups), on the reference's parameters (``models.interop``, stacked per
client) and batches.  Every reference run is cached per architecture.

The port runs one of three routes (``ROUTES``):

* ``"plain"`` — ``kernels=True`` on CPU tensors: ``kernels.ops`` sends
  every model kernel to its plain version;
* ``"functions"`` — the kernels' autograd Functions (``FlashAttentionFn``,
  ``SsdScanFn``, ``RglruScanFn``, ``FusedCrossEntropyFn``), their launch
  swapped for the plain forward (:func:`function_route`): the Functions'
  forwards, backwards and ``vmap`` rules, as the card runs them;
* ``"kernels_false"`` — ``kernels=False``, the plain route of the card's
  checks.

Tolerance: max |port − JAX| ≤ 1e-4·(1 + max|JAX|) (measured ≤ 1e-6: sum
orders).  In bf16 compute (:func:`check_one_round_bf16`, ``kernels=False``
on the port's side, the reference's form) a round is held to the bf16
limits of ``tests/test_torch_fsdp_mesh.py``: TOL_BF16_X = 1e-2 for x and
cx, TOL_BF16_Y = 2e-4 for y and cy; the reduced recurrentgemma-9b's
corrections to TOL_BF16_RG_CX = 3e-2 and TOL_BF16_RG_CY = 1e-3, since the
reference rounds its RG-LRU gradients in bf16 where the port does not
(ROADMAP §C quirk 7).
"""
import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import vmap

from repro.configs import registry as jax_registry
from repro.configs.base import AlgorithmConfig as JaxAlgorithmConfig
from repro.core import kgt_minimax as jax_kgt
from repro.core import objectives as jax_objectives
from repro.data import synthetic as jax_data
from repro.models import model as jax_model
from repro_torch.configs import AlgorithmConfig, registry
from repro_torch.core import KGTState, kgt_minimax as t_kgt
from repro_torch.core import objectives as t_objectives
from repro_torch.data import synthetic as t_data
from repro_torch.kernels import cross_entropy as t_ce
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as t_rg
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.models import interop
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_tf

TOL = 1e-4
TOL_BF16_X = 1e-2
TOL_BF16_Y = 2e-4
TOL_BF16_RG_CX = 3e-2
TOL_BF16_RG_CY = 1e-3
N, K, B, S, G = 2, 2, 2, 32, 4
ROUTES = ("plain", "functions", "kernels_false")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def batch_of(b):
    """A reference batch (numpy / jax arrays) -> the port's: integers as
    int64, prefix embeddings as f32."""
    out = {}
    for k, v in b.items():
        t = torch.tensor(np.asarray(v))
        out[k] = t if t.is_floating_point() else t.long()
    return out


def close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def close_trees(arch, got_x, want_x, tol, what=""):
    """The port's parameter dict against the reference's stacked pytree
    (one client at a time, through the interop's naming)."""
    tcfg = cfgs(arch)[1]
    for g, w in zip(interop.stacked_params_to_numpy(got_x, tcfg),
                    [jax.tree.map(lambda a: a[i], want_x)
                     for i in range(N)]):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(np_tree(w))):
            close(a, b, tol, what)


@functools.lru_cache(maxsize=None)
def cfgs(arch):
    """(the reference's, the port's) reduced config of ``arch``."""
    return (jax_registry.reduced(jax_registry.get_model_config(arch)),
            registry.reduced(registry.get_model_config(arch)))


def port_data_model(dm):
    return t_data.DataModel(
        domain_logits=torch.tensor(np.asarray(dm.domain_logits)),
        domain_shift=torch.tensor(np.asarray(dm.domain_shift)).long(),
        mixtures=torch.tensor(np.asarray(dm.mixtures)),
        vocab_size=dm.vocab_size, num_groups=dm.num_groups)


@functools.lru_cache(maxsize=None)
def reference_inputs(arch):
    """The reference's data model, initial parameters, an initial (n, B, S)
    batch and one round of (K, n, B, S) batches, each drawn under one
    ``jax.jit``."""
    jcfg = cfgs(arch)[0]
    kd, kx, kb = jax.random.split(jax.random.PRNGKey(0), 3)
    dm = jax.jit(functools.partial(
        jax_data.make_data_model, vocab_size=jcfg.vocab_size, num_groups=G,
        num_clients=N, alpha=0.3))(kd)
    x0 = jax.jit(functools.partial(jax_model.init_params, jcfg))(kx)

    def draw(local_steps, key):
        return np_tree(jax.jit(functools.partial(
            jax_data.round_batches, local_steps=local_steps, num_clients=N,
            per_client_batch=B, seq_len=S, cfg=jcfg))(dm, key))

    return dict(dm=dm, x0=np_tree(x0),
                init_b=jax.tree.map(lambda a: a[0], draw(1, kb)),
                batches=[draw(K, jax.random.fold_in(kb, 1))])


@functools.lru_cache(maxsize=None)
def f32_setup(arch):
    """Reference and port DRO problems in f32 compute, a state whose
    clients differ (x0 plus a per-client perturbation, y > 0, small
    corrections), and the reference's first round of batches."""
    jcfg, tcfg = cfgs(arch)
    ref_run = reference_inputs(arch)
    rng = np.random.default_rng(0)
    xs = [jax.tree.map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(
            np.float32), ref_run["x0"]) for _ in range(N)]
    x = jax.tree.map(lambda *a: np.stack(a), *xs)
    cx = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape)).astype(
        np.float32), x)
    y = rng.uniform(0.1, 1.0, (N, G)).astype(np.float32)
    cy = (1e-2 * rng.standard_normal((N, G))).astype(np.float32)
    jprob = jax_objectives.dro_problem(jcfg, num_groups=G, mu=1.0,
                                       compute_dtype=jnp.float32)
    tx = interop.stacked_params_from_reference(xs, tcfg, device="cpu")
    tcx = interop.stacked_params_from_reference(
        [jax.tree.map(lambda a: a[i], cx) for i in range(N)], tcfg,
        device="cpu")
    return dict(jprob=jprob, x=x, y=y, cx=cx, cy=cy, tx=tx, tcx=tcx,
                batches=ref_run["batches"][0])


def port_problem(arch, kernels=True, dtype=torch.float32):
    return t_objectives.dro_problem(cfgs(arch)[1], num_groups=G, mu=1.0,
                                    compute_dtype=dtype, kernels=kernels)


@contextlib.contextmanager
def function_route():
    """The model kernels' autograd Functions on CPU tensors: ``ops`` takes
    the kernel route, and each Function's launch is its plain forward,
    counted.  Yields the counts by kernel name."""
    counts = dict.fromkeys(("flash_attention", "ssd_scan", "rglru_scan",
                            "fused_cross_entropy"), 0)

    def counted(name, plain):
        def launch(*args):
            counts[name] += 1
            return plain(*args)
        return staticmethod(launch)

    with mock.patch.object(ops, "use_kernel", lambda backend, x: True), \
            mock.patch.object(t_fa.FlashAttentionFn, "launch", counted(
                "flash_attention", lambda q, k, v, causal, window, _:
                ref.attention_ref(q, k, v, causal=causal, window=window))), \
            mock.patch.object(t_ssd.SsdScanFn, "launch", counted(
                "ssd_scan", lambda x, la, bm, cm, s0, chunk, _:
                ref.ssd_chunked(x, la, bm, cm, chunk, s0))), \
            mock.patch.object(t_rg.RglruScanFn, "launch", counted(
                "rglru_scan", lambda a, u, _: ref.rglru_ref(a, u))), \
            mock.patch.object(t_ce.FusedCrossEntropyFn, "launch", counted(
                "fused_cross_entropy", lambda h, w, lab, _:
                ref.fused_ce_ref(h, w, lab))):
        yield counts


def route_context(route):
    """(context, kernels flag) of a route of ``ROUTES``."""
    if route not in ROUTES:
        raise ValueError(route)
    return ((function_route() if route == "functions"
             else contextlib.nullcontext({})), route != "kernels_false")


def grad_launches(arch, passes: int) -> dict:
    """The Functions' launches of ``passes`` vmapped evaluations of the DRO
    value over the clients: each block's kernel once a layer (the clients
    folded into its batch), the cross-entropy once a client (each its own
    head) and codebook."""
    cfg = cfgs(arch)[1]
    kinds = cfg.blocks()
    return {"flash_attention": passes * sum(k in t_tf.ATTN_KINDS
                                            for k in kinds),
            "ssd_scan": passes * kinds.count("ssm"),
            "rglru_scan": passes * kinds.count("rglru"),
            "fused_cross_entropy": passes * N * max(1, cfg.num_codebooks)}


@functools.lru_cache(maxsize=None)
def reference_value_and_grads(arch):
    st = f32_setup(arch)
    batch = jax.tree.map(lambda a: a[0], st["batches"])       # k = 0
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jprob = st["jprob"]
    want_v, (want_gx, want_gy) = jax.jit(jax.vmap(
        lambda *a: (jprob.value(*a), jprob.grads(*a))))(
        st["x"], st["y"], batch, keys)
    return batch, np.asarray(want_v), np_tree(want_gx), np.asarray(want_gy)


def check_value_and_grads(arch, route):
    """The DRO value and the per-client gradients (``_vgrads``) of a state
    whose clients differ, on the reference's k = 0 batch."""
    st = f32_setup(arch)
    batch, want_v, want_gx, want_gy = reference_value_and_grads(arch)
    ctx, kernels = route_context(route)
    prob = port_problem(arch, kernels)
    tb, ty = batch_of(batch), torch.tensor(st["y"])
    with ctx as counts:
        got_v = vmap(prob.value)(st["tx"], ty, tb, torch.zeros((N, 0)))
        got_gx, got_gy = t_kgt._vgrads(prob, st["tx"], ty, tb,
                                       torch.zeros((N, 0)))
    if route == "functions":
        assert counts == grad_launches(arch, 2), counts
    close(got_v.numpy(), want_v, TOL, "value")
    close(got_gy.numpy(), want_gy, TOL, "grad y")
    close_trees(arch, got_gx, want_gx, TOL, "grad x")


def _round_kw(algorithm):
    return dict(algorithm=algorithm, num_clients=N, local_steps=K,
                eta_cx=0.02, eta_cy=0.2, eta_sx=0.7, eta_sy=0.7,
                topology="ring", mixing_impl="dense")


@functools.lru_cache(maxsize=None)
def reference_round(arch, algorithm, dtype="float32"):
    st = f32_setup(arch)
    jstate = jax_kgt.KGTState(x=st["x"], y=st["y"], cx=st["cx"],
                              cy=st["cy"], round=jnp.int32(0))
    keys = jax.random.split(jax.random.PRNGKey(1), K * N).reshape(K, N, 2)
    jprob = (st["jprob"] if dtype == "float32" else
             jax_objectives.dro_problem(cfgs(arch)[0], num_groups=G, mu=1.0,
                                        compute_dtype=getattr(jnp, dtype)))
    want = jax.jit(jax_kgt.make_round_step(
        jprob, JaxAlgorithmConfig(**_round_kw(algorithm))))(
        jstate, st["batches"], keys)
    return np_tree(want)


def check_one_round(arch, algorithm, route="plain"):
    """One round on ``dense`` from a state whose clients differ, on the
    reference's first round of batches."""
    st = f32_setup(arch)
    want = reference_round(arch, algorithm)
    tstate = KGTState(x=st["tx"], y=torch.tensor(st["y"]), cx=st["tcx"],
                      cy=torch.tensor(st["cy"]), round=0)
    ctx, kernels = route_context(route)
    with ctx as counts:
        got = t_kgt.make_round_step(
            port_problem(arch, kernels),
            AlgorithmConfig(**_round_kw(algorithm)), device="cpu")(
            tstate, batch_of(st["batches"]), torch.zeros((K, N, 0)))
    if route == "functions":
        assert counts == grad_launches(arch, K), counts
    assert got.round == 1
    for name in ("y", "cy"):
        close(getattr(got, name).numpy(), getattr(want, name), TOL, name)
    close_trees(arch, got.x, want.x, TOL, "x")
    close_trees(arch, got.cx, want.cx, TOL, "cx")


def bf16_round_errors(arch, algorithm="kgt_minimax"):
    """max |port − JAX| / (1 + max|JAX|) of each field after one round in
    bf16 compute from :func:`f32_setup`'s state, ``kernels=False`` on the
    port's side (the reference's form)."""
    st = f32_setup(arch)
    want = reference_round(arch, algorithm, "bfloat16")
    tstate = KGTState(x=st["tx"], y=torch.tensor(st["y"]), cx=st["tcx"],
                      cy=torch.tensor(st["cy"]), round=0)
    got = t_kgt.make_round_step(
        port_problem(arch, kernels=False, dtype=torch.bfloat16),
        AlgorithmConfig(**_round_kw(algorithm)), device="cpu")(
        tstate, batch_of(st["batches"]), torch.zeros((K, N, 0)))

    def err(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        return float(np.abs(a - b).max()) / (1 + float(np.abs(b).max()))

    out = {name: err(getattr(got, name).numpy(), getattr(want, name))
           for name in ("y", "cy")}
    tcfg = cfgs(arch)[1]
    for name in ("x", "cx"):
        per_client = interop.stacked_params_to_numpy(getattr(got, name),
                                                     tcfg)
        out[name] = max(
            err(a, b) for i, g in enumerate(per_client)
            for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(
                jax.tree.map(lambda v: v[i], getattr(want, name)))))
    return out


def bf16_limits(arch):
    """The bf16 limits of a round's fields (module docstring)."""
    rg = arch == "recurrentgemma-9b"
    return dict(x=TOL_BF16_X, y=TOL_BF16_Y,
                cx=TOL_BF16_RG_CX if rg else TOL_BF16_X,
                cy=TOL_BF16_RG_CY if rg else TOL_BF16_Y)


@functools.lru_cache(maxsize=None)
def reference_init_state(arch):
    jcfg = cfgs(arch)[0]
    ref_run = reference_inputs(arch)
    algo = dict(algorithm="kgt_minimax", num_clients=N, local_steps=K)
    jprob = jax_objectives.dro_problem(jcfg, num_groups=G,
                                       compute_dtype=jnp.float32)
    jax_prob = jax_objectives.MinimaxProblem(
        init_x=lambda k: jax.tree.map(jnp.asarray, ref_run["x0"]),
        init_y=jprob.init_y, value=jprob.value, mu=jprob.mu)
    return np_tree(jax.jit(lambda ib: jax_kgt.init_state(
        jax_prob, JaxAlgorithmConfig(**algo), jax.random.PRNGKey(0),
        init_batch=ib))(ref_run["init_b"]))


def check_initial_corrections(arch, route="plain"):
    """``init_state`` on the LM: the replicated x0 and the corrections from
    the initial batch's gradients (Σ_i c_i = 0)."""
    tcfg = cfgs(arch)[1]
    ref_run = reference_inputs(arch)
    want = reference_init_state(arch)
    x0 = t_model.param_dict(interop.params_from_reference(
        ref_run["x0"], tcfg, device="cpu"))
    ctx, kernels = route_context(route)
    prob = port_problem(arch, kernels)
    prob = t_objectives.MinimaxProblem(
        init_x=lambda gen: x0, init_y=prob.init_y, value=prob.value,
        noise_dim=0, mu=prob.mu)
    with ctx as counts:
        got = t_kgt.init_state(
            prob, AlgorithmConfig(algorithm="kgt_minimax", num_clients=N,
                                  local_steps=K),
            torch.Generator(), init_batch=batch_of(ref_run["init_b"]))
    if route == "functions":
        assert counts == grad_launches(arch, 1), counts
    close(got.cy.numpy(), want.cy, TOL, "cy")
    close_trees(arch, got.cx, want.cx, TOL, "cx")
    close_trees(arch, got.x, want.x, 0.0, "x")
