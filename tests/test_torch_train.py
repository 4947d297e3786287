"""The port's training slice (``repro_torch.launch.train`` and what it runs)
against the JAX package, on the reduced qwen2-0.5b at the reference's own
train-test sizes (``tests/test_system.py::_args``: n = 2, K = 2, batch 2 ×
32 tokens, 4 groups).  ``tests/test_torch_dro.py`` holds the DRO problem,
its gradients and rounds in f32 compute.

``torch.Generator`` cannot replay ``jax.random``, so the reference's draws
cross as arrays: the reference's ``train`` runs once, and what it draws
(its initial parameters, initial batch, held-out batch and each round's
batches) is caught on the way and fed to the port's ``build``; the
batches of ``round_batches`` and the held-out batch are built here from
the reference's draws through ``batch_from_draws`` and ``stack_round``.

Tolerances, max |port − JAX| ≤ tol·(1 + max|JAX|):
* the first logged rows of ``train`` (bf16 compute, as the reference
  trains): 2e-2 — the kernel route keeps attention's and the
  cross-entropy's logits in f32 where the reference rounds them to bf16
  (ROADMAP §C quirk 4), and the two frameworks round the backbone at other
  places; four rounds carry those differences into the iterates;
* schedules: 1e-6 (f64 on the host against f32 on the device);
  optimizers: 1e-6.

The port alone: the scan engine against the host loop record for record
(eagerly and through a fake CUDA graph), a checkpoint resume bit for bit,
a per-round W on the mesh and the unported compile cache refused, the
CLI, and the autograd Functions of B5 and B6 with the plain forward
swapped in for the launch:
their gradients under ``grad`` and ``vmap(grad)`` equal the plain
version's autograd, and their ``vmap`` rules launch as documented.
"""
import _torch_threads  # noqa: F401
import argparse
import functools
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import registry as jax_registry
from repro.data import synthetic as jax_data
from repro.engine import sampler as jax_sampler
from repro.launch import train as jax_train
from repro.optim import optimizers as jax_optim
from repro.optim import schedules as jax_schedules
from repro_torch import engine as engine_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import registry
from repro_torch.core import tree as tree_lib
from repro_torch.data import synthetic as t_data
from repro_torch.engine import engine as t_engine
from repro_torch.kernels import cross_entropy as t_ce
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as t_train
from repro_torch.models import interop
from repro_torch.models import model as t_model
from repro_torch.optim import optimizers as t_optim
from repro_torch.optim import schedules as t_schedules

TOL_BF16_ROWS = 2e-2
ARCH = "qwen2-0.5b"
N, K, B, S, G = 2, 2, 2, 32, 4
ARGS = dict(arch=ARCH, reduced=True, algorithm="kgt_minimax", rounds=4,
            clients=N, local_steps=K, batch=B, seq_len=S, groups=G, mu=1.0,
            alpha=0.3, eta_cx=0.02, eta_cy=0.2, eta_s=0.7, topology="ring",
            mixing_impl="dense", gossip_dtype="float32", schedule="constant",
            warmup=0, seed=0, log_every=2, checkpoint_every=0,
            checkpoint_dir="checkpoints/test", out=None, engine="scan",
            chunk=4)
ROW_KEYS = ("f_bar", "mean_loss", "eval_loss", "eval_group_loss",
            "consensus_x", "consensus_y", "corr_x_norm", "corr_y_norm",
            "y_bar_norm")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(b):
    """A reference batch (numpy / jax arrays) -> the port's (int64)."""
    return {k: torch.tensor(np.asarray(v)).long() for k, v in b.items()}


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def _close_trees(got_x, want_x, tol, what=""):
    """The port's parameter dict against the reference's stacked pytree
    (one leaf at a time, through the interop's naming)."""
    tcfg = _cfgs()[1]
    for g, w in zip(interop.stacked_params_to_numpy(got_x, tcfg),
                    [jax.tree.map(lambda a: a[i], want_x)
                     for i in range(N)]):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(_np(w))):
            _close(a, b, tol, what)


@functools.lru_cache(maxsize=None)
def _cfgs():
    return (jax_registry.reduced(jax_registry.get_model_config(ARCH)),
            registry.reduced(registry.get_model_config(ARCH)))


@functools.lru_cache(maxsize=None)
def _reference_run():
    """The reference's ``train`` on ``ARGS``: its logged history, and what
    it drew (its data model, initial state, initial batch, held-out batch,
    the sampler's batches of every round), caught on the way by wrapping
    the functions it calls."""
    caught = {}

    def spy(module, name):
        orig = getattr(module, name)

        def call(*args, **kw):
            out = orig(*args, **kw)
            # the first call is train's own; the state is copied out before
            # the engine donates its buffers
            caught.setdefault(name, _np(out) if name == "init_state"
                              else out)
            return out

        return mock.patch.object(module, name, call)

    with spy(jax_train.data_lib, "make_data_model"), \
            spy(jax_train.data_lib, "round_batches"), \
            spy(jax_train.kgt, "init_state"), \
            spy(jax_train.engine_lib, "make_dro_sampler"), \
            spy(jax_train.engine_lib, "held_out_eval_batch"):
        hist = jax_train.train(argparse.Namespace(**ARGS))["history"]
    sample = jax.jit(caught["make_dro_sampler"])
    state = caught["init_state"]
    return dict(dm=caught["make_data_model"],
                x0=jax.tree.map(lambda a: a[0], state.x), state=state,
                init_b=_np(jax.tree.map(lambda x: x[0],
                                        caught["round_batches"])),
                batches=[_np(sample(jnp.int32(t))[0])
                         for t in range(ARGS["rounds"])],
                eval_b=_np(caught["held_out_eval_batch"]), history=hist)


def _port_args(**over):
    args = t_train.parser().parse_args(["--arch", ARCH])
    for k, v in {**ARGS, "device": "cpu", **over}.items():
        setattr(args, k, v)
    return args


def _replay_sampler(batches):
    return lambda t: (_batch(batches[t]), torch.zeros((K, N, 0)))


def _port_from_reference(**over):
    """``launch.train.build`` keyword arguments that feed it the
    reference's draws."""
    ref_run = _reference_run()
    tcfg = _cfgs()[1]
    x0 = t_model.param_dict(interop.params_from_reference(
        ref_run["x0"], tcfg, device="cpu"))
    return dict(init_params=x0, init_batch=_batch(ref_run["init_b"]),
                sampler=_replay_sampler(ref_run["batches"]),
                eval_batch=_batch(ref_run["eval_b"]), **over)


# ---------------------------------------------------------------------------
# schedules, optimizers, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedules_match_jax(name, warmup):
    want = jax_schedules.get_schedule(name, 10, warmup)
    got = t_schedules.get_schedule(name, 10, warmup)
    for t in range(13):
        assert isinstance(got(t), float)
        assert got(t) == pytest.approx(float(want(t)), abs=1e-6), t
    # the train driver passes no schedule where it is 1 every round, so
    # the round step does not read the round and a captured chunk serves
    # every start
    args = argparse.Namespace(schedule=name, rounds=10, warmup=warmup)
    assert (t_train.lr_schedule(args) is None) == (name == "constant"
                                                   and warmup == 0)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_match_jax(name):
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    jopt, topt = jax_optim.get_optimizer(name), t_optim.get_optimizer(name)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_lib.tree_map(torch.tensor, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, 0.1)
        tp, ts = topt.update(tree_lib.tree_map(torch.tensor, g), ts, tp, 0.1)
    for a, b in zip(tree_lib.leaves(tp), jax.tree.leaves(jp)):
        _close(a.numpy(), b, 1e-6, name)


def _reference_client_draws(dm, key, client):
    """The draws of ``repro.data.synthetic.sample_client_batch`` (:84-103)
    from its key."""
    kg, kt, kb = jax.random.split(key, 3)
    g = jax.random.categorical(kg, jnp.log(dm.mixtures[client] + 1e-9),
                               shape=(B,))
    first = jax.random.categorical(kt, dm.domain_logits[g],
                                   shape=(S + 1, B)).T
    use = jax.random.bernoulli(kb, 0.5, first.shape)
    return (torch.tensor(np.asarray(a)) for a in (g, first, use))


def _port_data_model(dm):
    return t_data.DataModel(
        domain_logits=torch.tensor(np.asarray(dm.domain_logits)),
        domain_shift=torch.tensor(np.asarray(dm.domain_shift)).long(),
        mixtures=torch.tensor(np.asarray(dm.mixtures)),
        vocab_size=dm.vocab_size, num_groups=dm.num_groups)


def test_round_batches_and_held_out_batch_from_the_reference_draws():
    """``round_batches``' keys (K·n, one a local step and client) and the
    held-out batch's (K = 1, flattened to n·B): the port's stacking of
    ``batch_from_draws`` on the reference's draws is the reference's
    batch exactly."""
    dm = _reference_run()["dm"]
    tdm = _port_data_model(dm)
    key = jax.random.PRNGKey(5)
    for k_steps, held_out in ((K, False), (1, True)):
        keys = jax.random.split(key, k_steps * N).reshape(k_steps, N, 2)
        got = t_data.stack_round([
            [t_data.batch_from_draws(
                tdm, *(a.long() if a.dtype != torch.bool else a
                       for a in _reference_client_draws(dm, keys[k, i], i)))
             for i in range(N)] for k in range(k_steps)])
        if held_out:
            got = engine_lib.flatten_clients(got)
            want = jax_sampler.held_out_eval_batch(
                dm, key, num_clients=N, per_client_batch=B, seq_len=S)
        else:
            want = jax_data.round_batches(dm, key, local_steps=K,
                                          num_clients=N, per_client_batch=B,
                                          seq_len=S)
        for name in ("tokens", "labels", "groups"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


def test_dro_sampler_is_a_pure_function_of_the_round():
    """Stacked (K, n, B, S) batches with (K, n, 0) noise; round t redraws
    the same batch however often it is asked (a resume redraws its data),
    and another round draws another."""
    tdm = t_data.make_data_model(vocab_size=512, num_groups=G,
                                 num_clients=N, seed=3)
    sample = engine_lib.make_dro_sampler(tdm, 7, local_steps=K,
                                         num_clients=N, per_client_batch=B,
                                         seq_len=S)
    b3, noise = sample(3)
    assert noise.shape == (K, N, 0)
    for name in ("tokens", "labels", "groups"):
        assert b3[name].shape == (K, N, B, S)
        assert torch.equal(b3[name], sample(3)[0][name])
    assert not torch.equal(b3["tokens"], sample(4)[0]["tokens"])
    assert torch.equal(b3["labels"][..., :-1], b3["tokens"][..., 1:])
    held = engine_lib.held_out_eval_batch(
        tdm, torch.Generator().manual_seed(1), num_clients=N,
        per_client_batch=B, seq_len=S)
    assert held["tokens"].shape == (N * B, S)


# ---------------------------------------------------------------------------
# the train entry point
# ---------------------------------------------------------------------------

def test_first_logged_rows_of_train_match_jax(capsys):
    """``train`` fed the reference's draws (bf16 compute, as the reference
    trains): the logged rows of rounds 0, 2 and 3, the held-out group
    losses a list of G, and the console rows."""
    want = _reference_run()["history"]
    kw = _port_from_reference()
    capsys.readouterr()     # the reference's own console rows
    res = t_train.train(_port_args(), **kw)
    got = res["history"]
    assert [r["round"] for r in got] == [r["round"] for r in want] == [0, 2,
                                                                        3]
    for g, w in zip(got, want):
        assert isinstance(g["eval_group_loss"], list)
        assert len(g["eval_group_loss"]) == G
        for key in ROW_KEYS:
            _close(g[key], w[key], TOL_BF16_ROWS, (g["round"], key))
    err = capsys.readouterr().err
    assert err.count("[train] round") == 3 and "ℓ_eval=" in err


def _strip(history):
    return [{k: v for k, v in r.items()
             if k not in ("wall_s", "build_s", "capture_s", "run_s")}
            for r in history]


class FakeGraph:
    """A CUDA graph's protocol on the CPU (as ``tests/test_torch_engine.py``):
    capture runs the body and stores nothing, a replay runs it again
    uncounted and stores; a captured graph has a pool, so a runner's later
    graphs capture without a warm-up, as on the card."""

    capturing = False

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        self.fn = fn
        self.capturing = True
        try:
            fn()
        finally:
            self.capturing = False
        self.pool = "pool"

    def replay(self):
        with ops.uncounted():
            self.fn()

    def write(self, dst, src):
        if not self.capturing:
            dst.copy_(src)


@functools.lru_cache(maxsize=None)
def _host_engine_run():
    """``--engine host`` on 4 rounds: what both cases below are held to."""
    return t_train.train(_port_args(rounds=4, engine="host", log_every=2))


@pytest.mark.parametrize("capture", [False, True])
def test_scan_engine_history_matches_host_engine(monkeypatch, capture):
    """--engine scan and --engine host: the same records and the same final
    state bit for bit, eagerly and through captured chunks (a fake graph:
    the chunk over the static buffers, the vector row included)."""
    if capture:
        monkeypatch.setattr(t_engine.ChunkRunner, "graph_type", FakeGraph)
        monkeypatch.setattr(t_train.Trainer, "build_chunk",
                            lambda self, args, capture=None:
                            engine_lib.make_chunk_builder(
                                self.round_step, self.sampler,
                                self.metrics_fn, log_every=args.log_every,
                                capture=True, donate=True))
    scan = t_train.train(_port_args(rounds=4, chunk=3, log_every=2))
    host = _host_engine_run()
    assert [r["round"] for r in scan["history"]] == [0, 2, 3]
    assert _strip(scan["history"]) == _strip(host["history"])
    for a, b in zip(tree_lib.leaves(scan["state"]),
                    tree_lib.leaves(host["state"])):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_checkpoint_resume_is_bit_for_bit(tmp_path):
    args = _port_args(rounds=4, chunk=4, log_every=1, checkpoint_every=2,
                      checkpoint_dir=str(tmp_path))
    full = t_train.train(args)
    trainer = t_train.build(args)
    restored = ckpt_lib.restore(str(tmp_path / "round_000002.npz"),
                                trainer.state)
    assert restored.round == 2
    resumed, hist = engine_lib.run(restored, trainer.build_chunk(args),
                                   total_rounds=4, chunk_rounds=4)
    for a, b in zip(tree_lib.leaves(resumed), tree_lib.leaves(full["state"])):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert _strip(hist) == _strip(full["history"][2:])


@pytest.mark.parametrize("over,error,match", [
    # the mesh runs (tests/test_torch_mesh_train.py); a per-round W on it
    # is refused as the reference refuses it (repro/launch/train.py:254)
    (dict(mesh="decentralized", topology_family="erdos_renyi"), ValueError,
     "not supported with --mesh decentralized"),
    (dict(compile_cache="on"), NotImplementedError, "A8")],
    ids=["mesh-decentralized", "compile_cache-on"])
def test_unported_mesh_and_compile_cache_are_refused(over, error, match):
    with pytest.raises(error, match=match):
        t_train.build(_port_args(**over))


def test_cli_runs_and_writes_its_history(tmp_path, capsys):
    out = tmp_path / "hist.json"
    t_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                  "--clients", "2", "--local-steps", "2", "--batch", "2",
                  "--seq-len", "32", "--groups", "4", "--rounds", "3",
                  "--log-every", "1", "--out", str(out)])
    hist = json.loads(out.read_text())["history"]
    assert [r["round"] for r in hist] == [0, 1, 2]
    assert all(len(r["eval_group_loss"]) == 4 for r in hist)
    assert capsys.readouterr().err.count("[train] round") == 3


# ---------------------------------------------------------------------------
# the autograd Functions of B5 and B6, the plain forward in the launch
# ---------------------------------------------------------------------------

@pytest.fixture
def plain_launches(monkeypatch):
    """Each Function's launch swapped for the plain version, counting."""
    counts = {"flash_attention": 0, "fused_cross_entropy": 0}

    def fa(q, k, v, causal, window, force_route):
        counts["flash_attention"] += 1
        return ref.attention_ref(q, k, v, causal=causal, window=window)

    def ce(h, w, lab, force_route):
        counts["fused_cross_entropy"] += 1
        return ref.fused_ce_ref(h, w, lab)

    monkeypatch.setattr(t_fa.FlashAttentionFn, "launch", staticmethod(fa))
    monkeypatch.setattr(t_ce.FusedCrossEntropyFn, "launch", staticmethod(ce))
    return counts


def _attention_case():
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((3, 2, 9, 4, 8), (3, 2, 9, 2, 8), (3, 2, 9, 2, 8)))
    wts = torch.tensor(rng.standard_normal((2, 9, 4, 8)).astype(np.float32))

    def loss(fn):
        return lambda q, k, v: (fn(q, k, v, causal=True, window=4)
                                * wts).sum()

    return (q, k, v), loss(t_fa.flash_attention_bshd), \
        loss(ref.attention_ref), (0, 0, 0), 1


def _ce_case(shared_head):
    rng = np.random.default_rng(4)
    h = torch.tensor(rng.standard_normal((3, 7, 8)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((3, 30, 8)).astype(np.float32))
    lab = torch.tensor(rng.integers(0, 30, (3, 7)))
    wts = torch.arange(7, dtype=torch.float32)

    def loss(fn):
        return lambda h, w, lab: (fn(h, w, lab) * wts).sum()

    if shared_head:
        return (h, w[0], lab), loss(t_ce.fused_ce_nd), loss(
            ref.fused_ce_ref), (0, None, 0), 1
    return (h, w, lab), loss(t_ce.fused_ce_nd), loss(ref.fused_ce_ref), \
        (0, 0, 0), 3


@pytest.mark.parametrize("case", ["attention", "ce", "ce_shared_head"])
@pytest.mark.parametrize("transform", ["grad", "vmap_grad"])
def test_autograd_functions_match_the_plain_gradient(plain_launches, case,
                                                     transform):
    """The Function's gradient (the plain version's closed form) against
    autograd through the plain version, under ``grad`` and
    ``vmap(grad)``; under vmap, attention folds the clients into one
    launch, the cross-entropy launches once a client whose head is its own
    and once in all for a shared head."""
    args, fn, plain_fn, in_dims, vmap_launches = (
        _attention_case() if case == "attention"
        else _ce_case(case == "ce_shared_head"))
    argnums = (0, 1, 2) if case == "attention" else (0, 1)
    name = "flash_attention" if case == "attention" else "fused_cross_entropy"
    if transform == "grad":
        args = tuple(a if d is None else a[0] for a, d in zip(args, in_dims))
        got = grad(fn, argnums=argnums)(*args)
        want = grad(plain_fn, argnums=argnums)(*args)
        assert plain_launches[name] == 1
    else:
        got = vmap(grad(fn, argnums=argnums), in_dims=in_dims)(*args)
        want = vmap(grad(plain_fn, argnums=argnums), in_dims=in_dims)(*args)
        assert plain_launches[name] == vmap_launches
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * (
            1 + float(w.abs().max())))
