"""A client's weights over the training mesh's fsdp and model axes
(``launch.steps.build_train_round`` at ``(clients 2, fsdp 2, model 2)``,
``dist.tensor_parallel.ClientShard``) against the JAX package's unsharded
round and the port's host path, on the reduced qwen2-0.5b (2 layers, d 256,
4 heads, 2 KV heads, vocab 512), n = 2, K = 2, 4 × 32 tokens a client, 4
groups, two rounds from a state whose clients differ.

One world of 8 gloo ranks is spawned for the file and runs every case
and check (``_torch_fsdp_mesh_worker.run``); the reference's rounds
(``repro.core.kgt_minimax.make_round_step`` on
``repro.core.objectives.dro_problem``, jitted: GSPMD's sharded program
computes that round) are compiled here while the world runs.  The f32
cases run the port's kernels' plain versions (``kernels=True`` on CPU
tensors: B6's vocab-parallel partials, ``ref.ce_partials_ref``); the bf16
cases ``kernels=False``, the reference's form (logits in bf16, ROADMAP §C
quirk 4), on both sides.

Tolerances, stated before the first reading, max |got − want| ≤
tol·(1 + max|want|):
* f32: TOL_F32 = 1e-4;
* bf16 compute: TOL_BF16_X = 1e-2 for x and cx, TOL_BF16_Y = 2e-4 for y
  and cy (PERF.md §2's limits);
* Σ_i c_i over the clients: TOL_SIGMA_C = 1e-5;
* int8 compression: its quantizer's q on a rank's pieces (the row's max
  taken over the block) is the whole row's bit for bit; the compressed
  round's x, y and cy at TOL_F32, its cx by Σc (a Δ one f32 ulp apart
  may round to another int8 step, which the correction scales by
  1/(K·η_c): ROADMAP §C, "Rounding in the chip checks").
"""
import _torch_threads  # noqa: F401
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.base import AlgorithmConfig as JaxAlgorithmConfig
from repro.core import kgt_minimax as jax_kgt
from repro.core import objectives as jax_objectives
from repro.data import synthetic as jax_data
from repro.models import model as jax_model
from repro_torch.configs import registry
from repro_torch.configs.base import AlgorithmConfig, MeshConfig
from repro_torch.core import KGTState
from repro_torch.core import compression, packing
from repro_torch.core import kgt_minimax as t_kgt
from repro_torch.core import objectives as t_objectives
from repro_torch.dist import launch as dist_launch
from repro_torch.dist import tensor_parallel as tp
from repro_torch.launch import steps
from repro_torch.models import interop

import _torch_fsdp_mesh_worker as worker

TOL_F32 = 1e-4
TOL_BF16_X = 1e-2
TOL_BF16_Y = 2e-4
TOL_SIGMA_C = 1e-5
ARCH = worker.ARCH
N, K, B, S, G, ROUNDS = 2, 2, 4, 32, 4, 2
F, M = worker.MESH[1], worker.MESH[2]
ALGO = dict(eta_cx=0.02, eta_cy=0.2, eta_sx=0.7, eta_sy=0.7,
            topology="ring")
# (name, mixing_impl, algorithm, compute dtype, kernels, gossip_compress)
CASES = [
    ("dense", "dense", "kgt_minimax", "float32", True, None),
    ("pallas_packed", "pallas_packed", "kgt_minimax", "float32", True, None),
    ("sparse_packed", "sparse_packed", "kgt_minimax", "float32", True, None),
    ("sparse_packed_gt_gda", "sparse_packed", "gt_gda", "float32", True,
     None),
    ("pallas_packed_bf16", "pallas_packed", "kgt_minimax", "bfloat16",
     False, None),
    ("pallas_packed_int8", "pallas_packed", "kgt_minimax", "float32", True,
     "int8"),
    ("dense_batch", "dense", "kgt_minimax", "float32", True, None),
    ("dense_no_remat", "dense", "kgt_minimax", "float32", True, None),
    ("pallas_packed_bf16_no_remat", "pallas_packed", "kgt_minimax",
     "bfloat16", False, None),
    ("replicated", "pallas_packed", "kgt_minimax", "float32", True, None),
    ("replicated_batch", "sparse_packed", "kgt_minimax", "float32", True,
     None),
    ("replicated_bf16", "pallas_packed", "kgt_minimax", "bfloat16", False,
     None),
    ("replicated_bf16_batch", "dense", "kgt_minimax", "bfloat16", False,
     None),
]
NAMES = [c[0] for c in CASES]
# MeshConfig.residual_mode of a case: the sequence split over model
# ("batch_seq", the default), or the residual whole ("batch")
RESIDUAL = {"dense_batch": "batch", "replicated_batch": "batch",
            "replicated_bf16_batch": "batch"}
# more MeshConfig fields of a case: activation checkpointing off (on by
# default, as the reference's), the weights whole on every rank of the
# block
MESH_KW = {"dense_no_remat": dict(remat=False),
           "pallas_packed_bf16_no_remat": dict(remat=False),
           **{name: dict(param_mode="replicated") for name in (
               "replicated", "replicated_batch", "replicated_bf16",
               "replicated_bf16_batch")}}
REPLICATED = [name for name, kw in MESH_KW.items() if "param_mode" in kw]
# (remat on, remat off): the same case
REMAT_PAIRS = [("dense", "dense_no_remat"),
               ("pallas_packed_bf16", "pallas_packed_bf16_no_remat")]
# (replicated, fsdp2d): the same lowering, dtype and residual layout
LAYOUT_PAIRS = [("replicated", "pallas_packed"),
                ("replicated_batch", None)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _cfgs():
    return (jax_registry.reduced(jax_registry.get_model_config(ARCH)),
            registry.reduced(registry.get_model_config(ARCH)))


@functools.lru_cache(maxsize=None)
def _inputs():
    """The reference's parameters made to differ by client, y > 0, small
    corrections summing to 0, and ROUNDS rounds of (K, n, B, S) batches
    (numpy)."""
    jcfg = _cfgs()[0]
    kd, kx, kb = jax.random.split(jax.random.PRNGKey(0), 3)
    dm = jax.jit(functools.partial(
        jax_data.make_data_model, vocab_size=jcfg.vocab_size, num_groups=G,
        num_clients=N, alpha=0.3))(kd)
    x0 = _np(jax.jit(functools.partial(jax_model.init_params, jcfg))(kx))
    draw = jax.jit(functools.partial(
        jax_data.round_batches, local_steps=K, num_clients=N,
        per_client_batch=B, seq_len=S, cfg=jcfg))
    batches = [_np(draw(dm, jax.random.fold_in(kb, t)))
               for t in range(ROUNDS)]
    rng = np.random.default_rng(0)
    xs = [jax.tree.map(lambda a: (a + 0.01 * rng.standard_normal(a.shape))
                       .astype(np.float32), x0) for _ in range(N)]
    # corrections that sum to 0 over the clients, as init_state's do
    cx = jax.tree.map(lambda a: (1e-3 * rng.standard_normal((N, *a.shape)))
                      .astype(np.float32), x0)
    cx = jax.tree.map(lambda a: a - a.mean(0), cx)
    cxs = [jax.tree.map(lambda a: a[c], cx) for c in range(N)]
    y = rng.uniform(0.1, 1.0, (N, G)).astype(np.float32)
    cy = (1e-2 * rng.standard_normal((N, G))).astype(np.float32)
    cy = cy - cy.mean(0)
    return dict(xs=xs, cxs=cxs, y=y, cy=cy, batches=batches)


def _batch(b):
    return {k: torch.tensor(np.asarray(v)).long() for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _port_state():
    inp, tcfg = _inputs(), _cfgs()[1]
    return dict(
        x=interop.stacked_params_from_reference(inp["xs"], tcfg,
                                                device="cpu"),
        cx=interop.stacked_params_from_reference(inp["cxs"], tcfg,
                                                 device="cpu"),
        y=torch.tensor(inp["y"]), cy=torch.tensor(inp["cy"]))


def _stack(trees):
    return jax.tree.map(lambda *a: np.stack(a), *trees)


@functools.lru_cache(maxsize=None)
def _reference(algo, dtype, compress):
    """The reference's ROUNDS rounds from the inputs (jitted, its XLA
    oracle for a packed lowering's compression), each unit of the stack
    under ``jax.checkpoint`` (``dro_problem(remat=True)``: the mesh's
    default, ``MeshConfig.remat``): numpy fields."""
    inp = _inputs()
    jprob = jax_objectives.dro_problem(_cfgs()[0], num_groups=G, mu=1.0,
                                       compute_dtype=getattr(jnp, dtype),
                                       remat=True)
    impl = "pallas_packed" if compress else "dense"
    cfg = JaxAlgorithmConfig(**ALGO, algorithm=algo, num_clients=N,
                             local_steps=K, mixing_impl=impl,
                             gossip_compress=compress,
                             gossip_backend="xla" if compress else "auto")
    ef = [None, None]
    if compress:
        dx = sum(a.size for a in jax.tree.leaves(inp["xs"][0]))
        ef = [np.zeros((N, dx), np.float32), np.zeros((N, G), np.float32)]
    st = jax_kgt.KGTState(x=_stack(inp["xs"]), y=inp["y"],
                          cx=_stack(inp["cxs"]), cy=inp["cy"],
                          round=jnp.int32(0), ef_x=ef[0], ef_y=ef[1])
    step = jax.jit(jax_kgt.make_round_step(jprob, cfg))
    keys = jax.random.split(jax.random.PRNGKey(1), K * N).reshape(K, N, 2)
    for b in inp["batches"]:
        st = step(st, b, keys)
    return _np(dict(x=st.x, y=st.y, cx=st.cx, cy=st.cy))


@functools.lru_cache(maxsize=None)
def _host(impl, algo, dtype, kernels, compress):
    """The port's host path on the case: its final state."""
    tcfg = _cfgs()[1]
    prob = t_objectives.dro_problem(tcfg, num_groups=G, mu=1.0,
                                    compute_dtype=getattr(torch, dtype),
                                    kernels=kernels)
    cfg = AlgorithmConfig(**ALGO, algorithm=algo, num_clients=N,
                          local_steps=K, mixing_impl=impl,
                          gossip_compress=compress)
    st = _port_state()
    state = t_kgt.init_state(prob, cfg, torch.Generator(), axis=None)
    state = KGTState(x=st["x"], y=st["y"], cx=st["cx"], cy=st["cy"],
                     round=0, ef_x=state.ef_x, ef_y=state.ef_y)
    step = t_kgt.make_round_step(prob, cfg, device="cpu")
    for b in _inputs()["batches"]:
        state = step(state, _batch(b), torch.zeros((K, N, 0)))
    return state


def _q_input():
    """A whole client row per client, as a stacked parameter dict, for
    the int8 quantizer check (values of several scales, so rows' maxima
    lie in different leaves)."""
    gen = torch.Generator().manual_seed(3)
    x = _port_state()["x"]
    return {k: torch.randn(v.shape, generator=gen) * (1.0 + i % 5)
            for i, (k, v) in enumerate(x.items())}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case and the checks on the 8 ranks (rank order), and the
    whole q input; the reference's rounds compiled meanwhile."""
    d = tmp_path_factory.mktemp("fsdp_mesh")
    st = _port_state()
    inputs = dict(n=N, k=K, b=B, s=S, g=G, mu=1.0, algo=ALGO,
                  state=st, batches=[_batch(b) for b in _inputs()["batches"]])
    path, q_path = str(d / "inputs.pt"), str(d / "q.pt")
    torch.save(inputs, path)
    q_in = _q_input()
    torch.save(q_in, q_path)
    out = {}

    def run():
        runs = [c + (RESIDUAL.get(c[0], "batch_seq"),
                     MESH_KW.get(c[0], {})) for c in CASES]
        ranks = dist_launch.run_world(8, worker.run, path, q_path, runs,
                                      backend="gloo", store_dir=str(d))
        out["cases"] = [r["cases"] for r in ranks]
        out["checks"] = [r["checks"] for r in ranks]
        out["heads"] = [r["heads"] for r in ranks]

    thread = threading.Thread(target=run)
    thread.start()
    try:
        for _, _, algo, dtype, _, comp in CASES:
            _reference(algo, dtype, comp)
    finally:
        thread.join()
    return dict(out, q_in=q_in)


def _ranks_of(client):
    """The block of ``client``: its ranks in (fsdp, model) order."""
    return range(client * F * M, (client + 1) * F * M)


def _gathered(ranks, name, field):
    """Every client's whole (gathered) parameter dict of ``field``: the
    pieces joined, or under ``"replicated"`` the block's first rank's
    (every rank's the same bit for bit:
    :func:`test_every_rank_of_a_client_holds_the_same_state`)."""
    cfg = _cfgs()[1]
    out = []
    for c in range(N):
        pieces = []
        for r in _ranks_of(c):
            rec = ranks[r][name]
            pieces.append({k: v[c - rec["clients"][0]]
                           for k, v in rec[field].items()})
        out.append(pieces[0] if name in REPLICATED
                   else tp.gather_client(pieces, cfg, F, M))
    return out


def _err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / (1.0 + float(
        np.abs(want).max()))


def _tols(dtype):
    if dtype == "float32":
        return dict(x=TOL_F32, cx=TOL_F32, y=TOL_F32, cy=TOL_F32)
    return dict(x=TOL_BF16_X, cx=TOL_BF16_X, y=TOL_BF16_Y, cy=TOL_BF16_Y)


def _errs(ranks, name, want_x, want_cx, want_y, want_cy):
    """max rel. error of each field of the world's state against the
    wanted one (x, cx as per-client dicts in the port's names)."""
    errs = {}
    for field, want in (("x", want_x), ("cx", want_cx)):
        for got, w in zip(_gathered(ranks, name, field), want):
            for k in got:
                errs[field] = max(errs.get(field, 0.0),
                                  _err(got[k].float().numpy(),
                                       w[k].float().numpy()))
    for field, want in (("y", want_y), ("cy", want_cy)):
        for c in range(N):
            for r in _ranks_of(c):
                rec = ranks[r][name]
                got = rec[field][c - rec["clients"][0]]
                errs[field] = max(errs.get(field, 0.0),
                                  _err(got.numpy(), want[c]))
    return errs


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", NAMES)
def test_round_matches_the_reference(world, name):
    _, impl, algo, dtype, kernels, comp = _case(name)
    want = _reference(algo, dtype, comp)
    errs = _errs(world["cases"], name, _port_dicts(want["x"]),
                 _port_dicts(want["cx"]), want["y"], want["cy"])
    tol = _tols(dtype)
    fields = ("x", "y", "cy") if comp else ("x", "cx", "y", "cy")
    assert all(errs[f] <= tol[f] for f in fields), errs


def _port_dicts(stacked):
    """A reference (n, …) parameter pytree as one port parameter dict a
    client."""
    x = interop.stacked_params_from_reference(
        [jax.tree.map(lambda a: a[c], stacked) for c in range(N)],
        _cfgs()[1], device="cpu")
    return [{k: v[c] for k, v in x.items()} for c in range(N)]


@pytest.mark.parametrize("name", NAMES)
def test_round_matches_the_host_path(world, name):
    _, impl, algo, dtype, kernels, comp = _case(name)
    host = _host(impl, algo, dtype, kernels, comp)
    per_client = lambda d: [{k: v[c] for k, v in d.items()}  # noqa: E731
                            for c in range(N)]
    errs = _errs(world["cases"], name, per_client(host.x),
                 per_client(host.cx), host.y.numpy(), host.cy.numpy())
    tol = _tols(dtype)
    fields = ("x", "y", "cy") if comp else ("x", "cx", "y", "cy")
    assert all(errs[f] <= tol[f] for f in fields), errs


@pytest.mark.parametrize("name", NAMES)
def test_sigma_c_is_zero(world, name):
    """Σ_i c_i = 0 over the clients, leaf by leaf of the gathered cx, and
    over cy."""
    ranks = world["cases"]
    cxs = _gathered(ranks, name, "cx")
    for k in cxs[0]:
        total = sum(c[k].double() for c in cxs)
        top = max(float(c[k].abs().max()) for c in cxs)
        assert float(total.abs().max()) / N <= TOL_SIGMA_C * (1 + top), k
    cy = torch.stack([ranks[_ranks_of(c)[0]][name]["cy"][0]
                      for c in range(N)])
    assert float(cy.double().sum(0).abs().max()) / N <= TOL_SIGMA_C * (
        1 + float(cy.abs().max()))


def test_y_is_the_same_on_every_rank_of_a_client(world):
    for name in NAMES:
        for c in range(N):
            ys = [world["cases"][r][name]["y"] for r in _ranks_of(c)]
            assert all(torch.equal(y, ys[0]) for y in ys), name


def test_the_round_makes_the_block_collectives(world):
    """The local steps gather the weights over fsdp and reduce-scatter
    their gradients (as many calls), sum the loss sums over fsdp, and over
    model: with the residual whole (``"batch"``) sum the row-parallel
    partials (``model_sum``) and no sequence collective; with the
    sequence split (``"batch_seq"``) gather the sequence where it enters
    a column-parallel piece and reduce-scatter it where a row-parallel
    output returns, and (their backwards) the other way round: as many
    ``seq_gather`` as ``seq_scatter`` calls, which take the place of
    those sums (fewer ``model_sum`` calls: the norms' gradients and the
    vocabulary pieces' merge).  The gossip runs over the clients axis
    only."""
    for rank in world["cases"]:
        seq, whole = (rank[name]["counts"]["local_steps"]
                      for name in ("dense", "dense_batch"))
        for name in ("dense", "dense_batch"):
            counts = rank[name]["counts"]
            local = counts["local_steps"]
            assert local["fsdp_gather"]["calls"] == local["reduce_scatter"][
                "calls"] > 0
            assert local["model_sum"]["calls"] > 0
            assert local["batch_sum"]["calls"] > 0
            assert set(counts["gossip"]) == {"all_gather"}
        assert seq["seq_gather"]["calls"] == seq["seq_scatter"]["calls"] > 0
        assert not {"seq_gather", "seq_scatter"} & set(whole)
        assert seq["model_sum"]["calls"] < whole["model_sum"]["calls"]


def test_attn_heads_sharding_runs_the_same_round(world):
    """``MeshConfig.attn_heads_sharding`` off and on build and run the same
    round on a ``(clients 1, fsdp 1, model 2)`` mesh, bit for bit: in the
    port's layout q is split by heads after the sequence's gather either
    way."""
    got = world["heads"]
    assert got[2:] == [None] * 6
    for rank in got[:2]:
        off, on = rank
        for field in ("x", "cx"):
            assert set(off[field]) == set(on[field])
            assert all(torch.equal(off[field][k], on[field][k])
                       for k in off[field])
        assert torch.equal(off["y"], on["y"])
        assert torch.equal(off["cy"], on["cy"])
        # the round moved the state: the final norm, whole on each rank
        assert not torch.equal(off["x"]["final_norm"],
                               _port_state()["x"]["final_norm"])


def test_replicated_leaves_get_the_same_gradient_on_every_model_rank(world):
    """A leaf every model rank holds whole (the norms) gets the same
    gradient bit for bit on the model ranks of a client's fsdp rank; the
    y gradient is the same on every rank of the block."""
    checks = world["checks"]
    replicated = [k for k, whole in checks[0]["plan"].items() if whole]
    assert replicated
    for c in range(N):
        block = [checks[r] for r in _ranks_of(c)]
        for f in range(F):
            ranks = [rec for rec in block if rec["block"][0] == f]
            for k in replicated:
                assert all(torch.equal(rec["gx"][k], ranks[0]["gx"][k])
                           for rec in ranks), k
        assert all(torch.equal(rec["gy"], block[0]["gy"]) for rec in block)


def test_the_gradient_is_the_host_paths(world):
    """The pieces' gradients gathered are the unsharded gradient."""
    tcfg = _cfgs()[1]
    prob = t_objectives.dro_problem(tcfg, num_groups=G, mu=1.0,
                                    compute_dtype=torch.float32)
    st = _port_state()
    batch = {k: v[0] for k, v in _batch(_inputs()["batches"][0]).items()}
    gx, gy = t_kgt._vgrads(prob, st["x"], st["y"], batch,
                           torch.zeros((N, 0)))
    checks = world["checks"]
    for c in range(N):
        got = tp.gather_client(
            [{k: v[c - checks[r]["clients"][0]]
              for k, v in checks[r]["gx"].items()} for r in _ranks_of(c)],
            tcfg, F, M)
        for k in got:
            assert _err(got[k].numpy(), gx[k][c].numpy()) <= TOL_F32, k
        got_y = checks[_ranks_of(c)[0]]["gy"][c - checks[
            _ranks_of(c)[0]]["clients"][0]]
        assert _err(got_y.numpy(), gy[c].numpy()) <= TOL_F32


def test_the_metrics_row_is_the_host_paths(world):
    """``dro_metrics_fn`` on the pieces (x̄ the pieces' mean, the losses
    on them, the consensus and correction norms summed over the block)
    against the host path's row of the same state and batches, on every
    rank."""
    from repro_torch.engine import diagnostics

    tcfg = _cfgs()[1]
    prob = t_objectives.dro_problem(tcfg, num_groups=G, mu=1.0,
                                    compute_dtype=torch.float32)
    st = _port_state()
    batches = _batch(_inputs()["batches"][0])
    want = diagnostics.dro_metrics_fn(
        prob, tcfg, num_groups=G,
        eval_batch={k: v[1, 0] for k, v in batches.items()},
        compute_dtype=torch.float32)(
        KGTState(x=st["x"], y=st["y"], cx=st["cx"], cy=st["cy"], round=0),
        batches)
    for rec in world["checks"]:
        assert set(rec["row"]) == set(want)
        for k, w in want.items():
            assert _err(rec["row"][k].numpy(), w.numpy()) <= TOL_F32, k


def test_a_rank_holds_a_quarter_of_a_client(world):
    """x and cx are split over the block's F·M = 4 ranks (up to the
    uneven pieces: a KV bias of one head a model rank has an empty fsdp
    piece), y and cy are whole on each."""
    st = _port_state()
    whole = sum(v[0].numel() * 4 for v in st["x"].values()) * 2
    yb = G * 4 * 2
    for rec in world["checks"]:
        x_bytes = rec["state_bytes"] - yb
        assert abs(x_bytes - whole / (F * M)) <= 0.01 * whole / (F * M)


def test_int8_q_is_the_whole_rows_bit_for_bit(world):
    """int8's q (and e') on a rank's pieces, the row's max over the block,
    is the whole row's q bit for bit."""
    tcfg = _cfgs()[1]
    q_in = world["q_in"]
    spec = packing.pack_spec(q_in)
    q, e = compression.ef_transmit(packing.pack(q_in, spec),
                                   torch.zeros((N, spec.dim)), "int8")
    want_q, want_e = packing.unpack(q, spec), packing.unpack(e, spec)
    checks = world["checks"]
    for field, want in (("q", want_q), ("e", want_e)):
        for c in range(N):
            got = tp.gather_client(
                [{k: v[c - checks[r]["clients"][0]]
                  for k, v in checks[r][field].items()}
                 for r in _ranks_of(c)], tcfg, F, M)
            for k in got:
                assert torch.equal(got[k], want[k][c]), (field, k)


@pytest.mark.parametrize("on,off", REMAT_PAIRS)
def test_remat_is_the_remat_off_round_bit_for_bit(world, on, off):
    """Activation checkpointing (``MeshConfig.remat``, the default: each
    unit through ``models.transformer.UnitRemat``, its backward a
    ``torch.func.vjp`` of the unit run again) leaves every rank's pieces
    of the state bit for bit those of the round without it, in f32 and in
    bf16."""
    assert MeshConfig().remat
    for rank in world["cases"]:
        for field in ("x", "cx"):
            assert set(rank[on][field]) == set(rank[off][field])
            for k in rank[on][field]:
                assert torch.equal(rank[on][field][k],
                                   rank[off][field][k]), (field, k)
        for field in ("y", "cy"):
            assert torch.equal(rank[on][field], rank[off][field])


def test_the_remat_round_makes_its_collectives(world):
    """Under remat the fsdp gathers run once a forward, before each unit,
    and their reduce-scatters once (as many calls as without remat); each
    unit's sequence gathers and reduce-scatters run once more, in the
    recompute: 2 of each a layer (``attn_in`` and ``ffn_in``,
    ``attn_proj`` and ``ffn_out``) a local step, and the sums over model
    and fsdp, outside the units here, as often as without it."""
    layers = len(_cfgs()[1].blocks())
    extra = 2 * layers * K * ROUNDS
    for rank in world["cases"]:
        on, off = (rank[name]["counts"]["local_steps"]
                   for name in ("dense", "dense_no_remat"))
        for kind in ("fsdp_gather", "reduce_scatter", "model_sum",
                     "batch_sum"):
            assert on[kind]["calls"] == off[kind]["calls"] > 0, kind
            assert on[kind]["bytes"] == off[kind]["bytes"], kind
        for kind in ("seq_gather", "seq_scatter"):
            assert on[kind]["calls"] == off[kind]["calls"] + extra, kind
        gossip_on, gossip_off = (
            {k: (v["calls"], v["bytes"]) for k, v in
             rank[name]["counts"]["gossip"].items()}
            for name in ("dense", "dense_no_remat"))
        assert gossip_on == gossip_off


@pytest.mark.parametrize("name", REPLICATED)
def test_every_rank_of_a_client_holds_the_same_state(world, name):
    """Under ``param_mode="replicated"`` every rank of a client's block
    holds the client's whole x, cx, y and cy, bit for bit the same."""
    whole = _port_state()["x"]
    for c in range(N):
        recs = [world["cases"][r][name] for r in _ranks_of(c)]
        for rec in recs:
            assert all(rec["x"][k].shape[1:] == whole[k].shape[1:]
                       for k in whole)
        for field in ("x", "cx"):
            for k in whole:
                want = recs[0][field][k]
                assert all(torch.equal(rec[field][k], want)
                           for rec in recs), (field, k)
        for field in ("y", "cy"):
            assert all(torch.equal(rec[field], recs[0][field])
                       for rec in recs)


@pytest.mark.parametrize("rep,fsdp2d", [("replicated", "pallas_packed"),
                                        ("replicated_batch",
                                         "sparse_packed")])
def test_replicated_is_the_fsdp2d_round(world, rep, fsdp2d):
    """The plain versions' round with the weights whole on every rank of
    the block is the ``"fsdp2d"`` round of the same lowering within the
    f32 tolerance (``replicated_batch`` keeps the residual whole, the
    ``sparse_packed`` case splits its sequence: the two layouts of the
    same function)."""
    per_client = _gathered(world["cases"], fsdp2d, "x")
    per_client_c = _gathered(world["cases"], fsdp2d, "cx")
    ys = [world["cases"][_ranks_of(c)[0]][fsdp2d] for c in range(N)]
    errs = _errs(world["cases"], rep, per_client, per_client_c,
                 [rec["y"][c - rec["clients"][0]].numpy()
                  for c, rec in enumerate(ys)],
                 [rec["cy"][c - rec["clients"][0]].numpy()
                  for c, rec in enumerate(ys)])
    assert all(v <= TOL_F32 for v in errs.values()), errs


def test_the_replicated_round_makes_its_collectives(world):
    """Under ``"replicated"`` no weight is gathered: each weight's
    gradient is summed over the token ranks (``grad_sum``; the block
    under ``"batch_seq"``, fsdp under ``"batch"``), and the gossip's
    all-gather moves the whole client: (R − 1)·(n/R) rows of the stacked
    (Δ, θ) of x and of y a round, F·M times ``fsdp2d``'s x.  Under
    ``"batch_seq"`` a mixer's gather carries its projected inputs."""
    dx = sum(v[0].numel() for v in _port_state()["x"].values())
    nl = N // 2
    cfg = _cfgs()[1]
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.resolved_head_dim
    for rank in world["cases"]:
        for name in ("replicated", "replicated_batch"):
            local = rank[name]["counts"]["local_steps"]
            assert "fsdp_gather" not in local and "reduce_scatter" not in local
            assert local["grad_sum"]["calls"] > 0
            assert local["batch_sum"]["calls"] > 0
        # a mixer's input gathered in the forward and again in the
        # recompute, reduce-scattered once in the backward; its output
        # cut back to the rank's positions without a collective
        seq = rank["replicated"]["counts"]["local_steps"]
        assert seq["seq_gather"]["calls"] == 2 * seq["seq_scatter"][
            "calls"] > 0
        # each rank projects its own positions: a gather carries the rank's
        # piece of q, k and v (f32), not of the residual
        assert seq["seq_gather"]["bytes"] == seq["seq_gather"]["calls"] * (
            (M - 1) * (B // F) * (S // M) * qkv * 4)
        assert not {"seq_gather", "seq_scatter"} & set(
            rank["replicated_batch"]["counts"]["local_steps"])
        gossip = rank["replicated"]["counts"]["gossip"]
        assert set(gossip) == {"all_gather"}
        assert gossip["all_gather"]["calls"] == 2 * ROUNDS
        assert gossip["all_gather"]["bytes"] == ROUNDS * (
            (2 - 1) * nl * 2 * (dx + G) * 4)


def test_the_replicated_gradient_and_metrics_are_the_host_paths(world):
    """Under ``"replicated"`` each rank's gradient of its whole clients
    (summed over the block) and its metrics row are the host path's, and
    a rank holds a whole client."""
    from repro_torch.engine import diagnostics

    tcfg = _cfgs()[1]
    prob = t_objectives.dro_problem(tcfg, num_groups=G, mu=1.0,
                                    compute_dtype=torch.float32)
    st = _port_state()
    batches = _batch(_inputs()["batches"][0])
    batch = {k: v[0] for k, v in batches.items()}
    gx, gy = t_kgt._vgrads(prob, st["x"], st["y"], batch,
                           torch.zeros((N, 0)))
    want = diagnostics.dro_metrics_fn(
        prob, tcfg, num_groups=G,
        eval_batch={k: v[1, 0] for k, v in batches.items()},
        compute_dtype=torch.float32)(
        KGTState(x=st["x"], y=st["y"], cx=st["cx"], cy=st["cy"], round=0),
        batches)
    whole = sum(v[0].numel() * 4 for v in st["x"].values()) * 2 + G * 4 * 2
    for rec in (c["replicated"] for c in world["checks"]):
        lo = rec["clients"][0]
        for k in gx:
            assert _err(rec["gx"][k][0].numpy(), gx[k][lo].numpy()) <= \
                TOL_F32, k
        assert _err(rec["gy"][0].numpy(), gy[lo].numpy()) <= TOL_F32
        for k, w in want.items():
            assert _err(rec["row"][k].numpy(), w.numpy()) <= TOL_F32, k
        assert rec["state_bytes"] == whole * (N // 2)


@pytest.mark.parametrize("arch,match", [
    ("mamba2-1.3b", "ssm blocks"), ("recurrentgemma-9b", "rglru blocks"),
    ("granite-moe-1b-a400m", "moe blocks")])
def test_blocks_not_ported_are_refused_by_name(arch, match):
    """The ``ssm``, ``rglru`` and ``moe`` blocks, refused before they
    trained over the block, now plan: ``check_train`` takes them at
    (fsdp 2, model 2), the model axis splits the block's own leaves, and
    the four block ranks' pieces of a whole client join back to it bit for
    bit (their rounds against the reference: ``test_torch_fsdp_blocks``)."""
    from repro_torch.dist import collectives
    from repro_torch.models import model as t_model

    cfg = registry.reduced(registry.get_model_config(arch))
    kind = match.split()[0]
    ep = kind == "moe"
    tp.check_train(cfg, 2, 2, expert_parallel=ep)
    tp.check_train(cfg, 1, 1)
    plan = tp.plan(cfg, 2, expert_parallel=ep)
    mine = [k for k in plan if f".{kind}." in k]
    assert mine and any(plan[k] is not None for k in mine)
    full = t_model.param_dict(t_model.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    shards = [tp.ClientShard(cfg, collectives.MeshAxis(f, 2),
                             collectives.MeshAxis(m, 2),
                             expert_parallel=ep).take(full)
              for f in range(2) for m in range(2)]
    back = tp.gather_client(shards, cfg, 2, 2, expert_parallel=ep)
    assert all(torch.equal(back[k], full[k]) for k in full)


def test_expert_parallel_plans_and_refuses_what_m_does_not_divide():
    """Expert parallelism in training plans (E/M whole experts a model
    rank) and refuses by name experts that M does not divide, under
    either ``param_mode``; ``"replicated"`` trains (``check_train`` takes
    it) and refuses an unknown mode by name."""
    cfg = _cfgs()[1]
    tp.check_train(cfg, 2, 1, param_mode="replicated")
    with pytest.raises(ValueError, match="param_mode='sharded'"):
        tp.check_train(cfg, 2, 1, param_mode="sharded")
    moe = registry.reduced(registry.get_model_config("granite-moe-1b-a400m"))
    tp.check_train(moe, 1, 2, expert_parallel=True)
    assert tp.plan(moe, 2, expert_parallel=True)[
        "layers.0.moe.up"] == tp.Split(0, (2, 2))
    six = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe,
                                                           num_experts=6))
    for mode in tp.PARAM_MODES:
        with pytest.raises(ValueError, match="num_experts = 6 does not "
                           "split over 4"):
            tp.check_train(six, 1, 4, expert_parallel=True, param_mode=mode)


def test_fsdp_pieces_cover_a_dim():
    from repro_torch.dist import collectives

    assert collectives.fsdp_widths(7, 2) == (4, 3)
    assert collectives.fsdp_widths(1, 2) == (1, 0)
    assert collectives.fsdp_widths(896, 2) == (448, 448)
    assert sum(collectives.fsdp_widths(5, 4)) == 5
