"""The ``ssm``, ``rglru`` and ``moe`` blocks trained over a client's fsdp and
model axes (``launch.steps.build_train_round`` at ``(clients 2, fsdp 2,
model 2)``, ``dist.tensor_parallel.ClientShard``) against the JAX
package's unsharded round and the port's host path: the reduced
mamba2-1.3b (2 Mamba2 layers, d 256, 16 SSM heads, d_state 16, vocab
512), recurrentgemma-9b (2 RG-LRU layers and a local-attention layer, d
256, 4 query heads and its one KV head, which both model ranks hold) and
granite-moe-1b-a400m (2 MoE layers, 4 experts, top 2) with its experts
split over model (``moe_expert_parallel``) and without (each expert's
expert_d_ff split); and the reduced qwen2-0.5b (4 query heads, 2 KV
heads) at ``(clients 1, fsdp 2, model 4)``, where each KV head is held
by two of the four model ranks: the gradient of a shared range is summed
over its holders only.  n = 2, K = 2, 4 × 32 tokens a client, 4 groups,
two rounds of ``pallas_packed`` from a state whose clients differ.  The
residual's sequence is split over model (``MeshConfig.residual_mode=
"batch_seq"``, the default) in the f32 and bf16 cases, and whole on every
model rank (``"batch"``) in the ``f32_batch`` case.

One world of 8 gloo ranks is spawned for the file and runs every case
and check (``_torch_fsdp_blocks_worker.run``); the reference's rounds
(``repro.core.kgt_minimax.make_round_step`` on
``repro.core.objectives.dro_problem``, jitted) are compiled here while the
world runs.  The f32 cases run the port's kernels' plain versions
(``kernels=True`` on CPU tensors: the scans' and B5's autograd Functions,
B6's vocab-parallel partials); the bf16 cases ``kernels=False``, the
reference's form, on both sides.

Tolerances, max |got − want| ≤ tol·(1 + max|want|): f32 TOL_F32 = 1e-4;
bf16 compute ``tests/test_torch_fsdp_mesh.py``'s TOL_BF16_X = 1e-2 for x
and cx and TOL_BF16_Y = 2e-4 for y and cy, but for the reduced
recurrentgemma-9b's corrections (a round's Δ scaled by 1/(K·η_c), 25×
for x, 2.5× for y) TOL_BF16_RG_CX = 3e-2 and TOL_BF16_RG_CY = 1e-3: the
port's single-process round already differs from the reference's by
1.47e-2 (cx) and 3.70e-4 (cy) there in bf16, past the limits of 1e-2 and
2e-4; Σ_i c_i over the clients TOL_SIGMA_C = 1e-5; the MoE aux of a
client's batch split over fsdp against the whole batch's, and the
per-group losses, at TOL_F32.  The ranges that several model ranks hold
(the SSM's B and C columns of ``in_proj`` and channels of the conv,
recurrentgemma-9b's KV head, qwen2-0.5b's two KV heads at model 4) are
equal bit for bit across their holders after every case and in every
gradient.
"""
import _torch_threads  # noqa: F401
import concurrent.futures
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
from repro_torch.configs.base import AlgorithmConfig
from repro_torch.core import KGTState
from repro_torch.core import kgt_minimax as t_kgt
from repro_torch.core import objectives as t_objectives
from repro_torch.dist import launch as dist_launch
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import interop
from repro_torch.models import model as t_model

import _torch_fsdp_blocks_worker as worker

TOL_F32 = 1e-4
TOL_BF16_X = 1e-2
TOL_BF16_Y = 2e-4
TOL_BF16_RG_CX = 3e-2
TOL_BF16_RG_CY = 1e-3
TOL_SIGMA_C = 1e-5
N, K, B, S, G, ROUNDS = 2, 2, 4, 32, 4, 2
ALGO = dict(eta_cx=0.02, eta_cy=0.2, eta_sx=0.7, eta_sy=0.7,
            topology="ring")
# (key, arch, moe_expert_parallel, mesh (clients, fsdp, model))
MODELS = [("mamba2", "mamba2-1.3b", False, (2, 2, 2)),
          ("recurrentgemma", "recurrentgemma-9b", False, (2, 2, 2)),
          ("granite_ep", "granite-moe-1b-a400m", True, (2, 2, 2)),
          ("granite", "granite-moe-1b-a400m", False, (2, 2, 2)),
          ("qwen2_kv2", "qwen2-0.5b", False, (1, 2, 4))]
KEYS = [m[0] for m in MODELS]
# (name, compute dtype, kernels, MeshConfig.residual_mode): the sequence
# split over model ("batch_seq", the default) or the residual whole
# ("batch")
CASES = [("f32", "float32", True, "batch_seq"),
         ("bf16", "bfloat16", False, "batch_seq"),
         ("f32_batch", "float32", True, "batch")]
NAMES = [c[0] for c in CASES]
# more cases of the ssm, rglru and moe models: activation checkpointing
# off (on by default, MeshConfig.remat) in f32 and bf16, and the weights
# whole on every rank of the block (param_mode="replicated"; the experts
# whole too, as the reference keeps them there)
NO_REMAT = dict(remat=False)
EXTRA = {key: [("f32_no_remat", "float32", True, "batch_seq", NO_REMAT),
               ("bf16_no_remat", "bfloat16", False, "batch_seq", NO_REMAT),
               ("replicated", "float32", True, "batch_seq",
                dict(param_mode="replicated"))]
         for key in ("mamba2", "recurrentgemma", "granite_ep")}


def _model(key):
    return next(m for m in MODELS if m[0] == key)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    return (jax_registry.reduced(jax_registry.get_model_config(arch)),
            registry.reduced(registry.get_model_config(arch)))


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """The reference's parameters made to differ by client, y > 0, small
    corrections summing to 0, and ROUNDS rounds of (K, n, B, S) batches
    (numpy)."""
    jcfg = _cfgs(arch)[0]
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
def _port_state(arch):
    inp, tcfg = _inputs(arch), _cfgs(arch)[1]
    return dict(
        x=interop.stacked_params_from_reference(inp["xs"], tcfg,
                                                device="cpu"),
        cx=interop.stacked_params_from_reference(inp["cxs"], tcfg,
                                                 device="cpu"),
        y=torch.tensor(inp["y"]), cy=torch.tensor(inp["cy"]))


def _stack(trees):
    return jax.tree.map(lambda *a: np.stack(a), *trees)


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """The reference's ROUNDS rounds of ``dense`` (its unsharded round;
    the packed lowerings are the same round) from the inputs: numpy
    fields."""
    inp = _inputs(arch)
    jprob = jax_objectives.dro_problem(_cfgs(arch)[0], num_groups=G,
                                       mu=1.0,
                                       compute_dtype=getattr(jnp, dtype))
    cfg = JaxAlgorithmConfig(**ALGO, num_clients=N, local_steps=K)
    st = jax_kgt.KGTState(x=_stack(inp["xs"]), y=inp["y"],
                          cx=_stack(inp["cxs"]), cy=inp["cy"],
                          round=jnp.int32(0))
    step = jax.jit(jax_kgt.make_round_step(jprob, cfg))
    keys = jax.random.split(jax.random.PRNGKey(1), K * N).reshape(K, N, 2)
    for b in inp["batches"]:
        st = step(st, b, keys)
    return _np(dict(x=st.x, y=st.y, cx=st.cx, cy=st.cy))


@functools.lru_cache(maxsize=None)
def _host(arch, dtype, kernels):
    """The port's host path on the case: its final state."""
    tcfg = _cfgs(arch)[1]
    prob = t_objectives.dro_problem(tcfg, num_groups=G, mu=1.0,
                                    compute_dtype=getattr(torch, dtype),
                                    kernels=kernels)
    cfg = AlgorithmConfig(**ALGO, num_clients=N, local_steps=K,
                          mixing_impl="pallas_packed")
    st = _port_state(arch)
    state = KGTState(x=st["x"], y=st["y"], cx=st["cx"], cy=st["cy"],
                     round=0)
    step = t_kgt.make_round_step(prob, cfg, device="cpu")
    for b in _inputs(arch)["batches"]:
        state = step(state, _batch(b), torch.zeros((K, N, 0)))
    return state


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every model's cases and checks on the 8 ranks (rank order), keyed
    by model; the reference's rounds compiled meanwhile."""
    d = tmp_path_factory.mktemp("fsdp_blocks")
    models = []
    for key, arch, ep, shape in MODELS:
        path = str(d / f"{key}.pt")
        torch.save(dict(n=N, k=K, b=B, s=S, g=G, mu=1.0, algo=ALGO,
                        state=_port_state(arch),
                        batches=[_batch(b) for b in _inputs(arch)["batches"]]),
                   path)
        models.append((key, arch, ep, shape, path))
    out = {}

    def run():
        out["ranks"] = dist_launch.run_world(8, worker.run, models, CASES,
                                             EXTRA, backend="gloo",
                                             store_dir=str(d))

    thread = threading.Thread(target=run)
    thread.start()
    try:
        # XLA compiles without the GIL: the reference's rounds side by side
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            list(pool.map(lambda a: _reference(*a),
                          sorted({(m[1], c[1]) for m in MODELS
                                  for c in CASES})))
    finally:
        thread.join()
    return out["ranks"]


def _fm(key):
    """(fsdp, model) of the model's mesh."""
    return _model(key)[3][1:]


def _ranks_of(key, client):
    """The block of ``client`` on the model's mesh: its ranks in (fsdp,
    model) order."""
    c, f, m = _model(key)[3]
    at = client // (N // c)
    return range(at * f * m, (at + 1) * f * m)


def _gathered(recs, key, field, whole=False):
    """Every client's whole parameter dict of ``field`` from the ranks'
    records ``recs`` (each a dict with ``clients`` and ``field``), joined
    by ``tp.gather_client``, which holds every range that several model
    ranks hold equal bit for bit across them; ``whole`` (``param_mode=
    "replicated"``): the block's ranks each hold the whole dict, held
    equal bit for bit across them."""
    _, arch, ep, _ = _model(key)
    f, m = _fm(key)
    out = []
    for c in range(N):
        ranks = _ranks_of(key, c)
        assert [recs[r]["block"] for r in ranks] == [
            (a, b) for a in range(f) for b in range(m)]
        pieces = [{k: v[c - recs[r]["clients"][0]]
                   for k, v in recs[r][field].items()} for r in ranks]
        if whole:
            assert all(torch.equal(p[k], pieces[0][k])
                       for p in pieces for k in p), (key, field)
            out.append(pieces[0])
        else:
            out.append(tp.gather_client(pieces, _cfgs(arch)[1], f, m,
                                        expert_parallel=ep))
    return out


def _cases(world, key, name):
    return [rank[key]["cases"][name] for rank in world]


def _checks(world, key):
    return [rank[key]["checks"] for rank in world]


def _err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / (1.0 + float(
        np.abs(want).max()))


def _tols(key, dtype):
    if dtype == "float32":
        return dict(x=TOL_F32, cx=TOL_F32, y=TOL_F32, cy=TOL_F32)
    if key == "recurrentgemma":
        return dict(x=TOL_BF16_X, cx=TOL_BF16_RG_CX, y=TOL_BF16_Y,
                    cy=TOL_BF16_RG_CY)
    return dict(x=TOL_BF16_X, cx=TOL_BF16_X, y=TOL_BF16_Y, cy=TOL_BF16_Y)


def _errs(world, key, name, want_x, want_cx, want_y, want_cy):
    """max rel. error of each field of the world's state against the
    wanted one (x, cx as per-client dicts in the port's names)."""
    recs = _cases(world, key, name)
    errs = {}
    for field, want in (("x", want_x), ("cx", want_cx)):
        for got, w in zip(_gathered(recs, key, field,
                                    whole=name == "replicated"), want):
            for k in got:
                errs[field] = max(errs.get(field, 0.0),
                                  _err(got[k].float().numpy(),
                                       w[k].float().numpy()))
    for field, want in (("y", want_y), ("cy", want_cy)):
        for c in range(N):
            for r in _ranks_of(key, c):
                got = recs[r][field][c - recs[r]["clients"][0]]
                errs[field] = max(errs.get(field, 0.0),
                                  _err(got.numpy(), want[c]))
    return errs


def _port_dicts(arch, stacked):
    """A reference (n, …) parameter pytree as one port parameter dict a
    client."""
    x = interop.stacked_params_from_reference(
        [jax.tree.map(lambda a: a[c], stacked) for c in range(N)],
        _cfgs(arch)[1], device="cpu")
    return [{k: v[c] for k, v in x.items()} for c in range(N)]


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", KEYS)
def test_round_matches_the_reference(world, key, name):
    arch = _model(key)[1]
    _, dtype, _, _ = _case(name)
    want = _reference(arch, dtype)
    errs = _errs(world, key, name, _port_dicts(arch, want["x"]),
                 _port_dicts(arch, want["cx"]), want["y"], want["cy"])
    tol = _tols(key, dtype)
    assert all(errs[f] <= tol[f] for f in tol), errs


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", KEYS)
def test_round_matches_the_host_path(world, key, name):
    arch = _model(key)[1]
    _, dtype, kernels, _ = _case(name)
    host = _host(arch, dtype, kernels)
    per_client = lambda d: [{k: v[c] for k, v in d.items()}  # noqa: E731
                            for c in range(N)]
    errs = _errs(world, key, name, per_client(host.x), per_client(host.cx),
                 host.y.numpy(), host.cy.numpy())
    tol = _tols(key, dtype)
    assert all(errs[f] <= tol[f] for f in tol), errs


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", KEYS)
def test_sigma_c_is_zero(world, key, name):
    """Σ_i c_i = 0 over the clients, leaf by leaf of the gathered cx, and
    over cy."""
    recs = _cases(world, key, name)
    cxs = _gathered(recs, key, "cx")
    for k in cxs[0]:
        total = sum(c[k].double() for c in cxs)
        top = max(float(c[k].abs().max()) for c in cxs)
        assert float(total.abs().max()) / N <= TOL_SIGMA_C * (1 + top), k
    firsts = [recs[_ranks_of(key, c)[0]] for c in range(N)]
    cy = torch.stack([rec["cy"][c - rec["clients"][0]]
                      for c, rec in enumerate(firsts)])
    assert float(cy.double().sum(0).abs().max()) / N <= TOL_SIGMA_C * (
        1 + float(cy.abs().max()))


def _shared_ranges(key):
    """(leaf, split) of each leaf of the model's plan at its M with a
    range that several model ranks hold."""
    _, arch, ep, _ = _model(key)
    m = _fm(key)[1]
    plan = tp.plan(_cfgs(arch)[1], m, expert_parallel=ep)
    out = []
    for name, s in plan.items():
        if s is None or not s.ranges:
            continue
        spans = [s.spans(r) for r in range(m)]
        if any(sp in spans[q] for r in range(m) for q in range(m)
               if q != r for sp in spans[r]):
            out.append((name, s))
    return out


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("key", ["mamba2", "recurrentgemma", "qwen2_kv2"])
def test_shared_ranges_stay_equal_across_model_ranks(world, key, name):
    """The SSM's B and C (columns of ``in_proj``, channels of the conv)
    and recurrentgemma-9b's KV head, which every model rank holds, and
    each of qwen2-0.5b's two KV heads, which two of its four model ranks
    hold, are bit for bit equal on their holders of a client after the
    rounds, in x and cx: each model rank's piece joined from its fsdp
    pieces, then cut into its ranges."""
    shared = _shared_ranges(key)
    assert shared
    m_size = _fm(key)[1]
    recs = _cases(world, key, name)
    for field in ("x", "cx"):
        for c in range(N):
            block = [recs[r] for r in _ranks_of(key, c)]
            for leaf, s in shared:
                held = {}
                for m in range(m_size):
                    piece = torch.cat([rec[field][leaf][c - rec["clients"][0]]
                                       for rec in block
                                       if rec["block"][1] == m])
                    at = 0
                    for lo, hi in s.spans(m):
                        held.setdefault((lo, hi), []).append(
                            piece.narrow(s.dim, at, hi - lo))
                        at += hi - lo
                common = [v for v in held.values() if len(v) > 1]
                assert common, leaf
                for v in common:
                    assert all(torch.equal(t, v[0]) for t in v), (field,
                                                                  leaf)


@pytest.mark.parametrize("key", KEYS)
def test_the_gradient_is_the_host_paths(world, key):
    """The pieces' f32 gradients on one batch, gathered (the shared ranges
    equal across the model ranks), are the unsharded gradient; the y
    gradient is the same on every rank of a client's block."""
    arch = _model(key)[1]
    tcfg = _cfgs(arch)[1]
    prob = t_objectives.dro_problem(tcfg, num_groups=G, mu=1.0,
                                    compute_dtype=torch.float32)
    st = _port_state(arch)
    batch = {k: v[0] for k, v in _batch(_inputs(arch)["batches"][0]).items()}
    gx, gy = t_kgt._vgrads(prob, st["x"], st["y"], batch,
                           torch.zeros((N, 0)))
    checks = _checks(world, key)
    for c, got in enumerate(_gathered(checks, key, "gx")):
        for k in got:
            assert _err(got[k].numpy(), gx[k][c].numpy()) <= TOL_F32, k
        ys = [checks[r]["gy"][c - checks[r]["clients"][0]]
              for r in _ranks_of(key, c)]
        assert all(torch.equal(v, ys[0]) for v in ys)
        assert _err(ys[0].numpy(), gy[c].numpy()) <= TOL_F32


@pytest.mark.parametrize("key", KEYS)
def test_the_metrics_row_is_the_host_paths(world, key):
    """``dro_metrics_fn`` on the pieces (x̄ the pieces' mean, the losses
    on them, the consensus and correction norms summed over the block,
    each range that several model ranks hold counted once) against the
    host path's row of the same state and batches, on every rank."""
    from repro_torch.engine import diagnostics

    arch = _model(key)[1]
    tcfg = _cfgs(arch)[1]
    prob = t_objectives.dro_problem(tcfg, num_groups=G, mu=1.0,
                                    compute_dtype=torch.float32)
    st = _port_state(arch)
    batches = _batch(_inputs(arch)["batches"][0])
    want = diagnostics.dro_metrics_fn(
        prob, tcfg, num_groups=G,
        eval_batch={k: v[1, 0] for k, v in batches.items()},
        compute_dtype=torch.float32)(
        KGTState(x=st["x"], y=st["y"], cx=st["cx"], cy=st["cy"], round=0),
        batches)
    for rec in _checks(world, key):
        assert set(rec["row"]) == set(want)
        for k, w in want.items():
            assert _err(rec["row"][k].numpy(), w.numpy()) <= TOL_F32, k


@pytest.mark.parametrize("key", ["granite_ep", "granite"])
def test_the_moe_aux_is_the_whole_batchs(world, key):
    """The Switch aux of a client's batch whose rows split over the fsdp
    ranks (each rank's router sums and top-1 counts summed over fsdp
    before the product) is the whole batch's aux on every rank of the
    block, not the mean of the halves' auxes; the per-group losses are
    the whole batch's too."""
    arch = _model(key)[1]
    tcfg = _cfgs(arch)[1]
    st = _port_state(arch)
    batch = {k: v[0, 0] for k, v in
             _batch(_inputs(arch)["batches"][0]).items()}
    skel = t_model.skeleton(tcfg)
    x0 = {k: v[0] for k, v in st["x"].items()}

    def of(rows):
        with torch.no_grad():
            return t_model.call(skel, x0, t_model.per_group_loss,
                                {k: v[rows] for k, v in batch.items()},
                                num_groups=G, compute_dtype=torch.float32)

    f_size = _fm(key)[0]
    losses, aux = of(slice(0, B))
    halves = [of(slice(f * B // f_size, (f + 1) * B // f_size))[1]
              for f in range(f_size)]
    checks = _checks(world, key)
    for r in _ranks_of(key, 0):
        assert _err(checks[r]["aux"].numpy(), aux.numpy()) <= TOL_F32
        assert _err(checks[r]["losses"].numpy(), losses.numpy()) <= TOL_F32
    assert abs(float(sum(halves)) / f_size - float(aux)) > TOL_F32 * (
        1 + abs(float(aux)))


@pytest.mark.parametrize("key", KEYS)
def test_the_round_makes_the_block_collectives(world, key):
    """The local steps gather the weights over fsdp and reduce-scatter
    their gradients (as many calls), sum the partials over model and the
    loss sums over fsdp; an RG-LRU layer gathers its gate input over
    model and reduce-scatters its gradient (twice as many gathers: remat
    gathers again in the recompute); the gossip
    runs over the clients axis only, and moves nothing where that axis is
    one rank.  With the sequence split over model (``"batch_seq"``) the
    residual's gathers and reduce-scatters (as many calls) take the place
    of the row-parallel sums: fewer ``model_sum`` calls than with the
    residual whole (``"batch"``), which makes no sequence collective."""
    gossip = {"all_gather"} if _model(key)[3][0] > 1 else set()
    for name in ("f32", "f32_batch"):
        for rec in _cases(world, key, name):
            local = rec["counts"]["local_steps"]
            assert local["fsdp_gather"]["calls"] == local["reduce_scatter"][
                "calls"] > 0
            assert local["model_sum"]["calls"] > 0
            assert local["batch_sum"]["calls"] > 0
            if key == "recurrentgemma":
                # the gate input's gather runs again in each unit's
                # recompute (MeshConfig.remat, the default), its
                # reduce-scatter once, in the backward
                assert local["model_gather"]["calls"] == 2 * local[
                    "model_scatter"]["calls"] > 0
            else:
                assert "model_gather" not in local
            assert set(rec["counts"].get("gossip", {})) == gossip
    for seq, whole in zip(_cases(world, key, "f32"),
                          _cases(world, key, "f32_batch")):
        seq, whole = (r["counts"]["local_steps"] for r in (seq, whole))
        assert seq["seq_gather"]["calls"] == seq["seq_scatter"]["calls"] > 0
        assert not {"seq_gather", "seq_scatter"} & set(whole)
        assert seq["model_sum"]["calls"] < whole["model_sum"]["calls"]


def test_expert_parallelism_splits_the_experts():
    """With ``moe_expert_parallel`` each model rank holds E/M whole
    experts (its ``MoEShard`` their range), else every expert's piece of
    expert_d_ff; the router is whole either way."""
    cfg = _cfgs("granite-moe-1b-a400m")[1]
    e, f = cfg.moe.num_experts, cfg.moe.expert_d_ff
    M = _fm("granite_ep")[1]
    for r in range(M):
        ep = tp.shard_config(cfg, M, r, expert_parallel=True)
        assert ep.moe.expert_range() == (r * e // M, (r + 1) * e // M)
        assert ep.moe.expert_d_ff == f
        assert tp.shard_config(cfg, M, r).moe.expert_range() == (0, e)
    plan = tp.plan(cfg, M, expert_parallel=True)
    assert plan["layers.0.moe.gate"] == tp.Split(0, (e // M,) * M)
    assert plan["layers.0.moe.router"] is None
    assert tp.plan(cfg, M)["layers.0.moe.down"].dim == 1


EXTRA_KEYS = sorted(EXTRA)


@pytest.mark.parametrize("on,off", [("f32", "f32_no_remat"),
                                    ("bf16", "bf16_no_remat")])
@pytest.mark.parametrize("key", EXTRA_KEYS)
def test_remat_is_the_remat_off_round_bit_for_bit(world, key, on, off):
    """Activation checkpointing (``MeshConfig.remat``, the default) leaves
    every rank's pieces of the state bit for bit those of the round
    without it, for the ssm, rglru and moe blocks over the block, in f32
    (the kernels' plain versions: the scans' and B5's autograd Functions
    run twice a unit) and in bf16 (the reference's form)."""
    for a, b in zip(_cases(world, key, on), _cases(world, key, off)):
        for field in ("x", "cx"):
            assert set(a[field]) == set(b[field])
            for k in a[field]:
                assert torch.equal(a[field][k], b[field][k]), (field, k)
        for field in ("y", "cy"):
            assert torch.equal(a[field], b[field])


@pytest.mark.parametrize("key", EXTRA_KEYS)
def test_remat_recomputes_the_units_collectives(world, key):
    """Under remat the fsdp gathers and reduce-scatters run as often as
    without it (once a forward, before each unit), and the collectives
    inside the units run once more, in the recompute: more sequence
    gathers than reduce-scatters (a gather's recompute has no backward of
    its own), the RG-LRU's gate-input gathers likewise."""
    for on, off in zip(_cases(world, key, "f32"),
                       _cases(world, key, "f32_no_remat")):
        on, off = (r["counts"]["local_steps"] for r in (on, off))
        for kind in ("fsdp_gather", "reduce_scatter"):
            assert on[kind]["calls"] == off[kind]["calls"] > 0, kind
        assert off["seq_gather"]["calls"] == off["seq_scatter"]["calls"]
        assert on["seq_gather"]["calls"] > off["seq_gather"]["calls"]
        assert on["seq_scatter"]["calls"] > off["seq_scatter"]["calls"]
        if key == "recurrentgemma":
            assert on["model_gather"]["calls"] == 2 * off["model_gather"][
                "calls"] > 0


@pytest.mark.parametrize("key", EXTRA_KEYS)
def test_replicated_round_matches_the_reference_and_the_host_path(world,
                                                                  key):
    """``param_mode="replicated"`` (every weight whole on each rank of the
    block, the sequence split over model between the mixers, which run on
    it whole) against the reference's round and the host path at the f32
    tolerance; every rank of a client holds the same state bit for bit
    (``_gathered(whole=True)``); no weight is gathered, each gradient is
    summed over the block."""
    arch = _model(key)[1]
    want = _reference(arch, "float32")
    host = _host(arch, "float32", True)
    per_client = lambda d: [{k: v[c] for k, v in d.items()}  # noqa: E731
                            for c in range(N)]
    for x, cx, y, cy in (
            (_port_dicts(arch, want["x"]), _port_dicts(arch, want["cx"]),
             want["y"], want["cy"]),
            (per_client(host.x), per_client(host.cx), host.y.numpy(),
             host.cy.numpy())):
        errs = _errs(world, key, "replicated", x, cx, y, cy)
        assert all(v <= TOL_F32 for v in errs.values()), errs
    for rec in _cases(world, key, "replicated"):
        local = rec["counts"]["local_steps"]
        assert "fsdp_gather" not in local and local["grad_sum"]["calls"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b",
                                  "recurrentgemma-9b",
                                  "granite-moe-1b-a400m"])
def test_remat_at_one_rank_a_client_is_bit_for_bit(arch, dtype):
    """At one rank a client (the host path's round, which
    ``launch.steps.build_train_round`` runs where the block is one rank)
    the DRO problem with each unit under ``UnitRemat`` takes the round of
    the problem without it, bit for bit, for the four reduced models in
    f32 (the kernels' plain versions) and bf16 (the reference's form):
    one round, K = 1, 2 × 16 tokens a client."""
    tcfg = _cfgs(arch)[1]
    st = _port_state(arch)
    batch = {k: v[:1, :, :2, :16] for k, v in
             _batch(_inputs(arch)["batches"][0]).items()}
    cfg = AlgorithmConfig(**dict(ALGO, eta_cx=0.02), num_clients=N,
                          local_steps=1, mixing_impl="pallas_packed")
    out = []
    for remat in (True, False):
        prob = t_objectives.dro_problem(
            tcfg, num_groups=G, mu=1.0, compute_dtype=getattr(torch, dtype),
            kernels=dtype == "float32", remat=remat)
        state = KGTState(x=st["x"], y=st["y"], cx=st["cx"], cy=st["cy"],
                         round=0)
        out.append(t_kgt.make_round_step(prob, cfg, device="cpu")(
            state, batch, torch.zeros((1, N, 0))))
    a, b = out
    for field in ("x", "cx"):
        for k in st["x"]:
            assert torch.equal(getattr(a, field)[k],
                               getattr(b, field)[k]), (field, k)
    assert torch.equal(a.y, b.y) and torch.equal(a.cy, b.cy)
    assert not torch.equal(a.x["final_norm"], st["x"]["final_norm"])
