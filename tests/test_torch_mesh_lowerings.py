"""The decentralized mesh's lowerings over a halo exchange and its
compressed gossip (``core.kgt_minimax.make_round_step(axis=)``,
``dist.collectives.HaloPlan`` / ``halo_rows``, the row-block epilogues of
B1 and B4) against the JAX package and the port's host path.

* **The round level.**  On the synthetic quadratic (numpy data, state and
  residuals from a seed; the noise rows drawn from the reference's keys),
  n = 8 and 16, ring, exp and star, every case of ``sparse_packed``, the
  four robust impls, ``pallas_packed`` × {bf16, int8} compression and
  ``fused_round`` (the whole-round kernel over the gathered state), ×
  the four algorithms, × f32 and bf16 gossip runs ROUNDS rounds on each
  rank of spawned gloo worlds of 1, 2 and 4 ranks
  (``_torch_mesh_worker.round_cases``), through the port's host path here
  and, at one (n, topology) a case taken in turn, through the reference's
  ``make_round_step`` (the XLA oracle for the packed paths).
* **A cycle of W and traced stepsizes.**  ``topology_cycle`` ("ring",
  "exp") with the lowerings that take one (dense, fused_dense,
  pallas_packed, fused_round), twice its length in rounds, against the
  reference's cycled rounds and the host path; the stepsizes passed as
  ``point_etas``' bundle against the same round with them baked in, bit
  for bit.
* **The CLI level.**  ``launch.train --mesh decentralized`` on the reduced
  qwen2-0.5b over a world of 2 for each of those options, held to the
  port's host path from the same seed.
* **The row-block plain versions** of B1 (``ref.fused_gossip_ref`` with
  ``row0``) and B4 (``ref.sparse_gossip_ref`` over n_src sources) against
  the Pallas kernels in interpret mode on the whole matrix, sliced to a
  rank's rows.

Tolerances, max |got − want| ≤ tol·(1 + max|want|), stated before the
first reading: TOL_ROWS = 1e-5 against the reference and, for the linear
gossips, against the host path (a rank's local steps batch n/R clients,
and the epilogue contracts a row block); TOL_ROBUST = 1e-6 for the robust
rules against the host path (an order statistic of the same values; only
a trimmed mean's sum may round otherwise); a world of 1 bit for bit;
TOL_SIGMA_C = 1e-5 for Σ_i c_i = 0 on the linear gossips (not asserted for
the robust rules, which do not keep it); TOL_MESH_STATE = 1e-4 at the CLI
level (``tests/test_torch_mesh_train.py``'s); the plain versions at the
JAX package's kernel tolerances, 1e-6 (θ') and 4e-6 (c').
"""
import _torch_threads  # noqa: F401
import functools
import itertools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AlgorithmConfig as JaxConfig
from repro.core import kgt_minimax as jax_kgt
from repro.core import objectives as jax_objectives
from repro.core import sparse_topology as jax_sparse
from repro.core import topology as jax_topology
from repro.kernels import ops as jax_ops
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import compression
from repro_torch.core import kgt_minimax as kgt
from repro_torch.core import sparse_topology as tsparse
from repro_torch.core import topology as ttopology
from repro_torch.core.objectives import quadratic_problem
from repro_torch.dist import collectives
from repro_torch.dist import launch as dist_launch
from repro_torch.kernels import ref as tref

import _torch_mesh_worker as worker

TOL_ROWS = 1e-5
TOL_ROBUST = 1e-6
TOL_SIGMA_C = 1e-5
TOL_MESH_STATE = 1e-4
ATOL_KERNEL, ATOL_KERNEL_C = 1e-6, 4e-6
K, DX, DY, ROUNDS, SIGMA = 2, 5, 3, 2, 0.1
NS = (8, 16)
TOPOLOGIES = ("ring", "exp", "star")
WORLDS = (1, 2, 4)
ALGOS = ("kgt_minimax", "gt_gda", "dsgda", "local_sgda")
TRACKING = ("kgt_minimax", "gt_gda")
GOSSIP_DTYPES = ("float32", "bfloat16")
ROBUST = ("coord_median", "trimmed_mean", "sparse_coord_median",
          "sparse_trimmed_mean")
# (mixing_impl, gossip_compress)
IMPLS = (("sparse_packed", None), *((r, None) for r in ROBUST),
         ("pallas_packed", "bf16"), ("pallas_packed", "int8"),
         ("fused_round", None))
CFG = dict(local_steps=K, eta_cx=0.01, eta_cy=0.1, eta_sx=0.5, eta_sy=0.5)
FIELDS = ("x", "y", "cx", "cy", "ef_x", "ef_y")


def _impl_id(impl, compress):
    return impl if compress is None else f"{impl}+{compress}"


CASES = [(impl, comp, algo, gd, topo, n)
         for (impl, comp), algo, gd, topo, n in itertools.product(
             IMPLS, ALGOS, GOSSIP_DTYPES, TOPOLOGIES, NS)]
# a cycle of W on the mesh (run for twice its length in rounds) with the
# lowerings that take one, and traced stepsizes (``point_etas``' bundle):
# (impl, compress, algorithm, gossip dtype, topology, n, cycle, traced)
CYCLE = ("ring", "exp")
CYCLE_IMPLS = ("dense", "fused_dense", "pallas_packed", "fused_round")
CYCLE_CASES = [(impl, None, algo, gd, "ring", 8, CYCLE, False)
               for impl in CYCLE_IMPLS for algo in ("kgt_minimax", "dsgda")
               for gd in GOSSIP_DTYPES]
TRACED_IMPLS = ("dense", "pallas_packed", "sparse_packed", "fused_round",
                "trimmed_mean")
TRACED_CASES = [(impl, None, "kgt_minimax", "float32", "exp", 8, (), True)
                for impl in TRACED_IMPLS] + [
    ("pallas_packed", None, "kgt_minimax", "float32", "ring", 8, CYCLE,
     True)]
# the traced cases' rounds with the stepsizes baked in (the cycled one's
# is a CYCLE_CASES case)
BAKED_CASES = [c[:7] + (False,) for c in TRACED_CASES if not c[6]]
OPTION_CASES = CYCLE_CASES + TRACED_CASES + BAKED_CASES
# the reference's cases: every (impl, algorithm, gossip dtype), each at one
# (n, topology), taken in turn so that every pair is held
REF_CASES = {(impl, comp, algo, gd): pair
             for ((impl, comp), algo, gd), pair in zip(
                 itertools.product(IMPLS, ALGOS, GOSSIP_DTYPES),
                 itertools.cycle(itertools.product(NS, TOPOLOGIES)))}


def _keys(t, n):
    return jax.random.split(jax.random.PRNGKey(100 + t),
                            K * n).reshape(K, n, 2)


@jax.jit
@jax.vmap
def _noise_row(k):
    """The reference quadratic's noise row of one key (its ``grads``)."""
    kx, ky = jax.random.split(k)
    return jnp.concatenate([jax.random.normal(kx, (DX,)),
                            jax.random.normal(ky, (DY,))])


@functools.lru_cache(maxsize=None)
def _inputs(n):
    """Numpy data, initial states (by algorithm and compression) and the
    rounds' noise rows at n clients."""
    rng = np.random.default_rng(n)

    def rn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    a = rn(n, DX, DX, scale=0.5)
    data = {"A": (a + a.transpose(0, 2, 1)) / 2, "B": rn(n, DY, DX, scale=0.3),
            "b": rn(n, DY), "q": rn(n, DX), "mu": 1.0}
    x, y = rn(n, DX), rn(n, DY)
    cx, cy = rn(n, DX, scale=0.3), rn(n, DY, scale=0.3)
    cx, cy = cx - cx.mean(0), cy - cy.mean(0)
    states = {}
    for algo, comp in itertools.product(ALGOS, (None, "bf16", "int8")):
        track = algo in TRACKING
        states[(algo, comp)] = dict(
            x=x, y=y, cx=cx if track else np.zeros_like(cx),
            cy=cy if track else np.zeros_like(cy),
            ef_x=None if comp is None else rn(n, DX, scale=1e-3),
            ef_y=None if comp is None else rn(n, DY, scale=1e-3))
    noise = [np.asarray(_noise_row(_keys(t, n).reshape(-1, 2))).reshape(
        K, n, DX + DY) for t in range(ROUNDS)]
    return data, states, noise


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _port_inputs(n):
    data, states, noise = _inputs(n)
    tdata = {k: (_t(v) if k != "mu" else v) for k, v in data.items()}
    return dict(data=tdata, sigma=SIGMA, cfg=CFG,
                state={key: kgt.KGTState(**{f: _t(v) for f, v in s.items()},
                                         round=0)
                       for key, s in states.items()},
                batches={k: v.unsqueeze(0).expand(K, *v.shape)
                         for k, v in tdata.items() if k != "mu"},
                noise=[_t(z) for z in noise])


def _cfg_kw(impl, comp, algo, gd, topo, n):
    return dict(CFG, algorithm=algo, num_clients=n, topology=topo,
                mixing_impl=impl, gossip_dtype=gd, gossip_compress=comp)


def _rounds(cycle):
    """The rounds a case runs: twice a cycle's length, else ROUNDS."""
    return 2 * len(cycle) if cycle else ROUNDS


@functools.lru_cache(maxsize=None)
def _host_run(impl, comp, algo, gd, topo, n, cycle=()):
    """The port's host path on the case: the final state's fields."""
    inp = _port_inputs(n)
    prob = quadratic_problem(inp["data"], sigma=SIGMA)
    step = kgt.make_round_step(
        prob, AlgorithmConfig(**_cfg_kw(impl, comp, algo, gd, topo, n),
                              topology_cycle=cycle), device="cpu")
    state = inp["state"][(algo, comp)]
    for t in range(_rounds(cycle)):
        state = step(state, inp["batches"], inp["noise"][t % ROUNDS])
    return {f: getattr(state, f) for f in FIELDS}


@functools.lru_cache(maxsize=None)
def _reference_run(impl, comp, algo, gd, topo, n, cycle=()):
    """The reference's ``make_round_step`` on the case (host, jitted; the
    XLA oracle for the packed paths; its W picked by the traced round
    under a cycle): the final state's fields (numpy)."""
    data, states, _ = _inputs(n)
    prob = jax_objectives.quadratic_problem(
        {k: (jnp.asarray(v) if k != "mu" else v) for k, v in data.items()},
        sigma=SIGMA)
    cfg = JaxConfig(**_cfg_kw(impl, comp, algo, gd, topo, n),
                    gossip_backend="xla", topology_cycle=cycle)
    step = jax.jit(jax_kgt.make_round_step(prob, cfg))
    st = jax_kgt.KGTState(**{f: None if v is None else jnp.asarray(v)
                             for f, v in states[(algo, comp)].items()},
                          round=jnp.int32(0))
    batches = {k: jnp.broadcast_to(jnp.asarray(v)[None], (K, *v.shape))
               for k, v in data.items() if k != "mu"}
    for t in range(_rounds(cycle)):
        st = step(st, batches, _keys(t % ROUNDS, n))
    return {f: None if getattr(st, f) is None else np.asarray(getattr(st, f))
            for f in FIELDS}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case on every rank of a world of 1, 2 and 4 gloo ranks:
    {world: [rank's {case: record}]}.  The reference's runs are compiled
    here while the worlds run (its jitted steps, ~1 s each on the CPU, are
    most of this file's time)."""
    d = tmp_path_factory.mktemp("mesh_lowerings")
    path = str(d / "inputs.pt")
    torch.save({n: _port_inputs(n) for n in NS}, path)
    out = {}

    def run_worlds():
        for world in WORLDS:
            ranks = dist_launch.run_world(world, worker.round_cases, path,
                                          CASES + OPTION_CASES,
                                          backend="gloo", store_dir=str(d))
            out[world] = [{rec["case"]: rec for rec in recs}
                          for recs in ranks]

    thread = threading.Thread(target=run_worlds)
    thread.start()
    try:
        for (impl, comp, algo, gd), (n, topo) in REF_CASES.items():
            _reference_run(impl, comp, algo, gd, topo, n)
        for case in CYCLE_CASES:
            _reference_run(*case[:7])
    finally:
        thread.join()
    assert set(out) == set(WORLDS)
    return out


def _err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / (1.0 + float(
        np.abs(want).max()))


def _rows_err(rec, want):
    lo, hi = rec["rows"]
    return {f: _err(rec["state"][f].numpy(), np.asarray(want[f])[lo:hi])
            for f in FIELDS if want[f] is not None}


IMPL_IDS = [_impl_id(*ic) for ic in IMPLS]


@pytest.mark.parametrize("gd", GOSSIP_DTYPES)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("impl,comp", IMPLS, ids=IMPL_IDS)
def test_mesh_rows_match_the_reference(worlds, impl, comp, algo, gd):
    n, topo = REF_CASES[(impl, comp, algo, gd)]
    case = (impl, comp, algo, gd, topo, n)
    want = _reference_run(*case)
    for world in (2, 4):
        for rank in worlds[world]:
            errs = _rows_err(rank[case], want)
            assert max(errs.values()) <= TOL_ROWS, (world, errs)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("gd", GOSSIP_DTYPES)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("impl,comp", IMPLS, ids=IMPL_IDS)
def test_mesh_rows_match_the_host_path(worlds, impl, comp, algo, gd, world):
    tol = TOL_ROBUST if impl in ROBUST else TOL_ROWS
    for topo, n in itertools.product(TOPOLOGIES, NS):
        case = (impl, comp, algo, gd, topo, n)
        want = _host_run(*case)
        for rank in worlds[world]:
            errs = _rows_err(rank[case], want)
            assert max(errs.values()) <= tol, (topo, n, errs)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("impl,comp", IMPLS, ids=IMPL_IDS)
def test_a_world_of_one_is_the_host_path_bit_for_bit(worlds, impl, comp,
                                                     algo):
    (rank,) = worlds[1]
    for gd, topo, n in itertools.product(GOSSIP_DTYPES, TOPOLOGIES, NS):
        case = (impl, comp, algo, gd, topo, n)
        got, want = rank[case], _host_run(*case)
        for f in FIELDS:
            if want[f] is not None:
                assert torch.equal(got["state"][f], want[f]), (case, f)
        assert got["gossip"] == {} and got["local_steps"] == {}


def _halo_formula(impl, comp, algo, gd, topo, n, world, rank):
    """The gossip's calls and bytes of ROUNDS rounds on one rank: the halo
    exchanges — (Δ, θ) stacked a variable for sparse_packed with
    tracking, θ + η_sΔ a variable without; R(θ + η_sΔ) and, with tracking,
    R(Δ) a variable for the robust rules — each receiving the plan's
    n_halo rows in the gossip dtype, and no call on a rank that neither
    sends nor receives; pallas_packed, one all-gather a variable of
    (R − 1)·(n/R) rows of (Δ, θ), or θ + η_sΔ without tracking;
    fused_round, the whole round's operands gathered, f32: z₀, c, the
    residual, G and each local step's h (one step for gt_gda and
    dsgda)."""
    elt = 4 if gd == "float32" else 2
    track = algo in TRACKING
    axis = collectives.ClientsAxis(n=n, rank=rank, size=world)
    rows = (world - 1) * (n // world)
    dz = DX + DY
    if impl == "fused_round":
        k = 1 if algo in ("gt_gda", "dsgda") else K
        per_round = {"all_gather": (5, rows * (3 * dz + dz * dz + k * dz)
                                    * 4)}
    elif impl == "pallas_packed":
        per_round = {"all_gather": (2, rows * (2 if track else 1)
                                    * (DX + DY) * elt)}
    else:
        w = (tsparse.sparse_mixing_matrix(topo, n)
             if impl.startswith("sparse_") else
             tsparse.from_dense(ttopology.mixing_matrix(topo, n)))
        plan = collectives.halo_plan(w, axis)
        if not plan.active:
            return {}, plan
        if impl == "sparse_packed":
            per_round = {"halo": (2, plan.n_halo * (2 if track else 1)
                                  * (DX + DY) * elt)}
        else:
            per_round = {"halo": (4 if track else 2, plan.n_halo
                                  * (2 if track else 1) * (DX + DY) * elt)}
    return ({k: (c * ROUNDS, b * ROUNDS) for k, (c, b) in per_round.items()},
            None if "all_gather" in per_round else plan)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("impl,comp", IMPLS, ids=IMPL_IDS)
def test_gossip_calls_and_bytes_are_the_plans_formula(worlds, impl, comp,
                                                      world):
    """The sparse and robust gossips move the halo's rows and no more: on
    a ring every rank receives two rows, not the all-gather's n − n/R."""
    for case in CASES:
        if case[:2] != (impl, comp):
            continue
        for r, rank in enumerate(worlds[world]):
            want, plan = _halo_formula(*case, world, r)
            assert rank[case]["gossip"] == want, (case, r)
            assert rank[case]["local_steps"] == {}
            if plan is not None:
                n = case[-1]
                assert plan.n_halo <= n - n // world
                if case[4] == "ring":
                    assert plan.n_halo == 2


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("algo", TRACKING)
@pytest.mark.parametrize("impl,comp", [ic for ic in IMPLS
                                       if ic[0] not in ROBUST],
                         ids=[_impl_id(*ic) for ic in IMPLS
                              if ic[0] not in ROBUST])
def test_sigma_c_is_zero_across_ranks(worlds, impl, comp, algo, world):
    # f32 gossip: a bf16-narrowed W is not doubly stochastic
    for topo, n in itertools.product(TOPOLOGIES, NS):
        case = (impl, comp, algo, "float32", topo, n)
        recs = [rank[case] for rank in worlds[world]]
        for f in ("cx", "cy"):
            total = sum(rec["c_sums"][f] for rec in recs)
            top = max(float(rec["state"][f].abs().max()) for rec in recs)
            assert float(total.abs().max()) / n <= TOL_SIGMA_C * (1 + top)


@pytest.mark.parametrize("gd", GOSSIP_DTYPES)
@pytest.mark.parametrize("algo", ("kgt_minimax", "dsgda"))
@pytest.mark.parametrize("impl", CYCLE_IMPLS)
def test_a_cycle_on_the_mesh_matches_the_reference(worlds, impl, algo, gd):
    """``topology_cycle`` on the mesh (each W's rows of the rank stacked,
    picked by the round's index): twice the cycle's rounds on worlds of 2
    and 4 against the reference's cycled rounds and the host path's at
    TOL_ROWS, and on a world of 1 the host path's bit for bit."""
    case = (impl, None, algo, gd, "ring", 8, CYCLE, False)
    want = _reference_run(*case[:7])
    host = _host_run(*case[:7])
    for world in (2, 4):
        for rank in worlds[world]:
            for errs in (_rows_err(rank[case], want),
                         _rows_err(rank[case], host)):
                assert max(errs.values()) <= TOL_ROWS, (world, errs)
    (one,) = worlds[1]
    for f in FIELDS:
        if host[f] is not None:
            assert torch.equal(one[case]["state"][f], host[f]), f
    # the cycle moved the trajectory: round 2 mixed with exp, not ring
    static = _host_run(impl, None, algo, gd, "ring", 8)
    assert not torch.equal(host["x"], static["x"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", TRACED_CASES,
                         ids=[f"{c[0]}{'+cycle' if c[6] else ''}"
                              for c in TRACED_CASES])
def test_traced_etas_are_the_static_round_bit_for_bit(worlds, case, world):
    """``make_round_step(axis=, traced_etas=True)`` fed ``point_etas``'
    bundle is the mesh round with those stepsizes baked in, bit for bit
    (the reference's own claim, ``repro/core/kgt_minimax.py:159-166``),
    on every rank of worlds of 1, 2 and 4, with a static W and a cycle."""
    static = case[:7] + (False,)
    for rank in worlds[world]:
        got, want = rank[case]["state"], rank[static]["state"]
        for f in FIELDS:
            if want[f] is not None:
                assert torch.equal(got[f], want[f]), (case, f)
        assert rank[case]["gossip"] == rank[static]["gossip"]


@pytest.mark.parametrize("method", compression.COMPRESS_METHODS)
def test_a_ranks_q_is_the_host_paths_bit_for_bit(method):
    """``ef_transmit`` is row-local (int8's scale is a row's), so a rank
    quantizing its own rows transmits the host path's q of those rows."""
    rng = np.random.default_rng(3)
    delta = torch.as_tensor(rng.standard_normal((8, 37)).astype(np.float32))
    ef = torch.as_tensor(rng.standard_normal((8, 37)).astype(np.float32)
                         * 1e-3)
    q, e = compression.ef_transmit(delta, ef, method)
    for lo, hi in ((0, 4), (4, 8), (2, 4)):
        q_r, e_r = compression.ef_transmit(delta[lo:hi], ef[lo:hi], method)
        assert torch.equal(q_r, q[lo:hi]) and torch.equal(e_r, e[lo:hi])


@pytest.mark.parametrize("impl", ROBUST)
def test_robust_rules_reduce_column_blocks_bit_for_bit(impl, monkeypatch):
    """The robust rules reduce a language model's D in blocks of
    ``mixing.ROBUST_CHUNK`` candidates; each coordinate is its own, so
    blocks of a few columns give one block's values, on the host path and
    over a rank's halo: a median bit for bit, a trimmed mean within
    TOL_ROBUST (``torch.sum`` may group a block's slots otherwise)."""
    from repro_torch.core import mixing

    n, d = 8, 37
    buf = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (n, d)).astype(np.float32))
    rule = mixing.robust_rule(impl)
    if impl.startswith("sparse_"):
        w = tsparse.sparse_mixing_matrix("exp", n)
        red = mixing.robust_mix_sparse
    else:
        w = torch.as_tensor(ttopology.mixing_matrix("exp", n))
        red = mixing.robust_mix_dense
    axis = collectives.ClientsAxis(n=n, rank=1, size=2)
    plan = collectives.halo_plan(
        w if impl.startswith("sparse_") else tsparse.from_dense(w), axis)
    rows, halo = buf[axis.lo:axis.hi], buf[plan.cols[axis.n_local:]]

    def both():
        whole = red(buf, w, rule=rule, trim=1)
        if impl.startswith("sparse_"):
            part = red(rows, plan.table, rule=rule, trim=1, halo=halo)
        else:
            part = red(rows, w[axis.lo:axis.hi], rule=rule, trim=1,
                       halo=halo, cols=plan.cols, row0=axis.lo)
        return whole, part

    def same(a, b):
        if rule == "coord_median":
            return torch.equal(a, b)
        return float((a - b).abs().max()) <= TOL_ROBUST * (
            1 + float(b.abs().max()))

    want = both()
    monkeypatch.setattr(mixing, "ROBUST_CHUNK", 2 * 3 * n)
    got = both()
    for a, b in zip(got, want):
        assert same(a, b)
    assert same(got[1], got[0][axis.lo:axis.hi])
    assert same(want[1], want[0][axis.lo:axis.hi])


PLAN_CASES = [(topo, n, world) for topo in TOPOLOGIES for n in NS
              for world in WORLDS]


@pytest.mark.parametrize("topo,n,world", PLAN_CASES)
def test_halo_plans_agree_across_ranks(topo, n, world):
    """What each rank receives from a peer is what the peer sends it, the
    remapped table reads the global lists' rows, and padding stays on the
    row's own local index with weight 0.  On a star the hub's rank reads
    every other row and every other rank reads only the hub."""
    sp = tsparse.sparse_mixing_matrix(topo, n)
    plans = [collectives.halo_plan(sp, collectives.ClientsAxis(
        n=n, rank=r, size=world)) for r in range(world)]
    k = n // world
    for r, plan in enumerate(plans):
        for p in range(world):
            assert tuple(g - p * k for g in plan.recv[p]) == \
                plans[p].send[r]
        tab = plan.table
        rows = slice(r * k, (r + 1) * k)
        got = plan.cols[tab.neighbor_idx.long()]
        assert torch.equal(got, sp.neighbor_idx[rows].long())
        pad = tab.neighbor_w == 0
        own = torch.arange(k)[:, None].expand(k, sp.max_degree)
        assert torch.equal(tab.neighbor_idx.long()[pad], own[pad])
        assert torch.equal(plan.cols[:k], torch.arange(r * k, (r + 1) * k))
        if world == 1:
            assert not plan.active and torch.equal(tab.neighbor_idx,
                                                   sp.neighbor_idx)
    if topo == "star" and world > 1:
        assert plans[0].n_halo == n - k
        assert all(p.recv[0] == (0,) and p.n_halo == 1 for p in plans[1:])


# ---------------------------------------------------------------------------
# the row-block plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _operands(n, d, seed):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((n, d)) * s).astype(np.float32)
                 for s in (1.0, 3.0, 0.5))


@pytest.mark.parametrize("gd", [None, "bfloat16"])
@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_row_block_b1_plain_version_matches_the_pallas_kernel(topo, world,
                                                              gd):
    n, d, eta_s, corr = 8, 300, 0.7, 4.2
    w = jax_topology.mixing_matrix(topo, n).astype(np.float32)
    delta, theta, c = _operands(n, d, world)
    jt, jc = jax_ops.fused_gossip_round(
        w, jnp.asarray(delta), jnp.asarray(theta), jnp.asarray(c), eta_s,
        corr, backend="interpret", gossip_dtype=gd)
    k = n // world
    for r in range(world):
        lo, hi = r * k, (r + 1) * k
        tt, tc = tref.fused_gossip_ref(
            _t(w[lo:hi]), _t(delta), _t(theta), _t(c[lo:hi]), eta_s, corr,
            gossip_dtype=gd, row0=lo)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt)[lo:hi],
                                   rtol=0, atol=ATOL_KERNEL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc)[lo:hi],
                                   rtol=0, atol=ATOL_KERNEL_C)


@pytest.mark.parametrize("gd", [None, "bfloat16"])
@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_row_block_b4_plain_version_matches_the_pallas_kernel(topo, world,
                                                              gd):
    """B4's plain version on a rank's remapped table over [own rows; halo
    rows] (n_src sources) against the Pallas kernel on the whole lists,
    sliced to the rank's rows; the tolerance scaled as
    ``tests/test_torch_sparse.py`` scales it."""
    n, d, eta_s, corr = 16, 300, 0.7, 4.2
    jsp = jax_sparse.sparse_mixing_matrix(topo, n)
    delta, theta, c = _operands(n, d, 10 + world)
    jt, jc = jax_ops.sparse_gossip_round(
        jsp.neighbor_idx, jsp.neighbor_w, jsp.self_w, jnp.asarray(delta),
        jnp.asarray(theta), jnp.asarray(c), eta_s, corr, backend="interpret",
        gossip_dtype=gd)
    jt, jc = np.asarray(jt), np.asarray(jc)
    sp = tsparse.sparse_mixing_matrix(topo, n)
    for r in range(world):
        plan = collectives.halo_plan(sp, collectives.ClientsAxis(
            n=n, rank=r, size=world))
        lo, hi = plan.cols[0].item(), plan.cols[0].item() + n // world
        src = plan.cols.numpy()
        tab = plan.table
        tt, tc = tref.sparse_gossip_ref(
            tab.neighbor_idx, tab.neighbor_w, tab.self_w, _t(delta[src]),
            _t(theta[src]), _t(c[lo:hi]), eta_s, corr, gossip_dtype=gd)
        assert tuple(tt.shape) == (hi - lo, d)
        for got, want in ((tt, jt[lo:hi]), (tc, jc[lo:hi])):
            assert _err(got.numpy(), want) <= ATOL_KERNEL


# ---------------------------------------------------------------------------
# the CLI level: launch.train --mesh decentralized on a world of 2
# ---------------------------------------------------------------------------

CLI_ARCH, CLI_N, CLI_WORLD = "qwen2-0.5b", 4, 2
CLI_ARGS = dict(arch=CLI_ARCH, reduced=True, algorithm="kgt_minimax",
                rounds=1, clients=CLI_N, local_steps=1, batch=2, seq_len=16,
                groups=4, mu=1.0, alpha=0.3, eta_cx=0.02, eta_cy=0.2,
                eta_s=0.7, topology="ring", gossip_dtype="float32",
                schedule="constant", warmup=0, seed=0, log_every=1,
                checkpoint_every=0, checkpoint_dir="checkpoints/test",
                out=None, engine="host", chunk=1, device="cpu")
# fused_round needs an affine_coeffs oracle, which the DRO problem has not
CLI_OPTIONS = [(impl, comp) for impl, comp in IMPLS if impl != "fused_round"]


def _cli_args(**over):
    from repro_torch.launch import train as t_train

    args = t_train.parser().parse_args(["--arch", CLI_ARCH])
    for k, v in {**CLI_ARGS, **over}.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each option on the host path here and on a world of 2 (the ranks
    draw their own data from the same seed)."""
    from repro_torch.launch import train as t_train

    d = tmp_path_factory.mktemp("mesh_lowerings_cli")
    host, runs = {}, []
    for impl, comp in CLI_OPTIONS:
        name = _impl_id(impl, comp)
        over = dict(mixing_impl=impl, gossip_compress=comp)
        host[name] = t_train.train(_cli_args(mesh="host", **over))
        if comp == "int8":
            # a compressed state's checkpoint, gathered and written by rank 0
            over.update(checkpoint_every=1,
                        checkpoint_dir=str(d / "int8_ckpt"))
        runs.append((name, dict(vars(_cli_args(mesh="decentralized",
                                               **over))), None))
    ranks = dist_launch.run_world(CLI_WORLD, worker.train_cases, None, runs,
                                  backend="gloo", store_dir=str(d))
    return host, ranks, d


@pytest.mark.parametrize("impl,comp", CLI_OPTIONS,
                         ids=[_impl_id(*ic) for ic in CLI_OPTIONS])
def test_cli_mesh_matches_the_host_path(cli_runs, impl, comp):
    from repro_torch.core import tree as tree_lib

    host, ranks, _ = cli_runs
    name = _impl_id(impl, comp)
    got, want = ranks[0][name]["state"], host[name]["state"]
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(b)):
            assert _err(x.float().numpy(), y.float().numpy()) <= \
                TOL_MESH_STATE, (name, f)
    for rank in ranks:
        counts = rank[name]["counts"]
        assert "local_steps" not in counts
        kind = "all_gather" if impl == "pallas_packed" else "halo"
        assert set(counts["gossip"]) == {kind}


def test_cli_mesh_checkpoint_carries_the_residuals(cli_runs):
    """The mesh's checkpoint of a compressed run holds every client's EF
    residuals (``collectives.gather_tree`` walks ``ef_x`` / ``ef_y``), and
    it resumes on the host path and, sharded, on a rank's rows."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import train as t_train

    _, ranks, d = cli_runs
    mesh = ranks[0]["pallas_packed+int8"]["state"]
    template = t_train.build(_cli_args(
        mesh="host", mixing_impl="pallas_packed",
        gossip_compress="int8")).state
    restored = ckpt_lib.restore(str(d / "int8_ckpt" / "round_000001.npz"),
                                template)
    assert restored.ef_x.shape == (CLI_N, template.ef_x.shape[1])
    for a, b in zip(tree_lib.leaves(restored), tree_lib.leaves(mesh)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    axis = collectives.ClientsAxis(n=CLI_N, rank=1, size=CLI_WORLD)
    rows = collectives.shard_tree(restored, axis)
    assert torch.equal(rows.ef_y, mesh.ef_y[axis.lo:axis.hi])
