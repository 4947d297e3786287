"""The port's distribution subsystem (``repro_torch.dist``) against
``repro.dist`` and ``repro.core.mixing``.

* Specs: ``params_shardings`` (every ``param_mode``, ``expert_parallel``
  on and off) and ``serve_params_shardings`` of every registered config
  at full size, on abstract meshes (2, 2, 2), (4, 4, 16) and (data 4,
  model 2): the port's placements (on meta tensors laid out as the
  reference's stacked tree) name the same dims as the reference's
  ``PartitionSpec`` (on ``jax.eval_shape``'s), leaf for leaf.
* The context (the reference's ``tests/test_dist.py:145-200``).
* Collectives: dense, ring and packed gossip over gloo sub-groups of 1, 2
  and 4 ranks of one spawned world (every transfer split over the stream
  groups), at n = 4 and 8, in f32 and bf16 gossip, against ``repro.core.mixing.mix_dense`` / ``mix_ring`` and
  ``repro.kernels.ref.fused_gossip_ref`` (the reference's packed
  epilogue) on the same numpy inputs; the counted calls and bytes equal
  the formula.  The world is spawned once for the file.
* ``repro_torch.launch.smoke`` in a subprocess: its train legs at
  ``(clients 2, 1, 1)``, the reference's train legs at ``(clients 2, fsdp
  2, model 2)`` (the MoE arch's wait) and its serving legs.
"""
import _torch_threads  # noqa: F401
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jax_registry
from repro.core import mixing as jax_mixing
from repro.dist import compat as jax_compat
from repro.dist import context as jax_ctx
from repro.dist import sharding as jax_sh
from repro.kernels import ref as jax_kref
from repro.models import model as jax_model
from repro_torch.configs import registry
from repro_torch.dist import collectives
from repro_torch.dist import compat
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import launch as dist_launch
from repro_torch.dist import sharding as sh
from repro_torch.models import interop
from repro_torch.models import model as t_model

import _torch_mesh_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STACK = 4
DEC_MESHES = ({"clients": 2, "fsdp": 2, "model": 2},
              {"clients": 4, "fsdp": 4, "model": 16})
SERVE_MESH = {"data": 4, "model": 2}
# the collectives against the reference's mixing, × (1 + max|reference|):
# the same f32 products, the sums maybe in another order
TOL_MIX = 1e-6


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_sds(arch, n):
    cfg = jax_registry.get_model_config(arch)
    one = jax.eval_shape(lambda k: jax_model.init_params(cfg, k),
                         jax.random.PRNGKey(0))
    if n is None:
        return one
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct((n, *s.shape),
                                                       s.dtype), one)


@functools.lru_cache(maxsize=None)
def _port_meta(arch, n):
    """The port model's parameters on the meta device laid out as the
    reference's tree: each block's tensors stacked over its repeats (and
    over n clients)."""
    cfg = registry.get_model_config(arch)
    model = t_model.skeleton(cfg)
    lead = () if n is None else (n,)

    def meta(*shape):
        return torch.empty((*lead, *shape), device="meta")

    out = {"embed": meta(*model.embed.shape),
           "final_norm": meta(*model.final_norm.shape)}
    if model.head is not None:
        out["head"] = meta(*model.head.shape)
    stack = []
    for unit in interop._by_slot(cfg, list(model.layers)):
        blocks = []
        for layers in unit:
            block = {}
            for name, p in layers[0].named_parameters():
                head, _, leaf = name.partition(".")
                t = meta(len(layers), *p.shape)
                if leaf:
                    block.setdefault(head, {})[leaf] = t
                else:
                    block[head] = t
            blocks.append(block)
        stack.append(tuple(blocks))
    out["stack"] = tuple(stack)
    return out


def _named_dims(placements, names, ndim):
    """Placements -> the axis name on each dim (None: on none)."""
    parts = [None] * ndim
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            assert parts[p.dim] is None
            parts[p.dim] = name
        else:
            assert isinstance(p, Replicate)
    return parts


def _spec_dims(spec, ndim):
    parts = list(spec) + [None] * (ndim - len(spec))
    return [p if p is None or isinstance(p, str) else tuple(p)
            for p in parts]


def _compare(ref_tree, ref_shards, port_tree, port_shards, names):
    ref_leaves = jax.tree.leaves(ref_tree)
    port_leaves = jax.tree.leaves(port_tree,
                                  is_leaf=lambda x: isinstance(x, torch.Tensor))
    ref_specs = jax.tree.leaves(ref_shards)
    port_specs = jax.tree.leaves(port_shards,
                                 is_leaf=lambda x: isinstance(x, tuple)
                                 and all(isinstance(p, (Shard, Replicate))
                                         for p in x))
    assert len(ref_leaves) == len(port_leaves) == len(ref_specs) == len(
        port_specs)
    for r, p, rs, ps in zip(ref_leaves, port_leaves, ref_specs, port_specs):
        assert tuple(r.shape) == tuple(p.shape)
        assert _named_dims(ps, names, len(r.shape)) == _spec_dims(
            rs.spec, len(r.shape)), (r.shape, rs.spec, ps)


@pytest.mark.parametrize("mesh_sizes", DEC_MESHES,
                         ids=lambda m: "x".join(map(str, m.values())))
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_params_shardings_match_the_reference(arch, mesh_sizes):
    ref_tree = _reference_sds(arch, N_STACK)
    port_tree = _port_meta(arch, N_STACK)
    jmesh = jax_compat.abstract_mesh(mesh_sizes)
    tmesh = compat.abstract_mesh(mesh_sizes)
    for mode in ("fsdp2d", "replicated", "other"):
        for ep in (False, True):
            kw = dict(leading_clients=True, param_mode=mode,
                      expert_parallel=ep)
            _compare(ref_tree, jax_sh.params_shardings(ref_tree, jmesh, **kw),
                     port_tree, sh.params_shardings(port_tree, tmesh, **kw),
                     tuple(mesh_sizes))


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_serve_params_shardings_match_the_reference(arch):
    ref_tree = _reference_sds(arch, None)
    port_tree = _port_meta(arch, None)
    jmesh = jax_compat.abstract_mesh(SERVE_MESH)
    tmesh = compat.abstract_mesh(SERVE_MESH)
    for ep in (False, True):
        _compare(ref_tree,
                 jax_sh.serve_params_shardings(ref_tree, jmesh,
                                               expert_parallel=ep),
                 port_tree,
                 sh.serve_params_shardings(port_tree, tmesh,
                                           expert_parallel=ep),
                 tuple(SERVE_MESH))


def test_port_parameter_names_carry_the_expert_rule():
    """On the port's own flat parameter dict (dotted names) the expert
    leaves of a MoE model take the model axis on their experts dim."""
    cfg = registry.get_model_config("granite-moe-1b-a400m")
    params = {name: torch.empty((4, *p.shape), device="meta") for name, p
              in t_model.param_dict(t_model.skeleton(cfg)).items()}
    mesh = compat.abstract_mesh({"clients": 4, "fsdp": 4, "model": 16})
    specs = sh.params_shardings(params, mesh, expert_parallel=True)
    experts = [k for k in specs if k.split(".")[-1] in ("gate", "up", "down")
               and ".moe." in k]
    assert experts
    for k in experts:
        assert specs[k][2] == Shard(params[k].dim() - 3), k
        assert specs[k][0] == Shard(0)


@pytest.mark.parametrize("mode", ["batch", "batch_seq"])
def test_residual_axes_match_the_reference(mode):
    assert sh.residual_axes(mode) == jax_sh.residual_axes(mode)


def test_residual_axes_refuse_an_unknown_mode():
    with pytest.raises(ValueError):
        sh.residual_axes("bogus")


@pytest.mark.parametrize("mode", ["batch", "batch_seq"])
def test_leading_dims_constraint_passes_plain_tensors_through(mode):
    fn = sh.leading_dims_constraint(
        compat.abstract_mesh({"clients": 1, "fsdp": 1, "model": 1}),
        sh.residual_axes(mode))
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert fn(x) is x
    v = torch.arange(3.0)
    assert fn(v) is v


def test_abstract_mesh_sizes():
    m = compat.abstract_mesh({"clients": 4, "fsdp": 4, "model": 16})
    assert compat.axis_sizes(m) == dict(jax_compat.abstract_mesh(
        {"clients": 4, "fsdp": 4, "model": 16}).shape)
    assert m.size == 256


# ---------------------------------------------------------------------------
# context (the reference's tests/test_dist.py:145-200, mirrored)
# ---------------------------------------------------------------------------

def test_apply_is_identity_without_context():
    x = torch.ones((2, 3))
    assert dist_ctx.apply("attn_qkv", x) is x
    assert dist_ctx.apply_residual(x) is x
    assert dist_ctx.current_slots() == {}
    assert jax_ctx.current_slots() == {}


def test_residual_constraint_installs_and_restores():
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        return x

    x = torch.ones((2, 3))
    with dist_ctx.residual_constraint(fn):
        assert dist_ctx.apply_residual(x) is x
    assert calls == [(2, 3)]
    dist_ctx.apply_residual(x)
    assert calls == [(2, 3)]  # popped on exit


def test_tagged_slots_and_nesting_shadowing():
    order = []
    outer = {"attn_qkv": lambda x: order.append("outer_qkv") or x,
             "attn_out": lambda x: order.append("outer_out") or x}
    inner_qkv = lambda x: order.append("inner_qkv") or x  # noqa: E731
    x = torch.zeros(())
    with dist_ctx.residual_constraint(**outer):
        with dist_ctx.residual_constraint(attn_qkv=inner_qkv):
            dist_ctx.apply("attn_qkv", x)   # inner shadows outer
            dist_ctx.apply("attn_out", x)   # falls through to outer
        dist_ctx.apply("attn_qkv", x)       # back to outer
    assert order == ["inner_qkv", "outer_out", "outer_qkv"]


def test_the_model_applies_the_slots_once_per_layer_and_unit():
    """The three call sites in ``models.transformer``: ``attn_qkv`` and
    ``attn_out`` once an attention layer, the residual once a unit of the
    block pattern (recurrentgemma's unit is three layers); with no context
    the forward is unchanged bit for bit."""
    cfg = registry.reduced(registry.get_model_config("recurrentgemma-9b"))
    model = t_model.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 8),
                           generator=torch.Generator().manual_seed(0))
    plain = t_model.forward(model, {"tokens": tokens}, mode="train")[0]
    seen = {"attn_qkv": 0, "attn_out": 0, "residual": 0}

    def counter(tag):
        def fn(x):
            seen[tag] += 1
            return x
        return fn

    with dist_ctx.residual_constraint(counter("residual"),
                                      attn_qkv=counter("attn_qkv"),
                                      attn_out=counter("attn_out")):
        got = t_model.forward(model, {"tokens": tokens}, mode="train")[0]
    assert torch.equal(got, plain)
    attn = sum(k in ("attn", "sliding", "attn_local", "moe")
               for k in cfg.blocks())
    assert seen["attn_qkv"] == seen["attn_out"] == attn > 0
    from repro_torch.models import transformer as tf
    units = sum(reps for _, reps in tf.segments(cfg))
    assert seen["residual"] == units < len(cfg.blocks())


# ---------------------------------------------------------------------------
# collectives over spawned gloo worlds
# ---------------------------------------------------------------------------

def _ring_w(n):
    from repro.core import topology as jax_topo

    return np.asarray(jax_topo.mixing_matrix("ring", n), np.float32)


@pytest.fixture(scope="module")
def collective_results(tmp_path_factory):
    """One world of 4 ranks running every case (``_torch_mesh_worker.
    collective_cases``); the inputs made here from a seed."""
    rng = np.random.default_rng(7)
    data = {}
    for n in (4, 8):
        w = rng.random((n, n)).astype(np.float32)
        data[f"w{n}"] = (w / w.sum(1, keepdims=True)).astype(np.float32)
        data[f"ring{n}"] = _ring_w(n)
        data[f"a{n}"] = rng.standard_normal((n, 3, 5)).astype(np.float32)
        data[f"b{n}"] = rng.standard_normal((n, 7)).astype(np.float32)
        for k, d in (("x", 11), ("y", 3)):
            for p in ("d", "t", "c"):
                data[f"{p}{k}{n}"] = rng.standard_normal(
                    (n, d)).astype(np.float32)
    d = tmp_path_factory.mktemp("collectives")
    path = str(d / "inputs.npz")
    np.savez(path, **data)
    ranks = dist_launch.run_world(4, worker.collective_cases, path,
                                  backend="gloo", store_dir=str(d))
    cases = {}
    for recs in ranks:
        for rec in recs:
            if rec["kind"] == "meshes":
                cases.setdefault("meshes", []).append(rec)
                continue
            key = (rec["size"], rec["n"], rec["gd"], rec["kind"])
            cases.setdefault(key, []).append(rec)
    return data, cases


def test_the_meshes_of_a_world(collective_results):
    """``launch.mesh.local_mesh`` is (clients = world, 1, 1) and
    ``fake_mesh(2, 2, 1)`` a (2, 2, 1) mesh over the same ranks; rank r of
    the clients axis holds clients [2r, 2r + 2) of 8."""
    recs = sorted(collective_results[1]["meshes"], key=lambda r: r["rank"])
    assert [r["rank"] for r in recs] == [0, 1, 2, 3]
    for r in recs:
        assert r["local"] == (("clients", "fsdp", "model"), (4, 1, 1))
        assert r["fake"] == (("clients", "fsdp", "model"), (2, 2, 1),
                             r["rank"] // 2)
        assert r["axis"] == (r["rank"], 4, 2 * r["rank"], 2 * r["rank"] + 2)
        # a DTensor's leading dims pinned to (fsdp, model), values kept
        assert r["placements"] == [("replicate",), ("shard", 0),
                                   ("shard", 1)]
        assert r["values_kept"]


def _reference(data, n, gd, kind):
    jgd = None if gd == "float32" else jnp.bfloat16
    tree = {"a": jnp.asarray(data[f"a{n}"]), "b": [jnp.asarray(data[f"b{n}"])]}
    if kind == "dense":
        out = jax_mixing.mix_dense(tree, data[f"w{n}"], gossip_dtype=jgd)
    elif kind == "ring":
        ring = data[f"ring{n}"]
        out = jax_mixing.mix_ring(tree, float(ring[0, 0]), float(ring[0, 1]),
                                  gossip_dtype=jgd)
    else:
        w = jnp.asarray(data[f"w{n}"])
        out = []
        for v, corr in (("x", 2.5), ("y", -0.5)):
            out += list(jax_kref.fused_gossip_ref(
                w, *(jnp.asarray(data[f"{p}{v}{n}"]) for p in "dtc"),
                0.7, corr, gossip_dtype=jgd))
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(out)]


def _wire_bytes(gd):
    return 2 if gd == "bfloat16" else 4


@pytest.mark.parametrize("kind", ["dense", "ring", "packed"])
@pytest.mark.parametrize("gd", worker.GOSSIP_DTYPES)
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("size", [1, 2, 4])
def test_collectives_match_the_reference_mixing(collective_results, size, n,
                                                gd, kind):
    data, cases = collective_results
    recs = sorted(cases[(size, n, gd, kind)], key=lambda r: r["rank"])
    assert len(recs) == size
    want = _reference(data, n, gd, kind)
    for j, w in enumerate(want):
        got = np.concatenate([r["leaves"][j].float().numpy() for r in recs])
        err = np.abs(got - w).max()
        assert err <= TOL_MIX * (1 + np.abs(w).max()), (j, err)
    # the counted collectives and bytes of each rank: the formula
    nl = n // size
    s = _wire_bytes(gd)
    leaf_numel = [15, 7]           # a (3, 5) and b (7,) a client
    for r in recs:
        counts = {k: v for k, v in r["counts"].items() if k != "other"}
        other = r["counts"].get("other", {})
        assert counts == {"staged_bytes": 0}, counts
        if size == 1:
            assert other == {}
            continue
        if kind == "dense":
            want_c = {"all_gather": (2, (size - 1) * nl * sum(leaf_numel)
                                     * s)}
        elif kind == "ring":
            want_c = {"exchange": (2, 2 * sum(leaf_numel) * s)}
        else:
            want_c = {"all_gather": (2, (size - 1) * nl * 2 * (11 + 3) * s)}
        assert {k: (v["calls"], v["bytes"]) for k, v in other.items()} == \
            want_c


def test_clients_axis_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="divide"):
        collectives.ClientsAxis(n=5, rank=0, size=2)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_mesh_configs_match_the_reference(arch, multi_pod):
    from repro.launch import mesh as jax_mesh
    from repro_torch.launch import mesh as mesh_lib

    got = mesh_lib.decentralized_mesh_config(arch, multi_pod=multi_pod)
    want = jax_mesh.decentralized_mesh_config(arch, multi_pod=multi_pod)
    # every field of the reference's MeshConfig, attn_heads_sharding
    # with sequence parallelism (ROADMAP A4) and remat on by default, as
    # the reference's (models.transformer.UnitRemat)
    assert set(dataclasses.asdict(want)) == set(dataclasses.asdict(got))
    assert want.remat and got.remat
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.devices_needed == want.devices_needed
    dec = mesh_lib.make_decentralized_mesh(got)
    assert dec.shape == {"clients": got.num_clients, "fsdp": got.fsdp,
                         "model": got.model}
    prod = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    assert prod.size == got.devices_needed
    assert prod.axis_names == (("pod", "data", "model") if multi_pod
                               else ("data", "model"))


def test_run_world_forks_ranks_from_the_fork_server(tmp_path):
    """``run_world`` forks its ranks from the fork server, which imported
    the port's training modules before any rank ran; ``stop_forkserver``
    stops it, and the next world starts it again."""
    from multiprocessing import forkserver

    want = [(0, 2, 3.0, True), (1, 2, 3.0, True)]
    for _ in range(2):
        ranks = dist_launch.run_world(2, worker.world_info,
                                      store_dir=str(tmp_path))
        assert [(r["rank"], r["world"], r["sum"], r["preloaded"])
                for r in ranks] == want
        assert forkserver._forkserver._forkserver_pid is not None
        dist_launch.stop_forkserver()
        assert forkserver._forkserver._forkserver_pid is None


def test_backend_refusals():
    with pytest.raises(ValueError, match="gloo"):
        dist_launch.check_backend("nccl", "cpu", 1)
    with pytest.raises(ValueError, match="gloo"):
        # two ranks on fewer cards: NCCL refuses them, gloo carries them
        dist_launch.check_backend("nccl", "cuda",
                                  torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="unknown backend"):
        dist_launch.check_backend("mpi", "cpu", 1)
    dist_launch.check_backend("gloo", "cpu", 4)


# ---------------------------------------------------------------------------
# the smoke run
# ---------------------------------------------------------------------------

def test_smoke_runs_the_train_legs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.smoke", "--archs",
         "qwen2-0.5b", "granite-moe-1b-a400m"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    for arch in ("qwen2-0.5b", "granite-moe-1b-a400m"):
        assert f"[smoke] {arch}: train round ran" in out.stdout
        assert f"[smoke] {arch}: packed-gossip train round ran" in out.stdout
    # the reference's train legs at (clients 2, fsdp 2, model 2): every
    # arch runs all three, the MoE arch with its experts split over model
    where = "ran on (clients 2, fsdp 2, model 2)"
    for arch in ("qwen2-0.5b", "granite-moe-1b-a400m"):
        for what in ("train round", "packed-gossip train round",
                     "sparse-gossip train round"):
            assert f"[smoke] {arch}: {what} {where}" in out.stdout
    assert " wait" not in out.stdout
