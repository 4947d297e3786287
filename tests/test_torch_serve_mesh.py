"""The port's serving mesh (``launch.steps.build_prefill_step`` /
``build_decode_step`` on a ``launch.mesh.ServeMesh``, tensor parallelism
from ``dist.tensor_parallel``, ``launch.serve.generate_on_mesh``,
``serve_production``) against ``repro``.

* One spawned gloo world of 4 ranks runs every case
  (``_torch_serve_mesh_worker.serve_cases``) on sub-meshes ``(1, 2)``,
  ``(2, 1)``, ``(2, 2)`` and ``(1, 1)``: the reduced qwen2-0.5b,
  granite-moe-1b-a400m, musicgen-medium (codebooks), internvl2-76b
  (prefix), mamba2-1.3b (``ssm`` blocks split by heads) and
  recurrentgemma-9b (``rglru`` blocks split by LRU channels, one KV head
  that both model ranks hold) in f32 — the prefill's last logits and its
  caches (gathered over heads, channels and rows by ``tp.gather_caches``)
  against ``repro.models.forward(mode="prefill", last_only=True,
  caches=...)`` (what the reference's ``build_prefill_step`` runs,
  ``repro/launch/steps.py:272-278``), then four teacher-forced decode
  steps against ``repro.models.decode_step`` from the reference's caches
  grown as the port grows them; the reduced qwen2-0.5b with an odd
  vocabulary (511) on ``(1, 2)`` and ``(2, 2)`` against the reference at
  that vocabulary; a world of one rank bit for bit the port's single
  process (prefill, ``grow_caches``, decode steps); the counted
  collectives and bytes against the formula.
* The prefill splits the residual's sequence over ``model`` (sequence
  parallelism, ``tp.SeqSplit``): each model rank's residual between the
  blocks holds its ⌈S/M⌉ positions (the last piece shorter, or empty),
  a decode step's the whole one; prompts of 31 tokens (qwen2-0.5b,
  mamba2-1.3b, recurrentgemma-9b) and of 1 token (qwen2-0.5b) on
  ``(1, 2)`` against the reference; every arch also prefills on ``(1,
  2)`` with the residual whole (``seq_parallel=False``), its collectives
  held to the whole-residual formula beside the split one's.
* ``shard_params`` then ``gather_params`` bit for bit, ``init_shard``
  the same pieces; ``plan(cfg, 2)`` of every arch; the refusals of what
  does not split, by name.
* ``_cache_shardings``, ``_maybe`` and the arguments' bytes of
  ``serve_production`` against the reference's specs on the production
  meshes, in a subprocess with 512 fake XLA devices (as
  ``repro/launch/smoke.py:1-4`` sets them); ``long_context_variant``.
* ``launch.serve --mesh 1x2`` under torchrun, and the smoke's serving leg
  (on the world of 4).

Tolerance: f32 compute, max |Δ| ≤ 1e-4·(1 + max|reference|) — the same
math, the row-parallel partial products summed over ranks in f32.
"""
import _torch_threads  # noqa: F401
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.launch import steps as jax_steps
from repro.models import model as jax_model
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import tree as tree_lib
from repro_torch.dist import collectives
from repro_torch.dist import launch as dist_launch
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist import context as dist_ctx
from repro_torch.kernels import flash_attention
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ssd_scan
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import steps
from repro_torch.models import interop
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_tf

import _torch_serve_mesh_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
B, P, T = 2, 32, 4
SCAN_ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
TP_ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m", "musicgen-medium",
            "internvl2-76b") + SCAN_ARCHS
TP_MESHES = ((1, 2), (2, 1), (2, 2))
ODD_VOCAB = 511
# the smoke's serving leg, on the same world at (2, 2)
SMOKE_ARCHS = ("qwen2-0.5b", "mamba2-1.3b", "recurrentgemma-9b")
# prompts that two model ranks do not split evenly, or that leave one of
# them no position, on (1, 2): (arch, prompt length)
UNEVEN = (("qwen2-0.5b", 31), ("mamba2-1.3b", 31),
          ("recurrentgemma-9b", 31), ("qwen2-0.5b", 1))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * (1 + np.abs(want).max()), err
    return err


# ---------------------------------------------------------------------------
# the reference's prefill and decode steps
# ---------------------------------------------------------------------------

def _grow_reference(caches, grown):
    """The reference's prefill caches padded with zero slots to the
    lengths of ``grown`` (its ``init_cache`` at P + T), as the port's
    ``grow_caches`` grows them."""
    def pad(c, g):
        if c.shape == g.shape:
            return c
        widths = [(0, gs - cs) for cs, gs in zip(c.shape, g.shape)]
        return jnp.pad(c, widths)

    return jax.tree.map(pad, caches, grown)


def _uneven_name(arch, p):
    return f"{arch}@{p}"


@functools.lru_cache(maxsize=None)
def _reference(arch, vocab=None, p=P):
    """(case, reference): the reduced ``arch``'s reference params, prompts
    of ``p`` tokens and forced tokens, with the reference's f32 prefill
    (last logits and caches) and the logits of T teacher-forced decode
    steps.  ``vocab``: the config's vocabulary replaced by that many
    tokens.  A case at ``P`` runs on every mesh of TP_MESHES, and on
    ``(1, 2)`` with the residual whole too; another prompt length or
    vocabulary on fewer meshes."""
    cfg_j = jax_registry.reduced(jax_registry.get_model_config(arch))
    cfg_t = registry.reduced(registry.get_model_config(arch))
    if vocab is not None:
        cfg_j = dataclasses.replace(cfg_j, vocab_size=vocab)
        cfg_t = dataclasses.replace(cfg_t, vocab_size=vocab,
                                    name=f"{cfg_t.name}-vocab-{vocab}")
    params = jax_model.init_params(cfg_j, jax.random.PRNGKey(3))
    rng = np.random.default_rng(5)
    cb = (cfg_j.num_codebooks,) if cfg_j.num_codebooks else ()
    prompt = rng.integers(0, cfg_j.vocab_size, (B, p, *cb)).astype(np.int32)
    forced = rng.integers(0, cfg_j.vocab_size, (B, T, *cb)).astype(np.int32)
    batch = {"tokens": jnp.asarray(prompt)}
    prefix = None
    if cfg_j.num_prefix_tokens:
        prefix = rng.standard_normal(
            (B, cfg_j.num_prefix_tokens, cfg_j.d_model)).astype(np.float32)
        batch["prefix"] = jnp.asarray(prefix)
    caches = jax_model.init_cache(cfg_j, B, p, jnp.float32)
    prefill = jax.jit(lambda p, b, c: jax_model.forward(
        p, b, cfg_j, mode="prefill", compute_dtype=jnp.float32, caches=c,
        last_only=True)[:2])
    decode = jax.jit(lambda p, c, t, pos: jax_model.decode_step(
        p, c, t, pos, cfg_j, compute_dtype=jnp.float32))
    logits, caches = prefill(params, batch, caches)
    prefill_caches = jax.tree.map(np.asarray, caches)
    caches = _grow_reference(caches, jax_model.init_cache(
        cfg_j, B, p + T, jnp.float32))
    outs = [np.asarray(logits)]
    for i in range(T):
        logits, caches = decode(params, caches,
                                jnp.asarray(forced[:, i:i + 1]),
                                jnp.int32(p + i))
        outs.append(np.asarray(logits))
    name = ("odd_vocab" if vocab is not None
            else arch if p == P else _uneven_name(arch, p))
    case = {"name": name, "cfg": cfg_t,
            "params": jax.tree.map(np.asarray, params), "dtype": torch.float32,
            "prompt": torch.from_numpy(prompt).long(),
            "forced": torch.from_numpy(forced).long(),
            "prefix": None if prefix is None else torch.from_numpy(prefix),
            "gen_tokens": T,
            "meshes": (((1, 2), (2, 2)) if vocab is not None
                       else TP_MESHES if p == P else ((1, 2),)),
            "whole_meshes": ((1, 2),) if name == arch else ()}
    ref = {"logits": np.concatenate(outs, axis=1),
           "caches": interop.caches_from_reference(prefill_caches, cfg_t,
                                                   device="cpu")}
    return case, ref


def _world_of_one_case():
    """bf16 serving (the default) on a mesh of one rank, held bit for bit
    to the single-process path (:func:`_single_process`)."""
    cfg = registry.reduced(registry.get_model_config("qwen2-0.5b"))
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g)
    forced = torch.randint(0, cfg.vocab_size, (B, T), generator=g)
    return {"name": "world_of_1", "cfg": cfg, "params": None, "seed": 4,
            "dtype": torch.bfloat16, "prompt": prompt, "forced": forced,
            "gen_tokens": T, "meshes": ((1, 1),)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one spawned world of 4; results by (case, mesh)."""
    refs = {arch: _reference(arch) for arch in TP_ARCHS}
    refs["odd_vocab"] = _reference("qwen2-0.5b", ODD_VOCAB)
    for arch, p in UNEVEN:
        refs[_uneven_name(arch, p)] = _reference(arch, p=p)
    one_case = _world_of_one_case()
    cases = [c for c, _ in refs.values()] + [one_case]
    d = tmp_path_factory.mktemp("serve_mesh")
    path = str(d / "cases.pt")
    torch.save(cases, path)
    ranks = dist_launch.run_world(4, worker.serve_cases, path, SMOKE_ARCHS,
                                  backend="gloo", store_dir=str(d))
    by = {}
    for recs in ranks:
        for r in recs:
            key = (r["case"], r["mesh"])
            if r.get("layout") == "whole":
                key += ("whole",)
            by.setdefault(key, []).append(r)
    return {"refs": refs, "cases": {c["name"]: c for c in cases},
            "one": _single_process(one_case), "by": by}


def _gathered(recs, cfg):
    """The mesh's logits (B, T + 1, …) and prefill caches (per layer, all
    rows, heads and channels) from each rank's: every model rank's logits
    equal, rows concatenated in batch-rank order, each batch shard's caches
    joined over its model ranks (``tp.gather_caches``)."""
    by_b = {}
    for r in recs:
        by_b.setdefault(r["batch_rank"], []).append(r)
    logits, caches = [], None
    for b in sorted(by_b):
        group = sorted(by_b[b], key=lambda r: r["model_rank"])
        for r in group[1:]:
            assert torch.equal(r["logits"], group[0]["logits"])
        logits.append(group[0]["logits"])
        layers = tp.gather_caches([r["caches"] for r in group], cfg)
        if b == 0:
            caches = layers
        elif recs[0]["rows"] != (0, B):      # rows split, not replicated
            caches = [{k: torch.cat([c[k], l[k]]) for k in c}
                      for c, l in zip(caches, layers)]
    if recs[0]["rows"] == (0, B):
        logits = logits[:1]
    return torch.cat(logits), caches


@pytest.mark.parametrize("mesh", TP_MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_prefill_and_decode_match_the_reference(world, arch, mesh):
    recs = world["by"][(arch, mesh)]
    assert len(recs) == mesh[0] * mesh[1]
    assert all(r["same_tokens"] for r in recs)
    ref = world["refs"][arch][1]
    logits, caches = _gathered(recs, world["cases"][arch]["cfg"])
    _close(logits[:, :1], ref["logits"][:, :1])        # the prefill
    _close(logits[:, 1:], ref["logits"][:, 1:])        # four decode steps
    assert len(caches) == len(ref["caches"])
    for got, want in zip(caches, ref["caches"]):
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k])


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_scan_blocks_serve_on_the_data_axis(world, arch):
    recs = world["by"][(arch, (2, 1))]
    assert [r["rows"] for r in sorted(recs, key=lambda r: r["rank"])] == [
        (0, 1), (1, 2)]
    ref = world["refs"][arch][1]
    logits, caches = _gathered(recs, world["cases"][arch]["cfg"])
    _close(logits, ref["logits"])
    for got, want in zip(caches, ref["caches"]):
        for k in got:
            _close(got[k], want[k])
    # the data axis alone makes no collective but the tokens' check
    for r in recs:
        assert set(r["collectives"]) - {"check"} == {"staged_bytes"}


def _refused(arch, m, **changes):
    cfg = registry.reduced(registry.get_model_config(arch))
    return dataclasses.replace(cfg, **changes), m


# what the model axis does not split, each refused by the field's name:
# the reduced mamba2-1.3b's 16 SSM heads over 3 ranks, an LRU width of 250
# over 4, 3 KV heads over 2 (neither divides the other), 4 query heads
# over 3
REFUSALS = {
    "ssm_heads": (_refused("mamba2-1.3b", 3), "the SSM heads"),
    "lru_width": (_refused("recurrentgemma-9b", 4, rglru=dataclasses.replace(
        registry.reduced(registry.get_model_config(
            "recurrentgemma-9b")).rglru, lru_width=250)), "lru_width"),
    "kv_heads": (_refused("qwen2-0.5b", 2, num_heads=6, num_kv_heads=3,
                          head_dim=64), "num_kv_heads"),
    "query_heads": (_refused("recurrentgemma-9b", 3), "num_heads"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_what_does_not_split_is_refused_by_name(case):
    (cfg, m), field = REFUSALS[case]
    with pytest.raises(ValueError, match=f"{field} = "):
        tp.plan(cfg, m)
    fake = mesh_lib.ServeMesh(
        ("data", "model"), (1, m),
        batch_axis=collectives.MeshAxis(rank=0, size=1),
        model_axis=collectives.MeshAxis(rank=0, size=m))
    with pytest.raises(ValueError, match=f"{field} = "):
        steps.build_prefill_step(
            cfg, InputShape("s", 8, 2, "prefill"), fake)
    tp.plan(cfg, 1)                      # the data axis alone is fine


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_every_arch_plans_over_two_model_ranks(arch):
    """``plan(cfg, 2)`` of the full config on the meta device: each rank's
    shard skeleton has the shapes of the plan's pieces, and the pieces
    cover every parameter (the shard configs make the same model)."""
    cfg = registry.get_model_config(arch)
    the_plan = tp.plan(cfg, 2)
    full = dict(t_model.skeleton(cfg).named_parameters())
    assert set(the_plan) == set(full)
    for r in range(2):
        got = {n: tuple(p.shape) for n, p in
               tp.shard_skeleton(cfg, 2, r).named_parameters()}
        want = {n: tuple(p.shape if s is None else s.take(p, r).shape)
                for n, p in full.items() for s in [the_plan[n]]}
        assert got == want


def _single_process(case):
    cfg = case["cfg"]
    model = t_model.init_params(cfg, seed=case["seed"], device="cpu",
                                dtype=case["dtype"])
    caches = t_model.init_cache(cfg, B, P, dtype=case["dtype"], device="cpu")
    with torch.no_grad():
        logits, caches, _ = t_model.forward(
            model, {"tokens": case["prompt"]}, mode="prefill",
            compute_dtype=case["dtype"], caches=caches, last_only=True)
        prefill = caches
        caches = t_model.grow_caches(cfg, caches, P + T)
        outs = [logits]
        for i in range(T):
            logits, caches = t_model.decode_step(
                model, caches, case["forced"][:, i:i + 1],
                torch.full((B,), P + i), compute_dtype=case["dtype"])
            outs.append(logits)
    return torch.cat(outs, dim=1), prefill


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_an_odd_vocabulary_splits_unevenly(world, mesh):
    assert tp.pieces(ODD_VOCAB, 2, "v") == (256, 255)
    recs = world["by"][("odd_vocab", mesh)]
    ref = world["refs"]["odd_vocab"][1]
    logits, caches = _gathered(recs, world["cases"]["odd_vocab"]["cfg"])
    assert logits.shape[-1] == ODD_VOCAB
    _close(logits[:, :1], ref["logits"][:, :1])        # the prefill
    _close(logits[:, 1:], ref["logits"][:, 1:])        # four decode steps
    assert len(caches) == len(ref["caches"])
    for got, want in zip(caches, ref["caches"]):
        for k in got:
            _close(got[k], want[k])
    # the logits' all-gather moves the padded pieces (256 wide)
    for r in recs:
        gather = r["collectives"]["prefill"]["all_gather"]
        assert gather == {**gather, "calls": 1,
                          "bytes": (mesh[1] - 1) * (B // mesh[0]) * 256 * 4}


def test_a_world_of_one_is_the_single_process_path(world):
    logits, prefill = world["one"]
    r, = world["by"][("world_of_1", (1, 1))]
    assert torch.equal(r["logits"], logits)
    assert torch.equal(r["tokens"], world["cases"]["world_of_1"]["forced"])
    for got, want in zip(r["caches"], prefill):
        for k in got:
            assert torch.equal(got[k], want[k])
    assert set(r["collectives"]) == {"staged_bytes"}


def _formula(cfg, nb, s, t, m, elt, *, layout="seq", model_rank=0):
    """The collectives of one rank (``model_rank`` of m) at m model ranks.

    A prefill on the split sequence (``layout="seq"``) of S' = S + the
    prefix positions, pieces of k = ⌈S'/m⌉ (padded to k on the wire):
    reduce-scatters in the compute dtype, each receiving (m − 1)·nb·k·d —
    one a layer after its mixer (out-projection) and one after its MLP,
    none after an ``ssm`` layer's missing MLP, and the embedding rows'
    (C codebooks' rows side by side: (m − 1)·nb·k·C·d); an all-gather of
    the pieces where the residual enters a column-parallel piece, one a
    reduce-scatter after a layer (each mixer's and MLP's input, the MoE's
    once); one broadcast of the last position's hidden row (nb·d,
    received by every rank but the one whose piece holds it).  With the
    residual whole (``layout="whole"``): 2L + 1 f32 all-reduces — after
    each layer's
    mixer and MLP, of nb·S'·d, or for an ``ssm`` layer after its
    out-projection and of its gated norm's sums of squares, nb·S'·d and
    nb·S'; and the embedding rows', of nb·S'·C·d.  Either way an ``ssm``
    layer's gated norm all-reduces its f32 sums of squares (nb·S'), and
    the compute dtype's all-gathers of the last logits' padded pieces
    ((m − 1)·nb·C·⌈V/m⌉) and of each ``rglru`` layer's gate input
    ((m − 1)·nb·S'·W/m).  A decode step is the whole layout's at S = 1.
    The check phase all-gathers the fed tokens (int64)."""
    if m == 1:
        return {}
    c = cfg.num_codebooks or 1
    kinds, d = cfg.blocks(), cfg.d_model
    n_ssm, n_lru = kinds.count("ssm"), kinds.count("rglru")
    w = cfg.rglru.lru_width or d
    vmax = max(tp.pieces(cfg.vocab_size, m, "v"))

    def whole(total):
        rows = nb * total
        return {"all_reduce": {"calls": 2 * len(kinds) + 1,
                               "bytes": ((2 * len(kinds) - n_ssm) * rows * d
                                         + n_ssm * rows
                                         + rows * c * d) * 4},
                "all_gather": {"calls": 1 + n_lru,
                               "bytes": (m - 1) * (nb * c * vmax + n_lru
                                                   * rows * (w // m)) * elt}}

    def split(total):
        k = -(-total // m)
        widths = collectives.fsdp_widths(total, m)
        last = max(r for r, width in enumerate(widths) if width)
        piece = (m - 1) * nb * k * d * elt
        n = 2 * len(kinds) - n_ssm
        out = {"seq_scatter": {"calls": n + 1,
                               "bytes": n * piece + c * piece},
               "seq_gather": {"calls": n, "bytes": n * piece},
               "broadcast": {"calls": 1, "bytes": 0 if model_rank == last
                             else nb * d * elt},
               "all_gather": whole(total)["all_gather"]}
        if n_ssm:
            out["all_reduce"] = {"calls": n_ssm,
                                 "bytes": n_ssm * nb * total * 4}
        return out

    total = s + cfg.num_prefix_tokens
    pre = split(total) if layout == "seq" else whole(total)
    dec = {k: {f: v * t for f, v in x.items()} for k, x in whole(1).items()}
    return {"prefill": pre, "decode": dec,
            "check": {"all_gather": {"calls": 1,
                                     "bytes": (m - 1) * nb * t * c * 8}}}


def _counts(rec):
    return {ph: {k: {f: v[f] for f in ("calls", "bytes")}
                 for k, v in kinds.items()}
            for ph, kinds in rec["collectives"].items()
            if ph != "staged_bytes"}


@pytest.mark.parametrize("mesh", TP_MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_the_counted_collectives_match_the_formula(world, arch, mesh):
    """Each layout's counts against its formula: the split sequence's on
    every mesh, and on ``(1, 2)`` the whole residual's beside it."""
    cfg = world["cases"][arch]["cfg"]
    layouts = ("seq", "whole") if mesh == (1, 2) else ("seq",)
    for layout in layouts:
        key = (arch, mesh) + (("whole",) if layout == "whole" else ())
        for r in world["by"][key]:
            want = _formula(cfg, B // mesh[0], P, T, mesh[1], 4,
                            layout=layout, model_rank=r["model_rank"])
            assert _counts(r) == want, layout
            assert r["collectives"]["staged_bytes"] == 0     # CPU tensors


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_the_whole_residual_prefill_matches_the_split_one(world, arch):
    """On ``(1, 2)`` the prefill with the residual whole gives the split
    one's logits and caches (within TOL of each other: the partials are
    summed in f32 by another collective), and its ranks' decode steps the
    same logits."""
    cfg = world["cases"][arch]["cfg"]
    split = _gathered(world["by"][(arch, (1, 2))], cfg)
    whole = _gathered(world["by"][(arch, (1, 2), "whole")], cfg)
    _close(whole[0], split[0])
    for got, want in zip(whole[1], split[1]):
        for k in got:
            _close(got[k], want[k])


def _residual_ok(rec, cfg, p, layout):
    """Every block's residual in and out of the rank's prefill: its piece
    of the split sequence, or the whole; a decode step's: one position."""
    total = p + cfg.num_prefix_tokens
    want = (collectives.fsdp_widths(total, rec["mesh"][1])[rec["model_rank"]]
            if layout == "seq" else total)
    lengths = rec["residual"]
    n = len(cfg.blocks())
    return (lengths["prefill"] == [(want, want)] * n
            and lengths["decode"] == [(1, 1)] * (n * T))


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_a_ranks_residual_between_blocks_is_its_piece(world, arch):
    """On ``(1, 2)`` and ``(2, 2)`` each model rank's residual between the
    blocks of a prefill holds ⌈S'/M⌉ positions (S' with the prefix), the
    whole S' with the residual whole; a decode step's one position on
    every rank."""
    cfg = world["cases"][arch]["cfg"]
    for mesh in ((1, 2), (2, 2)):
        for r in world["by"][(arch, mesh)]:
            assert _residual_ok(r, cfg, P, "seq"), r["residual"]
    for r in world["by"][(arch, (1, 2), "whole")]:
        assert _residual_ok(r, cfg, P, "whole"), r["residual"]


@pytest.mark.parametrize("arch,p", UNEVEN,
                         ids=[f"{a}-{p}" for a, p in UNEVEN])
def test_a_prompt_that_the_model_axis_does_not_divide(world, arch, p):
    """A prompt of 31 tokens (rank 0 holds 16 positions, rank 1 15) and
    one of 1 token (rank 0 holds it, rank 1 none) on ``(1, 2)``: the
    prefill's last logits and caches and four decode steps against the
    reference, each rank's residual its piece, and the collectives
    against the formula."""
    name = _uneven_name(arch, p)
    recs = world["by"][(name, (1, 2))]
    assert len(recs) == 2 and all(r["same_tokens"] for r in recs)
    cfg = world["cases"][name]["cfg"]
    ref = world["refs"][name][1]
    logits, caches = _gathered(recs, cfg)
    _close(logits[:, :1], ref["logits"][:, :1])        # the prefill
    _close(logits[:, 1:], ref["logits"][:, 1:])        # four decode steps
    for got, want in zip(caches, ref["caches"]):
        for k in got:
            _close(got[k], want[k])
    for r in recs:
        assert _residual_ok(r, cfg, p, "seq"), r["residual"]
        assert _counts(r) == _formula(cfg, B, p, T, 2, 4,
                                      model_rank=r["model_rank"])


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_shard_then_gather_is_bit_for_bit(arch, m):
    cfg = registry.reduced(registry.get_model_config(arch))
    full = t_model.param_dict(t_model.init_params(cfg, seed=1, device="cpu"))
    the_plan = tp.plan(cfg, m)
    shards = [tp.shard_params(full, the_plan, r) for r in range(m)]
    back = tp.gather_params(shards, the_plan)
    assert set(back) == set(full)
    for name in full:
        assert torch.equal(back[name], full[name]), name
    for r, shard in enumerate(shards):
        # each shard is a model of the rank's shard config
        skel = tp.shard_skeleton(cfg, m, r)
        shapes = {n: tuple(p.shape) for n, p in skel.named_parameters()}
        assert shapes == {n: tuple(t.shape) for n, t in shard.items()}
        # drawn piece by piece, the same shard
        drawn = tp.init_shard(cfg, m, r, seed=1, device="cpu")
        assert all(torch.equal(drawn[n], shard[n]) for n in full)
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if h:
        # GQA stays grouped: rank r's query heads are those of its KV
        # heads, each KV head whole on every rank that holds it
        at = next(n[:-2] for n in full if n.endswith(".attn.wq"))
        wq, wk = full[at + "wq"], full[at + "wk"]
        for r, shard in enumerate(shards):
            lo = r * h // m
            assert torch.equal(shard[at + "wq"], wq[:, lo:lo + h // m])
            g = lo * kv // h                 # the KV head of query head lo
            assert torch.equal(shard[at + "wk"],
                               wk[:, g:g + max(kv // m, 1)])
    if "ssm" in cfg.blocks():
        # B and C whole on every rank; each rank its heads of x, z and dt
        s = cfg.ssm
        d_in, n = s.heads(cfg.d_model) * s.d_head, s.d_state
        w = full["layers.0.ssm.in_proj"]
        for r, shard in enumerate(shards):
            c, hr = d_in // m, s.heads(cfg.d_model) // m
            got = shard["layers.0.ssm.in_proj"]
            assert torch.equal(got[:, :c], w[:, r * c:(r + 1) * c])
            assert torch.equal(got[:, 2 * c:2 * c + 2 * n],
                               w[:, 2 * d_in:2 * d_in + 2 * n])
            assert torch.equal(got[:, 2 * c + 2 * n:],
                               w[:, 2 * d_in + 2 * n + r * hr:
                                 2 * d_in + 2 * n + (r + 1) * hr])


def test_qwen2_at_two_model_ranks_runs_b5_on_tensor_cores():
    """qwen2-0.5b's shard at M = 2 is (4, 4096, 7, 1, 64) for B5: 7 query
    heads over 1 KV head, bf16, whose rows the tensor-core route takes."""
    cfg = tp.shard_config(registry.get_model_config("qwen2-0.5b"), 2, 0)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size) == (7, 1, 64, 2432, 75968)
    q = torch.empty((4, 4096, 7, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 4096, 1, 64), dtype=torch.bfloat16, device="meta")
    assert flash_attention.route(torch.bfloat16, 64,
                                 (q.stride(), k.stride(), k.stride()),
                                 True) == "tensor_core"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_scan_archs_at_two_model_ranks_take_the_tensor_core_routes(
        monkeypatch, dtype):
    """The full-width scan archs' rank-0 blocks at M = 2 on the meta
    device, the kernels' entry points spied on: mamba2-1.3b's ``ssm``
    block hands B7 (B, S, 32, 64, 128) with strides its tensor-core route
    takes (B and C, in f32 compute, are views of the conv output);
    recurrentgemma-9b's ``rglru`` block hands B8 (B, S, 2048), its
    ``attn_local`` block B5 8 query heads over 1 KV head of 256."""
    seen = {}

    def spy(name, fn):
        def call(*args, **kw):
            seen[name] = args
            return fn(*args, **kw)
        monkeypatch.setattr(t_ops, name, call)

    spy("ssd_scan", lambda xdt, loga, bm, cm, **kw: (
        torch.empty_like(xdt, dtype=torch.float32),
        torch.empty((xdt.shape[0], xdt.shape[2], xdt.shape[3],
                     bm.shape[-1]), device="meta")))
    spy("rglru_scan", lambda a, u, **kw: torch.empty_like(a))
    spy("flash_attention", lambda q, k, v, **kw: torch.empty_like(q))
    b, s = 2, 128
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        cfg = registry.get_model_config(arch)
        rank_cfg = tp.shard_config(cfg, 2, 0)
        x = torch.empty((b, s, cfg.d_model), dtype=dtype, device="meta")
        positions = torch.zeros((b, s), dtype=torch.int32, device="meta")
        gather = {"lru_gate_in": lambda t: torch.cat([t, t], dim=-1)}
        with torch.no_grad(), dist_ctx.residual_constraint(**gather):
            for kind in sorted(set(cfg.blocks())):
                blk = t_tf.Block(kind, rank_cfg, None, device="meta",
                                 dtype=torch.float32)
                t_tf.block_forward(kind, blk, x, rank_cfg, mode="prefill",
                                   positions=positions, compute_dtype=dtype)
    xdt, loga, bm, cm = seen["ssd_scan"]
    assert tuple(xdt.shape) == (b, s, 32, 64) and bm.shape[-1] == 128
    f32 = [t.to(torch.float32) for t in (xdt, bm, cm)]
    assert ssd_scan.route(64, 128, [t.stride() for t in f32],
                          True) == "tensor_core"
    assert tuple(seen["rglru_scan"][0].shape) == (b, s, 2048)
    q, k, v = seen["flash_attention"]
    assert (tuple(q.shape), tuple(k.shape)) == ((b, s, 8, 256),
                                                (b, s, 1, 256))
    assert flash_attention.route(torch.bfloat16, 256, (
        q.stride(), k.stride(), v.stride()), True) == "tensor_core"


def test_the_plan_leaves_the_router_and_norms_whole():
    cfg = registry.reduced(registry.get_model_config("granite-moe-1b-a400m"))
    the_plan = tp.plan(cfg, 2)
    assert the_plan["layers.0.moe.router"] is None
    assert the_plan["layers.0.norm1"] is None
    assert the_plan["final_norm"] is None
    assert the_plan["layers.0.moe.gate"] == tp.Split(2, (32, 32))
    assert the_plan["layers.0.moe.down"] == tp.Split(1, (32, 32))
    assert the_plan["embed"] == tp.Split(0, (256, 256))


def test_batch_rows_split_over_pod_and_data():
    """With a pod axis the rows split over pod × data (reference
    ``_serve_batch_axes``); a batch the axis does not divide is whole on
    every rank (``_maybe``)."""
    mesh = mesh_lib.ServeMesh(
        ("pod", "data", "model"), (2, 2, 2),
        batch_axis=collectives.MeshAxis(rank=3, size=4),
        model_axis=collectives.MeshAxis(rank=1, size=2))
    assert steps._serve_batch_axes(mesh) == (("pod", "data"),)
    assert steps.batch_rows(mesh, 8) == slice(6, 8)
    assert steps.batch_rows(mesh, 1) == slice(0, 1)


def test_grow_caches_then_decode_equals_the_longer_cache():
    """A prefill at the prompt's length, grown, then decoded: the logits
    of decoding from position 0 into the long cache (f32)."""
    cfg = registry.reduced(registry.get_model_config("qwen2-0.5b"))
    model = t_model.init_params(cfg, seed=9, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 12),
                         generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        full, _, _ = t_model.forward(model, {"tokens": toks},
                                     compute_dtype=torch.float32)
        caches = t_model.init_cache(cfg, 1, 8, dtype=torch.float32,
                                    device="cpu")
        _, caches, _ = t_model.forward(
            model, {"tokens": toks[:, :8]}, mode="prefill", caches=caches,
            compute_dtype=torch.float32, last_only=True)
        caches = t_model.grow_caches(cfg, caches, 12)
        assert caches[0]["k"].shape[1] == 12
        for t in range(8, 12):
            logits, caches = t_model.decode_step(
                model, caches, toks[:, t:t + 1], t,
                compute_dtype=torch.float32)
            _close(logits, full[:, t:t + 1], 1e-5)


# ---------------------------------------------------------------------------
# the reference's specs (fake devices in a subprocess)
# ---------------------------------------------------------------------------

SPEC_ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m", "musicgen-medium",
              "internvl2-76b", "mamba2-1.3b", "recurrentgemma-9b")
SPEC_SHAPES = ("prefill_32k", "decode_32k", "long_500k")

_REFERENCE_SPECS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, math, sys
import jax, jax.numpy as jnp
from repro.configs import registry
from repro.configs.shapes import SHAPES
from repro.dist import sharding as sh
from repro.launch import mesh as mesh_lib
from repro.launch import steps
from repro.models import model as model_lib

def spec_dims(s, ndim):
    parts = list(s.spec) + [None] * (ndim - len(s.spec))
    return [None if p is None else ([p] if isinstance(p, str) else list(p))
            for p in parts]

def nbytes(tree, shards):
    return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
               for x, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shards)))

out = {}
params_of = {}
for multi_pod in (False, True):
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    ax = steps._serve_batch_axes(mesh)[0]
    out[f"maybe/{multi_pod}"] = [
        [steps._maybe(a, n, mesh) for n in (1, 2, 16, 32, 128)]
        for a in (ax, "model", "data")]
    for arch in sys.argv[1].split(","):
        for name in sys.argv[2].split(","):
            cfg = registry.get_model_config(arch)
            shape = SHAPES[name]
            if name == "long_500k":
                cfg = steps.long_context_variant(cfg)
            b, s = shape.global_batch, shape.seq_len
            if arch not in params_of:  # the variant's params are the same
                params_of[arch] = steps._bf16_sds(jax.eval_shape(
                    lambda k: model_lib.init_params(cfg, k),
                    jax.random.PRNGKey(0)))
            params = params_of[arch]
            caches = jax.eval_shape(
                lambda: model_lib.init_cache(cfg, b, s, jnp.bfloat16))
            c_shard = steps._cache_shardings(caches, mesh, ax)
            cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
            tl = s if shape.kind == "prefill" else 1
            inputs = {"tokens": jax.ShapeDtypeStruct((b, tl, *cb), jnp.int32)}
            if shape.kind == "prefill" and cfg.num_prefix_tokens:
                inputs["prefix"] = jax.ShapeDtypeStruct(
                    (b, cfg.num_prefix_tokens, cfg.d_model), jnp.float32)
            from jax.sharding import NamedSharding, PartitionSpec as P
            i_shard = {k: NamedSharding(mesh, P(*([steps._maybe(ax, v.shape[0], mesh)]
                       + [None] * (len(v.shape) - 1)))) for k, v in inputs.items()}
            if shape.kind != "prefill":
                inputs["pos"] = jax.ShapeDtypeStruct((), jnp.int32)
                i_shard["pos"] = NamedSharding(mesh, P())
            out[f"{arch}/{name}/{multi_pod}"] = {
                "params_bytes": nbytes(params, sh.serve_params_shardings(params, mesh)),
                "caches_bytes": nbytes(caches, c_shard),
                "inputs_bytes": nbytes(inputs, i_shard),
                "cache_specs": [spec_dims(c, len(x.shape)) for x, c in zip(
                    jax.tree.leaves(caches), jax.tree.leaves(c_shard))]}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SPECS, ",".join(SPEC_ARCHS),
         ",".join(SPEC_SHAPES)], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("JSON", 1)[1])


def _port_dims(placements, names, ndim):
    parts = [None] * ndim
    for name, p in zip(names, placements):
        if p.is_shard():
            parts[p.dim] = (parts[p.dim] or []) + [name]
    return parts


@pytest.mark.parametrize("multi_pod", [False, True])
def test_maybe_matches_the_reference(reference_specs, multi_pod):
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    ax = steps._serve_batch_axes(mesh)[0]
    got = [[steps._maybe(a, n, mesh) for n in (1, 2, 16, 32, 128)]
           for a in (ax, "model", "data")]
    want = [[tuple(v) if isinstance(v, list) else v for v in row]
            for row in reference_specs[f"maybe/{multi_pod}"]]
    assert got == want


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", SPEC_SHAPES)
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_serve_production_counts_the_reference_specs(reference_specs, arch,
                                                     shape, multi_pod):
    want = reference_specs[f"{arch}/{shape}/{multi_pod}"]
    got = serve_lib.serve_production(arch, shape, multi_pod)
    for k in ("params_bytes", "caches_bytes", "inputs_bytes"):
        assert got[k] == want[k], k
    # the caches' placements, leaf for leaf
    cfg = registry.get_model_config(arch)
    if shape == "long_500k":
        cfg = steps.long_context_variant(cfg)
    s = SHAPES[shape]
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    tree = steps.cache_sds(cfg, s.global_batch, s.seq_len)
    shards = steps._cache_shardings(tree, mesh,
                                    steps._serve_batch_axes(mesh)[0])
    leaves = tree_lib.leaves(tree)
    specs = serve_lib._placement_leaves(shards, [])
    assert len(leaves) == len(specs) == len(want["cache_specs"])
    for t, pl, w in zip(leaves, specs, want["cache_specs"]):
        assert _port_dims(pl, mesh.axis_names, t.dim()) == w


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_long_context_variant_matches_the_reference(arch):
    got = steps.long_context_variant(registry.get_model_config(arch))
    want = jax_steps.long_context_variant(jax_registry.get_model_config(arch))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


def test_serve_mesh_cli_under_torchrun():
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "repro_torch.launch.serve", "--mesh",
         "1x2", "--device", "cpu", "--reduced", "--arch", "qwen2-0.5b",
         "--prompt-len", "16", "--tokens", "3", "--batch", "2"],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    text = out.stdout
    assert "on (data 1, model 2) over gloo: prefill 16 tok x 2 seq" in text
    assert "ms/token" in text and "tok/s aggregate" in text
    # the prefill's split sequence: 2L + 1 = 5 reduce-scatters and 2L = 4
    # all-gathers; the whole residual's 2L + 1 = 5 all-reduces a decode
    # step
    assert "seq_scatter 5 calls" in text and "seq_gather 4 calls" in text
    assert "all_reduce 15 calls" in text
    assert "peak memory a rank" in text


def test_serve_production_cli(capsys):
    serve_lib.main(["--shape", "decode_32k", "--arch", "qwen2-0.5b"])
    out = capsys.readouterr().out
    assert "qwen2-0.5b x decode_32k on {'data': 16, 'model': 16}" in out
    assert "arguments only" in out


def test_smoke_runs_the_serving_leg(world):
    """``launch.smoke``'s serving leg on the fixture's world of 4: qwen2,
    mamba2 and recurrentgemma at (data 2, model 2)."""
    recs = world["by"][("smoke", None)]
    assert len(recs) == 4
    for r in recs:
        assert [ok for ok, _ in r["legs"]] == [True] * len(SMOKE_ARCHS)
        assert all("prefill+decode ran on (data 2, model 2)" in line
                   for _, line in r["legs"])
