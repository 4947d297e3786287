"""The scan blocks and a replicated KV head on the serving mesh's model
axis, one process, no world: M shards of one block run in M threads, each
under the ``dist.context`` slots of ``dist.tensor_parallel.slots`` made to
sum and gather across the threads (:class:`ThreadAxis`), so a fault of the
tensor-parallel layout shows here without spawning ranks.

* ``models.ssm.ssm_forward`` (the ``ssm`` mixer: heads split, the gated
  norm's sum of squares across the shards) and ``models.rglru.
  rglru_forward`` (the ``rglru`` mixer: LRU channels split, the gate input
  gathered), their partial outputs summed here as ``mixer_out`` sums them;
  ``transformer.block_forward`` on recurrentgemma-9b's ``attn_local``
  block, whose one KV head each shard holds whole;
* on the reduced mamba2-1.3b and recurrentgemma-9b at M = 2 and 4, in
  prefill from a noisy carried cache and in one decode step, against the
  unsharded port block and against ``repro``'s block on the same numpy
  inputs; the shards' caches joined by ``tp.gather_caches``' splits
  (``cache_plan``), every copy of a replicated range equal.

Tolerance: f32 compute, max |Δ| ≤ 1e-5·(1 + max|reference|), as
``tests/test_torch_models.py`` holds the blocks: the same math, the
partial sums added in f32 in another order.
"""
import _torch_threads  # noqa: F401
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as jax_model
from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro_torch.configs import registry
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import interop
from repro_torch.models import model as t_model
from repro_torch.models import rglru as t_rglru
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf

TOL = 1e-5
B, S = 2, 40        # a ragged SSD chunk of 16; past the window of 32
ARCH = {"ssm": "mamba2-1.3b", "rglru": "recurrentgemma-9b",
        "attn_local": "recurrentgemma-9b"}

_MODELS = {}


def _models(arch):
    """(reference cfg, reference params, port cfg, port param dict)."""
    if arch not in _MODELS:
        jcfg = jax_registry.reduced(jax_registry.get_model_config(arch))
        tcfg = registry.reduced(registry.get_model_config(arch))
        params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        model = interop.params_from_reference(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _MODELS[arch] = (jcfg, params, tcfg, t_model.param_dict(model))
    return _MODELS[arch]


class ThreadAxis:
    """M shards in M threads of this process: a slot's tensor is posted
    by every thread, and each takes the f32 sum of all (rank order) or
    their concatenation along the last dim."""

    def __init__(self, m: int):
        self.m = m
        self.box = [None] * m
        self.barrier = threading.Barrier(m)

    def _exchange(self, r, t):
        self.box[r] = t
        self.barrier.wait()
        out = list(self.box)
        self.barrier.wait()
        return out

    def slots(self, r: int) -> dict:
        def reduce(t):
            parts = self._exchange(r, t.to(torch.float32))
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return total.to(t.dtype)

        def gather(t):
            return torch.cat(self._exchange(r, t), dim=-1)

        return {"attn_proj": reduce, "mixer_out": reduce, "ffn_out": reduce,
                "ssm_norm": reduce, "lru_gate_in": gather}

    def run(self, fn):
        """``fn(r)`` in M threads, each under its slots; the results in
        rank order (a thread's exception raised here)."""
        out, errs = [None] * self.m, []

        def body(r):
            try:
                out[r] = fn(r)
            except BaseException as e:  # re-raised below
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.m)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


def _close(got, want, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * (1 + np.abs(want).max()), (what, err)


def _layer(tcfg, kind):
    return next((i, si, r, bi) for i, (si, r, bi, k)
                in enumerate(t_tf.layer_slots(tcfg)) if k == kind)


def _block(tcfg, kind, layer, params, m=1, rank=0):
    """Layer ``layer``'s ``transformer.Block`` of rank ``rank``'s shard
    at ``m`` model ranks (the whole block at m = 1), holding its piece of
    ``params`` (the whole model's)."""
    prefix = f"layers.{layer}."
    mine = {n: t for n, t in params.items() if n.startswith(prefix)}
    if m > 1:
        mine = tp.shard_params(mine, tp.plan(tcfg, m), rank)
    blk = t_tf.Block(kind, tp.shard_config(tcfg, m, rank), None,
                     device="cpu", dtype=torch.float32)
    blk.load_state_dict({n[len(prefix):]: t for n, t in mine.items()})
    return blk


def _random_cache(jcfg, kind, seed):
    rng = np.random.default_rng(seed)
    one = jax_model._block_cache_shape(kind, jcfg, B, S + 8, jnp.float32)
    scale = {"state": 0.01}
    return {name: jnp.asarray(rng.standard_normal(x.shape)
                              * scale.get(name, 1.0), jnp.float32)
            for name, x in one.items()}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", ["ssm", "rglru", "attn_local"])
def test_shards_of_a_block_sum_to_the_block(kind, m, mode):
    jcfg, params, tcfg, full = _models(ARCH[kind])
    layer, si, rep, bi = _layer(tcfg, kind)
    jp = jax.tree.map(lambda a: a[rep], params["stack"][si][bi])
    s = 1 if mode == "decode" else S
    pos = S + 3
    rng = np.random.default_rng([len(kind), m, len(mode)])
    x = jnp.asarray(rng.standard_normal((B, s, jcfg.d_model)), jnp.float32)
    cache = _random_cache(jcfg, kind, seed=layer)
    positions = (np.full((B, 1), pos, np.int32) if mode == "decode"
                 else np.tile(np.arange(s, dtype=np.int32), (B, 1)))
    decode = mode == "decode"
    if kind == "ssm":
        want, want_cache = jax_ssm.ssm_forward(
            jp["ssm"], x, jcfg, jnp.float32, cache["conv"], cache["state"],
            decode=decode)
    elif kind == "rglru":
        want, want_cache = jax_rglru.rglru_forward(
            jp["rglru"], x, jcfg, jnp.float32, cache["conv"], cache["h"],
            decode=decode)
    else:
        want, want_cache, _ = jax_tf.block_forward(
            kind, jp, x, jcfg, mode=mode, positions=jnp.asarray(positions),
            cache=cache, pos=jnp.int32(pos) if decode else None,
            compute_dtype=jnp.float32)

    tx = torch.tensor(np.asarray(x))
    tcache = {k: torch.tensor(np.asarray(v)) for k, v in cache.items()}

    def run(blk, cfg, c):
        with torch.no_grad():
            if kind == "ssm":
                return t_ssm.ssm_forward(blk.ssm, tx, cfg, torch.float32,
                                         c["conv"], c["state"], decode=decode)
            if kind == "rglru":
                return t_rglru.rglru_forward(blk.rglru, tx, cfg,
                                             torch.float32, c["conv"],
                                             c["h"], decode=decode)
            y, nc, _ = t_tf.block_forward(
                kind, blk, tx, cfg, mode=mode,
                positions=torch.tensor(positions), cache=c,
                pos=pos if decode else None, compute_dtype=torch.float32)
            return y, nc

    one, one_cache = run(_block(tcfg, kind, layer, full), tcfg, tcache)

    splits = tp.cache_plan(tcfg, m)[layer]
    axis = ThreadAxis(m)

    def rank(r):
        blk = _block(tcfg, kind, layer, full, m, r)
        cfg = tp.shard_config(tcfg, m, r)
        mine = {k: splits[k].take(v, r) for k, v in tcache.items()}
        with dist_ctx.residual_constraint(**axis.slots(r)):
            return run(blk, cfg, mine)

    outs = axis.run(rank)
    if kind == "attn_local":          # block_forward summed over the ranks
        for y, _ in outs[1:]:
            assert torch.equal(y, outs[0][0])
        got = outs[0][0]
    else:                              # the mixer's partial outputs
        got = sum(y for y, _ in outs)
    got_cache = {k: splits[k].join([c[k] for _, c in outs], k)
                 for k in outs[0][1]}
    _close(got, want, "out")
    _close(got, one, "out against the unsharded block")
    assert set(got_cache) == set(want_cache)
    for k in want_cache:
        _close(got_cache[k], want_cache[k], k)
        _close(got_cache[k], one_cache[k], k)
