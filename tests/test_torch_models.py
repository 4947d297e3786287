"""The port's model stack against the JAX package's, on the reduced configs
of recurrentgemma-9b (3 layers: rglru, rglru, attn_local with window 32) and
qwen2-0.5b (2 global-attention layers, QKV bias, tied head).

Both sides start from the same ``init_params`` arrays (the reference's,
carried across with ``models.interop``) and the same numpy inputs.  Each
block, then the whole model, under ``train``, ``prefill`` with caches (the
caches compared) and ``decode`` over several positions, ring wrap included.

Tolerances, as max |port − JAX| ≤ tol·(1 + max|JAX|):
* f32 compute: 1e-5 — same f32 math, other sum orders (and f32 attention
  where the reference's prefill rounds its probabilities to the compute
  dtype: the same in f32);
* bf16 compute: 3e-2 — the two frameworks round bf16 at other places (the
  port's prefill attention keeps its probabilities in f32 where the
  reference's q-chunked attention rounds them to bf16), and a few bf16 ulps
  (2^−8 relative each) build up over the layers.
"""

import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro.models import transformer as jax_tf
from repro_torch.configs import registry
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.models import attention as t_attention
from repro_torch.models import interop
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_tf

ARCHS = ["recurrentgemma-9b", "qwen2-0.5b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
B, S = 2, 64        # S = 2 · window of the reduced recurrentgemma
GEN = 6             # decode steps after the prefill

_MODELS = {}


def _models(arch):
    """(reference cfg, reference params, port cfg, port model), once per
    arch.  The port holds the reference's f32 arrays."""
    if arch not in _MODELS:
        jcfg = jax_registry.reduced(jax_registry.get_model_config(arch))
        tcfg = registry.reduced(registry.get_model_config(arch))
        params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        model = interop.params_from_reference(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _MODELS[arch] = (jcfg, params, tcfg, model)
    return _MODELS[arch]


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _close(got, want, tol, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def _close_caches(got, want_np, tcfg, tol):
    got_np = interop.caches_to_numpy(got, tcfg)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_np),
                            jax.tree.leaves(want_np)):
        _close(torch.tensor(g), w, tol, jax.tree_util.keystr(path))


def _jax_decoder(jcfg, jdt):
    """The reference's decode step, compiled once per (cfg, dtype)."""
    return jax.jit(lambda p, c, t, pos: jax_model.decode_step(
        p, c, t, pos, jcfg, compute_dtype=jdt))


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _random_cache(jcfg, kind, seq_len, jdt, seed):
    """A reference-layout cache of one layer, filled with noise (a carried
    RG-LRU state exercises the h0 fold; attention slots, the ring)."""
    rng = np.random.default_rng(seed)
    one = jax_model._block_cache_shape(kind, jcfg, B, seq_len, jdt)
    return {name: jnp.asarray(rng.standard_normal(x.shape), x.dtype)
            for name, x in one.items()}


def _first_layer(tcfg, kind):
    return next((i, si, r, bi) for i, (si, r, bi, k)
                in enumerate(t_tf.layer_slots(tcfg)) if k == kind)


BLOCK_CASES = [(arch, kind) for arch in ARCHS
               for kind in sorted(set(registry.reduced(
                   registry.get_model_config(arch)).blocks()))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,kind", BLOCK_CASES)
def test_block_matches_jax(arch, kind, mode, dtype):
    jcfg, params, tcfg, model = _models(arch)
    jdt, tdt, tol = DTYPES[dtype]
    i, si, r, bi = _first_layer(tcfg, kind)
    jparams = jax.tree.map(lambda a: a[r], params["stack"][si][bi])
    s = 1 if mode == "decode" else S
    pos = S + 3      # decode: past the window, the ring has wrapped
    rng = np.random.default_rng(hash((arch, kind, mode)) % 2**32)
    x = jnp.asarray(rng.standard_normal((B, s, jcfg.d_model)), jdt)
    positions = (np.full((B, 1), pos, np.int32) if mode == "decode"
                 else np.tile(np.arange(s, dtype=np.int32), (B, 1)))
    cache = None
    if mode != "train":
        cache = _random_cache(jcfg, kind, S + GEN, jdt, seed=i)
    want, want_cache, _ = jax_tf.block_forward(
        kind, jparams, x, jcfg, mode=mode, positions=jnp.asarray(positions),
        cache=cache, pos=jnp.int32(pos) if mode == "decode" else None,
        compute_dtype=jdt)
    with torch.no_grad():
        got, got_cache, _ = t_tf.block_forward(
            kind, model.layers[i], _t(x), tcfg, mode=mode,
            positions=torch.tensor(positions),
            cache=(None if cache is None
                   else {k: _t(v) for k, v in cache.items()}),
            pos=pos if mode == "decode" else None, compute_dtype=tdt)
    assert got.dtype == tdt
    _close(got, want, tol, "out")
    if mode != "train":
        for name in want_cache:
            _close(got_cache[name], want_cache[name], tol, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("h,kv,window", [(4, 1, 16), (4, 2, 0), (4, 4, 0)])
def test_qchunk_attention_matches_jax(h, kv, window, dtype):
    """Query blocks of 16 over S = 40 (a ragged last block), GQA and
    MHA."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(h + kv + window)
    q, k, v = (jnp.asarray(rng.standard_normal((B, 40, n, 32)), jdt)
               for n in (h, kv, kv))
    want = jax_attention.qchunk_attention(q, k, v, window=window,
                                          q_chunk=16)
    got = t_attention.qchunk_attention(_t(q), _t(k), _t(v), window=window,
                                       q_chunk=16)
    _close(got, want, tol)
    # query blocks change nothing: the rows are independent
    assert torch.equal(got, t_attention.naive_attention(
        _t(q), _t(k), _t(v), window=window))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_train_and_prefill_match_jax(arch, dtype):
    jcfg, params, tcfg, model = _models(arch)
    jdt, tdt, tol = DTYPES[dtype]
    toks = _tokens(jcfg, B, S, seed=1)
    want, _, _ = jax_model.forward(params, {"tokens": jnp.asarray(toks)},
                                   jcfg, compute_dtype=jdt)
    jcache = jax_model.init_cache(jcfg, B, S + GEN, dtype=jdt)
    want_last, want_caches, _ = jax_model.forward(
        params, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill",
        caches=jcache, compute_dtype=jdt, last_only=True)
    with torch.no_grad():
        got, _, _ = t_model.forward(model, {"tokens": _t(toks).long()},
                                    compute_dtype=tdt)
        got_last, got_caches, _ = t_model.forward(
            model, {"tokens": _t(toks).long()}, mode="prefill",
            caches=t_model.init_cache(tcfg, B, S + GEN, dtype=tdt,
                                      device="cpu"),
            compute_dtype=tdt, last_only=True)
    _close(got, want, tol, "train logits")
    _close(got_last, want_last, tol, "prefill logits")
    _close_caches(got_caches, want_caches, tcfg, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, dtype):
    """From a prefill of S = 2·window (recurrentgemma: the ring wraps at
    every step; qwen2: a global cache, written past its end where the
    reference clamps) through GEN decode steps, logits and caches each
    step."""
    jcfg, params, tcfg, model = _models(arch)
    jdt, tdt, tol = DTYPES[dtype]
    toks = _tokens(jcfg, B, S + GEN, seed=2)
    jc = jax_model.init_cache(jcfg, B, S + GEN, dtype=jdt)
    _, jc, _ = jax_model.forward(params, {"tokens": jnp.asarray(toks[:, :S])},
                                 jcfg, mode="prefill", caches=jc,
                                 compute_dtype=jdt, last_only=True)
    tc = interop.caches_from_reference(jax.tree.map(np.asarray, jc), tcfg,
                                       device="cpu")
    step = _jax_decoder(jcfg, jdt)
    for t in range(S, S + GEN):
        want, jc = step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                        jnp.int32(t))
        with torch.no_grad():
            got, tc = t_model.decode_step(model, tc, _t(toks[:, t:t + 1])
                                          .long(), t, compute_dtype=tdt)
        _close(got, want, tol, f"logits at {t}")
        _close_caches(tc, jc, tcfg, tol)


def test_decode_from_cold_start_matches_jax():
    """Token by token from position 0 (the validity mask of slots not yet
    written), through the ring wrap of the window-32 cache."""
    jcfg, params, tcfg, model = _models("recurrentgemma-9b")
    toks = _tokens(jcfg, 1, 40, seed=3)
    jc = jax_model.init_cache(jcfg, 1, 40, dtype=jnp.float32)
    tc = t_model.init_cache(tcfg, 1, 40, dtype=torch.float32, device="cpu")
    step = _jax_decoder(jcfg, jnp.float32)
    for t in range(40):
        want, jc = step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                        jnp.int32(t))
        with torch.no_grad():
            got, tc = t_model.decode_step(model, tc, _t(toks[:, t:t + 1])
                                          .long(), t,
                                          compute_dtype=torch.float32)
        _close(got, want, 1e-5, f"logits at {t}")
    _close_caches(tc, jc, tcfg, 1e-5)


def test_interop_round_trip_and_shape_check():
    jcfg, params, tcfg, _ = _models("recurrentgemma-9b")
    jc = jax_model.init_cache(jcfg, B, S, dtype=jnp.float32)
    jc = jax.tree.map(lambda x: np.random.default_rng(0).standard_normal(
        x.shape).astype(np.float32), jc)
    back = interop.caches_to_numpy(
        interop.caches_from_reference(jc, tcfg, device="cpu"), tcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a, b)
    bad = jax.tree.map(np.asarray, params)
    bad["final_norm"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        interop.params_from_reference(bad, tcfg, device="cpu")
    # every tensor of the reference, and nothing else
    assert t_model.param_count(_models("recurrentgemma-9b")[3]) == \
        jax_model.param_count(params)


def _scan_under_autograd(cfg):
    """mamba2's model is ported, and so is its scan kernel's backward pass
    (``SsdScanFn``): an operand that requires grad is not refused for it,
    and the call goes on to the device check."""
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.d_head
    xdt = torch.zeros((1, 4, h, s.d_head), requires_grad=True)
    bm = torch.zeros((1, 4, s.d_state))
    t_ssd.ssd_scan_bshp(xdt, torch.zeros((1, 4, h)), bm, bm, chunk=s.chunk)


@pytest.mark.parametrize("arch", ["mamba2-1.3b"])
def test_unported_parts_raise(arch):
    # nothing of mamba2 is unported: training reaches the kernel, which
    # takes only CUDA tensors (the MoE and frontend archs are ported too:
    # tests/test_torch_moe.py, test_torch_frontends.py,
    # test_torch_dro_frontends.py)
    cfg = registry.reduced(registry.get_model_config(arch))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _scan_under_autograd(cfg)


def test_full_width_recurrentgemma_shapes():
    """The served model, built on the meta device (no memory): 38 layers,
    12 attn_local and 26 rglru, 10.4 B parameters, 20.9 GB in bf16; the
    config's own count (9.57 B) takes wa/wx as diagonal."""
    cfg = registry.get_model_config("recurrentgemma-9b")
    model = t_model.init_params(cfg, generator=torch.Generator(),
                                device="meta", dtype=torch.bfloat16)
    kinds = [layer.kind for layer in model.layers]
    assert (len(kinds), kinds.count("attn_local"), kinds.count("rglru")) == \
        (38, 12, 26)
    n = t_model.param_count(model)
    assert 10.3e9 < n < 10.5e9 and cfg.param_count() < n
    w = cfg.rglru.lru_width
    # the tensors beyond the config's count: wa/wx whole, conv_w, conv_b,
    # ba, bx beside its 3·w, and the final norm
    assert n - cfg.param_count() == 26 * (2 * w * w + 5 * w) + cfg.d_model
    attn = model.layers[2].attn
    assert tuple(attn["wq"].shape) == (4096, 16, 256)
    assert tuple(attn["wk"].shape) == (4096, 1, 256)
    caches = t_model.init_cache(cfg, 4, 4096 + 32, device="meta")
    assert tuple(caches[2]["k"].shape) == (4, 2048, 1, 256)
    assert tuple(caches[0]["h"].shape) == (4, 4096)
