"""The port's mamba2-1.3b model against the JAX package, and its serving
path on the CPU.

The reduced mamba2-1.3b (2 ``ssm`` layers, d 256, 16 heads of 32, d_state
16, chunk 16, vocab 512, tied head) holds the reference's ``init_params``
arrays (carried across with ``models.interop``).  The forward in train
mode, the prefill with its caches, and decode steps against the
reference's; prefill + decode against the full forward (the twin of
``tests/test_decode_consistency.py``, which covers mamba2 in the
reference); the serve entry point end to end; the full-width model's
shapes on the meta device.

Tolerances, as max |Δ| ≤ tol·(1 + max|reference|): f32 compute 1e-5 (the
same math in other orders); bf16 compute 3e-2 (the frameworks round bf16
at other places, as ``tests/test_torch_models.py`` states).
"""
import _torch_threads  # noqa: F401
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import model as jax_model
from repro_torch.configs import registry
from repro_torch.launch import serve as serve_lib
from repro_torch.models import interop
from repro_torch.models import model as t_model

ARCH = "mamba2-1.3b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
B, S, GEN = 2, 40, 6     # S: two chunks of 16 and a ragged one

_MODEL = {}


def _mamba():
    if not _MODEL:
        jcfg = jax_registry.reduced(jax_registry.get_model_config(ARCH))
        tcfg = registry.reduced(registry.get_model_config(ARCH))
        params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        model = interop.params_from_reference(
            jax.tree.map(np.asarray, params), tcfg, device="cpu")
        _MODEL.update(jcfg=jcfg, params=params, tcfg=tcfg, model=model)
    return _MODEL["jcfg"], _MODEL["params"], _MODEL["tcfg"], _MODEL["model"]


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


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_reduced_model_holds_the_reference_parameters():
    jcfg, params, tcfg, model = _mamba()
    assert [layer.kind for layer in model.layers] == ["ssm", "ssm"]
    # an ssm layer holds only norm1 and the mixer, as the reference's
    assert {n.split(".")[0] for n, _ in model.layers[0].named_parameters()} \
        == {"norm1", "ssm"}
    assert model.head is None and tcfg.tie_embeddings
    assert t_model.param_count(model) == jax_model.param_count(params)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_and_prefill_match_jax(dtype):
    jcfg, params, tcfg, model = _mamba()
    jdt, tdt, tol = DTYPES[dtype]
    toks = _tokens(jcfg.vocab_size, B, S, seed=1)
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
    assert [set(c) for c in got_caches] == [{"conv", "state"}] * 2
    assert got_caches[0]["conv"].dtype == tdt
    assert got_caches[0]["state"].dtype == torch.float32


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_steps_match_jax(dtype):
    jcfg, params, tcfg, model = _mamba()
    jdt, tdt, tol = DTYPES[dtype]
    toks = _tokens(jcfg.vocab_size, B, S + GEN, seed=2)
    jc = jax_model.init_cache(jcfg, B, S + GEN, dtype=jdt)
    _, jc, _ = jax_model.forward(params, {"tokens": jnp.asarray(toks[:, :S])},
                                 jcfg, mode="prefill", caches=jc,
                                 compute_dtype=jdt, last_only=True)
    tc = interop.caches_from_reference(jax.tree.map(np.asarray, jc), tcfg,
                                       device="cpu")
    step = jax.jit(lambda p, c, t, pos: jax_model.decode_step(
        p, c, t, pos, jcfg, compute_dtype=jdt))
    for t in range(S, S + GEN):
        want, jc = step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                        jnp.int32(t))
        with torch.no_grad():
            got, tc = t_model.decode_step(model, tc, _t(toks[:, t:t + 1])
                                          .long(), t, compute_dtype=tdt)
        _close(got, want, tol, f"logits at {t}")
        _close_caches(tc, jc, tcfg, tol)


def test_interop_round_trips_the_ssm_parameters_and_caches():
    jcfg, params, tcfg, model = _mamba()
    jc = jax_model.init_cache(jcfg, B, S, dtype=jnp.float32)
    jc = jax.tree.map(lambda x: np.random.default_rng(0).standard_normal(
        x.shape).astype(np.float32), jc)
    back = interop.caches_to_numpy(
        interop.caches_from_reference(jc, tcfg, device="cpu"), tcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a, b)
    # parameters: the port's model back in the reference's nesting, which
    # the reference's forward takes
    p_np = interop.params_to_numpy(model)
    assert jax.tree.structure(p_np) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(p_np), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _prefill_then_decode(model, tokens, prompt_len):
    b, total = tokens.shape
    out = []
    with torch.no_grad():
        caches = t_model.init_cache(model.cfg, b, total, dtype=torch.float32,
                                    device="cpu")
        if prompt_len:
            logits, caches, _ = t_model.forward(
                model, {"tokens": tokens[:, :prompt_len]}, mode="prefill",
                caches=caches, compute_dtype=torch.float32, last_only=True)
            out.append(logits)
        for t in range(prompt_len, total):
            logits, caches = t_model.decode_step(
                model, caches, tokens[:, t:t + 1], t,
                compute_dtype=torch.float32)
            out.append(logits)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("prompt_len", [0, 17, 32])
def test_prefill_then_decode_equals_full_forward(prompt_len):
    """Any prompt length: no KV cache, so the conv and SSD states carry the
    whole prefix (a prefill of 17 tokens ends inside a chunk)."""
    cfg = registry.reduced(registry.get_model_config(ARCH))
    model = t_model.init_params(cfg, seed=3, device="cpu",
                                dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 42),
                           generator=torch.Generator().manual_seed(4))
    got = _prefill_then_decode(model, tokens, prompt_len)
    with torch.no_grad():
        full, _, _ = t_model.forward(model, {"tokens": tokens},
                                     compute_dtype=torch.float32,
                                     kernels=False)
    want = full[:, max(prompt_len - 1, 0):]
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * (1 + want.abs().max().item()), err


def test_serve_mamba2_end_to_end_on_cpu():
    res = serve_lib.serve(ARCH, batch=3, prompt_len=40, gen_tokens=5,
                          device="cpu", reduced=True, seed=4)
    cfg = res.model.cfg
    assert res.prompt.shape == (3, 40) and res.tokens.shape == (3, 5)
    assert res.logits.shape == (3, 6, cfg.vocab_size)
    assert res.logits.dtype == torch.bfloat16
    assert torch.isfinite(res.logits.float()).all()
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
    assert [set(c) for c in res.prefill_caches] == [{"conv", "state"}] * 2
    seq = torch.cat([res.prompt, res.tokens], dim=1)
    with torch.no_grad():
        full, _, _ = t_model.forward(res.model, {"tokens": seq},
                                     kernels=False)
    want = full[:, 39:].float()
    err = (res.logits.float() - want).abs().max().item()
    assert err <= 3e-2 * (1 + want.abs().max().item()), err
    # CPU tensors launch no kernel: the plain versions run
    assert set(res.launches["prefill"].values()) == {0}


def test_full_width_mamba2_shapes():
    """The served model on the meta device (no memory): 48 ssm layers,
    d_in 4096 = 64 heads × 64, d_state 128, tied vocab 50280; 1.344 B
    parameters, 2.69 GB in bf16."""
    cfg = registry.get_model_config(ARCH)
    model = t_model.init_params(cfg, generator=torch.Generator(),
                                device="meta", dtype=torch.bfloat16)
    assert [layer.kind for layer in model.layers] == ["ssm"] * 48
    n = t_model.param_count(model)
    assert 1.34e9 < n < 1.35e9
    ssm = model.layers[0].ssm
    assert tuple(ssm["in_proj"].shape) == (2048, 2 * 4096 + 2 * 128 + 64)
    assert tuple(ssm["conv_w"].shape) == (4, 4096 + 2 * 128)
    assert tuple(ssm["out_proj"].shape) == (4096, 2048)
    caches = t_model.init_cache(cfg, 8, 4096 + 32, device="meta")
    assert tuple(caches[0]["conv"].shape) == (8, 3, 4352)
    assert tuple(caches[0]["state"].shape) == (8, 64, 64, 128)
