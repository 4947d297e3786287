"""The port's modality frontends and MoE models against the JAX package's,
on the reduced granite-moe-1b-a400m (2 ``moe`` layers), musicgen-medium (4
codebooks, untied (C, d, V) head) and internvl2-76b (4 prefix embeddings
a sequence): each whole model under ``train``, ``prefill`` with caches
(the caches compared) and ``decode`` over a few positions; the codebook
batch built from the reference's draws; ``round_batches`` with codebook
streams and prefix embeddings; a codebook model served as a prefill
server and decoded token by token; the full configs built on the meta
device; the interop both ways.

Both sides start from the same ``init_params`` arrays (the reference's,
carried across with ``models.interop``) and the same numpy inputs.
Tolerances, as max |port − JAX| ≤ tol·(1 + max|JAX|): f32 compute 1e-5,
bf16 compute 3e-2 (as ``tests/test_torch_models.py``).
"""
import _torch_threads  # noqa: F401
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.data import synthetic as jax_data
from repro.models import model as jax_model
from repro_torch.configs import registry
from repro_torch.data import synthetic as t_data
from repro_torch.launch import serve as serve_lib
from repro_torch.models import interop
from repro_torch.models import model as t_model

ARCHS = ["granite-moe-1b-a400m", "musicgen-medium", "internvl2-76b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
B, S, GEN = 2, 16, 3


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(reference cfg, reference params, port cfg, port model), once per
    arch.  The port holds the reference's f32 arrays."""
    jcfg = jax_registry.reduced(jax_registry.get_model_config(arch))
    tcfg = registry.reduced(registry.get_model_config(arch))
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    model = interop.params_from_reference(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, params, tcfg, model


@functools.lru_cache(maxsize=None)
def _decoder(arch, dtype):
    jcfg, jdt = _models(arch)[0], DTYPES[dtype][0]
    return jax.jit(lambda p, c, t, pos: jax_model.decode_step(
        p, c, t, pos, jcfg, compute_dtype=jdt))


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.tensor(a)
    return t if t.is_floating_point() else t.long()


def _close(got, want, tol, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * (1 + np.abs(want).max()), (what, err)


def _batch(cfg, s, seed):
    """Tokens (B, s[, C]) and, for a prefix model, (B, P, d) embeddings."""
    rng = np.random.default_rng(seed)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, s, *cb)).astype(
        np.int32)}
    if cfg.num_prefix_tokens:
        b["prefix"] = (0.02 * rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model))).astype(np.float32)
    return b


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_jax(arch, dtype):
    """The train logits, the prefill's last logits and caches, then GEN
    decode steps (logits and caches each step; decode takes no prefix).
    Each decode step starts from the reference's caches: in bf16 the
    port's own prefill caches differ from the reference's by bf16 ulps,
    enough to flip a near-tie top-2 routing of the reduced
    granite-moe-1b-a400m (read: experts 0 and 3 at 0.2536 / 0.2519 in the
    reference, 0.2523 / 0.2540 in the port, one token of 2)."""
    jcfg, params, tcfg, model = _models(arch)
    jdt, tdt, tol = DTYPES[dtype]
    batch = _batch(jcfg, S + GEN, seed=1)
    prompt = {k: (v[:, :S] if k == "tokens" else v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in prompt.items()}
    tb = {k: _t(v) for k, v in prompt.items()}
    want, _, want_aux = jax_model.forward(params, jb, jcfg, compute_dtype=jdt)
    jc = jax_model.init_cache(jcfg, B, S + GEN, dtype=jdt)
    want_last, jc, _ = jax_model.forward(
        params, jb, jcfg, mode="prefill", caches=jc, compute_dtype=jdt,
        last_only=True)
    with torch.no_grad():
        got, _, got_aux = t_model.forward(model, tb, compute_dtype=tdt)
        got_last, tc, _ = t_model.forward(
            model, tb, mode="prefill", compute_dtype=tdt, last_only=True,
            caches=t_model.init_cache(tcfg, B, S + GEN, dtype=tdt,
                                      device="cpu"))
    _close(got, want, tol, "train logits")
    _close(got_aux, want_aux, tol, "aux")
    _close(got_last, want_last, tol, "prefill logits")
    for g, w in zip(jax.tree.leaves(interop.caches_to_numpy(tc, tcfg)),
                    jax.tree.leaves(jc)):
        _close(torch.tensor(g), w, tol, "prefill cache")
    step = _decoder(arch, dtype)
    toks = batch["tokens"]
    for t in range(S, S + GEN):
        tc = interop.caches_from_reference(jax.tree.map(np.asarray, jc),
                                           tcfg, device="cpu")
        want, jc = step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                        jnp.int32(t))
        with torch.no_grad():
            got, tc = t_model.decode_step(model, tc, _t(toks[:, t:t + 1]), t,
                                          compute_dtype=tdt)
        _close(got, want, tol, f"decode logits at {t}")
        for g, w in zip(jax.tree.leaves(interop.caches_to_numpy(tc, tcfg)),
                        jax.tree.leaves(jc)):
            _close(torch.tensor(g), w, tol, f"decode cache at {t}")


@pytest.mark.parametrize("vocab,client,batch,seq_len",
                         [(512, 1, 3, 16), (2048, 0, 2, 9)])
def test_codebook_batch_on_the_reference_draws_is_the_reference_batch(
        vocab, client, batch, seq_len):
    """``codebook_batch_from_draws`` on the reference's own draws (its g and
    its (C, B, S + 1) categorical tokens, reference :84-95) gives the
    reference's batch exactly."""
    c = 4
    dm = jax_data.make_data_model(jax.random.PRNGKey(0), vocab_size=vocab,
                                  num_groups=8, num_clients=4, alpha=0.3)
    key = jax.random.PRNGKey(vocab + client)
    want = jax_data.sample_client_batch(dm, key, client, batch, seq_len, c)
    kg, kt, _ = jax.random.split(key, 3)
    g = jax.random.categorical(kg, jnp.log(dm.mixtures[client] + 1e-9),
                               shape=(batch,))
    toks = jax.random.categorical(
        kt, dm.domain_logits[g][:, None, :],
        shape=(c, batch, seq_len + 1)).transpose(1, 2, 0)
    port_dm = t_data.DataModel(
        domain_logits=torch.tensor(np.asarray(dm.domain_logits)),
        domain_shift=torch.tensor(np.asarray(dm.domain_shift)).long(),
        mixtures=torch.tensor(np.asarray(dm.mixtures)),
        vocab_size=dm.vocab_size, num_groups=dm.num_groups)
    got = t_data.codebook_batch_from_draws(port_dm, _t(g), _t(toks))
    for name in ("tokens", "labels", "groups"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        assert got[name].dtype == torch.int64


def test_round_batches_carry_codebooks_and_prefix():
    """(K, n, B, S, C) codebook streams whose labels are the next tokens
    shifted by the domain's shift, and (K, n, B, P, d) prefix embeddings of
    standard deviation 0.02 (within 5 %)."""
    music = registry.reduced(registry.get_model_config("musicgen-medium"))
    vlm = registry.reduced(registry.get_model_config("internvl2-76b"))
    dm = t_data.make_data_model(vocab_size=music.vocab_size, num_groups=4,
                                num_clients=2)
    gen = torch.Generator()
    gen.manual_seed(0)
    kw = dict(local_steps=2, num_clients=2, per_client_batch=3, seq_len=8)
    rb = t_data.round_batches(dm, gen, cfg=music, **kw)
    assert tuple(rb["tokens"].shape) == (2, 2, 3, 8, 4)
    assert tuple(rb["groups"].shape) == (2, 2, 3, 8)
    shift = dm.domain_shift[rb["groups"]][..., None]
    assert torch.equal(rb["labels"][..., :-1, :],
                       (rb["tokens"][..., 1:, :] + shift[..., 1:, :])
                       % music.vocab_size)
    rb = t_data.round_batches(dm, gen, cfg=vlm, **kw)
    assert tuple(rb["prefix"].shape) == (2, 2, 3, vlm.num_prefix_tokens,
                                         vlm.d_model)
    assert rb["prefix"].dtype == torch.float32
    assert abs(float(rb["prefix"].std()) / 0.02 - 1) < 0.05
    assert tuple(rb["tokens"].shape) == (2, 2, 3, 8)


def test_codebook_decode_equals_the_full_forward():
    """A codebook model decoded token by token from position 0 — the prompt,
    then (B, 1, C) tokens sampled from each step's (B, 1, C, V) logits —
    equals the full forward over the same tokens, in f32."""
    model = _models("musicgen-medium")[3]
    cfg = model.cfg
    prompt = _t(_batch(cfg, 6, seed=2)["tokens"])
    gen = torch.Generator()
    gen.manual_seed(0)
    caches = t_model.init_cache(cfg, B, 6 + GEN, dtype=torch.float32,
                                device="cpu")
    toks, steps = [prompt[:, i:i + 1] for i in range(6)], []
    with torch.no_grad():
        for t in range(6 + GEN):
            logits, caches = t_model.decode_step(
                model, caches, toks[t], t, compute_dtype=torch.float32)
            steps.append(logits)
            if t >= 5 and len(toks) < 6 + GEN:
                tok = serve_lib.sample(logits, 1.0, gen)
                assert tuple(tok.shape) == (B, 1, cfg.num_codebooks)
                toks.append(tok)
        full, _, _ = t_model.forward(model, {"tokens": torch.cat(toks, 1)},
                                     compute_dtype=torch.float32)
    _close(torch.cat(steps, 1), full.numpy(), 1e-5, "decode vs full")


def test_serve_codebooks_as_a_prefill_server():
    """``serve`` on the reduced musicgen-medium: (B, P, C) prompts, the
    prefill's (B, 1, C, V) logits against the full forward's last
    position; decoding after the prompt of a global cache is refused."""
    res = serve_lib.serve("musicgen-medium", batch=2, prompt_len=16,
                          gen_tokens=0, device="cpu", reduced=True)
    cfg = res.model.cfg
    assert tuple(res.prompt.shape) == (2, 16, cfg.num_codebooks)
    assert tuple(res.logits.shape) == (2, 1, cfg.num_codebooks,
                                       cfg.vocab_size)
    assert tuple(res.tokens.shape) == (2, 0, cfg.num_codebooks)
    with torch.no_grad():
        full, _, _ = t_model.forward(res.model, {"tokens": res.prompt})
    _close(res.logits, full[:, -1:].float().numpy(), 3e-2, "prefill")
    with pytest.raises(ValueError, match="divides the prompt"):
        serve_lib.serve("musicgen-medium", batch=2, prompt_len=16,
                        gen_tokens=2, device="cpu", reduced=True)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b",
                                  "musicgen-medium", "internvl2-76b"])
def test_full_configs_build_on_the_meta_device(arch):
    """``init_params`` builds the full config (no memory) with every tensor
    of the reference's ``init_params`` (its shapes from ``eval_shape``)."""
    model = t_model.init_params(registry.get_model_config(arch),
                                generator=torch.Generator(), device="meta",
                                dtype=torch.bfloat16)
    jcfg = jax_registry.get_model_config(arch)
    shapes = jax.eval_shape(lambda k: jax_model.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    assert t_model.param_count(model) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tuple(model.embed.shape) == tuple(shapes["embed"].shape)
    if "head" in shapes:
        assert tuple(model.head.shape) == tuple(shapes["head"].shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_round_trip(arch):
    """The reference's parameters across and back, bit for bit: the (C, V,
    d) embedding, the (C, d, V) head and every ``moe`` leaf among them."""
    jcfg, params, tcfg, model = _models(arch)
    back = interop.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    stacked = interop.stacked_params_from_reference(
        [jax.tree.map(np.asarray, params)] * 2, tcfg, device="cpu")
    for one in interop.stacked_params_to_numpy(stacked, tcfg):
        for a, b in zip(jax.tree.leaves(one), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, np.asarray(b))
