"""The port's serving path on the CPU: prefill, then decode, equals the
full forward (the twin of tests/test_decode_consistency.py), and the serve
entry point end to end on the reduced recurrentgemma-9b (window 32).

Tolerances, as max |Δ| ≤ tol·(1 + max|full|): f32 compute 1e-5 — the
same math in another order (prefill, ring-buffer decode, full sequence);
bf16 compute (``serve`` itself) 3e-2 — the decode path rounds to bf16 at
other places than the full forward (a CPU run at 38 layers, d = 512, gave
4.3e-3).
"""
import _torch_threads  # noqa: F401
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import serve as serve_lib
from repro_torch.models import model as t_model

TOL = 1e-5
TOL_BF16 = 3e-2


def _close(got, want, tol=TOL):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * (1 + want.float().abs().max().item()), err
    return err


def _model(arch, seed=0):
    cfg = registry.reduced(registry.get_model_config(arch))
    return t_model.init_params(cfg, seed=seed, device="cpu",
                               dtype=torch.float32)


def _full_logits(model, tokens):
    with torch.no_grad():
        logits, _, _ = t_model.forward(model, {"tokens": tokens},
                                       compute_dtype=torch.float32)
    return logits


def _prefill_then_decode(model, tokens, prompt_len):
    """Logits of the prefill's last position (if prompt_len > 0), then of
    each decode step over the rest of ``tokens``."""
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


def test_prefill_then_decode_equals_full_forward():
    """Prefill of S = 2·window (64), then 10 decode steps past it."""
    model = _model("recurrentgemma-9b")
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 74),
                           generator=torch.Generator().manual_seed(0))
    got = _prefill_then_decode(model, tokens, 64)
    _close(got, _full_logits(model, tokens)[:, 63:])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen2-0.5b"])
def test_decode_from_position_zero_equals_full_forward(arch):
    model = _model(arch)
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(1))
    got = _prefill_then_decode(model, tokens, 0)
    _close(got, _full_logits(model, tokens))


def test_misaligned_prefill_misses_the_full_forward():
    """Why serve refuses such prompts: with 40 prompt tokens the window-32
    cache keeps positions 8..39 in slots 0..31, where decode's ring expects
    position p at slot p % 32 (ROADMAP §C)."""
    model = _model("recurrentgemma-9b")
    tokens = torch.randint(0, model.cfg.vocab_size, (1, 46),
                           generator=torch.Generator().manual_seed(2))
    got = _prefill_then_decode(model, tokens, 40)
    full = _full_logits(model, tokens)[:, 39:]
    assert (got[:, 1:] - full[:, 1:]).abs().max() > 1e-2
    _close(got[:, :1], full[:, :1])     # the prefill itself is right


def test_generate_logits_are_the_full_forward():
    """f32: the logits that drew each token are the full forward's, and
    the prefill's caches are kept as the prefill left them."""
    model = _model("recurrentgemma-9b", seed=4)
    prompt = torch.randint(0, model.cfg.vocab_size, (3, 64),
                           generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    res = serve_lib.generate(model, prompt, 5, generator=gen,
                             compute_dtype=torch.float32)
    assert res.tokens.shape == (3, 5)
    assert res.logits.shape == (3, 6, model.cfg.vocab_size)
    seq = torch.cat([prompt, res.tokens], dim=1)
    _close(res.logits, _full_logits(model, seq)[:, 63:])
    kinds = model.cfg.blocks()
    assert [set(c) for c in res.prefill_caches] == [
        {"conv", "h"} if k == "rglru" else {"k", "v"} for k in kinds]
    assert res.prefill_caches[2]["k"].shape == (3, 32, 1, 64)
    # on CPU tensors no kernel launches: the plain versions run, and the
    # prefill with kernels=False (the check on the card) is the same one
    assert set(res.launches["prefill"].values()) == {0}
    with torch.no_grad():
        plain, _, _ = t_model.forward(
            model, {"tokens": prompt}, mode="prefill", last_only=True,
            caches=t_model.init_cache(model.cfg, 3, 69, device="cpu",
                                      dtype=torch.float32),
            compute_dtype=torch.float32, kernels=False)
    assert torch.equal(plain, res.logits[:, :1])


def test_serve_end_to_end_on_cpu():
    res = serve_lib.serve("recurrentgemma-9b", batch=3, prompt_len=64,
                          gen_tokens=5, device="cpu", reduced=True, seed=4)
    cfg = res.model.cfg
    assert res.prompt.shape == (3, 64) and res.tokens.shape == (3, 5)
    assert res.logits.shape == (3, 6, cfg.vocab_size)
    assert res.logits.dtype == torch.bfloat16
    assert torch.isfinite(res.logits.float()).all()
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
    seq = torch.cat([res.prompt, res.tokens], dim=1)
    with torch.no_grad():
        full, _, _ = t_model.forward(res.model, {"tokens": seq})
    _close(res.logits, full[:, 63:], TOL_BF16)
    # the same seed serves the same tokens
    again = serve_lib.serve("recurrentgemma-9b", batch=3, prompt_len=64,
                            gen_tokens=5, device="cpu", reduced=True, seed=4)
    assert torch.equal(again.tokens, res.tokens)


def test_serve_greedy_takes_the_argmax():
    res = serve_lib.serve("recurrentgemma-9b", batch=2, prompt_len=32,
                          gen_tokens=3, temperature=0.0, device="cpu",
                          reduced=True)
    assert torch.equal(res.tokens, res.logits[:, :3].argmax(-1))


@pytest.mark.parametrize("arch,prompt_len,gen", [
    ("recurrentgemma-9b", 40, 6),   # 32 does not divide 40
    ("recurrentgemma-9b", 16, 6),   # cache of 22 for 22 tokens
    ("qwen2-0.5b", 16, 4),          # a global cache of 20 for 20 tokens
])
def test_serve_refuses_a_prompt_the_cache_length_does_not_divide(
        arch, prompt_len, gen):
    with pytest.raises(ValueError, match="divides the prompt length"):
        serve_lib.serve(arch, batch=1, prompt_len=prompt_len, gen_tokens=gen,
                        device="cpu", reduced=True)


def test_serve_accepts_a_global_cache_without_decode():
    res = serve_lib.serve("qwen2-0.5b", batch=1, prompt_len=16, gen_tokens=0,
                          device="cpu", reduced=True)
    assert res.tokens.shape == (1, 0) and res.logits.shape[1] == 1


def test_serve_cli(capsys):
    serve_lib.main(["--device", "cpu", "--reduced", "--prompt-len", "32",
                    "--tokens", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert "prefill 32 tok x 2 seq" in out and "ms/token" in out
