"""Serving entry point: batched prefill, then decode (port of
``repro.launch.serve`` and the single-device body of
``repro.launch.steps.build_prefill_step`` / ``build_decode_step``).

One prefill step runs ``forward(mode="prefill", caches=init_cache(B,
prompt_len + gen_tokens), last_only=True)`` over the whole batch of prompts,
through the model's kernels (flash attention and the RG-LRU scan for
recurrentgemma-9b, the SSD scan for mamba2-1.3b); then ``gen_tokens``
decode steps each sample a token (``torch.multinomial``) and feed it back.
The decode step is ``serving.decode.DecodeStep``: on the card one CUDA
graph, captured once a call (its model, batch and cache length fixed) and
replayed every step; ``capture=False`` runs it eagerly.  Weights are bf16
on the card, drawn from a seeded ``torch.Generator``, as are the prompts.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --device cpu --reduced --prompt-len 40 --tokens 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --local --device cpu

A prefill fills a KV cache exactly only when the cache's length divides the
prompt length (the cache keeps the last ``length`` keys, and decode's ring
writes position p at slot p % length); other prompt lengths are refused.
Layers without a KV cache (``rglru``, ``ssm``) take any prompt length.  So
a model whose layers attend globally (qwen2-0.5b, granite-moe-1b-a400m,
musicgen-medium, …: a cache as long as prompt and new tokens together) is
served here as a prefill server, ``--tokens 0``; it generates after its
prompt through the continuous-batching engine
(``repro_torch.serving.ServingEngine``) or ``--local``, both of which
prefill token by token through the decode step.  ``--local`` is the
reference's single-device demo (``serve_local``): the arch's reduced
config, the prompt token by token, then sampled decode steps
(``generate_stepwise``, which ``launch.serve_example`` runs too).  An audio
model's prompts are (B, P, C) codebook streams, and each decode step
samples every codebook: (B, 1, C) (reference ``launch/serve.py:31,49``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.serving.decode import DecodeStep, gumbel_noise


@dataclasses.dataclass
class ServeResult:
    model: model_lib.Model
    prompt: torch.Tensor          # (B, prompt_len[, C])
    tokens: torch.Tensor          # (B, gen_tokens[, C]), the sampled tokens
    logits: torch.Tensor          # (B, gen_tokens + 1[, C], V): the
    #                               prefill's last position, then each
    #                               decode step's
    prefill_caches: List[Dict[str, torch.Tensor]]
    prefill_s: float
    decode_s: float
    capture_s: float                      # the decode step's capture
    launches: Dict[str, Dict[str, int]]   # kernel launches: prefill, decode


def check_prompt(cfg: ModelConfig, prompt_len: int, total: int) -> None:
    """Refuse a prompt length that some KV cache's length does not divide:
    the prefill keeps the last ``length`` keys (reference
    ``models/transformer.py:166-171``), which lands position p at decode's
    ring slot p % length only then."""
    for kind in sorted(set(cfg.blocks())):
        length = model_lib.cache_length(kind, cfg, total)
        if length is not None and prompt_len % length:
            raise ValueError(
                f"prompt length {prompt_len}: the {kind!r} layers' KV cache "
                f"holds {length} positions for {total} tokens, and a prefill "
                f"fills it exactly only when that length divides the prompt "
                f"length")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample(logits, temperature: float, generator) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) tokens, or (B, 1, C, V) -> (B, 1, C), a
    token of each codebook; temperature 0 is greedy."""
    last = logits[:, -1].to(torch.float32)        # (B, V) or (B, C, V)
    if temperature <= 0:
        return last.argmax(-1)[:, None]
    probs = torch.softmax(last / temperature, dim=-1)
    tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                            generator=generator)
    return tok.reshape(last.shape[:-1])[:, None]


@torch.no_grad()
def generate(model: model_lib.Model, prompt: torch.Tensor, gen_tokens: int, *,
             temperature: float = 1.0, generator=None,
             compute_dtype=torch.bfloat16, capture=None) -> ServeResult:
    """Prefill ``prompt`` (B, P), or (B, P, C) with codebooks, in one
    step, then ``gen_tokens`` decode steps through a ``DecodeStep`` on
    copies of the prefill's caches (``capture`` None: a CUDA graph on the
    card)."""
    cfg = model.cfg
    b, prompt_len = prompt.shape[:2]
    total = prompt_len + gen_tokens
    check_prompt(cfg, prompt_len, total)
    device = prompt.device
    caches = model_lib.init_cache(cfg, b, total, dtype=compute_dtype,
                                  device=device)
    start = ops.launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    logits, caches, _ = model_lib.forward(
        model, {"tokens": prompt}, mode="prefill", compute_dtype=compute_dtype,
        caches=caches, last_only=True)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    after_prefill = ops.launch_counts()
    prefill_caches = caches
    steps, toks = [logits], []
    step = None
    if gen_tokens:
        step = DecodeStep(model, [{k: v.clone() for k, v in c.items()}
                                  for c in caches], b,
                          compute_dtype=compute_dtype, capture=capture)
    t0 = time.perf_counter()
    for i in range(gen_tokens):
        tok = sample(logits, temperature, generator)
        toks.append(tok)
        step.tokens.copy_(tok)
        step.pos.fill_(prompt_len + i)
        step()
        logits = step.logits.clone()
        steps.append(logits)
    _sync(device)
    decode_s = time.perf_counter() - t0
    end = ops.launch_counts()
    launches = {
        "prefill": {k: after_prefill[k] - start[k] for k in start},
        "decode": {k: end[k] - after_prefill[k] for k in start}}
    tokens = (torch.cat(toks, dim=1) if toks
              else prompt.new_zeros((b, 0, *prompt.shape[2:])))
    return ServeResult(model=model, prompt=prompt, tokens=tokens,
                       logits=torch.cat(steps, dim=1),
                       prefill_caches=prefill_caches, prefill_s=prefill_s,
                       decode_s=decode_s,
                       capture_s=step.capture_s if step else 0.0,
                       launches=launches)


def serve(arch: str, *, batch: int = 4, prompt_len: int = 4096,
          gen_tokens: int = 32, temperature: float = 1.0, device="cuda",
          seed: int = 0, reduced: bool = False) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens on a model of
    ``arch`` (its reduced CPU-test variant if ``reduced``) with fresh bf16
    weights, computing in bf16, and generate ``gen_tokens`` tokens each."""
    cfg = registry.get_model_config(arch)
    if reduced:
        cfg = registry.reduced(cfg)
    check_prompt(cfg, prompt_len, prompt_len + gen_tokens)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = model_lib.init_params(cfg, generator=gen, device=device,
                                  dtype=torch.bfloat16)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len, *cb),
                           generator=gen, device=device)
    res = generate(model, prompt, gen_tokens, temperature=temperature,
                   generator=gen)
    print(f"[serve] {cfg.name}: prefill {prompt_len} tok x {batch} seq "
          f"in {res.prefill_s:.3f} s", flush=True)
    if gen_tokens:
        print(f"[serve] decoded {gen_tokens} tok/seq in {res.decode_s:.3f} s: "
              f"{1e3 * res.decode_s / gen_tokens:.2f} ms/token, "
              f"{gen_tokens * batch / res.decode_s:.1f} tok/s aggregate",
              flush=True)
    return res


@dataclasses.dataclass
class StepwiseResult:
    logits: torch.Tensor          # (B, P + T[, C], V): each step's, the
    #                               prompt's P steps, then the T decode steps
    tokens: torch.Tensor          # (B, T[, C]), the sampled tokens
    prefill_s: float
    decode_s: float
    capture_s: float


@torch.no_grad()
def generate_stepwise(model: model_lib.Model, prompt: torch.Tensor,
                      gen_tokens: int, *, temperature: float = 1.0,
                      generator=None, noise=None,
                      compute_dtype=torch.bfloat16,
                      capture=None) -> StepwiseResult:
    """The reference's local serve loop (``repro/launch/serve.py:23-53``,
    ``examples/serve.py``): ``prompt`` (B, P[, C]) token by token through
    a ``DecodeStep`` (for exactness across cache kinds), then
    ``gen_tokens`` steps, each fed the token sampled from the step before
    (``serving.decode.sample``: Gumbel noise from ``noise(shape)`` if
    given, else from ``generator``, drawn once a sample, in the
    reference's order)."""
    b, prompt_len = prompt.shape[:2]
    device = prompt.device
    caches = model_lib.init_cache(model.cfg, b, prompt_len + gen_tokens,
                                  dtype=compute_dtype, device=device)
    step = DecodeStep(model, caches, b, compute_dtype=compute_dtype,
                      capture=capture, sample=True)
    step.temps.fill_(temperature)
    shape = tuple(step.noise.shape)

    def draw():
        step.noise.copy_(noise(shape) if noise else
                         gumbel_noise(shape, generator, device))

    logits, toks = [], []
    _sync(device)
    t0 = time.perf_counter()
    for t in range(prompt_len):
        step.tokens.copy_(prompt[:, t:t + 1])
        step.pos.fill_(t)
        if t == prompt_len - 1 and gen_tokens:
            draw()
        step()
        logits.append(step.logits.clone())
    _sync(device)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(gen_tokens):
        tok = step.sampled[:, None].clone()
        toks.append(tok)
        step.tokens.copy_(tok)
        step.pos.fill_(prompt_len + i)
        if i < gen_tokens - 1:
            draw()
        step()
        logits.append(step.logits.clone())
    _sync(device)
    decode_s = time.perf_counter() - t0
    tokens = (torch.cat(toks, dim=1) if toks
              else prompt.new_zeros((b, 0, *prompt.shape[2:])))
    return StepwiseResult(logits=torch.cat(logits, dim=1), tokens=tokens,
                          prefill_s=prefill_s, decode_s=decode_s,
                          capture_s=step.capture_s)


def reduced_model_and_prompts(arch: str, batch: int, prompt_len: int, *,
                              device, seed: int = 0):
    """The local demos' inputs: the arch's reduced config with fresh f32
    weights (the reference's ``init_params``; bf16 compute and caches
    follow, as its ``decode_step``) and random prompts (B, P[, C]), both
    from one seeded generator, which is returned for the sampling."""
    cfg = registry.reduced(registry.get_model_config(arch))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = model_lib.init_params(cfg, generator=gen, device=device)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len, *cb),
                           generator=gen, device=device)
    return model, prompt, gen


def serve_local(arch: str, batch: int, prompt_len: int, gen_tokens: int,
                temperature: float, *, device="cuda", seed: int = 0,
                capture=None) -> StepwiseResult:
    """The reference's ``--local`` demo: :func:`generate_stepwise` on
    :func:`reduced_model_and_prompts`."""
    model, prompt, gen = reduced_model_and_prompts(
        arch, batch, prompt_len, device=device, seed=seed)
    res = generate_stepwise(model, prompt, gen_tokens,
                            temperature=temperature, generator=gen,
                            capture=capture)
    print(f"[serve] prefill {prompt_len} tok x {batch} seq: "
          f"{res.prefill_s:.2f}s", flush=True)
    print(f"[serve] decoded {gen_tokens} tok/seq in {res.decode_s:.2f}s "
          f"({gen_tokens * batch / res.decode_s:.1f} tok/s aggregate)",
          flush=True)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=sorted(registry.ARCHS),
                    help="served in full (prefill, then decode): "
                         "recurrentgemma-9b (the default), mamba2-1.3b; "
                         "served as prefill servers (--tokens 0), their "
                         "layers attending globally: qwen2-0.5b, "
                         "granite-moe-1b-a400m, musicgen-medium and the "
                         "other attention-only archs, which generate "
                         "through the continuous-batching engine "
                         "(repro_torch.serving.ServingEngine) or --local "
                         "(whose default is qwen2-0.5b)")
    ap.add_argument("--local", action="store_true",
                    help="the reference's single-device demo: the reduced "
                         "config, the prompt token by token through the "
                         "decode step, then sampled decode steps")
    ap.add_argument("--batch", type=int, default=None,
                    help="prompts in the batch (default 4; 2 with --local; "
                         "mamba2-1.3b is served at 8 on the card)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="tokens a prompt (default 4096, on the card for "
                         "both; 16 with --local)")
    ap.add_argument("--tokens", type=int, default=None,
                    help="new tokens a prompt, one decode step each "
                         "(default 32; 16 with --local)")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced CPU-test variant")
    args = ap.parse_args(argv)
    # the reference's --local defaults, or the full-width serve's
    defaults = (("qwen2-0.5b", 2, 16, 16) if args.local
                else ("recurrentgemma-9b", 4, 4096, 32))
    arch, batch, prompt_len, tokens = (
        d if v is None else v for v, d in zip(
            (args.arch, args.batch, args.prompt_len, args.tokens), defaults))
    if args.local:
        serve_local(arch, batch, prompt_len, tokens, args.temperature,
                    device=args.device, seed=args.seed)
        return
    res = serve(arch, batch=batch, prompt_len=prompt_len,
                gen_tokens=tokens, temperature=args.temperature,
                device=args.device, seed=args.seed, reduced=args.reduced)
    print(f"[serve] tokens[0]: {res.tokens[0].tolist()}")


if __name__ == "__main__":
    main()
