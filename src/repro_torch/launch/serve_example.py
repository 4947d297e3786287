"""Serving demo (the port's twin of ``examples/serve.py``): a batch of
random prompts prefilled token by token through the decode step (for
exactness across cache kinds: window caches, SSM state, …), then sampled
autoregressive decode steps, on the arch's reduced config.  The decode
step is ``serving.decode.DecodeStep``, a CUDA graph on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve_example \\
      --arch mamba2-1.3b --tokens 24
  PYTHONPATH=src python -m repro_torch.launch.serve_example --device cpu

``launch.serve.generate_stepwise``, the loop it runs, returns every
step's logits and the sampled tokens, and takes a prompt and a noise
source (``noise(shape) -> tensor``, one call a sample), so a caller can
feed it the reference's prompt and draws.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import registry
from repro_torch.launch import serve as serve_lib


def main(argv=None) -> serve_lib.StepwiseResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    model, prompt, gen = serve_lib.reduced_model_and_prompts(
        args.arch, args.batch, args.prompt_len, device=args.device,
        seed=args.seed)
    res = serve_lib.generate_stepwise(model, prompt, args.tokens,
                                      temperature=args.temperature,
                                      generator=gen)
    print(f"[serve] {model.cfg.name}: prefill {args.prompt_len} tokens "
          f"in {res.prefill_s:.2f}s")
    print(f"[serve] decoded {args.tokens} tokens/seq in {res.decode_s:.2f}s "
          f"({args.tokens * args.batch / res.decode_s:.1f} tok/s); sample "
          f"row: {res.tokens[0].reshape(-1)[:16].tolist()}")
    return res


if __name__ == "__main__":
    main()
