"""End-to-end driver: decentralized DRO training of a real transformer LM
with K-GT-Minimax over heterogeneous clients (the port's twin of
``examples/robust_lm.py``).

Default is a CPU-sized model (~9M params, ``SMALL``) for a few hundred
rounds; ``--full`` takes the ~100M paper-toy config.  The run is
``repro_torch.launch.train`` with the reference's settings: kgt_minimax on
a ring, batch 4 × 128 tokens a client, 8 groups, the wsd schedule with 10
warm-up rounds, captured chunks of 10 rounds, a checkpoint every 100
rounds.  It runs on the card unless given ``--device cpu``; the history
goes to ``--out``.

  PYTHONPATH=src python -m repro_torch.launch.robust_lm --rounds 200
  PYTHONPATH=src python -m repro_torch.launch.robust_lm --device cpu \\
      --clients 2 --local-steps 1 --rounds 2
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as train_lib

SMALL = ModelConfig(
    name="robust-lm-9m", arch_type="dense", num_layers=4, d_model=256,
    num_heads=4, num_kv_heads=2, d_ff=1024, vocab_size=4096,
    tie_embeddings=True, source="this repo (CPU-sized demo)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="use the ~100M paper-toy config")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.2,
                    help="Dirichlet heterogeneity (smaller = more "
                         "heterogeneous)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default="checkpoints/robust_lm")
    ap.add_argument("--out", default="results/robust_lm_torch.json")
    return ap


def train_args(args_in) -> argparse.Namespace:
    """``launch.train``'s flags with the reference's settings."""
    ns = train_lib.parser().parse_args([])
    for key, value in dict(
            arch="paper-toy" if args_in.full else SMALL.name,
            reduced=False, device=args_in.device, algorithm="kgt_minimax",
            rounds=args_in.rounds, clients=args_in.clients,
            local_steps=args_in.local_steps, batch=4, seq_len=128, groups=8,
            mu=1.0, alpha=args_in.alpha, eta_cx=0.02, eta_cy=0.15,
            eta_s=0.5, topology="ring", mixing_impl="dense",
            gossip_dtype="float32", schedule="wsd", warmup=10, seed=0,
            log_every=10, checkpoint_every=100,
            checkpoint_dir=args_in.checkpoint_dir,
            # chunked execution: one captured chunk per 10 rounds,
            # checkpoints land on chunk boundaries
            engine="scan", chunk=10, mesh="host",
            out=args_in.out).items():
        setattr(ns, key, value)
    return ns


def main(argv=None) -> dict:
    args_in = parser().parse_args(argv)
    if not args_in.full:
        registry.ARCHS[SMALL.name] = SMALL  # register the demo config
    ns = train_args(args_in)
    result = train_lib.train(ns)
    os.makedirs(os.path.dirname(ns.out) or ".", exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump({k: result[k] for k in ("history", "final_consensus")},
                  f, indent=1)
    print(f"[robust_lm] wrote {ns.out}")
    return result


if __name__ == "__main__":
    main()
