"""Adversarial-embedding minimax training (the paper's adversarial-training
application; the port's twin of ``examples/adversarial_training.py``): y
is a universal embedding perturbation ascended jointly while x descends,
run decentralized with K-GT-Minimax on the chunked engine
(``repro_torch.engine``): rounds run as chunks (one CUDA graph each on the
card) with the heterogeneous token data drawn per round by the DRO
sampler, and clean and adversarial losses streamed through the metrics
buffer (a custom ``metrics_fn``: the engine is metric-agnostic).  It runs
on the card unless given ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.adversarial_training \\
      --rounds 40
  PYTHONPATH=src python -m repro_torch.launch.adversarial_training \\
      --device cpu --clients 2 --rounds 2 --chunk 2
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import engine as engine_lib
from repro_torch.configs import AlgorithmConfig
from repro_torch.configs.registry import get_model_config, reduced
from repro_torch.core import adversarial_problem, init_state, make_round_step
from repro_torch.core import kgt_minimax as kgt
from repro_torch.data import make_data_model

# the generator streams of the seed (engine.stream_seed(SEED, stream)):
# the data model's, the initial state's, the sampler's and the held-out
# batch's — disjoint, so the held-out batch is no round's training data
SEED = 0
DATA_STREAM, INIT_STREAM, SAMPLER_STREAM, EVAL_STREAM = 0, 1, 2, 3


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    """Returns the engine's ``(state, history)``."""
    args = parser().parse_args(argv)
    dev = args.device
    cfg = reduced(get_model_config(args.arch))
    n, k = args.clients, args.local_steps
    problem = adversarial_problem(cfg, mu=10.0, scale=0.1)
    algo = AlgorithmConfig(num_clients=n, local_steps=k, eta_cx=0.02,
                           eta_cy=0.05, eta_sx=0.7, eta_sy=0.7,
                           topology="ring")

    def gen_of(stream: int) -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(engine_lib.stream_seed(SEED, stream))
        return g

    dm = make_data_model(vocab_size=cfg.vocab_size, num_groups=4,
                         num_clients=n, alpha=0.3,
                         seed=engine_lib.stream_seed(SEED, DATA_STREAM),
                         device=dev)
    sampler = engine_lib.make_dro_sampler(
        dm, engine_lib.stream_seed(SEED, SAMPLER_STREAM), local_steps=k,
        num_clients=n, per_client_batch=2, seq_len=64, cfg=cfg)
    batches0, _ = sampler(0)
    state = init_state(problem, algo, gen_of(INIT_STREAM),
                       init_batch={key: v[0] for key, v in batches0.items()})

    # held-out eval batch: clean vs adversarial loss of the consensus model
    eval_b = engine_lib.held_out_eval_batch(
        dm, gen_of(EVAL_STREAM), num_clients=n, per_client_batch=2,
        seq_len=64, cfg=cfg)

    @torch.no_grad()
    def metrics_fn(state, batches):
        xbar = kgt.mean_over_clients(state.x)
        ybar = state.y.mean(0)
        return {
            "clean_loss": problem.value(xbar, torch.zeros_like(ybar),
                                        eval_b, None),
            "adv_loss": problem.value(xbar, ybar, eval_b, None),
            "y_norm": torch.linalg.vector_norm(ybar),
        }

    build = engine_lib.make_chunk_builder(
        make_round_step(problem, algo, device=dev), sampler, metrics_fn,
        log_every=10)

    def show(state, records, prev_round):
        for r in records:
            print(f"round {r['round']:3d}  clean loss {r['clean_loss']:.4f}  "
                  f"adversarial loss {r['adv_loss']:.4f}  "
                  f"|y| {r['y_norm']:.4f}", flush=True)

    return engine_lib.run(state, build, total_rounds=args.rounds,
                          chunk_rounds=args.chunk, hooks=[show],
                          wall_clock=False)


if __name__ == "__main__":
    main()
