"""Quickstart: K-GT-Minimax on a synthetic heterogeneous NC-SC problem.

The port's twin of ``examples/quickstart.py``: build a problem, a topology
and the algorithm state, run rounds through the chunked engine, and watch
‖∇Φ(x̄)‖ fall while plain local SGDA stalls.

  PYTHONPATH=src python -m repro_torch.launch.quickstart \
      [--mixing-impl dense|ring|fused_dense|fused_ring|pallas_packed|
                     sparse_packed|fused_round]
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import engine as engine_lib
from repro_torch.configs import AlgorithmConfig
from repro_torch.core import (
    MIXING_IMPLS,
    init_state,
    make_quadratic_data,
    make_round_step,
    quadratic_problem,
)

N_CLIENTS, K = 8, 8
ROUNDS, LOG_EVERY = 300, 60


def run(algorithm: str, *, mixing_impl: str = "dense", device="cuda",
        n_clients: int = N_CLIENTS, local_steps: int = K, dx: int = 10,
        dy: int = 5, sigma: float = 0.1, rounds: int = ROUNDS,
        log_every: int = LOG_EVERY, seed: int = 0, verbose: bool = True):
    """One quickstart trajectory; returns ``(state, history)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    data = make_quadratic_data(gen, n_clients, dx=dx, dy=dy,
                               heterogeneity=2.0)
    problem = quadratic_problem(data, sigma=sigma)
    cfg = AlgorithmConfig(
        algorithm=algorithm, num_clients=n_clients, local_steps=local_steps,
        eta_cx=0.01, eta_cy=0.1,
        eta_sx=0.5 if algorithm == "kgt_minimax" else 1.0,
        eta_sy=0.5 if algorithm == "kgt_minimax" else 1.0,
        topology="ring", mixing_impl=mixing_impl)
    client_batch = {k: v for k, v in data.items() if k != "mu"}
    batches = {k: v.unsqueeze(0).expand(local_steps, *v.shape)
               for k, v in client_batch.items()}
    state = init_state(problem, cfg, gen, init_batch=client_batch)
    sampler = engine_lib.make_fixed_batch_sampler(
        batches, local_steps=local_steps, num_clients=n_clients,
        noise_dim=problem.noise_dim, seed=seed, device=device)
    build = engine_lib.make_chunk_builder(
        make_round_step(problem, cfg, device=device), sampler,
        engine_lib.quadratic_metrics_fn(problem), log_every=log_every)

    def show(state, records, prev_round):
        for r in records:
            print(f"round {r['round']:4d}  ||grad Phi(x̄)|| = "
                  f"{r['phi_grad_norm']:.4f}   consensus Ξx = "
                  f"{r['consensus_x']:.2e}")

    if verbose:
        print(f"\n=== {algorithm} (n={n_clients}, K={local_steps}, ring, "
              f"{mixing_impl}, {device}) ===")
    return engine_lib.run(state, build, total_rounds=rounds,
                          chunk_rounds=log_every,
                          hooks=[show] if verbose else [])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mixing-impl", default="dense", choices=MIXING_IMPLS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, h_kgt = run("kgt_minimax", mixing_impl=args.mixing_impl,
                   device=args.device)
    _, h_local = run("local_sgda", mixing_impl=args.mixing_impl,
                     device=args.device)
    g_kgt = h_kgt[-1]["phi_grad_norm"]
    g_local = h_local[-1]["phi_grad_norm"]
    print(f"\nK-GT-Minimax reaches ||grad|| = {g_kgt:.4f}; "
          f"local SGDA (no tracking) stalls at {g_local:.4f} "
          f"under the same heterogeneity.")


if __name__ == "__main__":
    main()
