"""Evaluation entry point: per-group and worst-group loss of one model on
each client's data (the body of ``repro.evaluation.metrics.evaluate_clients``
for one set of weights, without the client-stacked state of training).

The model gets fresh bf16 weights from a seeded ``torch.Generator``; the data
model is ``data.synthetic.make_data_model`` (G groups, one Dirichlet(alpha)
mixture a client); each client draws one batch and ``group_metrics`` runs on
it with autograd off — through the SSD scan (B7) in every Mamba2 layer, the
flash attention (B5) in every attention layer and the fused cross-entropy
(B6, once a codebook of an audio model) on the card.  As in the
reference's ``evaluate_clients``, the batches carry no prefix embeddings.

  PYTHONPATH=src python -m repro_torch.launch.evaluate --arch mamba2-1.3b
  PYTHONPATH=src python -m repro_torch.launch.evaluate --arch mamba2-1.3b \\
      --device cpu --reduced --seq-len 64
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import torch

from repro_torch.configs import registry
from repro_torch.data import synthetic as data_lib
from repro_torch.evaluation.metrics import group_metrics
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib


@dataclasses.dataclass
class EvalResult:
    model: model_lib.Model
    data: data_lib.DataModel
    batches: List[Dict[str, torch.Tensor]]     # one a client
    metrics: List[Dict[str, torch.Tensor]]     # group_metrics, one a client
    seconds: List[float]                       # host clock a client batch
    launches: List[Dict[str, int]]             # kernel launches a client


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(arch: str, *, clients: int = 4, batch: int = 4,
             seq_len: int = 4096, num_groups: int = 8, alpha: float = 0.3,
             device="cuda", seed: int = 0, reduced: bool = False,
             verbose: bool = True) -> EvalResult:
    """``group_metrics`` of a model of ``arch`` (its reduced CPU-test variant
    if ``reduced``) with fresh bf16 weights, computing in bf16, on one batch
    of ``batch`` × ``seq_len`` tokens of each of ``clients`` clients."""
    cfg = registry.get_model_config(arch)
    if reduced:
        cfg = registry.reduced(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = model_lib.init_params(cfg, generator=gen, device=device,
                                  dtype=torch.bfloat16)
    dm = data_lib.make_data_model(vocab_size=cfg.vocab_size,
                                  num_groups=num_groups, num_clients=clients,
                                  alpha=alpha, seed=seed, device=device)
    res = EvalResult(model=model, data=dm, batches=[], metrics=[], seconds=[],
                     launches=[])
    for i in range(clients):
        b = data_lib.sample_client_batch(dm, gen, i, batch, seq_len,
                                         cfg.num_codebooks)
        start = ops.launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        m = group_metrics(model, b, num_groups=num_groups)
        _sync(device)
        res.seconds.append(time.perf_counter() - t0)
        end = ops.launch_counts()
        res.launches.append({k: end[k] - start[k] for k in end})
        res.batches.append(b)
        res.metrics.append(m)
        if verbose:
            print(f"[evaluate] {cfg.name} client {i}: mean loss "
                  f"{float(m['mean_loss']):.4f}, worst group "
                  f"{int(m['worst_group'])} at "
                  f"{float(m['worst_group_loss']):.4f} "
                  f"({int(m['groups_present'])} groups), "
                  f"{batch * seq_len / res.seconds[-1]:.0f} tok/s",
                  flush=True)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-1.3b",
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced CPU-test variant")
    args = ap.parse_args(argv)
    res = evaluate(args.arch, clients=args.clients, batch=args.batch,
                   seq_len=args.seq_len, num_groups=args.groups,
                   alpha=args.alpha, device=args.device, seed=args.seed,
                   reduced=args.reduced)
    means = torch.stack([m["mean_loss"] for m in res.metrics])
    print(f"[evaluate] client mean loss {float(means.mean()):.4f}, worst "
          f"client {int(means.argmax())} at {float(means.max()):.4f}")


if __name__ == "__main__":
    main()
