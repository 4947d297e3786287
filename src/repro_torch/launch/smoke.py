"""Smoke run of the decentralized training mesh on a CPU world (port of
the train legs of ``repro.launch.smoke``).

For each reduced architecture, on a gloo world of 2 ranks (the clients
axis of a ``(clients=2, 1, 1)`` mesh, one client a rank), runs one
decentralized K-GT-Minimax round through ``launch.train`` on ``dense`` and
on ``pallas_packed``, and prints ``train round ran`` and ``packed-gossip
train round ran``.  Exit code 0 iff every leg ran.  The serving leg and
the sweep-cell leg wait for the next slice of the mesh (ROADMAP A13).

  PYTHONPATH=src python -m repro_torch.launch.smoke [--archs qwen2-0.5b ...]
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
import traceback

from repro_torch.configs import registry

WORLD = 2
LEGS = (("dense", "train round"), ("pallas_packed", "packed-gossip train "
                                   "round"))


def _leg(arch: str, impl: str) -> None:
    from repro_torch.launch import train as train_lib

    args = train_lib.parser().parse_args([
        "--arch", arch, "--reduced", "--device", "cpu",
        "--mesh", "decentralized", "--clients", str(WORLD),
        "--local-steps", "2", "--batch", "2", "--seq-len", "64",
        "--groups", "4", "--rounds", "1", "--log-every", "1",
        "--engine", "host", "--mixing-impl", impl])
    rec = train_lib.train(args)["history"][-1]
    if not all(float(rec[k]) == float(rec[k]) for k in ("f_bar",
                                                         "mean_loss")):
        raise FloatingPointError(f"non-finite row {rec}")


def _legs(rank: int, world: int, archs) -> list:
    """Every leg on this rank; rank 0 prints each line."""
    results = []
    for arch in archs:
        for impl, what in LEGS:
            t0 = time.perf_counter()
            try:
                _leg(arch, impl)
                ok, line = True, f"{what} ran ({time.perf_counter() - t0:.1f}s)"
            except Exception as e:  # a leg's failure is reported, not fatal
                ok, line = False, (f"{what} FAILED: {type(e).__name__}: {e}"
                                   f"\n{traceback.format_exc()}")
            if rank == 0:
                print(f"[smoke] {arch}: {line}", flush=True)
            results.append(ok)
    return results


def main(argv=None) -> int:
    from repro_torch.dist import launch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="*", default=["qwen2-0.5b"],
                    choices=sorted(registry.ARCHS))
    args = ap.parse_args(argv)
    print(f"[smoke] a gloo world of {WORLD} ranks on the CPU", flush=True)
    with tempfile.TemporaryDirectory() as store:
        results = launch.run_world(WORLD, _legs, args.archs,
                                   backend="gloo", store_dir=store)
    return 0 if all(all(r) for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
