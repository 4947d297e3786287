"""Shares the CPU's cores among pytest-xdist's workers.

Each torch process starts one OpenMP thread a core, and under ``-n 6``
the workers' threads spin against each other: a port test made of many
small ops then runs 50 times slower than alone.  Importing this module
gives each worker its share of the cores (at least one thread); a run
without xdist keeps torch's default.  Every port test file imports it,
and since each xdist worker collects every file, it holds for the whole
worker process.
"""
import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // workers))


share_cores()
