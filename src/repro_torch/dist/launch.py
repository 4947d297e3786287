"""Starting a ``torch.distributed`` world: ``run_world`` starts one, and
``init_from_env`` joins the one ``torchrun`` starts.

``run_world(world, fn, *args, backend=, store_dir=)`` starts ``world``
processes, joins them through a ``FileStore`` in a fresh
directory under ``store_dir`` (a file, so no TCP port can collide between
worlds that run at once), calls ``fn(rank, world, *args)`` in each, and
returns each rank's result in rank order.  A rank that raises fails the
call: its exception is raised in the caller, with its traceback, and the
other ranks are stopped.  ``fn`` and its arguments are pickled, so ``fn``
is a module-level function; a result travels back through a file in the
store directory.  On ``device="cuda"`` rank r runs on
``cuda:(r mod device_count)``; the caller frees its CUDA memory pool first
(``gc.collect()``, ``torch.cuda.empty_cache()``), since each rank holds a
context of its own beside the caller's.

The ranks fork from ``multiprocessing``'s fork server, which
:func:`start_forkserver` starts once a process with torch and the port's
modules imported (``FORKSERVER_PRELOAD``): a spawned rank spends seconds
importing them, most of a world's start on the card; a forked one none.
A process that has used CUDA cannot fork a child that uses it, but the
server never touches CUDA, so a rank initializes it afresh.  The ranks
see the environment the server was started with; it stops when the
process that started it exits.
"""
from __future__ import annotations

import atexit
import datetime
import multiprocessing
import os
import tempfile
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

# how long a rank waits for the others in a collective before it fails
TIMEOUT_S = 600

# what the fork server imports: torch, torch.func's first import
# (torch._dynamo) and the port's modules that the ranks run
FORKSERVER_PRELOAD = ("torch", "torch.distributed", "torch._dynamo",
                      "repro_torch.dist.launch", "repro_torch.launch.train",
                      "repro_torch.launch.steps", "repro_torch.launch.serve")


def start_forkserver() -> None:
    """Starts the fork server that ``run_world`` forks ranks from, with
    ``FORKSERVER_PRELOAD`` imported, unless it runs; stopped at exit.  It
    returns at once: the server imports them in the background (a caller
    may start it early, while it does other work), and a world started
    before it is done waits for it."""
    from multiprocessing import forkserver

    if forkserver._forkserver._forkserver_pid is None:
        multiprocessing.set_forkserver_preload(list(FORKSERVER_PRELOAD))
        atexit.register(stop_forkserver)
    forkserver.ensure_running()


def stop_forkserver() -> None:
    """Stops the fork server, if one runs, and waits for it to end."""
    from multiprocessing import forkserver

    # the module's own stop (it closes the server's "alive" pipe); the
    # server otherwise outlives the caller by as long as it takes to see
    # the pipe close
    forkserver._forkserver._stop()


def torchrun_env() -> Optional[Tuple[int, int, int]]:
    """(RANK, WORLD_SIZE, LOCAL_RANK) from torchrun's environment, or None
    outside torchrun."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    return (rank, int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", rank)))


def default_backend(device: str) -> str:
    """``nccl`` on the card, ``gloo`` on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device: str, world: int) -> None:
    """Refuses a backend the device cannot carry: NCCL off the card, and
    NCCL with more ranks than cards (two ranks on one device are refused
    by NCCL itself; gloo carries them)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; on the CPU "
                         "use --dist-backend gloo")
    cards = torch.cuda.device_count()
    if world > cards:
        raise ValueError(
            f"the nccl backend needs one card a rank: {world} ranks, "
            f"{cards} card(s); run two ranks on one card over gloo "
            "(--dist-backend gloo)")


def set_rank_device(device: str, local_rank: int) -> str:
    """Puts the rank on ``cuda:(local_rank mod device_count)`` for a CUDA
    ``device``; returns the device string the rank runs on."""
    if torch.device(device).type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but this process "
                           "sees no CUDA device")
    index = local_rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return f"cuda:{index}"


def init_from_env(backend: str, device: str) -> str:
    """Joins torchrun's world (``env://``) with ``backend``, or, outside
    torchrun, starts a world of one rank; returns the rank's device."""
    env = torchrun_env()
    rank, world, local = env if env is not None else (0, 1, 0)
    check_backend(backend, device, world)
    dev = set_rank_device(device, local)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if env is not None:
        dist.init_process_group(backend, rank=rank, world_size=world,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    return dev


def _entry(rank: int, world: int, backend: str, store: str, device: str,
           threads: Optional[int], fn: Callable, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = set_rank_device(device, rank)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(store, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = fn(rank, world, *args)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        torch.save(result, os.path.join(store, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(world: int, fn: Callable, *args, backend: str = "gloo",
              store_dir: str, device: str = "cpu",
              threads: Optional[int] = None) -> List[Any]:
    """``fn(rank, world, *args)`` on each rank of a world of ``world``
    processes forked from the fork server; returns the results in rank
    order (module docstring).  ``threads``: each rank's torch threads
    (default: this process's share, its threads over ``world``)."""
    check_backend(backend, device, world)
    start_forkserver()
    os.makedirs(store_dir, exist_ok=True)
    store = tempfile.mkdtemp(prefix="world-", dir=store_dir)
    if threads is None:
        threads = max(1, torch.get_num_threads() // world)
    torch.multiprocessing.start_processes(
        _entry, args=(world, backend, store, device, threads, fn, args),
        nprocs=world, join=True, start_method="forkserver")
    return [torch.load(os.path.join(store, f"result_{r}.pt"),
                       weights_only=False) for r in range(world)]
