"""Builds the CUDA sources under ``csrc/`` with nvcc and loads them.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so`` at
the repository root, with a plain C interface loaded through ``ctypes``.
The hash covers the source, every header in ``csrc/`` and the flags, so an
edit rebuilds; a built library is reused.  Nothing is built at import time:
the first call of a wrapper on a CUDA tensor builds what it needs, and
``build_all`` builds every source at once (one nvcc per source, in
parallel).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gossip", "fused_round", "neighbor_gossip", "flash_attention",
           "rglru_scan", "ssd_scan", "cross_entropy")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# each library's C entry points and their argument types (all return
# cudaError_t)
SIGNATURES = {
    "gossip": {
        # w, Δ, θ, c, θ', c'; n, n_out, row0, D, η_s, s, bf16
        "fused_gossip_launch": [_P] * 6 + [_I, _I, _I, _L, _F, _F, _I, _P],
        # w, then (Δ, θ, c, θ', c', D, η_s, s) for x and for y; n, n_out,
        # row0, bf16
        "fused_gossip_pair_launch": ([_P] + ([_P] * 5 + [_L, _F, _F]) * 2
                                     + [_I] * 4 + [_P]),
    },
    "fused_round": {"fused_round_launch": [_P] * 14 + [_I] * 6 + [_P]},
    "neighbor_gossip": {
        # the three tables, Δ, θ, c, θ', c'; n, n_src, m, D, η_s, s, bf16
        "sparse_gossip_launch": [_P] * 8 + [_I, _I, _I, _L, _F, _F, _I, _P],
        # the three tables, then (Δ, θ, c, θ', c', D, η_s, s) for x and y;
        # n, n_src, m, bf16
        "sparse_gossip_pair_launch": ([_P] * 3 + ([_P] * 5 + [_L, _F, _F]) * 2
                                      + [_I] * 4 + [_P]),
    },
    "flash_attention": {
        "flash_attention_launch": [_P] * 4 + [_I] * 10 + [_P]},
    "rglru_scan": {
        "rglru_scan_launch": [_P] * 3 + [_I] * 3 + [_P],
        # a, u, h, the workspace; B, S, W
        "rglru_chunked_launch": [_P] * 4 + [_I] * 3 + [_P],
        # a, h, dh, da, du, the workspace; B, S, W
        "rglru_scan_bwd_launch": [_P] * 6 + [_I] * 3 + [_P]},
    "ssd_scan": {
        "ssd_scan_launch": [_P] * 10 + [_I] * 9 + [_L] * 10 + [_P]},
    "cross_entropy": {
        "fused_ce_launch": [_P] * 4 + [_I] * 3 + [_L] * 3 + [_I, _I, _P],
        # hidden, weight, labels, z, m, l; N, V, D; the strides; dtype,
        # route
        "fused_ce_partials_launch": ([_P] * 6 + [_I] * 3 + [_L] * 3
                                     + [_I, _I, _P])},
}

_libs: Dict[str, ctypes.CDLL] = {}
# nvcc seconds spent in this process, and each build's ptxas report
stats = {"build_s": 0.0, "log": {}}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library of ``names``, all nvcc runs at once.
    Processes that build at once (the ranks of a world) take turns on a
    file lock in the build directory, and each looks again for what the
    one before it built, so no target is compiled twice."""
    targets = {name: _target(name) for name in names}
    if all(t.exists() for t in targets.values()):
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            _compile({name: t for name, t in targets.items()
                      if not t.exists()})
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return targets


def _compile(todo: Dict[str, Path]) -> None:
    if not todo:
        return
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        stats["log"][name] = out.decode()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{out.decode()}")
        else:
            os.replace(tmp, todo[name])
    stats["build_s"] += time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def forced_route(chosen: str, forced, universal: str = "cuda_core") -> str:
    """The route a call takes: ``chosen`` (the wrapper's rule) unless
    ``forced``; the ``universal`` route (the first port's kernel: the
    CUDA-core route, B2's block-per-client route or B8's walk) takes every
    operand, the other route only those the rule gives it."""
    if forced is None or forced == chosen or forced == universal:
        return forced or chosen
    raise ValueError(f"route {forced!r} cannot take these operands; the "
                     f"route rule gives {chosen!r}")


def check_operand(name, x, shape, dtype=torch.float32):
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
