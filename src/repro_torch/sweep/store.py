"""Persistence for sweep results: ``results/sweeps_torch/<name>.json``
(port of ``repro.sweep.store``; the port never writes the reference's
``results/sweeps/``, whose ``churn.json`` and ``adversary.json`` are
committed).

Merge, don't clobber: a partial rerun
(one cell in CI, a few added seeds) updates its own points and leaves the
rest of the file intact.  Every save restamps ``provenance`` — grid
description + config hash, capture vs run seconds, torch/device info, git
commit, timestamp — so a stored figure is reproducible from the file alone.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
from typing import Any, Optional

from repro_torch.sweep import grid as grid_lib


def repo_root() -> str:
    """The checkout root (this file lives at
    src/repro_torch/sweep/store.py)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def default_dir() -> str:
    return os.path.join(repo_root(), "results", "sweeps_torch")


def git_commit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=repo_root(),
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def device_info(device: Optional[str] = None) -> str:
    """``gpu:<card name>`` for a CUDA device, else ``cpu``."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(torch.device(device))}"
    return "cpu"


def provenance(spec: Optional[grid_lib.GridSpec] = None, *,
               device: Optional[str] = None) -> dict:
    import torch

    from repro_torch import obs

    out = {
        "timestamp": datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="seconds"),
        "torch": torch.__version__,
        "device": device_info(device),
        "git_commit": git_commit(),
        "telemetry_version": obs.TELEMETRY_VERSION,
        "ledger_version": obs.LEDGER_VERSION,
    }
    if spec is not None:
        gj = spec.to_json()
        out["grid"] = gj
        out["config_hash"] = grid_lib.config_hash(gj)
    return out


def _jsonable(obj: Any):
    """numpy scalars/arrays -> plain python, recursively."""
    import numpy as np

    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _jsonable(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def save(name: str, result: dict, spec: Optional[grid_lib.GridSpec] = None,
         directory: Optional[str] = None,
         device: Optional[str] = None) -> str:
    """Merge ``result`` (``{"points": ..., "cells": ...}``) into the named
    store file and return its path; the restamped ``provenance`` names
    ``device``, where the sweep ran."""
    directory = directory or default_dir()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.json")
    merged: dict = {"name": name, "points": {}, "cells": {}}
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
            if isinstance(prev, dict):
                merged["points"] = prev.get("points", {})
                merged["cells"] = prev.get("cells", {})
        except (OSError, ValueError):
            pass
    merged["points"].update(_jsonable(result.get("points", {})))
    merged["cells"].update(_jsonable(result.get("cells", {})))
    merged["provenance"] = _jsonable(provenance(spec, device=device))
    with open(path, "w") as f:
        json.dump(merged, f, indent=1, default=str)
    return path


def load(name: str, directory: Optional[str] = None) -> Optional[dict]:
    path = os.path.join(directory or default_dir(), f"{name}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
