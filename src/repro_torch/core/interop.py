"""Carrying the JAX package's quadratic data and state across as numpy.

The reference draws its data, x₀ and noise from JAX keys, which PyTorch's
generators cannot reproduce; parity runs therefore start both sides from
the reference's arrays.  This module takes numpy only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.kgt_minimax import KGTState


def to_tensor(a, device) -> torch.Tensor:
    """numpy array (bfloat16 included) -> tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.tensor(a).to(device)


def from_reference(data_np: Optional[Dict[str, Any]],
                   state_np: Optional[Dict[str, Any]] = None, *,
                   device="cuda") -> Tuple[Optional[dict], Optional[KGTState]]:
    """(quadratic data dict, KGTState leaves) as numpy -> the port's.

    ``data_np``: {"A", "B", "b", "q", "mu"} as returned by the reference's
    ``make_quadratic_data`` (converted with ``np.asarray``).  ``state_np``:
    {"x", "y", "cx", "cy"[, "round"]}, each a numpy array or a dict/list of
    them.  Either may be None.
    """
    data = None
    if data_np is not None:
        data = {k: to_tensor(v, device) for k, v in data_np.items()
                if k != "mu"}
        data["mu"] = float(np.asarray(data_np["mu"]))
    state = None
    if state_np is not None:
        def conv(t):
            return tree_lib.tree_map(lambda a: to_tensor(a, device), t)

        state = KGTState(x=conv(state_np["x"]), y=conv(state_np["y"]),
                         cx=conv(state_np["cx"]), cy=conv(state_np["cy"]),
                         round=int(np.asarray(state_np.get("round", 0))))
    return data, state

