"""Carrying the JAX package's arrays across as numpy.

The reference draws its data, x₀, noise, per-round mixing matrices and
participation masks from JAX keys, which PyTorch's generators cannot
reproduce; parity runs therefore start both sides from the reference's
arrays and replay its per-round draws.  This module takes numpy only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.kgt_minimax import KGTState
from repro_torch.core.sparse_topology import SparseTopology
from repro_torch.engine.sampler import with_topology


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



def sparse_from_reference(neighbor_idx, neighbor_w, self_w, degree, *,
                          device="cuda") -> SparseTopology:
    """The four arrays of a reference ``SparseTopology`` (numpy) -> the
    port's, on ``device``."""
    return SparseTopology(
        neighbor_idx=to_tensor(neighbor_idx, device).to(torch.int32),
        neighbor_w=to_tensor(neighbor_w, device).to(torch.float32),
        self_w=to_tensor(self_w, device).to(torch.float32),
        degree=to_tensor(degree, device).to(torch.int32))


def make_replay_sampler(sampler, *, ws: Optional[Sequence[Any]] = None,
                        masks: Optional[Sequence[Any]] = None,
                        device="cuda"):
    """``sampler`` with the reference's per-round draws as its extras
    (``engine.sampler.with_topology``): round r gets ``ws[r]`` — a dense
    (n, n) array, or the ``(neighbor_idx, neighbor_w, self_w, degree)``
    arrays of a sparse W — and ``masks[r]``, an (n,) array."""
    def convert_w(w):
        if isinstance(w, (tuple, list)):
            return sparse_from_reference(*w, device=device)
        return to_tensor(w, device).to(torch.float32)

    w_seq = None if ws is None else [convert_w(w) for w in ws]
    m_seq = (None if masks is None
             else [to_tensor(m, device).to(torch.bool) for m in masks])
    return with_topology(
        sampler,
        w_fn=None if w_seq is None else (lambda r: w_seq[r]),
        mask_fn=None if m_seq is None else (lambda r: m_seq[r]))
