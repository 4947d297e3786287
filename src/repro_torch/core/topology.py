"""Communication topologies and their mixing matrices (Assumption 4).

All matrices are symmetric, doubly stochastic, nonnegative.  ``spectral_gap``
returns the paper's ``p``: the largest p with ||XW - X̄||_F² <= (1-p)||X - X̄||_F²,
i.e. p = 1 - rho(W - J)² where rho is the spectral radius.
"""
from __future__ import annotations

import numpy as np


def ring(n: int) -> np.ndarray:
    """Each node: 1/3 self, 1/3 each neighbor (n=1,2 degenerate but valid)."""
    if n == 1:
        return np.ones((1, 1))
    if n == 2:
        return np.full((2, 2), 0.5)
    w = np.zeros((n, n))
    for i in range(n):
        w[i, i] = 1 / 3
        w[i, (i + 1) % n] = 1 / 3
        w[i, (i - 1) % n] = 1 / 3
    return w


def torus(n: int) -> np.ndarray:
    """2D wrap-around grid (n must be a perfect square); 1/5 self + neighbors."""
    s = int(round(np.sqrt(n)))
    if s * s != n:
        raise ValueError(f"torus needs a square n, got {n}")
    if s <= 2:
        return ring(n)
    w = np.zeros((n, n))
    for r in range(s):
        for c in range(s):
            i = r * s + c
            for dr, dc in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % s) * s + (c + dc) % s
                w[i, j] += 1 / 5
    return w


def fully_connected(n: int) -> np.ndarray:
    return np.full((n, n), 1.0 / n)


def exponential(n: int) -> np.ndarray:
    """Exponential graph: node i connects to i +- 2^k; Metropolis weights."""
    adj = np.zeros((n, n), bool)
    k = 1
    while k < n:
        for i in range(n):
            adj[i, (i + k) % n] = adj[i, (i - k) % n] = True
        k *= 2
    np.fill_diagonal(adj, False)
    return metropolis(adj)


def star(n: int) -> np.ndarray:
    adj = np.zeros((n, n), bool)
    adj[0, 1:] = adj[1:, 0] = True
    return metropolis(adj)


def metropolis(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    deg = adj.sum(1)
    w = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if adj[i, j]:
                w[i, j] = 1.0 / (1 + max(deg[i], deg[j]))
        w[i, i] = 1.0 - w[i].sum()
    return w


TOPOLOGIES = {
    "ring": ring,
    "torus": torus,
    "full": fully_connected,
    "exp": exponential,
    "star": star,
}


def mixing_matrix(topology: str, n: int) -> np.ndarray:
    try:
        w = TOPOLOGIES[topology](n)
    except KeyError:
        raise KeyError(f"unknown topology {topology!r}: {sorted(TOPOLOGIES)}") from None
    assert np.allclose(w, w.T) and np.allclose(w.sum(1), 1.0) and (w >= -1e-12).all()
    return w


def spectral_gap(w: np.ndarray) -> float:
    """p in Assumption 4: 1 - max_{i>=2} |lambda_i(W)|^2."""
    eig = np.sort(np.abs(np.linalg.eigvalsh(w)))[::-1]
    rho = eig[1] if len(eig) > 1 else 0.0
    return float(1.0 - rho**2)
