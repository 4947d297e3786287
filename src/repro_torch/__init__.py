"""PyTorch/CUDA port of the K-GT-Minimax system (``repro``).

The JAX package ``repro`` is the reference; this package re-implements its
main path — Algorithm 1 on the synthetic NC-SC quadratic — in PyTorch, with
churn (per-round W, partial participation) and the sparse neighbor-list path
past 512 clients, and hand-written CUDA kernels for the three round kernels
(``repro_torch.kernels``).
It imports ``torch`` and never ``jax`` or ``repro``.

Entry points run on the card unless the caller passes ``device="cpu"``; on
CPU tensors the kernels' plain PyTorch versions run instead.
"""
