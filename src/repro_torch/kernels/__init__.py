"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Importing this package builds nothing and needs no GPU: the CUDA sources
under ``csrc/`` are compiled by ``_build`` at the first call on a CUDA
tensor.
"""
