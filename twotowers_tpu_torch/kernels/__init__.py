"""Hand-written CUDA kernels for Hopper, built at first use (``build.py``).

Importing this package builds nothing and needs no ``nvcc``.
"""
