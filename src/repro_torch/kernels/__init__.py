"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` is the entry point; ``paged_attention`` and ``moe_gmm`` hold the
CUDA launch wrappers, ``ref`` the plain PyTorch versions, ``_build`` the
``nvcc`` build and ctypes binding of ``csrc/``.
"""
