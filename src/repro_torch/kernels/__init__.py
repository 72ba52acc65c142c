"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` is the entry point; ``paged_attention``, ``moe_gmm``,
``flash_attention``, ``kv_write``, ``mla_decode`` and ``ssd_scan`` hold
the CUDA launch wrappers, ``ref`` the plain PyTorch versions, ``_build``
the ``nvcc`` build and ctypes binding of ``csrc/``.
"""
