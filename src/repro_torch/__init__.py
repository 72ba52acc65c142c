"""PyTorch / CUDA port of the ElasticMoE serving system, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
``torch``, numpy and the standard library only.  The ported slice serves a
standard-attention MoE decoder (qwen3-30b-a3b at full width) on one card
through ``core.elastic_engine.ElasticServer`` with the paged KV pool, the
pooled expert pages and chunked prefill, on three hand-written CUDA
kernels (``kernels/``, sources in ``csrc/``).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
