"""PyTorch / CUDA port of the ElasticMoE serving system, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
``torch``, numpy and the standard library only.  The ported slices serve
MoE decoders on one card through ``core.elastic_engine.ElasticServer``: a
standard-attention model (qwen3-30b-a3b at full width) with the paged KV
pool, pooled expert pages and chunked prefill, their int8 stores, and the
reference's default stores (dense KV slots, dense expert banks, monolithic
prefill); and an MLA model (deepseek-v2-lite-16b) over its latent cache
with either expert store.  Ten hand-written CUDA kernels carry them
(``kernels/``, sources in ``csrc/``).  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
