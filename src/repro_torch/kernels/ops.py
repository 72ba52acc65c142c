"""Public kernel entry points: dispatch by the tensor's device.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback
and no environment switch.  The one explicit way to run the plain versions
on the card is the ``use_reference()`` context manager, which the tests and
``chip_smoke.py``'s comparison phase use.

Launch counts live on the kernel wrappers (``<wrapper>.launches``, one per
launch and nowhere else); ``launch_counts`` reads and
``reset_launch_counts`` zeroes them.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator

import torch

from repro_torch.kernels import moe_gmm, paged_attention, ref

_REFERENCE = contextvars.ContextVar("repro_torch_use_reference",
                                    default=False)

#: kernel name -> wrapper carrying its ``launches`` count
KERNELS = {
    "block_paged_decode_attention":
        paged_attention.block_paged_decode_attention,
    "mixed_block_paged_attention":
        paged_attention.mixed_block_paged_attention,
    "paged_gmm": moe_gmm.paged_gmm,
}


@contextlib.contextmanager
def use_reference() -> Iterator[None]:
    """Run the plain PyTorch versions on CUDA tensors inside the block."""
    token = _REFERENCE.set(True)
    try:
        yield
    finally:
        _REFERENCE.reset(token)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _plain(t: torch.Tensor) -> bool:
    """True where the plain version runs: CPU tensors, or CUDA tensors
    inside ``use_reference()``."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return _REFERENCE.get()
    raise ValueError(f"no kernel for device {t.device}")


def block_paged_decode_attention(q, k_pool, v_pool, block_tables, lengths):
    """Block-table paged decode attention (every decode tick, every
    layer); see ``paged_attention.block_paged_decode_attention``."""
    if _plain(q):
        return ref.block_paged_decode_attention_ref(q, k_pool, v_pool,
                                                    block_tables, lengths)
    return paged_attention.block_paged_decode_attention(
        q, k_pool, v_pool, block_tables, lengths)


def mixed_block_paged_attention(q, k_pool, v_pool, block_tables, ctx_lens,
                                q_lens):
    """Mixed chunked-prefill / decode attention (every prefill chunk,
    every layer); see ``paged_attention.mixed_block_paged_attention``."""
    if _plain(q):
        return ref.mixed_block_paged_attention_ref(q, k_pool, v_pool,
                                                   block_tables, ctx_lens,
                                                   q_lens)
    return paged_attention.mixed_block_paged_attention(
        q, k_pool, v_pool, block_tables, ctx_lens, q_lens)


def paged_gmm(table, pool, x):
    """out[e] = x[e] @ pool[table[e]]; see ``moe_gmm.paged_gmm``."""
    if _plain(x):
        return ref.paged_gmm_ref(table, pool, x)
    return moe_gmm.paged_gmm(table, pool, x)


def paged_expert_ffn(table_i, table_g, table_o, pool_i, pool_g, pool_o, x):
    """Paged SwiGLU expert FFN (the pooled-expert serving hot path): three
    ``paged_gmm`` launches on the card."""
    if _plain(x):
        return ref.paged_expert_ffn_ref(table_i, table_g, table_o,
                                        pool_i, pool_g, pool_o, x)
    return moe_gmm.paged_expert_ffn(table_i, table_g, table_o,
                                    pool_i, pool_g, pool_o, x)
