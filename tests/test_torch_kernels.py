"""The port's plain kernel versions (``repro_torch.kernels.ref``) against
the reference's Pallas kernels run in interpret mode, on the same numpy
inputs: paged decode attention, mixed chunked-prefill attention, the paged
grouped matmul and the paged expert FFN.

Tolerance: f32 inputs, atol = rtol = 1e-5 — both sides accumulate in f32
but in different orders (an online softmax over blocks against one softmax
over the gathered context; XLA against PyTorch matmuls), a few ulps apart.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm import paged_expert_ffn as jax_paged_expert_ffn
from repro.kernels.moe_gmm import paged_gmm as jax_paged_gmm
from repro.kernels.paged_attention import \
    block_paged_decode_attention as jax_block_decode
from repro.kernels.paged_attention import \
    mixed_block_paged_attention as jax_mixed
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool_and_tables(rng, B, NB, bs, KVH, hd, lengths, MB):
    """Random pools and per-sequence tables of distinct, non-contiguous
    pool rows; table padding past each sequence's blocks holds the NB
    sentinel."""
    k = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    rows = rng.permutation(NB)
    bt = np.full((B, MB), NB, np.int32)
    used = 0
    for b, n in enumerate(lengths):
        nblk = -(-int(n) // bs)
        bt[b, :nblk] = rows[used:used + nblk]
        used += nblk
    return k, v, bt


DECODE_CASES = {
    # B, H, KVH, hd, bs, NB, MB, lengths
    "gqa-ragged": (3, 4, 2, 16, 4, 16, 6, [1, 7, 21]),
    "mha-full-blocks": (2, 2, 2, 8, 8, 6, 3, [8, 24]),
    "one-token": (1, 8, 1, 32, 16, 4, 2, [1]),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_block_paged_decode_ref_matches_pallas(case):
    B, H, KVH, hd, bs, NB, MB, lengths = DECODE_CASES[case]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k, v, bt = _pool_and_tables(rng, B, NB, bs, KVH, hd, lengths, MB)
    lens = np.array(lengths, np.int32)
    # the reference's caller clamps the sentinel before the kernel
    # (models/layers.py:259); the plain version gets the raw sentinel rows
    want = jax_block_decode(q, k, v, np.minimum(bt, NB - 1), lens,
                            interpret=True)
    got = tref.block_paged_decode_attention_ref(_t(q), _t(k), _t(v), _t(bt),
                                                _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


MIXED_CASES = {
    # B, Sq, H, KVH, hd, bs, NB, MB, ctx, q_lens
    "chunk-with-padding-rows": (1, 8, 4, 2, 16, 4, 12, 6, [13], [5]),
    "full-chunk": (1, 8, 4, 1, 8, 4, 10, 4, [16], [8]),
    "mixed-batch": (2, 4, 4, 2, 16, 4, 16, 6, [9, 18], [4, 1]),
    "q-len-one": (3, 1, 4, 2, 16, 4, 16, 5, [3, 11, 17], [1, 1, 1]),
    # the served layout: 8 query heads a kv head, hd 128, blocks of 16
    "served-layout-full-chunk": (1, 8, 16, 2, 128, 16, 12, 8, [100], [8]),
    # a context over three 64-token tiles, 5 padding rows
    "tiles-with-padding-rows": (1, 16, 8, 1, 64, 16, 16, 12, [190], [11]),
    "chunk-beside-one-row": (2, 16, 16, 2, 128, 16, 24, 10, [150, 77],
                             [16, 1]),
}


@pytest.mark.parametrize("case", sorted(MIXED_CASES))
def test_mixed_block_paged_ref_matches_pallas(case):
    B, Sq, H, KVH, hd, bs, NB, MB, ctx, q_lens = MIXED_CASES[case]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k, v, bt = _pool_and_tables(rng, B, NB, bs, KVH, hd, ctx, MB)
    ctx = np.array(ctx, np.int32)
    q_lens = np.array(q_lens, np.int32)
    want = jax_mixed(q, k, v, bt, ctx, q_lens, interpret=True)
    got = tref.mixed_block_paged_attention_ref(_t(q), _t(k), _t(v), _t(bt),
                                               _t(ctx), _t(q_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mixed_with_q_len_one_is_decode():
    """q_len == 1 is plain paged decode (same masks, same rows)."""
    B, H, KVH, hd, bs, NB, MB = 3, 4, 2, 16, 4, 16, 6
    lengths = [2, 9, 23]
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v, bt = _pool_and_tables(rng, B, NB, bs, KVH, hd, lengths, MB)
    lens = _t(np.array(lengths, np.int32))
    mixed = tref.mixed_block_paged_attention_ref(
        _t(q), _t(k), _t(v), _t(bt), lens, torch.ones(B, dtype=torch.int32))
    dec = tref.block_paged_decode_attention_ref(_t(q[:, 0]), _t(k), _t(v),
                                                _t(bt), lens)
    np.testing.assert_allclose(mixed[:, 0].numpy(), dec.numpy(), **TOL)


GMM_TABLES = {
    "identity": lambda P, E, rng: np.arange(E, dtype=np.int32),
    "permuted": lambda P, E, rng: rng.permutation(P)[:E].astype(np.int32),
    "aliased": lambda P, E, rng: np.array([3, 3, 0, 5, 0][:E], np.int32),
}


@pytest.mark.parametrize("table_kind", sorted(GMM_TABLES))
@pytest.mark.parametrize("C", [1, 3, 10, 120, 129])
def test_paged_gmm_ref_matches_pallas(table_kind, C):
    E, P, D, F = 5, 8, 32, 24
    rng = np.random.default_rng(3)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    pool = rng.standard_normal((P, D, F)).astype(np.float32)
    table = GMM_TABLES[table_kind](P, E, rng)
    want = jax_paged_gmm(table, pool, x, interpret=True)
    got = tref.paged_gmm_ref(_t(table), _t(pool), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("x_dtype, pool_dtype, D, F, x_ptr, want", [
    # served: qwen3-30b-a3b's wi/wg and wo, deepseek-v2-lite-16b's wi/wg
    (torch.bfloat16, torch.bfloat16, 2048, 768, 0, "mma"),
    (torch.bfloat16, torch.bfloat16, 768, 2048, 0, "mma"),
    (torch.bfloat16, torch.bfloat16, 2048, 1408, 0, "mma"),
    (torch.bfloat16, torch.int8, 2048, 768, 0, "mma"),
    (torch.bfloat16, torch.int8, 768, 2048, 0, "mma"),
    (torch.bfloat16, torch.int8, 2048, 1408, 0, "mma"),
    # f32 x, the parity type: CUDA cores
    (torch.float32, torch.float32, 2048, 768, 0, "fma"),
    (torch.float32, torch.int8, 2048, 768, 0, "fma_char4"),
    # ragged: the card tests' shapes and a misaligned x
    (torch.bfloat16, torch.bfloat16, 512, 96, 0, "mma"),
    (torch.bfloat16, torch.bfloat16, 64, 257, 0, "fma"),
    (torch.bfloat16, torch.bfloat16, 260, 40, 0, "fma"),
    (torch.bfloat16, torch.int8, 512, 40, 0, "fma_char4"),
    (torch.bfloat16, torch.int8, 300, 130, 0, "fma"),
    (torch.bfloat16, torch.bfloat16, 2048, 768, 8, "fma"),
])
def test_gmm_instance_by_shape(x_dtype, pool_dtype, D, F, x_ptr, want):
    """The GMM wrappers pick the tensor-core instance for bf16 x at every
    served width, the CUDA cores for f32 x and for shapes whose rows do not
    come in 16-byte pieces, by shape alone (see ``csrc/moe_gmm.cu``)."""
    from repro_torch.kernels import moe_gmm
    got = moe_gmm.gmm_instance(x_dtype, pool_dtype, D, F, 4096 + x_ptr, 4096)
    assert got == want
    assert got in moe_gmm.INSTANCES


def test_gmm_instance_codes_match_the_kernel():
    """The wrapper's instance codes are the ones ``csrc/moe_gmm.cu``
    dispatches on."""
    import os
    import re
    from repro_torch.kernels import _build, moe_gmm
    with open(os.path.join(_build.CSRC, "moe_gmm.cu")) as f:
        found = re.findall(r"^constexpr int (FMA|FMA_CHAR4|MMA) = (\d+);",
                           f.read(), re.M)
    assert {k.lower(): int(v) for k, v in found} == moe_gmm.INSTANCES


@pytest.mark.parametrize("C", [1, 5])
def test_paged_expert_ffn_ref_matches_pallas(C):
    E, P, D, F = 4, 9, 32, 16
    rng = np.random.default_rng(4)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    pi = rng.standard_normal((P, D, F)).astype(np.float32) / np.sqrt(D)
    pg = rng.standard_normal((P, D, F)).astype(np.float32) / np.sqrt(D)
    po = rng.standard_normal((P, F, D)).astype(np.float32) / np.sqrt(F)
    ti = rng.permutation(P)[:E].astype(np.int32)
    tg = np.array([1, 1, 7, 2], np.int32)            # aliased gate table
    to = rng.permutation(P)[:E].astype(np.int32)
    want = jax_paged_expert_ffn(ti, tg, to, pi, pg, po, x, interpret=True)
    got = tref.paged_expert_ffn_ref(_t(ti), _t(tg), _t(to), _t(pi), _t(pg),
                                    _t(po), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_dispatch_cpu_tensors_to_plain_versions():
    """On CPU tensors the public entry points are the plain versions."""
    rng = np.random.default_rng(5)
    E, P, D, F = 3, 4, 8, 8
    x = _t(rng.standard_normal((E, 2, D)).astype(np.float32))
    pool = _t(rng.standard_normal((P, D, F)).astype(np.float32))
    table = _t(np.array([2, 0, 2], np.int32))
    assert torch.equal(ops.paged_gmm(table, pool, x),
                       tref.paged_gmm_ref(table, pool, x))


@pytest.mark.parametrize("source, name, module, attr", [
    ("paged_decode", "CH", "paged_attention", "TOKENS_PER_BLOCK"),
    ("mla_decode", "SPAN", "mla_decode", "TOKENS_PER_BLOCK"),
    ("mla_decode", "MH", "mla_decode", "HEADS_PER_BLOCK"),
    ("mla_decode", "CH", "mla_decode", "F32_TOKENS_PER_BLOCK"),
    ("mla_decode", "HG", "mla_decode", "F32_HEADS_PER_BLOCK"),
    ("paged_attention", "TQ", "paged_attention", "MIXED_ROWS_PER_BLOCK"),
    ("paged_attention", "SPAN", "paged_attention", "MIXED_TOKENS_PER_BLOCK"),
    ("ssd_scan", "MK", "ssd_scan", "PAD"),
    ("ssd_scan", "MMA_N", "ssd_scan", "MMA_MAX_STATE"),
    ("ssd_scan", "MMA_P", "ssd_scan", "MMA_MAX_HEAD_DIM"),
])
def test_split_wrappers_size_workspaces_by_the_kernels_constants(
        source, name, module, attr):
    """The split-merging wrappers (the decodes, MLA's two kernels and the
    bf16 mixed attention) size their workspaces and counters from the
    kernels' blocking, and the SSD wrapper sizes its workspace from the
    mma depth and picks its tensor-core instance by its largest N and P:
    each wrapper mirrors these as Python constants, and each must equal
    the constant in its CUDA source."""
    import importlib
    import os
    import re
    from repro_torch.kernels import _build
    with open(os.path.join(_build.CSRC, f"{source}.cu")) as f:
        found = re.findall(rf"^constexpr int {name} = (\d+);", f.read(),
                           re.M)
    wrapper = importlib.import_module(f"repro_torch.kernels.{module}")
    assert found == [str(getattr(wrapper, attr))]


def _source(name):
    import os
    from repro_torch.kernels import _build
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        return f.read()


@pytest.mark.parametrize("kernel", ["flash_attention_mma_kernel",
                                    "flash_attention_kernel"])
def test_flash_attention_instances_match_head_dims(kernel):
    """The wrapper refuses any (hd, hdv) outside ``HEAD_DIMS``; the CUDA
    source dispatches exactly those instances, and each dispatched
    instance launches both the bf16 (tensor-core) and the f32 kernel."""
    import re
    from repro_torch.kernels import flash_attention
    src = _source("flash_attention")
    found = re.findall(r"^  FA_LAUNCH\((\d+), (\d+)\)$", src, re.M)
    assert tuple((int(a), int(b)) for a, b in found) == \
        flash_attention.HEAD_DIMS
    launch = src[src.index("int launch(int dtype"):
                 src.index('extern "C"')]
    assert f"{kernel}<HD, HDV>" in launch


def test_int8_decode_lives_in_the_split_decode_source():
    """The int8 decode is an instance of the split-context decode: its
    entry point is defined in ``paged_decode.cu`` (and bound there by the
    wrapper), no longer in ``paged_attention.cu``."""
    from repro_torch.kernels import paged_attention
    name = "quant_block_paged_decode_attention_launch"
    assert f"int {name}(" in _source("paged_decode")
    assert name not in _source("paged_attention")
    assert name in paged_attention._DECODE_SIGNATURES
    assert name not in paged_attention._SIGNATURES
