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
@pytest.mark.parametrize("C", [1, 3, 10])
def test_paged_gmm_ref_matches_pallas(table_kind, C):
    E, P, D, F = 5, 8, 32, 24
    rng = np.random.default_rng(3)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    pool = rng.standard_normal((P, D, F)).astype(np.float32)
    table = GMM_TABLES[table_kind](P, E, rng)
    want = jax_paged_gmm(table, pool, x, interpret=True)
    got = tref.paged_gmm_ref(_t(table), _t(pool), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
