"""The port's int8 path against the reference, on the CPU: quantization,
the four plain int8 kernel versions against the Pallas kernels run in
interpret mode, the int8 attention layers, the pooled MoE over int8 pages,
the paged model steps with both knobs, and ``ElasticServer`` with
``kv_dtype="int8", expert_dtype="int8"`` against the reference server.

Inputs come from numpy with a seed and go to both packages.  Tolerances:

* ``quantize_rows`` — bit for bit (both compute in f32 and round half to
  even);
* plain versions against Pallas — f32 atol = rtol = 1e-4: the Pallas
  kernels take the scales out of the contractions (``dot(q, k_i8) * sk``,
  ``(p * sv) @ v_i8``), the plain versions dequantize first, so the sums
  round at other places, and scales 100x apart widen the spread;
* layers, MoE and model steps — f32 atol = rtol = 1e-5, as
  ``test_torch_model.py``.  The int8 rows they write must be equal; their
  scales agree to rtol = 1e-6, since each is max|k| / 127 of a k row that
  the projection and RoPE compute an ulp apart in XLA and PyTorch;
* model steps over two layers — layer 1 quantizes k/v rows computed from
  layer 0's output, which the two packages round an ulp apart, so a row
  value on a rounding tie can land one quantum apart (seen: one entry of
  ~2,000 in the chunk step at start 16).  At most two entries may differ,
  by exactly one quantum, and then the logits are held to atol = rtol =
  2e-3: one quantum of a k row (at most 3/127 here) moves that token's
  score and the logits after it by about 1e-3;
* servers — equal greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_MOE
from repro.core.hmm import HMM as JaxHMM
from repro.core.topology import ElasticConfig as JaxElasticConfig
from repro.kernels import quant as jquant
from repro.kernels.moe_gmm import quant_paged_expert_ffn as jax_quant_ffn
from repro.kernels.moe_gmm import quant_paged_gmm as jax_quant_gmm
from repro.kernels.paged_attention import \
    quant_block_paged_decode_attention as jax_quant_decode
from repro.kernels.paged_attention import \
    quant_mixed_block_paged_attention as jax_quant_mixed
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from test_torch_server import _run_jax, _run_port

KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=1e-5, rtol=1e-5)
TIE_TOL = dict(atol=2e-3, rtol=2e-3)
INT8 = dict(kv_dtype="int8", expert_dtype="int8")


def _t(a):
    return torch.from_numpy(np.array(a))


def _test_moe():
    ns = {}
    exec(TEST_MOE, ns)
    return ns["MCFG"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _int8_pool(rng, shape, spread=100.0, top=3.0):
    """Random int8 entries and positive f32 scales, one per leading row:
    row maxima log-uniform in [top / spread, top] (rows whose scales differ
    by up to ``spread``)."""
    q = rng.integers(-127, 128, shape).astype(np.int8)
    s = (np.exp(rng.uniform(np.log(top / spread), np.log(top), shape[:-2]))
         / 127.0).astype(np.float32)
    return q, s


# ---------------------------------------------------------------- quantize

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_equals_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 16, 4, 128)).astype(np.float32)
    x *= np.exp(rng.uniform(-3, 3, (64, 16, 1, 1))).astype(np.float32)
    x[3, 5] = 0.0                                   # an all-zero row
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = tensor_from_numpy(np.asarray(jx))
    assert tx.dtype == getattr(torch, dtype)
    jq, js = jquant.quantize_rows(jx, (-2, -1))
    tq, ts = tquant.quantize_rows(tx, (-2, -1))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[3, 5] == np.float32(jquant.EPS) / np.float32(127.0)
    np.testing.assert_array_equal(
        tquant.dequantize_rows(tq, ts, (-2, -1)).numpy(),
        np.asarray(jquant.dequantize_rows(jq, js, (-2, -1))))


def test_quantize_rows_pages_equal_reference():
    """Expert pages: one scale per [D, F] page."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((6, 32, 24)).astype(np.float32)
    w[2] = 0.0
    jq, js = jquant.quantize_rows(jnp.asarray(w), (-2, -1))
    tq, ts = tquant.quantize_rows(_t(w), (-2, -1))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ----------------------------------------------------- kernels vs Pallas

def _quant_pools_and_tables(rng, B, NB, bs, KVH, hd, lengths, MB):
    k, ks = _int8_pool(rng, (NB, bs, KVH, hd))
    v, vs = _int8_pool(rng, (NB, bs, KVH, hd))
    rows = rng.permutation(NB)
    bt = np.full((B, MB), NB, np.int32)            # NB sentinel padding
    used = 0
    for b, n in enumerate(lengths):
        nblk = -(-int(n) // bs)
        bt[b, :nblk] = rows[used:used + nblk]
        used += nblk
    return k, ks, v, vs, bt


DECODE_CASES = {
    # B, H, KVH, hd, bs, NB, MB, lengths
    "gqa-ragged": (3, 4, 2, 16, 4, 16, 6, [1, 7, 21]),
    "mha-full-blocks": (2, 2, 2, 8, 8, 6, 3, [8, 24]),
    "one-token": (1, 8, 1, 32, 16, 4, 2, [1]),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_quant_block_paged_decode_ref_matches_pallas(case):
    B, H, KVH, hd, bs, NB, MB, lengths = DECODE_CASES[case]
    rng = np.random.default_rng(10)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k, ks, v, vs, bt = _quant_pools_and_tables(rng, B, NB, bs, KVH, hd,
                                               lengths, MB)
    lens = np.array(lengths, np.int32)
    # the reference's caller clamps the sentinel (models/layers.py:259)
    want = jax_quant_decode(q, k, ks, v, vs, np.minimum(bt, NB - 1), lens,
                            interpret=True)
    got = tref.quant_block_paged_decode_attention_ref(
        _t(q), _t(k), _t(ks), _t(v), _t(vs), _t(bt), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


MIXED_CASES = {
    # B, Sq, H, KVH, hd, bs, NB, MB, ctx, q_lens
    "chunk-with-padding-rows": (1, 8, 4, 2, 16, 4, 12, 6, [13], [5]),
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
def test_quant_mixed_block_paged_ref_matches_pallas(case):
    B, Sq, H, KVH, hd, bs, NB, MB, ctx, q_lens = MIXED_CASES[case]
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k, ks, v, vs, bt = _quant_pools_and_tables(rng, B, NB, bs, KVH, hd, ctx,
                                               MB)
    ctx = np.array(ctx, np.int32)
    q_lens = np.array(q_lens, np.int32)
    want = jax_quant_mixed(q, k, ks, v, vs, bt, ctx, q_lens, interpret=True)
    got = tref.quant_mixed_block_paged_attention_ref(
        _t(q), _t(k), _t(ks), _t(v), _t(vs), _t(bt), _t(ctx), _t(q_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


GMM_TABLES = {
    "permuted": lambda P, E, rng: rng.permutation(P)[:E].astype(np.int32),
    "aliased": lambda P, E, rng: np.array([3, 3, 0, 5, 0][:E], np.int32),
}


@pytest.mark.parametrize("table_kind", sorted(GMM_TABLES))
@pytest.mark.parametrize("C", [1, 3, 10, 120, 129])
def test_quant_paged_gmm_ref_matches_pallas(table_kind, C):
    E, P, D, F = 5, 8, 32, 24
    rng = np.random.default_rng(13)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    pool, scales = _int8_pool(rng, (P, D, F))
    table = GMM_TABLES[table_kind](P, E, rng)
    want = jax_quant_gmm(table, pool, scales, x, interpret=True)
    got = tref.quant_paged_gmm_ref(_t(table), _t(pool), _t(scales), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("C", [1, 5])
def test_quant_paged_expert_ffn_ref_matches_pallas(C):
    E, P, D, F = 4, 9, 32, 16
    rng = np.random.default_rng(14)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    pi, si = _int8_pool(rng, (P, D, F))
    pg, sg = _int8_pool(rng, (P, D, F))
    po, so = _int8_pool(rng, (P, F, D))
    si, sg, so = si / np.sqrt(D), sg / np.sqrt(D), so / np.sqrt(F)
    ti = rng.permutation(P)[:E].astype(np.int32)
    tg = np.array([1, 1, 7, 2], np.int32)            # aliased gate table
    to = rng.permutation(P)[:E].astype(np.int32)
    want = jax_quant_ffn(ti, tg, to, pi, pg, po, si, sg, so, x,
                         interpret=True)
    got = tref.quant_paged_expert_ffn_ref(*map(_t, (ti, tg, to, pi, pg, po,
                                                    si, sg, so, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_ops_dispatch_quant_cpu_tensors_to_plain_versions():
    rng = np.random.default_rng(15)
    x = _t(rng.standard_normal((3, 2, 8)).astype(np.float32))
    pool, scales = map(_t, _int8_pool(rng, (4, 8, 8)))
    table = _t(np.array([2, 0, 2], np.int32))
    ops.reset_launch_counts()
    assert torch.equal(ops.quant_paged_gmm(table, pool, scales, x),
                       tref.quant_paged_gmm_ref(table, pool, scales, x))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


# ------------------------------------------------------------------ layers

def _attn_params(cfg, seed):
    jp = _np_tree(JL.attention_init(jax.random.PRNGKey(seed), cfg,
                                    jnp.float32))
    return jp, params_from_jax(jp)


def _quant_cache(rng, NB, bs, KVH, hd):
    k, ks = _int8_pool(rng, (NB, bs, KVH, hd))
    v, vs = _int8_pool(rng, (NB, bs, KVH, hd))
    return {"k": k, "v": v, "k_scale": ks, "v_scale": vs}


def _check_cache(tc, jc):
    for n in ("k", "v"):
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))
        np.testing.assert_allclose(tc[n + "_scale"].numpy(),
                                   np.asarray(jc[n + "_scale"]), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_quant_paged_attention_apply(seed):
    cfg = _test_moe()
    jp, tp = _attn_params(cfg, seed)
    rng = np.random.default_rng(seed)
    B, NB, bs, MB = 3, 12, 4, 5
    KVH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cache = _quant_cache(rng, NB, bs, KVH, hd)
    lengths = np.array([3, 9, 5], np.int32)
    bt = np.full((B, MB), NB, np.int32)
    bt[0, :1], bt[1, :3], bt[2, :2] = [7], [2, 11, 4], [0, 9]
    wb = np.array([7, 4, NB], np.int32)        # slot 2 inactive: dropped
    pos = lengths[:, None]
    jy, jc = JL.paged_attention_apply(cfg, jp, x, pos,
                                      cache=_jnp_tree(cache),
                                      block_tables=bt, write_block=wb,
                                      lengths=lengths)
    tc = {n: _t(a) for n, a in cache.items()}
    ty, tc = TL.paged_attention_apply(cfg, tp, _t(x), _t(pos), cache=tc,
                                      block_tables=_t(bt),
                                      write_block=_t(wb),
                                      lengths=_t(lengths))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _check_cache(tc, jc)


@pytest.mark.parametrize("start,q_len", [(0, 8), (8, 5), (4, 1)])
def test_quant_paged_chunk_attention_apply(start, q_len):
    cfg = _test_moe()
    jp, tp = _attn_params(cfg, 2)
    rng = np.random.default_rng(start + q_len)
    NB, bs, MB, C = 10, 4, 6, 8
    KVH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((1, C, cfg.d_model)).astype(np.float32)
    cache = _quant_cache(rng, NB, bs, KVH, hd)
    ctx = start + q_len
    table = np.full((1, MB), NB, np.int32)
    rows = np.array([6, 1, 8, 3, 0, 9], np.int32)
    nblk = -(-ctx // bs)
    table[0, :nblk] = rows[:nblk]
    ids = np.full((C // bs,), NB, np.int32)
    for j in range(C // bs):
        if start // bs + j < nblk:
            ids[j] = rows[start // bs + j]
    pos = start + np.arange(C, dtype=np.int32)[None]
    jy, jc = JL.paged_chunk_attention_apply(
        cfg, jp, x, pos, cache=_jnp_tree(cache), block_tables=table,
        chunk_block_ids=ids, ctx_len=np.int32(ctx), q_len=np.int32(q_len))
    tc = {n: _t(a) for n, a in cache.items()}
    ty, tc = TL.paged_chunk_attention_apply(
        cfg, tp, _t(x), _t(pos), cache=tc, block_tables=_t(table),
        chunk_block_ids=_t(ids), ctx_len=torch.tensor(ctx),
        q_len=torch.tensor(q_len))
    np.testing.assert_allclose(ty[0, :q_len].numpy(),
                               np.asarray(jy)[0, :q_len], **TOL)
    _check_cache(tc, jc)


# --------------------------------------------------------------------- MoE

@pytest.mark.parametrize("cf", [1.25, 100.0])
def test_quant_moe_local_pooled_matches_reference(cf):
    """Pooled single-shard MoE over int8 pages with per-page scales, on
    scattered pool rows, with GShard drops at capacity factor 1.25."""
    T = 32
    cfg = dataclasses.replace(_test_moe(), num_experts=8, top_k=2,
                              capacity_factor=cf)
    jp = _np_tree(JMoE.moe_init(jax.random.PRNGKey(4), cfg, jnp.float32))
    x = np.random.default_rng(4).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    E = cfg.num_experts
    rng = np.random.default_rng(8)
    gtable = rng.permutation(E + 3)[:E].astype(np.int32)
    pool = {}
    for k in ("wi", "wg", "wo"):
        q, s = jquant.quantize_rows(jnp.asarray(jp[k]), (-2, -1))
        pool[k] = np.zeros((E + 3,) + q.shape[1:], np.int8)
        pool[k][gtable] = np.asarray(q)
        pool[k + "_scale"] = np.zeros((E + 3,), np.float32)
        pool[k + "_scale"][gtable] = np.asarray(s)
    jpp = {"router": jp["router"], "gtable": gtable}
    jy, _ = JMoE.moe_local_pooled(cfg, jpp, pool, x)
    ty = TMoE.moe_local_pooled(ModelConfig(**dataclasses.asdict(cfg)),
                               params_from_jax(jpp), params_from_jax(pool),
                               _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


# ------------------------------------------------------------- model steps

@pytest.fixture(scope="module")
def int8_pooled():
    """The reference HMM's one-device pooled store with int8 expert pages
    (reference config, numpy params, port config, port params)."""
    jcfg = _test_moe()
    hmm = JaxHMM(jcfg, 1, batch_per_replica=2, max_len=64, seed=0,
                 kv_mode="paged", kv_block_size=8, expert_mode="pooled",
                 **INT8)
    hmm.boot(JaxElasticConfig(1, 1, (0,)))
    jp = _np_tree(hmm.params)
    assert jp["moe_pool"]["wi"].dtype == np.int8
    return jcfg, jp, ModelConfig(**dataclasses.asdict(jcfg)), \
        params_from_jax(jp)


def _check_step(tl, jl, tc, jc):
    """Logits and written caches of a two-layer step (see the module
    docstring for the rounding-tie rule)."""
    flips = 0
    for n in ("k", "v"):
        d = tc[n].int().numpy() - np.asarray(jc[n]).astype(np.int32)
        assert np.abs(d).max() <= 1
        flips += int(np.count_nonzero(d))
        np.testing.assert_allclose(tc[n + "_scale"].numpy(),
                                   np.asarray(jc[n + "_scale"]), rtol=1e-6,
                                   atol=0)
    assert flips <= 2, flips
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               **(TOL if flips == 0 else TIE_TOL))


def _quant_model_cache(rng, cfg, NB, bs):
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {}
    for n in ("k", "v"):
        out[n], out[n + "_scale"] = _int8_pool(rng, (L, NB, bs, KVH, hd))
    return out


def test_quant_paged_decode_step_logits(int8_pooled):
    jcfg, jp, cfg, tp = int8_pooled
    rng = np.random.default_rng(21)
    B, NB, bs, MB = 3, 16, 8, 6
    cache = _quant_model_cache(rng, cfg, NB, bs)
    lengths = np.array([5, 17, 30], np.int32)
    bt = np.full((B, MB), NB, np.int32)
    bt[0, :1], bt[1, :3], bt[2, :4] = [9], [1, 14, 6], [3, 0, 12, 7]
    wb = np.array([9, 6, NB], np.int32)            # slot 2 inactive
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc = JM.paged_decode_step(jcfg, _jnp_tree(jp), tokens,
                                  _jnp_tree(cache), lengths, bt, wb)
    tc = {n: _t(a) for n, a in cache.items()}
    tl, tc = TM.paged_decode_step(cfg, tp, _t(tokens), tc, _t(lengths),
                                  _t(bt), _t(wb))
    _check_step(tl, jl, tc, jc)


@pytest.mark.parametrize("start,length", [(0, 13), (16, 30)])
def test_quant_paged_chunk_prefill_step_logits(int8_pooled, start, length):
    jcfg, jp, cfg, tp = int8_pooled
    rng = np.random.default_rng(start + length)
    NB, bs, MB, C = 16, 8, 6, 16
    cache = _quant_model_cache(rng, cfg, NB, bs)
    rows = np.array([4, 11, 2, 15, 8, 0], np.int32)
    nblk = -(-length // bs)
    bt = np.full((1, MB), NB, np.int32)
    bt[0, :nblk] = rows[:nblk]
    ids = np.full((C // bs,), NB, np.int32)
    for j in range(C // bs):
        if start // bs + j < nblk:
            ids[j] = rows[start // bs + j]
    tokens = np.zeros((1, C), np.int32)
    tokens[0, :length - start] = rng.integers(0, cfg.vocab_size,
                                              length - start)
    jl, jc = JM.paged_chunk_prefill_step(jcfg, _jnp_tree(jp), tokens,
                                         _jnp_tree(cache), np.int32(start),
                                         np.int32(length), bt, ids)
    tc = {n: _t(a) for n, a in cache.items()}
    tl, tc = TM.paged_chunk_prefill_step(cfg, tp, _t(tokens), tc, start,
                                         length, _t(bt), _t(ids))
    _check_step(tl, jl, tc, jc)


def test_int8_cache_layout_matches_reference():
    jcfg = _test_moe()
    want = JM.init_paged_cache(jcfg, 6, 8, kv_dtype="int8")
    got = TM.init_paged_cache(ModelConfig(**dataclasses.asdict(jcfg)), 6, 8,
                              device="cpu", kv_dtype="int8")
    assert sorted(got) == sorted(want)
    for n, leaf in got.items():
        assert tuple(leaf.shape) == want[n].shape
        assert str(leaf.dtype).replace("torch.", "") == str(want[n].dtype)


# ----------------------------------------------------------------- servers

@pytest.fixture(scope="module")
def jax_int8_mixed():
    return _run_jax("mixed", **INT8)


@pytest.fixture(scope="module")
def jax_int8_pressure():
    return _run_jax("pressure", kv_blocks_per_replica=8, **INT8)


def test_int8_server_tokens_equal_reference(jax_int8_mixed):
    """Both knobs: int8 KV blocks and int8 expert pages.  The "mixed"
    requests include the CoW prefix pair, so a copied block must carry its
    scales."""
    params, want, want_st = jax_int8_mixed
    assert params["moe_pool"]["wi"].dtype == np.int8
    got, st = _run_port(params, "mixed", **INT8)
    assert got == want
    assert st["cow_copies"] == want_st["cow_copies"] > 0
    assert st["shared_block_hits"] == want_st["shared_block_hits"] > 0
    assert st["block_bytes"] == want_st["block_bytes"]


def test_int8_server_preemption_tokens_equal_reference(jax_int8_pressure):
    params, want, want_st = jax_int8_pressure
    got, st = _run_port(params, "pressure", kv_blocks_per_replica=8, **INT8)
    assert st["preemptions"] == want_st["preemptions"] > 0
    assert got == want


def test_int8_server_knobs_alone():
    """Each knob alone serves: the port's own int8 store against its own
    unquantized run on the same seed (the tokens may differ, the requests
    must finish), with the cache and pool dtypes each knob selects."""
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.serving.workload import Request
    from test_torch_server import SERVER_KW, _drive, _requests
    mcfg = ModelConfig(**dataclasses.asdict(_test_moe()))
    for kw in ({"kv_dtype": "int8"}, {"expert_dtype": "int8"}):
        srv = ElasticServer(mcfg, device="cpu", **{**SERVER_KW, **kw})
        srv.boot(ElasticConfig(1, 1, (0,)))
        _drive(srv, _requests("mixed"), Request)
        eng = srv.engine
        assert (eng.cache["k"].dtype == torch.int8) == ("kv_dtype" in kw)
        assert ("k_scale" in eng.cache) == ("kv_dtype" in kw)
        assert (eng.params["moe_pool"]["wi"].dtype == torch.int8) == \
            ("expert_dtype" in kw)
        assert all(len(eng.generated[r]) > 0 for r in eng.generated)


def test_expert_page_nbytes_matches_reference():
    from repro_torch.core.hmm import HMM
    jcfg = _test_moe()
    for kw in ({}, {"expert_dtype": "int8"}):
        want = JaxHMM(jcfg, 1, batch_per_replica=2, max_len=64,
                      expert_mode="pooled", kv_mode="paged",
                      **kw).expert_page_nbytes()
        got = HMM(ModelConfig(**dataclasses.asdict(jcfg)), 1,
                  batch_per_replica=2, max_len=64, expert_mode="pooled",
                  kv_mode="paged", device="cpu", **kw).expert_page_nbytes()
        assert got == want


def test_adopt_refuses_a_pool_of_the_other_dtype(jax_int8_mixed):
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.topology import ElasticConfig
    from test_torch_server import SERVER_KW
    params, _, _ = jax_int8_mixed
    mcfg = ModelConfig(**dataclasses.asdict(_test_moe()))
    srv = ElasticServer(mcfg, device="cpu", **SERVER_KW)     # bf16/f32 pool
    with pytest.raises(ValueError, match="expert_dtype"):
        srv.boot(ElasticConfig(1, 1, (0,)), params=params_from_jax(params))
