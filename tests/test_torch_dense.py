"""The reference's default serving path in the port — slot-contiguous KV,
dense expert banks, monolithic prefill — against the reference on the CPU:
the three plain kernel versions (``flash_attention_ref``,
``paged_decode_attention_ref``, ``kv_cache_write_ref``) against the Pallas
kernels in interpret mode and, at shapes the Pallas kernels refuse,
against the reference's oracles; ``attention_apply``, ``prefill``,
``decode_step``, ``forward`` and ``write_prefill_to_blocks`` against
``repro`` on ``TEST_MOE``; and the two ``ElasticServer``s' greedy tokens
with the default knobs and with the paged stores under monolithic prefill.

Inputs come from numpy with a seed.  Tolerances: f32 atol = rtol = 1e-5
wherever XLA and PyTorch compute (sums in other orders, an online softmax
against one softmax over the row: a few ulps); bit for bit where values
are only moved (cache writes, block scatters, int8 quantization of equal
rows); greedy tokens exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.elastic_engine import ElasticServer as JaxServer
from repro.core.topology import ElasticConfig as JaxElasticConfig
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.kv_write import kv_cache_write as jax_kv_write
from repro.kernels.paged_attention import \
    paged_decode_attention as jax_slot_decode
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.topology import ElasticConfig
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.workload import Request
from test_torch_server import _drive, _mcfg, _requests

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------- plain versions vs Pallas

FLASH_CASES = {
    # B, S, H, KVH, hd, block, causal
    "gqa-one-tile": (2, 64, 4, 2, 16, 128, True),
    "gqa8-four-tiles": (1, 128, 8, 1, 32, 32, True),
    "mha-not-causal": (1, 96, 2, 2, 16, 32, False),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_ref_matches_pallas(case):
    B, S, H, KVH, hd, blk, causal = FLASH_CASES[case]
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, B, S, H, hd), _normal(rng, B, S, KVH, hd),
               _normal(rng, B, S, KVH, hd))
    want = jax_flash(q, k, v, causal=causal, block_q=blk, block_k=blk,
                     interpret=True)
    got = tref.flash_attention_ref(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_ref_at_a_ragged_length_matches_oracles():
    """S = 192, a 64-token bucket that the Pallas kernel's 128-row tiles
    refuse: held against the reference's oracle and against ``mha``, what
    the reference's monolithic prefill runs."""
    B, S, H, KVH, hd = 1, 192, 8, 2, 16
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, B, S, H, hd), _normal(rng, B, S, KVH, hd),
               _normal(rng, B, S, KVH, hd))
    with pytest.raises(AssertionError):
        jax_flash(q, k, v, interpret=True)
    got = tref.flash_attention_ref(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.flash_attention_ref(
        q, k, v)), **TOL)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    np.testing.assert_allclose(got, np.asarray(JL.mha(
        q, k, v, q_pos=pos, kv_pos=pos, causal=True)), **TOL)


@pytest.mark.parametrize("lengths", [[1, 100, 256], [128, 129, 7]],
                         ids=["one-to-full", "tile-edges"])
def test_paged_decode_ref_matches_pallas(lengths):
    B, H, KVH, hd, S_max = 3, 8, 2, 16, 256
    rng = np.random.default_rng(2)
    q = _normal(rng, B, H, hd)
    kc, vc = _normal(rng, B, S_max, KVH, hd), _normal(rng, B, S_max, KVH, hd)
    lens = np.array(lengths, np.int32)
    want = jax_slot_decode(q, kc, vc, lens, interpret=True)
    got = tref.paged_decode_attention_ref(_t(q), _t(kc), _t(vc), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_decode_ref_clamps_lengths_like_the_oracle():
    """A length past S_max (the decode step's ``lengths + 1`` of a full
    slot) attends the whole row, as the oracle's mask does."""
    B, H, KVH, hd, S_max = 2, 4, 4, 16, 48
    rng = np.random.default_rng(3)
    q = _normal(rng, B, H, hd)
    kc, vc = _normal(rng, B, S_max, KVH, hd), _normal(rng, B, S_max, KVH, hd)
    lens = np.array([S_max + 1, 5], np.int32)
    want = jref.paged_decode_attention_ref(q, kc, vc, lens)
    got = tref.paged_decode_attention_ref(_t(q), _t(kc), _t(vc), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kv_cache_write_ref_matches_pallas_in_place():
    B, S, KVH, hd = 3, 256, 2, 16
    rng = np.random.default_rng(4)
    cache, new = _normal(rng, B, S, KVH, hd), _normal(rng, B, KVH, hd)
    pos = np.array([0, 129, 255], np.int32)
    want = jax_kv_write(jnp.asarray(cache), new, pos, interpret=True)
    tc = _t(cache)
    got = tref.kv_cache_write_ref(tc, _t(new), _t(pos))
    assert got is tc                                  # written in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kv_cache_write_ref_drops_like_the_reference():
    """``pos = S_max`` (a full slot's next token): no row changes, as
    ``.at[b, pos].set(mode="drop")`` drops it; the other rows are written
    in the cache's dtype."""
    B, S, KVH, hd = 3, 48, 2, 8
    rng = np.random.default_rng(5)
    cache, new = _normal(rng, B, S, KVH, hd), _normal(rng, B, KVH, hd)
    pos = np.array([S, 3, S - 1], np.int32)
    jc = jnp.asarray(cache, jnp.bfloat16)
    want = jc.at[jnp.arange(B), pos].set(new.astype(jnp.bfloat16),
                                         mode="drop")
    tc = tensor_from_numpy(np.asarray(jc))
    tref.kv_cache_write_ref(tc, _t(new), _t(pos))
    assert torch.equal(tc, tensor_from_numpy(np.asarray(want)))
    assert torch.equal(tc[0], tensor_from_numpy(np.asarray(jc[0])))


# ---------------------------------------------------- layers and the model

def _test_moe(capacity_factor=None):
    return _mcfg(capacity_factor)


@pytest.fixture(scope="module", params=[None, 1.25], ids=["cf100", "cf1.25"])
def dense(request):
    """(reference config, reference dense-bank params, port config, port
    params) for TEST_MOE, at capacity factor 100 and 1.25."""
    jcfg = _test_moe(request.param)
    jp = _np_tree(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    assert "wi" in jp["blocks"]["moe"]
    return jcfg, jp, ModelConfig(**dataclasses.asdict(jcfg)), \
        params_from_jax(jp)


def test_attention_apply_without_cache(dense):
    jcfg, jp, cfg, tp = dense
    rng = np.random.default_rng(6)
    B, S = 2, 12
    x = _normal(rng, B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    ja = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    ta = TM.layer_params(tp["blocks"]["attn"], 0)
    jy, (jk, jv) = JL.attention_apply(jcfg, ja, x, pos)
    ty, (tk, tv) = TL.attention_apply(cfg, ta, _t(x), _t(pos))
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_apply_with_cache(dense):
    """Decode over the slot cache: each row's new k/v land at its length
    (the last slot's write, at S_max, drops) and it attends length + 1."""
    jcfg, jp, cfg, tp = dense
    rng = np.random.default_rng(7)
    B, S_max = 3, 32
    KVH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = _normal(rng, B, 1, cfg.d_model)
    kc, vc = _normal(rng, B, S_max, KVH, hd), _normal(rng, B, S_max, KVH, hd)
    lengths = np.array([3, 31, 32], np.int32)
    pos = lengths[:, None]
    ja = jax.tree.map(lambda a: a[1], jp["blocks"]["attn"])
    ta = TM.layer_params(tp["blocks"]["attn"], 1)
    jy, (jk, jv) = JL.attention_apply(jcfg, ja, x, pos,
                                      cache=(jnp.asarray(kc), jnp.asarray(vc)),
                                      write_pos=lengths,
                                      kv_valid_len=lengths + 1)
    tk, tv = _t(kc), _t(vc)
    ty, (tk2, tv2) = TL.attention_apply(cfg, ta, _t(x), _t(pos),
                                        cache=(tk, tv), write_pos=_t(lengths),
                                        kv_valid_len=_t(lengths + 1))
    assert tk2 is tk and tv2 is tv                    # written in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for got, want, old in ((tk, jk, kc), (tv, jv, vc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(got[2].numpy(), old[2])   # dropped


@pytest.mark.parametrize("lengths", [[24, 17], [9, 24]])
def test_prefill_logits_and_cache(dense, lengths):
    """Two prompts padded to 24 tokens (padding goes through the router
    too, so at capacity factor 1.25 it takes capacity slots), K/V padded
    to max_len 40 with zeros."""
    jcfg, jp, cfg, tp = dense
    rng = np.random.default_rng(sum(lengths))
    B, S, max_len = 2, 24, 40
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array(lengths, np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": tokens, "lengths": lens},
                        max_len)
    tl, tc = TM.prefill(cfg, tp, {"tokens": _t(tokens), "lengths": _t(lens)},
                        max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        assert tuple(tc[n].shape) == jc[n].shape
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)
        assert not tc[n][:, :, S:].any()


def test_decode_step_logits_and_cache(dense):
    jcfg, jp, cfg, tp = dense
    rng = np.random.default_rng(8)
    B, max_len = 4, 48
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {n: _normal(rng, L, B, max_len, KVH, hd) for n in ("k", "v")}
    lengths = np.array([5, 17, 47, 48], np.int32)    # the last write drops
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc = JM.decode_step(jcfg, jp, tokens,
                            jax.tree.map(jnp.asarray, cache), lengths)
    tc = {n: _t(a) for n, a in cache.items()}
    tl, tc = TM.decode_step(cfg, tp, _t(tokens), tc, _t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)
        np.testing.assert_array_equal(tc[n][:, 3].numpy(), cache[n][:, 3])


def test_forward_logits(dense):
    jcfg, jp, cfg, tp = dense
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    jl, _ = JM.forward(jcfg, jp, {"tokens": tokens}, remat=False)
    tl = TM.forward(cfg, tp, {"tokens": _t(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("store", ["float32", "bfloat16", "int8"])
def test_write_prefill_to_blocks_equals_reference(store):
    """One prompt's prefill K/V scattered into pool blocks: the second
    block is CoW-shared and the fourth is padding (the NB sentinel on
    both), so only the first and third are written.  Equal bit for bit,
    int8 entries and scales too."""
    cfg = ModelConfig(**dataclasses.asdict(_test_moe()))
    rng = np.random.default_rng(10)
    L, KVH, hd, NB, bs, S = 2, cfg.num_kv_heads, cfg.resolved_head_dim, \
        10, 8, 32
    small = {n: _normal(rng, L, 1, S, KVH, hd) for n in ("k", "v")}
    ids = np.array([6, NB, 2, NB], np.int32)
    kv_dtype = "int8" if store == "int8" else None
    jpool = JM.init_paged_cache(_test_moe(), NB, bs, jnp.dtype(store)
                                if store != "int8" else None,
                                kv_dtype=kv_dtype)
    jpool = {n: a + jnp.asarray(rng.integers(-3, 4, a.shape), a.dtype)
             for n, a in jpool.items()}              # earlier contents
    want = JM.write_prefill_to_blocks(jpool, small, ids)
    tpool = {n: tensor_from_numpy(np.asarray(a)) for n, a in jpool.items()}
    got = TM.write_prefill_to_blocks(tpool, {n: _t(a) for n, a in
                                             small.items()}, _t(ids))
    assert got is tpool
    for n, leaf in got.items():
        assert torch.equal(leaf, tensor_from_numpy(np.asarray(want[n]))), n


def test_dense_steps_refuse_a_dense_prefix():
    """The reference's standard-attention prefill and decode scan
    ``blocks`` only; a dense prefix is outside what they compute."""
    cfg = dataclasses.replace(ModelConfig(**dataclasses.asdict(
        _test_moe())), first_k_dense=1)
    with pytest.raises(ValueError, match="first_k_dense"):
        TM.init_cache(cfg, 2, 32, device="cpu")
    with pytest.raises(ValueError, match="first_k_dense"):
        TM.prefill(cfg, {}, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                   8)


# ------------------------------------------------------------------ servers

SERVER_KW = dict(tp=1, batch_per_replica=4, max_len=128, seed=0,
                 prefill_buckets=(32, 64, 96))
PAGED = dict(kv_mode="paged", kv_block_size=16, expert_mode="pooled",
             prefill_chunk=0)
RUNS = {
    "defaults": ({}, None),
    "defaults-cf1.25": ({}, 1.25),
    "paged-monolithic": (PAGED, None),
    "paged-monolithic-int8": ({**PAGED, "kv_dtype": "int8",
                               "expert_dtype": "int8"}, None),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_server_tokens_equal_reference(run):
    """The "mixed" requests (4 slots for 6 requests; one whose first token
    is its only one; a shared-prefix pair that shares blocks and copies
    on write in the paged runs) through both servers, each booted on the
    reference's parameters: the greedy tokens must be equal.  At capacity
    factor 1.25 padding tokens of a prefill take capacity slots and drop
    real ones, as in the reference."""
    kw, cf = RUNS[run]
    jsrv = JaxServer(_mcfg(cf), **SERVER_KW, **kw)
    jsrv.boot(JaxElasticConfig(1, 1, (0,)))
    params = jax.tree.map(np.asarray, jsrv.engine.params)
    _drive(jsrv, _requests("mixed"), JaxRequest)
    srv = ElasticServer(ModelConfig(**dataclasses.asdict(_mcfg(cf))),
                        device="cpu", **SERVER_KW, **kw)
    srv.boot(ElasticConfig(1, 1, (0,)), params=params_from_jax(params))
    _drive(srv, _requests("mixed"), Request)
    got, want = srv.engine.generated, jsrv.engine.generated
    assert got == want
    assert len(got[3]) == 1
    if kw:
        st, want_st = srv.engine.kv_stats(), jsrv.engine.kv_stats()
        for key in ("shared_block_hits", "cow_copies"):
            assert st[key] == want_st[key] > 0, key
        assert st["used_blocks"] == 0
        srv.hmm.kv_blocks.check_invariants()
    else:
        assert srv.engine.kv_stats() is None
        assert "wi" in srv.engine.params["blocks"]["moe"]


def test_dense_server_refuses_an_unlisted_bucket():
    """Dense KV serves only the prefill buckets it was given, as the
    reference does; the paged pool builds the bucket."""
    mcfg = ModelConfig(**dataclasses.asdict(_mcfg()))
    reqs = [(0, 0, np.arange(40) % 128, 2)]
    srv = ElasticServer(mcfg, device="cpu", **{**SERVER_KW,
                                               "prefill_buckets": (32,)})
    srv.boot(ElasticConfig(1, 1, (0,)))
    with pytest.raises(KeyError, match="prefill"):
        _drive(srv, reqs, Request)
    srv = ElasticServer(mcfg, device="cpu", **{**SERVER_KW, **PAGED,
                                               "prefill_buckets": (32,)})
    srv.boot(ElasticConfig(1, 1, (0,)))
    _drive(srv, reqs, Request)
    assert "prefill_64" in srv.engine.compiled


def test_dense_server_boots_dense_banks_and_slot_cache():
    """Boot with the default knobs draws dense banks [L, E, D, F] and a
    slot cache [L, B, max_len, KVH, hd]; the same seed in the pooled store
    holds the same expert weights."""
    mcfg = ModelConfig(**dataclasses.asdict(_mcfg()))
    srv = ElasticServer(mcfg, device="cpu", **SERVER_KW)
    srv.boot(ElasticConfig(1, 1, (0,)))
    eng = srv.engine
    wi = eng.params["blocks"]["moe"]["wi"]
    assert tuple(wi.shape) == (2, mcfg.num_experts, mcfg.d_model,
                               mcfg.moe_d_ff)
    assert tuple(eng.cache["k"].shape) == (2, 4, 128, mcfg.num_kv_heads,
                                           mcfg.resolved_head_dim)
    assert srv.hmm.kv_blocks is None
    pooled = ElasticServer(mcfg, device="cpu", **SERVER_KW, **PAGED)
    pooled.boot(ElasticConfig(1, 1, (0,)))
    pp = pooled.engine.params
    gt = pp["blocks"]["moe"]["gtable"]
    for l in range(2):
        assert torch.equal(pp["moe_pool"]["wi"][gt[l].long()], wi[l])
