"""The port's layers, MoE and paged model steps against the reference, on
the reference's own parameters (``convert.params_from_jax``) and the same
numpy inputs, at f32 on the CPU.

Tolerance: atol = rtol = 1e-5 on f32 — both packages run the same
arithmetic at the same rounding points, but XLA and PyTorch sum matmuls and
softmaxes in different orders and their pow/cos/sin/exp differ in the last
ulp, so outputs agree to a few ulps, not bit for bit.  Integer outputs
(expert choices, capacity slots, drops) must match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_MOE
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.hmm import HMM as JaxHMM
from repro.core.topology import ElasticConfig as JaxElasticConfig
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE

TOL = dict(atol=1e-5, rtol=1e-5)


def _test_moe():
    ns = {}
    exec(TEST_MOE, ns)
    return ns["MCFG"]


CONFIGS = {
    "test-moe": _test_moe,
    "qwen3-30b-a3b-smoke": lambda: jax_reduced(jax_get_config(
        "qwen3-30b-a3b")),
}


def _port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pooled(request):
    """(reference config, reference pooled params as numpy, port config,
    port params) — the reference HMM's one-device pooled store."""
    jcfg = CONFIGS[request.param]()
    hmm = JaxHMM(jcfg, 1, batch_per_replica=2, max_len=64, seed=0,
                 kv_mode="paged", kv_block_size=8, expert_mode="pooled")
    hmm.boot(JaxElasticConfig(1, 1, (0,)))
    jp = _np_tree(hmm.params)
    return jcfg, jp, _port_cfg(jcfg), params_from_jax(jp)


def _random_pool(rng, cfg, NB, bs):
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}


# ------------------------------------------------------------------ layers

def _attn_params(cfg, seed):
    jp = _np_tree(JL.attention_init(jax.random.PRNGKey(seed), cfg,
                                    jnp.float32))
    return jp, params_from_jax(jp)


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_attention_apply(seed):
    cfg = _test_moe()
    jp, tp = _attn_params(cfg, seed)
    rng = np.random.default_rng(seed)
    B, NB, bs, MB = 3, 12, 4, 5
    KVH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    lengths = np.array([3, 9, 5], np.int32)
    bt = np.full((B, MB), NB, np.int32)
    bt[0, :1], bt[1, :3], bt[2, :2] = [7], [2, 11, 4], [0, 9]
    wb = np.array([7, 4, NB], np.int32)        # slot 2 inactive: dropped
    pos = lengths[:, None]
    jy, jc = JL.paged_attention_apply(cfg, jp, x, pos,
                                      cache={"k": jnp.asarray(k),
                                             "v": jnp.asarray(v)},
                                      block_tables=bt, write_block=wb,
                                      lengths=lengths)
    tc = {"k": _t(k), "v": _t(v)}
    ty, tc = TL.paged_attention_apply(cfg, tp, _t(x), _t(pos), cache=tc,
                                      block_tables=_t(bt),
                                      write_block=_t(wb),
                                      lengths=_t(lengths))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


@pytest.mark.parametrize("start,q_len", [(0, 8), (8, 5), (4, 1)])
def test_paged_chunk_attention_apply(start, q_len):
    cfg = _test_moe()
    jp, tp = _attn_params(cfg, 2)
    rng = np.random.default_rng(start + q_len)
    NB, bs, MB, C = 10, 4, 6, 8
    KVH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((1, C, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    ctx = start + q_len
    table = np.full((1, MB), NB, np.int32)
    rows = np.array([6, 1, 8, 3, 0, 9], np.int32)
    nblk = -(-ctx // bs)
    table[0, :nblk] = rows[:nblk]
    # chunk rows: written blocks of this chunk, the sentinel on padding
    ids = np.full((C // bs,), NB, np.int32)
    for j in range(C // bs):
        if start // bs + j < nblk:
            ids[j] = rows[start // bs + j]
    pos = start + np.arange(C, dtype=np.int32)[None]
    jy, jc = JL.paged_chunk_attention_apply(
        cfg, jp, x, pos, cache={"k": jnp.asarray(k), "v": jnp.asarray(v)},
        block_tables=table,
        chunk_block_ids=ids, ctx_len=np.int32(ctx), q_len=np.int32(q_len))
    tc = {"k": _t(k), "v": _t(v)}
    ty, tc = TL.paged_chunk_attention_apply(
        cfg, tp, _t(x), _t(pos), cache=tc, block_tables=_t(table),
        chunk_block_ids=_t(ids), ctx_len=torch.tensor(ctx),
        q_len=torch.tensor(q_len))
    np.testing.assert_allclose(ty[0, :q_len].numpy(),
                               np.asarray(jy)[0, :q_len], **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


def test_rope_rotates_interleaved_pairs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5)
    for rot in (16, 8):
        jc, js = JL.rope_tables(pos, rot)
        tc, ts = TL.rope_tables(_t(pos), rot)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_allclose(
            TL.apply_rope(_t(x), tc, ts, rot).numpy(),
            np.asarray(JL.apply_rope(x, jc, js, rot)), **TOL)


# --------------------------------------------------------------------- MoE

def _moe_case(T, cf, seed):
    cfg = dataclasses.replace(_test_moe(), num_experts=8, top_k=2,
                              capacity_factor=cf)
    jp = _np_tree(JMoE.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    return cfg, jp, x


@pytest.mark.parametrize("T", [8, 32])
def test_route_and_dispatch_match(T):
    cfg, jp, x = _moe_case(T, 1.25, 0)
    ji, jw, jaux = JMoE.route(jp["router"], x, cfg.top_k)
    ti, tw, taux = TMoE.route(params_from_jax(jp["router"]), _t(x),
                              cfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    C = JMoE.capacity_for(T, cfg)
    assert TMoE.capacity_for(T, _port_cfg(cfg)) == C
    je, js, jk = JMoE._dispatch_indices(ji, cfg.num_experts, C)
    te, ts, tk = TMoE._dispatch_indices(ti, cfg.num_experts, C)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_route_breaks_ties_toward_lower_index():
    """jax.lax.top_k order on exact ties: equal router logits everywhere."""
    w = {"w": torch.zeros(4, 6)}
    idx, wts, _ = TMoE.route(w, torch.ones(3, 4), 3)
    assert idx.tolist() == [[0, 1, 2]] * 3


@pytest.mark.parametrize("cf", [1.25, 100.0])
def test_moe_local_pooled_matches_reference(cf):
    """Pooled single-shard MoE, with GShard drops at capacity factor 1.25
    (32 tokens, 8 experts, top-2: 10 slots per expert)."""
    T = 32
    cfg, jp, x = _moe_case(T, cf, 1)
    E = cfg.num_experts
    rng = np.random.default_rng(7)
    gtable = rng.permutation(E + 3)[:E].astype(np.int32)   # scattered rows
    pool = {}
    for k in ("wi", "wg", "wo"):
        bank = np.asarray(jp[k])
        pool[k] = np.zeros((E + 3,) + bank.shape[1:], np.float32)
        pool[k][gtable] = bank
    jpp = {"router": jp["router"], "gtable": gtable}
    jy, _ = JMoE.moe_local_pooled(cfg, jpp, pool, x)
    ty = TMoE.moe_local_pooled(_port_cfg(cfg), params_from_jax(jpp),
                               params_from_jax(pool), _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    ji, _, _ = JMoE.route(jp["router"], x, cfg.top_k)
    _, _, keep = JMoE._dispatch_indices(ji, E, JMoE.capacity_for(T, cfg))
    assert (not np.asarray(keep).all()) == (cf == 1.25)   # drops happened


@pytest.mark.parametrize("cf", [1.25, 100.0])
def test_moe_local_matches_reference(cf):
    """Dense-bank single-shard MoE, drops at capacity factor 1.25."""
    cfg, jp, x = _moe_case(32, cf, 2)
    jy, _ = JMoE.moe_local(cfg, jp, x)
    ty = TMoE.moe_local(_port_cfg(cfg), params_from_jax(jp), _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_routing_counts_match_reference():
    cfg, jp, x = _moe_case(32, 1.25, 3)
    ji, _, _ = JMoE.route(jp["router"], x, cfg.top_k)
    want = JMoE.routing_counts(ji, cfg.num_experts)
    got = TMoE.routing_counts(_t(ji), cfg.num_experts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- model steps

def test_converted_params_keep_layout(pooled):
    jcfg, jp, _, tp = pooled
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_paged_decode_step_logits(pooled):
    jcfg, jp, cfg, tp = pooled
    rng = np.random.default_rng(11)
    B, NB, bs, MB = 3, 16, 8, 6
    cache = _random_pool(rng, cfg, NB, bs)
    lengths = np.array([5, 17, 30], np.int32)
    bt = np.full((B, MB), NB, np.int32)
    bt[0, :1], bt[1, :3], bt[2, :4] = [9], [1, 14, 6], [3, 0, 12, 7]
    wb = np.array([9, 6, NB], np.int32)            # slot 2 inactive
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc = JM.paged_decode_step(jcfg, _jnp_tree(jp), tokens, _jnp_tree(cache),
                                  lengths, bt, wb)
    tc = {n: _t(a) for n, a in cache.items()}
    tl, tc = TM.paged_decode_step(cfg, tp, _t(tokens), tc, _t(lengths),
                                  _t(bt), _t(wb))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


@pytest.mark.parametrize("start,length", [(0, 13), (16, 30)])
def test_paged_chunk_prefill_step_logits(pooled, start, length):
    jcfg, jp, cfg, tp = pooled
    rng = np.random.default_rng(start + length)
    NB, bs, MB, C = 16, 8, 6, 16
    cache = _random_pool(rng, cfg, NB, bs)
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
                                         _jnp_tree(cache),
                                         np.int32(start), np.int32(length),
                                         bt, ids)
    tc = {n: _t(a) for n, a in cache.items()}
    tl, tc = TM.paged_chunk_prefill_step(cfg, tp, _t(tokens), tc, start,
                                         length, _t(bt), _t(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


# ------------------------------------------------------------ pooled store

@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (2, 2)])
def test_page_table_and_pooled_layout_match_reference(dp, tp):
    """The port's copies of ``ExpertPageTable`` and ``pooled_layout`` place
    every (layer, expert) page where the reference does."""
    from repro.core.expert_pages import ExpertPageTable as JaxTable
    from repro.core.expert_pages import pooled_layout as jax_layout
    from repro_torch.core.expert_pages import ExpertPageTable, pooled_layout
    from repro_torch.core.topology import ElasticConfig
    L, E, pages = 2, 24, 64
    devs = tuple(range(dp * tp))
    jt, tt = JaxTable(L, E, pages), ExpertPageTable(L, E, pages)
    jcfg, tcfg = JaxElasticConfig(dp, tp, devs), ElasticConfig(dp, tp, devs)
    jt.initial_place(jcfg)
    tt.initial_place(tcfg)
    for layer in range(L):
        for d in devs:
            assert tt.device_table(tcfg, layer, d) == \
                jt.device_table(jcfg, layer, d)
    want = jax_layout(jt.active, jcfg, L, E, pages)
    got = pooled_layout(tt.active, tcfg, L, E, pages)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
