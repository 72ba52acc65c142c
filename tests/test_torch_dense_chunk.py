"""Dense KV with chunked prefill: the port's ``chunk_attention_apply``,
``chunk_prefill_step`` and a one-device server against the reference, in
process, at f32 on the CPU (``TEST_MOE``).

* ``chunk_attention_apply`` (the reference's plain causal ``mha`` over the
  slot's row; the port's mixed attention over the row viewed as pool
  blocks, at slot 1 of three through ``chunk_attention_apply_tp`` and over
  the row alone) and ``chunk_prefill_step`` (dense expert banks and pooled
  pages, a cache of three slots, the chunk on slot 1) on the reference's own
  parameters: every output row, the padding rows included, the logits and
  every cache row within atol = rtol = 1e-5 — also where ``start + C``
  runs past ``S_max`` and the reference's ``dynamic_update_slice`` moves
  the chunk back onto the row's last C positions;
* the port's one-device server with ``kv_mode="dense"`` and
  ``prefill_chunk=32`` gives the reference server's greedy tokens exactly,
  at ``max_len`` 128 and at 80, where a prompt runs past the row's last
  whole chunk (the clamp above, reached through the engine), and its own
  monolithic run's tokens at 128.

The servers at DP2 x TP2 and a scale started mid-chunk are in
``tests/test_torch_tp.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_MOE
from repro.core.elastic_engine import ElasticServer as JaxServer
from repro.core.hmm import HMM as JaxHMM
from repro.core.topology import ElasticConfig as JaxElasticConfig
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.topology import ElasticConfig
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.workload import Request

TOL = dict(atol=1e-5, rtol=1e-5)


def _jcfg():
    ns = {}
    exec(TEST_MOE, ns)
    return ns["MCFG"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny steps: one intra-op thread (the suite runs several test
    workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ attention

# (S_max, C, start, q_len): a first chunk, a middle one, a last partial
# one, and two whose start + C runs past S_max (the reference clamps the
# write back to S_max - C)
ATTN_CASES = [(48, 16, 0, 16), (48, 16, 16, 16), (48, 16, 32, 9),
              (40, 16, 32, 6), (40, 32, 32, 8)]


@pytest.mark.parametrize("S_max,C,start,q_len", ATTN_CASES)
def test_chunk_attention_apply(S_max, C, start, q_len):
    cfg = _jcfg()
    jp = jax.tree.map(np.asarray, JL.attention_init(
        jax.random.PRNGKey(start + C), cfg, jnp.float32))
    tp = params_from_jax(jp)
    rng = np.random.default_rng(S_max + start)
    KVH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((1, C, cfg.d_model)).astype(np.float32)
    x[0, q_len:] = rng.standard_normal((C - q_len, cfg.d_model))
    k = rng.standard_normal((1, S_max, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((1, S_max, KVH, hd)).astype(np.float32)
    pos = start + np.arange(C, dtype=np.int32)[None]
    jy, (jk, jv) = JL.chunk_attention_apply(
        cfg, jp, x, pos, k_row=jnp.asarray(k), v_row=jnp.asarray(v),
        start=np.int32(start))
    # the port: the same row as row 1 of a cache of three slots
    kc = torch.from_numpy(rng.standard_normal((3, S_max, KVH, hd))
                          .astype(np.float32))
    vc = kc.flip(0).clone()
    kc[1], vc[1] = _t(k[0]), _t(v[0])
    others = kc[[0, 2]].clone(), vc[[0, 2]].clone()
    ys, caches = TL.chunk_attention_apply_tp(
        cfg, [tp], [_t(x)], _t(pos), [torch.device("cpu")],
        caches=[(kc, vc)], start=torch.tensor([start], dtype=torch.int32),
        slot=torch.tensor([1], dtype=torch.int32))
    ty = ys[0]
    assert caches[0][0] is kc and caches[0][1] is vc        # in place
    # every row, padding included: both attend positions <= start + i
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(kc[1].numpy(), np.asarray(jk)[0], **TOL)
    np.testing.assert_allclose(vc[1].numpy(), np.asarray(jv)[0], **TOL)
    # the view never writes past the slot's own row
    assert torch.equal(kc[[0, 2]], others[0])
    assert torch.equal(vc[[0, 2]], others[1])
    # the one-device form over the row alone, as the reference calls it
    k1, v1 = _t(k), _t(v)
    y1, (tk, _) = TL.chunk_attention_apply(
        cfg, tp, _t(x), _t(pos), k_row=k1, v_row=v1,
        start=torch.tensor([start]))
    assert tk is k1
    assert torch.equal(y1, ty) and torch.equal(k1[0], kc[1])


# ----------------------------------------------------------- model step

@pytest.fixture(scope="module", params=["dense", "pooled"])
def weights(request):
    """(reference config, reference params as numpy, port config, port
    params): the reference HMM's one-device store, dense expert banks or
    pooled pages."""
    jcfg = _jcfg()
    hmm = JaxHMM(jcfg, 1, batch_per_replica=2, max_len=64, seed=0,
                 expert_mode=request.param)
    hmm.boot(JaxElasticConfig(1, 1, (0,)))
    jp = jax.tree.map(np.asarray, hmm.params)
    return (jcfg, jp, ModelConfig(**dataclasses.asdict(jcfg)),
            params_from_jax(jp))


# (S_max, start, length): C = 16; the last two run past S_max
STEP_CASES = [(48, 0, 13), (48, 16, 30), (48, 32, 48), (40, 32, 38),
              (40, 32, 33)]


@pytest.mark.parametrize("S_max,start,length", STEP_CASES)
def test_chunk_prefill_step(weights, S_max, start, length):
    jcfg, jp, cfg, tp = weights
    C, B, slot = 16, 3, 1
    rng = np.random.default_rng(S_max + start + length)
    shape = (cfg.num_layers, B, S_max, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    cache = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    tokens = np.zeros((1, C), np.int32)
    tokens[0, :length - start] = rng.integers(0, cfg.vocab_size,
                                              length - start)
    jl, jc = JM.chunk_prefill_step(
        jcfg, jax.tree.map(jnp.asarray, jp), tokens,
        {n: jnp.asarray(a) for n, a in cache.items()}, np.int32(start),
        np.int32(length), np.int32(slot))
    tc = {n: _t(a) for n, a in cache.items()}
    tl, tc = TM.chunk_prefill_step(cfg, tp, _t(tokens), tc,
                                   torch.tensor([start], dtype=torch.int32),
                                   torch.tensor([length], dtype=torch.int32),
                                   torch.tensor([slot], dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)
    # Python ints are filled into [1] tensors: the same step
    tc2 = {n: _t(a) for n, a in cache.items()}
    tl2, _ = TM.chunk_prefill_step(cfg, tp, _t(tokens), tc2, start, length,
                                   slot)
    assert torch.equal(tl2, tl)


# -------------------------------------------------------------- servers

SERVER_KW = dict(tp=1, batch_per_replica=4, seed=0, kv_mode="dense",
                 expert_mode="dense", prefill_buckets=(32, 64, 96, 128))
CHUNK_KW = dict(prefill_chunk=32, prefill_budget=64)


def _requests(max_len):
    """(prompt, output_len): prompts straddling the chunk of 32; at
    max_len 80 two run past the row's last whole chunk (64 + 32 > 80), so
    their final chunk's write is moved back to positions 48..79."""
    rng = np.random.default_rng(max_len)
    lens = [10, 37, 90, 16, 64, 45] if max_len == 128 else [70, 10, 66, 37]
    outs = [8, 12, 16, 1, 10, 6] if max_len == 128 else [6, 9, 8, 12]
    return [(rng.integers(0, 128, n), o) for n, o in zip(lens, outs)]


def _drive(srv, reqs, make):
    objs = [make(i, 0.2 * i, len(p), o, prompt=np.asarray(p, np.int32))
            for i, (p, o) in enumerate(reqs)]
    t, n, i = 0.0, 0, 0
    while any(r.finish_s is None for r in objs):
        while i < len(objs) and objs[i].arrival_s <= t:
            srv.submit(objs[i])
            i += 1
        srv.tick(t)
        t, n = t + .1, n + 1
        assert n < 2000
    return {r.rid: list(srv.engine.generated[r.rid]) for r in objs}


@pytest.fixture(scope="module", params=[128, 80])
def reference_server(request):
    """The reference server's weights and tokens, one device, dense KV,
    chunks of 32 under a budget of 64."""
    max_len = request.param
    buckets = tuple(b for b in SERVER_KW["prefill_buckets"] if b <= max_len)
    srv = JaxServer(_jcfg(), max_len=max_len,
                    **{**SERVER_KW, "prefill_buckets": buckets}, **CHUNK_KW)
    srv.boot(JaxElasticConfig(1, 1, (0,)))
    params = jax.tree.map(np.asarray, srv.engine.params)
    return max_len, params, _drive(srv, _requests(max_len), JaxRequest)


def test_dense_chunked_server_equals_reference(reference_server):
    max_len, params, want = reference_server
    buckets = tuple(b for b in SERVER_KW["prefill_buckets"] if b <= max_len)
    kw = {**SERVER_KW, "prefill_buckets": buckets}
    srv = ElasticServer(ModelConfig(**dataclasses.asdict(_jcfg())),
                        max_len=max_len, device="cpu", **kw, **CHUNK_KW)
    srv.boot(ElasticConfig(1, 1, (0,)), params=params_from_jax(params))
    got = _drive(srv, _requests(max_len), Request)
    assert got == {int(k): v for k, v in want.items()}
    assert srv.engine.kv_stats() is None and srv.engine.compiled.keys() >= {
        "chunk_prefill_32", "decode"}
    if max_len == 128:
        # chunking is a scheduling change only: the monolithic tokens
        mono = ElasticServer(ModelConfig(**dataclasses.asdict(_jcfg())),
                             max_len=max_len, device="cpu", **kw)
        mono.boot(ElasticConfig(1, 1, (0,)), params=params_from_jax(params))
        assert _drive(mono, _requests(max_len), Request) == got
        assert len(got[3]) == 1            # its first token is its only one
