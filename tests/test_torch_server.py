"""End to end: the reference ``ElasticServer`` and the port's, both on one
device with the paged KV pool, pooled expert pages and chunked prefill, on
the same weights (the reference's, through ``convert.params_from_jax``) and
the same requests, must produce exactly the same greedy tokens (f32,
``TEST_MOE``, and the same at GShard capacity factor 1.25, where tokens
are dropped).  Covers a prompt that straddles chunk and block boundaries,
a request whose first token is its only one, a shared-prefix pair that
shares blocks, skips its prefix and copies on write, and a small KV pool
that forces recompute preemption.

Each reference server is built once per module (its compilation dominates
the cost); the port's servers are cheap.
"""
import dataclasses

import jax
import numpy as np
import pytest

from helpers import TEST_MOE
from repro.core.elastic_engine import ElasticServer as JaxServer
from repro.core.topology import ElasticConfig as JaxElasticConfig
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.topology import ElasticConfig
from repro_torch.serving.workload import Request


def _mcfg(capacity_factor=None):
    ns = {}
    exec(TEST_MOE, ns)
    if capacity_factor is None:
        return ns["MCFG"]
    return dataclasses.replace(ns["MCFG"], capacity_factor=capacity_factor)


SERVER_KW = dict(tp=1, batch_per_replica=4, max_len=128, seed=0,
                 kv_mode="paged", kv_block_size=16, expert_mode="pooled",
                 prefill_chunk=32, prefill_budget=64, prefill_buckets=(32,))


def _requests(kind):
    """(rid, arrival tick, prompt, output_len) per request."""
    rng = np.random.default_rng(0)
    if kind == "mixed":
        base = rng.integers(0, 128, 48)
        lens = [10, 37, 90, 16]
        outs = [8, 12, 6, 1]
        reqs = [(i, 0, rng.integers(0, 128, L), o)
                for i, (L, o) in enumerate(zip(lens, outs))]
        # rid 4 shares rid 5's blocks: it arrives after rid 5's prompt (3
        # full blocks) is written and registered, matches two blocks plus
        # a partial third, skips the prefix and copies the shared third
        # block on its first append
        reqs += [(5, 4, base, 10), (4, 8, base[:40], 9)]
        return reqs
    # pressure: 8 blocks of 16 tokens for 4 slots of ~50 tokens each
    return [(i, i % 2, rng.integers(0, 128, L), o)
            for i, (L, o) in enumerate(zip([30, 45, 20, 52, 33],
                                           [20, 14, 25, 9, 18]))]


def _drive(srv, reqs, make, max_ticks=400):
    pending = sorted(reqs, key=lambda r: (r[1], r[0]))
    objs = {}
    t = 0
    while t < max_ticks:
        while pending and pending[0][1] <= t:
            rid, _, prompt, out = pending.pop(0)
            objs[rid] = make(rid, float(t), len(prompt), out,
                             prompt=np.asarray(prompt, np.int32))
            srv.submit(objs[rid])
        srv.tick(float(t))
        t += 1
        if not pending and all(r.finish_s is not None
                               for r in objs.values()):
            return
    raise AssertionError("requests did not finish")


def _run_jax(kind, capacity_factor=None, **kw):
    srv = JaxServer(_mcfg(capacity_factor), **{**SERVER_KW, **kw})
    srv.boot(JaxElasticConfig(1, 1, (0,)))
    params = jax.tree.map(np.asarray, srv.engine.params)
    _drive(srv, _requests(kind), JaxRequest)
    return params, srv.engine.generated, srv.engine.kv_stats()


def _run_port(params, kind, capacity_factor=None, **kw):
    mcfg = _mcfg(capacity_factor)
    srv = ElasticServer(ModelConfig(**dataclasses.asdict(mcfg)),
                        device="cpu", **{**SERVER_KW, **kw})
    srv.boot(ElasticConfig(1, 1, (0,)), params=params_from_jax(params))
    _drive(srv, _requests(kind), Request)
    srv.hmm.kv_blocks.check_invariants()
    return srv.engine.generated, srv.engine.kv_stats()


@pytest.fixture(scope="module")
def jax_mixed():
    return _run_jax("mixed")


@pytest.fixture(scope="module")
def jax_drops():
    return _run_jax("mixed", capacity_factor=1.25)


@pytest.fixture(scope="module")
def jax_pressure():
    return _run_jax("pressure", kv_blocks_per_replica=8)


def test_greedy_tokens_equal_reference(jax_mixed):
    params, want, _ = jax_mixed
    got, _ = _run_port(params, "mixed")
    assert got == want
    assert len(got[3]) == 1          # first token is the only token


def test_greedy_tokens_equal_reference_with_capacity_drops(jax_drops):
    """GShard capacity 1.25: decode of 4 slots gives one slot per expert
    (24 experts, top-2), so routed tokens are really dropped."""
    params, want, _ = jax_drops
    got, _ = _run_port(params, "mixed", capacity_factor=1.25)
    assert got == want


def test_shared_prefix_shares_and_copies_like_reference(jax_mixed):
    params, _, want = jax_mixed
    _, got = _run_port(params, "mixed")
    assert got["shared_block_hits"] == want["shared_block_hits"] > 0
    assert got["cow_copies"] == want["cow_copies"] > 0
    assert got["used_blocks"] == 0


def test_preemption_tokens_equal_reference(jax_pressure):
    params, want, want_st = jax_pressure
    got, st = _run_port(params, "pressure", kv_blocks_per_replica=8)
    assert st["preemptions"] == want_st["preemptions"] > 0
    assert got == want


def test_port_server_emits_serve_spans():
    """With a tracer installed, the port's engine records one
    ``decode.tick`` span per tick and ``prefill.chunks`` spans for the
    ticks that ran chunks (``chip_smoke.py`` reads chunk times from
    them); the requests' lifecycle instants come in order."""
    from repro_torch import obs
    tr = obs.install(obs.Tracer())
    try:
        srv = ElasticServer(ModelConfig(**dataclasses.asdict(_mcfg())),
                            device="cpu", **SERVER_KW)
        srv.boot(ElasticConfig(1, 1, (0,)))
        _drive(srv, _requests("pressure")[:2], Request)
    finally:
        obs.install(None)
    names = [e.name for e in tr.events()]
    # rid 0 outputs 20 tokens: one from its prefill tick, 19 from decode
    assert names.count("decode.tick") >= 19
    assert 0 < names.count("prefill.chunks") < names.count("decode.tick")
    for rid in (0, 1):
        seq = [e.name for e in tr.events() if e.args
               and e.args.get("rid") == rid and e.name.startswith("req.")]
        assert seq == ["req.admit", "req.first_token", "req.finish"]
