"""The dense decoders of the assigned set — yi-6b (GQA), qwen1.5-0.5b (QKV
bias), stablelm-3b (partial rotary, LayerNorm), chatglm3-6b (half rotary,
two kv heads, QKV bias) — and arctic-480b (a MoE with a dense residual
MLP) against the reference, on the CPU.

Their configs are the port's own copies (``repro_torch/configs/``): held
field for field equal to the reference's, full size and ``reduced()``.
Their steps run through the port's standard-attention paths: at
``reduced()`` size and f32, on the reference's parameters
(``init_params`` with seed 0, ``convert.params_from_jax``), ``forward``,
``prefill`` (two prompts, lengths 16 and 11, padded to 16, max_len 32)
and one ``decode_step`` from the prefilled cache are held against
``repro.models.model`` within atol = rtol = 1e-5 (logits and cache).

Their servers: the reference's ``ElasticServer`` and the port's, on one
device at f32 with the paper's stores (the paged KV pool with chunked
prefill; arctic's experts in pooled pages), on the same weights (the
reference server's own, converted) and the same three requests, must give
exactly the same greedy tokens.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.elastic_engine import ElasticServer as JaxServer
from repro.core.topology import ElasticConfig as JaxElasticConfig
from repro.models import model as JM
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.topology import ElasticConfig
from repro_torch.models import model as TM
from repro_torch.serving.workload import Request

TOL = dict(atol=1e-5, rtol=1e-5)
NAMES = ["yi-6b", "qwen1.5-0.5b", "stablelm-3b", "chatglm3-6b",
         "arctic-480b"]


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name):
    for suffix in ("", "-smoke"):
        got = dataclasses.asdict(get_config(name + suffix))
        assert got == dataclasses.asdict(jax_config(name + suffix))


@pytest.mark.parametrize("name", NAMES)
def test_steps_match_reference(name):
    jcfg = jax_config(name + "-smoke")
    cfg = get_config(name + "-smoke")
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_jax(jp)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lengths = np.array([16, 11], np.int32)

    want = np.asarray(JM.forward(jcfg, jp, {"tokens": tokens})[0])
    got = TM.forward(cfg, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    jlg, jc = JM.prefill(jcfg, jp, {"tokens": tokens, "lengths": lengths},
                         32)
    lg, cache = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(tokens),
                                     "lengths": torch.from_numpy(lengths)},
                           32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    for n in jc:
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]),
                                   **TOL)

    # one decode step from the reference's cache (the same rows in both)
    step = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    cache = {n: torch.from_numpy(np.array(v)) for n, v in jc.items()}
    jlg, jc = JM.decode_step(jcfg, jp, step, jc, lengths)
    lg, cache = TM.decode_step(cfg, tp, torch.from_numpy(step), cache,
                               torch.from_numpy(lengths))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    for n in jc:
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]),
                                   **TOL)


# the paged KV pool in blocks of 16, chunks of 32 (two chunks a tick)
SERVER_KW = dict(tp=1, batch_per_replica=4, max_len=128, seed=0,
                 kv_mode="paged", kv_block_size=16, prefill_chunk=32,
                 prefill_budget=64, prefill_buckets=(32,))
# (prompt length, output tokens): a prompt inside one chunk, one that
# straddles chunks and blocks, one that ends on a block boundary
SERVE_REQS = [(10, 7), (37, 5), (16, 6)]


def _serve(srv, make, vocab):
    rng = np.random.default_rng(1)
    reqs = [make(i, 0.0, n, out,
                 prompt=rng.integers(0, vocab, n).astype(np.int32))
            for i, (n, out) in enumerate(SERVE_REQS)]
    for r in reqs:
        srv.submit(r)
    for t in range(40):
        if all(r.finish_s is not None for r in reqs):
            return srv.engine.generated
        srv.tick(float(t))
    raise AssertionError("requests did not finish")


@pytest.mark.parametrize("name", NAMES)
def test_server_tokens_equal_reference(name):
    kw = dict(SERVER_KW, **({"expert_mode": "pooled"}
                            if get_config(name).is_moe else {}))
    ref = JaxServer(jax_config(name + "-smoke"), **kw)
    ref.boot(JaxElasticConfig(1, 1, (0,)))
    params = jax.tree.map(np.asarray, ref.engine.params)
    cfg = get_config(name + "-smoke")
    want = _serve(ref, JaxRequest, cfg.vocab_size)
    srv = ElasticServer(cfg, device="cpu", **kw)
    srv.boot(ElasticConfig(1, 1, (0,)), params=params_from_jax(params))
    got = _serve(srv, Request, cfg.vocab_size)
    assert got == want
    assert [len(got[i]) for i in range(len(SERVE_REQS))] == [
        out for _, out in SERVE_REQS]
