"""MLA in the port — deepseek-v2-lite-16b's path (latent cache, shared
experts, dense first layer) and deepseek-v3's q-LoRA branch — against the
reference on the CPU, at ``reduced()`` sizes: the plain version of the
MLA decode kernel (``mla_decode_attention_ref``) against the Pallas kernel
in interpret mode; ``mla_prefill`` / ``mla_decode`` against
``repro.models.mla``; ``prefill``, ``decode_step`` and ``forward`` with
the dense prefix against ``repro.models.model``; and the two
``ElasticServer``s' greedy tokens with dense expert banks and pooled
pages.

Inputs come from numpy with a seed; the reference's parameters reach the
port through ``convert.params_from_jax``.  Tolerances: f32 atol = rtol =
1e-5 wherever XLA and PyTorch compute (sums in other orders: a few ulps);
bit for bit where values are only moved (rows a write drops); greedy
tokens exactly equal.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.elastic_engine import ElasticServer as JaxServer
from repro.core.topology import ElasticConfig as JaxElasticConfig
from repro.kernels import ref as jref
from repro.kernels.mla_decode import mla_decode_attention as jax_mla_decode
from repro.models import mla as JMLA
from repro.models import model as JM
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.hmm import HMM
from repro_torch.core.topology import ElasticConfig
from repro_torch.kernels import mla_decode, ops
from repro_torch.kernels import ref as tref
from repro_torch.models import mla as TMLA
from repro_torch.models import model as TM
from repro_torch.serving.workload import Request
from test_torch_server import _drive, _requests

TOL = dict(atol=1e-5, rtol=1e-5)
MODELS = ["deepseek-v2-lite-16b-smoke", "deepseek-v3-smoke"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pallas_scale(r, dr):
    """The scale the Pallas kernel and its oracle derive from the shapes
    (``mla_decode.py:86``, ``ref.py:171``)."""
    return 1.0 / math.sqrt((128 if r >= 128 else r) + dr)


# ------------------------------------------------- plain version vs Pallas

MLA_CASES = {
    # B, H, r, dr, S, lengths
    "reduced-one-to-full": (3, 4, 64, 16, 256, [1, 100, 256]),
    "reduced-block-edges": (3, 4, 64, 16, 256, [128, 129, 7]),
    "full-width": (2, 2, 512, 64, 128, [128, 37]),
}


def _mla_inputs(seed, B, H, r, dr, S):
    rng = np.random.default_rng(seed)
    return (_normal(rng, B, H, r), _normal(rng, B, H, dr),
            _normal(rng, B, S, r), _normal(rng, B, S, dr))


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_mla_decode_ref_matches_pallas(case):
    """At the Pallas kernel's own scale (its formula: r < 128 and r >=
    128 both run)."""
    B, H, r, dr, S, lengths = MLA_CASES[case]
    qe, qr, c, kr = _mla_inputs(0, B, H, r, dr, S)
    lens = np.array(lengths, np.int32)
    want = jax_mla_decode(qe, qr, c, kr, lens, interpret=True)
    got = tref.mla_decode_attention_ref(_t(qe), _t(qr), _t(c), _t(kr),
                                        _t(lens), _pallas_scale(r, dr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_decode_ref_gives_zeros_at_length_zero_like_pallas():
    """A length of 0: the Pallas kernel skips every block and returns
    zeros, and so does the port; the reference's oracle takes a softmax
    over a row of -1e30 and returns the mean of ``c`` instead."""
    B, H, r, dr, S = 2, 4, 64, 16, 128
    qe, qr, c, kr = _mla_inputs(1, B, H, r, dr, S)
    lens = np.array([0, 50], np.int32)
    scale = _pallas_scale(r, dr)
    want = np.asarray(jax_mla_decode(qe, qr, c, kr, lens, interpret=True))
    got = tref.mla_decode_attention_ref(_t(qe), _t(qr), _t(c), _t(kr),
                                        _t(lens), scale).numpy()
    assert not got[0].any() and not want[0].any()
    np.testing.assert_allclose(got, want, **TOL)
    oracle = np.asarray(jref.mla_decode_attention_ref(qe, qr, c, kr, lens))
    np.testing.assert_allclose(oracle[0], np.broadcast_to(
        c[0].mean(0), (H, r)), **TOL)


def test_mla_decode_ref_at_a_ragged_length_matches_the_oracle():
    """S = 200, which the Pallas kernel's 128-row blocks refuse: held
    against the reference's oracle at its scale, lengths past S clamped
    as the oracle's mask clamps them."""
    B, H, r, dr, S = 3, 4, 64, 16, 200
    qe, qr, c, kr = _mla_inputs(2, B, H, r, dr, S)
    lens = np.array([200, 1, 201], np.int32)
    with pytest.raises(AssertionError):
        jax_mla_decode(qe, qr, c, kr, lens, interpret=True)
    got = tref.mla_decode_attention_ref(_t(qe), _t(qr), _t(c), _t(kr),
                                        _t(lens), _pallas_scale(r, dr))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.mla_decode_attention_ref(qe, qr, c, kr, lens)), **TOL)


def test_mla_cpu_tensors_run_the_plain_version_and_count_no_launch():
    qe, qr, c, kr = (_t(a) for a in _mla_inputs(3, 2, 4, 64, 16, 32))
    lens = torch.tensor([3, 32], dtype=torch.int32)
    ops.reset_launch_counts()
    got = ops.mla_decode_attention(qe, qr, c, kr, lens, 0.1)
    assert torch.equal(got, tref.mla_decode_attention_ref(qe, qr, c, kr,
                                                          lens, 0.1))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    with pytest.raises(ValueError, match="CUDA kernel"):
        mla_decode.mla_decode_attention(qe, qr, c, kr, lens, 0.1)
    assert ops.launch_counts()["mla_decode_attention"] == 0


# ------------------------------------------------ layers and the model


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(reference config, reference dense-bank params, port config, port
    params) for a reduced MLA config: deepseek-v2-lite (full-rank q, one
    dense layer, one MoE layer, a shared expert) and deepseek-v3
    (q-LoRA)."""
    jcfg = jax_config(request.param)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, get_config(request.param), params_from_jax(jp)


def test_converted_params_keep_the_reference_tree(model):
    """The MLA pytree converts leaf for leaf: the attention leaves of each
    q branch, the ``dense_prefix`` list and the shared experts."""
    jcfg, jp, cfg, tp = model
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert tdef == jdef and len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.numpy(), a)
    assert isinstance(tp["dense_prefix"], list)
    want = {"q_down", "q_norm", "q_up"} if cfg.q_lora_rank else {"q"}
    assert set(tp["blocks"]["attn"]) == want | {"kv_down", "kv_norm", "k_up",
                                                "v_up", "o"}
    assert "shared" in tp["blocks"]["moe"]


def test_mla_prefill_matches_reference(model):
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(4)
    B, S = 2, 12
    x = _normal(rng, B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    ja = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    ta = TM.layer_params(tp["blocks"]["attn"], 0)
    jy, (jc, jkr) = JMLA.mla_prefill(jcfg, ja, x, pos)
    ty, (tc, tkr) = TMLA.mla_prefill(cfg, ta, _t(x), _t(pos))
    for got, want in ((ty, jy), (tc, jc), (tkr, jkr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_decode_matches_reference(model):
    """Absorbed decode over the latent cache at the model's scale
    ``1/sqrt(dn+dr)`` (1/sqrt(48) here, where the Pallas kernel's formula
    gives 1/sqrt(80)); the last slot is full, so its write drops."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(5)
    B, S_max = 3, 32
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    assert 1 / math.sqrt(cfg.qk_nope_dim + dr) != _pallas_scale(r, dr)
    x = _normal(rng, B, 1, cfg.d_model)
    c, kr = _normal(rng, B, S_max, r), _normal(rng, B, S_max, dr)
    lengths = np.array([3, 31, 32], np.int32)
    pos = lengths[:, None]
    ja = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    ta = TM.layer_params(tp["blocks"]["attn"], 0)
    jy, (jc, jkr) = JMLA.mla_decode(jcfg, ja, x, pos,
                                    (jnp.asarray(c), jnp.asarray(kr)),
                                    lengths, lengths + 1)
    tc, tkr = _t(c), _t(kr)
    ty, (tc2, tkr2) = TMLA.mla_decode(cfg, ta, _t(x), _t(pos), (tc, tkr),
                                      _t(lengths), _t(lengths + 1))
    assert tc2 is tc and tkr2 is tkr                  # written in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for got, want, old in ((tc, jc, c), (tkr, jkr, kr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(got[2].numpy(), old[2])   # dropped


@pytest.mark.parametrize("lengths", [[24, 17], [9, 24]])
def test_prefill_with_the_dense_prefix(model, lengths):
    """Two prompts padded to 24 tokens through the dense layer and the
    MoE layer; the latent cache padded to max_len 40 with zeros, the
    prefix layer's rows first."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(sum(lengths))
    B, S, max_len = 2, 24, 40
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array(lengths, np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": tokens, "lengths": lens},
                        max_len)
    tl, tc = TM.prefill(cfg, tp, {"tokens": _t(tokens), "lengths": _t(lens)},
                        max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tc) == set(jc) == {"c", "kr"}
    for n in ("c", "kr"):
        assert tuple(tc[n].shape) == jc[n].shape
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)
        assert not tc[n][:, :, S:].any()


def test_decode_step_with_the_dense_prefix(model):
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(8)
    B, max_len, L = 4, 48, cfg.num_layers
    cache = {"c": _normal(rng, L, B, max_len, cfg.kv_lora_rank),
             "kr": _normal(rng, L, B, max_len, cfg.qk_rope_dim)}
    lengths = np.array([5, 17, 47, 48], np.int32)    # the last write drops
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc = JM.decode_step(jcfg, jp, tokens,
                            jax.tree.map(jnp.asarray, cache), lengths)
    tc = {n: _t(a) for n, a in cache.items()}
    tl, tc = TM.decode_step(cfg, tp, _t(tokens), tc, _t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("c", "kr"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)
        np.testing.assert_array_equal(tc[n][:, 3].numpy(), cache[n][:, 3])


def test_forward_with_the_dense_prefix(model):
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    jl, _ = JM.forward(jcfg, jp, {"tokens": tokens}, remat=False)
    tl = TM.forward(cfg, tp, {"tokens": _t(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "deepseek-v3",
                                  *MODELS])
def test_param_count_equals_the_reference(name):
    assert get_config(name).param_count() == jax_config(name).param_count()
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        jax_config(name))


# ------------------------------------------------------------------ servers

SERVER_KW = dict(tp=1, batch_per_replica=4, max_len=128, seed=0,
                 prefill_buckets=(32, 64, 96))


def _mcfg(port, capacity_factor):
    cfg = (get_config if port else jax_config)("deepseek-v2-lite-16b-smoke")
    return dataclasses.replace(cfg, capacity_factor=capacity_factor)


@pytest.mark.parametrize("cf", [100.0, 1.25], ids=["cf100", "cf1.25"])
@pytest.mark.parametrize("expert_mode", ["dense", "pooled"])
def test_server_tokens_equal_reference(expert_mode, cf):
    """The "mixed" requests (4 slots for 6 requests; one whose first token
    is its only one) through both servers on deepseek-v2-lite-smoke, each
    booted on the reference's parameters: dense latent KV, monolithic
    prefill, the expert store given.  The greedy tokens must be equal.  At
    capacity factor 1.25 padding tokens of a prefill take capacity slots
    and drop real ones, as in the reference."""
    kw = dict(SERVER_KW, expert_mode=expert_mode)
    jsrv = JaxServer(_mcfg(False, cf), **kw)
    jsrv.boot(JaxElasticConfig(1, 1, (0,)))
    params = jax.tree.map(np.asarray, jsrv.engine.params)
    _drive(jsrv, _requests("mixed"), JaxRequest)
    srv = ElasticServer(_mcfg(True, cf), device="cpu", **kw)
    srv.boot(ElasticConfig(1, 1, (0,)), params=params_from_jax(params))
    _drive(srv, _requests("mixed"), Request)
    got, want = srv.engine.generated, jsrv.engine.generated
    assert got == want
    assert len(got[3]) == 1
    eng = srv.engine
    assert set(eng.cache) == {"c", "kr"} and eng.kv_stats() is None
    L_moe = 1                                   # one dense layer first
    if expert_mode == "pooled":
        assert tuple(eng.params["blocks"]["moe"]["gtable"].shape) == (L_moe,
                                                                      4)
        assert "wi" not in eng.params["blocks"]["moe"]
    else:
        assert eng.params["blocks"]["moe"]["wi"].shape[0] == L_moe
    assert "moe" not in eng.params["dense_prefix"][0]


@pytest.mark.parametrize("expert_mode", ["dense", "pooled"])
def test_hmm_boots_mla_stores(expert_mode):
    """The HMM's own draw: the latent cache [L, B, max_len, r|dr], and
    the expert store over the L - first_k_dense MoE layers only (the dense
    layer holds no expert pages)."""
    cfg = get_config("deepseek-v2-lite-16b-smoke")
    hmm = HMM(cfg, 1, batch_per_replica=2, max_len=64,
              expert_mode=expert_mode, device="cpu")
    hmm.boot(ElasticConfig(1, 1, (0,)))
    L, E = cfg.num_layers, cfg.num_experts
    assert {n: tuple(t.shape) for n, t in hmm.cache.items()} == {
        "c": (L, 2, 64, cfg.kv_lora_rank), "kr": (L, 2, 64, cfg.qk_rope_dim)}
    if expert_mode == "pooled":
        assert hmm.params["moe_pool"]["wi"].shape[0] == (L - 1) * E
    else:
        assert hmm.params["blocks"]["moe"]["wi"].shape[:2] == (L - 1, E)


def test_mla_refuses_paged_kv_and_chunked_prefill():
    """As the reference asserts (``paged_cache_supported`` and
    ``chunk_prefill_supported`` exclude MLA)."""
    cfg = get_config("deepseek-v2-lite-16b-smoke")
    with pytest.raises(ValueError, match="paged KV"):
        HMM(cfg, 1, batch_per_replica=2, max_len=64, kv_mode="paged",
            device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        ElasticServer(cfg, **SERVER_KW, prefill_chunk=32, device="cpu")
    with pytest.raises(ValueError, match="paged KV"):
        TM.init_paged_cache(cfg, 4, 16, device="cpu")
