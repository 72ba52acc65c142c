"""Mamba2 in the port — mamba2-1.3b's attention-free path and zamba2-2.7b's
hybrid path (one shared attention block at the head of each group of SSD
layers) — against the reference on the CPU, at ``reduced()`` sizes (2
layers, d_model 256, N 16, P 32, chunk 16): the plain version of the SSD
chunk scan (``ssd_scan_ref``) against the Pallas kernel in interpret mode,
the reference's sequential oracle and the model's ``_ssd_chunked``;
``mamba2_forward`` / ``mamba2_decode`` against ``repro.models.mamba2``;
``prefill``, ``decode_step`` and ``forward`` against ``repro.models.model``;
and the two ``ElasticServer``s' greedy tokens with the reference's default
knobs.

Inputs come from numpy with a seed; the reference's parameters reach the
port through ``convert.params_from_jax``.  Tolerances: f32 atol = rtol =
1e-5 wherever XLA and PyTorch compute (sums in other orders: a few ulps),
except where a case states why it needs more; the sequential oracle at the
reference's own 2e-4 (a sequential and a chunked scan round differently);
greedy tokens exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.elastic_engine import ElasticServer as JaxServer
from repro.core.topology import ElasticConfig as JaxElasticConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro.serving.workload import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.hmm import HMM
from repro_torch.core.topology import ElasticConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba2 as TM2
from repro_torch.models import model as TM
from repro_torch.serving.workload import Request
from test_torch_server import _drive, _requests

TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = dict(atol=2e-4, rtol=2e-4)
# the hybrid's steps: four blocks (attention + MLP, SSD, attention + MLP,
# SSD), each 2e-6 to 5e-6 from XLA's alone at |x| up to 5, leave the
# second group's K/V rows and logits of up to |4.2| 1e-5 to 2e-5 apart
HYBRID_TOL = dict(atol=5e-5, rtol=1e-5)
MODELS = ["mamba2-1.3b-smoke", "zamba2-2.7b-smoke"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------- plain version vs Pallas

SSD_CASES = {
    # B, S, H, P, N, chunk, atol: the three shapes of the reference's own
    # kernel test, and zamba2's H = 80, P = 64, N = 64, chunk 128, whose
    # y reaches |45|: sums of 128 products that large round 4e-5 apart in
    # another order, so atol 1e-4 there (about 2 ulps of the largest y)
    "ref-b2-s128-c32": (2, 128, 4, 32, 16, 32, 1e-5),
    "ref-b1-s256-c64": (1, 256, 2, 64, 64, 64, 1e-5),
    "ref-b2-s64-c16": (2, 64, 8, 16, 8, 16, 1e-5),
    "zamba2-h80-c128": (1, 256, 80, 64, 64, 128, 1e-4),
}


def _ssd_inputs(seed, B, S, H, P, N):
    """The reference test's distributions: dt in [0.01, 0.51], A in
    [-1.5, -0.5]."""
    rng = np.random.default_rng(seed)
    return (_normal(rng, B, S, H, P),
            (rng.random((B, S, H)) * 0.5 + 0.01).astype(np.float32),
            -(rng.random(H) + 0.5).astype(np.float32),
            _normal(rng, B, S, N), _normal(rng, B, S, N))


def _ref(inputs, chunk):
    y, s = tref.ssd_scan_ref(*(_t(a) for a in inputs), chunk)
    return y.numpy(), s.numpy()


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_scan_ref_matches_pallas(case):
    *shape, chunk, atol = SSD_CASES[case]
    inputs = _ssd_inputs(0, *shape)
    wy, ws = jops.ssd_scan(*inputs, chunk=chunk, interpret=True)
    y, s = _ref(inputs, chunk)
    np.testing.assert_allclose(y, np.asarray(wy), atol=atol, rtol=1e-5)
    np.testing.assert_allclose(s, np.asarray(ws), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_scan_ref_matches_the_oracles(case):
    """The sequential recurrence at the reference's 2e-4, and the model's
    own chunked scan (``_ssd_chunked``, what ``mamba2_forward`` runs in the
    reference) at the Pallas case's tolerance."""
    *shape, chunk, atol = SSD_CASES[case]
    inputs = _ssd_inputs(1, *shape)
    y, s = _ref(inputs, chunk)
    oy, os_ = jref.ssd_scan_ref(*inputs)
    np.testing.assert_allclose(y, np.asarray(oy), **ORACLE_TOL)
    np.testing.assert_allclose(s, np.asarray(os_), **ORACLE_TOL)
    cy, cs = JM2._ssd_chunked(*inputs, chunk)
    np.testing.assert_allclose(y, np.asarray(cy), atol=atol, rtol=1e-5)
    np.testing.assert_allclose(s, np.asarray(cs), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("S,chunk", [(40, 16), (7, 16), (100, 32)])
def test_ssd_scan_ref_at_a_ragged_length_matches_the_oracle(S, chunk):
    """S not a multiple of the chunk, which the Pallas kernel and the
    model's ``_ssd_chunked`` refuse: the port pads the last chunk with
    dt = 0 and x = 0 rows (decay 1, no input) and matches the sequential
    recurrence; S below the chunk is one chunk of S rows."""
    inputs = _ssd_inputs(2, 2, S, 4, 32, 16)
    if S > chunk:
        with pytest.raises(AssertionError):
            jops.ssd_scan(*inputs, chunk=chunk, interpret=True)
        with pytest.raises(AssertionError, match="not divisible"):
            JM2._ssd_chunked(*inputs, chunk)
    y, s = _ref(inputs, chunk)
    assert y.shape == (2, S, 4, 32) and s.shape == (2, 4, 16, 32)
    oy, os_ = jref.ssd_scan_ref(*inputs)
    np.testing.assert_allclose(y, np.asarray(oy), **ORACLE_TOL)
    np.testing.assert_allclose(s, np.asarray(os_), **ORACLE_TOL)


# the chunk-parallel decomposition of the card's tensor-core instance
# (B, S, H, P, N, chunk): 1, 3 and 8 chunks, and a ragged last chunk
DECOMP_CASES = {
    "1-chunk": (2, 16, 4, 32, 16, 16),
    "3-chunks": (2, 48, 4, 32, 16, 16),
    "8-chunks": (2, 128, 4, 32, 16, 16),
    "ragged-s40": (2, 40, 4, 32, 16, 16),
}


def _split_bf16(t):
    """An f32 operand as the kernel feeds it to the tensor cores: its bf16
    rounding plus the bf16 rounding of what that left."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float()


def _ssd_chunk_parallel(x, dt, A, Bm, Cm, chunk, split=lambda t: t):
    """``csrc/ssd_scan.cu``'s tensor-core instance in plain f32: (1) C·Bᵀ
    once per (sequence, chunk); (2) every chunk's own state input S_c =
    (B ∘ exp(acs[-1] - acs) ∘ dt)ᵀ x at once; (3) the states passed in
    chunk order, h_{c+1} = h_c exp(acs_c[-1]) + S_c; (4) every chunk's
    rows at once, y = exp(acs) ∘ (C h_c) + (C·Bᵀ ∘ exp(acs_i - acs_j)[i >=
    j] ∘ dt_j) x.  ``split`` is applied to the three f32 operands the
    kernel splits into bf16 parts (the weighted B, h_c and M)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):         # [B,S,...] f32, zero-padded -> [B,nc,Q,...]
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((Bsz, pad, *t.shape[2:]))], 1)
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    xc, dtc, bc, cc = chunks(x), chunks(dt), chunks(Bm), chunks(Cm)
    acs = torch.cumsum(dtc * A.float(), dim=2)                # [B,nc,Q,H]
    last = acs[:, :, -1]                                      # [B,nc,H]
    low = torch.ones(Q, Q, dtype=torch.bool).tril()
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc) * low        # phase 1
    w = torch.exp(last[:, :, None] - acs) * dtc               # phase 2
    s_c = torch.einsum("bcjhn,bcjhp->bchnp",
                       split(bc[:, :, :, None] * w[..., None]), xc)
    h = torch.zeros(Bsz, H, N, P)                             # phase 3
    hs = []
    for c in range(nc):
        hs.append(h)
        h = h * torch.exp(last[:, c])[:, :, None, None] + s_c[:, c]
    hc = torch.stack(hs, 1)                                   # [B,nc,H,N,P]
    y_off = torch.exp(acs)[..., None] * torch.einsum(        # phase 4
        "bcin,bchnp->bcihp", cc, split(hc))
    seg = acs[:, :, :, None] - acs[:, :, None, :]             # [B,nc,i,j,H]
    L = torch.exp(torch.where(low[None, None, :, :, None], seg,
                              float("-inf")))
    M = cb[..., None] * L * dtc[:, :, None]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", split(M), xc)
    y = (y_off + y_diag).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y, h


@pytest.mark.parametrize("case", sorted(DECOMP_CASES))
def test_ssd_chunk_parallel_decomposition_matches_pallas_and_plain(case):
    """The four phases of the card's chunk-parallel scan, transcribed in
    plain f32, against the Pallas kernel (interpret mode; it refuses a
    ragged S, so that case meets the plain version alone) and the port's
    plain version, at the reference shapes' tolerance (atol = rtol =
    1e-5): the state passing carries each chunk's state exactly as the
    sequential scan does."""
    *shape, chunk = DECOMP_CASES[case]
    inputs = _ssd_inputs(3, *shape)
    y, s = _ssd_chunk_parallel(*(_t(a) for a in inputs), chunk)
    wy, ws = _ref(inputs, chunk)
    np.testing.assert_allclose(y.numpy(), wy, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), ws, atol=1e-5, rtol=1e-5)
    if shape[1] % chunk == 0:
        py, ps = jops.ssd_scan(*inputs, chunk=chunk, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(py), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(ps), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", sorted(DECOMP_CASES))
def test_ssd_hi_lo_split_keeps_the_card_tolerance(case):
    """The same phases with the weighted B, h_c and M each fed as two
    bf16 parts (x, B and C rounded to bf16 as the served model stores
    them) stay within the card's SSD tolerance (atol = rtol = 1e-3) of
    the plain version on the same bf16 inputs (about 2e-5 off here); one
    bf16 part alone (2^-9 of each entry) is 3e-2 off and fails."""
    *shape, chunk = DECOMP_CASES[case]
    x, dt, A, Bm, Cm = (_t(a) for a in _ssd_inputs(4, *shape))
    x, Bm, Cm = (t.bfloat16() for t in (x, Bm, Cm))
    y, s = _ssd_chunk_parallel(x, dt, A, Bm, Cm, chunk, split=_split_bf16)
    wy, ws = tref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    torch.testing.assert_close(y, wy, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(s, ws, atol=1e-3, rtol=1e-3)


# ------------------------------------------------ layers and the model


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(reference config, reference params, port config, port params) for
    a reduced Mamba2 config: mamba2-1.3b (2 SSD layers) and zamba2-2.7b (2
    groups of one SSD layer, each led by the shared attention block)."""
    jcfg = jax_config(request.param)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, get_config(request.param), params_from_jax(jp)


def test_converted_params_keep_the_reference_tree(model):
    """The SSD blocks stay stacked; the hybrid's shared block stays one
    unstacked block."""
    jcfg, jp, cfg, tp = model
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert tdef == jdef and len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.numpy(), a)
    assert tp["blocks"]["ssm"]["in_proj"]["w"].shape[0] == cfg.num_layers
    if cfg.arch_type == "hybrid":
        assert tp["shared_attn"]["attn"]["q"]["w"].dim() == 2


def test_port_init_params_has_the_reference_tree(model):
    """The port's own draw (another generator's numbers) in the
    reference's tree and shapes."""
    jcfg, jp, cfg, _ = model
    mine = TM.init_params(cfg, 0, device="cpu")
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(mine)
    assert tdef == jdef
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape and str(b.dtype)[6:] == str(a.dtype)


def _block0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"]),
            TM.layer_params(tp["blocks"]["ssm"], 0))


@pytest.mark.parametrize("S", [32, 2])
def test_mamba2_forward_matches_reference(model, S):
    """Output, conv tail (S = 2 is shorter than the conv's K - 1 = 3 rows:
    zeros in front) and final state."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(S)
    x = _normal(rng, 2, S, cfg.d_model)
    jb, tb = _block0(jp, tp)
    jy, jc = JM2.mamba2_forward(jcfg, jb, x, return_cache=True)
    ty, tc = TM2.mamba2_forward(cfg, tb, _t(x), return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(tc) == set(jc) == {"conv", "state"}
    for n in tc:
        assert tuple(tc[n].shape) == jc[n].shape
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)
    np.testing.assert_allclose(
        TM2.mamba2_forward(cfg, tb, _t(x)).numpy(), ty.numpy(), **TOL)


def test_mamba2_decode_matches_reference(model):
    """Three recurrent steps from the cache a 32-token forward leaves."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(5)
    x = _normal(rng, 3, 32, cfg.d_model)
    jb, tb = _block0(jp, tp)
    _, jc = JM2.mamba2_forward(jcfg, jb, x, return_cache=True)
    _, tc = TM2.mamba2_forward(cfg, tb, _t(x), return_cache=True)
    for step in range(3):
        xt = _normal(rng, 3, 1, cfg.d_model)
        jy, jc = JM2.mamba2_decode(jcfg, jb, xt, jc)
        ty, tc = TM2.mamba2_decode(cfg, tb, _t(xt), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for n in ("conv", "state"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **TOL)


def test_the_model_step_runs_ssd_scan(model, monkeypatch):
    """``mamba2_forward`` scans through ``ops.ssd_scan``, once per SSD
    layer of a prefill, and a decode step does not."""
    jcfg, jp, cfg, tp = model
    calls = []
    real = ops.ssd_scan
    monkeypatch.setattr(ops, "ssd_scan",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), dtype=torch.int32)
    _, cache = TM.prefill(cfg, tp, {"tokens": tokens}, 32)
    assert len(calls) == cfg.num_layers
    TM.decode_step(cfg, tp, tokens[:, :1], cache,
                   torch.tensor([16], dtype=torch.int32))
    assert len(calls) == cfg.num_layers


def _step_tol(cfg):
    return HYBRID_TOL if cfg.arch_type == "hybrid" else TOL


def _cache_leaves(cfg):
    return {"conv", "state"} | ({"attn_k", "attn_v"}
                                if cfg.arch_type == "hybrid" else set())


@pytest.mark.parametrize("lengths", [[32, 17], [9, 32]])
def test_prefill_logits_and_cache(model, lengths):
    """Two prompts padded to 32 tokens (two chunks; the reference refuses a
    length that is no multiple of its chunk): logits at lengths - 1; every
    cache leaf equal, the SSD state and conv tail after all 32 tokens
    (padding included, as the reference computes them); the hybrid's K/V
    rows padded to max_len 40 with zeros."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(sum(lengths))
    B, S, max_len = 2, 32, 40
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array(lengths, np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": tokens, "lengths": lens},
                        max_len)
    tl, tc = TM.prefill(cfg, tp, {"tokens": _t(tokens), "lengths": _t(lens)},
                        max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **_step_tol(cfg))
    assert set(tc) == set(jc) == _cache_leaves(cfg)
    for n in tc:
        assert tuple(tc[n].shape) == jc[n].shape
        assert str(tc[n].dtype)[6:] == str(jc[n].dtype)
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   **_step_tol(cfg))
    if cfg.arch_type == "hybrid":
        assert not tc["attn_k"][:, :, S:].any()


def test_decode_step_logits_and_cache(model):
    """Four slots from random caches; the hybrid's shared block writes at
    ``lengths % max_len`` (the last slot, at max_len, wraps to row 0) and
    attends min(lengths + 1, max_len) rows."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(8)
    B, max_len = 4, 48
    shapes = {n: tuple(t.shape) for n, t in
              TM.init_cache(cfg, B, max_len, device="cpu").items()}
    cache = {n: _normal(rng, *s) for n, s in shapes.items()}
    lengths = np.array([5, 17, 47, 48], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jc = JM.decode_step(jcfg, jp, tokens,
                            jax.tree.map(jnp.asarray, cache), lengths)
    tc = {n: _t(a) for n, a in cache.items()}
    tl, tc2 = TM.decode_step(cfg, tp, _t(tokens), tc, _t(lengths))
    assert tc2 is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **_step_tol(cfg))
    assert set(tc) == set(jc) == _cache_leaves(cfg)
    for n in tc:
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   **_step_tol(cfg))


def test_forward_logits(model):
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab_size, (3, 48)).astype(np.int32)
    jl, _ = JM.forward(jcfg, jp, {"tokens": tokens}, remat=False)
    tl = TM.forward(cfg, tp, {"tokens": _t(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **_step_tol(cfg))


# the hybrid with groups of several SSD layers: the shared block's K/V
# rows and the logits pass up to 12 blocks, each a few ulps from XLA's
ATTN_EVERY_TOL = {"logits": dict(atol=5e-5, rtol=1e-5),
                  "attn_k": dict(atol=5e-5, rtol=1e-5),
                  "attn_v": dict(atol=5e-5, rtol=1e-5),
                  "conv": dict(atol=5e-5, rtol=1e-5),
                  "state": dict(atol=2e-4, rtol=1e-5)}


@pytest.mark.parametrize("layers,attn_every", [(4, 2), (6, 2), (6, 3),
                                               (6, 6)])
def test_hybrid_groups_of_several_ssd_layers(layers, attn_every):
    """zamba2-2.7b reduced, but with ``attn_every`` > 1 (the full model
    has groups of 6; ``reduced()`` sets 1): a prefill of two prompts and
    three decode steps against the reference at f32, every cache leaf
    after each.  Tolerances: logits and the shared block's K/V rows 5e-5,
    the SSD state 2e-4 (its sums run over the whole prompt)."""
    jcfg = dataclasses.replace(jax_config("zamba2-2.7b-smoke"),
                               num_layers=layers, attn_every=attn_every)
    cfg = dataclasses.replace(get_config("zamba2-2.7b-smoke"),
                              num_layers=layers, attn_every=attn_every)
    jp = jax.tree.map(np.asarray,
                      JM.init_params(jcfg, jax.random.PRNGKey(layers)))
    tp = params_from_jax(jp)
    rng = np.random.default_rng(10 * layers + attn_every)
    B, S, max_len = 2, 32, 40
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([32, 17], np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": tokens, "lengths": lens},
                        max_len)
    tl, tc = TM.prefill(cfg, tp, {"tokens": _t(tokens), "lengths": _t(lens)},
                        max_len)
    assert tc["attn_k"].shape[0] == layers // attn_every

    def check(tl, jl, tc, jc):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **ATTN_EVERY_TOL["logits"])
        assert set(tc) == set(jc) == _cache_leaves(cfg)
        for n in tc:
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **ATTN_EVERY_TOL[n])

    check(tl, jl, tc, jc)
    for i in range(3):
        step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = JM.decode_step(jcfg, jp, step, jc, lens + i)
        tl, tc = TM.decode_step(cfg, tp, _t(step), tc, _t(lens + i))
        check(tl, jl, tc, jc)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "zamba2-2.7b", *MODELS])
def test_param_count_and_config_equal_the_reference(name):
    assert get_config(name).param_count() == jax_config(name).param_count()
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        jax_config(name))
    for prop in ("ssm_heads", "d_inner", "is_attention_free"):
        assert getattr(get_config(name), prop) == getattr(jax_config(name),
                                                          prop)


# ------------------------------------------------------------------ servers

SERVER_KW = dict(tp=1, batch_per_replica=4, max_len=128, seed=0,
                 prefill_buckets=(32, 64, 96))


@pytest.mark.parametrize("name", MODELS)
def test_server_tokens_equal_reference(name):
    """The "mixed" requests (4 slots for 6 requests; one whose first token
    is its only one) through both servers with the reference's default
    knobs, each booted on the reference's parameters.  Prompts are padded
    to a multiple of 32 and the SSD state runs over the padding, as in the
    reference.  The greedy tokens must be equal."""
    jsrv = JaxServer(jax_config(name), **SERVER_KW)
    jsrv.boot(JaxElasticConfig(1, 1, (0,)))
    params = jax.tree.map(np.asarray, jsrv.engine.params)
    _drive(jsrv, _requests("mixed"), JaxRequest)
    cfg = get_config(name)
    srv = ElasticServer(cfg, device="cpu", **SERVER_KW)
    srv.boot(ElasticConfig(1, 1, (0,)), params=params_from_jax(params))
    _drive(srv, _requests("mixed"), Request)
    got, want = srv.engine.generated, jsrv.engine.generated
    assert got == want
    assert len(got[3]) == 1
    eng = srv.engine
    assert set(eng.cache) == _cache_leaves(cfg) and eng.kv_stats() is None
    assert eng.cache["state"].dtype == torch.float32


@pytest.mark.parametrize("name", MODELS)
def test_hmm_boots_the_ssm_caches(name):
    """The HMM's own draw: per-slot conv tails and f32 SSD states for
    every layer, and for the hybrid the shared block's K/V rows per
    group."""
    cfg = get_config(name)
    hmm = HMM(cfg, 1, batch_per_replica=2, max_len=64, device="cpu")
    hmm.boot(ElasticConfig(1, 1, (0,)))
    L, C = cfg.num_layers, cfg.d_inner + 2 * cfg.ssm_state
    want = {"conv": (L, 2, cfg.ssm_conv - 1, C),
            "state": (L, 2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)}
    if cfg.arch_type == "hybrid":
        kv = (L // cfg.attn_every, 2, 64, cfg.num_kv_heads,
              cfg.resolved_head_dim)
        want.update(attn_k=kv, attn_v=kv)
    assert {n: tuple(t.shape) for n, t in hmm.cache.items()} == want
    assert "shared_attn" in hmm.params or cfg.arch_type == "ssm"


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("knobs,error", [
    (dict(kv_mode="paged"), "paged KV"),
    (dict(prefill_chunk=32), "chunked prefill"),
    (dict(expert_mode="pooled"), "MoE model"),
], ids=["paged", "chunked", "pooled"])
def test_ssm_models_refuse_what_the_reference_refuses(name, knobs, error):
    """As the reference asserts: the Mamba2 models keep a per-slot state,
    so no paged KV and no chunked prefill, and have no experts to pool."""
    with pytest.raises(ValueError, match=error):
        ElasticServer(get_config(name), **SERVER_KW, **knobs, device="cpu")
    if "prefill_chunk" not in knobs:
        with pytest.raises(ValueError, match=error):
            HMM(get_config(name), 1, batch_per_replica=2, max_len=64,
                device="cpu", **knobs)
