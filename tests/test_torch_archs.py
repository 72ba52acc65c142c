"""The last architectures of the reference against the port, on the CPU at
f32: llama-3.2-vision-11b (the VLM: a cross-attention block leading every
group of ``cross_attn_every`` layers), hubert-xlarge (the encoder: a
non-causal forward over frame embeddings) and the sliding window
(``attn_window``, which the reference's dry run sets) over a dense decoder
and ``TEST_MOE``.

Every case runs the reference's ``repro.models.model`` in this process on
its own parameters (``init_params`` with seed 0, ``convert.params_from_
jax``) and the same numpy inputs; logits and every cache leaf agree within
atol = rtol = 1e-5 (the two frameworks sum in other orders), greedy tokens
exactly.  The VLM's cross gates ``xgate`` are set to 0.5 in the numpy tree
before both packages load it: the reference initialises them to zero, and
``tanh(0) = 0`` would hide the cross-attention entirely.

The window cases decode through L = W - 1, W, 2W - 2, 2W - 1 and beyond:
the reference masks its ring by slot index (``kv_pos = arange(rows)``), so
from L = W on it drops the newest slots, and from L = 2W - 1 on every slot,
where its softmax over equal ``-1e30`` scores gives the uniform mean of v;
the plain versions are pinned against ``repro.models.layers.mha`` there.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from helpers import TEST_MOE
from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ref
from repro_torch.models import model as TM

TOL = dict(atol=1e-5, rtol=1e-5)
NAMES = ["llama-3.2-vision-11b", "hubert-xlarge"]
# the reference's steps, each compiled once per config and shape (an
# eager lax.scan compiles at every call)
JFORWARD = jax.jit(lambda c, p, b: JM.forward(c, p, b)[0], static_argnums=0)
JPREFILL = jax.jit(JM.prefill, static_argnums=(0, 3))
JDECODE = jax.jit(JM.decode_step, static_argnums=0)


def _test_moe():
    ns = {}
    exec(TEST_MOE, ns)
    return ns["MCFG"]


def _vlm(layers=2, **kw):
    return dataclasses.replace(jax_config("llama-3.2-vision-11b-smoke"),
                               num_layers=layers, **kw)


def _port(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, xgate=0.5):
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    if "cross_blocks" in jp:
        jp["cross_blocks"]["xgate"] = np.full_like(
            jp["cross_blocks"]["xgate"], xgate)
    return jp, params_from_jax(jp)


def _batch(jcfg, B=2, S=16, seed=0, image=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                    (B, S)).astype(np.int32),
             "lengths": np.array([S, max(1, S - 3)][:B], np.int32)}
    if jcfg.arch_type == "vlm" and image:
        batch["image_embeds"] = rng.standard_normal(
            (B, jcfg.num_image_tokens, jcfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _check_cache(cache, jc):
    assert sorted(cache) == sorted(jc)
    for n in jc:
        assert tuple(cache[n].shape) == tuple(jc[n].shape), n
        _close(cache[n], jc[n])


def _decode_both(jcfg, jp, tp, jc, cache, lengths, steps, seed=1):
    """``steps`` decode steps on both sides from equal caches, random
    tokens; logits and every cache leaf held after each."""
    cfg = _port(jcfg)
    rng = np.random.default_rng(seed)
    L = lengths.copy()
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab_size, (len(L), 1)).astype(np.int32)
        jlg, jc = JDECODE(jcfg, jp, tok, jc, L)
        lg, cache = TM.decode_step(cfg, tp, torch.from_numpy(tok), cache,
                                   torch.from_numpy(L))
        _close(lg, jlg)
        _check_cache(cache, jc)
        L = L + 1
    return L


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name):
    for suffix in ("", "-smoke"):
        got = get_config(name + suffix)
        want = jax_config(name + suffix)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()


# -------------------------------------------------------------------- VLM

@pytest.mark.parametrize("layers", [2, 4], ids=["one-group", "two-groups"])
def test_vlm_steps_and_greedy_tokens_equal_reference(layers):
    """``forward``, ``prefill`` (the cache in the reference's row order:
    each group's cross layer's self k/v, then its self layers'; ``img_k``,
    ``img_v``) and ``decode_step`` within 1e-5, and ten greedy tokens from
    the prefill equal."""
    jcfg = _vlm(layers)
    cfg = _port(jcfg)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg)
    _close(TM.forward(cfg, tp, _torch(batch)),
           JFORWARD(jcfg, jp, batch))
    jlg, jc = JPREFILL(jcfg, jp, batch, 32)
    lg, cache = TM.prefill(cfg, tp, _torch(batch), 32)
    _close(lg, jlg)
    _check_cache(cache, jc)
    assert cache["img_k"].shape[:3] == (layers // 2, 2, 16)
    L = batch["lengths"]
    jt = np.argmax(np.asarray(jlg), -1).astype(np.int32)
    tt = torch.argmax(lg, -1).to(torch.int32)
    jtoks, ttoks = [jt.tolist()], [tt.tolist()]
    for _ in range(9):
        jlg, jc = JDECODE(jcfg, jp, jt[:, None], jc, L)
        lg, cache = TM.decode_step(cfg, tp, tt[:, None], cache,
                                   torch.from_numpy(L))
        _close(lg, jlg)
        jt = np.argmax(np.asarray(jlg), -1).astype(np.int32)
        tt = torch.argmax(lg, -1).to(torch.int32)
        jtoks.append(jt.tolist())
        ttoks.append(tt.tolist())
        L = L + 1
    _check_cache(cache, jc)
    assert ttoks == jtoks


def test_vlm_cross_gate_starts_at_zero():
    """The reference's ``_block_init(cross=True)`` zeroes ``xgate`` and
    the port's ``init_params`` does too: at init the image does not enter
    the output at all, in either package (so a check at init weights
    checks no cross-attention; the tests and the card set the gate)."""
    jcfg = _vlm()
    cfg = _port(jcfg)
    jp, _ = _params(jcfg, xgate=0.0)
    assert not np.any(jp["cross_blocks"]["xgate"])
    own = TM.init_params(cfg, 0, device="cpu")
    assert own["cross_blocks"]["xgate"].shape == (1, 1)
    assert not own["cross_blocks"]["xgate"].any()
    a = _batch(jcfg)
    b = dict(a, image_embeds=a["image_embeds"] * -3.0 + 1.0)
    np.testing.assert_array_equal(TM.forward(cfg, own, _torch(a)).numpy(),
                                  TM.forward(cfg, own, _torch(b)).numpy())
    np.testing.assert_array_equal(np.asarray(JM.forward(jcfg, jp, a)[0]),
                                  np.asarray(JM.forward(jcfg, jp, b)[0]))


def test_vlm_prefill_without_an_image_follows_the_reference():
    """The reference's server prefills a VLM without ``image_embeds``:
    each cross block then attends its own normed input (``kv_x=None``),
    and the image rows of the cache hold the prompt's S rows.  The port's
    ``prefill`` computes the same (its server refuses a VLM instead)."""
    jcfg = _vlm()
    cfg = _port(jcfg)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, S=8, image=False)
    jlg, jc = JPREFILL(jcfg, jp, batch, 32)
    lg, cache = TM.prefill(cfg, tp, _torch(batch), 32)
    _close(lg, jlg)
    _check_cache(cache, jc)
    assert cache["img_k"].shape[2] == 8


def test_vlm_with_a_window_follows_the_reference():
    """A VLM with ``attn_window`` (the dry run's long-context setting):
    the reference's prefill writes ``max_len`` self rows whatever the
    window, decodes over that ring with the window's mask, and masks the
    image rows by the window too; the port computes the same through the
    window's empty range (L = 2W - 1 and past).  A prompt past
    ``max_len`` raises in both."""
    jcfg = _vlm(attn_window=4)
    cfg = _port(jcfg)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, S=8)
    jlg, jc = JPREFILL(jcfg, jp, batch, 16)
    lg, cache = TM.prefill(cfg, tp, _torch(batch), 16)
    _close(lg, jlg)
    _check_cache(cache, jc)
    assert cache["k"].shape[2] == 16
    _decode_both(jcfg, jp, tp, jc, cache, batch["lengths"], 6)
    long = _batch(jcfg, S=24)
    with pytest.raises(ValueError):
        JM.prefill(jcfg, jp, long, 16)
    with pytest.raises(ValueError, match="max_len"):
        TM.prefill(cfg, tp, _torch(long), 16)


# ---------------------------------------------------------------- encoder

def test_encoder_forward_equals_reference():
    """hubert-xlarge's forward (LayerNorm, non-causal, no rope, GELU MLP,
    no embedding: frames in) within 1e-5; it has no decode, in either
    package."""
    jcfg = jax_config("hubert-xlarge-smoke")
    cfg = _port(jcfg)
    jp, tp = _params(jcfg)
    assert "embed" not in tp
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    _close(TM.forward(cfg, tp, {"frames": torch.from_numpy(frames)}),
           JM.forward(jcfg, jp, {"frames": frames})[0])
    with pytest.raises(AssertionError):
        JM.prefill(jcfg, jp, {"tokens": np.zeros((1, 8), np.int32)}, 16)
    with pytest.raises(ValueError, match="encoder-only"):
        TM.prefill(cfg, tp, {"tokens": torch.zeros(1, 8, dtype=torch.int32)},
                   16)


# ----------------------------------------------------------------- window

WINDOWS = {
    "dense-w4-s4": ("dense", 4, 4),
    "dense-w4-s8": ("dense", 4, 8),
    "moe-w8-s8": ("moe", 8, 8),
    "moe-w8-s16": ("moe", 8, 16),
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_windowed_steps_equal_reference(case):
    """Prefill with S <= W and S > W (the ring keeps the last W rows),
    then decode from L = S and max(1, S - 3) through past 2W - 1, every
    step's logits and ring within 1e-5."""
    model, W, S = WINDOWS[case]
    base = (_test_moe() if model == "moe"
            else jax_config("yi-6b-smoke"))
    jcfg = dataclasses.replace(base, attn_window=W)
    cfg = _port(jcfg)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, S=S)
    _close(TM.forward(cfg, tp, _torch(batch)),
           JFORWARD(jcfg, jp, batch))
    jlg, jc = JPREFILL(jcfg, jp, batch, 32)
    lg, cache = TM.prefill(cfg, tp, _torch(batch), 32)
    _close(lg, jlg)
    _check_cache(cache, jc)
    assert cache["k"].shape[2] == W
    L = _decode_both(jcfg, jp, tp, jc, cache, batch["lengths"],
                     2 * W + 2 - int(batch["lengths"].min()))
    assert L.min() > 2 * W


@pytest.mark.parametrize("L", [3, 4, 6, 7, 12])
def test_ring_decode_plain_version_equals_reference_mha(L):
    """The plain decode over a ring of W = 4 slots at L = W - 1, W, 2W -
    2, 2W - 1 and 3W: slots ``[max(0, L - W + 1), min(L + 1, W))``, and,
    where that range is empty (L >= 2W - 1), the uniform mean of all W
    rows of v, as the reference's ``mha`` gives with ``kv_pos =
    arange(W)``."""
    W, B, H, KVH, hd = 4, 2, 4, 2, 16
    rng = np.random.default_rng(L)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, W, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, W, KVH, hd)).astype(np.float32)
    pos = np.full((B, 1), L, np.int32)
    want = JL.mha(q, k, v, q_pos=pos,
                  kv_pos=np.broadcast_to(np.arange(W)[None], (B, W)),
                  causal=True, window=W,
                  kv_valid_len=np.full((B,), min(L + 1, W), np.int32))
    got = ref.paged_decode_attention_ref(
        torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(v),
        torch.full((B,), min(L + 1, W), dtype=torch.int32),
        starts=torch.full((B,), max(0, L - W + 1), dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], **TOL)
    if L >= 2 * W - 1:
        mean = np.repeat(v.mean(1), H // KVH, axis=1)
        np.testing.assert_allclose(got.numpy(), mean, **TOL)


@pytest.mark.parametrize("kind", ["causal-window", "causal-window-long",
                                  "cross", "cross-window"])
def test_flash_plain_version_equals_reference_mha(kind):
    """The plain flash with the new arguments against ``mha``: causal
    over its own S rows with a window (and over 2,048 rows, which both
    take 1,024 at a time); not causal over Skv = 24 other rows (a
    cross-attention), and with a window W = 4 under which rows 27 and up
    attend no key (the uniform mean)."""
    B, H, KVH, hd = 2, 4, 2, 16
    S, Skv, W = {"causal-window": (32, 32, 8),
                 "causal-window-long": (2048, 2048, 300),
                 "cross": (32, 24, None),
                 "cross-window": (32, 24, 4)}[kind]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KVH, hd)).astype(np.float32)
    causal = kind.startswith("causal")
    want = JL.mha(q, k, v,
                  q_pos=np.broadcast_to(np.arange(S)[None], (B, S)),
                  kv_pos=np.broadcast_to(np.arange(Skv)[None], (B, Skv)),
                  causal=causal, window=W)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal, window=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
