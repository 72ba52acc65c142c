"""The port's training path against the reference, on the CPU at f32:
the flash attention's backward (the plain version the card's kernel is
held to) against ``jax.vjp`` of the reference's ``mha``, the autograd
``Function`` around it, ``loss_fn`` and every gradient against
``jax.value_and_grad`` of the reference's ``loss_fn`` (a standard-attention
MoE, an MLA MoE with a shared expert and a dense first layer, a dense
decoder), AdamW, the synthetic stream, checkpoints, the step, the
launcher, and the refusals of what the slice does not train.

Tolerances: atol = 1e-5 and rtol = 1e-4 on the loss and the gradients —
both packages take the same steps at the same rounding points, but XLA
and PyTorch sum in other orders, and a gradient sums over every token of
the batch; the attention backward 1e-5 on unit-scale inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_MOE
from repro.configs import get_config as jax_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro.training import checkpoint as JC
from repro.training import data as JD
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.distributed.sharding import tree_leaves as leaves
from repro_torch.distributed.sharding import tree_leaves_with_path
from repro_torch.kernels import flash_attention_bwd, ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as TC
from repro_torch.training import data as TD
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT

TOL = dict(atol=1e-5, rtol=1e-4)
B, S = 2, 37


def _test_moe():
    ns = {}
    exec(TEST_MOE, ns)
    return ns["MCFG"]


CONFIGS = {
    "test-moe": _test_moe,
    "deepseek-v2-lite-smoke": lambda: jax_reduced(jax_config(
        "deepseek-v2-lite-16b")),
    "qwen1.5-0.5b-smoke": lambda: jax_reduced(jax_config("qwen1.5-0.5b")),
}
JGRAD = jax.jit(jax.value_and_grad(lambda c, p, b: JM.loss_fn(c, p, b),
                                   argnums=1), static_argnums=0)
JFORWARD = jax.jit(lambda c, p, b: JM.forward(c, p, b), static_argnums=0)


def _port(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def items(tree):
    return list(tree_leaves_with_path(tree))


def _batch(cfg, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return b


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _reference(jcfg, jp, mask):
    b = _batch(jcfg, mask=mask)
    loss, grads = JGRAD(jcfg, jp, jax.tree.map(jnp.asarray, b))
    return b, float(loss), _np(grads)


def _model(name, mask=False):
    jcfg = CONFIGS[name]()
    jp = _np(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jp, _port(jcfg), _reference(jcfg, jp, mask)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(reference config, its params as numpy, port config, (batch, the
    reference's loss, its gradients))."""
    return _model(request.param)


@pytest.fixture(scope="module")
def masked():
    """:func:`model` for the test MoE with a ``loss_mask``."""
    return _model("test-moe", mask=True)


def _grad_leaves(cfg, jp, batch, remat):
    tp = params_from_jax(jp)
    ps = leaves(tp)
    for p in ps:
        p.requires_grad_(True)
    loss = TM.loss_fn(cfg, tp, _torch(batch), remat=remat)
    return loss.detach(), torch.autograd.grad(loss, ps,
                                              materialize_grads=True)


def _check_gradients(model, remat):
    jcfg, jp, cfg, (batch, jloss, jgrads) = model
    loss, grads = _grad_leaves(cfg, jp, batch, remat)
    np.testing.assert_allclose(float(loss), jloss, **TOL)
    keys = [k for k, _ in items(jgrads)]
    for key, jg, g in zip(keys, jax.tree.leaves(jgrads), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), err_msg=key,
                                   **TOL)
    assert len(keys) == len(grads)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_equal_reference(model, remat):
    _check_gradients(model, remat)


@pytest.mark.parametrize("remat", [False, True])
def test_masked_loss_and_every_gradient_equal_reference(masked, remat):
    _check_gradients(masked, remat)


def test_aux_loss_equals_reference(model):
    """The routers' load-balance term alone (0 for the dense decoder)."""
    jcfg, jp, cfg, (batch, _, _) = model
    _, jaux = JFORWARD(jcfg, jp, {"tokens": jnp.asarray(batch["tokens"])})
    _, aux = TM.train_forward(cfg, params_from_jax(jp),
                              {"tokens": torch.from_numpy(batch["tokens"])})
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    assert (float(aux) > 0) == cfg.is_moe


def test_serving_forward_keeps_its_return_value(model):
    jcfg, jp, cfg, (batch, _, _) = model
    tokens = torch.from_numpy(batch["tokens"])
    tp = params_from_jax(jp)
    logits = TM.forward(cfg, tp, {"tokens": tokens})
    assert isinstance(logits, torch.Tensor)
    train_logits, _ = TM.train_forward(cfg, tp, {"tokens": tokens})
    assert torch.equal(logits, train_logits)


# ------------------------------------------------------ attention backward

def _qkvo(rng, H, KVH, hd, hdv, dtype=np.float32):
    shapes = ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hdv),
              (B, S, H, hdv))
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


@pytest.mark.parametrize("dims", flash_attention_bwd.HEAD_DIMS, ids=str)
def test_backward_plain_version_equals_jax_vjp_of_mha(dims):
    """GQA H = 4 over KVH = 2, a ragged S = 37; scale 1/sqrt(hd) (the
    reference's, and MLA's 1/sqrt(dn + dr) at (192, 128)).  ``mha`` takes
    v as wide as q: a narrower v is padded with zeros, as the reference's
    MLA pads it, and the output and dv trimmed."""
    hd, hdv = dims
    rng = np.random.default_rng(hd + hdv)
    q, k, v, do = _qkvo(rng, 4, 2, hd, hdv)
    pad = lambda a: np.pad(a, [(0, 0)] * 3 + [(0, hd - hdv)])
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    o_j, vjp = jax.vjp(lambda q, k, v: JL.mha(q, k, v, q_pos=pos,
                                              kv_pos=pos, causal=True),
                       q, k, pad(v))
    dq, dk, dv = vjp(jnp.asarray(pad(do)))
    want = (dq, dk, np.asarray(dv)[..., :hdv])
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    o, lse = ref.flash_attention_lse_ref(tq, tk, tv, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j)[..., :hdv],
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(o, ref.flash_attention_ref(tq, tk, tv, True))
    assert lse.shape == (B, 4, S) and lse.dtype == torch.float32
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse,
                                      torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_lse_plain_version_is_the_rows_logsumexp():
    rng = np.random.default_rng(1)
    q, k, v, _ = _qkvo(rng, 4, 2, 16, 16)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    _, lse = ref.flash_attention_lse_ref(tq, tk, tv, True, 0.3)
    s = torch.einsum("bqkgh,btkh->bkgqt", tq.reshape(B, S, 2, 2, 16),
                     tk) * 0.3
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(B, 4, S))


def test_function_equals_autograd_through_the_plain_version():
    rng = np.random.default_rng(2)
    q, k, v, do = _qkvo(rng, 4, 2, 48, 32)
    got, want = [], []
    for fn, out in ((ops.flash_attention, got),
                    (ref.flash_attention_ref, want)):
        ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
        o = fn(*ts, True, 0.2)
        o.backward(torch.from_numpy(do))
        out += [o.detach()] + [t.grad for t in ts]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


def test_function_gradcheck_f64():
    gen = torch.Generator().manual_seed(0)
    ts = [torch.randn(*s, generator=gen, dtype=torch.float64,
                      requires_grad=True)
          for s in ((1, 9, 4, 8), (1, 9, 2, 8), (1, 9, 2, 4))]
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, True, 0.4), ts)


def test_grad_path_counts_no_launch_on_the_cpu():
    ops.reset_launch_counts()
    q = torch.randn(1, 5, 2, 16, requires_grad=True)
    ops.flash_attention(q, q, q).sum().backward()
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_backward_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 2, 16)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_attention_bwd.flash_attention_bwd(q, q, q, q, lse, q)
    assert ops.launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.parametrize("kw", [dict(causal=False), dict(window=4),
                                dict(skv=5)], ids=str)
def test_grad_outside_causal_self_attention_raises(kw):
    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    k = torch.zeros(1, kw.get("skv", 4), 2, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.flash_attention(q, k, k, kw.get("causal", True),
                            window=kw.get("window"))


# -------------------------------------------------------------- optimizer

@pytest.mark.parametrize("step", [0, 3, 5, 50, 95, 100])
def test_schedule_equals_reference(step):
    cfg = dict(lr=1e-3, warmup_steps=5, total_steps=100)
    want = JO.schedule(JO.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32))
    got = TO.schedule(TO.AdamWConfig(**cfg),
                      torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _opt_tree(rng):
    """A stacked norm scale [L, D] (decayed: ndim 2), a prefix norm [D]
    (not), a matrix and a bf16 matrix."""
    return {"blocks": {"ln1": {"scale": rng.standard_normal((3, 8))},
                       "w": rng.standard_normal((8, 6))},
            "dense_prefix": [{"ln": {"scale": rng.standard_normal(8)}}],
            "lm_head": {"w": rng.standard_normal((8, 6))}}


@pytest.mark.parametrize("gscale", [10.0, 1e-3], ids=["clipped",
                                                       "unclipped"])
def test_apply_updates_equal_reference(gscale):
    rng = np.random.default_rng(3)
    p = jax.tree.map(lambda a: a.astype(np.float32), _opt_tree(rng))
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg, tcfg = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    jp, jstate = jax.tree.map(jnp.asarray, p), None
    tp = params_from_jax(p)
    jstate, tstate = JO.init_state(jcfg, jp), TO.init_state(tcfg, tp)
    for i in range(2):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * gscale)
                         .astype(np.float32), p)
        jp, jstate, jinfo = JO.apply_updates(jcfg, jp, jax.tree.map(
            jnp.asarray, g), jstate)
        tp, tstate, tinfo = TO.apply_updates(tcfg, tp, params_from_jax(g),
                                             tstate)
        assert (float(jinfo["gnorm"]) > 1.0) == (gscale > 1)
        for name in ("lr", "gnorm"):
            np.testing.assert_allclose(float(tinfo[name]),
                                       float(jinfo[name]), rtol=1e-6)
        for got, want in ((tp, jp), (tstate.mu, jstate.mu),
                          (tstate.nu, jstate.nu)):
            for (key, t), w in zip(items(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=key)
        assert int(tstate.step) == i + 1


def test_decay_takes_the_stacked_norm_scale_not_the_prefix_one():
    """``ndim >= 2`` (the reference's rule): with zero gradients only the
    decay moves a leaf, and it moves the stacked [L, D] scale."""
    rng = np.random.default_rng(4)
    tp = params_from_jax(jax.tree.map(lambda a: a.astype(np.float32),
                                      _opt_tree(rng)))
    before = {k: t.clone() for k, t in items(tp)}
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=1)
    zeros = params_from_jax(jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), _opt_tree(rng)))
    TO.apply_updates(cfg, tp, zeros, TO.init_state(cfg, tp))
    after = dict(items(tp))
    assert torch.equal(after["dense_prefix/0/ln/scale"],
                       before["dense_prefix/0/ln/scale"])
    for key in ("blocks/ln1/scale", "blocks/w", "lm_head/w"):
        torch.testing.assert_close(after[key], before[key] * (1 - 1e-2 * 0.1))


def test_bf16_parameters_update_in_f32_and_round_once():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    g = rng.standard_normal((4, 6)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    cfg = dict(lr=1e-2, warmup_steps=1)
    jp2, _, _ = JO.apply_updates(JO.AdamWConfig(**cfg), jp,
                                 {"w": jnp.asarray(g, jnp.bfloat16)},
                                 JO.init_state(JO.AdamWConfig(**cfg), jp))
    tp = params_from_jax(_np(jp))
    TO.apply_updates(TO.AdamWConfig(**cfg), tp,
                     params_from_jax(_np({"w": jnp.asarray(g, jnp.bfloat16)})),
                     TO.init_state(TO.AdamWConfig(**cfg), tp))
    assert tp["w"].dtype == torch.bfloat16
    assert torch.equal(tp["w"], params_from_jax(_np(jp2))["w"])


# ------------------------------------------------------------------ steps

def test_three_train_steps_equal_reference():
    jcfg = CONFIGS["test-moe"]()
    cfg = _port(jcfg)
    opt = dict(lr=3e-4, warmup_steps=2, total_steps=3)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(_np(jp))
    jstep = jax.jit(JT.make_train_step(jcfg, JO.AdamWConfig(**opt)))
    tstep = TT.make_train_step(cfg, TO.AdamWConfig(**opt))
    jstate = JO.init_state(JO.AdamWConfig(**opt), jp)
    tstate = TO.init_state(TO.AdamWConfig(**opt), tp)
    jit_, tit = (JD.synthetic_batches(jcfg, B, S, 0),
                 TD.synthetic_batches(cfg, B, S, 0))
    for _ in range(3):
        jb, tb = next(jit_), next(tit)
        jp, jstate, jm = jstep(jp, jstate, jax.tree.map(jnp.asarray, jb))
        tp, tstate, tm = tstep(tp, tstate, TT.to_device(tb, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=1e-5)
    for (key, t), w in zip(items(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("arch", ["moe", "encoder", "vlm"])
def test_synthetic_batches_bitwise(arch):
    name = {"moe": "qwen3-30b-a3b", "encoder": "hubert-xlarge",
            "vlm": "llama-3.2-vision-11b"}[arch]
    jcfg = jax_reduced(jax_config(name))
    a, b = JD.synthetic_batches(jcfg, 3, 20, 7), \
        TD.synthetic_batches(_port(jcfg), 3, 20, 7)
    for _ in range(2):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


def test_checkpoint_round_trip_bitwise_with_the_reference_keys(tmp_path):
    """bf16 and f32 leaves, params and an optimizer state: the port's
    files hold the reference's ``_flatten`` keys, a reference-written
    file restores bit for bit, and the port's own round trip too."""
    jcfg = CONFIGS["deepseek-v2-lite-smoke"]()
    jp = JM.init_params(dataclasses.replace(jcfg, dtype="bfloat16"),
                        jax.random.PRNGKey(0))
    jstate = JO.init_state(JO.AdamWConfig(), jp)
    tp = params_from_jax(_np(jp))
    tstate = TO.init_state(TO.AdamWConfig(), tp)
    assert any(t.dtype == torch.bfloat16 for t in leaves(tp))
    for jtree, ttree, name in ((jp, tp, "params"),
                               (jstate, tstate, "state")):
        TC.save(str(tmp_path / f"port_{name}.npz"), ttree)
        JC.save(str(tmp_path / f"ref_{name}.npz"), jtree)
        with np.load(tmp_path / f"port_{name}.npz") as f:
            assert set(f.files) == set(JC._flatten(jtree))
        for src in ("port", "ref"):
            back = TC.restore(str(tmp_path / f"{src}_{name}.npz"), ttree)
            for (key, a), (_, b) in zip(items(back), items(ttree)):
                assert a.dtype == b.dtype and torch.equal(a, b), (src, key)


def test_launcher_on_the_cpu(capsys):
    out = launch_train.main(["--arch", "deepseek-v2-lite-16b", "--steps",
                             "2", "--batch", "2", "--seq", "16", "--device",
                             "cpu"])
    assert [i for i, _ in out["history"]] == [0, 1]
    assert all(np.isfinite(l) for _, l in out["history"])
    assert "done: loss" in capsys.readouterr().out
    assert launch_train.parse_args(["--arch", "yi-6b"]).device == "cuda"


def test_train_runs_on_the_card_unless_asked():
    import inspect
    assert inspect.signature(TT.train).parameters["device"].default == \
        "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.train(get_config("qwen3-30b-a3b-smoke"), steps=1, batch=1,
                     seq_len=8)


def test_init_params_with_experts_draws_the_dense_boot_banks():
    """``experts=True`` draws the banks the HMM's dense boot draws."""
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    cfg = _port(_test_moe())
    hmm = HMM(cfg, 1, batch_per_replica=2, max_len=32, seed=3,
              device="cpu")
    hmm.boot(ElasticConfig(1, 1, (0,)))
    p = TM.init_params(cfg, 3, device="cpu", experts=True)
    for (key, a), (_, b) in zip(items(p), items(hmm.params)):
        assert torch.equal(a, b), key


# --------------------------------------------------------------- refusals

def _refused():
    moe = _port(_test_moe())
    return {
        "ssm": get_config("mamba2-1.3b-smoke"),
        "hybrid": get_config("zamba2-2.7b-smoke"),
        "vlm": get_config("llama-3.2-vision-11b-smoke"),
        "encoder": get_config("hubert-xlarge-smoke"),
        "window": dataclasses.replace(moe, attn_window=4),
        "parallel": moe,
    }


@pytest.mark.parametrize("kind", ["ssm", "hybrid", "vlm", "encoder",
                                  "window", "parallel"])
def test_training_outside_the_slice_raises(kind):
    cfg = _refused()[kind]
    params = TM.init_params(cfg, 0, device="cpu", experts=True)
    batch = _torch(_batch(cfg))
    kw = {"parallel": object()} if kind == "parallel" else {}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.loss_fn(cfg, params, batch, **kw)


def test_training_over_pooled_experts_raises():
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    cfg = _port(_test_moe())
    hmm = HMM(cfg, 1, batch_per_replica=2, max_len=32, expert_mode="pooled",
              kv_mode="paged", device="cpu")
    hmm.boot(ElasticConfig(1, 1, (0,)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.loss_fn(cfg, hmm.params, _torch(_batch(cfg)))


# ---------------------------------------------------------------- metrics

def test_metrics_registry():
    m = obs.MetricsRegistry()
    m.inc("ticks")
    m.inc("ticks", 2)
    m.gauge("util", 0.5)
    snap = m.snapshot()
    assert snap["counters"] == {"ticks": 3}
    assert snap["gauges"] == {"util": 0.5}
    assert isinstance(obs.Tracer().metrics, obs.MetricsRegistry)
    assert obs.NULL_TRACER.metrics is None
