"""The port stands alone: ``repro_torch`` imports neither JAX nor anything of
the reference package, its entry points run on the card unless told
otherwise, its kernel wrappers never fall back to the plain versions on a
CUDA tensor, and every knob outside the one-card slice is refused."""
import ast
import inspect
import os
import pkgutil
import subprocess
import sys
from collections import OrderedDict

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.base import ModelConfig
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.hmm import HMM
from repro_torch.core.topology import ElasticConfig
from repro_torch.device import exact_matmuls
from repro_torch.kernels import (flash_attention, kv_write, moe_gmm, ops,
                                 paged_attention, ref, ssd_scan)
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.workload import Request
from repro_torch.models import model as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")

MCFG = ModelConfig(name="tiny-moe", arch_type="moe", num_layers=2,
                   d_model=32, vocab_size=64, num_heads=4, num_kv_heads=2,
                   head_dim=8, d_ff=64, num_experts=4, top_k=2, moe_d_ff=16,
                   dtype="float32")
SERVER_KW = dict(tp=1, batch_per_replica=2, max_len=64, kv_mode="paged",
                 kv_block_size=16, expert_mode="pooled", prefill_chunk=16)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_imports_without_jax():
    """Every module imports with ``jax`` made unimportable (the scaling
    modules among them), and none of them loads the reference package."""
    assert {"repro_torch.core.transfer", "repro_torch.core.imm",
            "repro_torch.serving.driver"} <= set(_modules())
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax_or_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {n}"


ENTRY_POINTS = {
    "ElasticServer": lambda **kw: ElasticServer(MCFG, **SERVER_KW, **kw),
    "HMM": lambda **kw: HMM(MCFG, 1, batch_per_replica=2, max_len=64,
                            kv_mode="paged", expert_mode="pooled", **kw),
    "init_params": lambda **kw: M.init_params(MCFG, 0, **kw),
    "init_paged_cache": lambda **kw: M.init_paged_cache(MCFG, 4, 16, **kw),
}
DEFAULTS = {"ElasticServer": ElasticServer.__init__, "HMM": HMM.__init__,
            "init_params": M.init_params,
            "init_paged_cache": M.init_paged_cache}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    assert inspect.signature(DEFAULTS[name]).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[name]()
    ENTRY_POINTS[name](device="cpu")


def test_hmm_boot_on_cpu_fills_the_pooled_store():
    hmm = HMM(MCFG, 1, batch_per_replica=2, max_len=64, kv_mode="paged",
              expert_mode="pooled", device="cpu")
    hmm.boot(ElasticConfig(1, 1, (0,)))
    pool = hmm.params["moe_pool"]
    L, E = MCFG.num_layers, MCFG.num_experts
    assert pool["wi"].shape == (L * E, MCFG.d_model, MCFG.moe_d_ff)
    gt = hmm.params["blocks"]["moe"]["gtable"]
    assert sorted(gt.flatten().tolist()) == list(range(L * E))
    assert all(bool(pool[k].abs().sum(dim=(1, 2)).gt(0).all())
               for k in pool)          # every page written


def test_init_params_draws_no_routed_experts():
    """``HMM.boot`` fills the pooled store: ``init_params`` holds only the
    router of each MoE layer, never dense expert banks."""
    p = M.init_params(MCFG, 0, device="cpu")
    assert set(p["blocks"]["moe"]) <= {"router", "shared"}
    assert "moe_pool" not in p


def test_exact_matmuls_turns_off_reduced_precision():
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
             m.allow_fp16_reduced_precision_reduction)
    try:
        m.allow_tf32 = True
        m.allow_bf16_reduced_precision_reduction = True
        m.allow_fp16_reduced_precision_reduction = True
        exact_matmuls()
        assert not (m.allow_tf32 or m.allow_bf16_reduced_precision_reduction
                    or m.allow_fp16_reduced_precision_reduction)
    finally:
        (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
         m.allow_fp16_reduced_precision_reduction) = saved


def _small_inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 8, generator=g)
    kp = torch.randn(6, 4, 2, 8, generator=g)
    vp = torch.randn(6, 4, 2, 8, generator=g)
    bt = torch.tensor([[1, 6], [0, 3]], dtype=torch.int32)
    lens = torch.tensor([3, 7], dtype=torch.int32)
    x = torch.randn(3, 2, 8, generator=g)
    pool = torch.randn(4, 8, 5, generator=g)
    table = torch.tensor([2, 2, 0], dtype=torch.int32)
    return q, kp, vp, bt, lens, x, pool, table


def test_cpu_tensors_run_plain_versions_and_count_no_launch():
    q, kp, vp, bt, lens, x, pool, table = _small_inputs()
    ops.reset_launch_counts()
    ops.block_paged_decode_attention(q, kp, vp, bt, lens)
    ops.mixed_block_paged_attention(q[:, None], kp, vp, bt, lens,
                                    torch.ones_like(lens))
    ops.paged_gmm(table, pool, x)
    ops.paged_expert_ffn(table, table, table, pool, pool,
                         pool.transpose(1, 2).contiguous(), x)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor is an error there,
    never a silent fallback."""
    q, kp, vp, bt, lens, x, pool, table = _small_inputs()
    with pytest.raises(ValueError, match="CUDA kernel"):
        paged_attention.block_paged_decode_attention(q, kp, vp, bt, lens)
    with pytest.raises(ValueError, match="CUDA kernel"):
        paged_attention.mixed_block_paged_attention(
            q[:, None], kp, vp, bt, lens, torch.ones_like(lens))
    with pytest.raises(ValueError, match="CUDA kernel"):
        moe_gmm.paged_gmm(table, pool, x)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def _small_quant_inputs():
    g = torch.Generator().manual_seed(1)
    q, _, _, bt, lens, x, _, table = _small_inputs()
    kp = torch.randint(-127, 128, (6, 4, 2, 8), generator=g,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (6, 4, 2, 8), generator=g,
                       dtype=torch.int8)
    ks, vs = torch.rand(6, 4, generator=g), torch.rand(6, 4, generator=g)
    pool = torch.randint(-127, 128, (4, 8, 5), generator=g, dtype=torch.int8)
    scales = torch.rand(4, generator=g)
    return q, kp, ks, vp, vs, bt, lens, x, pool, scales, table


def test_quant_cpu_tensors_run_plain_versions_and_count_no_launch():
    q, kp, ks, vp, vs, bt, lens, x, pool, scales, table = \
        _small_quant_inputs()
    ops.reset_launch_counts()
    ops.quant_block_paged_decode_attention(q, kp, ks, vp, vs, bt, lens)
    ops.quant_mixed_block_paged_attention(q[:, None], kp, ks, vp, vs, bt,
                                          lens, torch.ones_like(lens))
    ops.quant_paged_gmm(table, pool, scales, x)
    ops.quant_paged_expert_ffn(table, table, table, pool, pool,
                               pool.transpose(1, 2).contiguous(), scales,
                               scales, scales, x)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_quant_kernel_wrappers_refuse_cpu_tensors():
    q, kp, ks, vp, vs, bt, lens, x, pool, scales, table = \
        _small_quant_inputs()
    with pytest.raises(ValueError, match="CUDA kernel"):
        paged_attention.quant_block_paged_decode_attention(
            q, kp, ks, vp, vs, bt, lens)
    with pytest.raises(ValueError, match="CUDA kernel"):
        paged_attention.quant_mixed_block_paged_attention(
            q[:, None], kp, ks, vp, vs, bt, lens, torch.ones_like(lens))
    with pytest.raises(ValueError, match="CUDA kernel"):
        moe_gmm.quant_paged_gmm(table, pool, scales, x)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def _small_dense_inputs():
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 8, 4, 16, generator=g)
    k = torch.randn(2, 8, 2, 16, generator=g)
    v = torch.randn(2, 8, 2, 16, generator=g)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    new = torch.randn(2, 2, 16, generator=g)
    pos = torch.tensor([1, 8], dtype=torch.int32)
    return q, k, v, lens, new, pos


def test_dense_cpu_tensors_run_plain_versions_and_count_no_launch():
    q, k, v, lens, new, pos = _small_dense_inputs()
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    ops.paged_decode_attention(q[:, 0], k, v, lens)
    ops.kv_cache_write(k, new, pos)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_dense_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, lens, new, pos = _small_dense_inputs()
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_attention.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA kernel"):
        paged_attention.paged_decode_attention(q[:, 0], k, v, lens)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kv_write.kv_cache_write(k, new, pos)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def _small_ssd_inputs():
    g = torch.Generator().manual_seed(3)
    return (torch.randn(1, 24, 2, 16, generator=g),
            torch.rand(1, 24, 2, generator=g) + 0.01,
            -torch.rand(2, generator=g) - 0.5,
            torch.randn(1, 24, 8, generator=g),
            torch.randn(1, 24, 8, generator=g))


def test_ssd_cpu_tensors_run_the_plain_version_and_count_no_launch():
    inputs = _small_ssd_inputs()
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(*inputs, 16)
    wy, ws = ref.ssd_scan_ref(*inputs, 16)
    assert torch.equal(y, wy) and torch.equal(st, ws)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        ssd_scan.ssd_scan(*_small_ssd_inputs(), 16)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_use_reference_is_scoped():
    assert not ops._REFERENCE.get()
    with ops.use_reference():
        assert ops._REFERENCE.get()
    assert not ops._REFERENCE.get()


NOT_PORTED = {
    # dense KV with SERVER_KW's chunked prefill (the reference's
    # chunk_prefill_step) is outside the ported slices
    "kv_mode": "dense", "expert_host_pages": 4,
    "rebalance": object(), "routing_sample_every": 4,
}


@pytest.mark.parametrize("knob", sorted(NOT_PORTED))
def test_knobs_outside_the_slice_raise(knob):
    with pytest.raises(NotImplementedError):
        ElasticServer(MCFG, **{**SERVER_KW, knob: NOT_PORTED[knob]},
                      device="cpu")


SCALING_KNOBS = {"scaledown": "drain", "staging": "overlap",
                 "imm_cache": OrderedDict()}


@pytest.mark.parametrize("knob", sorted(SCALING_KNOBS))
def test_scaling_knobs_are_accepted(knob):
    """The knobs of scaling while serving are ported: each reaches the
    part of the server that acts on it, and a booted server serves."""
    value = SCALING_KNOBS[knob]
    srv = ElasticServer(MCFG, **{**SERVER_KW, knob: value}, device="cpu")
    srv.boot(ElasticConfig(1, 1, (0,)))
    if knob == "staging":
        assert srv.staging_mode == srv.hmm.staging_mode == "overlap"
    elif knob == "scaledown":
        assert srv.scaledown_mode == "drain"
    else:
        assert srv.imm._cache is value and len(value) == 1
        assert srv.engine.compiled is next(iter(value.values())).compiled
    srv.submit(Request(0, 0.0, 5, 3, prompt=np.arange(5, dtype=np.int32)))
    for t in range(8):
        srv.tick(float(t))
    assert len(srv.engine.generated[0]) == 3
    if knob != "imm_cache":
        with pytest.raises(ValueError):
            ElasticServer(MCFG, **{**SERVER_KW, knob: "bogus"},
                          device="cpu")


@pytest.mark.parametrize("knob", ["kv_dtype", "expert_dtype"])
def test_storage_dtypes_other_than_int8_raise(knob):
    """As in the reference, only ``None`` and ``"int8"`` are storage
    dtypes."""
    with pytest.raises(ValueError, match=knob):
        ElasticServer(MCFG, **{**SERVER_KW, knob: "fp8"}, device="cpu")


@pytest.mark.parametrize("knobs", [
    {"kv_dtype": "int8", "kv_mode": "dense"},
    {"expert_dtype": "int8", "expert_mode": "dense"},
], ids=["kv", "expert"])
def test_int8_stores_need_the_paged_layouts(knobs):
    """As the reference asserts: int8 KV needs the block pool (its scales
    are per block row), int8 experts the pooled store (scales per page)."""
    kw = {**SERVER_KW, "prefill_chunk": 0, "kv_mode": "paged",
          "expert_mode": "pooled", **knobs}
    with pytest.raises(ValueError, match=next(iter(knobs))):
        ElasticServer(MCFG, **kw, device="cpu")
    with pytest.raises(ValueError, match=next(iter(knobs))):
        HMM(MCFG, 1, batch_per_replica=2, max_len=64, device="cpu",
            **{k: v for k, v in kw.items() if k in (
                "kv_mode", "expert_mode", "kv_dtype", "expert_dtype")})


@pytest.mark.parametrize("entry", ["ElasticServer", "HMM", "InferenceEngine"])
def test_defaults_are_the_references(entry):
    """The reference's defaults: slot-contiguous KV, dense expert banks,
    monolithic prefill."""
    fn = {"ElasticServer": ElasticServer.__init__, "HMM": HMM.__init__,
          "InferenceEngine": InferenceEngine.__init__}[entry]
    params = inspect.signature(fn).parameters
    want = {"kv_mode": "dense", "expert_mode": "dense", "prefill_chunk": 0}
    got = {name: params[name].default for name in want if name in params}
    assert got == {name: want[name] for name in got} and got


def test_int8_cache_of_other_dtype_raises():
    with pytest.raises(ValueError):
        M.init_paged_cache(MCFG, 4, 16, device="cpu", kv_dtype="fp8")
    with pytest.raises(ValueError, match="kv_dtype"):
        M.init_paged_cache(MCFG, 4, 16, device="cpu", kv_dtype="int16")


def test_more_than_one_device_raises():
    """Several logical devices serve a standard-attention decoder at any
    tp that keeps every head whole (``tests/test_torch_scale.py``,
    ``tests/test_torch_tp.py``), and the MLA and Mamba2 models too
    (``tests/test_torch_scale_mla.py``, ``tests/test_torch_scale_ssm.py``):
    deepseek-v2-lite and mamba2-1.3b boot on two.  What they do not serve
    yet raises ``NotImplementedError`` naming its slice — a tp that cuts a
    kv head — and a configuration naming a logical device that
    ``all_devices`` lacks raises ``ValueError``: nothing maps it onto
    another device."""
    from repro_torch.configs import get_config
    srv = ElasticServer(MCFG, **SERVER_KW, device="cpu")
    with pytest.raises(ValueError, match="not in all_devices"):
        srv.boot(ElasticConfig(2, 1, (0, 1)))
    with pytest.raises(NotImplementedError, match="head-cutting TP slice"):
        ElasticServer(MCFG, **{**SERVER_KW, "tp": 4}, device="cpu")
    cpu2 = [torch.device("cpu")] * 2
    for name in ("deepseek-v2-lite-16b-smoke", "mamba2-1.3b-smoke"):
        hmm = HMM(get_config(name), 1, batch_per_replica=2, max_len=64,
                  all_devices=cpu2, device="cpu")
        hmm.boot(ElasticConfig(2, 1, (0, 1)))
        assert hmm.active_cfg == ElasticConfig(2, 1, (0, 1))
        assert all(len(leaf.shards) == 2 for leaf in hmm.cache.values())
