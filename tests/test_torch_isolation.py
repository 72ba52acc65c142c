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

import pytest
import torch

import repro_torch
from repro_torch.configs.base import ModelConfig
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.hmm import HMM
from repro_torch.core.topology import ElasticConfig
from repro_torch.device import exact_matmuls
from repro_torch.kernels import moe_gmm, ops, paged_attention
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
    """Every module imports with ``jax`` made unimportable, and none of them
    loads the reference package."""
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
    "HMM": lambda **kw: HMM(MCFG, 1, batch_per_replica=2, max_len=64, **kw),
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
    hmm = HMM(MCFG, 1, batch_per_replica=2, max_len=64, device="cpu")
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


def test_use_reference_is_scoped():
    assert not ops._REFERENCE.get()
    with ops.use_reference():
        assert ops._REFERENCE.get()
    assert not ops._REFERENCE.get()


NOT_PORTED = {
    "kv_mode": "dense", "expert_mode": "dense", "prefill_chunk": 0,
    "staging": "overlap", "rebalance": object(), "routing_sample_every": 4,
    "kv_dtype": "int8", "expert_dtype": "int8", "imm_cache": object(),
}


@pytest.mark.parametrize("knob", sorted(NOT_PORTED))
def test_knobs_outside_the_slice_raise(knob):
    with pytest.raises(NotImplementedError):
        ElasticServer(MCFG, **{**SERVER_KW, knob: NOT_PORTED[knob]},
                      device="cpu")


def test_more_than_one_device_raises():
    srv = ElasticServer(MCFG, **SERVER_KW, device="cpu")
    with pytest.raises(NotImplementedError):
        srv.boot(ElasticConfig(2, 1, (0, 1)))
