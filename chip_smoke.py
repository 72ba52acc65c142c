#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py                 # every phase, full depth (48 layers)
    python3 chip_smoke.py --layers 8      # cut the served model's depth
    python3 chip_smoke.py --phases build,kernels

Phases, each of which raises on failure (no phase's failure is caught):

1. ``build``: compile ``src/repro_torch/csrc/*.cu`` with ``nvcc`` (one
   process per source, all started together) and print the build time and
   ``-Xptxas -v`` report.
2. ``kernels``: call each kernel's wrapper on CUDA tensors at the shapes the
   serving path gives it, in bfloat16 and float32, and hold the result
   against its plain PyTorch version (``kernels/ref.py``) on the same
   inputs: bf16 atol = rtol = 2e-2 on f32-cast outputs (both round once,
   from f32 sums taken in different orders); f32 atol = rtol = 1e-4.  Times
   the kernel, the plain version and one PyTorch library call for the same
   function (a yardstick only, never called by the port) with CUDA events,
   each launch after an L2 flush, and computes the bound from the bytes and
   operations of these inputs.
3. ``e2e``: a 2-layer qwen3-30b-a3b at full width, one prefill chunk and
   one decode step, through the kernels and through ``ops.use_reference()``
   from identical caches; logits must agree (f32: atol = rtol = 1e-3;
   bf16: relative Frobenius error below 0.25, because a one-ulp bf16
   difference may flip a near-tied top-8 expert choice).
4. ``serve``: ``ElasticServer`` with paged KV, pooled experts and chunked
   prefill serves qwen3-30b-a3b in bf16 with random weights from a seed: 8
   requests of 200-1000 prompt tokens, two sharing a prefix (prefix skip
   and copy-on-write run), 32 output tokens each.  Every kernel's launch
   count must be above zero after this phase.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  ``--json PATH`` also writes every
measurement (per-case kernel times, the build log, the decode-tick
profile) to PATH.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; operations/s by
# the type the kernel computes on (bf16 tensor cores; f32 on CUDA cores)
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
       torch.float32: dict(atol=1e-4, rtol=1e-4)}
E2E_F32_TOL = dict(atol=1e-3, rtol=1e-3)
E2E_BF16_REL = 0.25

# qwen3-30b-a3b serving shapes
H, KVH, HD, BS = 32, 4, 128, 16
MAX_LEN, BATCH, CHUNK = 2048, 8, 128
D_MODEL, MOE_FF, N_EXP = 2048, 768, 128

REPLACES = {
    "block_paged_decode_attention": "src/repro/kernels/paged_attention.py:123",
    "mixed_block_paged_attention": "src/repro/kernels/paged_attention.py:322",
    "paged_gmm": "src/repro/kernels/moe_gmm.py:83",
}
SOURCES = {
    "block_paged_decode_attention": "src/repro_torch/csrc/paged_attention.cu",
    "mixed_block_paged_attention": "src/repro_torch/csrc/paged_attention.cu",
    "paged_gmm": "src/repro_torch/csrc/moe_gmm.cu",
}


def log(*a):
    print(*a, flush=True)


def require(cond, msg="check failed"):
    """A check that holds under ``python -O`` too (asserts vanish there)."""
    if not cond:
        raise AssertionError(msg)


# ----------------------------------------------------------------- timing

class Timer:
    """Median time of ``fn`` in ms from CUDA events, each launch after an
    L2 flush (the serving path finds every layer's weights and KV cold)
    and behind a short device sleep, so the host's launch cost stays
    outside the events."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(200_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def sdpa(q, k, v, mask):
    """One library attention call over K/V already gathered to [B,KVH,S,hd]
    (the gather is not timed); GQA through ``enable_gqa``."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


# ----------------------------------------------------------------- phases

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build()
    wall = time.perf_counter() - t0
    log(f"[build] {len(report)} sources compiled in {wall:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return {"seconds": wall,
            "logs": {n: r["log"] for n, r in report.items()}}


def _tables(gen, lengths, NB, MB, need_extra=0):
    """Per-sequence tables of distinct, non-contiguous pool rows for
    ``lengths`` tokens (+``need_extra``), NB sentinels in the padding."""
    perm = torch.randperm(NB, generator=gen)
    bt = torch.full((len(lengths), MB), NB, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        nblk = -(-(int(n) + need_extra) // BS)
        bt[b, :nblk] = perm[used:used + nblk].to(torch.int32)
        used += nblk
    require(used <= NB)
    return bt


def _attention_case(kind, dtype, gen, timer, do_time):
    from repro_torch.kernels import ops, ref
    NB, MB = 1024, MAX_LEN // BS
    k_pool = torch.randn(NB, BS, KVH, HD, generator=gen).to(dtype).cuda()
    v_pool = torch.randn(NB, BS, KVH, HD, generator=gen).to(dtype).cuda()
    el = k_pool.element_size()
    if kind == "decode":
        lengths = torch.tensor([2048, 1, 17, 333, 1024, 1500, 64, 777],
                               dtype=torch.int32)
        bt = _tables(gen, lengths.tolist(), NB, MB).cuda()
        q = torch.randn(BATCH, H, HD, generator=gen).to(dtype).cuda()
        lens = lengths.cuda()
        kern = lambda: ops.block_paged_decode_attention(q, k_pool, v_pool,
                                                        bt, lens)
        plain = lambda: ref.block_paged_decode_attention_ref(
            q, k_pool, v_pool, bt, lens)
        ctx_tok = int(lengths.sum())
        attended = H * ctx_tok
        S = MB * BS
        kg = ref._gather_rows(k_pool, bt).reshape(BATCH, S, KVH, HD)
        vg = ref._gather_rows(v_pool, bt).reshape(BATCH, S, KVH, HD)
        mask = (torch.arange(S, device="cuda")[None, :]
                < lens.long()[:, None])[:, None, None, :]
        ql, kl, vl = q[:, :, None], kg.transpose(1, 2).contiguous(), \
            vg.transpose(1, 2).contiguous()
        lib = lambda: sdpa(ql, kl, vl, mask)
        io = nbytes(q, q, bt, lens)
        label = f"B={BATCH} lengths={lengths.tolist()}"
    else:
        ctx, q_len = kind
        bt = _tables(gen, [ctx], NB, MB).cuda()
        q = torch.randn(1, CHUNK, H, HD, generator=gen).to(dtype).cuda()
        ctx_t = torch.tensor([ctx], dtype=torch.int32, device="cuda")
        ql_t = torch.tensor([q_len], dtype=torch.int32, device="cuda")
        kern = lambda: ops.mixed_block_paged_attention(q, k_pool, v_pool, bt,
                                                       ctx_t, ql_t)
        plain = lambda: ref.mixed_block_paged_attention_ref(
            q, k_pool, v_pool, bt, ctx_t, ql_t)
        ctx_tok = ctx
        q_abs = ctx - q_len + torch.arange(CHUNK)
        attended = H * int(torch.minimum(q_abs + 1,
                                         torch.tensor(ctx)).sum())
        S = MB * BS
        kg = ref._gather_rows(k_pool, bt).reshape(1, S, KVH, HD)
        vg = ref._gather_rows(v_pool, bt).reshape(1, S, KVH, HD)
        t = torch.arange(S, device="cuda")
        qa = q_abs.cuda()
        mask = ((t[None, :] < ctx) & (t[None, :] <= qa[:, None]))[None, None]
        ql, kl, vl = q.transpose(1, 2).contiguous(), \
            kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()
        lib = lambda: sdpa(ql, kl, vl, mask)
        io = nbytes(q, q, bt, ctx_t, ql_t)
        label = f"B=1 Sq={CHUNK} ctx={ctx} q_len={q_len}"
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if kind != "decode":
        # the library call must compute the same function on valid rows
        lib_out = lib().transpose(1, 2)
        torch.testing.assert_close(lib_out.float()[:, :kind[1]],
                                   want.float()[:, :kind[1]], **TOL[dtype])
    else:
        torch.testing.assert_close(lib()[:, :, 0].float(), want.float(),
                                   **TOL[dtype])
    kv_bytes = 2 * ctx_tok * KVH * HD * el
    ops_n = 4 * HD * attended
    b_ms, b_by = bound_ms(io + kv_bytes, ops_n, dtype)
    rec = {"case": label, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": io + kv_bytes, "ops": ops_n}
    if do_time:
        rec.update(ms=timer(kern), plain_ms=timer(plain, iters=10),
                   library_ms=timer(lib))
    return rec, (q, k_pool, v_pool, bt) if kind == "decode" else None


def _gmm_case(bank, C, dtype, aliased, gen, timer, do_time):
    from repro_torch.kernels import ops, ref
    P = 2 * N_EXP
    Din, Fout = (D_MODEL, MOE_FF) if bank in ("wi", "wg") else \
        (MOE_FF, D_MODEL)
    pool = (torch.randn(P, Din, Fout, generator=gen)
            / math.sqrt(Din)).to(dtype).cuda()
    perm = torch.randperm(P, generator=gen).to(torch.int32)
    table = (perm[torch.arange(N_EXP) % (N_EXP // 2)] if aliased
             else perm[:N_EXP]).cuda()
    x = torch.randn(N_EXP, C, Din, generator=gen).to(dtype).cuda()
    kern = lambda: ops.paged_gmm(table, pool, x)
    plain = lambda: ref.paged_gmm_ref(table, pool, x)
    w = ref._gather_rows(pool, table).contiguous()
    lib = lambda: torch.bmm(x, w)
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lib().float(), want.float(), **TOL[dtype])
    pages = int(torch.unique(table).numel())
    nb = pages * Din * Fout * pool.element_size() + nbytes(x, got, table)
    ops_n = 2 * N_EXP * C * Din * Fout
    b_ms, b_by = bound_ms(nb, ops_n, dtype)
    rec = {"case": f"{bank} E={N_EXP} C={C} [{Din}x{Fout}] pages={pages}"
                   + (" aliased" if aliased else ""),
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nb, "ops": ops_n}
    if do_time:
        rec.update(ms=timer(kern), plain_ms=timer(plain, iters=10),
                   library_ms=timer(lib))
    return rec


def phase_kernels():
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    timer = Timer()
    out = {"block_paged_decode_attention": [],
           "mixed_block_paged_attention": [], "paged_gmm": []}
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        rec, dec_inputs = _attention_case("decode", dtype, gen, timer, timed)
        out["block_paged_decode_attention"].append(rec)
        for kind in ((1000, 104), (512, 128)):
            rec, _ = _attention_case(kind, dtype, gen, timer, timed)
            out["mixed_block_paged_attention"].append(rec)
        # q_len == 1 through the mixed kernel is the decode kernel, bit for bit
        q, kp, vp, bt = dec_inputs
        lens = torch.tensor([2048, 1, 17, 333, 1024, 1500, 64, 777],
                            dtype=torch.int32, device="cuda")
        dec = ops.block_paged_decode_attention(q, kp, vp, bt, lens)
        mix = ops.mixed_block_paged_attention(
            q[:, None].contiguous(), kp, vp, bt, lens,
            torch.ones_like(lens))
        torch.cuda.synchronize()
        require(torch.equal(dec, mix[:, 0]),
                "q_len == 1 differs from decode")
        del dec_inputs, q, kp, vp, bt
        for bank in ("wi", "wg", "wo"):
            for C in (1, 5):
                out["paged_gmm"].append(
                    _gmm_case(bank, C, dtype, False, gen, timer, timed))
        out["paged_gmm"].append(
            _gmm_case("wi", 5, dtype, True, gen, timer, False))
        torch.cuda.empty_cache()
    for name, recs in out.items():
        for r in recs:
            t = (f" kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                 f"library {r['library_ms']:.4f} ms," if "ms" in r else "")
            log(f"[kernels] {name} {r['dtype']} {r['case']}: max_abs_err "
                f"{r['max_abs_err']:.3e};{t} bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    del timer
    torch.cuda.empty_cache()
    return out


def _e2e(dtype_name):
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("qwen3-30b-a3b"), num_layers=2,
                              dtype=dtype_name)
    hmm = HMM(cfg, 1, batch_per_replica=BATCH, max_len=MAX_LEN,
              kv_block_size=BS, kv_blocks_per_replica=512, seed=1,
              device="cuda")
    hmm.boot(ElasticConfig(1, 1, (0,)))
    params, cache = hmm.params, hmm.cache
    NB, MB = 512, MAX_LEN // BS
    gen = torch.Generator(device="cuda").manual_seed(2)
    for leaf in cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    # one chunk: positions 256..383 of a 360-token prompt (q_len 104, padding
    # rows), then one decode step of 8 slots at ragged lengths (one inactive)
    cg = torch.Generator().manual_seed(3)
    start, length = 256, 360
    lengths = [1900, 5, 640, 1024, 77, 300, 1500, 16]
    bt_all = _tables(cg, [length] + lengths, NB, MB, need_extra=1)
    bt_chunk, bt_dec = bt_all[:1].cuda(), bt_all[1:].cuda()
    ids = torch.full((CHUNK // BS,), NB, dtype=torch.int32)
    nblk = -(-length // BS)
    for j in range(CHUNK // BS):
        if start // BS + j < nblk:
            ids[j] = bt_all[0, start // BS + j]
    tokens = torch.randint(0, cfg.vocab_size, (1, CHUNK), generator=cg)
    dec_tokens = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=cg)
    lens = torch.tensor(lengths, dtype=torch.int32)
    wb = bt_all[1:].gather(1, (lens.long() // BS)[:, None])[:, 0].clone()
    wb[5] = NB                                        # inactive slot
    args = [t.cuda() for t in (tokens, ids, dec_tokens, lens, wb)]

    def run():
        c = {k: v.clone() for k, v in cache.items()}
        lc, c = M.paged_chunk_prefill_step(cfg, params, args[0], c, start,
                                           length, bt_chunk, args[1])
        ld, c = M.paged_decode_step(cfg, params, args[2], c, args[3],
                                    bt_dec, args[4])
        return torch.cat([lc, ld]).float(), c

    got, c_got = run()
    with ops.use_reference():
        want, c_want = run()
    torch.cuda.synchronize()
    require(got.shape == (1 + BATCH, cfg.vocab_size))
    require(torch.isfinite(got).all() and torch.isfinite(want).all())
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    # layer 0's written rows come before any kernel: identical on both paths
    for k in c_got:
        require(torch.equal(c_got[k][0], c_want[k][0]),
                f"cache {k} differs")
    if dtype_name == "float32":
        torch.testing.assert_close(got, want, **E2E_F32_TOL)
    else:
        require(rel < E2E_BF16_REL, f"bf16 logits rel err {rel}")
    log(f"[e2e] 2-layer qwen3-30b-a3b {dtype_name}: chunk + decode logits "
        f"{tuple(got.shape)}, max_abs_err {err:.3e}, rel {rel:.3e}")
    return {"dtype": dtype_name, "max_abs_err": err, "rel_err": rel}


def phase_e2e():
    out = [_e2e("float32"), _e2e("bfloat16")]
    torch.cuda.empty_cache()
    return out


def _prompts(rng, vocab):
    """8 prompts of 200-1000 tokens; the last is the seventh one's first 264
    tokens: 16 full shared blocks plus a shared partial 17th, so it skips
    its prefix and copies the partial block on its first append (the
    seventh is prefilled last of the first seven, so it is still live)."""
    lens = [600, 200, 1000, 431, 757, 318, 905]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    prompts.append(prompts[6][:264].copy())
    return prompts


def phase_serve(layers, profile=True):
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.workload import Request
    cfg = get_config("qwen3-30b-a3b")
    if layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    log(f"[serve] qwen3-30b-a3b, {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_experts} experts top-{cfg.top_k}, "
        f"moe_d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{cfg.param_count():,} parameters")
    torch.cuda.reset_peak_memory_stats()
    srv = ElasticServer(cfg, tp=1, batch_per_replica=BATCH, max_len=MAX_LEN,
                        kv_mode="paged", kv_block_size=BS,
                        expert_mode="pooled", prefill_chunk=CHUNK, seed=0,
                        device="cuda")
    t0 = time.perf_counter()
    srv.boot(ElasticConfig(1, 1, (0,)))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    mem_boot = torch.cuda.memory_allocated()
    log(f"[serve] boot {boot_s:.2f} s, {mem_boot / 2**30:.2f} GiB allocated")

    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)
    out_len = 32
    reqs = [Request(rid=i, arrival_s=0.0, prompt_len=len(p),
                    output_len=out_len, prompt=p)
            for i, p in enumerate(prompts)]
    # the prefix sharer arrives once the 17 blocks it matches are written
    # and registered
    late = reqs[-1]
    late_tokens = [int(t) for t in late.prompt]
    for r in reqs[:-1]:
        srv.submit(r)

    tracer = obs.install(obs.Tracer())
    ops.reset_launch_counts()
    ticks = []
    prof_rows = None
    prof_ticks = []
    prof_overhead_s = 0.0
    t_start = time.perf_counter()
    tick = 0
    while True:
        if late is not None and len(srv.engine.kv.prefix_match_blocks(
                0, late_tokens)) >= 17:
            late.arrival_s = time.perf_counter() - t_start
            srv.submit(late)
            late = None
        # decode-only ticks begin once every prompt is prefilled
        steady = (not srv.queue and not srv.engine._prefilling
                  and late is None)
        if profile and steady and prof_rows is None and ticks \
                and not ticks[-1]["chunks"]:
            tp = time.perf_counter()
            prof_rows, prof_ticks = _profile_ticks(srv, t_start, 3)
            # the profiler's start-up and table building are not serving
            prof_overhead_s = (time.perf_counter() - tp
                               - sum(prof_ticks) / 1e3)
            tick += len(prof_ticks)
            continue
        tracer.clear()
        ts = time.perf_counter()
        srv.tick(ts - t_start)
        torch.cuda.synchronize()
        te = time.perf_counter()
        chunk_s = [e.dur for e in tracer.events()
                   if e.name == "prefill.chunks"]
        ticks.append({"ms": (te - ts) * 1e3,
                      "chunk_ms": sum(chunk_s) * 1e3,
                      "chunks": len(chunk_s)})
        tick += 1
        if late is None and all(r.finish_s is not None for r in reqs):
            break
        require(tick < 2000, "serving did not finish")
    wall = time.perf_counter() - t_start - prof_overhead_s
    obs.install(None)
    counts = ops.launch_counts()
    eng = srv.engine
    kv = eng.kv_stats()

    for r in reqs:
        toks = eng.generated[r.rid]
        require(len(toks) == out_len, (r.rid, len(toks)))
        require(all(0 <= t < cfg.vocab_size for t in toks))
    require(kv["shared_block_hits"] >= 17 and kv["cow_copies"] >= 1, kv)
    require(kv["used_blocks"] == 0)
    for name, n in counts.items():
        require(n > 0, f"{name} was not launched while serving")
    # the served weights give finite logits of the expected shape
    NB = eng.kv.num_blocks
    tbl = torch.full((1, MAX_LEN // BS), NB, dtype=torch.int32,
                     device="cuda")
    tbl[0, :CHUNK // BS] = torch.arange(CHUNK // BS)
    logits, _ = M.paged_chunk_prefill_step(
        cfg, eng.params, torch.from_numpy(prompts[0][None, :CHUNK]).cuda(),
        eng.cache, 0, CHUNK, tbl, tbl[0, :CHUNK // BS].contiguous())
    require(logits.shape == (1, cfg.vocab_size))
    require(torch.isfinite(logits).all())

    dec = [t["ms"] for t in ticks if not t["chunks"]]
    chunk = [t["chunk_ms"] / t["chunks"] for t in ticks if t["chunks"]]
    gen_tokens = sum(len(eng.generated[r.rid]) for r in reqs)
    res = {
        "layers": cfg.num_layers, "boot_s": boot_s,
        "ticks": len(ticks) + len(prof_ticks),
        "decode_tick_ms_median": statistics.median(dec),
        "decode_tick_ms_p90": float(np.percentile(dec, 90)),
        "decode_ticks": len(dec),
        "chunk_step_ms_median": statistics.median(chunk),
        "chunk_steps": len(chunk),
        "output_tok_s": gen_tokens / wall, "serve_s": wall,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts, "kv": {k: kv[k] for k in (
            "shared_block_hits", "cow_copies", "preemptions")},
        "ttft_s": {r.rid: r.ttft for r in reqs},
        "profile": prof_rows, "profiled_ticks_ms": prof_ticks,
    }
    log(f"[serve] {len(reqs)} requests, {gen_tokens} tokens in {wall:.2f} s "
        f"({res['output_tok_s']:.2f} tok/s); decode tick median "
        f"{res['decode_tick_ms_median']:.2f} ms, p90 "
        f"{res['decode_tick_ms_p90']:.2f} ms over {len(dec)} ticks; chunk "
        f"step median {res['chunk_step_ms_median']:.2f} ms over "
        f"{len(chunk)} chunks; max_memory_allocated "
        f"{res['max_memory_allocated_gib']:.2f} GiB")
    log(f"[serve] launches {counts}; kv {res['kv']}")
    return res


def _profile_ticks(srv, t_start, n):
    """Trace ``n`` steady decode ticks with torch.profiler: device time by
    kernel name, and the device's busy share of the ticks' wall time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    walls = []
    with profile(activities=acts) as prof:
        for _ in range(n):
            ts = time.perf_counter()
            srv.tick(ts - t_start)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - ts) * 1e3)
    rows = []
    for ev in prof.key_averages():
        # device-side kernel events only: an aten op's row repeats the time
        # of the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append({"name": ev.key[:90], "count": ev.count,
                     "device_ms_per_tick":
                         ev.self_device_time_total / 1e3 / n})
    rows.sort(key=lambda r: -r["device_ms_per_tick"])
    busy = sum(r["device_ms_per_tick"] for r in rows)
    wall = sum(walls) / n
    log(f"[profile] {n} decode ticks, wall {wall:.2f} ms/tick, device "
        f"kernels {busy:.2f} ms/tick (idle share "
        f"{(1 - busy / wall) if rows else float('nan'):.3f})")
    for r in rows[:12]:
        log(f"[profile]   {r['device_ms_per_tick']:9.3f} ms  x{r['count']:<6}"
            f" {r['name']}")
    return {"wall_ms_per_tick": wall, "device_ms_per_tick": busy,
            "kernels": rows[:40]}, walls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=48,
                    help="depth of the served model (full: 48)")
    ap.add_argument("--phases", default="build,kernels,e2e,serve")
    ap.add_argument("--json", help="write every measurement to this file")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    sys.path.insert(0, os.path.join(HERE, "src"))
    # fails outside a checkout of the repo; on the card, sets the matmul
    # precision the port assumes, as every entry point of the port does
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    res = {"card": smi, "torch": torch.__version__}
    if "build" in phases:
        res["build"] = phase_build()
    if "kernels" in phases:
        res["kernels"] = phase_kernels()
    if "e2e" in phases:
        res["e2e"] = phase_e2e()
    if "serve" in phases:
        res["serve"] = phase_serve(args.layers)
    res["seconds"] = time.perf_counter() - t0
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1, default=str)

    if "kernels" in res:
        launches = res.get("serve", {}).get("launches", {})
        line = []
        for name, recs in res["kernels"].items():
            r = recs[0]                       # the main case, bf16, timed
            line.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches.get(name, 0),
                "max_abs_err": max(x["max_abs_err"] for x in recs
                                   if x["dtype"] == "bfloat16"),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]})
        log(json.dumps({"kernels": line}))
    log(f"{smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
