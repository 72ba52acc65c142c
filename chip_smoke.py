#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py                 # every phase, full depth
    python3 chip_smoke.py --layers 8      # cap every served model's depth
    python3 chip_smoke.py --phases build,kernels

Phases, each of which raises on failure (no phase's failure is caught):

1. ``build``: compile ``src/repro_torch/csrc/*.cu`` with ``nvcc`` (one
   process per source, all started together) and print the build time and
   ``-Xptxas -v`` report.
2. ``kernels``: call each kernel's wrapper on CUDA tensors at the shapes the
   serving paths give it, in bfloat16 and float32 (q and x; the int8
   kernels read int8 pools with positive random scales), and hold the
   result against its plain PyTorch version (``kernels/ref.py``) on the
   same inputs: bf16 atol = rtol = 2e-2 on f32-cast outputs (both round
   once, from f32 sums taken in different orders); f32 atol = rtol = 1e-4;
   ``kv_cache_write`` bit for bit, in every instance: the paged decode
   write at qwen3-30b-a3b's decode shape (B = 8 rows of [4, 128] into a
   [1024, 16, 4, 128] pool, slot 5 on the NB sentinel; the main case)
   and the chunk write (8 blocks of 16 rows, the last on the sentinel),
   each into bf16 pools and into int8 pools with their scales (the int8
   rows and scales as the plain version computes them on the card), a
   second launch giving the same bits; the slot pair write (K and V in
   one launch).  ``flash_attention`` runs at the
   buckets S = 1024 (the main case), 192 (a ragged tile) and 64, and at
   MLA's q/k width 192 and v width 128 (S = 1024 and 192; and 1024 at
   a TP rank's 8 heads, ``serve_scale_mla``'s prefill);
   ``mla_decode_attention`` at deepseek-v2-lite's decode shape (B = 8,
   H = 16, r = 512, dr = 64, S_max = 2048), at a TP rank's 8 heads as
   ``serve_scale_mla`` gives them (a replica's B = 2 slots, and B = 4;
   lengths 1900, 5, 640, 1024) and at lengths all 1, all
   S_max, an S_max of 1000 with a length of 0, and lengths either side of
   one and two of the kernel's spans, with queries drawn so
   that the scores spread over several units (a peaked softmax, as in
   decode), where the bf16 output must be the f32 answer rounded once
   (within 3e-5 past half a bf16 step) and a second launch must give the
   same bits; the slot pair write on MLA's latent rows of 1 KiB and
   rope-key rows of 128 B too;
   the GMMs at qwen3-30b-a3b's three banks (E = 128; wi and wg 2048 x 768,
   wo 768 x 2048) at C = 1 (decode), 5, and a chunk step's capacity
   (``capacity_for(CHUNK)``, 10 rows an expert), and an aliased table; both
   GMMs at deepseek-v2-lite's D = 2048, F = 1408, E = 64 too (int8 pages at
   its wi bank), at C = 1 (decode) and C = 120 (a 1,024-token prefill's
   6,144 routed rows over 64 experts at capacity factor 1.25,
   ``capacity_for(1024)``); the bf16 GMM outputs must be the f32 answer
   rounded once (within 3e-5 past half a bf16 step) and a second launch
   must give the same bits.
   ``ssd_scan`` at mamba2-1.3b's prefill shape (B = 1, S = 1024, H = 64,
   P = 64, N = 128, chunk 256; the main case), zamba2-2.7b's (H = 80,
   N = 64, chunk 128), B = 2 with S = 512, a ragged S = 1000, 16 chunks
   (S = 4096), mamba2's and zamba2's shapes with A twenty times steeper
   (up to 140 of decay within 16 rows, as a served model's steepest
   heads reach), and
   mamba2's shape in f32: its outputs are f32
   from f32 sums on both sides, atol = rtol = 1e-3 on y and the state,
   and a second launch must give the same bits; no
   single PyTorch call computes the scan, so it has no library time.
   ``flash_attention`` and ``paged_decode_attention`` at zamba2's shared
   block too (H = KVH = 32, head width 80), and ``flash_attention``'s four
   (hd, hdv) instances at a ragged S = 1000 with queries drawn for scores
   of standard deviation 3, where the bf16 output must be the f32 answer
   rounded once to bf16 (within 3e-5 past half a bf16 step).
   The two decodes, the slot decode and the two mixed attentions also
   at a TP rank's heads of the replicated cache (``kv_head_offset``):
   qwen3-30b-a3b's 16 query and 2 kv heads (tp = 2) and 8 and 1 (tp =
   4) from head 0 and past it (heads 2 and 3), bf16 and int8 rows, held
   to the same rules and timed past head 0.
   Both GMMs also at the expert-parallel shapes of ``serve_scale``: a
   device's table of 32 slots (DP4) or 22 with a pad slot on page 0
   (DP6), over the rows n_ep * C of a decode step and of a chunk step.
   The mixed attentions run at qwen3-30b-a3b's chunk of 128 rows: the
   1,000-token prompt's last chunk (ctx 1000, q_len 104; the main case),
   a full chunk at ctx 512 and a prompt's first chunk (ctx = q_len =
   128).  The decode and mixed kernels run twice on the same inputs and
   must give the same bits (the span counters, which the first launch
   leaves at zero, are reused).  Their queries, as MLA's, make scores of
   standard deviation 3; their bf16 outputs (bf16 and int8 rows) must
   also be the f32 answer rounded once to bf16.  At one query row the
   mixed attentions must agree with the decodes within the tolerance
   above (two kernels, sums in another order).
   Where each kernel lives (``SOURCES``): the three decodes,
   ``block_paged_decode_attention``, ``paged_decode_attention`` and the
   int8 ``quant_block_paged_decode_attention``, are instances of the
   split-context kernel in ``csrc/paged_decode.cu``; the two mixed
   attentions share ``csrc/paged_attention.cu``; the GMMs
   ``csrc/moe_gmm.cu``; ``flash_attention`` (bf16 on the tensor cores, f32
   on CUDA cores) ``csrc/flash_attention.cu``; the others a file each.
   Times the kernel, the plain version and one PyTorch library call for
   the same function (a yardstick only, never called by the port; for the
   int8 kernels it reads K/V or pages dequantized to q's dtype beforehand)
   with CUDA events, each launch after an L2 flush, and computes the bound
   from the bytes and operations of these inputs.
3. ``e2e``: a 2-layer qwen3-30b-a3b at full width, one prefill chunk and
   one decode step, through the kernels and through ``ops.use_reference()``
   from identical caches, with bf16/f32 stores and with int8 KV blocks and
   int8 expert pages.  The kernels' chunk and decode steps run under
   ``torch.cuda.set_sync_debug_mode("error")``: no call may synchronise
   with the host.  Layer 0's written KV rows (and int8 scales) must be
   equal on both paths.  Logits must agree: f32 atol = rtol = 1e-3; bf16
   relative Frobenius error below 0.25, because a one-ulp bf16 difference
   may flip a near-tied top-8 expert choice.  int8 f32 is held to the f32
   rule when layer 1's written int8 rows are equal on both paths; where a
   rounding tie put an entry one quantum apart, it is held to the 0.25
   rule, since that quantum may flip an expert choice too.  In f32 layer
   1's int8 entries may differ by at most one quantum; in bf16 layer 1's
   inputs already differ by more than a rounding (see above), so its
   entries are only counted.  The count is printed.  Then the default
   stores (slot-contiguous KV, dense expert banks): a monolithic prefill of
   a 200-token prompt (bucket 256) into one slot and a decode step of 8
   slots, one of them full (its KV write drops), held to the same rules;
   layer 0's cache rows must be equal on both paths.
4. ``serve``: ``ElasticServer`` with paged KV, pooled experts and chunked
   prefill serves qwen3-30b-a3b in bf16 with random weights from a seed: 8
   requests of 200-1000 prompt tokens, two sharing a prefix (prefix skip
   and copy-on-write run), 32 output tokens each.  Each bf16 kernel's
   launch count, set to 0 just before, must be above zero after it.  Each
   chunk step must launch one mixed attention per layer, and each chunk
   step and decode step three GMMs per MoE layer (counted apart: at a
   chunk's capacity of rows and at decode's one).  In every serve phase
   ``kv_cache_write`` must launch exactly once per attention layer per
   decode step and once per layer per chunk step.  After serving,
   two chunk steps of the 1,000-token prompt's last chunk (ctx 1000,
   q_len 104) run under the profiler.
5. ``serve_int8``: the same requests on a server with
   ``kv_dtype="int8", expert_dtype="int8"``, after the bf16 server is freed
   (the two do not fit one card together); each int8 kernel's launch count
   must be above zero after it.
6. ``serve_dense``: the same requests on a server with the reference's
   default knobs (slot-contiguous KV, dense expert banks, monolithic
   prefill at admission) and ``prefill_buckets`` every 64 tokens up to
   1024; ``flash_attention``, ``paged_decode_attention`` and
   ``kv_cache_write`` must each have launched.
7. ``e2e_mla``: a 2-layer deepseek-v2-lite-16b at full width (the dense
   layer and one MoE layer) with dense expert banks and with pooled
   pages: a monolithic prefill of a 200-token prompt into one slot, then
   three decode steps of 8 slots (one full: its writes drop), through the
   kernels and through ``ops.use_reference()``, held to the e2e rules
   above; layer 0's latent rows must be equal on both paths.
8. ``serve_mla`` and ``serve_mla_pooled``: the same requests on
   deepseek-v2-lite-16b at full depth (27 layers) with the reference's
   default knobs, and with ``expert_mode="pooled"``; each decode step
   must launch ``mla_decode_attention`` and ``kv_cache_write`` once per
   layer, each prefill ``flash_attention`` once per layer, and the
   pooled store ``paged_gmm`` three times per MoE layer per step.
9. ``e2e_ssm``: mamba2-1.3b and zamba2-2.7b at full width, 2 layers (the
   hybrid as two groups of one SSD layer, each led by the shared attention
   block), and zamba2-2.7b again with ``attn_every`` 2 (4 layers, two
   groups of two SSD layers), the default stores: a monolithic prefill of
   a 200-token prompt into one slot, then three decode steps of 8 slots,
   through the kernels and through ``ops.use_reference()``, held to the
   e2e rules above; layer
   0's conv tails (mamba2) or group 0's K/V rows (zamba2) must be equal on
   both paths.
10. ``serve_mamba2`` and ``serve_zamba2``: the same requests on
   mamba2-1.3b (48 layers) and zamba2-2.7b (54 layers) with the
   reference's default knobs and prefill buckets that are multiples of
   the SSD chunk (256 and 128 tokens) up to 1024; each prefill must launch
   ``ssd_scan`` once per SSD layer and, zamba2, ``flash_attention`` once
   per group; each zamba2 decode step ``paged_decode_attention`` and
   ``kv_cache_write`` once per group; mamba2 no attention kernel.
   Every serve phase runs its decode step and chunk step as the IMM's
   CUDA graphs (captured at boot, replayed by the engine; each replay
   counts the launches its capture recorded), its prefills eagerly.
   ``serve_graphs``: ``serve`` and ``serve_mamba2`` again with
   ``cuda_graphs=False`` (the eager steps), one server at a time, held
   against this call's graphed runs: the greedy tokens must be equal;
   prints each run's decode tick (unprofiled median and p90, device ms
   and idle share of 3 profiled ticks), ``serve``'s chunk step
   (unprofiled wall, device ms, idle share), the capture seconds and
   ``max_memory_allocated``.
11. ``e2e_scale``: several logical devices of the one card (every logical
   device is ``cuda:0``; a move between two of them is a copy on the
   card).  A 2-layer qwen3-30b-a3b at full width with paged KV and pooled
   experts (f32, bf16, and bf16 with int8 KV blocks and expert pages)
   booted on DP4 (tp = 1, 2 slots a replica): a chunk step on replica 1
   and a decode step of all 8 slots, through the kernels (under
   ``set_sync_debug_mode("error")``) and through ``ops.use_reference()``,
   held to the e2e rules above, layer 0's written rows equal in every
   shard; then ``HMM.scale`` to DP6 and ``commit``, and the same at DP6.
   Each case prints the rows whose top-k expert set differs between the
   two runs and the logits' relative error of the decode rows with and
   without such a flip (a flip tells a near-tied choice from a fault).
12. ``serve_scale``: ``ElasticServer`` serving the ``serve`` requests
   (8 prompts of 200-1000 tokens, 32 output tokens) on qwen3-30b-a3b at
   full width and 8 layers with paged KV, pooled experts and chunked
   prefill, booted on DP4; at the 5th tick ``stage_scale`` to DP6, seven
   ticks (as many as ``serve_overlap`` serves while it captures the
   target's seven graphs, one a poll), ``switchover``.  Every parameter
   shard of the four surviving devices (but the rebuilt page-table
   arrays) and every KV shard must be
   the same tensor after it (``data_ptr``); the staged expert bytes must
   be the migrations' pages, the other staged copies the two new devices'
   replicated leaves, and commit must move no weight byte.  Launches: one
   decode attention per layer per replica per decode step, one mixed
   attention per layer per chunk step, three GMMs per layer per logical
   device per step, one KV write per layer per replica per decode step
   and per layer per chunk step.  A decode step of every slot and a chunk
   step (ctx 1000, q_len 104) are timed, unprofiled and profiled, at DP4
   before serving and at DP6 after, eager and replayed from the
   instance's graphs, whose decode tokens must equal the eager step's on
   the same inputs and state (DP6: the target, captured while staging).
   Then the same with int8 KV blocks and int8 expert pages, its steps
   untimed.
13. ``e2e_tp``: the ``e2e_scale`` steps on DP2 x TP2 and DP1 x TP4 (4
   logical devices of the card; a TP sum or gather is a copy and an add
   on the card): each replica's ranks split its attention heads (from
   the cache's head ``t * KVH / tp``), embedding rows and LM head
   columns, f32, bf16 and bf16 with int8 stores, held to the e2e rules;
   every rank's copy of the cache must equal rank 0's after the steps.
14. ``serve_tp``: the ``serve_scale`` server and requests at tp = 2,
   booted on DP2 x TP2 and scaled to DP3 x TP2 at the 5th tick (four
   ticks between ``stage_scale`` and ``switchover``), bf16
   then int8; the same invariants with each rank's shards (the staged
   non-expert copies are the two new devices' TP shards, the new
   replica's KV slice zeroed once per rank), and a decode attention, a
   mixed attention and a KV write per layer per rank; the TP copies of
   the cache equal at the end; the TP sums and gathers at a decode and a
   chunk step's shapes, each timed alone (their per-step figure is the
   sum of those times over a step's calls, not a reading from a step).
15. ``serve_overlap``: the ``serve_scale`` server and requests with
   ``staging="overlap"`` and 4 transfer workers (each issuing its copies
   on its own side CUDA stream), bf16 then int8: ``start_scale`` to DP6
   before the 5th tick, a tick between every two ``advance`` polls until
   DONE; the decode steps of the ticks served while the staging's ops are
   in flight run under ``set_sync_debug_mode("error")``.  The staged
   ``TransferStats`` byte fields must equal this call's ``serve_scale``
   (serial ``stage_scale``) field by field, and the greedy tokens its
   tokens where every tick ran on the same configuration in both runs
   (else the phase prints where they part: the tick, each run's device
   count, the rows whose top-k expert set differs).  Prints
   ``stage_wall_s``, ``op_s``, ``overlap_efficiency``, ``stall_s``, the
   ticks served in STAGING and their wall and device times (a profile:
   the step kernels', all kernels' and the copies') against two ticks
   before the scale, ``switch_s`` beside the capture of the target's
   graphs (over STAGING's polls, one graph a poll, a tick between two
   polls) and the longest poll; ``compile_hit`` must be true.
16. ``serve_down``: DP6 -> DP4 while serving 12 requests (the eight
   survivor slots' short ones finish early; the four doomed slots hold
   the 1,000-token prompt and prompts of 600, 431 and 757 tokens, 40
   tokens out), the task (overlapped staging) opened once every doomed
   sequence has decoded 4 tokens: bf16 with ``scaledown="migrate"`` (no
   preemption allowed; every moved block's rows and scales held bit for
   bit, in each TP copy, against its source block before the cut-over;
   ``migration_bytes`` = blocks x ``block_nbytes``), then with
   ``"drain"``, int8 migrate; each store also unscaled on DP4, whose
   tokens each run is compared with (printed: capacity drops depend on
   the device count).  Prints the blocks and bytes moved, the MIGRATING
   wall, the wall from ``start_scale`` to DONE, the drain's ticks and the
   copy rate.
17. ``serve_down_tp``: the same at DP3 x TP2 -> DP2 x TP2 (6 requests,
   two doomed), bf16, migrate and unscaled; every TP copy of the cache
   equal after the scale.
18. ``serve_scale_mla``: the dense layout on several logical devices:
   deepseek-v2-lite-16b at full width and 8 layers (the pools the HMM
   reserves, ``2 L ceil(E / ndev)`` pages a device, outgrow the card at
   full depth), pooled expert pages, the latent slot cache, monolithic
   prefill, bf16, booted on DP2 x TP2 (each rank 8 of the 16 heads): the
   first decode step of every slot on random cache contents is held
   against the one-device step at the same weights (the e2e bf16 rule),
   its rows' expert choices compared layer by layer (``_Routing``): the
   rows whose top-k sets all agree, and the one-device step run again
   routed as the devices routed, must be within
   ``E2E_BF16_SAME_ROUTES_REL`` (0.05);
   then ``c1.dp * 2 + 2`` requests (prompts of 64-1000 tokens, 32 out),
   ``stage_scale`` to DP3 x TP2 at the 9th tick, three ticks served on
   the source with the target staged, ``switchover``, and six ticks on
   the target later ``start_scale`` back to DP2 x TP2, which drains (the
   dense layout has no blocks to migrate).  Every TP rank's copy of the
   cache must equal rank 0's after every tick.  Launches: one
   ``mla_decode_attention`` and one ``kv_cache_write`` per layer, rank
   and replica per decode step, one ``flash_attention`` per layer and
   rank per prefill, ``paged_gmm`` in every MoE layer.  The same requests
   and schedule on the eager twin (``cuda_graphs=False``) must give the
   same tokens and launch counts.  Prints the scales' ``TransferStats``
   bytes, ``stage_s`` and ``switch_s``, the decode tick's median (ticks
   with no prefill) before, during and after the scale-up, in the drain
   and after it, the drain's seconds and the card; the graphed run also
   profiles three replays of the source's decode graph (every slot
   active) before the requests arrive, the cache restored after them.
19. ``serve_scale_zamba2``: the same on zamba2-2.7b at full width and
   depth (54 layers), bf16, DP4 -> DP6 -> DP4 at tp = 1 (14 requests, 16
   tokens out):
   the scale-up is zero-copy reuse plus whole-replica copies (no
   experts; the staged copies must be exactly the two new devices'
   replicas).  Launches: one ``ssd_scan`` per layer per prefill, one
   ``flash_attention`` per group per prefill, one
   ``paged_decode_attention`` and one ``kv_cache_write`` per group and
   replica per decode step.

The line before the last is ``{"kernels": [...]}`` (each kernel's
launches summed over the serve phases whose path runs it,
``PATH_KERNELS``, each counted from 0 over its own run); the last line
is
``{"ok": true, "device": {...}}``.  ``--layers N`` caps every served
model's depth at N (a hybrid's at a multiple of its ``attn_every``); by
default each serves at full depth.  ``--json PATH`` also writes every
measurement (per-case kernel times, the build log, the decode-tick
profile) to PATH.  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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
# bf16 logits of two runs that route every row to the same experts and
# differ only in the order of their sums (measured 0.008-0.011 for
# qwen3-30b-a3b's unflipped rows in e2e_scale and e2e_tp)
E2E_BF16_SAME_ROUTES_REL = 0.05

# qwen3-30b-a3b serving shapes
H, KVH, HD, BS = 32, 4, 128, 16
MAX_LEN, BATCH, CHUNK = 2048, 8, 128
D_MODEL, MOE_FF, N_EXP = 2048, 768, 128
# deepseek-v2-lite-16b's (MLA): heads, latent rank, rope dim, nope dim,
# v dim; experts and their width
MLA_H, MLA_R, MLA_DR, MLA_DN, MLA_DV = 16, 512, 64, 128, 128
MLA_FF, MLA_EXP = 1408, 64
# the SSD scans of a 1,024-token prefill, (B, S, H, P, N, chunk):
# mamba2-1.3b's and zamba2-2.7b's; zamba2's shared attention block's heads
SSD_MAMBA2 = (1, 1024, 64, 64, 128, 256)
SSD_ZAMBA2 = (1, 1024, 80, 64, 64, 128)
SSD_TOL = dict(atol=1e-3, rtol=1e-3)
# decode queries: N(0, 3^2) entries against N(0, 1) keys give scores of
# standard deviation 3 after the 1/sqrt(hd) scale, a peaked softmax
DECODE_Q_STD = 3.0
ZAMBA_H, ZAMBA_HD = 32, 80

REPLACES = {
    "block_paged_decode_attention": "src/repro/kernels/paged_attention.py:123",
    "mixed_block_paged_attention": "src/repro/kernels/paged_attention.py:322",
    "paged_gmm": "src/repro/kernels/moe_gmm.py:83",
    "quant_block_paged_decode_attention":
        "src/repro/kernels/paged_attention.py:217",
    "quant_mixed_block_paged_attention":
        "src/repro/kernels/paged_attention.py:430",
    "quant_paged_gmm": "src/repro/kernels/moe_gmm.py:148",
    "flash_attention": "src/repro/kernels/flash_attention.py:72",
    "paged_decode_attention": "src/repro/kernels/paged_attention.py:75",
    "kv_cache_write": "src/repro/kernels/kv_write.py:37",
    "mla_decode_attention": "src/repro/kernels/mla_decode.py:73",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:67",
}
_ATTN_CU = "src/repro_torch/csrc/paged_attention.cu"
_DECODE_CU = "src/repro_torch/csrc/paged_decode.cu"
_GMM_CU = "src/repro_torch/csrc/moe_gmm.cu"
SOURCES = {
    "block_paged_decode_attention": _DECODE_CU,
    "mixed_block_paged_attention": _ATTN_CU,
    "paged_gmm": _GMM_CU,
    "quant_block_paged_decode_attention": _DECODE_CU,
    "quant_mixed_block_paged_attention": _ATTN_CU,
    "quant_paged_gmm": _GMM_CU,
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "paged_decode_attention": _DECODE_CU,
    "kv_cache_write": "src/repro_torch/csrc/kv_write.cu",
    "mla_decode_attention": "src/repro_torch/csrc/mla_decode.cu",
    "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
}
# the kernels each serve phase's path runs (the kernels line takes each
# kernel's launches from the first phase listing it)
PATH_KERNELS = {
    "serve": ("block_paged_decode_attention", "mixed_block_paged_attention",
              "paged_gmm", "kv_cache_write"),
    "serve_int8": ("quant_block_paged_decode_attention",
                   "quant_mixed_block_paged_attention", "quant_paged_gmm",
                   "kv_cache_write"),
    "serve_dense": ("flash_attention", "paged_decode_attention",
                    "kv_cache_write"),
    "serve_mla": ("mla_decode_attention", "flash_attention",
                  "kv_cache_write"),
    "serve_mla_pooled": ("mla_decode_attention", "flash_attention",
                         "kv_cache_write", "paged_gmm"),
    "serve_mamba2": ("ssd_scan",),
    "serve_zamba2": ("ssd_scan", "flash_attention", "paged_decode_attention",
                     "kv_cache_write"),
    "serve_scale_mla": ("mla_decode_attention", "flash_attention",
                        "kv_cache_write", "paged_gmm"),
    "serve_scale_zamba2": ("ssd_scan", "flash_attention",
                           "paged_decode_attention", "kv_cache_write"),
    "serve_scale": ("block_paged_decode_attention",
                    "mixed_block_paged_attention", "paged_gmm",
                    "quant_block_paged_decode_attention",
                    "quant_mixed_block_paged_attention", "quant_paged_gmm",
                    "kv_cache_write"),
}
for _p in ("serve_tp", "serve_overlap", "serve_down", "serve_down_tp"):
    PATH_KERNELS[_p] = PATH_KERNELS["serve_scale"]
DECODE_LENGTHS = [2048, 1, 17, 333, 1024, 1500, 64, 777]
# the scale phases: qwen3-30b-a3b at full width on logical devices of the
# one card, DP4 -> DP6 at tp = 1, 2 slots a replica; serve_scale at 8
# layers (the pools of 48 would take 174 GB), e2e_scale at 2
SCALE_LAYERS, SCALE_BPR, SCALE_DEVICES = 8, 2, 6
# the lengths of serve_scale_mla's one-device check, whose DP2 x TP2
# decode gives each rank's MLA decode a replica's 2 slots at 8 heads
RANK_LENGTHS = [1900, 5, 640, 1024]


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


def _kv_pools(gen, dtype, quant, NB):
    """K/V pools for an attention case: (kernel arguments, pools for the
    library call in q's dtype, K/V bytes per context token).  int8 pools
    hold random entries and positive scales with row maxima in [0.3, 3]."""
    from repro_torch.kernels.quant import dequantize_rows
    if not quant:
        k = torch.randn(NB, BS, KVH, HD, generator=gen).to(dtype).cuda()
        v = torch.randn(NB, BS, KVH, HD, generator=gen).to(dtype).cuda()
        return (k, v), (k, v), 2 * KVH * HD * k.element_size()
    pools = []
    for _ in range(2):
        p = torch.randint(-127, 128, (NB, BS, KVH, HD), generator=gen,
                          dtype=torch.int8).cuda()
        sc = ((0.3 + 2.7 * torch.rand(NB, BS, generator=gen)) / 127).cuda()
        pools += [p, sc]
    lib = tuple(dequantize_rows(p, sc, (-2, -1)).to(dtype)
                for p, sc in (pools[:2], pools[2:]))
    return tuple(pools), lib, 2 * (KVH * HD + 4)


def _attention_case(kind, dtype, gen, timer, do_time, quant=False,
                    heads=None):
    """``heads`` = (query heads, kv heads, offset): a TP rank's kv heads
    of the 4-head pool from the offset (``kv_head_offset``); default all
    of qwen3-30b-a3b's 32 and 4."""
    from repro_torch.kernels import ops, ref
    NB, MB = 1024, MAX_LEN // BS
    nq, nkv, off = heads or (H, KVH, 0)
    rng = dict(kv_head_offset=off, kv_heads=nkv)
    pools, (k_lib, v_lib), kv_tok_bytes = _kv_pools(gen, dtype, quant, NB)
    k_lib, v_lib = (t[:, :, off:off + nkv] for t in (k_lib, v_lib))
    kv_tok_bytes = (2 * nkv * HD * pools[0].element_size()
                    + (8 if quant else 0))
    if kind == "decode":
        lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32)
        bt = _tables(gen, lengths.tolist(), NB, MB).cuda()
        # each score with a standard deviation of 3, a peaked softmax
        q = (torch.randn(BATCH, nq, HD, generator=gen)
             * DECODE_Q_STD).to(dtype).cuda()
        lens = lengths.cuda()
        op, plain_op = (
            (ops.quant_block_paged_decode_attention,
             ref.quant_block_paged_decode_attention_ref) if quant else
            (ops.block_paged_decode_attention,
             ref.block_paged_decode_attention_ref))
        kern = lambda: op(q, *pools, bt, lens, **rng)
        plain = lambda: plain_op(q, *pools, bt, lens, **rng)
        plain32 = lambda: plain_op(q.float(), *(p.float() for p in pools),
                                   bt, lens, **rng)
        ctx_tok = int(lengths.sum())
        attended = nq * ctx_tok
        S = MB * BS
        kg = ref._gather_rows(k_lib, bt).reshape(BATCH, S, nkv, HD)
        vg = ref._gather_rows(v_lib, bt).reshape(BATCH, S, nkv, HD)
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
        # scores of standard deviation 3, as in decode
        q = (torch.randn(1, CHUNK, nq, HD, generator=gen)
             * DECODE_Q_STD).to(dtype).cuda()
        ctx_t = torch.tensor([ctx], dtype=torch.int32, device="cuda")
        ql_t = torch.tensor([q_len], dtype=torch.int32, device="cuda")
        op, plain_op = (
            (ops.quant_mixed_block_paged_attention,
             ref.quant_mixed_block_paged_attention_ref) if quant else
            (ops.mixed_block_paged_attention,
             ref.mixed_block_paged_attention_ref))
        kern = lambda: op(q, *pools, bt, ctx_t, ql_t, **rng)
        plain = lambda: plain_op(q, *pools, bt, ctx_t, ql_t, **rng)
        plain32 = lambda: plain_op(q.float(), *(p.float() for p in pools),
                                   bt, ctx_t, ql_t, **rng)
        ctx_tok = ctx
        q_abs = ctx - q_len + torch.arange(CHUNK)
        attended = nq * int(torch.minimum(q_abs + 1,
                                          torch.tensor(ctx)).sum())
        S = MB * BS
        kg = ref._gather_rows(k_lib, bt).reshape(1, S, nkv, HD)
        vg = ref._gather_rows(v_lib, bt).reshape(1, S, nkv, HD)
        t = torch.arange(S, device="cuda")
        qa = q_abs.cuda()
        mask = ((t[None, :] < ctx) & (t[None, :] <= qa[:, None]))[None, None]
        ql, kl, vl = q.transpose(1, 2).contiguous(), \
            kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()
        lib = lambda: sdpa(ql, kl, vl, mask)
        io = nbytes(q, q, bt, ctx_t, ql_t)
        label = f"B=1 Sq={CHUNK} ctx={ctx} q_len={q_len} peaked"
    if heads:
        label += f" H={nq} KVH={nkv} of {KVH} from head {off}"
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    # a second launch reuses the split counters the first left at 0
    require(torch.equal(kern(), got), f"{op.__name__}: a second launch "
            "differs from the first")
    excess = None
    if dtype == torch.bfloat16:
        excess = _require_one_bf16_rounding(got, plain32(), op.__name__)
    # the library call must compute the same function on its own inputs
    # (int8: the pools dequantized to q's dtype), on valid rows
    if kind != "decode":
        want_lib = ref.mixed_block_paged_attention_ref(q, k_lib, v_lib, bt,
                                                       ctx_t, ql_t)
        lib_out = lib().transpose(1, 2)
        torch.testing.assert_close(lib_out.float()[:, :kind[1]],
                                   want_lib.float()[:, :kind[1]],
                                   **TOL[dtype])
    else:
        want_lib = ref.block_paged_decode_attention_ref(q, k_lib, v_lib, bt,
                                                        lens)
        torch.testing.assert_close(lib()[:, :, 0].float(), want_lib.float(),
                                   **TOL[dtype])
    # K/V rows (and int8 scales) of the context, read once
    kv_bytes = ctx_tok * kv_tok_bytes
    ops_n = 4 * HD * attended
    b_ms, b_by = bound_ms(io + kv_bytes, ops_n, dtype)
    rec = {"case": label, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": io + kv_bytes, "ops": ops_n}
    if excess is not None:
        rec["rounding_excess"] = excess
    if do_time:
        rec.update(ms=timer(kern), plain_ms=timer(plain, iters=10),
                   library_ms=timer(lib))
    return rec, (q, pools, bt) if kind == "decode" else None


def _gmm_case(bank, C, dtype, aliased, gen, timer, do_time, quant=False,
              shape=(N_EXP, D_MODEL, MOE_FF), pad=0):
    """One bank's paged GMM over ``shape`` = (experts, d_model, moe_d_ff):
    qwen3-30b-a3b's by default, deepseek-v2-lite's (64, 2048, 1408) too;
    ``pad`` trailing table slots on page 0, as an expert-parallel device's
    table is padded to ``Elm`` slots."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant import dequantize_rows
    n_exp, d_model, moe_ff = shape
    P = 2 * n_exp
    Din, Fout = (d_model, moe_ff) if bank in ("wi", "wg") else \
        (moe_ff, d_model)
    perm = torch.randperm(P, generator=gen).to(torch.int32)
    table = (perm[torch.arange(n_exp) % (n_exp // 2)] if aliased
             else perm[:n_exp])
    if pad:
        table[n_exp - pad:] = 0
    table = table.cuda()
    x = torch.randn(n_exp, C, Din, generator=gen).to(dtype).cuda()
    if quant:
        # page maxima in [0.3, 3] / sqrt(Din): weights of a normal layer
        pool = torch.randint(-127, 128, (P, Din, Fout), generator=gen,
                             dtype=torch.int8).cuda()
        scales = ((0.3 + 2.7 * torch.rand(P, generator=gen))
                  / (127 * math.sqrt(Din))).cuda()
        kern = lambda: ops.quant_paged_gmm(table, pool, scales, x)
        plain = lambda: ref.quant_paged_gmm_ref(table, pool, scales, x)
        plain32 = lambda: ref.quant_paged_gmm_ref(table, pool, scales,
                                                  x.float())
        w = dequantize_rows(ref._gather_rows(pool, table),
                            ref._gather_rows(scales, table),
                            (-2, -1)).to(dtype)
        extra = int(torch.unique(table).numel()) * 4       # page scales
    else:
        pool = (torch.randn(P, Din, Fout, generator=gen)
                / math.sqrt(Din)).to(dtype).cuda()
        kern = lambda: ops.paged_gmm(table, pool, x)
        plain = lambda: ref.paged_gmm_ref(table, pool, x)
        plain32 = lambda: ref.paged_gmm_ref(table, pool, x.float())
        w = ref._gather_rows(pool, table).contiguous()
        extra = 0
    lib = lambda: torch.bmm(x, w)
    name = "quant_paged_gmm" if quant else "paged_gmm"
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lib().float(), want.float(), **TOL[dtype])
    require(torch.equal(kern(), got), f"{name}: a second launch differs "
            "from the first")
    excess = None
    if dtype == torch.bfloat16:
        excess = _require_one_bf16_rounding(got, plain32(), name)
    pages = int(torch.unique(table).numel())
    nb = pages * Din * Fout * pool.element_size() + extra \
        + nbytes(x, got, table)
    ops_n = 2 * n_exp * C * Din * Fout
    b_ms, b_by = bound_ms(nb, ops_n, dtype)
    rec = {"case": f"{bank} E={n_exp} C={C} [{Din}x{Fout}] pages={pages}"
                   + (" aliased" if aliased else "")
                   + (f" pad={pad}" if pad else ""),
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nb, "ops": ops_n}
    if excess is not None:
        rec["rounding_excess"] = excess
    if do_time:
        rec.update(ms=timer(kern), plain_ms=timer(plain, iters=10),
                   library_ms=timer(lib))
    return rec


def _flash_case(S, dtype, gen, timer, do_time, heads=(H, KVH, HD, HD),
                peaked=False):
    """Causal prefill attention of one prompt of S tokens (a serving
    bucket) against its plain version and causal SDPA, at ``heads`` =
    (query heads, kv heads, q/k width, v width): qwen3-30b-a3b's (32, 4,
    128, 128) by default, deepseek-v2-lite's MLA (16, 16, 192, 128; a
    TP rank's 8, 8, 192, 128 at tp = 2) or zamba2-2.7b's shared block
    (32, 32, 80, 80); scale 1/sqrt(q/k
    width).  ``peaked``: queries drawn for scores of standard deviation 3,
    and a bf16 output held to one rounding of the f32 answer."""
    from repro_torch.kernels import ops, ref
    nh, nkv, hd, hdv = heads
    scale = hd ** -0.5
    q = (torch.randn(1, S, nh, hd, generator=gen)
         * (DECODE_Q_STD if peaked else 1.0)).to(dtype).cuda()
    k = torch.randn(1, S, nkv, hd, generator=gen).to(dtype).cuda()
    v = torch.randn(1, S, nkv, hdv, generator=gen).to(dtype).cuda()
    kern = lambda: ops.flash_attention(q, k, v, True, scale)
    plain = lambda: ref.flash_attention_ref(q, k, v, True, scale)
    ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True, enable_gqa=True, scale=scale)
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lib().transpose(1, 2).float(), want.float(),
                               **TOL[dtype])
    excess = None
    if peaked and dtype == torch.bfloat16:
        excess = _require_one_bf16_rounding(
            got, ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         True, scale), "flash_attention")
    # 2 (hd + hdv) per attended (q, k, head)
    ops_n = 2 * (hd + hdv) * nh * S * (S + 1) // 2
    io = nbytes(q, k, v, got)
    b_ms, b_by = bound_ms(io, ops_n, dtype)
    rec = {"case": f"B=1 S={S} H={nh} KVH={nkv} hd={hd} hdv={hdv} causal"
                   + (" peaked" if peaked else ""),
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": io, "ops": ops_n}
    if excess is not None:
        rec["rounding_excess"] = excess
    if do_time:
        rec.update(ms=timer(kern), plain_ms=timer(plain, iters=10),
                   library_ms=timer(lib))
    return rec


def _require_one_bf16_rounding(got, want32, what, atol=3e-5):
    """bf16 ``got`` must be ``want32``, the f32 answer on the same inputs,
    rounded once: within half a bf16 step of it (a step is 2^(e-8) for a
    value in [2^(e-1), 2^e)), plus ``atol`` for f32 sums taken in another
    order.  A kernel that rounds the probabilities to bf16 before P.V
    fails this at peaked scores, well inside TOL."""
    half = torch.ldexp(torch.ones_like(want32),
                       torch.frexp(want32).exponent - 9)
    excess = ((got.float() - want32).abs() - half).max().item()
    require(excess <= atol, f"{what}: {excess:.3e} past one bf16 rounding "
            f"of the f32 answer")
    return excess


def _slot_decode_case(dtype, gen, timer, do_time, heads=(H, KVH, HD),
                      kv_range=None):
    """Decode over the slot-contiguous cache [B, 2048, KVH, hd] at ragged
    lengths, against its plain version and SDPA with a length mask over
    the cache's rows; ``heads`` = (query heads, kv heads, width):
    qwen3-30b-a3b's by default, zamba2-2.7b's (32, 32, 80) too;
    ``kv_range`` = (kv heads, offset): a TP rank's heads of the cache."""
    from repro_torch.kernels import ops, ref
    nh, nkv, hd = heads
    n, off = kv_range or (nkv, 0)
    rng = dict(kv_head_offset=off, kv_heads=n)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32)
    kc = torch.randn(BATCH, MAX_LEN, nkv, hd, generator=gen).to(dtype).cuda()
    vc = torch.randn(BATCH, MAX_LEN, nkv, hd, generator=gen).to(dtype).cuda()
    q = (torch.randn(BATCH, nh, hd, generator=gen)
         * DECODE_Q_STD).to(dtype).cuda()
    lens = lengths.cuda()
    kern = lambda: ops.paged_decode_attention(q, kc, vc, lens, **rng)
    plain = lambda: ref.paged_decode_attention_ref(q, kc, vc, lens, **rng)
    mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
            < lens.long()[:, None])[:, None, None, :]
    ql, kl, vl = q[:, :, None], \
        kc[:, :, off:off + n].transpose(1, 2).contiguous(), \
        vc[:, :, off:off + n].transpose(1, 2).contiguous()
    lib = lambda: sdpa(ql, kl, vl, mask)
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    require(torch.equal(kern(), got), "paged_decode_attention: a second "
            "launch differs from the first")
    excess = None
    if dtype == torch.bfloat16:
        excess = _require_one_bf16_rounding(
            got, ref.paged_decode_attention_ref(q.float(), kc.float(),
                                                vc.float(), lens, **rng),
            "paged_decode_attention")
    torch.testing.assert_close(lib()[:, :, 0].float(), want.float(),
                               **TOL[dtype])
    ctx_tok = int(lengths.sum())
    kv_bytes = ctx_tok * 2 * n * hd * kc.element_size()
    io = nbytes(q, got, lens) + kv_bytes
    ops_n = 4 * hd * nh * ctx_tok
    b_ms, b_by = bound_ms(io, ops_n, dtype)
    rec = {"case": f"B={BATCH} H={nh} KVH={nkv} hd={hd} S_max={MAX_LEN} "
                   f"lengths={DECODE_LENGTHS}"
                   + (f" kv heads {n} from {off}" if kv_range else ""),
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": io, "ops": ops_n}
    if excess is not None:
        rec["rounding_excess"] = excess
    if do_time:
        rec.update(ms=timer(kern), plain_ms=timer(plain, iters=10),
                   library_ms=timer(lib))
    return rec


def _kv_write_case(dtype, gen, timer, do_time, rows=((KVH, HD),) * 2):
    """One decode step's rows into a layer's two slot caches [B, 2048,
    *row] in one launch (``kv_cache_write_pair``): K and V of qwen3-30b-a3b
    by default, MLA's latent rows (512,) and rope-key rows (64,) too; slot
    0 writes at position 0, slot 1 at 2048 (dropped).  Must equal its
    plain version bit for bit; no single PyTorch call writes two caches,
    so it has no library time."""
    from repro_torch.kernels import ops, ref
    caches = [torch.randn(BATCH, MAX_LEN, *r, generator=gen).to(dtype)
              .cuda() for r in rows]
    new = [torch.randn(BATCH, *r, generator=gen).to(dtype).cuda()
           for r in rows]
    pos_l = [0, MAX_LEN] + torch.randint(1, MAX_LEN, (BATCH - 2,),
                                         generator=gen).tolist()
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    got = ops.kv_cache_write_pair(caches[0].clone(), new[0],
                                  caches[1].clone(), new[1], pos)
    want = ref.kv_cache_write_pair_ref(caches[0].clone(), new[0],
                                       caches[1].clone(), new[1], pos)
    torch.cuda.synchronize()
    for g, w, c in zip(got, want, caches):
        require(torch.equal(g, w), "kv_cache_write_pair differs from its "
                "plain version")
        require(torch.equal(g[1], c[1]), "the write at S_max was not "
                "dropped")
    kept = sum(0 <= p < MAX_LEN for p in pos_l)
    row_b = [n[0].numel() * n.element_size() for n in new]
    io = 2 * kept * sum(row_b) + nbytes(pos)
    b_ms, b_by = bound_ms(io, 0, dtype)
    rec = {"case": f"slot pair B={BATCH} S={MAX_LEN} rows of {row_b} B, "
                   f"pos={pos_l}",
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": 0.0,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": io, "ops": 0}
    if do_time:
        kc = [c.clone() for c in caches]
        rec.update(ms=timer(lambda: ops.kv_cache_write_pair(
                       kc[0], new[0], kc[1], new[1], pos)),
                   plain_ms=timer(lambda: ref.kv_cache_write_pair_ref(
                       kc[0], new[0], kc[1], new[1], pos), iters=10),
                   library_ms=None)
    return rec


#: operations per value of an int8 write: |x| and the max, the division,
#: the rounding, the clamp (f32, CUDA cores)
QUANT_OPS = 5


def _paged_write_case(kind, quant, gen, timer, do_time):
    """The paged KV write at qwen3-30b-a3b's shapes into bf16 pools, or
    int8 pools with their scales, from bf16 rows: ``"decode"`` is a decode
    step's 8 rows (``kv_paged_write``; slot 5 inactive on the NB sentinel,
    offsets ``DECODE_LENGTHS % 16``), ``"chunk"`` the 1,000-token prompt's
    last chunk of 8 blocks of 16 rows (``kv_block_write``; 7 blocks
    written, the eighth past the prompt on the sentinel).  Kernel and plain
    version must agree bit for bit, int8 rows and scales included, and a
    second launch must give the same bits.  Library yardstick (bf16 only):
    one ``index_put_`` of the kept K rows into one pool (picked before
    timing; the sentinel would fault there)."""
    from repro_torch.kernels import ops, ref
    NB = 1024
    pools = []
    for _ in range(2):
        if quant:
            pools += [torch.randint(-127, 128, (NB, BS, KVH, HD),
                                    generator=gen, dtype=torch.int8).cuda(),
                      (torch.rand(NB, BS, generator=gen) / 127).cuda()]
        else:
            pools += [torch.randn(NB, BS, KVH, HD, generator=gen)
                      .to(torch.bfloat16).cuda(), None]
    perm = torch.randperm(NB, generator=gen)[:BATCH].to(torch.int32)
    if kind == "decode":
        ids = perm.clone()
        ids[5] = NB
        lens = torch.tensor(DECODE_LENGTHS, dtype=torch.int32).cuda()
        shape = (BATCH, 1, KVH, HD)
    else:
        ids = perm.clone()
        ids[-1] = NB
        lens = None
        shape = (1, CHUNK, KVH, HD)
    ids = ids.cuda()
    new = [(torch.randn(shape, generator=gen)
            * torch.exp(torch.randn(shape[:2] + (1, 1), generator=gen)))
           .to(torch.bfloat16).cuda() for _ in range(2)]
    if kind == "decode":
        new = [t[:, 0] for t in new]                  # as the model's k[:, 0]
        fns, tail = (ops.kv_paged_write, ref.kv_paged_write_ref), (ids, lens)
    else:                                 # the pools as a one-layer stack
        fns, tail = (ops.kv_block_write, ref.kv_block_write_ref), (ids,)

    def call(fn, p):                                  # p = [k, ks, v, vs]
        if kind == "chunk":
            p = [None if t is None else t[None] for t in p]
        fn(p[0], p[2], *new, *tail, p[1], p[3])
    kern = lambda p: call(fns[0], p)
    plain = lambda p: call(fns[1], p)
    clone = lambda: [None if t is None else t.clone() for t in pools]
    want = clone()
    plain(want)
    for _ in range(2):
        got = clone()
        kern(got)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            require(g is None or torch.equal(g, w),
                    f"paged {kind} write ({'int8' if quant else 'bf16'}) "
                    f"differs from its plain version")
    live = int((ids < NB).sum())
    rows = live * (1 if kind == "decode" else BS)
    vals = rows * KVH * HD                             # a pool's values
    io = 2 * vals * 2 + nbytes(ids) + (0 if lens is None else nbytes(lens))
    io += 2 * vals * (1 if quant else 2) + (2 * rows * 4 if quant else 0)
    ops_n = 2 * vals * QUANT_OPS if quant else 0
    b_ms, b_by = bound_ms(io, ops_n,
                          torch.float32 if quant else torch.bfloat16)
    rec = {"case": f"paged {kind} write, {rows} of "
                   f"{BATCH if kind == 'decode' else CHUNK} token rows "
                   f"[{KVH},{HD}] bf16 into "
                   f"{'int8 pools + scales' if quant else 'bf16 pools'} "
                   f"[{NB},{BS},{KVH},{HD}]",
           "dtype": "int8" if quant else "bfloat16", "max_abs_err": 0.0,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": io, "ops": ops_n}
    if do_time:
        kp = clone()
        lib = None
        if not quant:
            keep = (ids < NB).nonzero().flatten()
            if kind == "decode":
                index = (ids[keep].long(), (lens[keep] % BS).long())
                src = new[0][keep].contiguous()
            else:
                index = (ids[keep].long(),)
                src = new[0][0].reshape(-1, BS, KVH, HD)[keep].contiguous()
            lp = pools[0].clone()
            lib = timer(lambda: lp.index_put_(index, src))
        rec.update(ms=timer(lambda: kern(kp)),
                   plain_ms=timer(lambda: plain(kp), iters=10),
                   library_ms=lib)
    return rec


def _mla_case(lengths, S_max, dtype, gen, timer, do_time, heads=MLA_H):
    """Absorbed MLA decode of ``heads`` query heads (the model's 16, or a
    TP rank's share) over deepseek-v2-lite's latent cache [B, S_max, 512]
    + [B, S_max, 64] at the model's scale, against its plain version
    and one SDPA call over the cache laid out as one kv head: q =
    [q_eff | q_rope], k = [c | kr], v = c, a length mask (a row of length
    0 has no SDPA counterpart: SDPA is held only where every length is
    above 0).  Each of the score's two products has a standard deviation
    of 3 after the scale (sum about 4.2), so the softmax is peaked as in
    decode: a few rows carry most of the weight, and a wrong score moves
    the output by the size of a row, not of the mean of the rows."""
    from repro_torch.kernels import ops, ref
    B = len(lengths)
    scale = (MLA_DN + MLA_DR) ** -0.5
    spread = 3 / scale
    qe = (torch.randn(B, heads, MLA_R, generator=gen)
          * spread * MLA_R ** -0.5).to(dtype).cuda()
    qr = (torch.randn(B, heads, MLA_DR, generator=gen)
          * spread * MLA_DR ** -0.5).to(dtype).cuda()
    c = torch.randn(B, S_max, MLA_R, generator=gen).to(dtype).cuda()
    kr = torch.randn(B, S_max, MLA_DR, generator=gen).to(dtype).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kern = lambda: ops.mla_decode_attention(qe, qr, c, kr, lens, scale)
    plain = lambda: ref.mla_decode_attention_ref(qe, qr, c, kr, lens, scale)
    ql = torch.cat([qe, qr], -1)[:, :, None]               # [B,H,1,576]
    kl = torch.cat([c, kr], -1)[:, None]                   # [B,1,S,576]
    vl = c[:, None]
    mask = (torch.arange(S_max, device="cuda")[None, :]
            < lens.long()[:, None])[:, None, None, :]
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask, enable_gqa=True, scale=scale)
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    for b, n in enumerate(lengths):
        if n == 0:
            require(not got[b].any(), "a length of 0 did not give zeros")
    # a second launch reuses the split counters the first left at 0
    require(torch.equal(kern(), got), "mla_decode_attention: a second "
            "launch differs from the first")
    excess = None
    if dtype == torch.bfloat16:
        excess = _require_one_bf16_rounding(
            got, ref.mla_decode_attention_ref(qe.float(), qr.float(),
                                              c.float(), kr.float(), lens,
                                              scale),
            "mla_decode_attention")
    if min(lengths) > 0:
        torch.testing.assert_close(lib()[:, :, 0].float(), want.float(),
                                   **TOL[dtype])
    # the latent rows up to each length read once, q read, out written
    ctx_tok = sum(min(n, S_max) for n in lengths)
    io = ctx_tok * (MLA_R + MLA_DR) * c.element_size() + nbytes(qe, qr, got,
                                                               lens)
    ops_n = 2 * heads * (2 * MLA_R + MLA_DR) * ctx_tok
    b_ms, b_by = bound_ms(io, ops_n, dtype)
    rec = {"case": f"B={B} H={heads} r={MLA_R} dr={MLA_DR} S_max={S_max} "
                   f"lengths={lengths}",
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": io, "ops": ops_n}
    if excess is not None:
        rec["rounding_excess"] = excess
    if do_time:
        rec.update(ms=timer(kern), plain_ms=timer(plain, iters=10),
                   library_ms=timer(lib))
    return rec


def _ssd_case(shape, dtype, gen, timer, do_time, a_scale=1.0):
    """The SSD chunk scan at ``shape`` = (B, S, H, P, N, chunk) against its
    plain version: x, B and C in ``dtype``, dt and A f32 from the
    reference test's distributions (dt in [0.01, 0.51], A in [-1.5, -0.5]:
    decays slow enough that the state carries across chunks), A times
    ``a_scale`` (20: up to 15 of decay a row, 140 within 16 rows, where
    a served mamba2's steepest head, A = -16 and dt near 0.69, decays 11
    a row, and where an exp that overflows shows as NaN; there
    the check runs the plain version on the CPU, whose f32 cumsum
    accumulates in double, where the card's sums in f32); y and the
    state are f32 from f32 sums on both sides.  The bound counts C.Bᵀ once
    per (sequence, chunk), the least the work needs (the Pallas kernel
    computes it per head: both counts are kept).  No single PyTorch call
    computes the scan: no library time."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import ssd_instance
    B, S, nh, P, N, chunk = shape
    x = torch.randn(B, S, nh, P, generator=gen).to(dtype).cuda()
    dt = (torch.rand(B, S, nh, generator=gen) * 0.5 + 0.01).cuda()
    A = (-(torch.rand(nh, generator=gen) + 0.5) * a_scale).cuda()
    Bm = torch.randn(B, S, N, generator=gen).to(dtype).cuda()
    Cm = torch.randn(B, S, N, generator=gen).to(dtype).cuda()
    kern = lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk)
    plain = lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    y, st = kern()
    if a_scale == 1.0:
        wy, ws = plain()
    else:
        wy, ws = (t.cuda() for t in ref.ssd_scan_ref(
            *(t.cpu() for t in (x, dt, A, Bm, Cm)), chunk))
    torch.cuda.synchronize()
    err = max((y - wy).abs().max().item(), (st - ws).abs().max().item())
    torch.testing.assert_close(y, wy, **SSD_TOL)
    torch.testing.assert_close(st, ws, **SSD_TOL)
    y2, st2 = kern()
    require(torch.equal(y2, y) and torch.equal(st2, st), "ssd_scan: a "
            "second launch differs from the first")
    Q = min(chunk, S)
    nc = -(-S // Q)
    # per (sequence, head, chunk): M.x 2Q²P, C.state and the state update
    # 2QNP each; C.Bᵀ 2Q²N once per (sequence, chunk), or per head as the
    # Pallas kernel computes it
    per_head = 2 * Q * Q * P + 4 * Q * N * P
    ops_n = B * nc * (2 * Q * Q * N + nh * per_head)
    ops_pallas = B * nc * nh * (2 * Q * Q * N + per_head)
    io = nbytes(x, dt, A, Bm, Cm, y, st)
    b_ms, b_by = bound_ms(io, ops_n, dtype)
    rec = {"case": f"B={B} S={S} H={nh} P={P} N={N} chunk={chunk} "
                   f"A x{a_scale:g} ({ssd_instance(x, Bm, Cm)})",
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": io, "ops": ops_n,
           "ops_pallas": ops_pallas, "library_ms": None}
    if do_time:
        rec.update(ms=timer(kern), plain_ms=timer(plain, iters=10))
    return rec


def phase_kernels():
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode, ops
    from repro_torch.models.moe import capacity_for
    # the GMMs' rows an expert at a chunk step (qwen3-30b-a3b: 10) and at
    # a 1,024-token prefill (deepseek-v2-lite-16b: 120)
    chunk_c = capacity_for(CHUNK, get_config("qwen3-30b-a3b"))
    prefill_c = capacity_for(1024, get_config("deepseek-v2-lite-16b"))
    gen = torch.Generator().manual_seed(0)
    timer = Timer()
    out = {name: [] for name in REPLACES}
    lens = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    # the paged KV writes of the serving path (the decode write first: the
    # kernels line's main case), then the slot pairs below
    for kind in ("decode", "chunk"):
        for quant in (False, True):
            out["kv_cache_write"].append(_paged_write_case(kind, quant, gen,
                                                           timer, True))
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        for S in (1024, 192, 64):          # the main case first
            out["flash_attention"].append(_flash_case(S, dtype, gen, timer,
                                                      timed))
        out["paged_decode_attention"].append(
            _slot_decode_case(dtype, gen, timer, timed))
        out["kv_cache_write"].append(_kv_write_case(dtype, gen, timer,
                                                    timed))
        torch.cuda.empty_cache()
    # MLA (deepseek-v2-lite): the decode kernel, the prefill instance at
    # q/k 192 and v 128, latent-row writes, the expert GMM's widths
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        mla = out["mla_decode_attention"]
        mla.append(_mla_case(DECODE_LENGTHS, MAX_LEN, dtype, gen, timer,
                             timed))                     # the main case
        span = (mla_decode.TOKENS_PER_BLOCK if dtype == torch.bfloat16
                else mla_decode.F32_TOKENS_PER_BLOCK)
        for lengths, S_max in (([1] * BATCH, MAX_LEN),
                               ([MAX_LEN] * BATCH, MAX_LEN),
                               ([1000, 999, 0, 1, 500, 64, 65, 1000], 1000),
                               ([span - 1, span, span + 1, 2 * span - 1,
                                 2 * span, 2 * span + 1, 0, 1],
                                2 * span + 1)):
            mla.append(_mla_case(lengths, S_max, dtype, gen, timer, False))
        # a TP rank's 8 heads (serve_scale_mla, tp = 2): a replica's 2
        # slots, as the phase gives them, and 4
        for lengths in (RANK_LENGTHS[:SCALE_BPR], RANK_LENGTHS):
            mla.append(_mla_case(lengths, MAX_LEN, dtype, gen, timer, timed,
                                 heads=MLA_H // 2))
        for S, nh in ((1024, MLA_H), (192, MLA_H), (1024, MLA_H // 2)):
            out["flash_attention"].append(_flash_case(
                S, dtype, gen, timer, timed,
                heads=(nh, nh, MLA_DN + MLA_DR, MLA_DV)))
        out["kv_cache_write"].append(_kv_write_case(
            dtype, gen, timer, timed, ((MLA_R,), (MLA_DR,))))
        torch.cuda.empty_cache()
    # Mamba2: the SSD scan (mamba2-1.3b's shape first: the main case), and
    # zamba2-2.7b's shared attention block at head width 80
    ssd = out["ssd_scan"]
    for shape, timed in ((SSD_MAMBA2, True), (SSD_ZAMBA2, True),
                         ((2, 512, 64, 64, 128, 256), False),
                         ((1, 1000, 64, 64, 128, 256), False),
                         ((1, 4096, 64, 64, 128, 256), False)):
        ssd.append(_ssd_case(shape, torch.bfloat16, gen, timer, timed))
    for shape in (SSD_MAMBA2, SSD_ZAMBA2):
        ssd.append(_ssd_case(shape, torch.bfloat16, gen, timer, False,
                             a_scale=20.0))
    ssd.append(_ssd_case(SSD_MAMBA2, torch.float32, gen, timer, False))
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        out["flash_attention"].append(_flash_case(
            1024, dtype, gen, timer, timed,
            heads=(ZAMBA_H, ZAMBA_H, ZAMBA_HD, ZAMBA_HD)))
        out["paged_decode_attention"].append(_slot_decode_case(
            dtype, gen, timer, timed, heads=(ZAMBA_H, ZAMBA_H, ZAMBA_HD)))
    # each flash instance at peaked scores and a ragged S: the bf16 output
    # is the f32 answer rounded once
    for heads in ((H, KVH, HD, HD), (MLA_H, MLA_H, MLA_DN + MLA_DR, MLA_DV),
                  (ZAMBA_H, ZAMBA_H, ZAMBA_HD, ZAMBA_HD), (H, KVH, 64, 64)):
        out["flash_attention"].append(_flash_case(
            1000, torch.bfloat16, gen, timer, False, heads, peaked=True))
    torch.cuda.empty_cache()
    for phase in ("serve", "serve_int8"):
        quant = phase == "serve_int8"
        dec_name, mix_name, gmm_name = PATH_KERNELS[phase][:3]
        decode, mixed = getattr(ops, dec_name), getattr(ops, mix_name)
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16
            rec, dec_inputs = _attention_case("decode", dtype, gen, timer,
                                              timed, quant)
            out[dec_name].append(rec)
            # the 1,000-token prompt's last chunk (the main case), a full
            # chunk, and a prompt's first chunk
            for kind in ((1000, 104), (512, 128), (CHUNK, CHUNK)):
                rec, _ = _attention_case(kind, dtype, gen, timer, timed,
                                         quant)
                out[mix_name].append(rec)
            # q_len == 1 through the mixed kernel is the decode's function,
            # within TOL (the split-context decode sums in another order)
            q, pools, bt = dec_inputs
            dec = decode(q, *pools, bt, lens)
            mix = mixed(q[:, None].contiguous(), *pools, bt, lens,
                        torch.ones_like(lens))
            torch.cuda.synchronize()
            torch.testing.assert_close(mix[:, 0].float(), dec.float(),
                                       **TOL[dtype])
            del dec_inputs, q, pools, bt
            for bank in ("wi", "wg", "wo"):
                for C in (1, 5, chunk_c):
                    out[gmm_name].append(_gmm_case(bank, C, dtype, False,
                                                   gen, timer, timed, quant))
            out[gmm_name].append(
                _gmm_case("wi", 5, dtype, True, gen, timer, False, quant))
            torch.cuda.empty_cache()
    # a TP rank's heads of the replicated cache (e2e_tp, serve_tp):
    # qwen3-30b-a3b's 16 query and 2 kv heads at tp = 2 and 8 and 1 at tp
    # = 4, from head 0 and past it, bf16 and int8 rows (timed past 0)
    for phase in ("serve", "serve_int8"):
        dec_name, mix_name = PATH_KERNELS[phase][:2]
        for nq, n, off in ((16, 2, 0), (16, 2, 2), (8, 1, 0), (8, 1, 3)):
            for kind, name in (("decode", dec_name), ((1000, 104), mix_name)):
                rec, _ = _attention_case(kind, torch.bfloat16, gen, timer,
                                         off > 0, phase == "serve_int8",
                                         heads=(nq, n, off))
                out[name].append(rec)
    for nq, n, off in ((16, 2, 0), (16, 2, 2), (8, 1, 0), (8, 1, 3)):
        out["paged_decode_attention"].append(_slot_decode_case(
            torch.bfloat16, gen, timer, off > 0, heads=(nq, KVH, HD),
            kv_range=(n, off)))
    torch.cuda.empty_cache()
    # qwen3-30b-a3b's expert-parallel shapes (serve_scale): each device's
    # table of Elm slots (32 at DP4; 22 at DP6, pad slots on page 0) over
    # n_ep * C rows an expert, at decode (2 slots a replica) and a chunk
    for ndev, pad in ((4, 0), (6, 1)):
        elm = -(-N_EXP // ndev)
        for T in (SCALE_BPR * ndev, CHUNK):
            rows = ndev * capacity_for(-(-T // ndev), get_config(
                "qwen3-30b-a3b"))
            for quant in (False, True):
                out["quant_paged_gmm" if quant else "paged_gmm"].append(
                    _gmm_case("wi", rows, torch.bfloat16, False, gen, timer,
                              False, quant, shape=(elm, D_MODEL, MOE_FF),
                              pad=pad))
    torch.cuda.empty_cache()
    # deepseek-v2-lite's: decode (C = 1) and a 1,024-token prefill (C =
    # 1024 * 6 / 64 * 1.25 = 120 rows an expert); int8 pages at its wi
    for dtype in (torch.bfloat16, torch.float32):
        for C in (1, prefill_c):
            for bank in ("wi", "wg", "wo"):
                out["paged_gmm"].append(_gmm_case(
                    bank, C, dtype, False, gen, timer,
                    dtype == torch.bfloat16, shape=(MLA_EXP, D_MODEL,
                                                    MLA_FF)))
            out["quant_paged_gmm"].append(_gmm_case(
                "wi", C, dtype, False, gen, timer, dtype == torch.bfloat16,
                quant=True, shape=(MLA_EXP, D_MODEL, MLA_FF)))
        torch.cuda.empty_cache()
    for name, recs in out.items():
        for r in recs:
            lib = r.get("library_ms")
            t = (f" kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                 f"library {'none' if lib is None else f'{lib:.4f} ms'},"
                 if "ms" in r else "")
            ex = (f" {r['rounding_excess']:.2e} past one bf16 rounding;"
                  if "rounding_excess" in r else "")
            log(f"[kernels] {name} {r['dtype']} {r['case']}: max_abs_err "
                f"{r['max_abs_err']:.3e};{ex}{t} bound {r['bound_ms']:.4f} "
                f"ms ({r['bound_by']})")
    del timer
    torch.cuda.empty_cache()
    return out


def _e2e(dtype_name, quant=False):
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("qwen3-30b-a3b"), num_layers=2,
                              dtype=dtype_name)
    store = "int8" if quant else None
    hmm = HMM(cfg, 1, batch_per_replica=BATCH, max_len=MAX_LEN,
              kv_mode="paged", kv_block_size=BS, kv_blocks_per_replica=512,
              expert_mode="pooled", seed=1, kv_dtype=store,
              expert_dtype=store, device="cuda")
    hmm.boot(ElasticConfig(1, 1, (0,)))
    params, cache = hmm.params, hmm.cache
    NB, MB = 512, MAX_LEN // BS
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, leaf in cache.items():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     device="cuda", dtype=torch.int8))
        elif name.endswith("_scale"):     # row maxima in [0.3, 3]
            leaf.copy_((0.3 + 2.7 * torch.rand(leaf.shape, generator=gen,
                                               device="cuda")) / 127)
        else:
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

    run()                                  # first calls: kernels loaded
    # the kernels' chunk and decode steps make no device-to-host sync
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, c_got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
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
    # layer 1's int8 rows quantize values that went through layer 0's
    # kernels: in f32 a rounding tie may land one quantum apart; in bf16
    # layer 0's outputs already differ by more than a rounding
    flips = max_q = 0
    for k in ("k", "v"):
        if quant:
            d = (c_got[k][1].int() - c_want[k][1].int()).abs()
            flips += int(d.count_nonzero())
            max_q = max(max_q, int(d.max()))
    if dtype_name == "float32":
        require(max_q <= 1, f"layer 1 int8 rows differ by {max_q} quanta")
    if dtype_name == "float32" and flips == 0:
        torch.testing.assert_close(got, want, **E2E_F32_TOL)
    else:
        require(rel < E2E_BF16_REL, f"{dtype_name} logits rel err {rel}")
    name = f"{dtype_name}{' int8 KV + int8 experts' if quant else ''}"
    log(f"[e2e] 2-layer qwen3-30b-a3b {name}: chunk + decode logits "
        f"{tuple(got.shape)}, max_abs_err {err:.3e}, rel {rel:.3e}"
        + (f", layer-1 int8 entries that differ: {flips} (at most "
           f"{max_q} quanta)" if quant else ""))
    return {"dtype": dtype_name, "int8": quant, "max_abs_err": err,
            "rel_err": rel, "layer1_int8_differing": flips,
            "layer1_int8_max_quanta": max_q}


def _e2e_dense(dtype_name):
    """The default stores (slot-contiguous KV, dense expert banks): a
    monolithic prefill of a 200-token prompt padded to its 256 bucket into
    slot 2 (the engine's own prefill step), then one decode step of the 8
    slots at ragged lengths, the last one full (its write drops)."""
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import _prefill_fn
    cfg = dataclasses.replace(get_config("qwen3-30b-a3b"), num_layers=2,
                              dtype=dtype_name)
    hmm = HMM(cfg, 1, batch_per_replica=BATCH, max_len=MAX_LEN, seed=1,
              device="cuda")
    hmm.boot(ElasticConfig(1, 1, (0,)))
    params, cache = hmm.params, hmm.cache
    require("wi" in params["blocks"]["moe"] and "moe_pool" not in params)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for leaf in cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    cg = torch.Generator().manual_seed(3)
    S, S_pad, slot = 200, 256, 2
    tokens = torch.zeros(1, S_pad, dtype=torch.int32)
    tokens[0, :S] = torch.randint(0, cfg.vocab_size, (S,), generator=cg)
    lengths = [1900, 5, S, 1024, 77, 300, 1500, MAX_LEN]
    dec_tokens = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=cg)
    args = [t.cuda() for t in (tokens, torch.tensor(S, dtype=torch.int32),
                               dec_tokens,
                               torch.tensor(lengths, dtype=torch.int32))]

    def run():
        c = {k: v.clone() for k, v in cache.items()}
        _, c = _prefill_fn(cfg, MAX_LEN, params, c, args[0], args[1], slot)
        lp, _ = M.prefill(cfg, params, {"tokens": args[0],
                                        "lengths": args[1][None]},
                          max_len=S_pad)
        ld, c = M.decode_step(cfg, params, args[2], c, args[3])
        return torch.cat([lp, ld]).float(), c

    got, c_got = run()
    with ops.use_reference():
        want, c_want = run()
    torch.cuda.synchronize()
    require(got.shape == (1 + BATCH, cfg.vocab_size))
    require(torch.isfinite(got).all() and torch.isfinite(want).all())
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    # layer 0's K/V rows (prefill and decode) come before any kernel
    for k in c_got:
        require(torch.equal(c_got[k][0], c_want[k][0]), f"cache {k} differs")
        require(not c_got[k][:, slot, S_pad:].any(),
                "the prefilled row is not zero past its bucket")
        require(torch.equal(c_got[k][:, BATCH - 1], cache[k][:, BATCH - 1]),
                "the write of the full slot was not dropped")
    if dtype_name == "float32":
        torch.testing.assert_close(got, want, **E2E_F32_TOL)
    else:
        require(rel < E2E_BF16_REL, f"{dtype_name} logits rel err {rel}")
    log(f"[e2e] 2-layer qwen3-30b-a3b {dtype_name} dense KV + dense banks: "
        f"prefill (S={S}, bucket {S_pad}) + decode logits "
        f"{tuple(got.shape)}, max_abs_err {err:.3e}, rel {rel:.3e}")
    return {"dtype": dtype_name, "store": "dense", "max_abs_err": err,
            "rel_err": rel}


def phase_e2e():
    out = []
    for quant in (False, True):
        for dtype_name in ("float32", "bfloat16"):
            out.append(_e2e(dtype_name, quant))
            torch.cuda.empty_cache()
    for dtype_name in ("float32", "bfloat16"):
        out.append(_e2e_dense(dtype_name))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _e2e_mla(dtype_name, expert_mode):
    """deepseek-v2-lite at full width, 2 layers (the dense layer, one MoE
    layer), dense KV with ``expert_mode``'s store: a monolithic prefill of
    a 200-token prompt padded to its 256 bucket into slot 2 (the engine's
    own prefill step), then three decode steps of the 8 slots at ragged
    lengths, the last one full (its writes drop)."""
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import _prefill_fn
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_layers=2, dtype=dtype_name)
    hmm = HMM(cfg, 1, batch_per_replica=BATCH, max_len=MAX_LEN, seed=1,
              expert_mode=expert_mode, device="cuda")
    hmm.boot(ElasticConfig(1, 1, (0,)))
    params, cache = hmm.params, hmm.cache
    require(set(cache) == {"c", "kr"} and len(params["dense_prefix"]) == 1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for leaf in cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    cg = torch.Generator().manual_seed(3)
    S, S_pad, slot, steps = 200, 256, 2, 3
    tokens = torch.zeros(1, S_pad, dtype=torch.int32)
    tokens[0, :S] = torch.randint(0, cfg.vocab_size, (S,), generator=cg)
    lengths = [1900, 5, S, 1024, 77, 300, 1500, MAX_LEN]
    dec_tokens = torch.randint(0, cfg.vocab_size, (steps, BATCH, 1),
                               generator=cg)
    args = [t.cuda() for t in (tokens, torch.tensor(S, dtype=torch.int32),
                               dec_tokens,
                               torch.tensor(lengths, dtype=torch.int32))]

    def run():
        c = {k: v.clone() for k, v in cache.items()}
        _, c = _prefill_fn(cfg, MAX_LEN, params, c, args[0], args[1], slot)
        out = [M.prefill(cfg, params, {"tokens": args[0],
                                       "lengths": args[1][None]},
                         max_len=S_pad)[0]]
        for i in range(steps):
            ld, c = M.decode_step(cfg, params, args[2][i], c, args[3] + i)
            out.append(ld)
        return torch.cat(out).float(), c

    got, c_got = run()
    with ops.use_reference():
        want, c_want = run()
    torch.cuda.synchronize()
    require(got.shape == (1 + steps * BATCH, cfg.vocab_size))
    require(torch.isfinite(got).all() and torch.isfinite(want).all())
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    for k in c_got:
        # layer 0's latent rows (prefill and decode) come before any
        # kernel; layer 1's went through layer 0's attention kernels
        require(torch.equal(c_got[k][0], c_want[k][0]), f"cache {k} differs")
        require(not c_got[k][:, slot, S_pad:].any(),
                "the prefilled row is not zero past its bucket")
        require(torch.equal(c_got[k][:, BATCH - 1], cache[k][:, BATCH - 1]),
                "the writes of the full slot were not dropped")
    layer1 = max((c_got[k][1].float() - c_want[k][1].float()).abs().max()
                 .item() for k in c_got)
    if dtype_name == "float32":
        torch.testing.assert_close(got, want, **E2E_F32_TOL)
    else:
        require(rel < E2E_BF16_REL, f"{dtype_name} logits rel err {rel}")
    log(f"[e2e_mla] 2-layer deepseek-v2-lite-16b {dtype_name}, dense latent "
        f"KV, {expert_mode} experts: prefill (S={S}, bucket {S_pad}) + "
        f"{steps} decode steps, logits {tuple(got.shape)}, max_abs_err "
        f"{err:.3e}, rel {rel:.3e}; layer 1 latent rows max_abs_err "
        f"{layer1:.3e}")
    return {"dtype": dtype_name, "expert_mode": expert_mode,
            "max_abs_err": err, "rel_err": rel, "layer1_cache_err": layer1}


def phase_e2e_mla():
    out = []
    for expert_mode in ("dense", "pooled"):
        for dtype_name in ("float32", "bfloat16"):
            out.append(_e2e_mla(dtype_name, expert_mode))
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _e2e_ssm(model, dtype_name, attn_every=1):
    """mamba2-1.3b or zamba2-2.7b at full width, 2 layers (zamba2 as two
    groups of one SSD layer, each led by the shared attention block: the
    reduced hybrid's layout; with ``attn_every`` 2, 4 layers as two groups
    of two, as the full model's groups of 6 share one block), the default
    stores: a monolithic prefill of a 200-token prompt padded to its 256
    bucket into slot 2 (the engine's own prefill step), then three decode
    steps of the 8 slots at ragged lengths, through the kernels and
    through ``ops.use_reference()``."""
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import _prefill_fn
    base = get_config(model)
    hybrid = base.arch_type == "hybrid"
    cfg = dataclasses.replace(base, num_layers=2 * attn_every,
                              dtype=dtype_name,
                              **({"attn_every": attn_every} if hybrid
                                 else {}))
    hmm = HMM(cfg, 1, batch_per_replica=BATCH, max_len=MAX_LEN, seed=1,
              device="cuda")
    hmm.boot(ElasticConfig(1, 1, (0,)))
    params, cache = hmm.params, hmm.cache
    require(set(cache) == ({"conv", "state", "attn_k", "attn_v"} if hybrid
                           else {"conv", "state"}))
    gen = torch.Generator(device="cuda").manual_seed(2)
    for leaf in cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    cg = torch.Generator().manual_seed(3)
    S, S_pad, slot, steps = 200, 256, 2, 3
    tokens = torch.zeros(1, S_pad, dtype=torch.int32)
    tokens[0, :S] = torch.randint(0, cfg.vocab_size, (S,), generator=cg)
    lengths = [1900, 5, S, 1024, 77, 300, 1500, 2000]
    dec_tokens = torch.randint(0, cfg.vocab_size, (steps, BATCH, 1),
                               generator=cg)
    args = [t.cuda() for t in (tokens, torch.tensor(S, dtype=torch.int32),
                               dec_tokens,
                               torch.tensor(lengths, dtype=torch.int32))]

    def run():
        c = {k: v.clone() for k, v in cache.items()}
        _, c = _prefill_fn(cfg, MAX_LEN, params, c, args[0], args[1], slot)
        out = [M.prefill(cfg, params, {"tokens": args[0],
                                       "lengths": args[1][None]},
                         max_len=S_pad)[0]]
        for i in range(steps):
            ld, c = M.decode_step(cfg, params, args[2][i], c, args[3] + i)
            out.append(ld)
        return torch.cat(out).float(), c

    ops.reset_launch_counts()
    got, c_got = run()
    counts = ops.launch_counts()
    with ops.use_reference():
        want, c_want = run()
    torch.cuda.synchronize()
    # two prefills (the slot's and the logits') of every SSD layer; each
    # decode step one shared-block attention a group
    require(counts["ssd_scan"] == 2 * cfg.num_layers, counts)
    require(counts["paged_decode_attention"]
            == (steps * 2 if hybrid else 0), counts)
    require(got.shape == (1 + steps * BATCH, cfg.vocab_size))
    require(torch.isfinite(got).all() and torch.isfinite(want).all())
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    # written before any kernel: the first SSD layer's raw conv tails
    # (mamba2), the first group's K/V rows (zamba2, whose first SSD layer
    # follows the shared block's attention kernels)
    for k in (("attn_k", "attn_v") if hybrid else ("conv",)):
        require(torch.equal(c_got[k][0], c_want[k][0]), f"cache {k} differs")
    state_err = (c_got["state"] - c_want["state"]).abs().max().item()
    if dtype_name == "float32":
        torch.testing.assert_close(got, want, **E2E_F32_TOL)
        torch.testing.assert_close(c_got["state"], c_want["state"],
                                   **E2E_F32_TOL)
    else:
        require(rel < E2E_BF16_REL, f"{dtype_name} logits rel err {rel}")
    stores = "per-slot SSD state" + (" + shared-attention KV" if hybrid
                                      else "")
    log(f"[e2e_ssm] {cfg.num_layers}-layer {model} {dtype_name}"
        f"{f', attn_every {attn_every}' if hybrid else ''}, {stores}: "
        f"prefill (S={S}, bucket {S_pad}) + {steps} decode steps, logits "
        f"{tuple(got.shape)}, max_abs_err {err:.3e}, rel {rel:.3e}; SSD "
        f"state max_abs_err {state_err:.3e}")
    return {"model": model, "dtype": dtype_name, "layers": cfg.num_layers,
            "attn_every": cfg.attn_every, "max_abs_err": err,
            "rel_err": rel, "state_err": state_err}


def phase_e2e_ssm():
    out = []
    for model, attn_every in (("mamba2-1.3b", 1), ("zamba2-2.7b", 1),
                              ("zamba2-2.7b", 2)):
        for dtype_name in ("float32", "bfloat16"):
            out.append(_e2e_ssm(model, dtype_name, attn_every))
            gc.collect()
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


DENSE_BUCKETS = tuple(range(64, 1025, 64))   # every prompt's bucket
SERVE_STORES = {
    # phase: (model, server knobs, KV/expert store)
    "serve": ("qwen3-30b-a3b",
              dict(kv_mode="paged", kv_block_size=BS, expert_mode="pooled",
                   prefill_chunk=CHUNK), None),
    "serve_int8": ("qwen3-30b-a3b",
                   dict(kv_mode="paged", kv_block_size=BS,
                        expert_mode="pooled", prefill_chunk=CHUNK,
                        kv_dtype="int8", expert_dtype="int8"), "int8"),
    # the reference's default knobs
    "serve_dense": ("qwen3-30b-a3b", dict(prefill_buckets=DENSE_BUCKETS),
                    None),
    # MLA: dense latent KV and monolithic prefill, either expert store
    "serve_mla": ("deepseek-v2-lite-16b",
                  dict(prefill_buckets=DENSE_BUCKETS), None),
    "serve_mla_pooled": ("deepseek-v2-lite-16b",
                         dict(prefill_buckets=DENSE_BUCKETS,
                              expert_mode="pooled"), None),
    # Mamba2: per-slot SSD state (and the hybrid's shared-attention KV),
    # buckets that are multiples of the SSD chunk, as the reference's
    # chunked scan asserts
    "serve_mamba2": ("mamba2-1.3b",
                     dict(prefill_buckets=(256, 512, 768, 1024)), None),
    "serve_zamba2": ("zamba2-2.7b",
                     dict(prefill_buckets=tuple(range(128, 1025, 128))),
                     None),
}


def _capped(cfg, layers):
    """``cfg`` at most ``layers`` deep (None: full depth); a hybrid's depth
    stays a multiple of its ``attn_every`` (one shared block a group)."""
    if layers is None or layers >= cfg.num_layers:
        return cfg
    if cfg.attn_every:
        layers = max(cfg.attn_every, layers - layers % cfg.attn_every)
    return dataclasses.replace(cfg, num_layers=layers)


def _describe(cfg, knobs, store):
    """The served model and its stores, for the serve phase's first
    line."""
    if cfg.arch_type in ("ssm", "hybrid"):
        arch = (f"{cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, state "
                f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}")
        if cfg.arch_type == "hybrid":
            arch += (f", one shared attention block ({cfg.num_heads} heads "
                     f"of {cfg.resolved_head_dim}, MLP {cfg.d_ff}) every "
                     f"{cfg.attn_every} layers")
        stores = ("per-slot SSD state"
                  + (" + shared-attention KV" if cfg.attn_every else ""))
    else:
        arch = (f"{cfg.num_experts} experts top-{cfg.top_k} "
                f"(+{cfg.num_shared_experts} shared, {cfg.first_k_dense} "
                f"dense layers first), moe_d_ff {cfg.moe_d_ff}")
        stores = (("paged KV" if knobs.get("kv_mode") == "paged"
                   else "dense latent KV" if cfg.use_mla else "dense KV")
                  + (", pooled experts" if knobs.get("expert_mode")
                     == "pooled" else ", dense expert banks"))
    return (f"{cfg.num_layers} layers, d_model {cfg.d_model}, {arch}, vocab "
            f"{cfg.vocab_size}, {cfg.dtype}; store: {store or cfg.dtype}, "
            f"{stores}" + (", chunked prefill" if knobs.get("prefill_chunk")
                           else ", monolithic prefill"))


def phase_serve(layers, phase="serve", profile=True, cuda_graphs=True):
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.workload import Request
    model, knobs, store = SERVE_STORES[phase]
    cfg = _capped(get_config(model), layers)
    tag = f"[{phase}]"
    paged = knobs.get("kv_mode") == "paged"
    pooled = knobs.get("expert_mode") == "pooled"
    if not cuda_graphs:
        tag = f"[{phase} eager]"
    log(f"{tag} {model}, {_describe(cfg, knobs, store)}, "
        f"{'CUDA graphs' if cuda_graphs else 'eager steps'}")
    gc.collect()                  # an earlier server's pools are freed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = ElasticServer(cfg, tp=1, batch_per_replica=BATCH, max_len=MAX_LEN,
                        seed=0, device="cuda", cuda_graphs=cuda_graphs,
                        **knobs)
    t0 = time.perf_counter()
    srv.boot(ElasticConfig(1, 1, (0,)))
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    # the steps' warm-up and capture (the IMM's compile), inside boot_s
    capture_s = srv.imm.stats["compile_s_total"]
    require((srv.engine.graphs is not None) == cuda_graphs,
            f"{tag} graphs bound: {srv.engine.graphs is not None}")
    mem_boot = torch.cuda.memory_allocated()
    held = 0
    stack = [srv.engine.params]
    while stack:                       # parameters held (index arrays out)
        t = stack.pop()
        if isinstance(t, dict):
            stack += t.values()
        elif isinstance(t, list):
            stack += t
        elif t.is_floating_point() or t.dtype == torch.int8:
            held += t.numel()
    log(f"{tag} boot {boot_s:.2f} s (capture {capture_s:.3f} s), "
        f"{mem_boot / 2**30:.2f} GiB allocated, {held:,} parameters held")

    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)
    out_len = 32
    reqs = [Request(rid=i, arrival_s=0.0, prompt_len=len(p),
                    output_len=out_len, prompt=p)
            for i, p in enumerate(prompts)]
    # paged: the prefix sharer arrives once the 17 blocks it matches are
    # written and registered; dense KV shares nothing, all arrive at once
    late = reqs[-1] if paged else None
    late_tokens = [int(t) for t in reqs[-1].prompt]
    for r in reqs:
        if r is not late:
            srv.submit(r)

    tracer = obs.install(obs.Tracer())
    ops.reset_launch_counts()
    ticks = []
    prefills = []
    first_token = {}
    prof_rows = None
    prof_ticks = []
    prof_overhead_s = 0.0
    n_chunks = 0                  # chunk executions (paged stores)
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
            prof_rows, prof_ticks = _profile(
                "decode ticks",
                lambda: srv.tick(time.perf_counter() - t_start), 3)
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
        ev = tracer.events()
        chunk_s = [e.dur for e in ev if e.name == "prefill.chunks"]
        n_chunks += sum(e.args["chunks"] for e in ev
                        if e.name == "chunk.plan")
        for e in ev:
            if e.name == "prefill.request":
                prefills.append((e.args["S_pad"], e.dur * 1e3))
                # a monolithic prefill's token is ready at the span's end
                first_token[e.args["rid"]] = e.t1 - t_start
        pre = chunk_s or [e.dur for e in ev if e.name == "prefill.request"]
        ticks.append({"ms": (te - ts) * 1e3, "chunk_ms": sum(chunk_s) * 1e3,
                      "chunks": len(pre)})
        tick += 1
        if late is None and all(r.finish_s is not None for r in reqs):
            break
        require(tick < 2000, "serving did not finish")
    wall = time.perf_counter() - t_start - prof_overhead_s
    obs.install(None)
    counts = ops.launch_counts()
    eng = srv.engine
    if cfg.use_mla:
        # each decode step: one MLA decode per layer; each prefill: one
        # flash attention per layer; pooled: three expert GMMs per MoE
        # layer per step and prefill
        L, steps = cfg.num_layers, eng._step_count
        want = {"mla_decode_attention": L * steps,
                "flash_attention": L * len(prefills)}
        if pooled:
            want["paged_gmm"] = (3 * (L - cfg.first_k_dense)
                                 * (steps + len(prefills)))
        for name, n in want.items():
            require(counts[name] == n, f"{name}: {counts[name]} launches, "
                    f"{n} expected")
        log(f"{tag} {steps} decode steps, {len(prefills)} prefills: "
            f"launches per decode step "
            f"{counts['mla_decode_attention'] / steps:g} "
            f"mla_decode_attention")
    if cfg.arch_type in ("ssm", "hybrid"):
        # each prefill: one SSD scan per layer and, in the hybrid, one
        # flash attention per group; each decode step: one slot decode
        # per group (none in mamba2)
        steps, n_pre = eng._step_count, len(prefills)
        groups = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
        want = {"ssd_scan": cfg.num_layers * n_pre,
                "flash_attention": groups * n_pre,
                "paged_decode_attention": groups * steps}
        for name, n in want.items():
            require(counts[name] == n, f"{name}: {counts[name]} launches, "
                    f"{n} expected")
        log(f"{tag} {steps} decode steps, {n_pre} prefills: launches per "
            f"prefill {counts['ssd_scan'] / n_pre:g} ssd_scan, "
            f"{counts['flash_attention'] / n_pre:g} flash_attention; per "
            f"decode step {counts['paged_decode_attention'] / steps:g} "
            f"paged_decode_attention")
    # every store: one KV write per attention layer per decode step (a slot
    # cache's K/V or latent pair, a pool's K/V rows with their int8
    # scales) and one per layer per chunk step (its blocks)
    if cfg.arch_type in ("ssm", "hybrid"):
        attn_layers = (cfg.num_layers // cfg.attn_every if cfg.attn_every
                       else 0)
    else:
        attn_layers = cfg.num_layers
    want_kv = attn_layers * (eng._step_count + n_chunks)
    require(counts["kv_cache_write"] == want_kv,
            f"kv_cache_write: {counts['kv_cache_write']} launches over "
            f"{eng._step_count} decode steps and {n_chunks} chunk steps of "
            f"{attn_layers} attention layers, {want_kv} expected")
    log(f"{tag} kv_cache_write: {counts['kv_cache_write']} launches, one "
        f"per attention layer ({attn_layers}) per decode step "
        f"({eng._step_count}) and chunk step ({n_chunks})")
    if paged:
        # each chunk step: one mixed attention per layer; each chunk step
        # and decode step: three GMMs per MoE layer
        _, mix, gmm = PATH_KERNELS[phase][:3]
        require(counts[mix] == cfg.num_layers * n_chunks,
                f"{mix}: {counts[mix]} launches over {n_chunks} chunks of "
                f"{cfg.num_layers} layers")
        per_step = 3 * (cfg.num_layers - cfg.first_k_dense)
        gmm_launches = {"decode": per_step * eng._step_count,
                        "chunk": per_step * n_chunks}
        require(counts[gmm] == sum(gmm_launches.values()),
                f"{gmm}: {counts[gmm]} launches, {gmm_launches} expected")
        log(f"{tag} {n_chunks} chunk steps: "
            f"{counts[mix] / n_chunks:g} {mix} launches each; {gmm} "
            f"{gmm_launches['chunk']} launches at a chunk's rows, "
            f"{gmm_launches['decode']} at decode")
    for r in reqs:
        toks = eng.generated[r.rid]
        require(len(toks) == out_len, (r.rid, len(toks)))
        require(all(0 <= t < cfg.vocab_size for t in toks))
    for name in PATH_KERNELS[phase]:
        require(counts[name] > 0, f"{name} was not launched while serving")
    # the served weights give finite logits of the expected shape
    head = torch.from_numpy(prompts[0][None, :CHUNK]).cuda()
    if paged:
        kv = eng.kv_stats()
        require(kv["shared_block_hits"] >= 17 and kv["cow_copies"] >= 1, kv)
        require(kv["used_blocks"] == 0)
        NB = eng.kv.num_blocks
        tbl = torch.full((1, MAX_LEN // BS), NB, dtype=torch.int32,
                         device="cuda")
        tbl[0, :CHUNK // BS] = torch.arange(CHUNK // BS)
        logits, _ = M.paged_chunk_prefill_step(
            cfg, eng.params, head, eng.cache, 0, CHUNK, tbl,
            tbl[0, :CHUNK // BS].contiguous())
    else:
        require(eng.kv_stats() is None and srv.hmm.kv_blocks is None)
        logits, _ = M.prefill(cfg, eng.params, {"tokens": head}, CHUNK)
    require(logits.shape == (1, cfg.vocab_size))
    require(torch.isfinite(logits).all())

    dec = [t["ms"] for t in ticks if not t["chunks"]]
    gen_tokens = sum(len(eng.generated[r.rid]) for r in reqs)
    res = {
        "model": model, "params_held": held,
        "layers": cfg.num_layers, "store": store or cfg.dtype,
        "knobs": {k: v for k, v in knobs.items() if k != "prefill_buckets"},
        "boot_s": boot_s, "boot_allocated_gib": mem_boot / 2**30,
        "cuda_graphs": cuda_graphs, "capture_s": capture_s,
        "tokens": {r.rid: list(eng.generated[r.rid]) for r in reqs},
        "ticks": len(ticks) + len(prof_ticks),
        "decode_tick_ms_median": statistics.median(dec),
        "decode_tick_ms_p90": float(np.percentile(dec, 90)),
        "decode_ticks": len(dec),
        "output_tok_s": gen_tokens / wall, "serve_s": wall,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts,
        "ttft_s": {r.rid: r.ttft for r in reqs},
        "profile": prof_rows, "profiled_ticks_ms": prof_ticks,
    }
    if paged:
        chunk = [t["chunk_ms"] / t["chunks"] for t in ticks if t["chunks"]]
        res.update(chunk_step_ms_median=statistics.median(chunk),
                   chunk_steps=len(chunk), gmm_launches=gmm_launches,
                   kv={k: kv[k] for k in ("shared_block_hits", "cow_copies",
                                          "preemptions")})
        pre_txt = (f"chunk step median {res['chunk_step_ms_median']:.2f} ms "
                   f"over {len(chunk)} chunks")
        # two more chunk steps of the 1,000-token prompt's last chunk (ctx
        # 1000, q_len 104) into freed pool rows 0.., traced
        long = max(prompts, key=len)
        S = len(long)
        start = (S - 1) // CHUNK * CHUNK
        toks = torch.zeros(1, CHUNK, dtype=torch.int32, device="cuda")
        toks[0, :S - start] = torch.from_numpy(long[start:])
        nblk = -(-S // BS)
        tbl = torch.full((1, MAX_LEN // BS), NB, dtype=torch.int32,
                         device="cuda")
        tbl[0, :nblk] = torch.arange(nblk)
        ids = torch.arange(start // BS, start // BS + CHUNK // BS,
                           dtype=torch.int32, device="cuda")
        ids[ids >= nblk] = NB                    # past the prompt: dropped
        if eng.graphs is not None:
            # the graph's replay, as the engine runs it: the inputs from
            # host arrays, the token read back
            host = [t.cpu().numpy() for t in (toks, tbl, ids)]

            def step():
                int(eng.graphs.chunk(0, host[0], start, S, host[1],
                                     host[2])[0])
        else:
            eager = eng.compiled[f"chunk_prefill_{CHUNK}"]

            def step():
                int(eager(eng.params, eng.cache, toks, start, S, tbl,
                          ids)[0][0])
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            step()
            walls.append((time.perf_counter() - ts) * 1e3)
        res["chunk_step_wall_ms"] = statistics.median(walls)
        res["chunk_profile"], _ = _profile(
            f"chunk steps of ctx {S}, q_len {S - start}", step, 2)
    else:
        # the server stamps a token with its tick's start; every request
        # arrived at 0, so its time to first token is its prefill's end
        res["ttft_s"] = first_token
        res["prefill_ms"] = prefills
        pre_txt = "prefill ms by bucket " + ", ".join(
            f"{S}: {ms:.2f}" for S, ms in prefills)
        # one more prefill of the longest prompt, into a freed slot, traced
        S = max(len(p) for p in prompts)
        S_pad = -(-S // 64) * 64
        toks = torch.zeros(1, S_pad, dtype=torch.int32, device="cuda")
        toks[0, :S] = torch.from_numpy(max(prompts, key=len))
        length = torch.tensor(S, dtype=torch.int32, device="cuda")
        step = eng.compiled[f"prefill_{S_pad}"]
        res["prefill_profile"], _ = _profile(
            f"prefills of {S} tokens (bucket {S_pad})",
            lambda: step(eng.params, eng.cache, toks, length, 0), 2)
    log(f"{tag} {len(reqs)} requests, {gen_tokens} tokens in {wall:.2f} s "
        f"({res['output_tok_s']:.2f} tok/s); decode tick median "
        f"{res['decode_tick_ms_median']:.2f} ms, p90 "
        f"{res['decode_tick_ms_p90']:.2f} ms over {len(dec)} ticks; "
        f"{pre_txt}; max_memory_allocated "
        f"{res['max_memory_allocated_gib']:.2f} GiB")
    log(f"{tag} launches {counts}" + (f"; kv {res['kv']}" if paged else ""))
    return res


def phase_serve_graphs(layers, done):
    """``serve`` and ``serve_mamba2`` (the most host-bound store) served
    eagerly (``cuda_graphs=False``) beside their graphed runs of this
    call (``done``; run here if their phases were not selected), one
    server at a time: the greedy tokens must be equal; prints each run's
    decode tick (unprofiled median and p90, device ms and idle share of 3
    profiled ticks), the chunk step (``serve``: unprofiled wall, device ms
    and idle share of the 1,000-token prompt's last chunk), the capture
    seconds and ``max_memory_allocated``."""
    res = {}
    for phase in ("serve", "serve_mamba2"):
        graphed = done.get(phase) or phase_serve(layers, phase)
        eager = phase_serve(layers, phase, cuda_graphs=False)
        require(graphed["tokens"] == eager["tokens"],
                f"[serve_graphs] {phase}: the graphed server's tokens "
                f"differ from the eager one's")
        row = {}
        for name, r in (("eager", eager), ("graphs", graphed)):
            prof = r["profile"]
            row[name] = {
                "decode_tick_ms_median": r["decode_tick_ms_median"],
                "decode_tick_ms_p90": r["decode_tick_ms_p90"],
                "decode_device_ms": prof["device_ms_per_call"],
                "decode_idle": 1 - prof["device_ms_per_call"]
                / prof["wall_ms_per_call"],
                "capture_s": r["capture_s"],
                "max_memory_allocated_gib": r["max_memory_allocated_gib"]}
            if "chunk_profile" in r:
                cp = r["chunk_profile"]
                row[name].update(
                    chunk_wall_ms=r["chunk_step_wall_ms"],
                    chunk_step_ms_median=r["chunk_step_ms_median"],
                    chunk_device_ms=cp["device_ms_per_call"],
                    chunk_idle=1 - cp["device_ms_per_call"]
                    / cp["wall_ms_per_call"])
            log(f"[serve_graphs] {phase} {name}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row[name].items()))
        log(f"[serve_graphs] {phase}: graphed tokens equal the eager "
            f"server's ({len(eager['tokens'])} requests)")
        res[phase] = row
        gc.collect()
        torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ scale phases

def _scale_cfgs(tp=1):
    """The scale phases' source and target: DP4 -> DP6 at tp = 1, DP2 x
    TP2 -> DP3 x TP2 at tp = 2 (4 -> 6 logical devices either way)."""
    from repro_torch.core.topology import ElasticConfig
    return (ElasticConfig(4 // tp, tp, (0, 1, 2, 3)),
            ElasticConfig(6 // tp, tp, tuple(range(6))))


def _require_copies_equal(cache, ecfg, what):
    """Every TP rank's copy of each replica's cache slice is rank 0's, bit
    for bit."""
    for name, leaf in cache.items():
        for r in range(ecfg.dp):
            devs = ecfg.devices[r * ecfg.tp:(r + 1) * ecfg.tp]
            for d in devs[1:]:
                require(torch.equal(leaf.shard(d), leaf.shard(devs[0])),
                        f"{what}: cache {name} on device {d} differs from "
                        f"rank 0's copy on {devs[0]}")


def _scale_ctx(ecfg, hmm):
    from repro_torch.distributed.sharding import make_instance_mesh
    from repro_torch.serving.engine import engine_parallel_ctx
    return engine_parallel_ctx(make_instance_mesh(ecfg, hmm.all_devices))


def _fill_pool(cache, gen, tp=1):
    """Random contents in every shard of a sharded KV pool: int8 entries,
    scales with row maxima in [0.3, 3], N(0, 1) rows; at tp > 1 the same
    contents in every TP rank's copy of a replica's slice."""
    for name, leaf in cache.items():
        for i, t in enumerate(leaf.shards.values()):
            if i % tp:
                t.copy_(list(leaf.shards.values())[i - i % tp])
            elif t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device="cuda", dtype=torch.int8))
            elif name.endswith("_scale"):
                t.copy_((0.3 + 2.7 * torch.rand(t.shape, generator=gen,
                                                device="cuda")) / 127)
            else:
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))


def _clone_pool(cache):
    from repro_torch.distributed.sharding import ShardedTensor
    return {k: ShardedTensor(v.shape, v.sharding,
                             {d: t.clone() for d, t in v.shards.items()})
            for k, v in cache.items()}


def _replica_tables(cg, lengths, dp, NB, extra=()):
    """Each replica's two sequences' tables, ids local to its pool slice
    of NB blocks; ``extra`` = (replica, length) of one more sequence
    there, whose table comes back apart."""
    MB = MAX_LEN // BS
    rows, extra_row = [], None
    for r in range(dp):
        mine = lengths[r * SCALE_BPR:(r + 1) * SCALE_BPR]
        first = [extra[1]] if extra and extra[0] == r else []
        t = _tables(cg, first + mine, NB, MB, need_extra=1)
        if first:
            extra_row, t = t[:1], t[1:]
        rows.append(t)
    return torch.cat(rows), extra_row


class _Routing:
    """While active, keeps the sorted top-k expert ids of every
    ``moe_ep`` shard, in call order (a wrapper around
    ``repro_torch.models.moe._topk``; device tensors, no host sync): it
    tells a near-tied expert choice that flipped from a numeric fault.  A
    call inside a CUDA graph's capture computes nothing and is not kept
    (nor is its sort captured); a replay calls no Python, so the graphed
    steps leave no record.  With ``force`` (one [T, k] id tensor a call)
    call i routes its rows to ``force[i]``'s experts instead, each weighed
    by its own router's probabilities renormalised over them."""

    def __init__(self, force=None):
        self.force = force

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.calls = moe, moe._topk, []

        def topk(p, x, k):
            out = self.orig(p, x, k)
            if self.force is not None:
                idx = self.force[len(self.calls)].to(out[1].device)
                w = out[0].gather(-1, idx)
                out = out[0], idx, w / w.sum(-1, keepdim=True)
            if not torch.cuda.is_current_stream_capturing():
                self.calls.append(out[1].sort(-1).values)
            return out
        moe._topk = topk
        return self.calls

    def __exit__(self, *exc):
        self.moe._topk = self.orig


def _routing_flips(r_got, r_want, n_ep, layers, q_len, B, got, want):
    """The rows whose top-k expert set differs between two runs of a
    chunk step (``layers`` MoE calls over its rows, ``q_len`` real) then
    a decode step of ``B`` rows, each call ``n_ep`` shards in row order;
    and the logits' relative error of the decode rows (``got[1:]``) with
    no flip in any layer, and of those with one."""
    calls = [[torch.cat(r[i:i + n_ep]) for i in range(0, len(r), n_ep)]
             for r in (r_got, r_want)]
    require(len(calls[0]) == len(calls[1]) == 2 * layers,
            f"{len(calls[0])} MoE calls recorded, expected {2 * layers}")
    diff = [(a != b).any(-1) for a, b in zip(*calls)]
    chunk = sum(int(d[:q_len].sum()) for d in diff[:layers])
    per_row = torch.stack([d[:B] for d in diff[layers:]]).any(0)

    def rel(rows):
        if not rows.any():
            return None
        g, w = got[1:][rows], want[1:][rows]
        return ((g - w).norm() / w.norm()).item()
    return {"chunk_rows": q_len * layers, "chunk_rows_flipped": chunk,
            "decode_rows": B * layers,
            "decode_rows_flipped": sum(int(d[:B].sum())
                                       for d in diff[layers:]),
            "rel_err_unflipped": rel(~per_row),
            "rel_err_flipped": rel(per_row),
            "rel_err_chunk": ((got[0] - want[0]).norm()
                              / want[0].norm()).item()}


def _e2e_scale_steps(cfg, hmm, ecfg, dtype_name, quant, tag="[e2e_scale]"):
    """One chunk step (replica 1's sequence; replica 0's on one replica)
    and one decode step of every replica's two slots on the HMM's instance
    on ``ecfg``, through the kernels (under ``set_sync_debug_mode
    ("error")``) and through ``ops.use_reference()`` from identical pools,
    held to the e2e rules; at tp > 1 every rank's copy of the cache must
    equal rank 0's after them."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    _fill_pool(hmm.cache, torch.Generator(device="cuda").manual_seed(2),
               ecfg.tp)
    ctx = _scale_ctx(ecfg, hmm)
    NB = hmm.kv_blocks_per_replica
    cg = torch.Generator().manual_seed(3)
    B = ecfg.dp * SCALE_BPR
    lengths = [1900, 5, 640, 1024, 77, 300, 1500, 16, 1000, 999, 64,
               2040][:B]
    start, length = 256, 360
    replica = min(1, ecfg.dp - 1)
    bt_dec, bt_chunk = _replica_tables(cg, lengths, ecfg.dp, NB,
                                       extra=(replica, length))
    ids = torch.full((CHUNK // BS,), NB, dtype=torch.int32)
    for j in range(CHUNK // BS):
        if start // BS + j < -(-length // BS):
            ids[j] = bt_chunk[0, start // BS + j]
    lens = torch.tensor(lengths, dtype=torch.int32)
    wb = bt_dec.gather(1, (lens.long() // BS)[:, None])[:, 0].clone()
    wb[min(5, B - 1)] = NB                            # inactive slot
    tokens = torch.randint(0, cfg.vocab_size, (1, CHUNK), generator=cg)
    dec_tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=cg)
    args = [t.cuda() for t in (tokens, bt_chunk, ids, dec_tokens, lens,
                               bt_dec, wb)]

    def run():
        c = _clone_pool(hmm.cache)
        lc, c = M.paged_chunk_prefill_step(cfg, hmm.params, args[0], c,
                                           start, length, args[1], args[2],
                                           parallel=ctx, replica=replica)
        ld, c = M.paged_decode_step(cfg, hmm.params, args[3], c, args[4],
                                    args[5], args[6], parallel=ctx)
        return torch.cat([lc, ld]).float(), c

    run()                                  # first calls: kernels loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with _Routing() as r_got:
            got, c_got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with ops.use_reference(), _Routing() as r_want:
        want, c_want = run()
    torch.cuda.synchronize()
    require(got.shape == (1 + B, cfg.vocab_size))
    require(torch.isfinite(got).all() and torch.isfinite(want).all())
    if ecfg.tp > 1:
        _require_copies_equal(c_got, ecfg, f"{tag} kernels")
        _require_copies_equal(c_want, ecfg, f"{tag} plain versions")
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    routing = _routing_flips(r_got, r_want, ecfg.dp * ecfg.tp,
                             cfg.num_layers, length - start, B, got, want)
    flips = max_q = 0
    for k in c_got:
        for d in c_got[k].shards:
            require(torch.equal(c_got[k].shard(d)[0], c_want[k].shard(d)[0]),
                    f"cache {k} on device {d} differs")
            if quant and k in ("k", "v"):
                q = (c_got[k].shard(d)[1].int()
                     - c_want[k].shard(d)[1].int()).abs()
                flips += int(q.count_nonzero())
                max_q = max(max_q, int(q.max()))
    if dtype_name == "float32":
        require(max_q <= 1, f"layer 1 int8 rows differ by {max_q} quanta")
    if dtype_name == "float32" and flips == 0:
        torch.testing.assert_close(got, want, **E2E_F32_TOL)
    else:
        require(rel < E2E_BF16_REL, f"{dtype_name} logits rel err {rel}")
    name = f"{dtype_name}{' int8 KV + int8 experts' if quant else ''}"
    log(f"{tag} 2-layer qwen3-30b-a3b {name} on {ecfg.describe()} "
        f"(one card): chunk + decode logits {tuple(got.shape)}, "
        f"max_abs_err {err:.3e}, rel {rel:.3e}"
        + (f", layer-1 int8 entries that differ: {flips}" if quant else ""))
    log(f"{tag} {name} on {ecfg.describe()}: top-k expert sets that differ "
        f"between the kernels' and the plain run: chunk rows "
        f"{routing['chunk_rows_flipped']} of {routing['chunk_rows']}, "
        f"decode rows {routing['decode_rows_flipped']} of "
        f"{routing['decode_rows']} (over the layers); logits rel err of "
        f"the decode rows with no flip {routing['rel_err_unflipped']}, "
        f"with one {routing['rel_err_flipped']}, of the chunk row "
        f"{routing['rel_err_chunk']:.3e}")
    return {"dtype": dtype_name, "int8": quant, "config": ecfg.describe(),
            "max_abs_err": err, "rel_err": rel,
            "layer1_int8_differing": flips, "routing": routing}


def phase_e2e_scale():
    """A 2-layer qwen3-30b-a3b at full width booted on DP4 (4 logical
    devices of the card), a chunk step and a decode step held to the e2e
    rules; then scaled to DP6 (stage, commit) and the same again."""
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    out = []
    for dtype_name, quant in (("float32", False), ("bfloat16", False),
                              ("bfloat16", True)):
        cfg = dataclasses.replace(get_config("qwen3-30b-a3b"), num_layers=2,
                                  dtype=dtype_name)
        store = "int8" if quant else None
        c4, c6 = _scale_cfgs()
        hmm = HMM(cfg, 1, batch_per_replica=SCALE_BPR, max_len=MAX_LEN,
                  kv_mode="paged", kv_block_size=BS,
                  kv_blocks_per_replica=256, expert_mode="pooled", seed=1,
                  kv_dtype=store, expert_dtype=store, device="cuda",
                  all_devices=["cuda:0"] * SCALE_DEVICES)
        hmm.boot(c4)
        out.append(_e2e_scale_steps(cfg, hmm, c4, dtype_name, quant))
        st = hmm.scale(c6)
        require(st.expert_p2p_bytes == len(hmm.last_migrations)
                * hmm.expert_page_nbytes())
        hmm.commit()
        out.append(_e2e_scale_steps(cfg, hmm, c6, dtype_name, quant))
        del hmm
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_e2e_tp():
    """A 2-layer qwen3-30b-a3b at full width booted on DP2 x TP2 and on DP1
    x TP4 (4 logical devices of the card): a chunk step and a decode step
    through the kernels and the plain versions, held to the e2e rules, and
    every rank's copy of the cache equal to rank 0's after them."""
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    out = []
    for dtype_name, quant in (("float32", False), ("bfloat16", False),
                              ("bfloat16", True)):
        cfg = dataclasses.replace(get_config("qwen3-30b-a3b"), num_layers=2,
                                  dtype=dtype_name)
        store = "int8" if quant else None
        for dp, tp in ((2, 2), (1, 4)):
            ecfg = ElasticConfig(dp, tp, (0, 1, 2, 3))
            hmm = HMM(cfg, tp, batch_per_replica=SCALE_BPR, max_len=MAX_LEN,
                      kv_mode="paged", kv_block_size=BS,
                      kv_blocks_per_replica=256, expert_mode="pooled",
                      seed=1, kv_dtype=store, expert_dtype=store,
                      device="cuda", all_devices=["cuda:0"] * 4)
            hmm.boot(ecfg)
            out.append(_e2e_scale_steps(cfg, hmm, ecfg, dtype_name, quant,
                                        tag="[e2e_tp]"))
            del hmm
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _scale_step_times(srv, tag):
    """A decode step of every slot (ragged lengths, each replica's tables
    in its own slice) and a chunk step of the 1,000-token prompt's last
    chunk (ctx 1000, q_len 104) on replica 0, into free pool blocks, on
    the engine's current instance, eager and, where the engine holds its
    CUDA graphs, replayed: the median wall of 5 unprofiled calls and the
    device time of 2 profiled ones each.  The graphed decode's tokens must
    equal the eager one's on the same inputs and state (both write the
    same rows)."""
    eng = srv.engine
    dp, NB, MB = eng.cfg.dp, eng.kv.blocks_per_partition, MAX_LEN // BS
    cg = torch.Generator().manual_seed(4)
    lengths = [600, 200, 1000, 431, 757, 318, 905, 264, 777, 64, 1500,
               17][:dp * SCALE_BPR]
    bt, _ = _replica_tables(cg, lengths, dp, NB)
    n = len(lengths)
    tokens = torch.randint(0, srv.mcfg.vocab_size, (n,), generator=cg)
    args = [t.cuda() for t in (tokens, torch.tensor(lengths,
                                                    dtype=torch.int32),
                               torch.ones(n, dtype=torch.bool), bt)]
    dec = eng.compiled["decode"]
    S, start = 1000, 896
    toks = torch.randint(0, srv.mcfg.vocab_size, (1, CHUNK), generator=cg)
    toks[0, S - start:] = 0
    nblk = -(-S // BS)
    tbl = torch.full((1, MB), NB, dtype=torch.int32)
    tbl[0, :nblk] = torch.arange(nblk)
    ids = torch.arange(start // BS, start // BS + CHUNK // BS,
                       dtype=torch.int32)
    ids[ids >= nblk] = NB
    chunk = eng.compiled[f"chunk_prefill_{CHUNK}"]
    cargs = [t.cuda() for t in (toks, tbl, ids)]
    steps = [("decode", lambda: dec(eng.params, eng.cache, *args)),
             ("chunk", lambda: chunk(eng.params, eng.cache, cargs[0], start,
                                     S, cargs[1], cargs[2], replica=0))]
    if eng.graphs is not None:
        host = [t.numpy() for t in (tokens.to(torch.int32),
                                    torch.tensor(lengths, dtype=torch.int32),
                                    torch.ones(n, dtype=torch.bool), bt)]
        want = dec(eng.params, eng.cache, *args)[0].cpu()
        got = eng.graphs.decode(*host).cpu()
        require(torch.equal(got, want), f"{tag} the graphed decode step's "
                f"tokens differ from the eager one's: {got} {want}")
        log(f"{tag} graphed decode step: tokens equal the eager step's")
        steps += [("graphed decode", lambda: eng.graphs.decode(*host)),
                  ("graphed chunk", lambda: eng.graphs.chunk(
                      0, toks.numpy(), start, S, tbl.numpy(), ids.numpy()))]
    out = {}
    for name, fn in steps:
        fn()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - ts) * 1e3)
        prof, _ = _profile(f"{tag} {name} steps", fn, 2)
        out[name] = {"wall_ms_median": statistics.median(walls),
                     "device_ms": prof["device_ms_per_call"],
                     "profiled_wall_ms": prof["wall_ms_per_call"],
                     "kernels": prof["kernels"][:12]}
        log(f"{tag} {name} step: unprofiled wall median "
            f"{out[name]['wall_ms_median']:.2f} ms, device "
            f"{out[name]['device_ms']:.2f} ms")
    return out


def _shard_ptrs(tree, devices):
    """(leaf path, logical device) -> data_ptr of the sharded leaves'
    shards on ``devices``."""
    from repro_torch.distributed.sharding import tree_leaves_with_path
    return {(path, d): leaf.shard(d).data_ptr()
            for path, leaf in tree_leaves_with_path(tree)
            for d in devices}


def _serve_scale(layers, store, timed, tp=1):
    """``serve_scale`` (tp = 1, DP4 -> DP6) or ``serve_tp`` (tp = 2, DP2 x
    TP2 -> DP3 x TP2) with one store, ``stage_scale`` at the 5th tick and
    ``switchover`` after as many ticks as the target has graphs (its
    decode step and a chunk step per replica): an overlapped staging
    captures one a poll with a tick between two polls, so
    ``serve_overlap``'s ticks run on the configurations these run on.
    The result keeps the greedy tokens and, under ``"_trace"`` (not
    written to the JSON), each tick's configuration, token counts and
    top-k expert sets (``_Ticks``), which ``serve_overlap`` compares its
    overlapped run with."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.workload import Request
    cfg = _capped(get_config("qwen3-30b-a3b"),
                  min(SCALE_LAYERS, layers or SCALE_LAYERS))
    L = cfg.num_layers
    tag = f"[{'serve_tp' if tp > 1 else 'serve_scale'} {store or 'bf16'}]"
    c0, c1 = _scale_cfgs(tp)
    srv = _scale_server(cfg, store, tp)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv.boot(c0)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    log(f"{tag} qwen3-30b-a3b, {L} layers, full width, paged KV, pooled "
        f"experts ({store or cfg.dtype}), chunked prefill, "
        f"{c0.describe()} -> {c1.describe()}, every logical device on the "
        f"one card; boot {boot_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    res = {"layers": L, "store": store or cfg.dtype, "boot_s": boot_s,
           "boot_allocated_gib": torch.cuda.memory_allocated() / 2**30}
    if timed:
        res[f"steps_dp{c0.dp}"] = _scale_step_times(
            srv, f"{tag} {c0.describe()}")

    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)
    out_len = 32
    reqs = [Request(rid=i, arrival_s=0.0, prompt_len=len(p),
                    output_len=out_len, prompt=p)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    eng = srv.engine
    tracer = obs.install(obs.Tracer())
    ops.reset_launch_counts()
    work = {c0.dp: [0, 0], c1.dp: [0, 0]}   # dp -> [decode steps, chunks]
    ticks = []
    tick = 0
    trace = _Ticks(eng, reqs)
    t_start = time.perf_counter()
    while not all(r.finish_s is not None for r in reqs):
        trace.mark()
        require(tick < 2000, "serving did not finish")
        dp = eng.cfg.dp
        steps0 = eng._step_count
        tracer.clear()
        ts = time.perf_counter()
        if tick == 4:
            # the 5th tick: stage the target while the source serves a
            # tick for each of the target's graphs, switch
            keep = _shard_ptrs({"params": eng.params, "cache": eng.cache},
                               c0.devices)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            ev = srv.stage_scale(c1)
            torch.cuda.synchronize()
            stage_synced = time.perf_counter() - ts
            staged = {f: getattr(ev.stats, f) for f in
                      ev.stats.BYTE_FIELDS}
            migs = len(srv.hmm.last_migrations)
            for k in range(1 + c1.dp):
                if k:
                    trace.mark()    # the loop marked the first
                srv.tick(time.perf_counter() - t_start)
            torch.cuda.synchronize()
            work[c0.dp][0] += eng._step_count - steps0
            work[c0.dp][1] += sum(e.args["chunks"] for e in tracer.events()
                                  if e.name == "chunk.plan")
            ts = time.perf_counter()
            srv.switchover()
            torch.cuda.synchronize()
            switch_synced = time.perf_counter() - ts
            res["scale"] = _check_scale(srv, ev, staged, migs, keep,
                                        stage_synced, switch_synced, tag,
                                        c0, c1)
            tick += 1
            continue
        srv.tick(ts - t_start)
        torch.cuda.synchronize()
        te = time.perf_counter()
        ev_ = tracer.events()
        chunks = sum(e.args["chunks"] for e in ev_ if e.name == "chunk.plan")
        work[dp][0] += eng._step_count - steps0
        work[dp][1] += chunks
        ticks.append({"dp": dp, "ms": (te - ts) * 1e3, "chunks": chunks,
                      "chunk_ms": sum(e.dur for e in ev_
                                      if e.name == "prefill.chunks") * 1e3})
        tick += 1
    wall = time.perf_counter() - t_start
    trace.close()
    obs.install(None)
    counts = ops.launch_counts()
    q = "quant_" if store else ""
    # every TP rank attends and writes its own copy of the KV; the GMMs
    # run on every logical device
    want = {
        f"{q}block_paged_decode_attention":
            L * tp * sum(dp * w[0] for dp, w in work.items()),
        f"{q}mixed_block_paged_attention":
            L * tp * sum(w[1] for w in work.values()),
        f"{q}paged_gmm": 3 * L * tp * sum(dp * (w[0] + w[1])
                                          for dp, w in work.items()),
        "kv_cache_write": L * tp * sum(dp * w[0] + w[1]
                                       for dp, w in work.items()),
    }
    for name, n in want.items():
        require(counts[name] == n, f"{name}: {counts[name]} launches, {n} "
                f"expected over {work} (dp: [decode steps, chunk steps])")
        require(n > 0, f"{name} was not launched")
    for r in reqs:
        toks = eng.generated[r.rid]
        require(len(toks) == out_len, (r.rid, len(toks)))
        require(all(0 <= t < cfg.vocab_size for t in toks))
    if timed:
        res[f"steps_dp{c1.dp}"] = _scale_step_times(
            srv, f"{tag} {c1.describe()}")
    if tp > 1:
        _require_copies_equal(eng.cache, c1, tag)
        res["collectives"] = _collective_times(cfg, eng, tag)
    dec = {dp: [t["ms"] for t in ticks if t["dp"] == dp and not t["chunks"]]
           for dp in work}
    chk = {dp: [t["chunk_ms"] / t["chunks"] for t in ticks
                if t["dp"] == dp and t["chunks"]] for dp in work}
    gen_tokens = sum(len(eng.generated[r.rid]) for r in reqs)
    res.update(
        launches=counts, work=work, serve_s=wall,
        tokens={r.rid: list(eng.generated[r.rid]) for r in reqs},
        _trace=trace,
        output_tok_s=gen_tokens / wall,
        decode_tick_ms_median={dp: statistics.median(v) if v else None
                               for dp, v in dec.items()},
        chunk_step_ms_median={dp: statistics.median(v) if v else None
                              for dp, v in chk.items()},
        ticks=len(ticks) + 1,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"{tag} {len(reqs)} requests, {gen_tokens} tokens in {wall:.2f} s; "
        f"decode ticks (no chunk) median {res['decode_tick_ms_median']} ms, "
        f"chunk step median {res['chunk_step_ms_median']} ms by dp; "
        f"[decode steps, chunk steps] by dp {work}; max_memory_allocated "
        f"{res['max_memory_allocated_gib']:.2f} GiB")
    log(f"{tag} launches " + str({k: counts[k] for k in want}))
    del srv, eng
    return res


def _collective_times(cfg, eng, tag):
    """The TP sums and gathers of the engine's instance at its step shapes,
    each timed alone with CUDA events (copies and adds on the one card),
    and ``per_step_ms``: the sum of those isolated times over the calls a
    step makes, not a reading from a step.  Per layer and replica one sum
    of the attention output, two gathers (the K and V rows) and one
    broadcast of the MoE output; per replica one sum of the embedding and
    one gather of the logits.  A decode step runs them for every replica
    (2 rows each), a chunk step for one (128 rows)."""
    from repro_torch.device import torch_dtype
    from repro_torch.distributed.sharding import (tp_all_gather,
                                                  tp_all_reduce,
                                                  tp_broadcast)
    timer = Timer()
    par = eng.parallel
    devs = [par.torch_device(d) for d in par.replica_devices(0)]
    tp, L, dt = par.tp, cfg.num_layers, torch_dtype(cfg.dtype)
    kvh, hd = cfg.num_kv_heads // tp, cfg.resolved_head_dim
    out = {}
    for name, rows, reps in (("decode", (SCALE_BPR, 1), par.dp),
                             ("chunk", (1, CHUNK), 1)):
        x = [torch.randn(*rows, cfg.d_model, device="cuda").to(dt)
             for _ in devs]
        kv = [torch.randn(*rows, kvh, hd, device="cuda").to(dt)
              for _ in devs]
        lg = [torch.randn(rows[0], cfg.vocab_size // tp,
                          device="cuda").to(dt) for _ in devs]
        t = {"all_reduce_ms": timer(lambda: tp_all_reduce(x, devs)),
             "all_gather_kv_ms": timer(lambda: tp_all_gather(kv, devs, 2)),
             "broadcast_ms": timer(lambda: tp_broadcast(x[0], devs)),
             "all_gather_logits_ms": timer(
                 lambda: tp_all_gather(lg, devs, -1))}
        t["per_step_ms"] = reps * (
            L * (t["all_reduce_ms"] + 2 * t["all_gather_kv_ms"]
                 + t["broadcast_ms"])
            + t["all_reduce_ms"] + t["all_gather_logits_ms"])
        out[name] = t
        log(f"{tag} TP sums and gathers at a {name} step's shapes, each "
            f"timed alone (copies and adds on the one card; per_step_ms "
            f"sums them over the step's calls): " + ", ".join(f"{k} {v:.4f}"
                                               for k, v in t.items()))
    del timer
    return out


def _check_scale(srv, ev, staged, migs, keep, stage_synced, switch_synced,
                 tag, c0, c1):
    """The switchover's invariants on the card: every parameter shard of
    the surviving devices but the rebuilt index arrays, and every KV
    shard, is the same tensor as before; the staged expert bytes are
    exactly the migrations' pages, the rest of the copies exactly the two
    new devices' non-expert shards (at tp = 2 each its TP rank's), commit
    moved no weight byte and zeroed the new replica's KV slice in each of
    its ranks' copies."""
    from repro_torch.distributed.sharding import tree_leaves_with_path
    eng, hmm = srv.engine, srv.hmm
    now = _shard_ptrs({"params": eng.params, "cache": eng.cache},
                      sorted({d for _, d in keep}))
    index = ("tables", "edest", "eslot", "gtable")
    moved = [k for k, p in keep.items()
             if now[k] != p and not k[0].endswith(index)]
    require(not moved, f"shards not reused: {moved[:5]}")
    page = hmm.expert_page_nbytes()
    E, Lm = hmm.mcfg.num_experts, hmm._n_moe_layers
    repl = sum(leaf.shard(0).nbytes
               for path, leaf in tree_leaves_with_path(eng.params)
               if not path.startswith("moe_pool")
               and not path.endswith(index))
    require(staged["expert_p2p_bytes"] == migs * page,
            (staged["expert_p2p_bytes"], migs, page))
    require(staged["expert_zero_copy_bytes"] == (Lm * E - migs) * page)
    n_new = c1.ndev - c0.ndev
    require(staged["p2p_bytes"] == migs * page + n_new * repl)
    require(staged["zero_copy_bytes"]
            == (Lm * E - migs) * page + c0.ndev * repl)
    require(staged["local_bytes"] == staged["init_bytes"] == 0)
    final = {f: getattr(ev.stats, f) for f in ev.stats.BYTE_FIELDS}
    require(final["p2p_bytes"] == staged["p2p_bytes"]
            and final["expert_p2p_bytes"] == staged["expert_p2p_bytes"],
            "commit moved weight bytes")
    kv = sum(leaf.nbytes for leaf in eng.cache.values())
    require(final["init_bytes"] == kv // c1.dp * (c1.dp - c0.dp) * c1.tp,
            (final["init_bytes"], kv))             # the new replicas' copies
    nonzero = {f: v for f, v in final.items() if v}
    rate = staged["p2p_bytes"] / stage_synced / 1e9
    log(f"{tag} scale {c0.describe()} -> {c1.describe()}: stage_s "
        f"{ev.stage_s:.3f} (host), "
        f"{stage_synced:.3f} s with the card synchronised; switch_s "
        f"{ev.switch_s:.4f} (host), {switch_synced:.4f} s synchronised; "
        f"{migs} expert pages moved (copies between logical devices on "
        f"one card); bytes {nonzero}; staged copies "
        f"{staged['p2p_bytes'] / 1e9:.3f} GB at {rate:.1f} GB/s")
    return {"stage_s": ev.stage_s, "stage_synced_s": stage_synced,
            "switch_s": ev.switch_s, "switch_synced_s": switch_synced,
            "migrations": migs, "staged_bytes": staged,
            "final_bytes": final, "copy_gb_s": rate}


def phase_serve_scale(layers, tp=1):
    """``serve_scale`` (tp = 1) or ``serve_tp`` (tp = 2): the bf16 server,
    its steps timed before and after the scale, then (after it is freed)
    the int8 one; the launches are their sum."""
    res = {}
    for store in (None, "int8"):
        res[store or "bf16"] = _serve_scale(layers, store, store is None, tp)
        gc.collect()
        torch.cuda.empty_cache()
    names = PATH_KERNELS["serve_tp" if tp > 1 else "serve_scale"]
    res["launches"] = {n: sum(r["launches"][n] for r in res.values())
                       for n in names}
    return res


# -------------------------------------------- scaling while serving

# the symbols of the hand-written kernels a paged serve step launches (a
# tick's path-kernel time is the device time of these, all on the default
# stream)
STEP_SYMBOLS = ("mma_gmm_kernel", "paged_decode_kernel", "mixed_mma_kernel",
                "paged_write_kernel")


class _Ticks:
    """A serve loop's per-tick record: the logical device count each tick
    ran on (the MoE's n_ep), each request's token count at each tick's
    start, and the sorted top-k expert ids of every MoE shard it routed
    (``_Routing``: device tensors, no host sync until ``close``)."""

    def __init__(self, eng, reqs):
        self.eng, self.reqs = eng, reqs
        self._routing = _Routing()
        self.calls = self._routing.__enter__()
        self.ticks = []             # (ndev, index of the tick's first call)
        self.lengths = []           # rid -> tokens, at each tick's start

    def _lengths(self):
        return {r.rid: len(self.eng.generated.get(r.rid, ()))
                for r in self.reqs}

    def mark(self):
        """A tick starts."""
        self.ticks.append((self.eng.cfg.ndev, len(self.calls)))
        self.lengths.append(self._lengths())

    def close(self):
        """The loop ended: keep host copies, release the engine (and with
        it the server's device memory)."""
        self._routing.__exit__(None, None, None)
        self.lengths.append(self._lengths())
        self.calls = [c.cpu() for c in self.calls]
        self.eng = self.reqs = None

    def tick_calls(self, i):
        """(n_ep, [the top-k sets of each MoE call's rows]) of tick i."""
        ndev, lo = self.ticks[i]
        hi = (self.ticks[i + 1][1] if i + 1 < len(self.ticks)
              else len(self.calls))
        cs = self.calls[lo:hi]
        return ndev, [torch.cat(cs[j:j + ndev])
                      for j in range(0, len(cs), ndev)]

    def tick_of(self, rid, j):
        """The tick that produced request ``rid``'s token ``j``."""
        return next(t for t in range(len(self.ticks))
                    if self.lengths[t + 1][rid] > j)


def _divergence(a, b, tok_a, tok_b):
    """Where two serve runs' greedy tokens part: each differing request's
    first differing token and the tick that produced it, and for every
    tick up to the last such one where the runs differ (the device count
    the tick ran on, or rows whose top-k expert set differs between the
    runs, over all its MoE calls)."""
    first = {}
    for rid, ta in tok_a.items():
        tb = tok_b[rid]
        if ta == tb:
            continue
        j = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 min(len(ta), len(tb)))
        first[rid] = (j, a.tick_of(rid, j), b.tick_of(rid, j))
    ticks = []
    last = max((max(t[1], t[2]) for t in first.values()), default=-1)
    for t in range(min(last + 1, len(a.ticks), len(b.ticks))):
        na, ca = a.tick_calls(t)
        nb, cb = b.tick_calls(t)
        flipped = sum(int((x[:n] != y[:n]).any(-1).sum())
                      for x, y in zip(ca, cb)
                      for n in [min(len(x), len(y))])
        if na != nb or flipped or len(ca) != len(cb):
            ticks.append({"tick": t, "ndev": [na, nb],
                          "moe_calls": [len(ca), len(cb)],
                          "rows_flipped": flipped})
    return {"requests_differing": first, "ticks": ticks}


def _strict_steps(eng):
    """Run the engine's decode step (its graph's input fill and replay,
    or the eager step) under ``set_sync_debug_mode("error")`` (a step that
    synchronises with the host raises) until the returned undo is called.
    The mode is global: the TransferEngine's workers run under it too.
    (The engine reads a final chunk's token, a sync by design; the chunk's
    model step is checked in ``e2e``.)"""
    def strict(fn):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run
    if eng.graphs is not None:
        graphs = eng.graphs
        graphs.decode = strict(graphs.decode)
        return lambda: vars(graphs).pop("decode")
    saved = {"decode": eng.compiled["decode"]}
    compiled = eng.compiled
    compiled.update({k: strict(f) for k, f in saved.items()})
    return lambda: compiled.update(saved)


def _device_split(prof, ticks):
    """Device ms a tick of a profiled window: the step kernels', all
    kernels' and the copies' (``Memcpy`` rows: the staging's side-stream
    copies are these and elementwise copy kernels); and the host's top
    rows by self time over every thread (CUDA runtime calls among them:
    ``cudaMalloc``, ``cudaEventSynchronize``), ms a tick."""
    step = total = copies = 0.0
    host = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            host.append((ev.self_cpu_time_total / 1e3, ev.key[:60],
                         ev.count))
            continue
        ms = ev.self_device_time_total / 1e3
        total += ms
        if any(s in ev.key for s in STEP_SYMBOLS):
            step += ms
        if "Memcpy" in ev.key or "copy" in ev.key.lower():
            copies += ms
    n = max(ticks, 1)
    host.sort(reverse=True)
    return {"step_kernels_ms": step / n, "device_ms": total / n,
            "copies_ms": copies / n,
            "host_top_ms": [(k, round(ms / n, 3), c) for ms, k, c
                            in host[:8]]}


def _scale_server(cfg, store, tp, **kw):
    from repro_torch.core.elastic_engine import ElasticServer
    gc.collect()
    torch.cuda.empty_cache()
    return ElasticServer(cfg, tp=tp, batch_per_replica=SCALE_BPR,
                         max_len=MAX_LEN, seed=0, device="cuda",
                         all_devices=["cuda:0"] * SCALE_DEVICES,
                         kv_mode="paged", kv_block_size=BS,
                         expert_mode="pooled", prefill_chunk=CHUNK,
                         kv_dtype=store, expert_dtype=store, **kw)


def _path_launches(counts, store, tag):
    """Each of the path's four kernels (bf16 or int8) was launched."""
    q = "quant_" if store else ""
    names = (f"{q}block_paged_decode_attention",
             f"{q}mixed_block_paged_attention", f"{q}paged_gmm",
             "kv_cache_write")
    for n in names:
        require(counts[n] > 0, f"{tag}: {n} was not launched")
    return {n: counts[n] for n in names}


def _serve_overlap(layers, store, serial):
    """``serve_overlap`` with one store: the ``serve_scale`` server and
    requests, DP4 -> DP6 with ``staging="overlap"`` and 4 transfer
    workers, the task opened before the 5th tick (where ``serve_scale``
    stages), a tick between every two polls; the ticks while ops are in
    flight run their decode steps under sync-debug "error".  Two ticks before
    the scale and the staging window are profiled.  ``serial`` is
    ``serve_scale``'s run of the same store in this call: its staged
    bytes and its tokens."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.driver import ScalePhase
    from repro_torch.serving.workload import Request
    cfg = _capped(get_config("qwen3-30b-a3b"),
                  min(SCALE_LAYERS, layers or SCALE_LAYERS))
    tag = f"[serve_overlap {store or 'bf16'}]"
    c0, c1 = _scale_cfgs()
    srv = _scale_server(cfg, store, 1, staging="overlap", transfer_workers=4)
    srv.boot(c0)
    srv.preinitialize(c1)
    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)
    reqs = [Request(rid=i, arrival_s=0.0, prompt_len=len(p), output_len=32,
                    prompt=p) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    eng = srv.engine
    tracer = obs.install(obs.Tracer())
    ops.reset_launch_counts()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    trace = _Ticks(eng, reqs)
    before, during, poll_ms, in_flight = [], [], [], 0
    task, prof_before, prof_during = None, None, None
    t_start = time.perf_counter()

    def timed_tick(out):
        trace.mark()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        srv.tick(ts - t_start)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - ts) * 1e3)

    while not all(r.finish_s is not None for r in reqs):
        require(len(trace.ticks) < 2000, "serving did not finish")
        n = len(trace.ticks)
        if n == 2:
            with profile(activities=acts) as prof_before:
                timed_tick(before)
                timed_tick(before)
            continue
        if n == 4 and task is None:
            with profile(activities=acts) as prof_during:
                cap0 = srv.imm.stats["compile_s_total"]
                t_task = time.perf_counter()
                task = srv.start_scale(c1)
                while task.phase is ScalePhase.STAGING:
                    in_flight += srv.hmm.staging_in_flight
                    undo = _strict_steps(eng)
                    try:
                        timed_tick(during)
                    finally:
                        undo()
                    tp = time.perf_counter()
                    task.advance(tp - t_start)
                    poll_ms.append((time.perf_counter() - tp) * 1e3)
                    if task.phase is ScalePhase.COMMITTING:
                        # the commit right after the poll that saw the
                        # copies land: the next tick runs on DP6, as in
                        # serve_scale (stage, one tick, switch)
                        task.advance(time.perf_counter() - t_start)
                torch.cuda.synchronize()
                task_wall = time.perf_counter() - t_task
                # the target's graphs, captured over STAGING's polls
                capture_s = srv.imm.stats["compile_s_total"] - cap0
            require(task.phase is ScalePhase.DONE, task.phase)
            require(task.event.compile_hit and eng.graphs is not None,
                    f"{tag} the target's graphs were not ready at the "
                    f"switchover")
            require(in_flight > 0, f"{tag} no tick started while the "
                    f"staging's ops were in flight")
            continue
        trace.mark()
        srv.tick(time.perf_counter() - t_start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    trace.close()
    obs.install(None)
    counts = ops.launch_counts()
    launches = _path_launches(counts, store, tag)
    st, ev = task.stage_stats, srv.events[-1]
    staged = {f: getattr(st, f) for f in st.BYTE_FIELDS}
    require(staged == serial["scale"]["staged_bytes"],
            f"{tag} staged bytes {staged} differ from the serial "
            f"stage_scale's {serial['scale']['staged_bytes']}")
    tokens = {r.rid: list(eng.generated[r.rid]) for r in reqs}
    for r in reqs:
        require(len(tokens[r.rid]) == 32, (r.rid, len(tokens[r.rid])))
    same_ticks = ([nd for nd, _ in trace.ticks]
                  == [nd for nd, _ in serial["_trace"].ticks])
    div = _divergence(trace, serial["_trace"], tokens, serial["tokens"])
    if same_ticks:
        # every tick ran on the configuration it ran on in the serial
        # run: the steps are the same, so the tokens must be
        require(tokens == serial["tokens"],
                f"{tag} tokens differ from the serial run's: {div}")
    spans = {e.name: e.dur for e in tracer.events() if e.tid == "scale"}
    dev_before = _device_split(prof_before, len(before))
    dev_during = _device_split(prof_during, len(during))
    res = {"store": store or cfg.dtype, "layers": cfg.num_layers,
           "stage_wall_s": st.wall_s, "op_s": st.op_s,
           "overlap_efficiency": task.overlap_efficiency,
           "stall_s": task.stall_s, "task_wall_s": task_wall,
           "stage_s": ev.stage_s, "switch_s": ev.switch_s,
           "capture_s": capture_s,
           "compile_hit": ev.compile_hit, "polls": len(poll_ms),
           "poll_ms": poll_ms,
           "ticks_during_staging": len(during),
           "ticks_started_in_flight": in_flight,
           "tick_ms_before": before, "tick_ms_during": during,
           "device_before": dev_before, "device_during": dev_during,
           "phase_spans_s": spans, "staged_bytes": staged,
           "tokens_equal_serial": tokens == serial["tokens"],
           "same_configs_per_tick": same_ticks, "divergence": div,
           "launches": counts, "path_launches": launches, "serve_s": wall}
    log(f"{tag} qwen3-30b-a3b, {cfg.num_layers} layers, {c0.describe()} "
        f"-> {c1.describe()} (every logical device cuda:0: the staged "
        f"copies are copies on the one card), staging='overlap', 4 "
        f"workers on side streams: stage_wall_s {st.wall_s:.4f}, op_s "
        f"{st.op_s:.4f}, overlap_efficiency "
        f"{task.overlap_efficiency:.3f}, stall_s {task.stall_s:.4f} "
        f"(serial stage_s in this call {serial['scale']['stage_s']:.4f}), "
        f"start_scale to DONE {task_wall:.4f} s, switch_s "
        f"{ev.switch_s:.4f} beside the target's capture {capture_s:.4f} s "
        f"(in STAGING, one graph a poll), compile_hit {ev.compile_hit}; "
        f"{len(poll_ms)} STAGING polls, the longest {max(poll_ms):.1f} ms")
    log(f"{tag} {len(during)} tick(s) served in STAGING, {in_flight} of "
        f"them started with ops in flight (their decode steps under "
        f"sync-debug 'error'), wall ms {during} against "
        f"{before} before the scale (both profiled); device ms a tick "
        f"before {dev_before}, during {dev_during}")
    log(f"{tag} staged bytes equal the serial stage_scale's: {staged}")
    log(f"{tag} tokens equal the serial run's: "
        f"{res['tokens_equal_serial']} (each tick on the same "
        f"configuration as there: {same_ticks}); where they part: {div}")
    log(f"{tag} phase spans (s): {spans}; launches {launches}")
    srv.hmm.close()
    del srv, eng
    return res


def phase_serve_overlap(layers, serial):
    """bf16, then int8 (after the bf16 server is freed); ``serial`` is
    this call's ``serve_scale`` result."""
    res = {}
    for store in (None, "int8"):
        res[store or "bf16"] = _serve_overlap(layers, store,
                                              serial[store or "bf16"])
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = {n: sum(r["launches"][n] for r in res.values())
                       for n in PATH_KERNELS["serve_overlap"]}
    return res


def _down_requests(cfg, c_from, c_to):
    """The survivors' slots (below ``c_to``'s) take short requests (one
    128-token chunk, 4 tokens out) that finish early and leave their slots
    free; the doomed slots take the 1,000-token prompt and three more
    (600, 431, 757 tokens), 40 tokens out, still decoding at the scale."""
    from repro_torch.serving.workload import Request
    rng = np.random.default_rng(5)
    keep = c_to.dp * SCALE_BPR
    doomed = c_from.dp * SCALE_BPR - keep
    lens = [128] * keep + [1000, 600, 431, 757][:doomed]
    outs = [4] * keep + [40] * doomed
    return [Request(rid=i, arrival_s=0.0, prompt_len=n, output_len=o,
                    prompt=rng.integers(0, cfg.vocab_size, n).astype(
                        np.int32))
            for i, (n, o) in enumerate(zip(lens, outs))]


def _block_rows(eng, block):
    """Every leaf's rows of pool block ``block`` in each TP rank's copy of
    its replica's slice (views)."""
    bpp = eng.kv.blocks_per_partition
    r, tp = block // bpp, eng.parallel.tp
    return [leaf.shard(eng.parallel.devices[r * tp + t])[:, block - r * bpp]
            for leaf in eng.cache.values() for t in range(tp)]


def _checked_copies(eng):
    """Wrap ``finish_migration`` to hold, before the cut-over, every moved
    block's rows (and scales) in each TP copy of the destination against
    the source block's, which are frozen from the planning on (their
    sequences are paused, and commit frees them only in this call): the
    comparisons stay on the card, counted into one device tensor read
    after the run.  Returns [blocks compared, mismatching rows]."""
    finish = eng.finish_migration
    out = [0, torch.zeros((), dtype=torch.int64, device=eng.device)]

    def finish_migration(job):
        for src, dst in job.ticket.pairs:
            for g, w in zip(_block_rows(eng, dst), _block_rows(eng, src)):
                out[1] += (g != w).any()
            out[0] += 1
        finish(job)
    eng.finish_migration = finish_migration
    return out


def _serve_down(layers, store, mode, tp=1, scale=True):
    """One ``serve_down`` run: DP6 -> DP4 (tp = 1) or DP3 x TP2 -> DP2 x
    TP2 (tp = 2) while serving ``_down_requests``, the task (overlapped
    staging, 4 workers) opened at the first tick where every doomed slot's
    sequence has decoded 4 tokens; ``scale=False`` serves the same
    requests unscaled on the target."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.driver import ScalePhase
    cfg = _capped(get_config("qwen3-30b-a3b"),
                  min(SCALE_LAYERS, layers or SCALE_LAYERS))
    c_from = ElasticConfig(6 // tp, tp, tuple(range(6)))
    c_to = ElasticConfig(4 // tp, tp, (0, 1, 2, 3))
    what = mode if scale else "unscaled"
    tag = (f"[serve_down{'_tp' if tp > 1 else ''} {store or 'bf16'} "
           f"{what}]")
    # overlapped staging: the weights land within a tick or two, so the
    # doomed sequences are still mid-decode when MIGRATING begins (serial
    # staging takes one unit a poll, about 30 ticks)
    srv = _scale_server(cfg, store, tp, scaledown=mode, staging="overlap",
                        transfer_workers=4)
    srv.boot(c_from if scale else c_to)
    reqs = _down_requests(cfg, c_from, c_to)
    for r in reqs:
        srv.submit(r)
    eng = srv.engine
    keep = c_to.dp * SCALE_BPR
    doomed = range(keep, c_from.dp * SCALE_BPR)
    checked = _checked_copies(eng)
    tracer = obs.install(obs.Tracer())
    ops.reset_launch_counts()
    task, ticks, t_task, task_wall, drain_ticks = None, 0, 0.0, 0.0, 0
    at_scale = None
    t_start = time.perf_counter()
    while not all(r.finish_s is not None for r in reqs) or (
            task is not None and not task.done):
        require(ticks < 3000, "serving did not finish")
        if scale and task is None and all(
                eng.slots[s].active and not eng.slots[s].prefilling
                and len(eng.generated.get(eng.slots[s].rid, ())) >= 4
                for s in doomed):
            at_scale = {"tick": ticks, "doomed": {
                eng.slots[s].rid: {"slot": s,
                                   "tokens": int(eng.lengths[s]),
                                   "blocks": len(eng.kv.block_table(
                                       eng.slots[s].rid))}
                for s in doomed},
                "free_survivor_slots": len(eng.free_slots())}
            torch.cuda.synchronize()
            t_task = time.perf_counter()
            task = srv.start_scale(c_to)
        srv.tick(time.perf_counter() - t_start)
        ticks += 1
        if task is not None and not task.done:
            if task.phase is ScalePhase.DRAINING:
                drain_ticks += 1
            task.advance(time.perf_counter() - t_start)
            if task.done:
                torch.cuda.synchronize()
                task_wall = time.perf_counter() - t_task
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    obs.install(None)
    counts = ops.launch_counts()
    launches = _path_launches(counts, store, tag)
    tokens = {r.rid: list(eng.generated[r.rid]) for r in reqs}
    for r in reqs:
        require(len(tokens[r.rid]) == r.output_len,
                (r.rid, len(tokens[r.rid])))
        require(all(0 <= t < cfg.vocab_size for t in tokens[r.rid]))
    res = {"store": store or cfg.dtype, "mode": what, "tp": tp,
           "tokens": tokens, "launches": counts, "path_launches": launches,
           "serve_s": wall, "ticks": ticks}
    if scale:
        require(task.phase is ScalePhase.DONE and srv.hmm.active_cfg == c_to,
                f"{tag} ended in {task.phase}")
        srv.hmm.kv_blocks.check_invariants()
        require(srv.hmm.kv_blocks.num_partitions == c_to.dp)
        spans = {e.name: e.dur for e in tracer.events() if e.tid == "scale"}
        mig_s = spans.get("scale.MIGRATING", 0.0)
        res.update(at_scale=at_scale, task_wall_s=task_wall,
                   phase_spans_s=spans, migrated_blocks=task.migrated_blocks,
                   migration_bytes=task.migration_bytes,
                   blocks_checked=checked[0],
                   block_nbytes=eng.block_nbytes(),
                   preemptions=eng.preemptions, drain_ticks=drain_ticks,
                   stall_s=task.stall_s,
                   copy_gb_s=(task.migration_bytes / mig_s / 1e9
                              if mig_s else None))
        if mode == "migrate":
            require(eng.preemptions == 0, f"{tag} preempted "
                    f"{eng.preemptions} sequence(s) instead of moving them")
            require(task.migrated_blocks > 0 and "scale.MIGRATING" in spans)
            require(checked[0] == task.migrated_blocks,
                    (checked[0], task.migrated_blocks))
            require(int(checked[1]) == 0, f"{tag} {int(checked[1])} moved "
                    f"rows differ from their source rows")
            require(task.migration_bytes
                    == task.migrated_blocks * eng.block_nbytes())
        else:
            require(task.migrated_blocks == 0 and drain_ticks > 0)
        if tp > 1:
            _require_copies_equal(eng.cache, c_to, tag)
        log(f"{tag} qwen3-30b-a3b, {cfg.num_layers} layers, "
            f"{c_from.describe()} -> {c_to.describe()} (every logical "
            f"device cuda:0: a block move is a copy on the one card), "
            f"scaledown='{mode}': at the scale {at_scale}; "
            f"migrated_blocks {task.migrated_blocks} "
            f"({checked[0]} held bit for bit against their source "
            f"rows: equal), migration_bytes {task.migration_bytes} "
            f"({eng.block_nbytes()} B a block), MIGRATING "
            f"{mig_s * 1e3:.2f} ms, start_scale to DONE "
            f"{task_wall * 1e3:.2f} ms, drain ticks {drain_ticks}, "
            f"preemptions {eng.preemptions}, stall_s {task.stall_s:.4f}, "
            f"copy rate {res['copy_gb_s']} GB/s; phase spans (s) {spans}")
    log(f"{tag} {len(reqs)} requests in {ticks} ticks, {wall:.2f} s; "
        f"launches {launches}")
    srv.hmm.close()
    del srv, eng
    return res


def _compare_tokens(got, want, tag, what):
    same = [rid for rid in got if got[rid] == want[rid]]
    parts = {rid: next((i for i, (x, y) in enumerate(zip(got[rid],
                                                         want[rid]))
                        if x != y), None)
             for rid in got if rid not in same}
    log(f"{tag} tokens equal to {what}'s for {len(same)} of {len(got)} "
        f"requests; first differing position of the others {parts}")
    return {"equal": len(same), "of": len(got), "first_differing": parts}


def phase_serve_down(layers, tp=1):
    """``serve_down`` (tp = 1): bf16 with ``scaledown="migrate"``, with
    ``"drain"`` and unscaled on DP4; int8 migrate and unscaled.
    ``serve_down_tp`` (tp = 2): bf16 migrate and unscaled."""
    res = {}
    runs = ([(None, "migrate"), (None, "drain"), ("int8", "migrate")]
            if tp == 1 else [(None, "migrate")])
    for store, mode in runs:
        key = f"{store or 'bf16'}_{mode}"
        res[key] = _serve_down(layers, store, mode, tp)
        if mode == "migrate":
            res[f"{store or 'bf16'}_unscaled"] = _serve_down(
                layers, store, mode, tp, scale=False)
    tag = f"[serve_down{'_tp' if tp > 1 else ''}]"
    for key, r in list(res.items()):
        if r["mode"] == "unscaled":
            continue
        base = res[f"{key.split('_')[0]}_unscaled"]
        r["vs_unscaled"] = _compare_tokens(r["tokens"], base["tokens"],
                                           f"{tag} {key}", "the unscaled "
                                           "run")
    names = PATH_KERNELS["serve_down_tp" if tp > 1 else "serve_down"]
    res["launches"] = {n: sum(r["launches"][n] for r in res.values())
                       for n in names}
    return res


# ------------------------------------------ the dense layout, scaled

# phase: (model, depth cap, tp, output tokens, server knobs); DP(4/tp) x
# TPtp -> DP(6/tp) x TPtp -> back, by drain.  zamba2's eager twin ticks at
# about 0.5 s (54 layers, every replica launching its own SSD kernels),
# so its requests are shorter: the drain still waits on the new
# replicas' sequences
DENSE_SCALE = {
    "serve_scale_mla": ("deepseek-v2-lite-16b", SCALE_LAYERS, 2, 32,
                        dict(prefill_buckets=DENSE_BUCKETS,
                             expert_mode="pooled")),
    "serve_scale_zamba2": ("zamba2-2.7b", None, 1, 16,
                           dict(prefill_buckets=tuple(range(128, 1025,
                                                            128)))),
}
# the ticks the scales start at: up at the 9th, switchover three ticks
# later, the drain back six ticks after that
UP_TICK, STAGED_TICKS, DOWN_AFTER = 8, 3, 6


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip() \
        .splitlines()[0]


def _dense_vs_one_device(cfg, srv, ecfg, knobs, tag):
    """The first decode step of every slot of the server's instance on
    ``ecfg``, on random cache contents (the same in every TP copy), held
    against the one-device step at the same weights (an HMM with the same
    seed and expert store on one device) to the e2e bf16 rule; every TP
    rank's copy of the cache must equal rank 0's after it.  Both steps
    run the model with no capacity drops: which routed entries a capacity
    drops depends on how the experts are split over the devices, and
    this check holds the split arithmetic (the TP sums, the expert
    parallel dispatch) against one device's.  A near-tied top-k choice
    that flips between the two moves a row by the size of an expert's
    output, so the rows are sorted by whether any layer's choice differs,
    and the one-device step runs a second time from the same cache with
    every layer routed as the devices routed: both its logits and those
    of the rows with no flip must be within ``E2E_BF16_SAME_ROUTES_REL``
    of the split step's."""
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.models import model as M
    eng = srv.engine
    B = ecfg.dp * SCALE_BPR
    one = HMM(cfg, 1, batch_per_replica=B, max_len=MAX_LEN, seed=0,
              device="cuda", expert_mode=knobs.get("expert_mode", "dense"))
    one.boot(ElasticConfig(1, 1, (0,)))
    gen = torch.Generator(device="cuda").manual_seed(2)
    multi = _clone_pool(eng.cache)
    for n, leaf in one.cache.items():
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
        for _, idx, t in multi[n].addressable_shards:
            t.copy_(leaf[idx])
    cg = torch.Generator().manual_seed(3)
    lengths = torch.tensor((RANK_LENGTHS + [77, 300, 1500, 16])[:B],
                           dtype=torch.int32).cuda()
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=cg,
                           dtype=torch.int32).cuda()
    whole = dataclasses.replace(cfg, capacity_factor=100.0)
    with _Routing() as r_multi:
        got, multi = M.decode_step(whole, eng.params, tokens, multi, lengths,
                                   parallel=eng.parallel)
    again = {n: leaf.clone() for n, leaf in one.cache.items()}
    with _Routing() as r_one:
        want, _ = M.decode_step(whole, one.params, tokens, one.cache, lengths)
    _require_copies_equal(multi, ecfg, f"{tag} one-device check")
    # each MoE layer's top-k sets of the B rows: ecfg.ndev shards a layer
    # across the devices, in row order (padding rows last), one call on
    # one device
    routes = [torch.cat(r_multi[i:i + ecfg.ndev])[:B]
              for i in range(0, len(r_multi), ecfg.ndev)]
    n_moe = cfg.num_layers - cfg.first_k_dense if cfg.is_moe else 0
    require(len(routes) == len(r_one) == n_moe,
            (len(r_multi), len(r_one), n_moe))
    flipped = torch.zeros(B, dtype=torch.bool, device=got.device)
    for a, b in zip(routes, r_one):
        flipped |= (a != b).any(-1)
    # the one-device step again from the same cache, routed as the devices
    # routed: only the order of the sums differs
    with _Routing(force=routes):
        same, _ = M.decode_step(whole, one.params, tokens, again, lengths)
    got, want, same = got.float(), want.float(), same.float()
    require(got.shape == want.shape == (B, cfg.vocab_size))
    require(torch.isfinite(got).all() and torch.isfinite(want).all())

    def rel_of(ref, rows):
        if not rows.any():
            return None
        return ((got[rows] - ref[rows]).norm() / ref[rows].norm()).item()
    err = (got - want).abs().max().item()
    rel = rel_of(want, torch.ones_like(flipped))
    res = {"max_abs_err": err, "rel_err": rel,
           "rows_flipped": int(flipped.sum()), "moe_layers": n_moe,
           "rel_err_unflipped": rel_of(want, ~flipped),
           "rel_err_flipped": rel_of(want, flipped),
           "rel_err_same_routes": rel_of(same, torch.ones_like(flipped))}
    require(rel < E2E_BF16_REL, f"{tag} logits rel err {rel} against the "
            f"one-device step")
    for k in ("rel_err_unflipped", "rel_err_same_routes"):
        require(res[k] is None or res[k] < E2E_BF16_SAME_ROUTES_REL,
                f"{tag} {k} {res[k]} against the one-device step")
    log(f"{tag} first decode step of {B} slots on {ecfg.describe()} "
        f"against the one-device step at the same weights: max_abs_err "
        f"{err:.3e}, rel {rel:.3e}; rows whose top-k expert set differs in "
        f"some of the {n_moe} MoE layers: {res['rows_flipped']} of {B}; "
        f"rel of the rows with no flip {res['rel_err_unflipped']}, with "
        f"one {res['rel_err_flipped']}; rel against the one-device step "
        f"routed as the devices routed {res['rel_err_same_routes']:.3e} "
        f"(limit {E2E_BF16_SAME_ROUTES_REL})")
    del one, multi, again
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _decode_profile(srv, tag):
    """Three replays of the source configuration's decode graph with every
    slot active (ragged lengths), profiled before any request arrives; the
    cache is restored after them, so the served run starts from the state
    its eager twin starts from."""
    eng = srv.engine
    B = eng.num_slots
    saved = {n: {d: t.clone() for d, t in leaf.shards.items()}
             for n, leaf in eng.cache.items()}
    lengths = np.array([600, 200, 1000, 431, 757, 318, 905, 264][:B],
                       np.int32)
    tokens, active = np.arange(B, dtype=np.int32), np.ones(B, np.int32)
    prof, _ = _profile(f"{tag} graphed decode steps of {B} slots on "
                       f"{eng.cfg.describe()}",
                       lambda: eng.graphs.decode(tokens, lengths, active), 3)
    for n, leaf in eng.cache.items():
        for d, t in leaf.shards.items():
            t.copy_(saved[n][d])
    del saved
    return prof


def _medians(ticks, stage):
    ms = [t["ms"] for t in ticks if t["stage"] == stage and t["steps"]
          and not t["prefills"]]
    return statistics.median(ms) if ms else None


def _serve_scale_dense(layers, phase, cuda_graphs):
    """One run of ``serve_scale_mla`` or ``serve_scale_zamba2`` (module
    note), graphed or its eager twin."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.elastic_engine import ElasticServer
    from repro_torch.kernels import ops
    from repro_torch.serving.driver import ScalePhase
    from repro_torch.serving.workload import Request
    model, cap, tp, out_len, knobs = DENSE_SCALE[phase]
    cfg = _capped(get_config(model),
                  layers if cap is None else min(cap, layers or cap))
    c0, c1 = _scale_cfgs(tp)
    tag = f"[{phase}{'' if cuda_graphs else ' eager'}]"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = ElasticServer(cfg, tp=tp, batch_per_replica=SCALE_BPR,
                        max_len=MAX_LEN, seed=0, device="cuda",
                        all_devices=["cuda:0"] * SCALE_DEVICES,
                        cuda_graphs=cuda_graphs, **knobs)
    t0 = time.perf_counter()
    srv.boot(c0)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    eng = srv.engine
    log(f"{tag} {model}, {_describe(cfg, knobs, None)}, {c0.describe()} -> "
        f"{c1.describe()} -> {c0.describe()} (drain), every logical device "
        f"on the one card, {'CUDA graphs' if cuda_graphs else 'eager'}; "
        f"boot {boot_s:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    res = {"layers": cfg.num_layers, "boot_s": boot_s, "card": _card()}
    if cuda_graphs:
        res["one_device"] = _dense_vs_one_device(cfg, srv, c0, knobs, tag)
        res["profile"] = _decode_profile(srv, tag)
    rng = np.random.default_rng(0)
    lens = [600, 200, 1000, 431, 757, 318, 905, 264, 777, 64, 512, 333,
            128, 960][:c1.dp * SCALE_BPR + 2]
    reqs = [Request(rid=i, arrival_s=0.0, prompt_len=n, output_len=out_len,
                    prompt=rng.integers(0, cfg.vocab_size, n).astype(
                        np.int32))
            for i, n in enumerate(lens)]
    for r in reqs:
        srv.submit(r)
    tracer = obs.install(obs.Tracer())
    ops.reset_launch_counts()
    ticks, stage, task, events = [], "before", None, {}
    drain_s = drain_ticks = None
    n = 0
    t_start = time.perf_counter()
    while any(r.finish_s is None for r in reqs) or (
            task is not None and not task.done):
        require(n < 3000, "serving did not finish")
        if n == UP_TICK:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            ev = srv.stage_scale(c1)
            torch.cuda.synchronize()
            events["up"] = {"stage_synced_s": time.perf_counter() - ts,
                            "staged": {f: getattr(ev.stats, f)
                                       for f in ev.stats.BYTE_FIELDS}}
            stage = "during"
        elif n == UP_TICK + STAGED_TICKS:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            srv.switchover()
            torch.cuda.synchronize()
            events["up"]["switch_synced_s"] = time.perf_counter() - ts
            stage = "after"
        elif n == UP_TICK + STAGED_TICKS + DOWN_AFTER:
            torch.cuda.synchronize()
            t_task = time.perf_counter()
            task = srv.start_scale(c0)
            while task.phase in (ScalePhase.STAGING, ScalePhase.COMPILING):
                task.advance(time.perf_counter() - t_start)
            stage, drain_ticks = "drain", 0
        dp, steps0 = eng.cfg.dp, eng._step_count
        tracer.clear()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        srv.tick(ts - t_start)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - ts) * 1e3
        prefills = sum(1 for e in tracer.events()
                       if e.name == "prefill.request")
        ticks.append({"stage": stage, "dp": dp, "ms": ms,
                      "prefills": prefills,
                      "steps": eng._step_count - steps0})
        if task is not None and not task.done:
            drain_ticks += 1
            task.advance(time.perf_counter() - t_start)
            if task.done:
                torch.cuda.synchronize()
                drain_s = time.perf_counter() - t_task
                stage = "final"
        # every rank's copy of the cache, after every step
        _require_copies_equal(eng.cache, eng.cfg, f"{tag} tick {n}")
        n += 1
    wall = time.perf_counter() - t_start
    obs.install(None)
    counts = ops.launch_counts()
    require(task.phase is ScalePhase.DONE and srv.hmm.active_cfg == c0,
            f"{tag} the scale-down ended in {task.phase}")
    require(task.migrated_blocks == 0 and srv.scaledown_mode == "drain")
    require(len(srv.events) == 2, [e.dst for e in srv.events])
    up, down = srv.events
    for name, ev in (("up", up), ("down", down)):
        events.setdefault(name, {}).update(
            stage_s=ev.stage_s, switch_s=ev.switch_s,
            final={f: getattr(ev.stats, f) for f in ev.stats.BYTE_FIELDS})
    # the scale-up's copies: the two new devices' shards; commit zeroed the
    # new replica's KV slice in each rank's copy
    st, fin = events["up"]["staged"], events["up"]["final"]
    require(st["p2p_bytes"] > 0 and st["zero_copy_bytes"] > 0)
    replica_kv = sum(leaf.nbytes for leaf in eng.cache.values()) // c0.dp
    require(fin["init_bytes"] == replica_kv * (c1.dp - c0.dp) * c1.tp,
            (fin["init_bytes"], replica_kv))
    if not cfg.is_moe:
        # no experts: everything is replicated, so the staged copies are
        # two whole replicas and the rest is reused
        repl = sum(leaf.shard(0).nbytes for leaf in _leaves(eng.params))
        require(st["p2p_bytes"] == (c1.ndev - c0.ndev) * repl
                and st["zero_copy_bytes"] == c0.ndev * repl,
                (st, repl))
    # launches from the ticks' work: decode steps by replica count, and
    # prefills (each on one replica's ranks)
    L = cfg.num_layers
    dec = sum(t["dp"] * t["steps"] for t in ticks)
    pre = sum(t["prefills"] for t in ticks)
    require(pre == len(reqs), (pre, len(reqs)))
    if cfg.use_mla:
        want = {"mla_decode_attention": L * tp * dec,
                "kv_cache_write": L * tp * dec,
                "flash_attention": L * tp * pre}
    else:
        groups = L // cfg.attn_every
        want = {"paged_decode_attention": groups * tp * dec,
                "kv_cache_write": groups * tp * dec,
                "flash_attention": groups * tp * pre,
                "ssd_scan": L * tp * pre}
    for name in PATH_KERNELS[phase]:
        require(counts[name] > 0, f"{tag} {name} was not launched")
        require(name not in want or counts[name] == want[name],
                f"{tag} {name}: {counts[name]} launches, {want.get(name)} "
                f"expected")
    tokens = {r.rid: list(eng.generated[r.rid]) for r in reqs}
    for r in reqs:
        require(len(tokens[r.rid]) == r.output_len
                and all(0 <= t < cfg.vocab_size for t in tokens[r.rid]),
                (r.rid, len(tokens[r.rid])))
    med = {s: _medians(ticks, s)
           for s in ("before", "during", "after", "drain", "final")}
    res.update(tokens=tokens, launches=counts, serve_s=wall,
               ticks=len(ticks), decode_tick_ms_median=med, scale=events,
               drain_s=drain_s, drain_ticks=drain_ticks,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2**30)
    for name in ("up", "down"):
        e = events[name]
        nonzero = {f: v for f, v in e["final"].items() if v}
        log(f"{tag} scale {name}: stage_s {e['stage_s']:.4f}, switch_s "
            f"{e['switch_s']:.4f} (host clock); bytes {nonzero}"
            + (f"; staged {e['staged']['p2p_bytes']} B copied, "
               f"{e['staged']['zero_copy_bytes']} B reused; with the card "
               f"synchronised stage {e['stage_synced_s']:.4f} s, switch "
               f"{e['switch_synced_s']:.4f} s" if name == "up" else ""))
    log(f"{tag} {len(reqs)} requests, {len(ticks)} ticks, {wall:.2f} s; "
        f"decode tick median (no prefill) by stage {med} ms; drain "
        f"{drain_s:.3f} s over {drain_ticks} ticks; max_memory_allocated "
        f"{res['max_memory_allocated_gib']:.2f} GiB; card {res['card']}")
    log(f"{tag} launches " + str({k: counts[k] for k in PATH_KERNELS[phase]}))
    srv.hmm.close()
    del srv, eng
    return res


def _leaves(tree):
    from repro_torch.distributed.sharding import tree_leaves_with_path
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def phase_serve_scale_dense(layers, phase):
    """``serve_scale_mla`` or ``serve_scale_zamba2``: the graphed run, then
    its eager twin on the same requests and schedule; the tokens and the
    launch counts must be equal.  The kernels line takes the graphed
    run's launches."""
    graphed = _serve_scale_dense(layers, phase, True)
    gc.collect()
    torch.cuda.empty_cache()
    eager = _serve_scale_dense(layers, phase, False)
    require(graphed["tokens"] == eager["tokens"],
            f"[{phase}] the graphed server's tokens differ from the eager "
            f"twin's")
    names = PATH_KERNELS[phase]
    require({n: graphed["launches"][n] for n in names}
            == {n: eager["launches"][n] for n in names},
            f"[{phase}] launch counts differ from the eager twin's")
    log(f"[{phase}] graphed tokens equal the eager twin's "
        f"({len(eager['tokens'])} requests, the same scale schedule); "
        f"decode tick median by stage: graphed "
        f"{graphed['decode_tick_ms_median']}, eager "
        f"{eager['decode_tick_ms_median']} ms")
    gc.collect()
    torch.cuda.empty_cache()
    return {"graphs": graphed, "eager": eager,
            "launches": {n: graphed["launches"][n] for n in names}}


def _profile(label, fn, n):
    """Trace ``n`` calls of ``fn`` (each ending in a sync) with
    torch.profiler: device time by kernel name, and the device's busy share
    of the calls' wall time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    walls = []
    with profile(activities=acts) as prof:
        for _ in range(n):
            ts = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - ts) * 1e3)
    rows = []
    for ev in prof.key_averages():
        # device-side kernel events only: an aten op's row repeats the time
        # of the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append({"name": ev.key[:90], "count": ev.count,
                     "device_ms_per_call":
                         ev.self_device_time_total / 1e3 / n})
    rows.sort(key=lambda r: -r["device_ms_per_call"])
    busy = sum(r["device_ms_per_call"] for r in rows)
    wall = sum(walls) / n
    log(f"[profile] {n} {label}, wall {wall:.2f} ms each, device kernels "
        f"{busy:.2f} ms each (idle share "
        f"{(1 - busy / wall) if rows else float('nan'):.3f})")
    for r in rows[:12]:
        log(f"[profile]   {r['device_ms_per_call']:9.3f} ms  x{r['count']:<6}"
            f" {r['name']}")
    return {"wall_ms_per_call": wall, "device_ms_per_call": busy,
            "kernels": rows[:40]}, walls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cap on every served model's depth (default: full "
                         "depth, 48 for qwen3-30b-a3b, 27 for "
                         "deepseek-v2-lite-16b, 48 for mamba2-1.3b, 54 for "
                         "zamba2-2.7b); a hybrid's cap is rounded down to a "
                         "multiple of its attn_every")
    ap.add_argument("--phases",
                    default="build,kernels,e2e,e2e_mla,e2e_ssm,e2e_scale,"
                            "e2e_tp,serve,serve_int8,serve_dense,serve_mla,"
                            "serve_mla_pooled,serve_mamba2,serve_zamba2,"
                            "serve_graphs,"
                            "serve_scale,serve_tp,serve_overlap,serve_down,"
                            "serve_down_tp,serve_scale_mla,"
                            "serve_scale_zamba2")
    ap.add_argument("--json", help="write every measurement to this file")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device is available")
    smi = _card()
    log(smi)
    sys.path.insert(0, os.path.join(HERE, "src"))
    # fails outside a checkout of the repo; on the card, sets the matmul
    # precision the port assumes, as every entry point of the port does
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    res = {"card": smi, "torch": torch.__version__, "phase_seconds": {}}
    runs = [("build", phase_build), ("kernels", phase_kernels),
            ("e2e", phase_e2e), ("e2e_mla", phase_e2e_mla),
            ("e2e_ssm", phase_e2e_ssm), ("e2e_scale", phase_e2e_scale),
            ("e2e_tp", phase_e2e_tp)]
    runs += [(p, lambda p=p: phase_serve(args.layers, p))
             for p in SERVE_STORES]
    # the eager twins of serve and serve_mamba2, held against this call's
    # graphed runs
    runs.append(("serve_graphs", lambda: phase_serve_graphs(args.layers,
                                                            res)))
    runs.append(("serve_scale", lambda: phase_serve_scale(args.layers)))
    runs.append(("serve_tp", lambda: phase_serve_scale(args.layers, 2)))
    # serve_overlap holds its staged bytes and tokens against this call's
    # serve_scale (serial staging of the same server and requests)
    runs.append(("serve_overlap", lambda: phase_serve_overlap(
        args.layers, res.get("serve_scale")
        or phase_serve_scale(args.layers))))
    runs.append(("serve_down", lambda: phase_serve_down(args.layers)))
    runs.append(("serve_down_tp", lambda: phase_serve_down(args.layers, 2)))
    runs += [(p, lambda p=p: phase_serve_scale_dense(args.layers, p))
             for p in DENSE_SCALE]
    for phase, run in runs:
        if phase in phases:
            tp = time.perf_counter()
            res[phase] = run()
            res["phase_seconds"][phase] = time.perf_counter() - tp
            log(f"[time] {phase}: {res['phase_seconds'][phase]:.1f} s")
    res["seconds"] = time.perf_counter() - t0
    for r in res.get("serve_scale", {}).values():
        if isinstance(r, dict):
            r.pop("_trace", None)           # tensors: not for the JSON
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1, default=str)

    if "kernels" in res:
        # each kernel's launches: the sum over the serve phases whose path
        # runs it, each counted from 0 over its own run
        launches = {}
        for phase, names in PATH_KERNELS.items():
            if phase in res:
                for n in names:
                    launches[n] = (launches.get(n, 0)
                                   + res[phase]["launches"][n])
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
