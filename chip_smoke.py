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
   to the same rules and timed past head 0; the block-paged decode and
   the mixed attention at group 16 (chatglm3-6b's 32 query heads over a
   pool of 2 kv heads), bf16 (timed) and f32; the MLA decode at a tp = 3
   rank's 6 heads (B = 2 and 8) and, bf16, a tp = 32 rank's one, and
   flash at MLA's widths with 6 heads (S = 1024 and 192).
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
   ``serve_dense_chunked``: the same requests on qwen3-30b-a3b at full
   depth with the slot-contiguous KV, dense banks and ``prefill_chunk``
   128: each chunk step must launch ``mixed_block_paged_attention`` once
   per layer (the slot's row read as pool blocks) and ``kv_cache_write``
   once per layer (the chunk's blocks), no ``flash_attention``; two chunk
   steps of the 1,000-token prompt's last chunk run under the profiler;
   then its eager twin (``cuda_graphs=False``) serves the same requests,
   whose tokens must be equal.
7. ``e2e_mla``: a 2-layer deepseek-v2-lite-16b at full width (the dense
   layer and one MoE layer) with dense expert banks and with pooled
   pages: a monolithic prefill of a 200-token prompt into one slot, then
   three decode steps of 8 slots (one full: its writes drop), through the
   kernels and through ``ops.use_reference()``, held to the e2e rules
   above; layer 0's latent rows must be equal on both paths.  Then,
   pooled pages, at a tp that cuts a head (``tp`` logical devices of the
   card, DP1): tp = 3 (q 1,024 columns a rank, mid-head; k_up, v_up and
   o whole; each rank attends 6 heads) in f32 and bf16, tp = 32 (every
   leaf cut: q 96 columns, k_up / v_up 64, o 64 rows; one head a rank)
   in bf16, the same prefill (the engine's, into every rank's copy) and
   decode steps held to the same rules, every rank's copy equal to rank
   0's, and per rank one MLA decode and one latent write a layer a step
   and one flash attention a layer a prefill; at tp = 32 in f32 the boot
   must raise under "MLA head count".
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
   ``serve_chatglm3``: the same requests on chatglm3-6b at full width and
   depth (28 layers, 32 query heads over 2 kv heads, half rotary, QKV
   bias; no experts), paged KV, chunks of 128, bf16; each decode step
   must launch ``block_paged_decode_attention`` once per layer (group
   16), each chunk step ``mixed_block_paged_attention`` once per layer;
   it prints the decode floor, the bytes of the weights a tick reads at
   the card's memory rate.
   Every serve phase runs its decode step, and its chunk step or every
   bucket's monolithic prefill, as the IMM's CUDA graphs (captured at
   boot, replayed by the engine; each replay counts the launches its
   capture recorded); the boot must have captured the decode step and
   the chunk step or one graph a bucket, and prints the capture seconds
   and the bytes of the graph pool.  After serving, each monolithic
   phase prefills the 1,000-token prompt (bucket 1024) into slot 0 with
   the eager step, then with its bucket's graph into the same row, first
   filled with ones: the token and every cache leaf's row must be equal
   bit for bit; it prints the graphed wall (median of 5) beside the
   device ms of two profiled replays, the eager wall (median of 3) and
   the eager wall measured before the prefills were captured
   (``EAGER_PREFILL_MS``).
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
   Last, bf16 with dense KV and dense expert banks on DP4, one decode
   step of the 8 slots with ``moe_ep``'s expert-slot dispatch and with
   the packed one (``ParallelCtx.moe_dispatch="packed"``), each held to
   the e2e bf16 rule against its plain versions and profiled (device
   ms), with each dispatch's capacity and expert-row products a device.
12. ``serve_scale``: ``ElasticServer`` serving the ``serve`` requests
   (8 prompts of 200-1000 tokens, 32 output tokens) on qwen3-30b-a3b at
   full width and 4 layers with paged KV, pooled experts and chunked
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
13. ``e2e_tp``: the ``e2e_scale`` steps on DP2 x TP2, DP1 x TP4 (4
   logical devices of the card; a TP sum or gather is a copy and an add
   on the card) and DP1 x TP8 (8): each replica's ranks split its
   attention heads (from the cache's head ``t * KVH / tp``; at tp = 8
   each rank holds half a kv head: q, k and v's columns are gathered and
   rank t attends its 4 query heads against kv head ``t // 2``),
   embedding rows and LM head columns, f32, bf16 and bf16 with int8
   stores, held to the e2e rules; every rank's copy of the cache must
   equal rank 0's after the steps.
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
14a. ``serve_tp8``: the ``serve_scale`` server and requests at tp = 8,
   bf16, booted on DP1 x TP8 and scaled to DP2 x TP8 (16 logical
   devices) at the 5th tick, where each rank holds 64 of a kv head's 128
   columns: the ``serve_tp`` invariants (the new replica's TP-split
   leaves, the half-head k/v shards included, are its ranks' shards),
   graphed decode tokens equal to eager, the boot's and the target's
   capture seconds and graphs, ``stage_s`` and ``stall_s``, the steps
   timed and profiled at both configurations, the launches a tick and
   ``max_memory_allocated``; the TP sums and gathers of the cut path,
   each timed alone.
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
   deepseek-v2-lite-16b at full width and 4 layers (the pools the HMM
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
   same tokens and launch counts.  The graphed scale-up's target set (its
   decode step and every bucket's prefill on each replica) is captured
   inside ``stage_scale``; its size and capture seconds are printed
   beside ``stage_s`` and the ``stage_s`` measured when the target's set
   was its decode step alone (``DECODE_ONLY_UP_STAGE_S``).
   Prints the scales' ``TransferStats``
   bytes, ``stage_s`` and ``switch_s``, the decode tick's median (ticks
   with no prefill) before, during and after the scale-up, in the drain
   and after it, the drain's seconds and the card; the graphed run also
   profiles three replays of the source's decode graph (every slot
   active) before the requests arrive and of the target's right after
   the switchover, the cache restored after them (their launches are
   not counted).
18a. ``serve_scale_mla_tp3``: the same at tp = 3, DP1 x TP3 -> DP2 x TP3
   -> DP1 x TP3 (3 and 6 logical devices; q cut mid-head, each rank
   attending 6 heads; a DP1 source's KV is allocated anew for every
   replica at the scale-up, as the reference's ``_grow_cache`` does).
19. ``serve_scale_zamba2``: the same on zamba2-2.7b at full width and
   6 layers (one group), bf16, DP4 -> DP6 -> DP4 at tp = 1 (14 requests,
   16 tokens out):
   the scale-up is zero-copy reuse plus whole-replica copies (no
   experts; the staged copies must be exactly the two new devices'
   replicas).  Launches: one ``ssd_scan`` per layer per prefill, one
   ``flash_attention`` per group per prefill, one
   ``paged_decode_attention`` and one ``kv_cache_write`` per group and
   replica per decode step.
20. ``serve_closed_loop``: the paper's Coordinator drives the scaling
   (``serving/driver.py``'s ``ClusterDriver``, ``core/coordinator.py``'s
   estimator, ``core/costmodel.py``'s projections): the ``serve_scale``
   server (4 layers, paged bf16 KV, pooled bf16 pages, chunks of 128,
   ``staging="overlap"`` with 4 workers, scale-down by migrate, CUDA
   graphs) boots on DP4 in a ``DevicePool`` of 6 logical devices
   (``min_dp=4``, ``max_step_dp=2``, ``settle_s=1``, no prewarm; SLO TTFT
   1 s, TPOT 0.1 s; window 8, cooldown 1 s, queue 4; ``CLOSED_LOOP``)
   under ``make_workload``'s arrivals: 2 rps, a one-second burst of 16
   rps at t = 2, then 2 rps to t = 20 (driver seconds; prompts 200-1000
   tokens, 16-48 out, seed 0).  The driver's clock is virtual (0.05 s a
   tick); the phase records each tick's wall and maps every request's
   virtual timestamps onto the wall of the ticks that produced them.  It
   prints each ``DriverEvent`` with the cost model's projection (the paper
   cluster's constants, not the card's) and its plan's P2P, zero-copy and
   KV bytes beside what the card measured (``stage_s``, ``switch_s``,
   ``stall_s``, ``start_scale`` to DONE, the ``TransferStats`` bytes,
   migrated blocks), ``summarize`` in driver seconds, TTFT p50 / p99,
   TPOT p50 and ITL p99 in wall ms, output tokens a wall second, the tick
   wall inside and outside a scale task and ``max_memory_allocated``.  It
   requires an up and a down, every request finished with its tokens, DP4
   at the end with nothing staged and every device's pages in use equal
   to the pages it owns, the STAGING ticks' steps under sync-debug
   "error", and ``serve_scale``'s launch counts.
21. ``launch_serve``: ``python -m repro_torch.launch.serve``'s ``main`` on
   the card (f32 smoke configs, 8 logical devices on ``cuda:0``):
   deepseek-v2-lite-16b at tp = 2 with 8 requests (flash at MLA's reduced
   widths 48 / 32, the MLA decode), which serves without a scale (the
   reference launcher's traffic does not scale it either), then
   qwen1.5-0.5b at tp = 2 with 32 requests, which scales up once (the
   smoke MoE's 4 experts do not split over DP3's 6 devices in either
   package).  Every request finishes; each summary is printed in driver
   seconds and wall ms.
22. ``serve_rebalance``: the skew rebalancer on qwen3-30b-a3b at full
   width and 4 layers, DP2 x TP2 on four logical devices of the card
   (bf16 pooled pages, paged KV, chunked prefill, CUDA graphs).  The 8
   ``serve`` requests on a server without a policy, then on one with
   ``routing_sample_every=1`` (the routed decode graph every tick) and the
   reference test's tight ``RebalancePolicy``: it must replicate and
   demote mid-serving, give the same tokens, capture no graph after boot
   and keep every bound tensor (the commits write the index tensors in
   place).  Prints the routed and the plain graphed decode tick, each
   pass's STAGING, ``wall_s``, ``op_s`` and commit time, the replica and
   D2H bytes with their per-op rates and the host tier's bytes; then
   demotes every expert of layers 0 and 1 (about 2.4 GB pinned: the host's
   MemAvailable is printed before and after) and scales to DP3 x TP2
   while serving 8 more requests: those layers' movers must come from the
   host tier (``expert_h2d_bytes`` = their pages) and ``expert_p2p_bytes``
   count only the others; the same copies replayed alone give the H2D and
   the device-to-device rates.
23. ``serve_park``: scale to zero on ``serve_rebalance``'s server (DP2 x
   TP2, overlapped staging with 4 workers, ``expert_host_pages`` set):
   the host cache emptied (so the park pins cold), layer 0 demoted
   whole, the 8 requests served, ``park`` (pinned host snapshot; it must
   absorb layer 0's host-tier rows, ``memory_allocated`` must fall back
   within 256 MiB of its level before the boot, and no graph set may
   survive), ``start_unpark`` to DP2 x TP2 (``start_unpark`` and every
   STAGING poll under sync-debug "error"; an ``unpark:`` op span must
   overlap an ``unpark.compile`` span): the requests again give the same
   tokens.  Parked again and unparked to DP3 x TP2: every logical
   parameter bitwise equal to the pre-park one; 8 more requests finish.
   Prints the park's wall split into pinning and D2H, its bytes, the
   pinned bytes, MemAvailable and ``memory_allocated`` around it, the
   unpark's ``h2d_bytes`` beside the bytes it copied and their rate, its
   capture polls and seconds, ``stall_s``, the longest poll,
   ``start_unpark`` to DONE and the commit, which gives the pinned
   snapshot back (the host allocator's counts and VmRSS around it).
24. ``serve_fleet``: a ``FleetDriver`` over two ``serve_park`` servers
   (seeds 0 and 1, 512 pool pages a device, one shared ``imm_cache``)
   in a pool of 8 ids with ``serve_closed_loop``'s policy: "a" (DP2 x
   TP2, ``min_devices`` 0, parks after 1 s idle) takes the 8 requests,
   "b" (DP1 x TP2, ``min_devices`` 2) 2, then a burst of 12 once "a" has
   parked, and "a" 4 more once "b" has scaled up: "a" must park, "b" grow
   onto ids "a" held, "a" unpark, every request finish with
   in-vocabulary tokens; "a"'s STAGING polls and "b"'s decode steps
   during the unpark run under sync-debug "error".  Prints each event
   with its projection, "a"'s cold-start TTFT in driver s and wall ms
   against ``unpark_transition_cost``, and the fleet tick that holds
   "a"'s park (cold: the host cache is emptied first), split into
   pinning and D2H.
25. ``e2e_vlm``: llama-3.2-vision-11b at full width, its image encoder a
   stub (embeddings [8, 1601, 4096] from seed 0), every cross gate set
   to 1.0 (the reference initialises them to zero, which would keep the
   image out).  5 layers (one group) in f32 and bf16, the prefill of the
   8 smoke prompts and 2 decode steps through the kernels and under
   ``ops.use_reference()``; then 40 layers in bf16: the prefill, 32
   greedy decode steps (median and p90 wall), 4 profiled for the device
   time, and ``max_memory_allocated``.
26. ``e2e_encoder``: hubert-xlarge at full width, frames [8, 1024, 1280]
   from seed 0: 2 layers in f32 and bf16 against plain, then 48 layers in
   bf16 timed and profiled.
27. ``e2e_window``: chatglm3-6b at full width with the dry run's
   ``attn_window`` of 8,192, B = 2 prompts of 9,216 tokens: 2 layers in
   f32 and bf16 against plain through the prefill (the ring keeps the
   last 8,192 rows) and 16 ring decode steps; then 28 layers in bf16,
   the prefill and 64 decode steps timed.
28. ``serve_scale_one``: qwen3-30b-a3b at full width and
   ``SCALE_LAYERS`` layers (paged bf16 KV, pooled pages, chunks of 128,
   CUDA graphs) booted on one device: serves, ``stage_scale`` DP1 ->
   DP2, ``switchover`` (its commit zeroes the KV, a DP1 shard being
   keyed whole, as in the reference), finishes, drains to DP1, parks at
   DP1 with nothing kept aside (``memory_allocated`` back within 256 MiB
   of its level before the boot) and unparks to DP1 (8 fresh requests'
   tokens equal before and after), then parks and unparks again with the
   parameters kept aside (every logical parameter bitwise equal); the
   eager twin's scale run gives the graphed run's tokens.
29. ``train``: qwen3-30b-a3b at full width cut to ``TRAIN_LAYERS``
   layers, bf16, weights from seed 0 with dense expert banks
   (``init_params(..., experts=True)``), batches of 2 x 1,024 tokens from
   ``synthetic_batches``.  The first step's loss and gradients through
   the kernels against ``ops.use_reference()`` on the same batch (loss
   within 1e-2 relative, the global gradient norm within 2 %, every
   gradient finite; the rows whose top-k expert set flipped near a tie
   counted), then 6 steps of ``make_train_step`` (remat) on one fixed
   batch, whose loss must fall at every step; the step wall (median after
   the first), forward + backward and optimizer ms, tokens/s,
   ``max_memory_allocated`` and both flash kernels' launches, counted from
   0 over the 6 steps; one step under the profiler.
30. ``train_mla``: the same for deepseek-v2-lite-16b (its dense first
   layer, then 3 MoE layers; MLA's q/k 192 and v 128).
31. ``launch_train``: ``python -m repro_torch.launch.train``'s ``main``
   on the card for qwen3-30b-a3b and deepseek-v2-lite-16b (their f32
   smoke configs, 3 steps of 2 x 64 tokens: shapes the kernels phase
   holds), every loss finite; and one f32 step of the test MoE's widths
   through the kernels against ``ops.use_reference()``, the loss and
   every gradient within 1e-4.
The new phases print their numbers beside the card's name and power
limit.  The kernels phase also runs the last slice's instances: the
VLM's cross prefill (S = 1024 over 1,601 image rows) and cross decode,
the encoder's non-causal prefill (B = 8, 16 heads of 80), chatglm3-6b's
windowed prefill (S = 9216, W = 8192) and ring decode (positions below
W, between W and 2W - 1, and past it, where the range is empty and the
output the uniform mean of v), and a cross prefill whose rows past the
window attend no key; SDPA's time is taken with the same boolean mask.
And ``flash_attention_bwd``, the training path's backward (no TPU
kernel: the reference differentiates its plain ``mha``), at
qwen3-30b-a3b's training shape (B = 2, S = 1024, 32 over 4 heads of 128;
the main case), deepseek-v2-lite's (16 heads, q/k 192, v 128), a ragged
S = 1000, and in f32 at the smoke configs' (64, 64) and (48, 32) and the
test MoE's 16: dQ, dK and dV within ``TOL`` of the plain version on the
same inputs and forward LSE, the same bits from a second launch, and
the forward with its LSE bit for bit the forward without it, its LSE
within 1e-4 of the plain version's; the library time is SDPA's backward
under autograd.

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
import re
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
# the heads a tp = 3 rank attends (its 682-683 of o's 2,048 rows cover 6
# heads of 128)
MLA_TP3_HEADS = 6
# chatglm3-6b's (query heads, kv heads, first kv head): group 16
GLM_HEADS = (32, 2, 0)
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
    # the reference trains through jax.value_and_grad
    # (src/repro/training/train_loop.py:25) of its plain mha
    "flash_attention_bwd": "none: no pallas_call (jax.grad of mha, "
                           "src/repro/models/layers.py:115)",
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
    "flash_attention_bwd": "src/repro_torch/csrc/flash_attention_bwd.cu",
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
    "serve_dense_chunked": ("mixed_block_paged_attention",
                            "paged_decode_attention", "kv_cache_write"),
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
PATH_KERNELS["serve_tp8"] = PATH_KERNELS["serve"]
PATH_KERNELS["serve_chatglm3"] = ("block_paged_decode_attention",
                                  "mixed_block_paged_attention",
                                  "kv_cache_write")
PATH_KERNELS["serve_scale_mla_tp3"] = PATH_KERNELS["serve_scale_mla"]
PATH_KERNELS["serve_closed_loop"] = PATH_KERNELS["serve"]
PATH_KERNELS["serve_rebalance"] = PATH_KERNELS["serve"]
PATH_KERNELS["serve_park"] = PATH_KERNELS["serve"]
PATH_KERNELS["serve_scale_one"] = PATH_KERNELS["serve"]
# the last slice's model steps: the VLM's self and cross prefill and
# decode, the encoder's forward, the windowed prefill and ring decode
PATH_KERNELS["e2e_vlm"] = ("flash_attention", "paged_decode_attention",
                           "kv_cache_write")
PATH_KERNELS["e2e_encoder"] = ("flash_attention",)
PATH_KERNELS["e2e_window"] = PATH_KERNELS["e2e_vlm"]
PATH_KERNELS["serve_fleet"] = PATH_KERNELS["serve"]
# the launcher's f32 smoke runs: deepseek-v2-lite's MLA with the dense
# stores, and qwen1.5-0.5b's slot decode
PATH_KERNELS["launch_serve"] = ("flash_attention", "mla_decode_attention",
                                "paged_decode_attention", "kv_cache_write")
# training: every layer's flash forward (twice a step under remat) and
# its backward
for _p in ("train", "train_mla", "launch_train"):
    PATH_KERNELS[_p] = ("flash_attention", "flash_attention_bwd")
DECODE_LENGTHS = [2048, 1, 17, 333, 1024, 1500, 64, 777]
# a TP rank's (query heads, kv heads, first kv head) of qwen3-30b-a3b's
# replicated cache at tp = 2, 4 and 8
TP_HEAD_RANGES = ((16, 2, 0), (16, 2, 2), (8, 1, 0), (8, 1, 3), (4, 1, 1),
                  (4, 1, 3))
# the scale phases: qwen3-30b-a3b at full width on logical devices of the
# one card, DP4 -> DP6 at tp = 1, 2 slots a replica; serve_scale at 4
# layers (the pools of 48 would take 174 GB; 8 until the prefill graphs
# and serve_dense_chunked had to fit the run's time), e2e_scale at 2
SCALE_LAYERS, SCALE_BPR, SCALE_DEVICES = 4, 2, 6
# the lengths of serve_scale_mla's one-device check, whose DP2 x TP2
# decode gives each rank's MLA decode a replica's 2 slots at 8 heads
RANK_LENGTHS = [1900, 5, 640, 1024]
# the f32 smoke runs' prefill attention: the launcher's 32-token bucket
# at a TP rank's 2 of 4 heads (tp = 2) of deepseek-v2-lite-smoke's MLA
# (q/k 48, v 32) and qwen1.5-0.5b-smoke (64); the test MoE's width 16
# (the card test's closed loop), whole and a rank's
LAUNCH_BUCKET = 32
SMOKE_FLASH_HEADS = ((2, 2, 48, 32), (4, 4, 48, 32), (2, 2, 64, 64),
                     (2, 2, 16, 16), (4, 4, 16, 16))
# llama-3.2-vision-11b's heads (query, kv, width) and image rows;
# hubert-xlarge's heads; chatglm3-6b at the dry run's long-context window
# (LONG_CONTEXT_WINDOW) over a prompt past it (the reference's mha takes
# Sq % 1024 == 0 above 1024), and the windowed decode's positions L: L <
# W, W <= L < 2W - 1 (the ring's mask drops the newest slots) and L >= 2W
# - 1 (it drops every slot: the uniform mean)
VLM_HEADS, VLM_IMG = (32, 8, 128), 1601
ENC_HEADS = (16, 16, 80)
WINDOW, WINDOW_S = 8192, 9216
RING_L = [100, 5000, 8191, 8192, 12000, 16382, 16383, 20000]
# the train phases: full width cut to 4 layers, 2 x 1,024 tokens, 6 steps;
# the launcher's f32 smoke runs, 3 steps of 2 x 64 tokens (4 heads: the
# smoke configs' (64, 64) and (48, 32), and the test MoE's 16)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2, 1024, 6
TRAIN_LOSS_REL, TRAIN_GNORM_REL = 1e-2, 2e-2
LAUNCH_TRAIN_SEQ = 64
SMOKE_BWD_HEADS = ((4, 4, 64, 64), (4, 4, 48, 32), (4, 4, 16, 16))


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


def _kv_pools(gen, dtype, quant, NB, kvh=KVH):
    """K/V pools of ``kvh`` kv heads for an attention case: (kernel
    arguments, pools for the library call in q's dtype, K/V bytes per
    context token).  int8 pools hold random entries and positive scales
    with row maxima in [0.3, 3]."""
    from repro_torch.kernels.quant import dequantize_rows
    if not quant:
        k = torch.randn(NB, BS, kvh, HD, generator=gen).to(dtype).cuda()
        v = torch.randn(NB, BS, kvh, HD, generator=gen).to(dtype).cuda()
        return (k, v), (k, v), 2 * kvh * HD * k.element_size()
    pools = []
    for _ in range(2):
        p = torch.randint(-127, 128, (NB, BS, kvh, HD), generator=gen,
                          dtype=torch.int8).cuda()
        sc = ((0.3 + 2.7 * torch.rand(NB, BS, generator=gen)) / 127).cuda()
        pools += [p, sc]
    lib = tuple(dequantize_rows(p, sc, (-2, -1)).to(dtype)
                for p, sc in (pools[:2], pools[2:]))
    return tuple(pools), lib, 2 * (kvh * HD + 4)


def _attention_case(kind, dtype, gen, timer, do_time, quant=False,
                    heads=None, pool_kvh=KVH):
    """``heads`` = (query heads, kv heads, offset): a TP rank's kv heads
    of the ``pool_kvh``-head pool from the offset (``kv_head_offset``);
    default all of qwen3-30b-a3b's 32 and 4."""
    from repro_torch.kernels import ops, ref
    NB, MB = 1024, MAX_LEN // BS
    nq, nkv, off = heads or (H, KVH, 0)
    rng = dict(kv_head_offset=off, kv_heads=nkv)
    pools, (k_lib, v_lib), kv_tok_bytes = _kv_pools(gen, dtype, quant, NB,
                                                    pool_kvh)
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
        label += f" H={nq} KVH={nkv} of {pool_kvh} from head {off}"
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


def _attended(S, Skv, causal, window):
    """(attended (query, key) pairs of one head, empty rows) of a prefill
    attention: row i reads keys t <= i where causal, and t > i - window
    under a window; a row left with none reads all Skv (the uniform mean,
    as the reference's -1e30 mask gives)."""
    i = np.arange(S)
    hi = np.minimum(i + 1, Skv) if causal else np.full(S, Skv)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(S, int)
    n = np.maximum(hi - lo, 0)
    empty = n == 0
    return int(np.where(empty, Skv, n).sum()), int(empty.sum())


def _flash_case(S, dtype, gen, timer, do_time, heads=(H, KVH, HD, HD),
                peaked=False, B=1, Skv=None, causal=True, window=None):
    """Prefill attention of B prompts of S tokens (a serving bucket)
    against its plain version and SDPA (causal, or with the boolean mask
    of the same function), at ``heads`` = (query heads, kv heads, q/k
    width, v width): qwen3-30b-a3b's (32, 4, 128, 128) by default,
    deepseek-v2-lite's MLA (16, 16, 192, 128; a TP rank's 8, 8, 192, 128
    at tp = 2) or zamba2-2.7b's shared block (32, 32, 80, 80), or a smoke
    config's (``SMOKE_FLASH_HEADS``), and the last slice's: the VLM's
    cross prefill (``Skv`` image rows, not causal), the encoder's (not
    causal) and a sliding ``window``; scale 1/sqrt(q/k width).
    ``peaked``: queries drawn for scores of standard deviation 3, and a
    bf16 output held to one rounding of the f32 answer."""
    from repro_torch.kernels import ops, ref
    nh, nkv, hd, hdv = heads
    Skv = S if Skv is None else Skv
    scale = hd ** -0.5
    q = (torch.randn(B, S, nh, hd, generator=gen)
         * (DECODE_Q_STD if peaked else 1.0)).to(dtype).cuda()
    k = torch.randn(B, Skv, nkv, hd, generator=gen).to(dtype).cuda()
    v = torch.randn(B, Skv, nkv, hdv, generator=gen).to(dtype).cuda()
    kern = lambda: ops.flash_attention(q, k, v, causal, scale, window)
    plain = lambda: ref.flash_attention_ref(q, k, v, causal, scale, window)
    ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs, empty = _attended(S, Skv, causal, window)
    if window is None and causal:
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True, enable_gqa=True, scale=scale)
    else:
        i = torch.arange(S, device="cuda")[:, None]
        t = torch.arange(Skv, device="cuda")[None]
        mask = torch.ones(S, Skv, dtype=torch.bool, device="cuda")
        if causal:
            mask &= t <= i
        if window is not None:
            mask &= i - t < window
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask, enable_gqa=True, scale=scale)
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if not empty:          # SDPA gives NaN where a row attends no key
        torch.testing.assert_close(lib().transpose(1, 2).float(),
                                   want.float(), **TOL[dtype])
    excess = None
    if peaked and dtype == torch.bfloat16:
        excess = _require_one_bf16_rounding(
            got, ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal, scale, window),
            "flash_attention")
    # 2 (hd + hdv) per attended (q, k, head)
    ops_n = 2 * (hd + hdv) * nh * B * pairs
    io = nbytes(q, k, v, got)
    b_ms, b_by = bound_ms(io, ops_n, dtype)
    rec = {"case": f"B={B} S={S}" + (f" Skv={Skv}" if Skv != S else "")
                   + f" H={nh} KVH={nkv} hd={hd} hdv={hdv} "
                   + ("causal" if causal else "not causal")
                   + (f" window={window}" if window else "")
                   + (f" ({empty} rows attend no key)" if empty else "")
                   + (" peaked" if peaked else ""),
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": io, "ops": ops_n}
    if excess is not None:
        rec["rounding_excess"] = excess
    if do_time:
        rec.update(ms=timer(kern), plain_ms=timer(plain, iters=10),
                   library_ms=timer(lib))
    return rec


def _flash_bwd_case(S, dtype, gen, timer, do_time, heads=(H, KVH, HD, HD),
                    B=TRAIN_BATCH):
    """The training path's backward of causal self-attention, B sequences
    of S tokens at ``heads`` = (query heads, kv heads, q/k width, v
    width), scale 1/sqrt(q/k width) (MLA's 1/sqrt(dn + dr)): the forward
    with its LSE must give the forward's bits without it and an LSE within
    1e-4 of the plain version's; dQ, dK and dV within ``TOL`` of the plain
    version on the same inputs, o and LSE; a second launch the same bits.
    The library time is SDPA's backward under autograd (its forward
    outside the timing).  Bound: (6 hd + 4 hdv) operations per attended
    (query, key, head) (S, dV, dP, dQ, dK; 10 hd where hdv = hd)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ref
    nh, nkv, hd, hdv = heads
    scale = hd ** -0.5
    q = torch.randn(B, S, nh, hd, generator=gen).to(dtype).cuda()
    k = torch.randn(B, S, nkv, hd, generator=gen).to(dtype).cuda()
    v = torch.randn(B, S, nkv, hdv, generator=gen).to(dtype).cuda()
    do = torch.randn(B, S, nh, hdv, generator=gen).to(dtype).cuda()
    o, lse = fa.flash_attention(q, k, v, True, scale, lse=True)
    plain_o, plain_lse = ref.flash_attention_lse_ref(q, k, v, True, scale)
    torch.cuda.synchronize()
    require(torch.equal(o, fa.flash_attention(q, k, v, True, scale)),
            "flash_attention: the forward with its LSE is not the same bits")
    torch.testing.assert_close(lse, plain_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(o.float(), plain_o.float(), **TOL[dtype])
    kern = lambda: fb.flash_attention_bwd(q, k, v, o, lse, do, scale)
    plain = lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do, scale)
    got, want = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])
        require(torch.equal(g, a), f"flash_attention_bwd {name}: a second "
                f"launch gave other bits")
        err = max(err, (g.float() - w.float()).abs().max().item())
    pairs = B * S * (S + 1) // 2
    ops_n = (6 * hd + 4 * hdv) * nh * pairs
    io = nbytes(q, k, v, o, do, lse, *got)
    b_ms, b_by = bound_ms(io, ops_n, dtype)
    rec = {"case": f"B={B} S={S} H={nh} KVH={nkv} hd={hd} hdv={hdv} causal",
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": io, "ops": ops_n}
    if do_time:
        ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        ol = torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True, enable_gqa=True, scale=scale)
        dol = do.transpose(1, 2).contiguous()
        lib = lambda: torch.autograd.grad(ol, (ql, kl, vl), dol,
                                          retain_graph=True)
        rec.update(ms=timer(kern), plain_ms=timer(plain, iters=10),
                   library_ms=timer(lib))
        del ol
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


def _range_decode_case(dtype, gen, timer, do_time, heads, S_max, ends,
                       starts=None):
    """Decode over a slot cache [B, S_max, KVH, hd] of rows ``[starts[b],
    ends[b])``: the windowed ring's ranges (``starts`` given; an empty
    range is the uniform mean of all S_max rows) or the VLM's cross
    decode over its image rows (every row); against the plain version,
    the bf16 output to one rounding of the f32 answer, a second launch the
    same bits, and SDPA with the range's boolean mask (which cannot give
    an empty range's mean: such rows attend every row there and are not
    compared)."""
    from repro_torch.kernels import ops, ref
    nh, nkv, hd = heads
    B = len(ends)
    kc = torch.randn(B, S_max, nkv, hd, generator=gen).to(dtype).cuda()
    vc = torch.randn(B, S_max, nkv, hd, generator=gen).to(dtype).cuda()
    q = (torch.randn(B, nh, hd, generator=gen)
         * DECODE_Q_STD).to(dtype).cuda()
    end = torch.tensor(ends, dtype=torch.int32, device="cuda")
    start = (None if starts is None else
             torch.tensor(starts, dtype=torch.int32, device="cuda"))
    kern = lambda: ops.paged_decode_attention(q, kc, vc, end, starts=start)
    plain = lambda: ref.paged_decode_attention_ref(q, kc, vc, end,
                                                   starts=start)
    lo = np.zeros(B, int) if starts is None else np.asarray(starts)
    hi = np.asarray(ends)
    empty = lo >= hi
    t = torch.arange(S_max, device="cuda")[None, :]
    mask = ((t >= torch.tensor(lo, device="cuda")[:, None])
            & (t < end.long()[:, None]))
    mask |= torch.tensor(empty, device="cuda")[:, None]
    ql = q[:, :, None]
    kl, vl = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    lib = lambda: sdpa(ql, kl, vl, mask[:, None, None, :])
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    require(torch.equal(kern(), got), "paged_decode_attention: a second "
            "launch differs from the first")
    if empty.any():
        mean = vc.float().mean(1).repeat_interleave(nh // nkv, 1)
        rows = torch.tensor(empty, device="cuda")
        torch.testing.assert_close(got.float()[rows], mean[rows],
                                   **TOL[dtype])
    excess = None
    if dtype == torch.bfloat16:
        excess = _require_one_bf16_rounding(
            got, ref.paged_decode_attention_ref(q.float(), kc.float(),
                                                vc.float(), end,
                                                starts=start),
            "paged_decode_attention")
    keep = torch.tensor(~empty, device="cuda")
    torch.testing.assert_close(lib()[:, :, 0].float()[keep],
                               want.float()[keep], **TOL[dtype])
    rows = int(np.where(empty, S_max, hi - lo).sum())
    io = (nbytes(q, got, end) + (0 if start is None else nbytes(start))
          + rows * 2 * nkv * hd * kc.element_size())
    ops_n = 4 * hd * nh * rows
    b_ms, b_by = bound_ms(io, ops_n, dtype)
    rec = {"case": f"B={B} H={nh} KVH={nkv} hd={hd} S_max={S_max} rows "
                   f"from {0 if starts is None else list(starts)} to "
                   f"{list(ends)}"
                   + (f" ({int(empty.sum())} empty: the uniform mean)"
                      if empty.any() else ""),
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
        # where tp cuts a head: a tp = 3 rank's 6 heads (serve_scale_mla_
        # tp3's 2 slots, e2e_mla's 8) and, in bf16, a tp = 32 rank's one
        # (the f32 kernel takes even counts; e2e_mla)
        for lengths in (RANK_LENGTHS[:SCALE_BPR], DECODE_LENGTHS):
            mla.append(_mla_case(lengths, MAX_LEN, dtype, gen, timer, timed,
                                 heads=MLA_TP3_HEADS))
        if dtype == torch.bfloat16:
            mla.append(_mla_case(DECODE_LENGTHS, MAX_LEN, dtype, gen, timer,
                                 timed, heads=1))
        for S, nh in ((1024, MLA_H), (192, MLA_H), (1024, MLA_H // 2),
                      (1024, MLA_TP3_HEADS), (192, MLA_TP3_HEADS)):
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
    # each flash instance at peaked scores and a ragged S (the last, a
    # qwen3-30b-a3b rank at tp = 8: 4 query heads and the kv head they
    # read): the bf16 output is the f32 answer rounded once
    for heads in ((H, KVH, HD, HD), (MLA_H, MLA_H, MLA_DN + MLA_DR, MLA_DV),
                  (ZAMBA_H, ZAMBA_H, ZAMBA_HD, ZAMBA_HD), (H, KVH, 64, 64),
                  (4, 4, 48, 32), (4, 4, 16, 16), (H // 8, 1, HD, HD)):
        out["flash_attention"].append(_flash_case(
            1000, torch.bfloat16, gen, timer, False, heads, peaked=True))
    # the training path's backward: qwen3-30b-a3b's shape (the main case),
    # deepseek-v2-lite's MLA, a ragged S; in f32 the launcher's smoke
    # shapes and the test MoE's width
    bwd = out["flash_attention_bwd"]
    bwd.append(_flash_bwd_case(TRAIN_SEQ, torch.bfloat16, gen, timer, True))
    bwd.append(_flash_bwd_case(TRAIN_SEQ, torch.bfloat16, gen, timer, True,
                               (MLA_H, MLA_H, MLA_DN + MLA_DR, MLA_DV)))
    bwd.append(_flash_bwd_case(1000, torch.bfloat16, gen, timer, False))
    for heads in SMOKE_BWD_HEADS:
        bwd.append(_flash_bwd_case(LAUNCH_TRAIN_SEQ, torch.float32, gen,
                                   timer, False, heads))
    torch.cuda.empty_cache()
    # the smoke configs' instances at launch_serve's shapes (f32, as it
    # runs them) and in bf16
    for dtype in (torch.float32, torch.bfloat16):
        for heads in SMOKE_FLASH_HEADS:
            out["flash_attention"].append(_flash_case(
                LAUNCH_BUCKET, dtype, gen, timer, False, heads))
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
    # a TP rank's heads of the replicated cache (e2e_tp, serve_tp,
    # serve_tp8): qwen3-30b-a3b's 16 query and 2 kv heads at tp = 2, 8 and
    # 1 at tp = 4, and 4 and 1 at tp = 8 (half a kv head a rank: its 4
    # query heads read one kv head), from head 0 and past it, bf16 and
    # int8 rows (timed past 0)
    for phase in ("serve", "serve_int8"):
        dec_name, mix_name = PATH_KERNELS[phase][:2]
        for nq, n, off in TP_HEAD_RANGES:
            for kind, name in (("decode", dec_name), ((1000, 104), mix_name)):
                rec, _ = _attention_case(kind, torch.bfloat16, gen, timer,
                                         off > 0, phase == "serve_int8",
                                         heads=(nq, n, off))
                out[name].append(rec)
    for nq, n, off in TP_HEAD_RANGES:
        out["paged_decode_attention"].append(_slot_decode_case(
            torch.bfloat16, gen, timer, off > 0, heads=(nq, KVH, HD),
            kv_range=(n, off)))
    # group 16: chatglm3-6b's 32 query heads over its 2 kv heads
    # (serve_chatglm3), a pool of 2 kv heads, bf16 (timed) and f32
    for dtype in (torch.bfloat16, torch.float32):
        for kind, name in (("decode", "block_paged_decode_attention"),
                           ((1000, 104), "mixed_block_paged_attention")):
            rec, _ = _attention_case(kind, dtype, gen, timer,
                                     dtype == torch.bfloat16,
                                     heads=GLM_HEADS, pool_kvh=GLM_HEADS[1])
            out[name].append(rec)
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
    # the last slice's instances: the VLM's cross prefill (a 1,024-token
    # prompt over its 1,601 image rows) and cross decode (every image
    # row), the encoder's non-causal prefill (B = 8 clips of 1,024
    # frames), chatglm3-6b's windowed prefill and ring decode, and a cross
    # prefill whose rows 31 and up lie past the window (no key: the mean)
    nh, nkv, hd = VLM_HEADS
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        peaked = dtype == torch.bfloat16
        fa, pd = out["flash_attention"], out["paged_decode_attention"]
        fa.append(_flash_case(1024, dtype, gen, timer, timed,
                              (nh, nkv, hd, hd), peaked, Skv=VLM_IMG,
                              causal=False))
        fa.append(_flash_case(1024, dtype, gen, timer, timed,
                              ENC_HEADS + ENC_HEADS[2:], peaked, B=8,
                              causal=False))
        fa.append(_flash_case(WINDOW_S, dtype, gen, timer, timed,
                              (32, 2, HD, HD), peaked, window=WINDOW))
        fa.append(_flash_case(64, dtype, gen, timer, False,
                              (nh, nkv, hd, hd), peaked, Skv=24,
                              causal=False, window=8))
        torch.cuda.empty_cache()
        pd.append(_range_decode_case(
            dtype, gen, timer, timed, (32, 2, HD), WINDOW,
            [min(L + 1, WINDOW) for L in RING_L],
            [max(0, L - WINDOW + 1) for L in RING_L]))
        pd.append(_range_decode_case(dtype, gen, timer, timed, VLM_HEADS,
                                     VLM_IMG, [VLM_IMG] * BATCH))
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


def _e2e_mla_tp(dtype_name, tp):
    """deepseek-v2-lite at full width, 2 layers, pooled pages, dense
    latent KV, on DP1 x TP``tp`` (``tp`` logical devices of the card), at
    a tp that cuts its heads: tp = 3 cuts q mid-head and leaves k_up,
    v_up and o whole (each rank attends 6 heads); tp = 32 cuts every leaf
    (each rank attends one head, half of its 128 columns of o).  As
    ``_e2e_mla``: a monolithic prefill of a 200-token prompt (bucket 256)
    into slot 2 of every rank's copy and three decode steps of the 8
    slots, through the kernels and through ``ops.use_reference()`` from
    the same cache (the same contents in every copy), held to the e2e
    rules, every rank's copy equal to rank 0's after each run.  In f32 at
    tp = 32 the boot must raise under "MLA head count" (the f32 MLA
    decode kernel takes an even head count)."""
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import _prefill_fn
    tag = f"[e2e_mla tp={tp}]"
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_layers=2, dtype=dtype_name)
    ecfg = ElasticConfig(1, tp, tuple(range(tp)))
    hmm = HMM(cfg, tp, batch_per_replica=BATCH, max_len=MAX_LEN, seed=1,
              expert_mode="pooled", device="cuda",
              all_devices=["cuda:0"] * tp)
    heads = M.heads_a_rank(cfg, tp)
    if dtype_name == "float32" and any(n % 2 for n in heads):
        refused = None
        try:
            hmm.boot(ecfg)
        except NotImplementedError as e:
            refused = str(e)
        require(refused is not None and "MLA head count" in refused,
                f"{tag} f32 boot at {heads[0]} head a rank: {refused}")
        log(f"{tag} float32: the boot raised as required: {refused}")
        return {"dtype": dtype_name, "tp": tp, "refused": refused}
    hmm.boot(ecfg)
    attn = hmm.params["blocks"]["attn"]
    widths = {k: attn[k]["w"].shard(0).shape[-1 if k != "o" else -2]
              for k in ("q", "k_up", "v_up", "o")}
    _fill_pool(hmm.cache, torch.Generator(device="cuda").manual_seed(2), tp)
    ctx = _scale_ctx(ecfg, hmm)
    cg = torch.Generator().manual_seed(3)
    S, S_pad, slot, steps = 200, 256, 2, 3
    tokens = torch.zeros(1, S_pad, dtype=torch.int32)
    tokens[0, :S] = torch.randint(0, cfg.vocab_size, (S,), generator=cg)
    lengths = [1900, 5, S, 1024, 77, 300, 1500, MAX_LEN]
    dec_tokens = torch.randint(0, cfg.vocab_size, (steps, BATCH, 1),
                               generator=cg)
    args = [t.cuda() for t in (tokens, torch.tensor([S], dtype=torch.int32),
                               dec_tokens,
                               torch.tensor(lengths, dtype=torch.int32))]

    def run():
        c = _clone_pool(hmm.cache)
        _, c = _prefill_fn(cfg, MAX_LEN, hmm.params, c, args[0], args[1],
                           slot, parallel=ctx)
        out = [M.prefill(cfg, hmm.params, {"tokens": args[0],
                                           "lengths": args[1]},
                         max_len=S_pad, parallel=ctx)[0]]
        for i in range(steps):
            ld, c = M.decode_step(cfg, hmm.params, args[2][i], c,
                                  args[3] + i, parallel=ctx)
            out.append(ld)
        return torch.cat(out).float(), c

    run()                                  # first calls: kernels loaded
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got, c_got = run()
    counts = ops.launch_counts()
    with ops.use_reference():
        want, c_want = run()
    torch.cuda.synchronize()
    require(got.shape == (1 + steps * BATCH, cfg.vocab_size))
    require(torch.isfinite(got).all() and torch.isfinite(want).all())
    _require_copies_equal(c_got, ecfg, f"{tag} kernels")
    _require_copies_equal(c_want, ecfg, f"{tag} plain versions")
    # per rank: one MLA decode and one latent write a layer a step, two
    # flash attentions a layer (the engine's prefill and the prefill)
    L = cfg.num_layers
    for name, n in (("mla_decode_attention", L * tp * steps),
                    ("kv_cache_write", L * tp * steps),
                    ("flash_attention", 2 * L * tp)):
        require(counts[name] == n, f"{tag} {name}: {counts[name]} "
                f"launches, {n} expected")
    for k in c_got:
        require(torch.equal(c_got[k].shard(0)[0], c_want[k].shard(0)[0]),
                f"{tag} layer 0's cache {k} differs")
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    if dtype_name == "float32":
        torch.testing.assert_close(got, want, **E2E_F32_TOL)
    else:
        require(rel < E2E_BF16_REL, f"{tag} {dtype_name} logits rel err "
                f"{rel}")
    log(f"{tag} 2-layer deepseek-v2-lite-16b {dtype_name} on "
        f"{ecfg.describe()} (one card), pooled experts, dense latent KV; "
        f"rank 0's widths {widths} (q columns, k_up / v_up columns, o "
        f"rows), heads a rank {sorted(set(heads))}: prefill (S={S}, bucket "
        f"{S_pad}) + {steps} decode steps, logits {tuple(got.shape)}, "
        f"max_abs_err {err:.3e}, rel {rel:.3e}; every rank's copy equal")
    del hmm, c_got, c_want
    return {"dtype": dtype_name, "tp": tp, "max_abs_err": err,
            "rel_err": rel, "widths": widths, "heads_a_rank": heads,
            "launches": counts}


def phase_e2e_mla():
    out = []
    for expert_mode in ("dense", "pooled"):
        for dtype_name in ("float32", "bfloat16"):
            out.append(_e2e_mla(dtype_name, expert_mode))
            gc.collect()
            torch.cuda.empty_cache()
    for tp, dtype_name in ((3, "float32"), (3, "bfloat16"),
                           (32, "float32"), (32, "bfloat16")):
        out.append(_e2e_mla_tp(dtype_name, tp))
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


def _step_ms(fn, n):
    """``n`` calls of ``fn``, each timed on the host from its start to a
    synchronised card -> (every call's wall ms, the last call's value)."""
    walls, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls, out


def _kernels_vs_plain(run, dtype_name, tag, what):
    """``run()`` -> (logits, cache) through the kernels and under
    ``ops.use_reference()``: finite logits of one shape; f32 within
    ``E2E_F32_TOL``, bf16 relative Frobenius error under
    ``E2E_BF16_REL``.  Returns (the errors, both caches)."""
    from repro_torch.kernels import ops
    got, c_got = run()
    with ops.use_reference():
        want, c_want = run()
    torch.cuda.synchronize()
    require(got.shape == want.shape and torch.isfinite(got).all()
            and torch.isfinite(want).all(), f"{tag} {what}: logits")
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    if dtype_name == "float32":
        torch.testing.assert_close(got, want, **E2E_F32_TOL)
    else:
        require(rel < E2E_BF16_REL, f"{tag} {what} logits rel err {rel}")
    return {"dtype": dtype_name, "max_abs_err": err, "rel_err": rel}, \
        c_got, c_want


def _vlm_params(cfg):
    """llama-3.2-vision-11b's parameters from seed 0, every cross gate set
    to 1.0: the reference initialises ``xgate`` to zero, and tanh(0) = 0
    would keep the image out of the output entirely."""
    from repro_torch.models import model as M
    params = M.init_params(cfg, 0, device="cuda")
    params["cross_blocks"]["xgate"].fill_(1.0)
    return params


def _vlm_batch(cfg, gen):
    """The 8 smoke prompts padded to 1,024 with their lengths, and stub
    image embeddings [8, 1601, 4096] from ``gen``."""
    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)
    tokens = torch.zeros(BATCH, 1024, dtype=torch.int32)
    for b, p in enumerate(prompts):
        tokens[b, :len(p)] = torch.from_numpy(p)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    img = torch.randn(BATCH, cfg.num_image_tokens, cfg.d_model,
                      generator=gen).to(getattr(torch, cfg.dtype))
    return {"tokens": tokens.cuda(), "lengths": lengths.cuda(),
            "image_embeds": img.cuda()}


def phase_e2e_vlm():
    """``e2e_vlm``: llama-3.2-vision-11b at full width (the image encoder a
    stub: embeddings from seed 0), every cross gate 1.0.  5 layers (one
    group: the cross layer and four self layers) in f32 and bf16: a
    prefill of the 8 smoke prompts over their images and 2 decode steps,
    through the kernels and under ``ops.use_reference()``, the logits to
    ``E2E_F32_TOL`` (f32) or ``E2E_BF16_REL`` (bf16) and the image k/v
    equal.  Then 40 layers in bf16: the prefill, 32 greedy decode steps
    (each step's wall to a synchronised card; the launches counted from
    0 over prefill and steps), 4 more steps profiled for their device
    time, and ``max_memory_allocated``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    smi = _card()
    tag = "[e2e_vlm]"
    base = get_config("llama-3.2-vision-11b")
    res = {"compare": []}
    for dtype_name in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, num_layers=base.cross_attn_every,
                                  dtype=dtype_name)
        params = _vlm_params(cfg)
        batch = _vlm_batch(cfg, torch.Generator().manual_seed(0))
        steps = torch.randint(0, cfg.vocab_size, (2, BATCH, 1),
                              generator=torch.Generator().manual_seed(1),
                              dtype=torch.int32).cuda()

        def run():
            lg, cache = M.prefill(cfg, params, batch, MAX_LEN)
            out = [lg]
            for j in range(2):
                lg, cache = M.decode_step(cfg, params, steps[j], cache,
                                          batch["lengths"] + j)
                out.append(lg)
            return torch.cat(out).float(), cache
        rec, c_got, c_want = _kernels_vs_plain(run, dtype_name, tag,
                                               "5 layers")
        for n in ("img_k", "img_v"):
            require(torch.equal(c_got[n], c_want[n]), f"{tag} {n} differs")
        log(f"{tag} {cfg.num_layers} layers (1 cross + "
            f"{cfg.num_layers - 1} self) at full width, "
            f"{dtype_name}: prefill of {BATCH} prompts (bucket 1024) over "
            f"{cfg.num_image_tokens} image rows + 2 decode steps, kernels "
            f"against plain: max_abs_err {rec['max_abs_err']:.3e}, rel "
            f"{rec['rel_err']:.3e}; image k/v equal; {smi}")
        res["compare"].append(rec)
        del params, batch, c_got, c_want, run
        gc.collect()
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(base, dtype="bfloat16")
    params = _vlm_params(cfg)
    batch = _vlm_batch(cfg, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lg, cache = M.prefill(cfg, params, batch, MAX_LEN)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    lengths = batch["lengths"].clone()
    tok = torch.argmax(lg, -1).to(torch.int32)
    toks = [tok]

    def step():
        nonlocal tok, lengths
        lg, _ = M.decode_step(cfg, params, tok[:, None], cache, lengths)
        tok = torch.argmax(lg, -1).to(torch.int32)
        lengths = lengths + 1
        toks.append(tok)
        return lg
    walls, lg = _step_ms(step, 32)
    counts = ops.launch_counts()
    res["launches"] = {n: counts[n] for n in PATH_KERNELS["e2e_vlm"]}
    for n, c in res["launches"].items():
        require(c > 0, f"{tag} {n} was not launched")
    require(torch.isfinite(lg).all(), f"{tag} logits not finite")
    allt = torch.stack(toks).cpu()
    require(bool(((allt >= 0) & (allt < cfg.vocab_size)).all()))
    prof, _ = _profile("e2e_vlm decode steps", step, 4)
    peak = torch.cuda.max_memory_allocated()
    med, p90 = statistics.median(walls), _pct(walls, 90)
    log(f"{tag} {cfg.num_layers} layers bf16 ("
        f"{cfg.num_layers // cfg.cross_attn_every} cross), B={BATCH}, "
        f"S_max={MAX_LEN}: "
        f"prefill {prefill_ms:.2f} ms (bucket 1024 over "
        f"{cfg.num_image_tokens} image rows), 32 greedy decode steps: "
        f"median {med:.3f} ms, p90 {p90:.3f} ms (wall to a synchronised "
        f"card), device {prof['device_ms_per_call']:.3f} ms a step; "
        f"max_memory_allocated {peak}; launches {res['launches']}; {smi}")
    res.update(prefill_ms=prefill_ms, decode_ms=walls, decode_median_ms=med,
               decode_p90_ms=p90, device_ms=prof["device_ms_per_call"],
               profile=prof, max_memory_allocated=peak, card=smi)
    del params, cache, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_e2e_encoder():
    """``e2e_encoder``: hubert-xlarge at full width (the conv frontend a
    stub: frames from seed 0).  2 layers in f32 and bf16, ``forward`` over
    frames [8, 1024, 1280] through the kernels and under
    ``ops.use_reference()`` (``E2E_F32_TOL``, ``E2E_BF16_REL``); then 48
    layers in bf16: 3 forwards timed (wall to a synchronised card), the
    launches counted from 0 over them, and one profiled for its device
    time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    smi = _card()
    tag = "[e2e_encoder]"
    base = get_config("hubert-xlarge")
    res = {"compare": []}
    gen = torch.Generator().manual_seed(0)
    frames32 = torch.randn(BATCH, 1024, base.d_model, generator=gen).cuda()
    for dtype_name in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, num_layers=2, dtype=dtype_name)
        params = M.init_params(cfg, 0, device="cuda")
        frames = frames32.to(getattr(torch, dtype_name))
        rec, _, _ = _kernels_vs_plain(
            lambda: (M.forward(cfg, params, {"frames": frames}).float(),
                     None), dtype_name, tag, "2 layers")
        log(f"{tag} 2 layers at full width, {dtype_name}: forward over "
            f"frames {tuple(frames.shape)}, kernels against plain: "
            f"max_abs_err {rec['max_abs_err']:.3e}, rel "
            f"{rec['rel_err']:.3e}; {smi}")
        res["compare"].append(rec)
        del params, frames
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(base, dtype="bfloat16")
    params = M.init_params(cfg, 0, device="cuda")
    frames = frames32.to(torch.bfloat16)
    M.forward(cfg, params, {"frames": frames})       # warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    walls, y = _step_ms(lambda: M.forward(cfg, params, {"frames": frames}),
                        3)
    counts = ops.launch_counts()
    res["launches"] = {n: counts[n] for n in PATH_KERNELS["e2e_encoder"]}
    require(res["launches"]["flash_attention"] == 3 * cfg.num_layers,
            f"{tag} launches {res['launches']}")
    require(y.shape == (BATCH, 1024, cfg.vocab_size)
            and torch.isfinite(y).all(), f"{tag} logits")
    prof, _ = _profile("e2e_encoder forward", lambda: M.forward(
        cfg, params, {"frames": frames}), 1)
    log(f"{tag} {cfg.num_layers} layers bf16, frames [{BATCH}, 1024, "
        f"{cfg.d_model}]: "
        f"forward {statistics.median(walls):.2f} ms (median of 3, wall to "
        f"a synchronised card; {walls}), device "
        f"{prof['device_ms_per_call']:.2f} ms; launches {res['launches']}; "
        f"{smi}")
    res.update(forward_ms=walls, device_ms=prof["device_ms_per_call"],
               profile=prof, card=smi)
    del params, frames, frames32, y
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_e2e_window():
    """``e2e_window``: chatglm3-6b at full width with ``attn_window`` =
    8192 (the dry run's ``LONG_CONTEXT_WINDOW``), B = 2 prompts of 9,216
    tokens (lengths 9216 and 9000; the reference's mha takes Sq % 1024 ==
    0 above 1024).  2 layers in f32 and bf16: the prefill (the ring keeps
    the last 8,192 rows) and 16 decode steps (the ring written at L %
    8192, its slots masked as the reference masks them), through the
    kernels and under ``ops.use_reference()``, each step's logits held
    (``E2E_F32_TOL``, ``E2E_BF16_REL``).  Then 28 layers in bf16: the
    prefill and 64 decode steps timed (wall to a synchronised card), the
    launches counted from 0 over them."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    smi = _card()
    tag = "[e2e_window]"
    base = dataclasses.replace(get_config("chatglm3-6b"),
                               attn_window=WINDOW)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, base.vocab_size, (2, WINDOW_S), generator=gen,
                           dtype=torch.int32).cuda()
    lengths = torch.tensor([WINDOW_S, 9000], dtype=torch.int32).cuda()
    steps = torch.randint(0, base.vocab_size, (16, 2, 1), generator=gen,
                          dtype=torch.int32).cuda()
    max_len = WINDOW_S + 128
    res = {"compare": []}
    for dtype_name in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, num_layers=2, dtype=dtype_name)
        params = M.init_params(cfg, 0, device="cuda")

        def run():
            lg, cache = M.prefill(cfg, params, {"tokens": tokens,
                                                "lengths": lengths}, max_len)
            out = [lg]
            for j in range(16):
                lg, cache = M.decode_step(cfg, params, steps[j], cache,
                                          lengths + j)
                out.append(lg)
            return torch.cat(out).float(), cache
        rec, c_got, _ = _kernels_vs_plain(run, dtype_name, tag, "2 layers")
        require(c_got["k"].shape[2] == WINDOW, f"{tag} ring rows")
        log(f"{tag} 2 layers at full width, {dtype_name}: prefill of 2 x "
            f"{WINDOW_S} tokens (window {WINDOW}) + 16 ring decode steps, "
            f"kernels against plain: max_abs_err {rec['max_abs_err']:.3e}, "
            f"rel {rec['rel_err']:.3e}; {smi}")
        res["compare"].append(rec)
        del params, c_got, run
        gc.collect()
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(base, dtype="bfloat16")
    params = M.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lg, cache = M.prefill(cfg, params, {"tokens": tokens,
                                        "lengths": lengths}, max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    state = {"tok": torch.argmax(lg, -1).to(torch.int32), "L": lengths}

    def step():
        lg, _ = M.decode_step(cfg, params, state["tok"][:, None], cache,
                              state["L"])
        state["tok"] = torch.argmax(lg, -1).to(torch.int32)
        state["L"] = state["L"] + 1
        return lg
    walls, lg = _step_ms(step, 64)
    counts = ops.launch_counts()
    res["launches"] = {n: counts[n] for n in PATH_KERNELS["e2e_window"]}
    for n, c in res["launches"].items():
        require(c > 0, f"{tag} {n} was not launched")
    require(torch.isfinite(lg).all(), f"{tag} logits not finite")
    med, p90 = statistics.median(walls), _pct(walls, 90)
    log(f"{tag} {cfg.num_layers} layers bf16, B=2, window {WINDOW}: prefill "
        f"{prefill_ms:.2f} ms ({WINDOW_S} tokens a prompt), 64 ring decode "
        f"steps: median {med:.3f} ms, p90 {p90:.3f} ms (wall to a "
        f"synchronised card); launches {res['launches']}; {smi}")
    res.update(prefill_ms=prefill_ms, decode_ms=walls, decode_median_ms=med,
               decode_p90_ms=p90, card=smi)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return res


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
    # dense KV and dense banks with chunked prefill: the chunk step over
    # the slot's row
    "serve_dense_chunked": ("qwen3-30b-a3b", dict(prefill_chunk=CHUNK),
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
    # a dense decoder, no experts (arXiv:2406.12793): 32 query heads over
    # 2 kv heads (group 16), half rotary, QKV bias; the paper's stores
    "serve_chatglm3": ("chatglm3-6b",
                       dict(kv_mode="paged", kv_block_size=BS,
                            prefill_chunk=CHUNK), None),
}


# a 1,024-token prefill's eager wall ms, measured on an NVIDIA H100 80GB
# HBM3 at 700.00 W before the prefills were captured (PERF.md section 5)
EAGER_PREFILL_MS = {"serve_dense": 204.85, "serve_mla": 131.14,
                         "serve_mla_pooled": 137.41, "serve_mamba2": 92.52,
                         "serve_zamba2": 123.07}


def _pool_bytes(pool):
    """Bytes the CUDA caching allocator holds in the graph memory pool
    ``pool`` (its segments' total size)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


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
    elif not cfg.is_moe:
        arch = (f"{cfg.num_heads} heads over {cfg.num_kv_heads} kv heads "
                f"of {cfg.resolved_head_dim} (rotary on "
                f"{cfg.rope_fraction:g} of each), QKV bias "
                f"{cfg.qkv_bias}, {cfg.norm_type}, MLP {cfg.d_ff}, no "
                f"experts")
    else:
        arch = (f"{cfg.num_experts} experts top-{cfg.top_k} "
                f"(+{cfg.num_shared_experts} shared, {cfg.first_k_dense} "
                f"dense layers first), moe_d_ff {cfg.moe_d_ff}")
    if cfg.arch_type not in ("ssm", "hybrid"):
        stores = (("paged KV" if knobs.get("kv_mode") == "paged"
                   else "dense latent KV" if cfg.use_mla else "dense KV")
                  + ("" if not cfg.is_moe else ", pooled experts"
                     if knobs.get("expert_mode") == "pooled"
                     else ", dense expert banks"))
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
    chunked = bool(knobs.get("prefill_chunk"))
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
    pool_gib = (_pool_bytes(srv.imm._pool) / 2**30 if cuda_graphs
                else 0.0)
    if cuda_graphs:
        # the set: the decode step, the chunk step or every bucket's
        # prefill (one replica)
        n_graphs = len(srv.engine.graphs._graphs)
        want_graphs = 1 + (1 if chunked else len(knobs.get(
            "prefill_buckets", (64,))))
        require(n_graphs == want_graphs, f"{tag} {n_graphs} graphs "
                f"captured, {want_graphs} expected")
        log(f"{tag} {n_graphs} graphs captured in {capture_s:.3f} s; the "
            f"graph pool holds {pool_gib:.3f} GiB, memory_reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    held = held_bytes = 0
    stack = [srv.engine.params]
    while stack:                       # parameters held (index arrays out)
        t = stack.pop()
        if isinstance(t, dict):
            stack += t.values()
        elif isinstance(t, list):
            stack += t
        elif t.is_floating_point() or t.dtype == torch.int8:
            held += t.numel()
            held_bytes += t.numel() * t.element_size()
    log(f"{tag} boot {boot_s:.2f} s (capture {capture_s:.3f} s), "
        f"{mem_boot / 2**30:.2f} GiB allocated, {held:,} parameters held")
    floor_ms = None
    if cfg.arch_type == "dense":
        # every weight but the embedding table (one row a token) is read
        # once a tick: the tick's floor at the card's memory rate
        emb = srv.engine.params["embed"]
        floor_b = held_bytes - emb.numel() * emb.element_size()
        floor_ms = floor_b / PEAK_BYTES * 1e3
        log(f"{tag} decode floor: a tick reads {floor_b / 1e9:.2f} GB of "
            f"weights, {floor_ms:.3f} ms at {PEAK_BYTES / 1e12:.2f} TB/s "
            f"(the KV read besides)")

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
    if chunked and not paged:
        # each chunk step: one mixed attention per layer over the slot's
        # row; each decode step one slot decode per layer; no monolithic
        # prefill
        L, steps = cfg.num_layers, eng._step_count
        want = {"mixed_block_paged_attention": L * n_chunks,
                "paged_decode_attention": L * steps, "flash_attention": 0}
        for name, n in want.items():
            require(counts[name] == n, f"{name}: {counts[name]} launches, "
                    f"{n} expected")
        log(f"{tag} {n_chunks} chunk steps over the slot rows: "
            f"{counts['mixed_block_paged_attention'] / n_chunks:g} "
            f"mixed_block_paged_attention launches each")
    if paged and not cfg.is_moe:
        # each chunk step: one mixed attention per layer; each decode
        # step: one paged decode per layer
        dec_name, mix = PATH_KERNELS[phase][:2]
        L, steps = cfg.num_layers, eng._step_count
        want = {mix: L * n_chunks, dec_name: L * steps}
        for name, n in want.items():
            require(counts[name] == n, f"{name}: {counts[name]} launches, "
                    f"{n} expected")
        log(f"{tag} {n_chunks} chunk steps, {steps} decode steps: "
            f"{counts[mix] / n_chunks:g} {mix} and "
            f"{counts[dec_name] / steps:g} {dec_name} launches each")
    elif paged:
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
        "graph_pool_gib": pool_gib,
        "tokens": {r.rid: list(eng.generated[r.rid]) for r in reqs},
        "ticks": len(ticks) + len(prof_ticks),
        "decode_tick_ms_median": statistics.median(dec),
        "decode_tick_ms_p90": float(np.percentile(dec, 90)),
        "decode_ticks": len(dec),
        "output_tok_s": gen_tokens / wall, "serve_s": wall,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts, "decode_floor_ms": floor_ms,
        "ttft_s": {r.rid: r.ttft for r in reqs},
        "profile": prof_rows, "profiled_ticks_ms": prof_ticks,
    }
    if chunked:
        chunk = [t["chunk_ms"] / t["chunks"] for t in ticks if t["chunks"]]
        res.update(chunk_step_ms_median=statistics.median(chunk),
                   chunk_steps=len(chunk))
        if paged:
            res["kv"] = {k: kv[k] for k in ("shared_block_hits",
                                            "cow_copies", "preemptions")}
        if paged and cfg.is_moe:
            res["gmm_launches"] = gmm_launches
        pre_txt = (f"chunk step median {res['chunk_step_ms_median']:.2f} ms "
                   f"over {len(chunk)} chunks")
        # two more chunk steps of the 1,000-token prompt's last chunk (ctx
        # 1000, q_len 104) into freed pool rows 0.. or the freed row 0,
        # traced
        long = max(prompts, key=len)
        S = len(long)
        start = (S - 1) // CHUNK * CHUNK
        toks = torch.zeros(1, CHUNK, dtype=torch.int32, device="cuda")
        toks[0, :S - start] = torch.from_numpy(long[start:])
        if paged:
            nblk = -(-S // BS)
            tbl = torch.full((1, MAX_LEN // BS), NB, dtype=torch.int32,
                             device="cuda")
            tbl[0, :nblk] = torch.arange(nblk)
            ids = torch.arange(start // BS, start // BS + CHUNK // BS,
                               dtype=torch.int32, device="cuda")
            ids[ids >= nblk] = NB                # past the prompt: dropped
            where = (tbl, ids)
        else:
            where = (torch.zeros(1, dtype=torch.int32, device="cuda"),)
        if eng.graphs is not None:
            # the graph's replay, as the engine runs it: the inputs from
            # host arrays, the token read back
            host = [t.cpu().numpy() for t in (toks, *where)]

            def step():
                int(eng.graphs.chunk(0, host[0], start, S, *host[1:])[0])
        else:
            eager = eng.compiled[f"chunk_prefill_{CHUNK}"]

            def step():
                int(eager(eng.params, eng.cache, toks, start, S,
                          *where)[0][0])
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
        res.update(_prefill_twins(phase, eng, prompts, knobs, tag))
    log(f"{tag} {len(reqs)} requests, {gen_tokens} tokens in {wall:.2f} s "
        f"({res['output_tok_s']:.2f} tok/s); decode tick median "
        f"{res['decode_tick_ms_median']:.2f} ms, p90 "
        f"{res['decode_tick_ms_p90']:.2f} ms over {len(dec)} ticks; "
        f"{pre_txt}; max_memory_allocated "
        f"{res['max_memory_allocated_gib']:.2f} GiB")
    log(f"{tag} launches {counts}" + (f"; kv {res['kv']}" if paged else ""))
    return res


def _prefill_twins(phase, eng, prompts, knobs, tag):
    """The longest prompt's monolithic prefill (1,000 tokens, bucket 1024)
    into slot 0's freed row: the eager step's wall (median of 3), then,
    on a graphed server, the bucket's graph replayed as the engine replays
    it (inputs from host arrays, the token read back) into the same row
    after it was overwritten: its token and every cache leaf's row must
    equal the eager step's bit for bit; its wall (median of 5) and two
    replays under the profiler (device ms).  On an eager server, two eager
    prefills under the profiler."""
    long = max(prompts, key=len)
    S = len(long)
    b = min(knobs["prefill_buckets"])
    S_pad = max(b, -(-S // b) * b)
    host = np.zeros((1, S_pad), np.int32)
    host[0, :S] = long
    toks = torch.from_numpy(host).cuda()
    length = torch.tensor([S], dtype=torch.int32, device="cuda")
    row = torch.zeros(1, dtype=torch.int32, device="cuda")
    eager = eng.compiled[f"prefill_{S_pad}"]

    def eager_step():
        return int(eager(eng.params, eng.cache, toks, length, row)[0][0])

    def timed(fn, n):
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - ts) * 1e3)
        return statistics.median(walls)
    out = {"prefill_eager_wall_ms": timed(eager_step, 3)}
    want = eager_step()
    rows = {n: leaf[:, 0].clone() for n, leaf in eng.cache.items()}
    before = EAGER_PREFILL_MS.get(phase)
    if eng.graphs is None:
        out["prefill_profile"], _ = _profile(
            f"eager prefills of {S} tokens (bucket {S_pad})", eager_step, 2)
        return out
    require(eng.graphs.has_prefill(S_pad), f"{tag} no graph of bucket "
            f"{S_pad}")

    def graphed():
        return int(eng.graphs.prefill(0, host, S, np.zeros(1, np.int32))[0])
    for leaf in eng.cache.values():
        leaf[:, 0].fill_(1)                  # the graph must rewrite it
    got = graphed()
    require(got == want, f"{tag} graphed prefill token {got}, eager {want}")
    for n, leaf in eng.cache.items():
        require(torch.equal(leaf[:, 0], rows[n]),
                f"{tag} graphed prefill's {n} row differs from the eager "
                f"step's")
    out["prefill_graph_wall_ms"] = timed(graphed, 5)
    out["prefill_profile"], _ = _profile(
        f"graphed prefills of {S} tokens (bucket {S_pad})", graphed, 2)
    dev_ms = out["prefill_profile"]["device_ms_per_call"]
    log(f"{tag} prefill of {S} tokens (bucket {S_pad}): graphed wall "
        f"{out['prefill_graph_wall_ms']:.2f} ms at {dev_ms:.2f} device ms "
        f"(idle {1 - dev_ms / out['prefill_graph_wall_ms']:.3f}); eager "
        f"wall {out['prefill_eager_wall_ms']:.2f} ms this call"
        + (f", {before:.2f} ms before the prefills were captured"
           if before else "")
        + "; token and cache row bitwise equal to the eager step's")
    return out


def phase_serve_dense_chunked(layers):
    """``serve_dense_chunked``: the graphed server, then its eager twin
    (``cuda_graphs=False``, unprofiled ticks) on the same requests: the
    greedy tokens must be equal.  The kernels line takes the graphed
    run's launches."""
    phase = "serve_dense_chunked"
    graphed = phase_serve(layers, phase)
    gc.collect()
    torch.cuda.empty_cache()
    eager = phase_serve(layers, phase, profile=False, cuda_graphs=False)
    require(graphed["tokens"] == eager["tokens"],
            f"[{phase}] the graphed server's tokens differ from the eager "
            f"twin's")
    cp, ep = graphed["chunk_profile"], eager["chunk_profile"]
    log(f"[{phase}] graphed tokens equal the eager twin's "
        f"({len(eager['tokens'])} requests); chunk step (ctx 1000, q_len "
        f"104) wall / device ms: graphed {graphed['chunk_step_wall_ms']:.2f}"
        f" / {cp['device_ms_per_call']:.2f}, eager "
        f"{eager['chunk_step_wall_ms']:.2f} / {ep['device_ms_per_call']:.2f};"
        f" decode tick median graphed {graphed['decode_tick_ms_median']:.2f}"
        f", eager {eager['decode_tick_ms_median']:.2f} ms")
    graphed["eager"] = {k: eager[k] for k in (
        "decode_tick_ms_median", "chunk_step_ms_median",
        "chunk_step_wall_ms", "chunk_profile", "serve_s", "boot_s")}
    gc.collect()
    torch.cuda.empty_cache()
    return graphed


def phase_serve_graphs(layers, done):
    """``serve`` and ``serve_mamba2`` (the most host-bound store) served
    eagerly (``cuda_graphs=False``) beside their graphed runs of this
    call (``done``; run here if their phases were not selected), one
    server at a time: the greedy tokens must be equal; prints each run's
    decode tick (unprofiled median and p90, device ms and idle share of 3
    profiled ticks), the chunk step (``serve``: unprofiled wall, device ms
    and idle share of the 1,000-token prompt's last chunk), the capture
    seconds and ``max_memory_allocated``; and, for every graphed serve
    phase of this call, its boot's capture seconds and the bytes its graph
    pool holds."""
    res = {"boot_captures": {}}
    for phase in SERVE_STORES:
        r = done.get(phase)
        if r is None or not r.get("cuda_graphs"):
            continue
        res["boot_captures"][phase] = {"capture_s": r["capture_s"],
                                       "graph_pool_gib": r["graph_pool_gib"]}
        log(f"[serve_graphs] {phase}: boot capture {r['capture_s']:.3f} s, "
            f"graph pool {r['graph_pool_gib']:.3f} GiB")
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
    TP2 -> DP3 x TP2 at tp = 2 (4 -> 6 logical devices either way); DP1 x
    TP3 -> DP2 x TP3 at tp = 3 (3 -> 6); DP1 x TP8 -> DP2 x TP8 at tp = 8
    (8 -> 16)."""
    from repro_torch.core.topology import ElasticConfig
    if tp in (3, 8):
        return (ElasticConfig(1, tp, tuple(range(tp))),
                ElasticConfig(2, tp, tuple(range(2 * tp))))
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


def _e2e_packed():
    """A 2-layer qwen3-30b-a3b at full width on DP4 (4 logical devices of
    the card) with dense expert banks and dense KV, bf16: one decode step
    of the 8 slots with ``moe_ep``'s expert-slot dispatch and with the
    packed one (``ParallelCtx.moe_dispatch="packed"``), each through the
    kernels (under ``set_sync_debug_mode("error")``) and through
    ``ops.use_reference()`` from the same cache, held to the e2e bf16
    rule, and each step's device ms from a profile of 3 steps.  The two
    dispatches drop different entries (capacity per expert against per
    device), so they are compared with each other only for the record.
    Packed computes every one of a device's 32 experts on every row it
    receives: its rows an expert are printed beside expert slots'."""
    from repro_torch.configs import get_config
    from repro_torch.core.hmm import HMM
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    tag = "[e2e_scale packed]"
    cfg = dataclasses.replace(get_config("qwen3-30b-a3b"), num_layers=2,
                              dtype="bfloat16")
    c4, _ = _scale_cfgs()
    hmm = HMM(cfg, 1, batch_per_replica=SCALE_BPR, max_len=MAX_LEN, seed=1,
              device="cuda", all_devices=["cuda:0"] * SCALE_DEVICES)
    hmm.boot(c4)
    _fill_pool(hmm.cache, torch.Generator(device="cuda").manual_seed(2))
    ctx = _scale_ctx(c4, hmm)
    B = c4.dp * SCALE_BPR
    cg = torch.Generator().manual_seed(3)
    lengths = torch.tensor([1900, 5, 640, 1024, 77, 300, 1500, 16][:B],
                           dtype=torch.int32).cuda()
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=cg,
                           dtype=torch.int32).cuda()
    n_ep, elm, k = c4.ndev, cfg.num_experts // c4.ndev, cfg.top_k
    t_local = -(-B // n_ep)
    res, logits = {}, {}
    for mode in ("expert_slots", "packed"):
        pctx = dataclasses.replace(ctx, moe_dispatch=mode)
        cache = _clone_pool(hmm.cache)

        def step():
            return M.decode_step(cfg, hmm.params, tokens, cache, lengths,
                                 parallel=pctx)[0]

        def run():
            c = _clone_pool(hmm.cache)
            return M.decode_step(cfg, hmm.params, tokens, c, lengths,
                                 parallel=pctx)[0].float()

        run()                              # first calls: kernels loaded
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        with ops.use_reference():
            want = run()
        torch.cuda.synchronize()
        require(got.shape == (B, cfg.vocab_size))
        require(torch.isfinite(got).all() and torch.isfinite(want).all())
        rel = ((got - want).norm() / want.norm()).item()
        require(rel < E2E_BF16_REL, f"{tag} {mode}: logits rel err {rel}")
        prof, _ = _profile(f"{tag} {mode} decode steps of {B} slots on "
                           f"{c4.describe()}", step, 3)
        if mode == "packed":
            C = max(1, math.ceil(t_local * k / n_ep * cfg.capacity_factor))
            rows = elm * n_ep * C      # every local expert, every row
        else:
            from repro_torch.models.moe import capacity_for
            C = capacity_for(t_local, cfg)
            rows = elm * n_ep * C
        res[mode] = {"rel_err": rel, "max_abs_err":
                     (got - want).abs().max().item(),
                     "device_ms": prof["device_ms_per_call"],
                     "wall_ms": prof["wall_ms_per_call"], "capacity": C,
                     "expert_rows_a_device": rows, "profile": prof}
        logits[mode] = got
        per = "a destination" if mode == "packed" else "an expert"
        log(f"{tag} {mode}: logits rel err against the plain versions "
            f"{rel:.3e}; capacity {C} (rows {per} a source device), "
            f"{rows} expert-row products a device a MoE layer; decode step "
            f"device {prof['device_ms_per_call']:.3f} ms, wall "
            f"{prof['wall_ms_per_call']:.3f} ms")
        del cache
    a, b = logits["packed"], logits["expert_slots"]
    res["packed_vs_slots_rel"] = ((a - b).norm() / b.norm()).item()
    ratio = res["packed"]["device_ms"] / res["expert_slots"]["device_ms"]
    log(f"{tag} packed against expert slots (different drops): rel "
        f"{res['packed_vs_slots_rel']:.3e}; device ms packed / slots "
        f"{ratio:.3f}; card {_card()}")
    del hmm
    return res


def phase_e2e_scale():
    """A 2-layer qwen3-30b-a3b at full width booted on DP4 (4 logical
    devices of the card), a chunk step and a decode step held to the e2e
    rules; then scaled to DP6 (stage, commit) and the same again; then
    the packed dispatch's decode step (``_e2e_packed``)."""
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
    out.append(_e2e_packed())
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_e2e_tp():
    """A 2-layer qwen3-30b-a3b at full width booted on DP2 x TP2, on DP1 x
    TP4 (4 logical devices of the card) and on DP1 x TP8 (8; each rank
    holds 64 of a kv head's 128 columns): a chunk step and a decode step
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
        for dp, tp in ((2, 2), (1, 4), (1, 8)):
            ecfg = ElasticConfig(dp, tp, tuple(range(dp * tp)))
            hmm = HMM(cfg, tp, batch_per_replica=SCALE_BPR, max_len=MAX_LEN,
                      kv_mode="paged", kv_block_size=BS,
                      kv_blocks_per_replica=256, expert_mode="pooled",
                      seed=1, kv_dtype=store, expert_dtype=store,
                      device="cuda", all_devices=["cuda:0"] * (dp * tp))
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


SCALE_PHASES = {1: "serve_scale", 2: "serve_tp", 8: "serve_tp8"}


def _serve_scale(layers, store, timed, tp=1):
    """``serve_scale`` (tp = 1, DP4 -> DP6), ``serve_tp`` (tp = 2, DP2 x
    TP2 -> DP3 x TP2) or ``serve_tp8`` (tp = 8, DP1 x TP8 -> DP2 x TP8:
    each rank holds half a kv head) with one store, ``stage_scale`` at the
    5th tick and
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
    tag = f"[{SCALE_PHASES[tp]} {store or 'bf16'}]"
    c0, c1 = _scale_cfgs(tp)
    srv = _scale_server(cfg, store, tp, max(SCALE_DEVICES, c1.ndev))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv.boot(c0)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    boot_capture_s = srv.imm.stats["compile_s_total"]
    boot_graphs = len(srv.engine.graphs._graphs) if srv.engine.graphs else 0
    log(f"{tag} qwen3-30b-a3b, {L} layers, full width, paged KV, pooled "
        f"experts ({store or cfg.dtype}), chunked prefill, "
        f"{c0.describe()} -> {c1.describe()}, every logical device on the "
        f"one card; boot {boot_s:.2f} s (capture {boot_capture_s:.3f} s, "
        f"{boot_graphs} graphs), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    res = {"layers": L, "store": store or cfg.dtype, "boot_s": boot_s,
           "boot_capture_s": boot_capture_s, "boot_graphs": boot_graphs,
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
            res["scale"].update(
                capture_s=srv.imm.stats["compile_s_total"] - boot_capture_s,
                graphs=len(eng.graphs._graphs) if eng.graphs else 0)
            log(f"{tag} the target's {res['scale']['graphs']} graphs "
                f"captured in {res['scale']['capture_s']:.3f} s inside "
                f"stage_s")
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
    ticks_n = len(ticks) + 1 + c1.dp      # and the scale tick's serves
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
    log(f"{tag} launches " + str({k: counts[k] for k in want})
        + f"; a tick ({ticks_n} ticks): "
        + str({k: round(counts[k] / ticks_n, 2) for k in want}))
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
    (2 rows each), a chunk step for one (128 rows).  Where tp cuts a head
    the layer's two k/v gathers become a gather of each of q, k and v's
    columns onto rank 0, a broadcast of the k and v rows of all heads and
    a copy of each rank's query heads to it."""
    from repro_torch.device import torch_dtype
    from repro_torch.distributed.sharding import (place, tp_all_gather,
                                                  tp_all_reduce,
                                                  tp_broadcast, tp_gather)
    timer = Timer()
    par = eng.parallel
    devs = [par.torch_device(d) for d in par.replica_devices(0)]
    tp, L, dt = par.tp, cfg.num_layers, torch_dtype(cfg.dtype)
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cut = H % tp or KVH % tp
    out = {}
    for name, rows, reps in (("decode", (SCALE_BPR, 1), par.dp),
                             ("chunk", (1, CHUNK), 1)):
        x = [torch.randn(*rows, cfg.d_model, device="cuda").to(dt)
             for _ in devs]
        lg = [torch.randn(rows[0], cfg.vocab_size // tp,
                          device="cuda").to(dt) for _ in devs]
        t = {"all_reduce_ms": timer(lambda: tp_all_reduce(x, devs)),
             "broadcast_ms": timer(lambda: tp_broadcast(x[0], devs)),
             "all_gather_logits_ms": timer(
                 lambda: tp_all_gather(lg, devs, -1))}
        if cut:
            qc = [torch.randn(*rows, H * hd // tp, device="cuda").to(dt)
                  for _ in devs]
            kc = [torch.randn(*rows, KVH * hd // tp, device="cuda").to(dt)
                  for _ in devs]
            kw = torch.randn(*rows, KVH, hd, device="cuda").to(dt)
            qw = torch.randn(*rows, H, hd, device="cuda").to(dt)
            n = H // tp if H % tp == 0 else -(-H // tp) + 1
            t.update(
                gather_q_cols_ms=timer(lambda: tp_gather(qc, devs, -1)),
                gather_kv_cols_ms=timer(lambda: tp_gather(kc, devs, -1)),
                broadcast_kv_ms=timer(lambda: tp_broadcast(kw, devs)),
                place_q_heads_ms=timer(lambda: [
                    place(qw[:, :, :n], d) for d in devs]))
            layer = (t["gather_q_cols_ms"] + 2 * t["gather_kv_cols_ms"]
                     + 2 * t["broadcast_kv_ms"] + t["place_q_heads_ms"])
        else:
            kv = [torch.randn(*rows, KVH // tp, hd, device="cuda").to(dt)
                  for _ in devs]
            t["all_gather_kv_ms"] = timer(lambda: tp_all_gather(kv, devs, 2))
            layer = 2 * t["all_gather_kv_ms"]
        t["per_step_ms"] = reps * (
            L * (t["all_reduce_ms"] + layer + t["broadcast_ms"])
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
    exactly the migrations' pages, the rest of the copies exactly the new
    devices' non-expert shards (at tp > 1 each its TP rank's: every new
    device's shard of each TP-split leaf equals its rank's shard on the
    first replica, at tp = 8 the k/v shards half a kv head wide), commit
    moved no weight byte and zeroed the new replica's KV slice in each of
    its ranks' copies."""
    from repro_torch.distributed.sharding import tree_leaves_with_path
    eng, hmm = srv.engine, srv.hmm
    now = _shard_ptrs({"params": eng.params, "cache": eng.cache},
                      sorted({d for _, d in keep}))
    index = ("tables", "edest", "eslot", "gtable")
    # a DP1 source's KV shard is indexed whole, a DP2 target's by its
    # replica's slice: as in the reference's ``_grow_cache``, no shard
    # keeps its key and every replica's KV is allocated anew
    whole_kv = c0.dp == 1
    moved = [k for k, p in keep.items()
             if now[k] != p and not k[0].endswith(index)
             and not (whole_kv and k[0].startswith("cache/"))]
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
    fresh = c1.dp if whole_kv else c1.dp - c0.dp
    require(final["init_bytes"] == kv // c1.dp * fresh * c1.tp,
            (final["init_bytes"], kv))             # the new replicas' copies
    new = [d for d in c1.devices if d not in c0.devices]
    split = 0
    for path, leaf in tree_leaves_with_path(eng.params):
        if path.startswith("moe_pool") or path.endswith(index):
            continue
        for d in new:
            rank = c1.devices.index(d) % c1.tp
            require(torch.equal(leaf.shard(d), leaf.shard(c0.devices[rank])),
                    f"{tag} {path} on new device {d} is not rank {rank}'s "
                    f"shard")
        split += leaf.shard(new[0]).shape != tuple(leaf.shape)
    if c1.tp > 1:
        kvw = hmm.mcfg.num_kv_heads * hmm.mcfg.resolved_head_dim // c1.tp
        widths = {leaf.shard(new[0]).shape[-1]
                  for path, leaf in tree_leaves_with_path(eng.params)
                  if path.endswith(("attn/k/w", "attn/v/w"))}
        require(widths == {kvw}, (widths, kvw))
        log(f"{tag} the new replica's {split} TP-split leaves are its ranks' "
            f"shards; k/v shards {kvw} columns wide "
            f"({kvw / hmm.mcfg.resolved_head_dim:g} kv heads a rank)")
    nonzero = {f: v for f, v in final.items() if v}
    rate = staged["p2p_bytes"] / stage_synced / 1e9
    log(f"{tag} scale {c0.describe()} -> {c1.describe()}: stage_s "
        f"{ev.stage_s:.3f} (host; stall_s {ev.stall_s:.3f}), "
        f"{stage_synced:.3f} s with the card synchronised; switch_s "
        f"{ev.switch_s:.4f} (host), {switch_synced:.4f} s synchronised; "
        f"{migs} expert pages moved (copies between logical devices on "
        f"one card); bytes {nonzero}; staged copies "
        f"{staged['p2p_bytes'] / 1e9:.3f} GB at {rate:.1f} GB/s")
    return {"stage_s": ev.stage_s, "stall_s": ev.stall_s,
            "stage_synced_s": stage_synced,
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


def phase_serve_tp8(layers):
    """``serve_tp8``: the ``serve_scale`` server and requests at tp = 8, bf16,
    booted on DP1 x TP8 and scaled to DP2 x TP8 (8 -> 16 logical devices
    of the card); each rank holds 64 of a kv head's 128 columns."""
    res = _serve_scale(layers, None, True, 8)
    res["launches"] = {n: res["launches"][n]
                       for n in PATH_KERNELS["serve_tp8"]}
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


def _scale_server(cfg, store, tp, ndev=SCALE_DEVICES, **kw):
    from repro_torch.core.elastic_engine import ElasticServer
    gc.collect()
    torch.cuda.empty_cache()
    return ElasticServer(cfg, tp=tp, batch_per_replica=SCALE_BPR,
                         max_len=MAX_LEN, seed=0, device="cuda",
                         all_devices=["cuda:0"] * ndev,
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

# phase: (model, depth cap, tp, output tokens, server knobs);
# ``_scale_cfgs(tp)`` -> back, by drain: DP(4/tp) x TPtp -> DP(6/tp) x
# TPtp, and at tp = 3 DP1 x TP3 -> DP2 x TP3 (3 and 6 logical devices,
# neither dividing deepseek-v2-lite's 16 heads: q is cut mid-head, each
# rank attends 6 heads).  zamba2's eager twin ticked at about 0.5 s at 54
# layers (every replica launching its own SSD kernels), so its requests
# are shorter: the drain still waits on the new replicas' sequences
DENSE_SCALE = {
    "serve_scale_mla": ("deepseek-v2-lite-16b", SCALE_LAYERS, 2, 32,
                        dict(prefill_buckets=DENSE_BUCKETS,
                             expert_mode="pooled")),
    "serve_scale_mla_tp3": ("deepseek-v2-lite-16b", SCALE_LAYERS, 3, 32,
                            dict(prefill_buckets=DENSE_BUCKETS,
                                 expert_mode="pooled")),
    # one group of six layers (54 until the prefill graphs had to fit the
    # run's time)
    "serve_scale_zamba2": ("zamba2-2.7b", 6, 1, 16,
                           dict(prefill_buckets=tuple(range(128, 1025,
                                                            128)))),
}
# the ticks the scales start at: up at the 9th, switchover three ticks
# later, the drain back six ticks after that
UP_TICK, STAGED_TICKS, DOWN_AFTER = 8, 3, 6
# the graphed scale-up's stage_s measured on an NVIDIA H100 80GB HBM3 at
# 700.00 W (8 and 54 layers) when the target's set was its decode step
# alone
DECODE_ONLY_UP_STAGE_S = {"serve_scale_mla": 0.198,
                          "serve_scale_zamba2": 0.619}


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
    """Three replays of the current configuration's decode graph with
    every slot active (ragged lengths), profiled between ticks (the
    source's before any request arrives, ``serve_scale_mla_tp3``'s target
    right after the switchover); the cache is restored after them, so the
    served run goes on from the state its eager twin is in."""
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
            if cuda_graphs:
                # the target's set, captured inside stage_scale: its
                # decode step and every bucket's prefill on each replica
                inst = srv.imm._cache[srv.imm._key(c1)]
                want_n = 1 + c1.dp * len(knobs["prefill_buckets"])
                require(len(inst.graphs._graphs) == want_n,
                        f"{tag} target set of {len(inst.graphs._graphs)} "
                        f"graphs, {want_n} expected")
                events["up"].update(target_graphs=want_n,
                                    target_capture_s=inst.compile_s)
            stage = "during"
        elif n == UP_TICK + STAGED_TICKS:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            srv.switchover()
            torch.cuda.synchronize()
            events["up"]["switch_synced_s"] = time.perf_counter() - ts
            stage = "after"
            if cuda_graphs:
                # the target's decode step (its launches are not the
                # ticks': taken out of the counts)
                before = ops.launch_counts()
                res["profile_target"] = _decode_profile(srv, tag)
                after = ops.launch_counts()
                profiled = {k: after[k] - before[k] for k in after}
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
    if cuda_graphs:
        counts = {k: v - profiled[k] for k, v in counts.items()}
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
    # a DP1 source's KV shards are indexed whole, so every replica's KV is
    # allocated anew (the reference's ``_grow_cache``; ``_check_scale``)
    fresh = c1.dp if c0.dp == 1 else c1.dp - c0.dp
    require(fin["init_bytes"] == replica_kv * fresh * c1.tp,
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
    if cuda_graphs:
        e = events["up"]
        alone = DECODE_ONLY_UP_STAGE_S.get(phase)
        log(f"{tag} the scale-up's target set: {e['target_graphs']} graphs "
            f"(the decode step, {len(knobs['prefill_buckets'])} prefill "
            f"buckets x {c1.dp} replicas) captured in "
            f"{e['target_capture_s']:.3f} s inside stage_s "
            f"{e['stage_s']:.4f} (stall_s {up.stall_s:.4f})"
            + (f"; with its decode step alone (8 and 54 layers): stage_s "
               f"{alone:.3f}" if alone is not None else ""))
    if cuda_graphs:
        log(f"{tag} graphed decode step of every slot, device ms: "
            f"{c0.describe()} {res['profile']['device_ms_per_call']:.3f}, "
            f"{c1.describe()} "
            f"{res['profile_target']['device_ms_per_call']:.3f}")
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


# ------------------------------------------------------- the closed loop

# serve_closed_loop: the paper's Coordinator over the serve_scale server
# (qwen3-30b-a3b, full width, SCALE_LAYERS deep, paged bf16 KV, pooled
# bf16 pages, chunks of CHUNK, overlapped staging with 4 workers,
# scale-down by migrate, CUDA graphs), DP4 in a pool of 6 logical devices
CLOSED_LOOP = dict(
    slo=dict(ttft_s=1.0, tpot_s=0.1),
    policy=dict(window=8, cooldown_s=1.0, queue_scale_up=4),
    driver=dict(dt=0.05, min_dp=4, max_step_dp=2, settle_s=1.0,
                prewarm_next=False),
    # a calm base, a one-second burst to about twice DP4's 8 slots, a calm
    # tail that refills the estimator's window
    workload=dict(duration_s=20.0, burst=(2.0, 16.0, 2.0, 1.0),
                  prompt_len=(200, 1000), output_range=(16, 48), seed=0))


def _pct(xs, q):
    return float(np.percentile(xs, q)) if xs else float("nan")


def _wall_latencies(reqs, ticks):
    """Each request's TTFT, TPOT and inter-token gaps in wall ms: a
    virtual timestamp maps to the wall time at the end of the tick that
    produced it (``ticks``: (virtual t, wall at the step's start, at its
    end)); an arrival maps to the start of the first tick at or after it,
    where the driver submits it."""
    end = {t: w1 for t, _, w1 in ticks}
    starts = [(t, w0) for t, w0, _ in ticks]
    ttft, tpot, itl = [], [], []
    for r in reqs:
        t_arr = next(w0 for t, w0 in starts if t >= r.arrival_s)
        first = end[r.first_token_s]
        ttft.append((first - t_arr) * 1e3)
        if r.output_len > 1:
            tpot.append((end[r.finish_s] - first) * 1e3
                        / (r.output_len - 1))
        walls = [end[t] for t in r.token_times]
        itl += [(b - a) * 1e3 for a, b in zip(walls, walls[1:])]
    return {"ttft_p50": _pct(ttft, 50), "ttft_p99": _pct(ttft, 99),
            "tpot_p50": _pct(tpot, 50), "itl_p99": _pct(itl, 99)}


def _projected_bytes(driver, old, new):
    """The bytes of the driver's projection of ``old -> new``: the plan
    that ``transition_cost`` costs, from the driver's own inputs
    (``ClusterDriver.projection``): P2P, zero-copy, and a migrating
    scale-down's projected KV."""
    from repro_torch.core.scaling_plan import Op
    from repro_torch.serving.driver import transition_plan
    kw = driver.projection(old, new)
    mig = kw.pop("kv_migration_bytes")
    kw.pop("staging")
    plan, _ = transition_plan(driver.mcfg, driver.tp, old, new, **kw)
    by_op = plan.bytes_by_op()
    return {"p2p_bytes": by_op.get(Op.P2P, 0),
            "zero_copy_bytes": by_op.get(Op.ZERO_COPY, 0),
            "kv_migration_bytes": mig}


def phase_serve_closed_loop(layers):
    """``serve_closed_loop``: a ``ClusterDriver`` scales the serve_scale
    server on its own decisions under a burst of arrivals, up and back
    down to DP4; driver seconds beside wall ms."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.coordinator import ScalingPolicy
    from repro_torch.kernels import ops
    from repro_torch.serving.driver import (ClusterDriver, DevicePool,
                                            DriverConfig, ScalePhase,
                                            ServingBackend)
    from repro_torch.serving.metrics import SLO, summarize
    from repro_torch.serving.workload import burst, make_workload
    tag = "[serve_closed_loop]"
    cl = CLOSED_LOOP
    cfg = _capped(get_config("qwen3-30b-a3b"),
                  min(SCALE_LAYERS, layers or SCALE_LAYERS))
    c0, _ = _scale_cfgs()
    torch.cuda.reset_peak_memory_stats()
    srv = _scale_server(cfg, None, 1, staging="overlap", transfer_workers=4,
                        scaledown="migrate")
    srv.boot(c0)
    require(isinstance(srv, ServingBackend), "not a ServingBackend")
    eng = srv.engine
    slo = SLO(**cl["slo"])
    driver = ClusterDriver(srv, ScalingPolicy(slo=slo, **cl["policy"]),
                           mcfg=cfg, tp=1,
                           device_pool=DevicePool(range(SCALE_DEVICES)),
                           config=DriverConfig(**cl["driver"]))
    wl = cl["workload"]
    reqs = make_workload(duration_s=wl["duration_s"],
                         rps_fn=burst(*wl["burst"]),
                         prompt_len=wl["prompt_len"],
                         output_range=wl["output_range"], seed=wl["seed"],
                         vocab_size=cfg.vocab_size)

    # instrumentation around the server, none inside the package: each
    # tick's wall, its work by dp (the serve_scale launch rules), the
    # STAGING ticks' steps under sync-debug "error"; each scale's wall
    # from start_scale to DONE and the plan of the driver's projection
    ticks, work, strict, scales = [], {}, [0], []
    step, start_scale = srv.step, srv.start_scale
    tracer = obs.install(obs.Tracer())

    def timed_step(now):
        task = driver.task
        in_task = task is not None
        staging = in_task and task.phase is ScalePhase.STAGING
        dp, steps0 = eng.cfg.dp, eng._step_count
        tracer.clear()
        undo = _strict_steps(eng) if staging else None
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        try:
            out = step(now)
        finally:
            if undo is not None:
                undo()
        torch.cuda.synchronize()
        w1 = time.perf_counter()
        strict[0] += staging
        w = work.setdefault(dp, [0, 0])
        w[0] += eng._step_count - steps0
        w[1] += sum(e.args["chunks"] for e in tracer.events()
                    if e.name == "chunk.plan")
        ticks.append((now, w0, w1, in_task))
        return out

    def timed_start(target):
        rec = {"projected_bytes": _projected_bytes(
            driver, srv.current_config(), target)}
        torch.cuda.synchronize()
        rec["w0"] = time.perf_counter()
        task = start_scale(target)
        advance = task.advance

        def timed_advance(now):
            phase = advance(now)
            if phase.terminal and "wall_s" not in rec:
                torch.cuda.synchronize()
                rec["wall_s"] = time.perf_counter() - rec["w0"]
                rec["phase"] = phase.name
            return phase
        task.advance = timed_advance
        scales.append(rec)
        return task

    srv.step, srv.start_scale = timed_step, timed_start
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    until = 0.0
    while any(r.finish_s is None for r in reqs) or driver.task is not None:
        until += 5.0
        driver.run(reqs if until == 5.0 else [], until=until)
        require(until < 120.0, f"{tag} serving did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = ops.launch_counts()
    obs.install(None)
    srv.step, srv.start_scale = step, start_scale

    # what the loop must have done
    dirs = [e.direction for e in driver.events]
    require("up" in dirs and "down" in dirs,
            f"{tag} the loop did not go up and back down: {dirs}")
    require(len(scales) == len(driver.events) == len(srv.events)
            and all(s.get("phase") == "DONE" for s in scales),
            f"{tag} a scale did not complete: {scales}")
    for r in reqs:
        toks = eng.generated[r.rid]
        require(r.finish_s is not None and len(toks) == r.output_len,
                (r.rid, len(toks), r.output_len))
        require(all(0 <= t < cfg.vocab_size for t in toks))
    require(srv.hmm.active_cfg == c0, f"{tag} ended on "
            f"{srv.hmm.active_cfg.describe()}, not {c0.describe()}; "
            f"events {[(e.t, e.direction, e.dst) for e in driver.events]}")
    table = srv.hmm.page_table
    require(srv._staged_cfg is None and srv.hmm.staged is None
            and table.staged is None and not srv.hmm.staging_in_flight,
            f"{tag} staged state left behind")
    # DP4's devices hold the pages they own; the devices the scale-downs
    # released hold none
    for d in range(SCALE_DEVICES):
        owned = sum(1 for ref in table.active.values() if ref.device == d)
        require(owned == 0 or d in c0.devices,
                f"{tag} released device {d} owns {owned} pages")
        require(table.pages_in_use(d) == owned,
                f"{tag} device {d}: {table.pages_in_use(d)} pages in use, "
                f"{owned} owned")
    require(strict[0] > 0, f"{tag} no tick was served in STAGING")
    L = cfg.num_layers
    want = {
        "block_paged_decode_attention":
            L * sum(dp * w[0] for dp, w in work.items()),
        "mixed_block_paged_attention": L * sum(w[1] for w in work.values()),
        "paged_gmm": 3 * L * sum(dp * (w[0] + w[1])
                                 for dp, w in work.items()),
        "kv_cache_write": L * sum(dp * w[0] + w[1] for dp, w in work.items()),
    }
    for name, n in want.items():
        require(counts[name] == n, f"{tag} {name}: {counts[name]} launches, "
                f"{n} expected over {work} (dp: [decode steps, chunks])")
        require(n > 0, f"{tag} {name} was not launched")

    # what it measured
    summary = summarize(reqs, slo, backend=srv)
    wall_lat = _wall_latencies(reqs, [t[:3] for t in ticks])
    tokens = sum(r.output_len for r in reqs)
    tick_ms = {k: [(w1 - w0) * 1e3 for _, w0, w1, in_task in ticks
                   if in_task == k] for k in (True, False)}
    tick_stats = {("in_scale" if k else "outside"):
                  {"n": len(v), "median_ms": _pct(v, 50),
                   "p90_ms": _pct(v, 90)} for k, v in tick_ms.items()}
    events = []
    for e, ev, rec in zip(driver.events, srv.events, scales):
        measured = {"stage_s": ev.stage_s, "switch_s": ev.switch_s,
                    "stall_s": ev.stall_s,
                    "start_scale_to_done_s": rec["wall_s"],
                    "bytes": {f: getattr(ev.stats, f)
                              for f in ev.stats.BYTE_FIELDS},
                    "migrated_blocks": ev.migrated_blocks,
                    "migration_bytes": ev.migration_bytes}
        events.append({"t": e.t, "direction": e.direction, "src": e.src,
                       "dst": e.dst,
                       "projected_scale_s_paper_cluster":
                           e.projected_scale_s,
                       "projected_bytes": rec["projected_bytes"],
                       "measured": measured})
        log(f"{tag} t={e.t:.2f} (driver s) {e.direction} {e.src} -> "
            f"{e.dst}: projected_scale_s {e.projected_scale_s:.4f} (cost "
            f"model, the paper cluster's constants, not the card's; plan "
            f"P2P {rec['projected_bytes']['p2p_bytes']} B, zero-copy "
            f"{rec['projected_bytes']['zero_copy_bytes']} B, KV migration "
            f"{rec['projected_bytes']['kv_migration_bytes']} B)")
        log(f"{tag}   measured on the card: stage_s {ev.stage_s:.4f}, "
            f"switch_s {ev.switch_s:.4f}, stall_s {ev.stall_s:.4f}, "
            f"start_scale to DONE {rec['wall_s']:.4f} s; bytes "
            f"{ {k: v for k, v in measured['bytes'].items() if v} }; "
            f"migrated {ev.migrated_blocks} blocks, {ev.migration_bytes} B")
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag} qwen3-30b-a3b, {L} layers, {len(reqs)} requests over "
        f"{wl['duration_s']} driver s (burst {wl['burst']}), SLO "
        f"{cl['slo']} driver s: summarize {summary}")
    log(f"{tag} wall ms: TTFT p50 {wall_lat['ttft_p50']:.1f}, p99 "
        f"{wall_lat['ttft_p99']:.1f}; TPOT p50 {wall_lat['tpot_p50']:.2f}; "
        f"ITL p99 {wall_lat['itl_p99']:.2f}; {tokens} output tokens in "
        f"{wall:.2f} s wall, {tokens / wall:.1f} tokens a wall second")
    log(f"{tag} tick wall ms: {tick_stats}; {strict[0]} STAGING ticks "
        f"under sync-debug 'error'; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; launches {want}")
    srv.hmm.close()
    del srv, eng, driver
    return {"events": events, "summary_driver_s": summary,
            "wall_ms": wall_lat, "tokens": tokens, "serve_wall_s": wall,
            "tokens_per_wall_s": tokens / wall, "ticks": tick_stats,
            "strict_ticks": strict[0], "work": work, "launches": counts,
            "max_memory_allocated": peak, "requests": len(reqs),
            "params": CLOSED_LOOP}


# launch_serve: the launcher's main on the card (f32 smoke configs, 8
# logical devices on cuda:0); deepseek-v2-lite as the launcher's default
# traffic gives it (no scale), then a dense decoder with enough requests
# to scale up (the smoke MoE's 4 experts do not split over DP3's 6)
LAUNCH_RUNS = {
    "deepseek-v2-lite-16b": ["--arch", "deepseek-v2-lite-16b", "--tp", "2",
                             "--autoscale", "--requests", "8"],
    "qwen1.5-0.5b": ["--arch", "qwen1.5-0.5b", "--tp", "2", "--autoscale",
                     "--requests", "32"],
}


def phase_launch_serve():
    """``launch_serve``: ``repro_torch.launch.serve.main`` on the card;
    every request finishes, the dense run scales, each prefill attention
    is at a shape the kernels phase held (``SMOKE_FLASH_HEADS``), and
    each run's summary is printed in driver seconds and in wall
    seconds."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    os.environ["REPRO_SERVE_DEVICES"] = "8"
    res, counts, shapes = {}, {}, set()
    flash = ops.flash_attention

    def seen_flash(q, k, v, *a, **kw):
        shapes.add((q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                    v.shape[3], q.dtype))
        return flash(q, k, v, *a, **kw)
    for name, argv in LAUNCH_RUNS.items():
        tag = f"[launch_serve {name}]"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ops.flash_attention = seen_flash
        try:
            out = serve.main(argv)
        finally:
            ops.flash_attention = flash
        wall = time.perf_counter() - t0
        got = ops.launch_counts()
        counts = {k: counts.get(k, 0) + got[k] for k in got}
        s = out["summary"]
        require(s["finished"] == s["n"], f"{tag} {s}")
        if name == "qwen1.5-0.5b":
            require(out["scales"], f"{tag} no scale line")
        wall_lat = _wall_latencies(out["requests"], out["ticks"])
        log(f"{tag} summary (driver s): {s}")
        log(f"{tag} wall ms: TTFT p50 {wall_lat['ttft_p50']:.2f}, p99 "
            f"{wall_lat['ttft_p99']:.2f}; TPOT p50 "
            f"{wall_lat['tpot_p50']:.2f}; ITL p99 {wall_lat['itl_p99']:.2f};"
            f" {len(out['ticks'])} ticks in {wall:.2f} s (boot included); "
            f"scales {out['scales']}; launches "
            f"{ {k: v for k, v in got.items() if v} }")
        res[name] = {"summary_driver_s": s, "wall_ms": wall_lat,
                     "scales": out["scales"], "wall_s": wall,
                     "launches": got}
        out["server"].hmm.close()
    for n in PATH_KERNELS["launch_serve"]:
        require(counts[n] > 0, f"[launch_serve] {n} was not launched")
    held = {(LAUNCH_BUCKET, *h, torch.float32) for h in SMOKE_FLASH_HEADS}
    require(shapes <= held, f"[launch_serve] flash_attention at "
            f"{shapes - held}, not held by the kernels phase")
    res["launches"] = counts
    return res


# serve_rebalance: the reference test's tight bands, so that the policy
# acts on the smoke requests' near-uniform routing
REBALANCE_POLICY = dict(hot_factor=1.02, cold_factor=0.98, min_samples=3,
                        cooldown_s=0.5, max_actions=8)


def _mem_available():
    """The host's MemAvailable line of /proc/meminfo."""
    with open("/proc/meminfo") as f:
        return next(line.strip() for line in f
                    if line.startswith("MemAvailable"))


def _rebalance_serve(srv, reqs, tracer, scale_at=None, target=None):
    """Serve ``reqs`` to the end on a virtual clock (0.1 s a tick, the
    policy's cooldown clock); with ``target``, ``start_scale`` at tick
    ``scale_at`` and one ``advance`` after each tick.  Returns the tokens,
    the chunkless ticks' ``decode.tick`` spans (ms), the rebalance spans
    (begin and commit on the serving thread, the task's STAGING phase) and
    copy ops, and the scale task."""
    for r in reqs:
        srv.submit(r)
    eng, t, n, task = srv.engine, 0.0, 0, None
    decode_ms, commit_ms, staging_ms, copies = [], [], [], []
    begin_ms = []
    while any(r.finish_s is None for r in reqs) or \
            (task is not None and not task.done):
        require(n < 3000, "serving did not finish")
        if target is not None and n == scale_at:
            task = srv.start_scale(target)
        tracer.clear()
        srv.tick(t)
        if task is not None and not task.done:
            task.advance(t)
        ev = tracer.events()
        if not any(e.name == "prefill.chunks" for e in ev):
            decode_ms += [e.dur * 1e3 for e in ev if e.name == "decode.tick"]
        commit_ms += [e.dur * 1e3 for e in ev
                      if e.name == "hmm.commit_rebalance"]
        begin_ms += [e.dur * 1e3 for e in ev
                     if e.name == "hmm.begin_rebalance"]
        staging_ms += [e.dur * 1e3 for e in ev
                       if e.name == "rebalance.STAGING"]
        copies += [(e.name, e.dur) for e in ev
                   if e.name.startswith("rebalance:")]
        t, n = t + .1, n + 1
    torch.cuda.synchronize()
    return {"tokens": {r.rid: list(eng.generated[r.rid]) for r in reqs},
            "decode_ms": decode_ms, "commit_ms": commit_ms,
            "begin_ms": begin_ms,
            "staging_ms": staging_ms, "copies": copies, "task": task}


def _kind_rates(copies, page):
    """kind -> (ops, GB/s): each copy op's page over its own time (begin to
    landed on the worker), summed over the ops of that kind."""
    out = {}
    for kind in ("replicate", "demote"):
        ds = [d for name, d in copies if name.startswith(f"rebalance:{kind}")]
        out[kind] = (len(ds), len(ds) * page / sum(ds) / 1e9 if ds else None)
    return out


def _copy_rate(pairs, reps=5):
    """GB/s of copying every (destination, source) pair once, timed with
    CUDA events over ``reps`` rounds after one warm-up round."""
    def run():
        for dst, src in pairs:
            dst.copy_(src, non_blocking=True)
    run()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        run()
    b.record()
    b.synchronize()
    nbytes = reps * sum(s.nbytes for _, s in pairs)
    return nbytes / (a.elapsed_time(b) / 1e3) / 1e9


def phase_serve_rebalance(layers):
    """``serve_rebalance``: qwen3-30b-a3b at full width and
    ``SCALE_LAYERS`` layers, DP2 x TP2 on four logical devices of the
    card, bf16 pooled pages, paged KV, chunked prefill, CUDA graphs.  The
    8 smoke requests, served by a server without a policy, then by one
    with ``routing_sample_every=1`` and a tight ``RebalancePolicy``: it
    must replicate and demote mid-serving, give the same tokens, capture
    no graph after boot and keep every bound tensor.  Then every expert of
    two layers is demoted and the server scales to DP3 x TP2 while it
    serves 8 more requests: those layers' movers come from the pinned-host
    tier (``expert_h2d_bytes``), the others between logical devices."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.expert_pages import HOST
    from repro_torch.kernels import ops
    from repro_torch.serving.rebalance import RebalancePolicy
    from repro_torch.serving.workload import Request
    smi = _card()
    tag = "[serve_rebalance]"
    log(f"{tag} host {_mem_available()}")
    cfg = _capped(get_config("qwen3-30b-a3b"),
                  min(SCALE_LAYERS, layers or SCALE_LAYERS))
    L, E = cfg.num_layers, cfg.num_experts
    c0, c1 = _scale_cfgs(2)
    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)

    def requests(base):
        return [Request(rid=base + i, arrival_s=0.0, prompt_len=len(p),
                        output_len=32, prompt=p)
                for i, p in enumerate(prompts)]
    tracer = obs.install(obs.Tracer())
    res = {"layers": L}
    try:
        srv = _scale_server(cfg, None, 2)
        srv.boot(c0)
        plain = _rebalance_serve(srv, requests(0), tracer)
        srv.hmm.close()
        del srv
        srv = _scale_server(cfg, None, 2, routing_sample_every=1,
                            rebalance=RebalancePolicy(**REBALANCE_POLICY))
        srv.boot(c0)
        log(f"{tag} qwen3-30b-a3b, {L} layers, full width, paged KV, "
            f"pooled {cfg.dtype} experts (table width "
            f"{srv.hmm.params['blocks']['moe']['tables'].shape[-1]}: one "
            f"slot of slack), chunked prefill, CUDA graphs, "
            f"{c0.describe()} on one card; routing_sample_every=1, "
            f"RebalancePolicy({REBALANCE_POLICY})")
        eng = srv.engine
        captures, graphs = srv.imm.stats["captures"], eng.graphs
        require(graphs is not None and graphs._routed == 1,
                "the routed decode graph was not captured")
        keep = _shard_ptrs({"params": eng.params, "cache": eng.cache},
                           c0.devices)
        ops.reset_launch_counts()
        routed = _rebalance_serve(srv, requests(0), tracer)
        counts = ops.launch_counts()
        res["launches"] = _path_launches(counts, None, tag)
        _compare_tokens(routed["tokens"], plain["tokens"], tag,
                        "the server without a policy")
        require(routed["tokens"] == plain["tokens"],
                "the rebalanced server's tokens differ")
        summ = srv.rebalance_summary()
        require(summ is not None and summ["replicated"] >= 1
                and summ["demoted"] >= 1, f"the policy did not act: {summ}")
        require(srv.imm.stats["captures"] == captures
                and eng.graphs is graphs, "a graph was captured again")
        now = _shard_ptrs({"params": eng.params, "cache": eng.cache},
                          c0.devices)
        require(now == keep, "a bound tensor moved")
        page = srv.hmm.expert_page_nbytes()
        evs = [ev for ev in srv.rebalance_events if not ev.aborted]
        rates = _kind_rates(routed["copies"], page)
        plain_ms = statistics.median(plain["decode_ms"])
        routed_ms = statistics.median(routed["decode_ms"])
        log(f"{tag} graphed decode tick (chunkless, decode.tick span) "
            f"median: routed {routed_ms:.3f} ms over "
            f"{len(routed['decode_ms'])} ticks, plain {plain_ms:.3f} ms over "
            f"{len(plain['decode_ms'])} ticks; {smi}")
        log(f"{tag} {summ['passes']} passes ({summ['aborted']} aborted): "
            f"{summ['replicated']} replicated, {summ['demoted']} demoted, "
            f"{summ['dropped']} dropped, {summ['promoted']} promoted; tokens "
            f"equal the server without a policy; no graph captured after "
            f"boot, every bound tensor kept; {smi}")
        log(f"{tag} per pass: begin on the serving thread ms "
            f"{[round(x, 3) for x in routed['begin_ms']]}, STAGING span ms "
            f"{[round(x, 3) for x in routed['staging_ms']]}, wall_s "
            f"{[round(ev.stats.wall_s, 5) for ev in evs]}, op_s "
            f"{[round(ev.stats.op_s, 5) for ev in evs]}, commit on the "
            f"serving thread ms {[round(x, 3) for x in routed['commit_ms']]};"
            f" {smi}")
        log(f"{tag} expert_replica_bytes {summ['replica_bytes']} "
            f"({rates['replicate'][0]} ops, {rates['replicate'][1]} GB/s per "
            f"op), expert_d2h_bytes {summ['d2h_bytes']} "
            f"({rates['demote'][0]} ops, {rates['demote'][1]} GB/s per op, "
            f"into pinned host rows), host_tier_bytes "
            f"{summ['host_tier_bytes']}; {smi}")
        res.update(
            tokens_equal=True, summary=summ,
            decode_tick_ms={"routed": routed_ms, "plain": plain_ms},
            staging_ms=routed["staging_ms"], commit_ms=routed["commit_ms"],
            begin_ms=routed["begin_ms"],
            wall_s=[ev.stats.wall_s for ev in evs],
            op_s=[ev.stats.op_s for ev in evs], copy_rates=rates)

        # every expert of two layers into the pinned-host tier
        srv.rebalance_policy = None
        t = 1000.0
        while srv._rebalance_task is not None \
                and not srv._rebalance_task.done:
            srv.tick(t)
            t += .1
        pt = srv.hmm.page_table
        cold = [("demote", l, e) for l in (0, 1) for e in range(E)
                if (l, e) not in pt.host]
        tracer.clear()
        task = srv.start_rebalance(cold)
        while not task.done:
            srv.tick(t)
            t += .1
        st = task.stats
        d2h_rate = st.expert_d2h_bytes / st.wall_s / 1e9
        ev = tracer.events()
        per_op = _kind_rates([(e.name, e.dur) for e in ev
                              if e.name.startswith("rebalance:")], page)
        begin = sum(e.dur for e in ev if e.name == "hmm.begin_rebalance")
        host_bytes = srv.hmm.host_tier_bytes()
        pinned = all(t_.is_pinned() for rows in
                     srv.hmm._expert_host_pool.values()
                     for t_ in rows.values())
        require(pinned, "a host-tier row is not pinned")
        log(f"{tag} demoted {len(cold)} more pages (every expert of layers "
            f"0 and 1): expert_d2h_bytes {st.expert_d2h_bytes} in "
            f"{st.wall_s:.4f} s (begin to commit end, "
            f"{srv.hmm.transfer_workers} workers; begin {begin * 1e3:.2f} ms"
            f", op_s {st.op_s:.4f}) = {d2h_rate:.2f} GB/s, "
            f"{per_op['demote'][1]} GB/s per op (a slab not yet pinned is "
            f"pinned on the worker); host_tier_bytes {host_bytes} in "
            f"{srv.hmm._host_tier.pinned_bytes()} bytes of pinned slabs; "
            f"host {_mem_available()}; {smi}")
        res.update(pinned_bytes=srv.hmm._host_tier.pinned_bytes(),
                   demote_all={"pages": len(cold),
                               "d2h_bytes": st.expert_d2h_bytes,
                               "wall_s": st.wall_s, "gb_s": d2h_rate,
                               "begin_s": begin, "op_s": st.op_s,
                               "per_op_gb_s": per_op["demote"][1]},
                   host_tier_bytes=host_bytes)

        # a scale while serving: layers 0 and 1 come from the host tier
        ops.reset_launch_counts()
        run = _rebalance_serve(srv, requests(100), tracer, scale_at=4,
                               target=c1)
        more = ops.launch_counts()
        for n in res["launches"]:
            res["launches"][n] += more[n]
        task = run["task"]
        require(task.phase.name == "DONE" and srv.hmm.active_cfg == c1,
                "the scale did not finish")
        migs = srv.hmm.last_migrations
        host = [m for m in migs if m.src.device == HOST]
        require(all(m.src.device == HOST for m in migs if m.layer < 2),
                "a mover of a demoted layer did not come from the host tier")
        require(any(m.layer < 2 for m in migs), "no mover in layers 0, 1")
        stg = task.stage_stats
        require(stg.expert_h2d_bytes == len(host) * page,
                (stg.expert_h2d_bytes, len(host), page))
        require(stg.expert_p2p_bytes == (len(migs) - len(host)) * page,
                (stg.expert_p2p_bytes, len(migs), len(host)))
        for r in requests(100):
            toks = srv.engine.generated[r.rid]
            require(len(toks) == 32 and all(0 <= x < cfg.vocab_size
                                            for x in toks))
        # the same scale's copies replayed alone, timed with CUDA events:
        # host rows into pool pages, pool pages between logical devices
        pool = srv.hmm.params["moe_pool"]
        h2d = [(pool[b].shard(m.dst.device)[m.dst.page],
                srv.hmm._expert_host_pool[(m.layer, m.expert)][b])
               for m in host for b in pool]
        p2p = [(pool[b].shard(m.dst.device)[m.dst.page],
                pool[b].shard(m.dst.device)[m.dst.page].clone())
               for m in migs if m.src.device != HOST for b in pool]
        h2d_rate, p2p_rate = _copy_rate(h2d), _copy_rate(p2p)
        log(f"{tag} scale {c0.describe()} -> {c1.describe()} while serving "
            f"8 requests: {len(migs)} movers, {len(host)} from the host tier "
            f"(expert_h2d_bytes {stg.expert_h2d_bytes}), "
            f"{len(migs) - len(host)} between logical devices "
            f"(expert_p2p_bytes {stg.expert_p2p_bytes}); staging wall "
            f"{stg.wall_s:.4f} s; the same copies alone: H2D "
            f"{h2d_rate:.2f} GB/s, P2P (one card, device to device) "
            f"{p2p_rate:.2f} GB/s; {smi}")
        res["scale"] = {"movers": len(migs), "host_movers": len(host),
                        "h2d_bytes": stg.expert_h2d_bytes,
                        "p2p_bytes": stg.expert_p2p_bytes,
                        "stage_wall_s": stg.wall_s,
                        "h2d_gb_s": h2d_rate, "p2p_gb_s": p2p_rate}
        srv.hmm.close()
        del srv, eng, graphs
    finally:
        obs.install(None)
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------- scale to zero

def _overlap(a, b):
    """Do two (t0, t1) spans overlap?"""
    return max(a[0], b[0]) < min(a[1], b[1])


def _shards(leaf):
    """A leaf's (device, index, tensor) shards: a one-device instance's
    plain tensor is its one shard, indexed ``slice(None)``."""
    if hasattr(leaf, "addressable_shards"):
        return leaf.addressable_shards
    return [(None, (slice(None),) * leaf.dim(), leaf)]


def _logical_equal(old, old_table, new, new_table):
    """Every logical parameter of ``old`` (a parameter tree and its page
    table) bitwise equal in ``new``: each shard of a dense leaf of
    ``new`` (every replica's copy) against ``old``'s at the same index,
    the same indices in both, each expert's rows where each table puts
    them; plain (one-device) leaves count as one shard.  Returns the
    number of tensors compared."""
    from repro_torch.distributed.sharding import tree_leaves_with_path
    new_leaves = dict(tree_leaves_with_path(new))

    def key(idx):
        return tuple((s.start, s.stop) for s in idx)
    n = 0
    for path, leaf in tree_leaves_with_path(old):
        if path.startswith("moe_pool/") or re.search(
                r"moe/(tables|edest|eslot|gtable)$", path):
            continue
        by_index = {key(idx): t for _, idx, t in _shards(leaf)}
        shards = _shards(new_leaves[path])
        require({key(idx) for _, idx, _ in shards} == set(by_index),
                f"{path} is split otherwise after the unpark")
        for _, idx, t in shards:
            require(torch.equal(t, by_index[key(idx)]),
                    f"{path} differs after the unpark")
            n += 1
    pool_old, pool_new = old["moe_pool"], new["moe_pool"]

    def page(bank, ref):
        return (bank.shard(ref.device) if hasattr(bank, "shard")
                else bank)[ref.page]
    for key, ref in old_table.active.items():
        dst = new_table.active[key]
        for bank in pool_old:
            require(torch.equal(page(pool_new[bank], dst),
                                page(pool_old[bank], ref)),
                    f"expert {key} bank {bank} differs after the unpark")
            n += 1
    return n


def _strict(fn):
    """``fn`` under ``set_sync_debug_mode("error")``: a call that
    synchronises with the host raises (the mode is global: the
    TransferEngine's workers run under it too)."""
    def run(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return run


def _unpark(srv, target, tracer, t=0.0):
    """``start_unpark(target)`` and its polls to DONE, ``start_unpark`` and
    every STAGING poll under sync-debug "error" (a tick of ``srv`` itself
    would do nothing: it is parked until the commit; ``serve_fleet`` ticks
    a second server between the polls).  Returns the task and
    what it measured: each poll's wall, the STAGING polls, the wall from
    ``start_unpark`` to DONE (the card synchronised), the capture polls,
    and the op and capture spans."""
    from repro_torch.serving.driver import ScalePhase
    tracer.clear()
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    task = _strict(srv.start_unpark)(target)
    polls, staging, captures = [], 0, 0
    while not task.done:
        strict = task.phase is ScalePhase.STAGING
        capturing = strict and not task._captured
        p0 = time.perf_counter()
        (_strict(task.advance) if strict else task.advance)(t)
        polls.append(time.perf_counter() - p0)
        staging += strict
        captures += capturing
        t += 0.05
        require(len(polls) < 5000, "the unpark did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    require(task.phase is ScalePhase.DONE, f"unpark ended {task.phase}")
    ev = tracer.events()
    ops = [(e.t0, e.t1) for e in ev if e.name.startswith("unpark:")]
    comp = [(e.t0, e.t1) for e in ev if e.name == "unpark.compile"]
    return task, {"polls": polls, "staging_polls": staging,
                  "capture_polls": captures, "wall_s": wall,
                  "overlap": any(_overlap(a, b) for a in ops for b in comp),
                  "ops": len(ops), "compile_spans": len(comp)}


def _serve_all(srv, reqs, t=0.0):
    """Submit ``reqs``, tick to their end; returns their tokens."""
    for r in reqs:
        srv.submit(r)
    n = 0
    while any(r.finish_s is None for r in reqs):
        srv.tick(t)
        t, n = t + 0.05, n + 1
        require(n < 3000, "serving did not finish")
    torch.cuda.synchronize()
    return {r.rid: list(srv.engine.generated[r.rid]) for r in reqs}


def _host_alloc():
    """The caching host allocator's current counts, where this torch has
    ``torch.cuda.host_memory_stats``, this process's resident, locked and
    pinned bytes, and MemAvailable."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    got = {k: v for k, v in (stats() if stats else {}).items()
           if k.endswith("current") or k.startswith("num_host")}
    with open("/proc/self/status") as f:
        got.update(line.split(":", 1) for line in f.read().splitlines()
                   if line.startswith(("VmRSS", "VmLck", "VmPin")))
    return {**{k: str(v).strip() for k, v in got.items()},
            "MemAvailable": _mem_available()}


def _host_pinned(srv):
    return sum(b.nbytes for b in srv.hmm._parked.arena.blocks)


def phase_serve_park(layers):
    """``serve_park``: ``serve_tp``'s server (qwen3-30b-a3b at full width
    and ``SCALE_LAYERS`` layers, DP2 x TP2 on four logical devices of the
    card, paged bf16 KV, pooled bf16 pages, chunks of 128, CUDA graphs)
    with overlapped staging (4 workers) and ``expert_host_pages`` set.
    Layer 0 is demoted whole, the 8 smoke requests served, the server
    parked (layer 0's tier rows absorbed; ``memory_allocated`` back within
    256 MiB of its level before the boot) and unparked to DP2 x TP2: the
    requests again give the same tokens.  Parked again (its parameters
    kept aside) and unparked to DP3 x TP2: every logical parameter bitwise
    equal to the pre-park one, and the requests finish."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.workload import Request
    smi = _card()
    tag = "[serve_park]"
    cfg = _capped(get_config("qwen3-30b-a3b"),
                  min(SCALE_LAYERS, layers or SCALE_LAYERS))
    E = cfg.num_experts
    c0, c1 = _scale_cfgs(2)
    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)

    def requests(base):
        return [Request(rid=base + i, arrival_s=0.0, prompt_len=len(p),
                        output_len=32, prompt=p)
                for i, p in enumerate(prompts)]
    tracer = obs.install(obs.Tracer(capacity=1 << 20))
    res = {"layers": cfg.num_layers}
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        # an earlier phase's cached pinned blocks would make the park's
        # pinning warm
        torch._C._host_emptyCache()
        mem = {"before_boot": torch.cuda.memory_allocated()}
        srv = _scale_server(cfg, None, 2, staging="overlap",
                            transfer_workers=4, expert_host_pages=2 * E)
        srv.boot(c0)
        torch.cuda.synchronize()
        mem["after_boot"] = torch.cuda.memory_allocated()
        task = srv.start_rebalance([("demote", 0, e) for e in range(E)])
        t = 0.0
        while not task.done:
            srv.tick(t)
            t += .1
        log(f"{tag} qwen3-30b-a3b, {cfg.num_layers} layers, full width, "
            f"{c0.describe()} on one card, paged KV, pooled "
            f"{cfg.dtype} pages, chunks of {CHUNK}, overlapped staging (4 "
            f"workers), CUDA graphs; layer 0 demoted whole "
            f"({srv.hmm.host_tier_bytes()} bytes in the host tier)")
        ops.reset_launch_counts()
        before = _serve_all(srv, requests(0))
        host0 = _host_alloc()
        st = srv.park()
        gc.collect()
        torch.cuda.synchronize()
        mem["after_park"] = torch.cuda.memory_allocated()
        mem["reserved_after_park"] = torch.cuda.memory_reserved()
        lp = dict(srv.hmm.last_park)
        host1 = _host_alloc()
        require(mem["after_park"] - mem["before_boot"] < 256 << 20,
                f"{tag} memory_allocated after the park {mem}")
        require(srv.engine.graphs is None and all(
            i.graphs is None for i in srv.imm._cache.values()),
            f"{tag} a graph set survived the park")
        pinned = _host_pinned(srv)
        page = srv.hmm.expert_page_nbytes()
        log(f"{tag} park (cold: the host cache emptied first): wall "
            f"{st.wall_s:.4f} s = pinning "
            f"{lp['pin_s']:.4f} s + D2H {lp['copy_s']:.4f} s "
            f"({lp['copied_bytes'] / lp['copy_s'] / 1e9:.2f} GB/s) + the "
            f"rest; d2h_bytes {st.d2h_bytes} (expert_d2h_bytes "
            f"{st.expert_d2h_bytes}: {st.expert_d2h_bytes // page} pages "
            f"from the devices, the reference's count), copied "
            f"{lp['copied_bytes']}, absorbed from the host tier "
            f"{lp['absorbed_bytes']} ({lp['absorbed_bytes'] // page} "
            f"demoted pages, no copy), snapshot "
            f"{srv.hmm.parked_bytes()} bytes in {pinned} pinned; host "
            f"{host0} -> {host1}; memory_allocated before boot "
            f"{mem['before_boot']}, after boot {mem['after_boot']}, after "
            f"park {mem['after_park']} (reserved {mem['reserved_after_park']}"
            f"); {smi}")
        res["park"] = {"wall_s": st.wall_s, **lp, "d2h_bytes": st.d2h_bytes,
                       "expert_d2h_bytes": st.expert_d2h_bytes,
                       "parked_bytes": srv.hmm.parked_bytes(),
                       "pinned_bytes": pinned, "host": [host0, host1],
                       "memory": mem}
        task, m = _unpark(srv, c0, tracer, 100.0)
        host2 = _host_alloc()
        gc.collect()
        torch._C._host_emptyCache()
        host3 = _host_alloc()
        stg = task.stage_stats
        h2d = stg.h2d_copied_bytes / stg.wall_s / 1e9
        log(f"{tag} unpark -> {c0.describe()}: h2d_bytes {stg.h2d_bytes} "
            f"(the reference's count: whole pool slices), copied "
            f"{stg.h2d_copied_bytes} in a staging wall of {stg.wall_s:.4f} "
            f"s = {h2d:.2f} GB/s (op_s {stg.op_s:.4f}); {m['capture_polls']}"
            f" capture polls, capture_s {task.capture_s:.4f}, compile_hit "
            f"{task.event.compile_hit}; stall_s {task.stall_s:.4f}, longest "
            f"poll {max(m['polls']) * 1e3:.2f} ms, start_unpark to DONE "
            f"{m['wall_s']:.4f} s (the commit, which gives the snapshot's "
            f"pinned memory back, {task.event.switch_s:.4f} s; host {host2} "
            f"after it, {host3} after a gc.collect and another "
            f"_host_emptyCache); an unpark: op span overlaps an unpark.compile span: {m['overlap']}; "
            f"{smi}")
        require(m["overlap"], f"{tag} no op span overlapped a capture")
        require(lp["absorbed_bytes"] == E * page,
                f"{tag} absorbed {lp['absorbed_bytes']} bytes, not layer "
                f"0's {E} demoted pages")
        after = _serve_all(srv, requests(0), 200.0)
        counts = ops.launch_counts()
        res["launches"] = _path_launches(counts, None, tag)
        _compare_tokens(after, before, tag, "the pre-park run")
        require(after == before, f"{tag} tokens after the unpark differ")
        res["unpark"] = {"h2d_bytes": stg.h2d_bytes,
                         "h2d_copied_bytes": stg.h2d_copied_bytes,
                         "expert_h2d_bytes": stg.expert_h2d_bytes,
                         "init_bytes": task.stats.init_bytes,
                         "stage_wall_s": stg.wall_s, "op_s": stg.op_s,
                         "h2d_gb_s": h2d, "capture_s": task.capture_s,
                         "stall_s": task.stall_s,
                         "longest_poll_s": max(m["polls"]),
                         "start_to_done_s": m["wall_s"],
                         "commit_s": task.event.switch_s,
                         "host_after_commit": host2,
                         "host_after_gc": host3,
                         "capture_polls": m["capture_polls"],
                         "staging_polls": m["staging_polls"],
                         "overlap": m["overlap"], "tokens_equal": True}

        # again, to DP3 x TP2, the parameters kept aside to compare
        old = (srv.hmm.params, srv.hmm.page_table)
        st2 = srv.park()
        lp2 = dict(srv.hmm.last_park)
        task, m2 = _unpark(srv, c1, tracer, 300.0)
        n = _logical_equal(old[0], old[1], srv.hmm.params,
                           srv.hmm.page_table)
        del old
        more = _serve_all(srv, requests(100), 400.0)
        for toks in more.values():
            require(len(toks) == 32 and all(0 <= x < cfg.vocab_size
                                            for x in toks))
        log(f"{tag} park again (cold: the unpark's commit gave the pinned "
            f"memory back, and nothing is demoted): wall {st2.wall_s:.4f} s "
            f"= pinning {lp2['pin_s']:.4f} s + D2H {lp2['copy_s']:.4f} s; "
            f"unpark -> {c1.describe()}: "
            f"{n} logical tensors bitwise equal to the pre-park ones, "
            f"h2d_bytes {task.stats.h2d_bytes}, start_unpark to DONE "
            f"{m2['wall_s']:.4f} s, {m2['capture_polls']} capture polls; "
            f"the 8 requests finish; {smi}")
        res["again"] = {"park_wall_s": st2.wall_s, **lp2,
                        "unpark_start_to_done_s": m2["wall_s"],
                        "h2d_bytes": task.stats.h2d_bytes,
                        "compared": n}
        srv.hmm.close()
        del srv, task
    finally:
        obs.install(None)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _scale_one(cfg, prompts, cuda_graphs, tag):
    """``serve_scale_one``'s scale run: boot DP1, serve the 8 smoke
    requests for 6 ticks, ``stage_scale`` to DP2, one tick, ``switchover``,
    serve to the end, then ``start_scale`` back to DP1 (drain) advanced to
    DONE.  Returns (the server, the tokens, the two events, the drain's
    wall)."""
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.serving.workload import Request
    c1, c2 = ElasticConfig(1, 1, (0,)), ElasticConfig(2, 1, (0, 1))
    srv = _scale_server(cfg, None, 1, ndev=2, scaledown="drain",
                        cuda_graphs=cuda_graphs)
    srv.boot(c1)
    reqs = [Request(rid=i, arrival_s=0.0, prompt_len=len(p), output_len=32,
                    prompt=p) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    t = 0.0
    for _ in range(6):
        srv.tick(t)
        t += 0.05
    torch.cuda.synchronize()
    up = srv.stage_scale(c2)
    srv.tick(t)
    t += 0.05
    srv.switchover()
    torch.cuda.synchronize()
    require(srv.engine.num_slots == 2 * SCALE_BPR, f"{tag} slots")
    n = 0
    while any(r.finish_s is None for r in reqs):
        srv.tick(t)
        t, n = t + 0.05, n + 1
        require(n < 3000, f"{tag} serving did not finish")
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    task = srv.start_scale(c1)
    while not task.done:
        task.advance(t)
        t += 0.05
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - w0
    require(srv.current_config() == c1 and srv.engine.parallel is None,
            f"{tag} not back on one device")
    tokens = {r.rid: list(srv.engine.generated[r.rid]) for r in reqs}
    return srv, tokens, (up, task.event), drain_s


def phase_serve_scale_one(layers):
    """``serve_scale_one``: qwen3-30b-a3b at full width and
    ``SCALE_LAYERS`` layers, paged bf16 KV, pooled bf16 pages, chunks of
    128, CUDA graphs, two logical devices of the card.  Boots on ONE
    device (DP1: plain tensors, one-device steps), serves the 8 smoke
    requests part way, ``stage_scale`` to DP2 (the target's graphs
    captured inside it), ``switchover`` (the KV zeroed at this commit, as
    the reference's ``_grow_cache`` does: a DP1 shard is keyed whole),
    finishes, drains back to DP1 (``start_scale``), then parks at DP1
    with nothing kept aside (``memory_allocated`` back within 256 MiB of
    its level before the boot) and unparks to DP1: 8 fresh requests give
    the tokens they gave before the park.  A second park and unpark keeps
    the parameters aside: every logical one bitwise equal to the pre-park
    one.  The eager twin (``cuda_graphs=False``) runs the
    scale part and its tokens must equal the graphed run's."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.topology import ElasticConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.workload import Request
    smi = _card()
    tag = "[serve_scale_one]"
    cfg = _capped(get_config("qwen3-30b-a3b"),
                  min(SCALE_LAYERS, layers or SCALE_LAYERS))
    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)
    c1 = ElasticConfig(1, 1, (0,))
    res = {"layers": cfg.num_layers}
    tracer = obs.install(obs.Tracer(capacity=1 << 20))
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch._C._host_emptyCache()
        mem = {"before_boot": torch.cuda.memory_allocated()}
        ops.reset_launch_counts()
        srv, tokens, (up, down), drain_s = _scale_one(cfg, prompts, True,
                                                      tag)
        counts = ops.launch_counts()
        res["launches"] = _path_launches(counts, None, tag)
        fields = ("zero_copy_bytes", "p2p_bytes", "local_bytes",
                  "init_bytes", "expert_p2p_bytes",
                  "expert_zero_copy_bytes")
        for name, ev in (("up", up), ("down", down)):
            st = {f: int(getattr(ev.stats, f)) for f in fields}
            log(f"{tag} {ev.src} -> {ev.dst}: stage_s {ev.stage_s:.4f}, "
                f"switch_s {ev.switch_s:.4f}, stall_s {ev.stall_s:.4f}; "
                f"bytes {st} (init_bytes: the zeroed KV of the commit); "
                f"{smi}")
            res[name] = {"stage_s": ev.stage_s, "switch_s": ev.switch_s,
                         "stall_s": ev.stall_s, **st}
        kv1 = sum(t.nbytes for t in srv.engine.cache.values())
        require(up.stats.init_bytes == 2 * kv1,
                f"{tag} the DP1 -> DP2 commit made {up.stats.init_bytes} "
                f"KV bytes, not both replicas' {2 * kv1}")
        res["drain_s"] = drain_s
        def fresh(base):
            return [Request(rid=base + i, arrival_s=0.0, prompt_len=len(p),
                            output_len=32, prompt=p)
                    for i, p in enumerate(prompts)]
        before = _serve_all(srv, fresh(100), 100.0)
        # the first park keeps nothing aside, so the memory it frees shows
        st = srv.park()
        gc.collect()
        torch.cuda.synchronize()
        mem["after_park"] = torch.cuda.memory_allocated()
        require(mem["after_park"] - mem["before_boot"] < 256 << 20,
                f"{tag} memory_allocated after the park {mem}")
        task, m = _unpark(srv, c1, tracer, 200.0)
        again = _serve_all(srv, fresh(200), 300.0)
        require(list(again.values()) == list(before.values()),
                f"{tag} tokens after the unpark differ")
        log(f"{tag} park at {c1.describe()}: wall {st.wall_s:.4f} s, "
            f"d2h_bytes {st.d2h_bytes}; memory_allocated before boot "
            f"{mem['before_boot']}, after the park {mem['after_park']}; "
            f"unpark -> {c1.describe()}: start_unpark to DONE "
            f"{m['wall_s']:.4f} s, h2d_bytes {task.stats.h2d_bytes}; 8 "
            f"fresh requests' tokens equal before and after; {smi}")
        res.update(park_wall_s=st.wall_s, d2h_bytes=st.d2h_bytes,
                   unpark_start_to_done_s=m["wall_s"],
                   h2d_bytes=task.stats.h2d_bytes, memory=mem, card=smi)
        # again, the parameters kept aside to compare
        old = (srv.hmm.params, srv.hmm.page_table)
        st2 = srv.park()
        task, m2 = _unpark(srv, c1, tracer, 400.0)
        n = _logical_equal(old[0], old[1], srv.hmm.params,
                           srv.hmm.page_table)
        del old
        log(f"{tag} park again: wall {st2.wall_s:.4f} s; unpark -> "
            f"{c1.describe()}: start_unpark to DONE {m2['wall_s']:.4f} s; "
            f"{n} logical tensors bitwise equal to the pre-park ones; {smi}")
        res["again"] = {"park_wall_s": st2.wall_s,
                        "unpark_start_to_done_s": m2["wall_s"],
                        "compared": n}
        srv.hmm.close()
        del srv, task
        gc.collect()
        torch.cuda.empty_cache()
        eager, e_tokens, _, _ = _scale_one(cfg, prompts, False, tag)
        _compare_tokens(e_tokens, tokens, tag, "the graphed run")
        require(e_tokens == tokens, f"{tag} graphed tokens differ from "
                f"the eager twin's")
        eager.hmm.close()
        del eager
    finally:
        obs.install(None)
    gc.collect()
    torch.cuda.empty_cache()
    return res


# serve_fleet: two serve_park servers in one pool of 8 ids, the
# closed loop's policy; expert_pool_pages 512 a device (serve_park's) for
# both: "b" booted on DP1 x TP2 would default to 1,024 and its DP3 x TP2
# pools (58 GB) and "a"'s would not fit the card together
FLEET = dict(dt=0.05, settle_s=1.0, max_step_dp=2, pool_pages=512,
             park_after_idle_s=1.0)


def _fleet_server(cfg, seed, shared):
    from repro_torch.core.elastic_engine import ElasticServer
    gc.collect()
    torch.cuda.empty_cache()
    return ElasticServer(cfg, tp=2, batch_per_replica=SCALE_BPR,
                         max_len=MAX_LEN, seed=seed, device="cuda",
                         all_devices=["cuda:0"] * 8, kv_mode="paged",
                         kv_block_size=BS, expert_mode="pooled",
                         prefill_chunk=CHUNK, staging="overlap",
                         transfer_workers=4,
                         expert_pool_pages=FLEET["pool_pages"],
                         expert_host_pages=2 * cfg.num_experts,
                         imm_cache=shared)


def phase_serve_fleet(layers):
    """``serve_fleet``: a ``FleetDriver`` over two ``serve_park`` servers
    sharing one ``imm_cache`` in a pool of 8 ids: "a" (seed 0,
    ``min_devices`` 0, parks after 1 s idle) on DP2 x TP2 and "b" (seed
    1, ``min_devices`` 2) on DP1 x TP2.  "a" takes the 8 smoke requests
    and "b" 2 at t = 0; "b" a burst of 12 once "a" has parked, "a" 4 more
    once "b" has scaled up: "a" parks, "b" scales up onto ids "a" held,
    "a" unparks.  "b"'s decode steps during "a"'s unpark and "a"'s
    STAGING polls run under sync-debug "error"."""
    from collections import OrderedDict
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.coordinator import ScalingPolicy
    from repro_torch.kernels import ops
    from repro_torch.serving.driver import ScalePhase
    from repro_torch.serving.fleet import (FleetConfig, FleetDriver,
                                           FleetModelSpec)
    from repro_torch.serving.metrics import SLO
    from repro_torch.serving.workload import Request
    smi = _card()
    tag = "[serve_fleet]"
    cfg = _capped(get_config("qwen3-30b-a3b"),
                  min(SCALE_LAYERS, layers or SCALE_LAYERS))
    c0, _ = _scale_cfgs(2)
    from repro_torch.core.topology import ElasticConfig
    # cold pinning at "a"'s park, as a fleet's first park would have it
    torch._C._host_emptyCache()
    shared = OrderedDict()
    a = _fleet_server(cfg, 0, shared)
    a.boot(c0)
    b = _fleet_server(cfg, 1, shared)
    b.boot(ElasticConfig(1, 2, (0, 1)))
    cl = CLOSED_LOOP
    slo = SLO(**cl["slo"])
    specs = [FleetModelSpec("a", a, ScalingPolicy(slo=slo, **cl["policy"]),
                            cfg, 2, min_devices=0,
                            park_after_idle_s=FLEET["park_after_idle_s"]),
             FleetModelSpec("b", b, ScalingPolicy(slo=slo, **cl["policy"]),
                            cfg, 2, min_devices=2)]
    fd = FleetDriver(specs, range(8), FleetConfig(
        dt=FLEET["dt"], settle_s=FLEET["settle_s"],
        max_step_dp=FLEET["max_step_dp"]))
    rng = np.random.default_rng(1)
    prompts = _prompts(np.random.default_rng(0), cfg.vocab_size)

    def burst(base, t, n):
        return [Request(rid=base + i, arrival_s=t, prompt_len=len(p),
                        output_len=32, prompt=p)
                for i, p in enumerate(
                    rng.integers(0, cfg.vocab_size,
                                 int(rng.integers(200, 1001))
                                 ).astype(np.int32) for _ in range(n))]
    reqs = {"a": [Request(rid=i, arrival_s=0.0, prompt_len=len(p),
                          output_len=32, prompt=p)
                  for i, p in enumerate(prompts)],
            "b": burst(100, 0.0, 2)}
    # instrumentation around the servers, none inside the package: each
    # fleet tick's wall; "a"'s unpark polls and "b"'s decode steps under
    # sync-debug "error" while the unpark runs; "a"'s tokens' ticks
    tracer = obs.install(obs.Tracer(capacity=1 << 20))
    ticks, strict_steps, held_a, claimed = [], [0], set(), None
    a_unpark, a_start = {}, a.start_unpark

    def start_unpark(target):
        torch.cuda.synchronize()
        a_unpark["w0"] = time.perf_counter()
        task = _strict(a_start)(target)
        adv = task.advance

        def advance(now):
            staging = task.phase is ScalePhase.STAGING
            phase = (_strict(adv) if staging else adv)(now)
            if phase.terminal and "wall_s" not in a_unpark:
                torch.cuda.synchronize()
                a_unpark["wall_s"] = time.perf_counter() - a_unpark["w0"]
            return phase
        task.advance = advance
        a_unpark["task"] = task
        return task
    a.start_unpark = start_unpark
    b_step = b.step

    def step(now):
        task = a_unpark.get("task")
        undo = None
        if task is not None and not task.done:
            undo = _strict_steps(b.engine)
            strict_steps[0] += 1
        try:
            return b_step(now)
        finally:
            if undo is not None:
                undo()
    b.step = step
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    stage, arrivals = "park", reqs
    while True:
        torch.cuda.synchronize()
        w0, t_tick, n_ev = time.perf_counter(), fd.t, len(fd.events)
        fd.run(arrivals, until=fd.t + FLEET["dt"] / 2)     # one tick
        arrivals = {}
        torch.cuda.synchronize()
        ticks.append((t_tick, w0, time.perf_counter(),
                      [(e.model, e.kind) for e in fd.events[n_ev:]]))
        held_a |= set(fd.states["a"].lease)
        if ("b", "up") in ticks[-1][3] and stage != "park" \
                and claimed is None:
            st_b = fd.states["b"]
            claimed = st_b.lease[st_b.task_prev_lease:]
        kinds = [(e.model, e.kind) for e in fd.events]
        if stage == "park" and ("a", "park") in kinds:
            a_park = dict(a.hmm.last_park)
            arrivals, stage = {"b": burst(200, fd.t, 12)}, "up"
            reqs["b"] += arrivals["b"]
        elif stage == "up" and ("b", "up") in kinds[
                kinds.index(("a", "park")):]:
            late = [Request(rid=300 + i, arrival_s=fd.t, prompt_len=len(p),
                            output_len=32, prompt=p)
                    for i, p in enumerate(prompts[:4])]
            arrivals, stage = {"a": late}, "unpark"
            reqs["a"] += late
        done = all(r.finish_s is not None for v in reqs.values() for r in v)
        if stage == "unpark" and done and all(
                s.task is None for s in fd.states.values()):
            break
        require(fd.t < 120.0, f"{tag} the fleet did not finish: "
                f"{[(e.t, e.model, e.kind) for e in fd.events]}")
    wall = time.perf_counter() - t_start
    obs.install(None)
    counts = ops.launch_counts()
    a.start_unpark, b.step = a_start, b_step
    kinds = [(e.model, e.kind) for e in fd.events]
    p, u = kinds.index(("a", "park")), kinds.index(("a", "unpark"))
    up = next(i for i in range(p, u) if kinds[i] == ("b", "up"))
    require(p < up < u, f"{tag} order {kinds}")
    require(claimed and set(claimed) <= held_a,
            f"{tag} b grew onto {claimed}, a held {sorted(held_a)}")
    fd.check_invariants()
    for name, srv in (("a", a), ("b", b)):
        for r in reqs[name]:
            toks = srv.engine.generated[r.rid]
            require(r.finish_s is not None and len(toks) == 32
                    and all(0 <= x < cfg.vocab_size for x in toks),
                    f"{tag} {name} request {r.rid}")
    require(strict_steps[0] > 0, f"{tag} no step of b ran during the unpark")
    launches = _path_launches(counts, None, tag)
    ev_by_tick = {i: k for i, (_, _, _, k) in enumerate(ticks)}
    end = {t: w1 for t, _, w1, _ in ticks}
    start = [(t, w0) for t, w0, _, _ in ticks]
    events = []
    for e in fd.events:
        log(f"{tag} t={e.t:.2f} (driver s) {e.model} {e.kind} {e.src} -> "
            f"{e.dst}: projected_s {e.projected_s:.4f} (cost model, the "
            f"paper cluster's constants), queue {e.queue_depth}, free "
            f"{e.free_devices}")
        events.append(dataclasses.asdict(e))
    park_tick = next(i for i, k in ev_by_tick.items() if ("a", "park") in k)
    park_ms = (ticks[park_tick][2] - ticks[park_tick][1]) * 1e3
    late = reqs["a"][8:]
    cold_driver = [r.first_token_s - r.arrival_s for r in late]
    cold_wall = [(end[r.first_token_s]
                  - next(w0 for t, w0 in start if t >= r.arrival_s)) * 1e3
                 for r in late]
    proj = fd.events[u].projected_s
    a_commit = next(e.switch_s for e in a.events if e.src == "parked")
    tick_ms = sorted((w1 - w0) * 1e3 for _, w0, w1, _ in ticks)
    log(f"{tag} a's cold-start TTFT: {[round(x, 3) for x in cold_driver]} "
        f"driver s, {[round(x, 1) for x in cold_wall]} wall ms (unpark "
        f"start to DONE {a_unpark['wall_s']:.4f} s) against "
        f"unpark_transition_cost {proj:.4f} s (the paper cluster's; the "
        f"commit, which gives the snapshot's pinned memory back, "
        f"{a_commit:.4f} s); the fleet tick in which a parked "
        f"(b waits through it; cold pinning, the host cache emptied at the "
        f"phase's start): {park_ms:.1f} ms, of which pinning "
        f"{a_park['pin_s'] * 1e3:.1f} ms and D2H "
        f"{a_park['copy_s'] * 1e3:.1f} ms; fleet tick median "
        f"{_pct(tick_ms, 50):.2f} ms, p99 "
        f"{_pct(tick_ms, 99):.2f}, over {len(ticks)} ticks, {wall:.2f} s "
        f"wall; {strict_steps[0]} of b's steps under sync-debug 'error' "
        f"during the unpark; timeline {fd.timeline}; {smi}")
    a.hmm.close()
    b.hmm.close()
    del a, b, fd
    gc.collect()
    torch.cuda.empty_cache()
    return {"events": events, "cold_ttft_driver_s": cold_driver,
            "cold_ttft_wall_ms": cold_wall,
            "unpark_start_to_done_s": a_unpark["wall_s"],
            "unpark_projected_s": proj, "park_tick_ms": park_ms,
            "park": a_park, "unpark_commit_s": a_commit,
            "tick_ms": {"median": _pct(tick_ms, 50), "p99": _pct(tick_ms,
                                                                 99)},
            "ticks": len(ticks), "wall_s": wall,
            "strict_steps": strict_steps[0], "launches": launches,
            "params": FLEET}


def _grads(cfg, params, batch):
    """(loss, every parameter's gradient) of ``loss_fn`` (remat), in
    JAX's leaf order."""
    from repro_torch.models.model import loss_fn
    from repro_torch.distributed.sharding import tree_leaves as leaves
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss = loss_fn(cfg, params, batch)
    return loss.detach(), torch.autograd.grad(loss, ps,
                                              materialize_grads=True)


def _gnorm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads)).item()


def _train_case(name, tag):
    """``train`` / ``train_mla``: ``name`` at full width cut to
    ``TRAIN_LAYERS`` layers, bf16, from seed 0; the first step against
    ``ops.use_reference()``, then ``TRAIN_STEPS`` steps of
    ``make_train_step`` on one fixed batch, timed, and one profiled."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.training import train_loop
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.distributed.sharding import tree_leaves as leaves
    smi = _card()
    cfg = dataclasses.replace(get_config(name), num_layers=TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, 0, device="cuda", experts=True)
    n_params = sum(p.numel() for p in leaves(params))
    batch = train_loop.to_device(next(synthetic_batches(
        cfg, TRAIN_BATCH, TRAIN_SEQ, 0)), "cuda")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the first step's loss and gradients: kernels against plain
    with _Routing() as r_got:
        loss, grads = _grads(cfg, params, batch)
    require(all(bool(torch.isfinite(g).all()) for g in grads),
            f"{tag} a gradient is not finite")
    gnorm = _gnorm(grads)
    del grads
    with ops.use_reference(), _Routing() as r_want:
        loss_ref, grads = _grads(cfg, params, batch)
    gnorm_ref = _gnorm(grads)
    del grads
    n_moe = len(r_want) // 2          # the forward's calls, then remat's
    flips = sum(int((a != b).any(-1).sum())
                for a, b in zip(r_got[:n_moe], r_want[:n_moe]))
    loss_rel = abs(loss.item() - loss_ref.item()) / abs(loss_ref.item())
    gnorm_rel = abs(gnorm - gnorm_ref) / gnorm_ref
    log(f"{tag} first step, kernels against plain: loss {loss.item():.6f} "
        f"/ {loss_ref.item():.6f} (rel {loss_rel:.2e}), gnorm {gnorm:.6f} "
        f"/ {gnorm_ref:.6f} (rel {gnorm_rel:.2e}); {flips} of "
        f"{tokens * n_moe} routed rows flipped their top-{cfg.top_k} set "
        f"in the forward; {smi}")
    require(loss_rel < TRAIN_LOSS_REL, f"{tag} loss rel err {loss_rel}")
    require(gnorm_rel < TRAIN_GNORM_REL, f"{tag} gnorm rel err {gnorm_rel}")
    torch.cuda.empty_cache()
    # the steps: make_train_step, its optimizer timed apart
    opt = AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    state = init_state(opt, params)
    step = train_loop.make_train_step(cfg, opt)
    update = train_loop.apply_updates
    opt_ms = []

    def timed_update(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*a)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    losses = []

    def one():
        nonlocal params, state
        params, state, m = step(params, state, batch)
        losses.append(m["loss"].item())
    train_loop.apply_updates = timed_update
    try:
        ops.reset_launch_counts()
        walls, _ = _step_ms(one, TRAIN_STEPS)
        counts = ops.launch_counts()
    finally:
        train_loop.apply_updates = update
    launches = {n: counts[n] for n in PATH_KERNELS["train"]}
    require(launches == {"flash_attention": 2 * TRAIN_LAYERS * TRAIN_STEPS,
                         "flash_attention_bwd": TRAIN_LAYERS * TRAIN_STEPS},
            f"{tag} launches {launches}")
    require(all(math.isfinite(x) for x in losses)
            and all(b < a for a, b in zip(losses, losses[1:])),
            f"{tag} the loss did not fall at every step: {losses}")
    peak = torch.cuda.max_memory_allocated()
    prof, _ = _profile(f"{tag} train step", one, 1)
    wall = statistics.median(walls[1:])
    fb = [w - o for w, o in zip(walls, opt_ms)]
    log(f"{tag} {cfg.name} {TRAIN_LAYERS} layers bf16, {n_params:,} "
        f"parameters, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: losses "
        f"{[round(x, 4) for x in losses]}; step wall "
        f"{wall:.2f} ms (median of steps 2-{TRAIN_STEPS}; {walls}), "
        f"forward + backward {statistics.median(fb[1:]):.2f} ms, optimizer "
        f"{statistics.median(opt_ms[1:]):.2f} ms, {tokens / wall * 1e3:.0f} "
        f"tokens/s; max_memory_allocated {peak / 2**30:.2f} GiB; device "
        f"{prof['device_ms_per_call']:.2f} ms a step; launches {launches}; "
        f"{smi}")
    res = {"losses": losses, "step_ms": walls, "opt_ms": opt_ms,
           "fwd_bwd_ms": fb, "tokens_per_s": tokens / wall * 1e3,
           "max_memory_allocated": peak, "parameters": n_params,
           "loss_rel": loss_rel, "gnorm_rel": gnorm_rel,
           "routing_flips": flips, "launches": launches, "profile": prof,
           "card": smi}
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_train():
    return _train_case("qwen3-30b-a3b", "[train]")


def phase_train_mla():
    return _train_case("deepseek-v2-lite-16b", "[train_mla]")


def _train_step_f32_test_moe(smi):
    """One f32 step at the test MoE's widths (2 layers, 4 heads of 16, 24
    experts top-2): the loss and every gradient through the kernels
    within 1e-4 of ``ops.use_reference()``'s."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.training import train_loop
    from repro_torch.training.data import synthetic_batches
    cfg = ModelConfig(name="test-moe", arch_type="moe", num_layers=2,
                      d_model=64, vocab_size=128, num_heads=4,
                      num_kv_heads=4, head_dim=16, d_ff=128, num_experts=24,
                      top_k=2, moe_d_ff=32, dtype="float32",
                      capacity_factor=100.0)
    batch = train_loop.to_device(next(synthetic_batches(
        cfg, TRAIN_BATCH, LAUNCH_TRAIN_SEQ, 0)), "cuda")
    params = M.init_params(cfg, 0, device="cuda", experts=True)
    loss, grads = _grads(cfg, params, batch)
    with ops.use_reference():
        loss_ref, grads_ref = _grads(cfg, params, batch)
    torch.testing.assert_close(loss, loss_ref, atol=1e-4, rtol=1e-4)
    err = 0.0
    for g, w in zip(grads, grads_ref):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        err = max(err, (g - w).abs().max().item())
    log(f"[launch_train] test MoE f32 step, kernels against plain: loss "
        f"{loss.item():.6f} / {loss_ref.item():.6f}, {len(grads)} "
        f"gradients within 1e-4 (max abs err {err:.2e}); {smi}")
    return {"loss": loss.item(), "loss_ref": loss_ref.item(),
            "grad_max_abs_err": err}


def phase_launch_train():
    """``launch_train``: ``repro_torch.launch.train.main`` on the card for
    the two trained families' f32 smoke configs; every loss finite, each
    flash call at a shape the kernels phase held."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    smi = _card()
    res, counts, shapes = {}, {}, set()
    flash = ops.flash_attention

    def seen_flash(q, k, v, *a, **kw):
        shapes.add((q.shape[2], k.shape[2], q.shape[3], v.shape[3],
                    q.dtype))
        return flash(q, k, v, *a, **kw)
    for name in ("qwen3-30b-a3b", "deepseek-v2-lite-16b"):
        tag = f"[launch_train {name}]"
        ops.reset_launch_counts()
        ops.flash_attention = seen_flash
        t0 = time.perf_counter()
        try:
            out = train.main(["--arch", name, "--steps", "3", "--batch",
                              str(TRAIN_BATCH), "--seq",
                              str(LAUNCH_TRAIN_SEQ)])
        finally:
            ops.flash_attention = flash
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ops.launch_counts()
        counts = {k: counts.get(k, 0) + got[k] for k in got}
        require(all(math.isfinite(l) for _, l in out["history"]),
                f"{tag} {out['history']}")
        log(f"{tag} history {out['history']} in {wall:.2f} s; launches "
            f"{ {k: v for k, v in got.items() if v} }; {smi}")
        res[name] = {"history": out["history"], "wall_s": wall,
                     "launches": got}
        del out
    for n in PATH_KERNELS["launch_train"]:
        require(counts[n] > 0, f"[launch_train] {n} was not launched")
    held = {(*h, torch.float32) for h in SMOKE_BWD_HEADS}
    require(shapes <= held, f"[launch_train] flash_attention at "
            f"{shapes - held}, not held by the kernels phase")
    res["launches"] = counts
    res["test_moe_step"] = _train_step_f32_test_moe(smi)
    torch.cuda.empty_cache()
    return res


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
                            "e2e_tp,serve,serve_int8,serve_dense,"
                            "serve_dense_chunked,serve_mla,"
                            "serve_mla_pooled,serve_mamba2,serve_zamba2,"
                            "serve_chatglm3,serve_graphs,"
                            "serve_scale,serve_tp,serve_tp8,serve_overlap,"
                            "serve_down,"
                            "serve_down_tp,serve_scale_mla,"
                            "serve_scale_mla_tp3,"
                            "serve_scale_zamba2,serve_closed_loop,"
                            "launch_serve,serve_rebalance,serve_park,"
                            "serve_fleet,e2e_vlm,e2e_encoder,e2e_window,"
                            "serve_scale_one,train,train_mla,launch_train")
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
    runs += [(p, lambda p=p: (phase_serve_dense_chunked(args.layers)
                              if p == "serve_dense_chunked"
                              else phase_serve(args.layers, p)))
             for p in SERVE_STORES]
    # the eager twins of serve and serve_mamba2, held against this call's
    # graphed runs
    runs.append(("serve_graphs", lambda: phase_serve_graphs(args.layers,
                                                            res)))
    runs.append(("serve_scale", lambda: phase_serve_scale(args.layers)))
    runs.append(("serve_tp", lambda: phase_serve_scale(args.layers, 2)))
    runs.append(("serve_tp8", lambda: phase_serve_tp8(args.layers)))
    # serve_overlap holds its staged bytes and tokens against this call's
    # serve_scale (serial staging of the same server and requests)
    runs.append(("serve_overlap", lambda: phase_serve_overlap(
        args.layers, res.get("serve_scale")
        or phase_serve_scale(args.layers))))
    runs.append(("serve_down", lambda: phase_serve_down(args.layers)))
    runs.append(("serve_down_tp", lambda: phase_serve_down(args.layers, 2)))
    runs += [(p, lambda p=p: phase_serve_scale_dense(args.layers, p))
             for p in DENSE_SCALE]
    runs.append(("serve_closed_loop",
                 lambda: phase_serve_closed_loop(args.layers)))
    runs.append(("launch_serve", phase_launch_serve))
    runs.append(("serve_rebalance",
                 lambda: phase_serve_rebalance(args.layers)))
    runs.append(("serve_park", lambda: phase_serve_park(args.layers)))
    runs.append(("serve_fleet", lambda: phase_serve_fleet(args.layers)))
    runs.append(("e2e_vlm", phase_e2e_vlm))
    runs.append(("e2e_encoder", phase_e2e_encoder))
    runs.append(("e2e_window", phase_e2e_window))
    runs.append(("serve_scale_one",
                 lambda: phase_serve_scale_one(args.layers)))
    runs.append(("train", phase_train))
    runs.append(("train_mla", phase_train_mla))
    runs.append(("launch_train", phase_launch_train))
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
