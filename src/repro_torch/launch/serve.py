"""Elastic serving launcher — the port's counterpart of
``repro.launch.serve``:

    python -m repro_torch.launch.serve --arch <id> [--tp N] [--requests N]
        [--autoscale] [--device cuda|cpu]

Boots the ``ElasticServer`` on DP2 at the chosen tp, with the ``-smoke``
config of the architecture (capacity factor 100), replays a steady stream
of short requests (one every 0.15 s, from ``default_rng(0)``) and, with
``--autoscale``, lets the server's SLO-aware estimator scale it up the
ladder DP1 .. DP4 (a rung fits when ``tp * dp`` logical devices exist).
It prints a line for each scale and ``metrics.summarize`` at the end.
Times are the loop's virtual seconds (0.05 s a tick), as in the reference.

``REPRO_SERVE_DEVICES`` (default 8) sets the number of logical devices;
each is the chosen device, so on the card all of them are ``cuda:0``.  It
runs on the card unless ``--device cpu`` is given, and raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.coordinator import ScalingPolicy
from repro_torch.core.elastic_engine import ElasticServer
from repro_torch.core.topology import ElasticConfig
from repro_torch.device import resolve_device
from repro_torch.serving.metrics import SLO, summarize
from repro_torch.serving.workload import Request

TICK_S = 0.05          # virtual seconds a tick
MAX_T = 300.0          # virtual seconds before the loop counts as stalled


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b",
                    choices=sorted(REGISTRY))
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the launcher; returns ``{"summary", "scales", "requests",
    "server", "ticks"}`` (``ticks``: each tick's virtual time and its
    ``time.perf_counter()`` before and after, for a caller that maps the
    virtual timestamps onto the wall)."""
    args = parse_args(argv)
    n_dev = int(os.environ.get("REPRO_SERVE_DEVICES", "8"))
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch + "-smoke"),
                              capacity_factor=100.0)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no serving decode")
    if cfg.is_moe and cfg.num_experts % (2 * args.tp):
        raise SystemExit("num_experts must divide the EP ladder")

    slo = SLO(ttft_s=2.0, tpot_s=1.0)
    policy = ScalingPolicy(slo=slo, window=8, cooldown_s=2.0,
                           queue_scale_up=3) if args.autoscale else None
    srv = ElasticServer(cfg, tp=args.tp, batch_per_replica=2, max_len=128,
                        prefill_buckets=(32,), policy=policy, seed=0,
                        all_devices=[dev] * n_dev, device=dev)
    ladder = [ElasticConfig(dp=d, tp=args.tp,
                            devices=tuple(range(args.tp * d)))
              for d in (1, 2, 3, 4) if args.tp * d <= n_dev]
    level = 1
    srv.boot(ladder[level])

    rng = np.random.default_rng(0)
    reqs = [Request(i, 0.15 * i, 16, int(rng.integers(8, 20)),
                    prompt=rng.integers(0, cfg.vocab_size, 16))
            for i in range(args.requests)]
    scales, ticks = [], []
    t, i = 0.0, 0
    while any(r.finish_s is None for r in reqs):
        while i < len(reqs) and reqs[i].arrival_s <= t:
            srv.submit(reqs[i])
            i += 1
        if args.autoscale:
            d = srv.autoscale_decision(t)
            if d == "up" and level + 1 < len(ladder):
                level += 1
                srv.scale_to(ladder[level])
                line = (f"[t={t:.2f}] scaled up -> "
                        f"{srv.hmm.active_cfg.describe()}")
                scales.append(line)
                print(line)
        w0 = time.perf_counter()
        srv.tick(t)
        ticks.append((t, w0, time.perf_counter()))
        t += TICK_S
        if t > MAX_T:
            raise SystemExit("stalled")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    summary = summarize(reqs, slo)
    print(summary)
    return {"summary": summary, "scales": scales, "requests": reqs,
            "server": srv, "ticks": ticks}


if __name__ == "__main__":
    main()
