"""Serving metrics — the port's own copy of ``repro.serving.metrics``
(paper §7.3): TTFT, TPOT, inter-token latency, SLO attainment, the paged
pool's pressure (preemptions, block utilization) and the scaling surface
(decode stall during scaling, overlap efficiency, migrated KV).

Every time here is in the caller's clock: the ``ClusterDriver``'s virtual
seconds when it drives the server (``Request``'s timestamps are the
``now`` of the ticks that produced them)."""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.serving.workload import Request


@dataclasses.dataclass(frozen=True)
class SLO:
    ttft_s: float
    tpot_s: float


def meets_slo(r: Request, slo: SLO) -> Optional[bool]:
    if r.ttft is None or r.finish_s is None:
        return None
    ok = r.ttft <= slo.ttft_s
    if r.tpot is not None:
        ok = ok and r.tpot <= slo.tpot_s
    return ok


def slo_attainment(reqs: Sequence[Request], slo: SLO) -> float:
    done = [meets_slo(r, slo) for r in reqs]
    done = [d for d in done if d is not None]
    if not done:
        return float("nan")
    return sum(done) / len(done)


def slo_attainment_timeline(reqs: Sequence[Request], slo: SLO,
                            window_s: float = 10.0, dt: float = 1.0):
    """(times, attainment) over sliding windows keyed by finish time: the
    window ``t - window_s <= finish_s <= t`` (both ends inclusive), NaN
    where it holds no request."""
    finished = [r for r in reqs if r.finish_s is not None]
    if not finished:
        return np.array([]), np.array([])
    t_end = max(r.finish_s for r in finished)
    ts = np.arange(0.0, t_end + dt, dt)
    judged = [(r.finish_s, v) for r in finished
              for v in (meets_slo(r, slo),) if v is not None]
    judged.sort(key=lambda fv: fv[0])
    fs = np.array([f for f, _ in judged])
    ok_cum = np.concatenate([[0], np.cumsum([v for _, v in judged])])
    hi = np.searchsorted(fs, ts, side="right")       # finish_s <= t
    lo = np.searchsorted(fs, ts - window_s, side="left")  # >= t - window_s
    n = hi - lo
    att = np.where(n > 0, (ok_cum[hi] - ok_cum[lo]) / np.maximum(n, 1),
                   np.nan)
    return ts, att


def iter_itls(reqs: Sequence[Request]) -> Iterable[float]:
    """Inter-token latencies: the gaps between consecutive
    ``token_times`` of every request."""
    for r in reqs:
        if r.token_times and len(r.token_times) > 1:
            for a, b in zip(r.token_times, r.token_times[1:]):
                yield b - a


def latency_percentiles(reqs: Sequence[Request]) -> dict:
    """TTFT and ITL p50 / p99 (NaN without samples): the snapshot a
    ``DriverEvent`` carries, and the core of ``summarize``."""
    ttfts = [r.ttft for r in reqs if r.ttft is not None]
    itls = list(iter_itls(reqs))

    def pct(xs, q):
        return float(np.percentile(xs, q)) if xs else float("nan")

    return {"ttft_p50": pct(ttfts, 50), "ttft_p99": pct(ttfts, 99),
            "itl_p50": pct(itls, 50), "itl_p99": pct(itls, 99)}


def throughput_rps(reqs: Sequence[Request], t0: float, t1: float) -> float:
    n = sum(1 for r in reqs if r.finish_s is not None and t0 <= r.finish_s < t1)
    return n / max(t1 - t0, 1e-9)


@dataclasses.dataclass(frozen=True)
class KVPoolStats:
    """Paged-KV pressure snapshot of a serving backend."""
    num_blocks: int
    used_blocks: int
    utilization: float
    preemptions: int


def kv_pool_stats(backend) -> Optional[KVPoolStats]:
    """A backend's ``kv_stats()`` dict as ``KVPoolStats``; None for a
    dense-KV backend."""
    getter = getattr(backend, "kv_stats", None)
    raw = getter() if getter is not None else None
    if not raw:
        return None
    return KVPoolStats(num_blocks=int(raw.get("num_blocks", 0)),
                       used_blocks=int(raw.get("used_blocks", 0)),
                       utilization=float(raw.get("utilization", 0.0)),
                       preemptions=int(raw.get("preemptions", 0)))


def summarize(reqs: Sequence[Request], slo: Optional[SLO] = None,
              backend=None) -> dict:
    tpots = [r.tpot for r in reqs if r.tpot is not None]
    lat = latency_percentiles(reqs)
    out = {
        "n": len(reqs),
        "finished": sum(1 for r in reqs if r.finish_s is not None),
        "ttft_p50": lat["ttft_p50"],
        "ttft_p99": lat["ttft_p99"],
        "tpot_p50": float(np.median(tpots)) if tpots else float("nan"),
        "itl_p50": lat["itl_p50"],
        "itl_p99": lat["itl_p99"],
    }
    if slo:
        out["slo_attainment"] = slo_attainment(reqs, slo)
    if backend is not None:
        kv = kv_pool_stats(backend)
        if kv is not None:
            out["preemptions"] = kv.preemptions
            out["kv_block_utilization"] = kv.utilization
        sc = scaling_overlap_stats(backend)
        if sc is not None:
            out.update(sc)
        rt = getattr(backend, "routing_stats", lambda: None)()
        if rt:
            out["routing_samples"] = int(rt["samples"])
            out["routing_top_expert_share"] = float(rt["top_expert_share"])
            out["routing_expert_cv"] = float(rt["expert_cv"])
    return out


def fleet_summary(per_model_requests: "dict[str, Sequence[Request]]",
                  slo: SLO,
                  device_seconds: "dict[str, float]") -> dict:
    """Per-model and aggregate SLO attainment, and the device-hours each
    model held (``device_seconds``: the integral of its leased devices
    over time).  The aggregate pools every request, so a model with ten
    times the traffic counts ten times."""
    all_reqs: List[Request] = []
    per_model = {}
    for name, reqs in per_model_requests.items():
        all_reqs.extend(reqs)
        per_model[name] = {
            "n": len(reqs),
            "finished": sum(1 for r in reqs if r.finish_s is not None),
            "slo_attainment": slo_attainment(reqs, slo),
            "device_hours": device_seconds.get(name, 0.0) / 3600.0,
        }
    return {
        "aggregate_slo_attainment": slo_attainment(all_reqs, slo),
        "finished": sum(1 for r in all_reqs if r.finish_s is not None),
        "n": len(all_reqs),
        "device_hours": sum(device_seconds.values()) / 3600.0,
        "per_model": per_model,
    }


def scaling_overlap_stats(backend) -> Optional[dict]:
    """A backend's ``scaling_summary()``: the staging mode, the decode
    stall summed over its scale events, the overlap efficiency (the ops'
    summed time over the staging wall; > 1 when copies overlapped) and a
    migrating scale-down's moved blocks and bytes.  None before the first
    scale event."""
    getter = getattr(backend, "scaling_summary", None)
    raw = getter() if getter is not None else None
    if not raw:
        return None
    out = {"staging_mode": raw.get("staging_mode", "serial"),
           "decode_stall_s": float(raw.get("decode_stall_s", 0.0))}
    if raw.get("overlap_efficiency") is not None:
        out["overlap_efficiency"] = float(raw["overlap_efficiency"])
    if raw.get("scaledown_mode") is not None:
        out["scaledown_mode"] = raw["scaledown_mode"]
        out["migrated_blocks"] = int(raw.get("migrated_blocks", 0))
        out["migration_bytes"] = int(raw.get("migration_bytes", 0))
    return out
