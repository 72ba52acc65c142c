"""Hardware cost model — the port's own copy of ``repro.core.costmodel``:
turns a scaling plan (``core/scaling_plan.py``) into a projected scale
time, downtime, decode stall and peak memory.

The byte counts (zero-copy, P2P, disk, init) are exact outputs of the
planner.  ``HardwareModel``'s constants are the reference's, kept for
parity: the paper's CloudMatrix384 cluster of Ascend 910C devices,
calibrated once against the paper's Table 1 (deepseek-v2-lite DP3 -> DP4).
They describe that cluster, not an H100: a projection from them is the
paper cluster's time for the same plan, and the ``ClusterDriver`` uses it
only to rank and veto candidate targets.  ``chip_smoke.py`` prints each
projection beside what the card measured for the same scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.scaling_plan import Op, ScalingPlan

#: element sizes of every dtype name the repo's knobs accept
DTYPE_BYTES = {
    "int8": 1, "uint8": 1, "s8": 1, "u8": 1, "float8": 1,
    "bfloat16": 2, "float16": 2, "bf16": 2, "f16": 2,
    "float32": 4, "int32": 4, "f32": 4, "s32": 4,
    "float64": 8, "int64": 8, "f64": 8, "s64": 8,
}


def dtype_bytes(dtype) -> int:
    """Bytes per element of ``dtype`` (a name, or anything numpy's dtype
    constructor accepts); ``None`` means float32."""
    if dtype is None:
        return 4
    name = getattr(dtype, "name", dtype)
    if isinstance(name, str) and name in DTYPE_BYTES:
        return DTYPE_BYTES[name]
    import numpy as np
    return int(np.dtype(dtype).itemsize)


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """The paper cluster's constants (CloudMatrix384, Ascend 910C), as the
    reference calibrates them; none of them is an H100's."""
    disk_bw: float = 0.4e9          # bytes/s per device, disk -> HBM
    p2p_bw: float = 120e9           # bytes/s per link (Unified Bus class)
    p2p_bw_slow: float = 0.8e9      # without HCCL: staged through host
    h2d_bw: float = 25e9            # bytes/s, pinned host -> HBM
    hbm_init_bw: float = 400e9      # memset for fresh KV allocations
    zero_copy_per_tensor: float = 2e-5   # handle open/import, seconds
    warmup_s: float = 2.0           # model warmup of the target instance
    preinit_boot_s: float = 55.0    # cold instance boot (engine + graphs)
    comm_setup_s: float = 3.0       # communication group (re)init
    kv_alloc_s: float = 1.5         # KV allocator setup on a fresh instance
    device_hbm: float = 64e9        # Ascend 910C HBM per device
    # overlapped staging: background transfers share links and HBM with
    # serving, so each op runs ``overlap_contention`` times slower; the
    # warmup hides under the transfer window and decode loses
    # ``overlap_stall_frac`` of the transfer time
    overlap_contention: float = 1.25
    overlap_stall_frac: float = 0.12


DEFAULT_HW = HardwareModel()


@dataclasses.dataclass
class ScalingCost:
    scale_time_s: float
    downtime_s: float
    peak_mem_bytes_per_device: Dict[int, int]
    breakdown: Dict[str, float]
    # modelled decode stall over the staging window (0 with downtime)
    decode_stall_s: float = 0.0
    staging: str = "serial"
    # a migrating scale-down's live KV bytes copied off doomed partitions
    migration_bytes: int = 0


def plan_cost(plan: ScalingPlan,
              *,
              hw: HardwareModel = DEFAULT_HW,
              preinit: bool = True,
              strategy: str = "elastic",
              resident_bytes_per_device: Optional[Dict[int, int]] = None,
              staging: str = "serial",
              kv_migration_bytes: int = 0
              ) -> ScalingCost:
    """Project a plan onto ``hw``.

    ``resident_bytes_per_device``: bytes live on each device before the
    transition (peak-memory accounting).  ``kv_migration_bytes``: a
    migrating scale-down's KV copies, P2P traffic like any other transfer.
    ``staging``: "serial" sums transfer and warmup, and decode stalls for
    the weight transfers; "overlap" slows the transfers by
    ``hw.overlap_contention``, takes the max of them and the warmup, and
    stalls decode for ``hw.overlap_stall_frac`` of them.  The breakdown's
    ``op_s`` is the summed transfer time either way.  ``preinit=False``:
    the target cold-boots first.  ``strategy="cold_restart"``: the old
    instance goes first, so the whole scale is downtime.
    """
    resident = dict(resident_bytes_per_device or {})
    peak = dict(resident)
    live = dict(resident)

    disk_bytes: Dict[int, int] = {}
    p2p_in: Dict[int, int] = {}
    init_bytes: Dict[int, int] = {}
    host_bytes: Dict[int, int] = {}
    n_zero_copy = 0

    for s in plan.steps:
        op = s.op
        if op == Op.FREE:
            continue
        if op == Op.ZERO_COPY:
            n_zero_copy += 1
            continue  # no new bytes: aliases existing memory
        if op == Op.DISK:
            disk_bytes[s.dst] = disk_bytes.get(s.dst, 0) + s.nbytes
        elif op == Op.P2P:
            p2p_in[s.dst] = p2p_in.get(s.dst, 0) + s.nbytes
        elif op == Op.HOST:
            host_bytes[s.dst] = host_bytes.get(s.dst, 0) + s.nbytes
        elif op == Op.INIT:
            init_bytes[s.dst] = init_bytes.get(s.dst, 0) + s.nbytes
        live[s.dst] = live.get(s.dst, 0) + s.nbytes
        peak[s.dst] = max(peak.get(s.dst, 0), live[s.dst])

    devs = set(plan.new.devices) | (set(plan.old.devices) if plan.old else set())
    for d in devs:
        peak.setdefault(d, 0)

    if staging not in ("serial", "overlap"):
        raise ValueError(f"unknown staging {staging!r}")
    t_disk = max((b / hw.disk_bw for b in disk_bytes.values()), default=0.0)
    t_p2p = max((b / hw.p2p_bw for b in p2p_in.values()), default=0.0)
    t_host = max((b / hw.h2d_bw for b in host_bytes.values()), default=0.0)
    t_init = max((b / hw.hbm_init_bw for b in init_bytes.values()), default=0.0)
    t_mig = kv_migration_bytes / hw.p2p_bw
    t_zc = n_zero_copy * hw.zero_copy_per_tensor

    t_transfer = t_disk + t_p2p + t_host + t_init + t_mig
    if staging == "overlap":
        t_ops = t_transfer * hw.overlap_contention
        t = max(t_ops, hw.warmup_s) + t_zc
        decode_stall = t_ops * hw.overlap_stall_frac
        breakdown = {"disk": t_disk, "p2p": t_p2p, "host": t_host,
                     "init": t_init, "kv_migration": t_mig,
                     "zero_copy": t_zc, "warmup": hw.warmup_s,
                     "op_s": t_ops,
                     "overlap_hidden": t_ops + hw.warmup_s
                     - max(t_ops, hw.warmup_s)}
    else:
        t = t_transfer + t_zc + hw.warmup_s
        # serial staging blocks the serve loop for the weight transfers;
        # KV migration copies run on the TransferEngine in either mode, so
        # they stall decode only for the contention share
        decode_stall = (t_disk + t_p2p + t_host + t_init
                        + t_mig * hw.overlap_stall_frac)
        breakdown = {"disk": t_disk, "p2p": t_p2p, "host": t_host,
                     "init": t_init, "kv_migration": t_mig,
                     "zero_copy": t_zc, "warmup": hw.warmup_s,
                     "op_s": t_transfer}
    if not preinit:
        t += hw.preinit_boot_s + hw.comm_setup_s
        breakdown["cold_boot"] = hw.preinit_boot_s + hw.comm_setup_s
    if strategy == "cold_restart":
        # the old instance is gone before the new one is ready: downtime
        breakdown["kv_alloc"] = hw.kv_alloc_s
        t += hw.kv_alloc_s
        downtime = t
        decode_stall = 0.0          # the outage already accounts for it
    else:
        downtime = 0.0
    return ScalingCost(scale_time_s=t, downtime_s=downtime,
                       peak_mem_bytes_per_device=peak, breakdown=breakdown,
                       decode_stall_s=decode_stall, staging=staging,
                       migration_bytes=kv_migration_bytes)


def unpark_cost(plan: ScalingPlan, *, preinit: bool = True,
                staging: str = "overlap") -> ScalingCost:
    """The cost of an unpark plan (``scaling_plan.plan_unpark``): every
    weight shard over the host link at ``DEFAULT_HW.h2d_bw``, the KV
    cache a fresh INIT.  Overlapped, the warmup hides under the transfers
    as in ``plan_cost``; ``preinit=False`` adds the cold boot.  A parked
    model serves nothing until the commit, so ``downtime_s`` is the whole
    scale time (``breakdown["cold_start"]`` too)."""
    for s in plan.steps:
        if s.op not in (Op.HOST, Op.INIT, Op.FREE):
            raise ValueError(f"an unpark plan streams host and init steps "
                             f"only, not {s.op}")
    cost = plan_cost(plan, preinit=preinit, staging=staging)
    cost.downtime_s = cost.scale_time_s
    cost.breakdown["cold_start"] = cost.scale_time_s
    return cost
