#!/usr/bin/env python3
"""Scaling while serving under two thread switch intervals of the
interpreter, on one NVIDIA GPU.

The TransferEngine's workers and the serving thread share the interpreter
lock: a worker that waits for its copies' event gives the lock up and then
waits for the serving thread, which issues a tick's eager steps for tens
of milliseconds, to hand it back (at most every ``sys.getswitchinterval()``
seconds, 5 ms by default).  This script runs ``chip_smoke.py``'s
``serve_overlap`` (bf16, against a serial ``serve_scale`` run of the same
interval) and ``serve_down`` (bf16, migrate) at the default interval and
at 0.5 ms, in turns (default, short, short, default), and prints for each
run the staging window, the tick served during it, the MIGRATING wall and
the blocks moved.  Run from the repository root::

    python3 tools/torch_switch_interval.py [--json PATH]
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def run(interval):
    sys.setswitchinterval(interval)
    try:
        serial = cs._serve_scale(None, None, False)
        over = cs._serve_overlap(None, None, serial)
        down = cs._serve_down(None, None, "migrate")
    finally:
        sys.setswitchinterval(0.005)
    out = {"switch_interval_s": interval,
           "serial_stage_s": serial["scale"]["stage_s"],
           "stage_wall_s": over["stage_wall_s"], "op_s": over["op_s"],
           "stall_s": over["stall_s"],
           "tick_ms_before": over["tick_ms_before"],
           "tick_ms_during": over["tick_ms_during"],
           "migrating_s": down["phase_spans_s"].get("scale.MIGRATING"),
           "migrated_blocks": down["migrated_blocks"],
           "down_task_wall_s": down["task_wall_s"]}
    cs.log(f"[switch interval {interval * 1e3:g} ms] {out}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write the readings to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    cs.phase_build()
    res = [run(i) for i in (0.005, 0.0005, 0.0005, 0.005)]
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
