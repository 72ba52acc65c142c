#!/usr/bin/env python3
"""Time the pinned-host tier's pieces on one CUDA card: allocating pinned
host rows (one ``torch.empty(..., pin_memory=True)`` per bank row, as a
demote needs them, or one slab per bank for many pages), and copying
expert pages device-to-host into rows already pinned and host-to-device
back.  A page is qwen3-30b-a3b's (three bf16 banks of 2048 x 768).

Run from the repository root on a machine with a card::

    python3 tools/torch_host_tier_rates.py [--pages 229] [--slab 42]

Prints each time beside the card's name and power limit.
"""
import argparse
import subprocess
import time

import torch

ROW = (2048, 768)          # one bank's row of a qwen3-30b-a3b page, bf16
BANKS = 3


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip() \
        .splitlines()[0]


def _seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pages", type=int, default=229)
    ap.add_argument("--slab", type=int, default=42,
                    help="pages a slab holds (42 rows of 3 MiB fill a "
                         "128 MiB block of the caching host allocator)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = _card()
    n = args.pages
    page = BANKS * ROW[0] * ROW[1] * 2
    dev = torch.empty((n * BANKS, *ROW), dtype=torch.bfloat16,
                      device="cuda").normal_()
    keep = []

    def rows():
        keep.extend(torch.empty(ROW, dtype=torch.bfloat16, pin_memory=True)
                    for _ in range(n * BANKS))
    t_rows = _seconds(rows)

    def slabs():
        for _ in range(BANKS):
            for lo in range(0, n, args.slab):
                keep.append(torch.empty((min(args.slab, n - lo), *ROW),
                                        dtype=torch.bfloat16,
                                        pin_memory=True))
    t_slabs = _seconds(slabs)
    host = keep[:n * BANKS]

    def d2h():
        for i, h in enumerate(host):
            h.copy_(dev[i], non_blocking=True)
    d2h()
    t_d2h = _seconds(d2h)

    def h2d():
        for i, h in enumerate(host):
            dev[i].copy_(h, non_blocking=True)
    h2d()
    t_h2d = _seconds(h2d)
    gb = n * page / 1e9
    print(f"{n} pages of {page} bytes ({gb:.3f} GB), {smi}")
    print(f"pinned rows, one allocation a bank row: {t_rows:.4f} s "
          f"({gb / t_rows:.2f} GB/s)")
    print(f"pinned slabs of {args.slab} pages a bank: {t_slabs:.4f} s "
          f"({gb / t_slabs:.2f} GB/s)")
    print(f"D2H into pinned rows: {t_d2h:.4f} s ({gb / t_d2h:.2f} GB/s)")
    print(f"H2D from pinned rows: {t_h2d:.4f} s ({gb / t_h2d:.2f} GB/s)")


if __name__ == "__main__":
    main()
