"""Device selection for the port's entry points: they run on the card
unless the caller asks for the CPU, and never fall back silently."""
from __future__ import annotations

import torch


def exact_matmuls() -> None:
    """Make cuBLAS keep the reference's rounding: every product accumulates
    in f32 and is rounded once (``models.layers.dot``).  PyTorch lets
    cuBLAS take TF32 inputs and reduce split-K partial sums in bf16/fp16;
    both flags are process-wide, so the port turns them off itself rather
    than relying on its caller."""
    m = torch.backends.cuda.matmul
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_fp16_reduced_precision_reduction = False


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and no card is
    present (the caller passes ``device="cpu"`` to run on the CPU).  On
    CUDA it also sets the matmul precision the port's numerics assume
    (``exact_matmuls``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        exact_matmuls()
    return dev


def logical_devices(all_devices, device="cuda"):
    """The list of ``torch.device``s that logical device ids index: the
    given ``all_devices`` (each resolved), or one entry per card, ``cuda:0
    ... cuda:{n-1}``, when ``device`` names CUDA, or ``[device]`` on the
    CPU.  A CUDA entry without an index means the current card."""
    if all_devices is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            return [dev]
        all_devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = []
    for d in all_devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def torch_dtype(name) -> torch.dtype:
    """A dtype name of the configs ("bfloat16", "float32") as torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
