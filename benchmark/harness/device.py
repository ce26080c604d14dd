"""The run's device: the card check, the card's line, the peak memory,
and the guard against JAX in the process."""

from __future__ import annotations

import shutil
import subprocess
import sys

# published dense peaks of one NVIDIA H100 SXM (data sheet, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mtn_tpu")


class NoDevice(RuntimeError):
    """The run cannot measure: no card, or fewer than the cell asks for."""


def acquire(device: str, chips: int):
    """``torch.device`` of the run; raises :class:`NoDevice` unless
    ``device`` is ``cpu`` or CUDA holds ``chips`` cards."""
    import torch
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} cards, the cell asks "
                       f"for {chips}")
    return torch.device("cuda", 0)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi: not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit,clocks.max.sm,clocks.sm,"
             "power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except subprocess.TimeoutExpired:
        return "nvidia-smi: timed out"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: " + out.stderr.strip()[:200]


def describe(dev, memory_peak_bytes: int) -> dict:
    import torch
    if dev.type == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(memory_peak_bytes)}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run must not hold,
    each compared whole (``mtn_tpu_torch`` is not ``mtn_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
