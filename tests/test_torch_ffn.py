"""The FFN kernel's wrapper (mtn_tpu_torch/ops/ffn_kernel.py) on the CPU:
the shared-memory layout of csrc/ffn.cu against the card's limit, and the
wrapper raising, rather than falling back to the plain version, for what
the kernel does not take. The kernel itself runs only on the card
(chip_smoke.py)."""

import pytest
import torch

from mtn_tpu_torch.ops import ffn_kernel as fk

D, F = 512, 2048


def _meta(N, d=D, f=F, dtype=torch.bfloat16):
    """FFN operands on the meta device: shapes and types, no data."""
    mk = lambda *s: torch.empty(*s, dtype=dtype, device="meta")
    return mk(N, d), mk(d, f), mk(f), mk(f, d), mk(d)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [1, 16, 160, 161, 256])
def test_flagship_layout_fits_shared_memory(n, itemsize):
    assert fk.smem_bytes(D, itemsize) <= fk.SMEM_LIMIT
    assert fk.supports(n, D, F, itemsize)


def test_layout_counts_the_bf16_ring():
    """bf16 (32-row tiles): x tile, h, f32 partial y, b2, three ~33 KB
    weight stages and their six mbarriers. f32 (16-row tiles): x, h and
    the partial."""
    assert fk.smem_bytes(D, 2) == (32 * 520 * 2 + 32 * 264 * 2
                                   + 32 * 520 * 4 + 512 * 2
                                   + 3 * 64 * 264 * 2 + 6 * 8)
    assert fk.smem_bytes(D, 4) == 16 * 512 * 4 + 16 * 256 * 4 + 16 * 520 * 4


@pytest.mark.parametrize("d_model,d_ff,want", [
    (512, 2048, True),
    (512, 2000, False),      # F not a multiple of the 256-wide slice
    (520, 2048, False),      # D % 16
    (4096, 2048, False),     # x tile and partial exceed shared memory
    (256, 256, True),        # one slice: a cluster of one block
    (256, 768, True),        # three slices over a cluster of two
    (768, 2048, False),      # bf16 32-row tiles exceed shared memory
])
def test_gate_shape_terms(d_model, d_ff, want):
    assert fk.supports(160, d_model, d_ff, 2) is want


@pytest.mark.parametrize("case,exc,match", [
    ("meta", ValueError, "device"),
    ("float16", TypeError, "dtype"),
    ("d_ff", ValueError, "F %"),
    ("d_model", ValueError, "D % 16"),
    ("rows", ValueError, "N > 0"),
    ("w2_shape", ValueError, "shapes"),
])
def test_ffn_raises_instead_of_falling_back(case, exc, match):
    args = {
        "meta": lambda: _meta(160),
        "float16": lambda: _meta(160, dtype=torch.float16),
        "d_ff": lambda: _meta(160, f=2000),
        "d_model": lambda: _meta(160, d=24),
        "rows": lambda: _meta(0),
        "w2_shape": lambda: _meta(160)[:3] + (
            torch.empty(D, F, dtype=torch.bfloat16, device="meta"),
            torch.empty(D, dtype=torch.bfloat16, device="meta")),
    }[case]()
    launches = fk.KERNEL.launches
    with pytest.raises(exc, match=match):
        fk.ffn(*args)
    if case == "meta":  # inside the gate: the dispatch raises too
        with pytest.raises(exc, match=match):
            fk.fused_ffn(*args)
    assert fk.KERNEL.launches == launches
