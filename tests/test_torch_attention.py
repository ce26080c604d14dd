"""The attention kernel's wrapper (mtn_tpu_torch/ops/attention_kernel.py)
on the CPU: the bf16 gate against the TPU gate, the shared-memory layout of
csrc/attention.cu against the card's limit, the plain version against the
Pallas kernel (interpret mode) at the ragged shapes the kernel handles,
and the wrapper raising, rather than falling back to the plain version,
for what the kernel does not take. The kernel itself runs only on the card
(chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtn_tpu.ops import pallas_attention as pa
from mtn_tpu_torch.ops import attention_kernel as ak
from mtn_tpu_torch.ops.attention import multi_head_attention
from tests.torch_parity import interpret_pallas, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def interpret(monkeypatch):
    interpret_pallas(monkeypatch)


@pytest.mark.parametrize("Lq,Lk,D", [
    (32, 32, 64),       # AE self-attention (main path)
    (32, 64, 64),       # AE->video attention (main path)
    (16, 2048, 256),    # admitted now: K/V stream through shared memory
    (1024, 1024, 256),  # rejected by the VMEM term
    (1024, 1024, 64),
    (2048, 2048, 16),   # the score block alone exceeds the VMEM term
    (15, 64, 64),       # Lq < 16
    (16, 16, 257),      # D > 256
    (2049, 64, 64),     # L > 2048
    (64, 2049, 64),
    (20, 61, 40),
    (16, 130, 64),
])
def test_bf16_gate_is_the_tpu_gate(Lq, Lk, D):
    q_shape, k_shape = (2, 8, Lq, D), (2, 8, Lk, D)
    want = pa.supports(q_shape, k_shape, jnp.bfloat16)
    assert ak.supports(q_shape, k_shape, torch.bfloat16) is want


def test_f32_gate_keeps_its_shared_memory_term():
    """The shape the bf16 gate now admits stays outside the f32 kernel's
    (it stages the whole head's K and V); a 3-D shape is outside both."""
    assert ak.supports((1, 1, 16, 256), (1, 1, 2048, 256), torch.bfloat16)
    assert not ak.supports((1, 1, 16, 256), (1, 1, 2048, 256),
                           torch.float32)
    assert not ak.supports((1, 1, 64), (1, 1, 64), torch.bfloat16)


@pytest.mark.parametrize("Lq", [16, 20, 32, 48, 64, 100, 1024, 2048])
@pytest.mark.parametrize("D", [16, 40, 64, 128, 200, 256])
def test_bf16_layout_fits_and_does_not_grow_with_lk(Lq, D):
    """Every shape the bf16 gate admits fits in 227 KB; past one 64-key
    chunk the block's shared memory does not depend on Lk."""
    past_one_chunk = set()
    for Lk in (1, 32, 64, 65, 130, 256, 257, 1000, 2048):
        if not ak.supports((1, 1, Lq, D), (1, 1, Lk, D), torch.bfloat16):
            continue
        assert ak.smem_bytes(Lq, Lk, D, 2) <= ak.SMEM_LIMIT
        if Lk > ak.KEY_CHUNK:
            past_one_chunk.add(ak.smem_bytes(Lq, Lk, D, 2))
    assert len(past_one_chunk) <= 1


def test_bf16_layout_counts_tiles_splits_and_ring():
    """One pass (Lk <= 64): Q tiles and one K/V stage. Two passes: Q
    tiles and two stages of 64 keys, whatever the warps: keys are not
    split across warps, so Lq = 16 takes the same ring as Lq = 64."""
    ld = 64 + 8
    assert ak.smem_bytes(32, 64, 64, 2) == 32 * ld * 2 + 2 * 64 * ld * 2
    assert ak.smem_bytes(16, 2048, 64, 2) == (16 * ld * 2
                                              + 2 * 2 * 64 * ld * 2)
    assert ak.smem_bytes(64, 2048, 64, 2) == (64 * ld * 2
                                              + 2 * 2 * 64 * ld * 2)
    ld = 256 + 8
    assert ak.smem_bytes(16, 2048, 256, 2) == (16 * ld * 2
                                               + 2 * 2 * 64 * ld * 2)


def _qkv(rng, B, H, Lq, Lk, D):
    return (rng.standard_normal((B, H, Lq, D)).astype(np.float32),
            rng.standard_normal((B, H, Lk, D)).astype(np.float32),
            rng.standard_normal((B, H, Lk, D)).astype(np.float32))


# the ragged shapes the bf16 kernel handles: Lq not a multiple of 16, Lk
# past one 64-key chunk or not a multiple of it, D not a multiple of 16
@pytest.mark.parametrize("B,H,Lq,Lk,D,mask_kind", [
    (2, 2, 20, 32, 16, "keys"),     # Lq = 20
    (2, 2, 16, 61, 16, "keys"),     # keys past Lk in the chunk
    (1, 2, 16, 130, 16, "keys"),    # past one chunk: two passes
    (2, 2, 16, 32, 40, "full"),     # D = 40
    (2, 2, 16, 61, 16, "empty_row"),
])
def test_plain_matches_pallas_at_ragged_shapes(interpret, B, H, Lq, Lk, D,
                                               mask_kind):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, B, H, Lq, Lk, D)
    if mask_kind == "full":
        mask = rng.random((B, 1, Lq, Lk)) > 0.3
    else:
        mask = rng.random((B, 1, 1, Lk)) > 0.3
        if mask_kind == "empty_row":
            mask[0] = False
    got = ak.attention_plain(*map(torch.from_numpy, (q, k, v)),
                             torch.from_numpy(mask))
    want = pa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(mask))
    got = got.numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
    if mask_kind == "empty_row":  # uniform average of v, not NaN
        np.testing.assert_allclose(
            got[0], v[0].mean(axis=1, keepdims=True).repeat(Lq, axis=1),
            atol=2e-5)


def _meta(Lq=32, Lk=64, D=64, dtype=torch.bfloat16):
    mk = lambda L: torch.empty(2, 8, L, D, dtype=dtype, device="meta")
    return mk(Lq), mk(Lk), mk(Lk)


@pytest.mark.parametrize("case,exc,match", [
    ("meta", ValueError, "device"),
    ("float16", TypeError, "dtypes"),
    ("noncontiguous_q", ValueError, "contiguous"),
    ("k_shape", ValueError, "vs k"),
    ("v_shape", ValueError, "shapes"),
])
def test_attention_raises_instead_of_falling_back(case, exc, match):
    q, k, v = {
        "meta": lambda: _meta(),
        "float16": lambda: _meta(dtype=torch.float16),
        "noncontiguous_q": lambda: (torch.empty(
            2, 32, 8, 64, dtype=torch.bfloat16,
            device="meta").transpose(1, 2),) + _meta()[1:],
        "k_shape": lambda: (_meta()[0], _meta(D=32)[1], _meta(D=32)[2]),
        "v_shape": lambda: _meta()[:2] + (_meta(Lk=32)[2],),
    }[case]()
    launches = ak.KERNEL.launches
    with pytest.raises(exc, match=match):
        ak.attention(q, k, v)
    if case == "meta":  # inside the gate: the dispatch raises too
        assert ak.supports(q.shape, k.shape, q.dtype)
        with pytest.raises(exc, match=match):
            multi_head_attention(q, k, v, use_kernel=True)
    assert ak.KERNEL.launches == launches


def test_cpu_bf16_takes_the_plain_path():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(rng, 2, 8, 20, 130, 40))
    mask = torch.from_numpy(rng.random((2, 1, 1, 130)) > 0.2)
    launches = ak.KERNEL.launches
    got = multi_head_attention(q, k, v, mask, use_kernel=True)
    assert ak.supports(q.shape, k.shape, q.dtype)
    torch.testing.assert_close(got, ak.attention_plain(q, k, v, mask),
                               rtol=0, atol=0)
    assert got.dtype == torch.bfloat16
    assert ak.KERNEL.launches == launches
