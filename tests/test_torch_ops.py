"""Port ops against the JAX package's: masks, PE table, sdpa, and the two
kernels' plain versions against the Pallas kernels (interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtn_tpu.ops import masks as jmasks
from mtn_tpu.ops import pallas_attention as pa
from mtn_tpu.ops import pallas_ffn as pf
from mtn_tpu.ops.attention import sdpa_xla
from mtn_tpu.ops.positional import sinusoidal_table as jax_table
from mtn_tpu_torch.ops import attention_kernel as ak
from mtn_tpu_torch.ops import ffn_kernel as fk
from mtn_tpu_torch.ops import masks as tmasks
from mtn_tpu_torch.ops.attention import multi_head_attention, sdpa
from mtn_tpu_torch.ops.positional import sinusoidal_table as torch_table
from tests.torch_parity import interpret_pallas, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def interpret(monkeypatch):
    interpret_pallas(monkeypatch)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def test_masks_exact():
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, size=(3, 9)).astype(np.int32)
    seq[1] = 1  # a fully padded row
    lens = np.array([0, 3, 7], np.int32)
    tseq = torch.from_numpy(seq)
    np.testing.assert_array_equal(tmasks.pad_mask(tseq, 1).numpy(),
                                  np.asarray(jmasks.pad_mask(seq, 1)))
    np.testing.assert_array_equal(
        tmasks.length_mask(torch.from_numpy(lens), 7).numpy(),
        np.asarray(jmasks.length_mask(jnp.asarray(lens), 7)))
    pm = jmasks.pad_mask(seq, 1)
    np.testing.assert_array_equal(
        tmasks.attend_first_if_empty(tmasks.pad_mask(tseq, 1)).numpy(),
        np.asarray(jmasks.attend_first_if_empty(pm)))
    np.testing.assert_array_equal(
        tmasks.causal_mask(5, "cpu").numpy(),
        np.asarray(jmasks.causal_mask(5)))
    np.testing.assert_array_equal(tmasks.target_mask(tseq, 1).numpy(),
                                  np.asarray(jmasks.target_mask(seq, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pe_table_exact(dtype):
    t = torch_table(64, 16, getattr(torch, dtype))
    j = jax_table(64, 16, getattr(jnp, dtype))
    np.testing.assert_array_equal(_np(t), _np(j))


def _qkv(rng, B, H, Lq, Lk, D):
    return (rng.standard_normal((B, H, Lq, D)).astype(np.float32),
            rng.standard_normal((B, H, Lk, D)).astype(np.float32),
            rng.standard_normal((B, H, Lk, D)).astype(np.float32))


@pytest.mark.parametrize("mask_kind", ["full", "keys", "none"])
def test_sdpa_matches_xla(mask_kind):
    rng = np.random.default_rng(1)
    B, H, Lq, Lk, D = 2, 2, 6, 9, 8
    q, k, v = _qkv(rng, B, H, Lq, Lk, D)
    mask = {"full": rng.random((B, 1, Lq, Lk)) > 0.3,
            "keys": rng.random((B, 1, 1, Lk)) > 0.3,
            "none": None}[mask_kind]
    got = sdpa(*map(torch.from_numpy, (q, k, v)),
               None if mask is None else torch.from_numpy(mask))
    want = sdpa_xla(q, k, v, mask)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


# the cases of tests/test_pallas.py, plus a fully masked row
@pytest.mark.parametrize("B,H,Lq,Lk,D,mask_kind", [
    (2, 2, 8, 16, 8, "full"),
    (1, 4, 16, 16, 16, "full"),
    (3, 2, 1, 24, 8, "full"),      # single-query (decode-step shape)
    (2, 2, 8, 12, 8, "keys"),      # (B,1,1,Lk) key-padding mask
    (2, 2, 8, 8, 8, "none"),
    (2, 2, 16, 16, 16, "empty_row"),
])
def test_attention_plain_matches_pallas(interpret, B, H, Lq, Lk, D,
                                        mask_kind):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, B, H, Lq, Lk, D)
    if mask_kind == "full":
        mask = rng.random((B, 1, Lq, Lk)) > 0.3
    elif mask_kind == "keys":
        mask = rng.random((B, 1, 1, Lk)) > 0.3
    elif mask_kind == "empty_row":
        mask = rng.random((B, 1, 1, Lk)) > 0.3
        mask[0] = False
    else:
        mask = None
    got = ak.attention_plain(*map(torch.from_numpy, (q, k, v)),
                             None if mask is None else
                             torch.from_numpy(mask))
    want = pa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v),
                              None if mask is None else jnp.asarray(mask))
    assert not np.isnan(_np(got)).any()
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    if mask_kind == "empty_row":  # uniform average of v, not NaN
        np.testing.assert_allclose(_np(got)[0], v[0].mean(axis=1,
                                                          keepdims=True)
                                   .repeat(Lq, axis=1), atol=2e-5)


def _ffn_mats(rng, N, D, F):
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((D, F)).astype(np.float32),
            rng.standard_normal((F,)).astype(np.float32),
            rng.standard_normal((F, D)).astype(np.float32),
            rng.standard_normal((D,)).astype(np.float32))


@pytest.mark.parametrize("N", [8, 256, 300])
def test_ffn_plain_matches_pallas(interpret, N):
    rng = np.random.default_rng(0)
    mats = _ffn_mats(rng, N, 16, 32)
    got = fk.ffn_plain(*map(torch.from_numpy, mats))
    want = pf._fused(*map(jnp.asarray, mats))
    assert got.shape == (N, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)


def test_ffn_3d_input(interpret):
    rng = np.random.default_rng(1)
    x, w1, b1, w2, b2 = _ffn_mats(rng, 12, 16, 32)
    x3 = x.reshape(3, 4, 16)
    got = fk.fused_ffn(*map(torch.from_numpy, (x3, w1, b1, w2, b2)))
    want = pf.fused_ffn(*map(jnp.asarray, (x3, w1, b1, w2, b2)))
    assert got.shape == (3, 4, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)


@pytest.mark.parametrize("q_shape,k_shape,want", [
    ((2, 8, 64, 64), (2, 8, 128, 64), True),
    ((32, 8, 32, 64), (32, 8, 64, 64), True),     # decode precompute
    ((2, 8, 4096, 64), (2, 8, 4096, 64), False),  # longer than 2048
    ((2, 8, 64), (2, 8, 64), False),              # not 4-D
    ((160, 8, 1, 64), (160, 8, 30, 64), False),   # decode step: Lq < 16
    ((2, 8, 15, 64), (2, 8, 15, 64), False),
    ((2, 2, 16, 512), (2, 2, 16, 512), False),    # D > 256
])
def test_attention_gate_matches_tpu_gate(q_shape, k_shape, want):
    assert ak.supports(q_shape, k_shape, torch.float32) is want
    assert pa.supports(q_shape, k_shape, jnp.float32) is want


def test_attention_gate_shared_memory_term():
    """The VMEM term is replaced by the kernel's shared-memory limit: a
    2048-key, D=256 head fits the TPU's VMEM but not 227 KB of shared
    memory."""
    assert pa.supports((1, 1, 16, 256), (1, 1, 2048, 256), jnp.float32)
    assert not ak.supports((1, 1, 16, 256), (1, 1, 2048, 256),
                           torch.float32)
    assert ak.smem_bytes(32, 64, 64, 2) < ak.SMEM_LIMIT


@pytest.mark.parametrize("n,want", [(160, True), (256, True), (257, False),
                                    (1056, False)])
def test_ffn_gate_matches_tpu_gate(n, want):
    assert fk.supports(n, 512, 2048, 2) is want
    assert pf.supports(n, 512, 2048, 2) is want


def test_cpu_tensor_takes_plain_path_and_counts_nothing():
    rng = np.random.default_rng(2)
    q, k, v = map(torch.from_numpy, _qkv(rng, 2, 8, 32, 32, 64))
    mask = torch.from_numpy(rng.random((2, 1, 32)) > 0.2)
    mats = [torch.from_numpy(m) for m in _ffn_mats(rng, 160, 512, 2048)]
    a0, f0 = ak.KERNEL.launches, fk.KERNEL.launches
    got = multi_head_attention(q, k, v, mask[:, None], use_kernel=True)
    torch.testing.assert_close(got, ak.attention_plain(q, k, v,
                                                       mask[:, None]),
                               rtol=0, atol=0)
    torch.testing.assert_close(fk.fused_ffn(*mats), fk.ffn_plain(*mats),
                               rtol=0, atol=0)
    assert (ak.KERNEL.launches, fk.KERNEL.launches) == (a0, f0)
