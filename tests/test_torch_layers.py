"""Each port layer against its flax counterpart (same params, bridged)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtn_tpu.models import layers as jl
from mtn_tpu_torch.models import layers as tl
from mtn_tpu_torch.weights import from_flax
from tests.torch_parity import interpret_pallas, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _init(module, *args, method=None):
    kw = {"method": method} if method else {}
    return jax.tree.map(np.asarray, module.init(
        jax.random.PRNGKey(0), *args, **kw)["params"])


def _load(module, params):
    module.load_state_dict(from_flax(params), strict=True)
    return module.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_layer_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3 + 1
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jm = jl.RefLayerNorm()
    params = jax.tree.map(lambda a: a + np.float32(0.25), _init(jm, jx))
    tm = _load(tl.RefLayerNorm(16), params)
    got, want = tm(tx), jm.apply({"params": params}, jx)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)
    else:  # within one bf16 rounding of each other
        np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7,
                                   atol=1e-6)
    # a biased std (torch.nn.LayerNorm's law) is well outside that
    biased = torch.nn.functional.layer_norm(tx.float(), (16,), eps=1e-6)
    assert np.abs(_np(biased) * 1.25 + 0.25 - _np(want)).max() > 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scaled_embed_exact(dtype):
    d = 512  # sqrt(512) is 22.625 in bf16
    toks = np.random.default_rng(1).integers(0, 40, (2, 7)).astype(np.int32)
    jm = jl.ScaledEmbed(40, d, dtype=getattr(jnp, dtype))
    params = _init(jm, jnp.asarray(toks))
    tm = _load(tl.ScaledEmbed(40, d, getattr(torch, dtype)), params)
    got = tm(torch.from_numpy(toks).long())
    want = jm.apply({"params": params}, jnp.asarray(toks))
    np.testing.assert_array_equal(_np(got), _np(want))
    if dtype == "bfloat16":
        assert float(tm.mult) == 22.625


def test_pos_encoding():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    jm = jl.PosEncoding(16, 0.0, 64)
    tm = tl.PosEncoding(16, 0.0, 64, torch.float32).eval()
    for offset in (0, 3):
        want = jm.apply({}, jnp.asarray(x), offset=offset)
        np.testing.assert_array_equal(
            _np(tm(torch.from_numpy(x), offset)), _np(want))
    want = jm.apply({}, jnp.asarray(x[:, :1]), 5, method=jl.PosEncoding.at)
    np.testing.assert_array_equal(_np(tm.at(torch.from_numpy(x[:, :1]), 5)),
                                  _np(want))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_multi_head_attention(monkeypatch, use_kernel):
    interpret_pallas(monkeypatch)
    rng = np.random.default_rng(3)
    q_in = rng.standard_normal((2, 16, 16)).astype(np.float32)
    kv_in = rng.standard_normal((2, 9, 16)).astype(np.float32)
    mask = rng.random((2, 1, 9)) > 0.3
    jm = jl.MultiHeadAttention(2, 16, use_pallas=use_kernel)
    params = _init(jm, q_in, kv_in, kv_in, mask)
    tm = _load(tl.MultiHeadAttention(2, 16, torch.float32,
                                     use_kernel=use_kernel), params)
    tq, tkv, tmask = map(torch.from_numpy, (q_in, kv_in, mask))
    want = jm.apply({"params": params}, q_in, kv_in, kv_in, mask)
    np.testing.assert_allclose(_np(tm(tq, tkv, tkv, tmask)), _np(want),
                               atol=2e-5)
    jk, jv = jm.apply({"params": params}, kv_in,
                      method=jl.MultiHeadAttention.project_kv)
    tk, tv = tm.project_kv(tkv)
    np.testing.assert_allclose(_np(tk), _np(jk), atol=1e-5)
    np.testing.assert_allclose(_np(tv), _np(jv), atol=1e-5)
    for got, want in zip(tm.fused_qkv(tq), jm.apply(
            {"params": params}, q_in, method=jl.MultiHeadAttention.fused_qkv)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    want = jm.apply({"params": params}, q_in[:, :1], jk, jv, mask[:, None],
                    method=jl.MultiHeadAttention.attend_with_kv)
    got = tm.attend_with_kv(tq[:, :1], tk, tv, tmask[:, None])
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_feed_forward(monkeypatch, use_kernel):
    interpret_pallas(monkeypatch)
    x = np.random.default_rng(4).standard_normal((3, 5, 16)).astype(
        np.float32)
    jm = jl.FeedForward(16, 128, 0.1, use_pallas=use_kernel)
    params = _init(jm, x)
    tm = _load(tl.FeedForward(16, 128, 0.1, torch.float32,
                              use_kernel=use_kernel), params)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))),
                               _np(jm.apply({"params": params}, x)),
                               atol=2e-4)


def test_param_linear_sublayer_generator():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    jlin = jl.ParamLinear(16, 24)
    params = _init(jlin, x)
    tlin = _load(tl.ParamLinear(16, 24, torch.float32), params)
    np.testing.assert_allclose(_np(tlin(torch.from_numpy(x))),
                               _np(jlin.apply({"params": params}, x)),
                               atol=1e-5)
    jsub = jl.Sublayer(0.0)
    sparams = _init(jsub, x, lambda y: y * 2.0)
    tsub = _load(tl.Sublayer(16, 0.0), sparams)
    np.testing.assert_allclose(
        _np(tsub(torch.from_numpy(x), lambda y: y * 2.0)),
        _np(jsub.apply({"params": sparams}, x, lambda y: y * 2.0)),
        atol=1e-5)
    jgen = jl.Generator(30)
    gparams = _init(jgen, x)
    tgen = _load(tl.Generator(16, 30, torch.float32), gparams)
    np.testing.assert_allclose(_np(tgen(torch.from_numpy(x))),
                               _np(jgen.apply({"params": gparams}, x)),
                               atol=1e-5)
