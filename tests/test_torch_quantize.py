"""The port's weight-only int8 decode path and int8 feature transfer
against the JAX package's (``mtn_tpu/utils/quantize.py``,
``mtn_tpu/train/batch.py``): the same quantized bits, the same module
rules, the same logits (f32, CPU)."""

import jax
import numpy as np
import pytest
import torch

from mtn_tpu.config import DecodeConfig as JDecodeConfig
from mtn_tpu.decode.beam import BeamDecoder as JBeamDecoder
from mtn_tpu.models.mtn import MTN as JMTN
from mtn_tpu.train.batch import _int8_transfer
from mtn_tpu.train.batch import host_quant_int8 as jax_host_quant
from mtn_tpu.utils import quantize as jq
from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.data.batching import HostBatch
from mtn_tpu_torch.decode.beam import BeamDecoder
from mtn_tpu_torch.models import layers as tl
from mtn_tpu_torch.ops import attention_kernel
from mtn_tpu_torch.train.batch import device_batch, host_quant_int8
from mtn_tpu_torch.utils import quantize as tq
from mtn_tpu_torch.weights import from_flax
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import (SOS, both_batches, host_fields,
                                interpret_pallas, one_thread, port_model,
                                seeded_params)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 5e-5   # the whole-model tolerance of tests/test_pallas.py
STEPS = 3
MODES = {"int8": {}, "int8-fp-head": {"skip_generator": True},
         "int8-vid": {"include_vid_encoder": True}}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _jax_int8(qp):
    """{dotted key: array} of the int8 kernels and of the scales of a
    JAX QuantizedParams."""
    def flat(tree, suffix=""):
        return {".".join(str(p.key) for p in path) + suffix: np.asarray(x)
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    kernels = {k: v for k, v in flat(qp.params).items() if v.dtype == np.int8}
    return kernels, flat(qp.qscales)


@pytest.mark.parametrize("shape,bits", [((64, 48), 8), ((16, 3000), 8),
                                        ((33, 7), 4)])
def test_quantize_kernel_equals_jax_bitwise(shape, bits):
    rng = np.random.default_rng(sum(shape))
    k = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    k[:, 0] = 0.0  # an all-zero column takes the 1e-12 scale floor
    q, scale = tq.quantize_kernel(k, bits)
    jq_, jscale = jq.quantize_kernel(k, bits)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    assert np.array_equal(q, jq_) and np.array_equal(scale, jscale)
    assert np.array_equal(tq.dequantize_kernel(q, scale),
                          jq.dequantize_kernel(jq_, jscale))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantize_params_quantizes_the_jax_keys(mode):
    cfg = tiny_model_cfg(30, (12, 8), dropout=0.0, diff_gen=True)
    params = seeded_params(cfg, seed=5)
    kernels, scales = _jax_int8(jq.quantize_params(params, **MODES[mode]))
    sd = from_flax(params)
    qsd = tq.quantize_params(sd, **MODES[mode])
    got_k = {k: v for k, v in qsd.items() if v.dtype == torch.int8}
    got_s = {k[:-len("_scale")]: v for k, v in qsd.items()
             if k.endswith(".kernel_scale")}
    assert set(got_k) == set(kernels) == set(got_s) \
        == {k.replace(".kernel_scale", ".kernel") for k in scales}
    for key in kernels:
        assert np.array_equal(got_k[key].numpy(), kernels[key])
        assert np.array_equal(got_s[key].numpy(), scales[key + "_scale"])
    assert any(k.startswith("generator.") for k in kernels) == \
        (mode != "int8-fp-head")
    assert any(k.startswith("vid_encoder") for k in kernels) == \
        (mode == "int8-vid")
    # everything else is untouched; the accounting is JAX's
    assert all(torch.equal(qsd[k], v) for k, v in sd.items()
               if k not in kernels)
    want = jq.quantized_size_bytes(jq.quantize_params(params,
                                                      **MODES[mode]))
    got = tq.quantized_size_bytes(qsd)
    assert {k: got[k] for k in want} == want
    assert got["scales"] == sum(4 * v.size for v in scales.values())


def test_quantize_params_needs_a_kernel():
    with pytest.raises(ValueError, match="no quantizable kernels"):
        tq.quantize_params({"embed.lut.embedding": torch.zeros(3, 2)})


def _decode_logps(tm, jcfg, jparams, fields):
    """Decode state and STEPS decode steps of the port model ``tm`` and of
    JAX on ``jparams`` (plain or QuantizedParams): per-step log-probs."""
    jdb, tdb = both_batches(fields)
    jdec = JBeamDecoder(jcfg, JDecodeConfig(maxlen=STEPS + 1))
    jstate = jdec._decode_state(jparams, jdb)
    tdec = BeamDecoder(tm, DecodeConfig(maxlen=STEPS + 1))
    B = fields["query"].shape[0]
    jkv = JMTN(jcfg).init_self_kv(B, STEPS + 1)
    tkv = tm.init_self_kv(B, STEPS + 1, "cpu")
    tokens = np.full((B,), SOS, np.int32)
    out = []
    with torch.inference_mode():
        tstate = tdec._decode_state(tdb)
        for pos in range(STEPS):
            jlogp, jkv = jdec._step(jparams, jstate, tokens, pos, jkv)
            tlogp, tkv = tm.decode_step(
                tstate, torch.from_numpy(tokens).long(), pos, tkv)
            out.append((_np(tlogp), np.asarray(jlogp, np.float32)))
            tokens = np.argmax(np.asarray(jlogp), axis=-1).astype(np.int32)
    return out


@pytest.mark.parametrize("case", ["int8", "int8-fp-head", "fused_qkv",
                                  "kernels_on"])
def test_quantized_logits_match_jax(monkeypatch, case):
    """The quantized port model against JAX's quantized model: decode
    log-probs within the whole-model tolerance, through every branch of
    the int8 read path (fused q/k/v; the kernels' flags on, where the FFN
    kernel is skipped and attention still runs)."""
    interpret_pallas(monkeypatch)
    over = {"fused_qkv": dict(fused_decode_qkv=True),
            "kernels_on": dict(use_pallas_attention=True,
                               use_pallas_ffn=True, d_ff=128)}
    cfg = tiny_model_cfg(30, (12, 8), dropout=0.0, **over.get(case, {}))
    params = seeded_params(cfg, seed=1)
    skip = case == "int8-fp-head"
    qp = jq.quantize_params(params, skip_generator=skip)
    tm = port_model(cfg, params)
    tq.quantize_model(tm, from_flax(params), skip_generator=skip)
    assert tm.generator.proj.is_int8 != skip
    fields = host_fields(np.random.default_rng(2), B=3, Lq=16)
    for pos, (got, want) in enumerate(_decode_logps(tm, cfg, qp, fields)):
        np.testing.assert_allclose(got, want, atol=ATOL,
                                   err_msg=f"{case} pos={pos}")


def test_quantized_state_dict_carries_int8_buffers():
    cfg = tiny_model_cfg(30, (12, 8), dropout=0.0)
    params = seeded_params(cfg, seed=1)
    tm = tq.quantize_model(port_model(cfg, params), from_flax(params))
    sd = tm.state_dict()
    w_q = "decoder.layer_0.self_attn.w_q"
    assert sd[w_q + ".kernel"].dtype == torch.int8
    assert sd[w_q + ".kernel_scale"].dtype == torch.float32
    assert not any(p.dtype == torch.int8 for p in tm.parameters())
    assert tm.vid_encoder_0.proj.kernel.dtype == torch.float32
    # a quantized model's state_dict loads into a quantized model
    again = tq.quantize_model(port_model(cfg, params), from_flax(params))
    again.load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="load_int8"):
        tm.decoder.layer_0.ff.w_1.load_int8(
            torch.zeros(3, 3, dtype=torch.int8), torch.ones(3))


def test_fused_qkv_under_int8_equals_unfused():
    """The three int8 projections as one (D, 3D) product with their scales
    concatenated: the unfused products column for column."""
    cfg = tiny_model_cfg(30, (12, 8), dropout=0.0)
    params = seeded_params(cfg, seed=4)
    tm = tq.quantize_model(port_model(cfg, params), from_flax(params))
    attn = tm.decoder.layer_0.self_attn
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 1, 16)).astype(np.float32))
    with torch.inference_mode():
        fused = attn.fused_qkv(x)
        unfused = [attn._split(m(x)) for m in (attn.w_q, attn.w_k, attn.w_v)]
    for a, b in zip(fused, unfused):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def test_int8_linear_scales_after_the_product():
    """(x @ q) * scale + b in the compute dtype, JAX's order: in bf16 the
    product with q is exact per term, and the scale comes after it."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((32, 24)).astype(np.float32)
    q, scale = tq.quantize_kernel(k)
    lin = tl.ParamLinear(32, 24, torch.bfloat16)
    with torch.no_grad():
        lin.bias.copy_(torch.from_numpy(rng.standard_normal(24)))
    lin.load_int8(torch.from_numpy(q), torch.from_numpy(scale))
    x = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))
    want = (x.bfloat16() @ torch.from_numpy(q).bfloat16()) \
        * torch.from_numpy(scale).bfloat16() + lin.bias
    assert torch.equal(lin(x), want)


def test_int8_batch_equals_jax_bitwise():
    """int8 feature transfer: the same host quantization as JAX's
    ``host_quant_int8``, and the batch on the device is JAX's
    ``_int8_transfer`` bit for bit (f32 dequantization)."""
    fields = host_fields(np.random.default_rng(6), B=3)
    fields["fts"][0][1, 2:] = 0.0  # zero frames take the scale floor
    db = device_batch(HostBatch(**fields), "cpu", "int8")
    for f, got in zip(fields["fts"], db.fts):
        q, scale = host_quant_int8(f)
        jq_, jscale = jax_host_quant(f)
        assert np.array_equal(q, jq_) and np.array_equal(scale, jscale)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(_int8_transfer(f)))
    # tokens and lengths travel as before
    plain = device_batch(HostBatch(**fields), "cpu")
    assert torch.equal(db.query, plain.query)
    assert all(torch.equal(a, b) for a, b in zip(db.fts_len, plain.fts_len))


def test_under_int8_the_ffn_wrapper_is_skipped(monkeypatch):
    """With both kernel flags on, an int8 model never reaches the FFN
    wrapper and still reaches the attention wrapper; the float model
    reaches both."""
    calls = {"attention": 0, "ffn": 0}

    def counting(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper
    monkeypatch.setattr(attention_kernel, "attention",
                        counting("attention", attention_kernel.attention))
    monkeypatch.setattr(tl, "fused_ffn", counting("ffn", tl.fused_ffn))
    cfg = tiny_model_cfg(30, (12, 8), dropout=0.0, d_ff=128,
                         use_pallas_attention=True, use_pallas_ffn=True)
    params = seeded_params(cfg, seed=1)
    _, tdb = both_batches(host_fields(np.random.default_rng(2), Lq=16))
    seen = {}
    for quant in (False, True):
        tm = port_model(cfg, params)
        if quant:
            tq.quantize_model(tm, from_flax(params))
        calls.update(attention=0, ffn=0)
        BeamDecoder(tm, DecodeConfig(maxlen=4, beam=2, nbest=2)
                    ).beam_batch(tdb)
        seen[quant] = dict(calls)
    assert seen[False]["attention"] > 0 and seen[False]["ffn"] > 0
    assert seen[True]["attention"] > 0 and seen[True]["ffn"] == 0
