"""The port's ``batched_ae`` path (the S per-stream AE chains as one
stacked chain) against JAX's ``MTN`` with ``batched_ae`` and against the
port's own sequential chain: the forward pass, decode state and steps,
beam tokens, one train step's gradients, int8 logits, and the FFN
dispatch of a rank batch (f32, CPU)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mtn_tpu.config import DecodeConfig as JDecodeConfig
from mtn_tpu.config import TrainConfig as JTrainConfig
from mtn_tpu.decode.beam import BeamDecoder as JBeamDecoder
from mtn_tpu.models.mtn import MTN as JMTN
from mtn_tpu.train.batch import batch_masks as jax_masks
from mtn_tpu.train.trainer import Trainer as JTrainer
from mtn_tpu.utils import quantize as jq
from mtn_tpu_torch.config import DecodeConfig, TrainConfig
from mtn_tpu_torch.decode.beam import BeamDecoder
from mtn_tpu_torch.models import layers as tl
from mtn_tpu_torch.models.mtn import MTN
from mtn_tpu_torch.train.batch import batch_masks as torch_masks
from mtn_tpu_torch.train.trainer import Trainer
from mtn_tpu_torch.utils import quantize as tq
from mtn_tpu_torch.weights import from_flax
from tests.fixtures import tiny_model_cfg
from tests.test_torch_beam import _assert_margin_aware
from tests.test_torch_quantize import _decode_logps
from tests.torch_parity import (PAD, both_batches, host_fields,
                                interpret_pallas, one_thread, port_cfg,
                                port_model, seeded_params)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 5e-5               # the whole-model tolerance of tests/test_pallas.py
SEQ_ATOL, SEQ_RTOL = 2e-5, 1e-4   # batched vs sequential, tests/test_model.py
STEPS = 4

CASES = {
    "query_diff_encoder": dict(),
    "shared_seed": dict(diff_encoder=False),
    "caption_diff_embed_gen": dict(auto_encoder_ft="caption",
                                   diff_embed=True, diff_gen=True),
    "kernels_on": dict(use_pallas_attention=True, use_pallas_ffn=True,
                       d_ff=128),
}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _batched(cfg):
    return dataclasses.replace(cfg, batched_ae=True)


def _fields(seed=3, B=3):
    """Streams of different video lengths (5 and 9 frames, some rows
    shorter), a padded query and a fully masked caption row; Lq 16 so the
    AE attentions pass the attention kernel's gate."""
    rng = np.random.default_rng(seed)
    f = host_fields(rng, B=B, Lq=16, T=(5, 9),
                    lengths=[[5, 3, 4][:B], [9, 2, 6][:B]])
    f["query"][1, 10:] = PAD
    f["cap"][0, :] = PAD
    return f


def _port_outputs(tm, tdb):
    """Forward outputs, both heads, decode-state leaves and STEPS decode
    steps' log-probs of the port model on one batch."""
    tmask, ttgt = torch_masks(tdb, PAD)
    out = {}
    with torch.no_grad():
        x, ae = tm(tdb.query, tdb.his, tdb.cap, tdb.fts, tmask,
                   tdb.answer_in, ttgt)
        out["x"], out["ae"] = _np(x), [_np(a) for a in ae]
        out["logp"] = _np(tm.generate_logprobs(x))
        out["ae_logp"] = [_np(a) for a in tm.ae_logprobs(ae)]
        state = tm.init_decode_state(tdb.query, tdb.his, tdb.cap, tdb.fts,
                                     tmask)
        leaves = []
        state.map(lambda t: leaves.append(_np(t)) or t)
        out["state"] = leaves
        B = tdb.query.shape[0]
        kv = tm.init_self_kv(B, STEPS + 1, "cpu")
        tokens = torch.full((B,), 2, dtype=torch.long)
        steps = []
        for pos in range(STEPS):
            logp, kv = tm.decode_step(state, tokens, pos, kv)
            steps.append(_np(logp))
            tokens = logp.argmax(-1)
        out["steps"] = steps
    return out


def _assert_outputs_close(got, want, **tol):
    np.testing.assert_allclose(got["x"], want["x"], **tol)
    np.testing.assert_allclose(got["logp"], want["logp"], **tol)
    for key in ("ae", "ae_logp", "state", "steps"):
        assert len(got[key]) == len(want[key]), key
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(a, b, err_msg=f"{key}[{i}]", **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_ae_matches_jax(monkeypatch, case):
    """Forward, AE outputs, both heads, every decode-state leaf and the
    decode steps of the port's batched model against JAX's batched model
    at the whole-model tolerance."""
    if case == "kernels_on":
        interpret_pallas(monkeypatch)
    fields = _fields()
    jdb, tdb = both_batches(fields)
    cfg = _batched(tiny_model_cfg(30, (12, 8), dropout=0.0, **CASES[case]))
    params = seeded_params(cfg)
    tm = port_model(cfg, params)
    assert tm.cfg.batched_ae
    jm, v = JMTN(cfg), {"params": params}
    jmask, jtgt = jax_masks(jdb, PAD)
    jx, jae = jax.jit(lambda p: jm.apply(p, jdb.query, jdb.his, jdb.cap,
                                         jdb.fts, jmask, jdb.answer_in,
                                         jtgt))(v)
    jstate = jax.jit(lambda p: jm.apply(p, jdb.query, jdb.his, jdb.cap,
                                        jdb.fts, jmask,
                                        method=JMTN.init_decode_state))(v)
    got = _port_outputs(tm, tdb)
    want = {"x": _np(jx), "ae": [_np(a) for a in jae],
            "logp": _np(jm.apply(v, jx, method=JMTN.generate_logprobs)),
            "ae_logp": [_np(a) for a in
                        jm.apply(v, jae, method=JMTN.ae_logprobs)],
            "state": [_np(x) for x in jax.tree.leaves(jstate)]}
    # the decode steps fed the port's argmax tokens, as _port_outputs does
    B = fields["query"].shape[0]
    jkv = jm.apply(v, B, STEPS + 1, method=JMTN.init_self_kv)
    jstep = jax.jit(lambda p, s, t, pos, kv: jm.apply(
        p, s, t, pos, kv, method=JMTN.decode_step))
    tokens, steps = np.full((B,), 2, np.int32), []
    for pos in range(STEPS):
        jlogp, jkv = jstep(v, jstate, tokens, pos, jkv)
        steps.append(_np(jlogp))
        tokens = got["steps"][pos].argmax(-1).astype(np.int32)
    want["steps"] = steps
    _assert_outputs_close(got, want, atol=ATOL)


@pytest.mark.parametrize("case", ["query_diff_encoder", "shared_seed"])
def test_batched_ae_matches_the_sequential_chain(case):
    """The same weights through the port's batched and sequential chains:
    equal up to f32 summation order."""
    cfg = tiny_model_cfg(30, (12, 8), dropout=0.0, **CASES[case])
    params = seeded_params(cfg, seed=2)
    _, tdb = both_batches(_fields(seed=4))
    got = _port_outputs(port_model(_batched(cfg), params), tdb)
    want = _port_outputs(port_model(cfg, params), tdb)
    _assert_outputs_close(got, want, atol=SEQ_ATOL, rtol=SEQ_RTOL)


def test_one_stream_keeps_the_sequential_chain(monkeypatch):
    """With one stream there is nothing to stack: the flag leaves the
    sequential chain, as in JAX."""
    cfg = _batched(tiny_model_cfg(30, (12,), dropout=0.0))
    tm = port_model(cfg, seeded_params(cfg))
    monkeypatch.setattr(type(tm.decoder.layers[0]), "_ae_streams_batched",
                        lambda *a: pytest.fail("stacked one stream"))
    rng = np.random.default_rng(0)
    _, tdb = both_batches(host_fields(rng, ft_dims=(12,), T=(5,)))
    _port_outputs(tm, tdb)


def test_batched_beam_tokens_match_jax():
    rng = np.random.default_rng(7)
    fields = host_fields(rng, B=6, vocab=20, T=(5, 9),
                         lengths=[[5, 2, 4, 5, 1, 3], [9, 9, 3, 7, 2, 8]])
    fields["valid"][4] = False
    jdb, tdb = both_batches(fields)
    cfg = _batched(tiny_model_cfg(20, (12, 8), dropout=0.0))
    params = seeded_params(cfg, seed=5, gen_scale=6.0)
    kw = dict(maxlen=8, beam=3, nbest=3)
    jres = JBeamDecoder(cfg, JDecodeConfig(**kw)).beam_batch(params, jdb)
    dec = BeamDecoder(port_model(cfg, params), DecodeConfig(**kw))
    _assert_margin_aware(jres, dec.beam_results(dec.beam_batch_raw(tdb),
                                                tdb.valid))


def test_batched_train_step_matches_jax(monkeypatch):
    """One dropout-0 step with both kernels' flags on (Pallas in
    interpret mode): the loss and every gradient against
    ``jax.value_and_grad`` of JAX's batched model."""
    interpret_pallas(monkeypatch)
    cfg = _batched(tiny_model_cfg(
        30, (12, 8), dropout=0.0, attn_dropout=0.0,
        use_pallas_attention=True, use_pallas_ffn=True, d_ff=256))
    params = seeded_params(cfg, seed=4)
    rng = np.random.default_rng(0)
    fields = host_fields(rng, B=2, Lq=16, Lh=16, Lc=16, La=16, T=(5, 9),
                         lengths=[[5, 3], [2, 9]])
    fields["query"][1, 11:] = PAD
    jdb, tdb = both_batches(fields)
    jt = JTrainer(cfg, JTrainConfig(warmup_steps=10))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt._loss_fn(p, jdb, jax.random.PRNGKey(0), False),
        has_aux=True))(params)
    tr = Trainer(port_cfg(cfg), TrainConfig(warmup_steps=10), "cpu")
    tr.state_from(from_flax(params))
    loss, _, grads = tr.loss_and_grads(tdb, (0, 0))
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL)
    want = from_flax(jax.tree.map(np.asarray, jgrads))
    got = dict(zip(tr.names, grads))
    assert got.keys() == want.keys()
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=ATOL,
                                   err_msg=n)


def test_batched_dropout_forward_runs_and_draws():
    """In training mode the stacked chain draws dropout: two draws differ,
    a reseeded draw repeats, and eval mode is deterministic."""
    cfg = _batched(tiny_model_cfg(30, (12, 8), dropout=0.3,
                                  attn_dropout=0.3))
    tm = port_model(cfg, seeded_params(cfg))
    _, tdb = both_batches(_fields())
    tmask, ttgt = torch_masks(tdb, PAD)
    run = lambda: tm(tdb.query, tdb.his, tdb.cap, tdb.fts, tmask,
                     tdb.answer_in, ttgt)[1][0]
    tm.train()
    torch.manual_seed(0)
    a, b = run(), run()
    torch.manual_seed(0)
    assert torch.isfinite(a).all() and not torch.equal(a, b)
    assert torch.equal(a, run())
    tm.eval()
    assert torch.equal(run(), run())


@pytest.mark.parametrize("mode", ["int8", "int8-fp-head"])
def test_batched_int8_logits_match_jax(monkeypatch, mode):
    """The int8 stacked linears (scales stacked beside the kernels)
    against JAX's quantized batched model."""
    interpret_pallas(monkeypatch)
    cfg = _batched(tiny_model_cfg(30, (12, 8), dropout=0.0))
    params = seeded_params(cfg, seed=1)
    skip = mode == "int8-fp-head"
    qp = jq.quantize_params(params, skip_generator=skip)
    tm = port_model(cfg, params)
    tq.quantize_model(tm, from_flax(params), skip_generator=skip)
    assert tm.decoder.layers[0].ae_ff[1].w_1.is_int8
    for pos, (got, want) in enumerate(_decode_logps(tm, cfg, qp,
                                                    _fields(seed=2))):
        np.testing.assert_allclose(got, want, atol=ATOL,
                                   err_msg=f"{mode} pos={pos}")


def test_batched_rank_never_runs_the_ae_ffn_through_the_kernel(monkeypatch):
    """A rank batch with the FFN kernel's flag on: under ``batched_ae``
    no AE FFN module runs (the stacked chain's FFN is plain, as JAX's
    einsum), while the decoder FFN still reaches the kernel's dispatch;
    the sequential chain sends every AE FFN there. The scores equal JAX's
    batched model's."""
    cfg = tiny_model_cfg(20, (12, 8), dropout=0.0, use_pallas_ffn=True,
                         d_ff=128)
    params = seeded_params(cfg, seed=8, gen_scale=3.0)
    fields = host_fields(np.random.default_rng(13), B=3, vocab=20,
                         T=(5, 9), lengths=[[5, 2, 4], [9, 3, 6]])
    jdb, tdb = both_batches(fields)
    cands = [[[5, 9, 4], [7], [11, 12, 13]], [[8, 8], [10, 4, 6]],
             [[19], [4, 5, 6, 7]]]
    called, dispatched = [], [0]
    forward = tl.FeedForward.forward
    fused = tl.fused_ffn

    def record(self, x):
        called.append(self)
        return forward(self, x)

    def count(*args):
        dispatched[0] += 1
        return fused(*args)
    monkeypatch.setattr(tl.FeedForward, "forward", record)
    monkeypatch.setattr(tl, "fused_ffn", count)
    seen = {}
    for batched in (False, True):
        c = _batched(cfg) if batched else cfg
        tm = port_model(c, params)
        ae_ffs = {id(m) for layer in tm.decoder.layers for m in layer.ae_ff}
        called.clear()
        dispatched[0] = 0
        got = BeamDecoder(tm, DecodeConfig()).rank_batch(tdb, cands)
        seen[batched] = (sum(id(m) in ae_ffs for m in called),
                         dispatched[0])
        if batched:
            want = JBeamDecoder(c, JDecodeConfig()).rank_batch(
                params, jdb, cands)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    ae_seq, ffn_seq = seen[False]
    ae_b, ffn_b = seen[True]
    assert ae_seq > 0 and ae_b == 0
    assert ffn_b == ffn_seq - ae_seq > 0
