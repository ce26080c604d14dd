"""The residual add + LayerNorm op (mtn_tpu_torch/ops/norm_kernel.py) and
the decode step built on it, on the CPU (no JAX; the kernel itself runs
only on the card, chip_smoke.py's ``[norm-kernel]``):

- ``mtn_tpu_torch::add_norm`` bitwise equal to the plain composition it
  replaces (``Sublayer``'s ``x + (product + bias)``, then
  ``RefLayerNorm``), with and without ``delta`` and ``bias``;
- ``MTN.decode_step`` bitwise equal, log-probs and KV caches at every
  position, to the chain before the op (kept below as the reference),
  and the beam n-bests equal, on an av-like and a text-like config;
- one op call a sublayer boundary (and one norm-only call) a step, none
  in a training forward or with grad on; the op kept as one node by
  ``torch.export``; its launches in ``kernel_launches()``.
"""

import numpy as np
import pytest
import torch

from mtn_tpu_torch.cli.common import kernel_launches
from mtn_tpu_torch.config import DecodeConfig, ModelConfig
from mtn_tpu_torch.decode.beam import BeamDecoder
from mtn_tpu_torch.models.layers import RefLayerNorm, Sublayer
from mtn_tpu_torch.models.mtn import SourceMasks
from mtn_tpu_torch.ops import norm_kernel as nk
from mtn_tpu_torch.ops.attention import multi_head_attention
from mtn_tpu_torch.ops.masks import length_mask, pad_mask
from mtn_tpu_torch.train.batch import DeviceBatch
from mtn_tpu_torch.weights import init_params, load_model

ADD_NORM = torch.ops.mtn_tpu_torch.add_norm.default
VOCAB = 40


def _randn(rng, *shape, dtype=torch.float32, scale=1.0):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)


def _plain_chain(x, delta, bias, norm):
    """``Sublayer.forward``'s residual around an output ``delta + bias``
    (a ParamLinear's ``product + bias``), then the next ``RefLayerNorm``."""
    if delta is not None:
        out = delta if bias is None else delta + bias
        x = Sublayer(x.shape[-1], 0.0).eval()(x, lambda y: out)
    return x, norm(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 5, 160, 257])
@pytest.mark.parametrize("d", [64, 512])
@pytest.mark.parametrize("parts", ["delta_bias", "delta", "none"])
def test_op_is_the_plain_composition_bitwise(dtype, rows, d, parts):
    rng = np.random.default_rng(rows * d)
    norm = RefLayerNorm(d)
    with torch.no_grad():
        norm.scale.copy_(_randn(rng, d, scale=0.1) + 1)
        norm.bias.copy_(_randn(rng, d, scale=0.02))
    x = _randn(rng, rows, 1, d, dtype=dtype, scale=3.0)
    delta = _randn(rng, rows, 1, d, dtype=dtype) if parts != "none" else None
    bias = _randn(rng, d, dtype=dtype, scale=0.1) \
        if parts == "delta_bias" else None
    with torch.no_grad():
        want = _plain_chain(x, delta, bias, norm)
        got_op = ADD_NORM(x, delta, bias, norm.scale, norm.bias, norm.eps)
        got = nk.add_norm(x, delta, bias, norm.scale, norm.bias, norm.eps)
    for g in (got_op, got):
        assert g[0].dtype == g[1].dtype == dtype
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
    assert got_op[0].data_ptr() != x.data_ptr()  # no output aliases x


def test_norm_parameters_of_the_activation_type():
    rng = np.random.default_rng(3)
    x, delta = (_randn(rng, 7, 1, 128, dtype=torch.bfloat16)
                for _ in range(2))
    scale = _randn(rng, 128, dtype=torch.bfloat16, scale=0.1) + 1
    nbias = _randn(rng, 128, dtype=torch.bfloat16, scale=0.02)
    assert nk.supports(x, delta, None, scale, nbias)
    want = nk.add_norm_plain(x, delta, None, scale, nbias, 1e-6)
    got = ADD_NORM(x, delta, None, scale, nbias, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("d,takes", [(128, True), (512, True), (1024, True),
                                     (4096, True), (64, False), (520, False),
                                     (4224, False)])
def test_kernel_width_term(d, takes):
    assert nk.kernel_takes(d) is takes


def test_gate_and_launch_on_what_the_kernel_cannot_take():
    meta = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt,
                                                     device="meta")
    x, p = meta(4, 512), meta(512, dt=torch.float32)
    assert nk.supports(torch.empty(4, 512), None, None,
                       torch.ones(512), torch.ones(512))
    assert not nk.supports(x, None, None, p, p)           # no kernel there
    assert not nk.supports(torch.empty(4, 512, dtype=torch.float16), None,
                           None, torch.ones(512), torch.ones(512))
    assert not nk.supports(torch.empty(4, 512), None, None,
                           torch.ones(512, dtype=torch.bfloat16),
                           torch.ones(512, dtype=torch.bfloat16))
    assert not nk.supports(torch.empty(4, 512), torch.empty(4, 512),
                           torch.empty(512, dtype=torch.bfloat16),
                           torch.ones(512), torch.ones(512))
    launches = nk.KERNEL.launches
    with pytest.raises(ValueError, match="no kernel"):
        nk.launch(x, meta(4, 512), meta(512), p, p, 1e-6)
    assert nk.KERNEL.launches == launches
    # outside the gate: the plain version, on any device
    got = nk.add_norm(x, meta(4, 512), None, p, p, 1e-6)
    assert got[1].shape == (4, 512) and got[1].device.type == "meta"


def test_op_survives_export_save_and_load(tmp_path):
    class Boundary(torch.nn.Module):
        def forward(self, x, delta, bias, scale, nbias):
            x, y = nk.add_norm(x, delta, bias, scale, nbias, 1e-6)
            return x, nk.add_norm(x, None, None, scale, nbias, 1e-6)[1] + y

    rng = np.random.default_rng(4)
    args = (_randn(rng, 5, 1, 64), _randn(rng, 5, 1, 64), _randn(rng, 64),
            _randn(rng, 64) + 1, _randn(rng, 64))
    with torch.no_grad():
        ep = torch.export.export(Boundary(), args, strict=False)
        path = str(tmp_path / "boundary.pt2")
        torch.export.save(ep, path)
        loaded = torch.export.load(path)
        targets = [n.target for n in loaded.graph.nodes
                   if n.op == "call_function"]
        assert targets.count(ADD_NORM) == 2
        got, want = loaded.module()(*args), Boundary()(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_kernel_launches_has_the_norm_kernel():
    launches = kernel_launches()
    assert set(launches) == {"attention", "ffn", "norm"}
    assert launches["norm"] == nk.KERNEL.launches


# -- the decode step ----------------------------------------------------------
AV = dict(ft_sizes=[12, 8], diff_encoder=True, auto_encoder_ft="query")
TEXT = dict(ft_sizes=[], auto_encoder_ft="caption")


def _cfg(**kw):
    return ModelConfig(**dict(dict(
        vocab_size=VOCAB, nb_blocks=2, d_model=32, d_ff=64, att_h=2,
        dropout=0.1, attn_dropout=0.1, max_len=64), **kw))


def _model(cfg, seed=0):
    """init_params with every tensor perturbed (biases and norms too)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
          for k, v in init_params(cfg, gen).items()}
    return load_model(cfg, sd, "cpu")


def _batch(cfg, rng, B=3):
    tok = lambda L: torch.from_numpy(rng.integers(4, VOCAB, (B, L)))
    tok_pad = lambda L: tok(L).masked_fill(
        torch.from_numpy(rng.random((B, L)) < 0.2), 1)
    T = [7, 4][:cfg.n_streams]
    return DeviceBatch(
        query=tok_pad(6), his=tok_pad(9), cap=tok_pad(5),
        answer_in=tok(2), answer_out=tok(2),
        fts=tuple(_randn(rng, B, t, d) for t, d in zip(T, cfg.ft_sizes)),
        fts_len=tuple(torch.tensor([t, 2, 1][:B]) for t in T),
        valid=torch.ones(B, dtype=torch.bool))


def _state(model, db):
    masks = SourceMasks(query=pad_mask(db.query, 1), his=pad_mask(db.his, 1),
                        cap=pad_mask(db.cap, 1),
                        vid=tuple(length_mask(n, f.shape[1])
                                  for f, n in zip(db.fts, db.fts_len)))
    return model.init_decode_state(db.query, db.his, db.cap, db.fts, masks)


def reference_decode_step(model, state, tokens, pos, self_kv):
    """``MTN.decode_step`` as it was before ``add_norm``: each sublayer
    ``Sublayer.forward`` (a norm, the sublayer with w_o's bias, the
    residual add), the self-attention norm computed for K/V and again for
    q, the decoder's final norm last."""
    cfg, dec = model.cfg, model.decoder
    x = model.pe_tgt.at(model.embed_tgt(tokens[:, None]), pos)
    for layer, cache, (k_cache, v_cache) in zip(dec.layers, state.layers,
                                                self_kv):
        y = layer.sl_self.norm(x)
        if cfg.fused_decode_qkv:
            q_t, k_t, v_t = layer.self_attn.fused_qkv(y)
        else:
            q_t = None
            k_t, v_t = layer.self_attn.project_kv(y)
        k_cache[:, :, pos:pos + 1] = k_t
        v_cache[:, :, pos:pos + 1] = v_t
        valid = (torch.arange(k_cache.shape[2]) <= pos)[None, None, None, :]
        attn = layer.self_attn

        def self_sub(y):
            if q_t is None:
                return attn.attend_with_kv(y, k_cache, v_cache, valid)
            return attn.w_o(attn._merge(multi_head_attention(
                q_t, k_cache, v_cache, valid, dropout_rate=0.0,
                use_kernel=attn.use_kernel)))
        x = layer.sl_self(x, self_sub)
        x = layer.sl_his(x, lambda y: layer.his_attn.attend_with_kv(
            y, *cache.his_kv, state.masks.his[:, None]))
        masks = state.masks
        cap = lambda x: layer.sl_cap(x, lambda y: layer.cap_attn
                                     .attend_with_kv(y, *cache.cap_kv,
                                                     masks.cap[:, None]))
        src = lambda x: layer.sl_src(x, lambda y: layer.src_attn
                                     .attend_with_kv(y, *cache.src_kv,
                                                     masks.query[:, None]))
        x = cap(src(x)) if cfg.auto_encoder_ft in ("caption", "summary") \
            else src(cap(x))
        for i in range(cfg.n_streams):
            x = layer.sl_x_ae[i](x, lambda y, i=i: layer.ae_attn[i]
                                 .attend_with_kv(y, *cache.ae_kv[i],
                                                 state.ae_mask[:, None]))
        x = layer.sl_ff(x, layer.ff)
    return model.generator(dec.norm(x)[:, 0]), self_kv


CONFIGS = {"av": AV, "av_fused_qkv": dict(AV, fused_decode_qkv=True),
           "text": TEXT}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_step_is_the_chain_before_the_op_bitwise(name, dtype,
                                                        monkeypatch):
    cfg = _cfg(dtype=dtype, use_pallas_attention=True, use_pallas_ffn=True,
               **CONFIGS[name])
    model = _model(cfg, seed=1)
    rng = np.random.default_rng(2)
    db = _batch(cfg, rng)
    maxlen, B = 5, db.query.shape[0]
    calls = []
    op = nk.add_norm_op
    monkeypatch.setattr(nk, "add_norm_op",
                        lambda *a: calls.append(1) or op(*a))
    with torch.no_grad():
        state = _state(model, db)
        assert not calls   # the AE chain's precompute: the plain chain
        kv, kv_ref = (model.init_self_kv(B, maxlen) for _ in range(2))
        for pos in range(maxlen):
            tokens = torch.from_numpy(rng.integers(4, VOCAB, B))
            n = len(calls)
            got, kv = model.decode_step(state, tokens, pos, kv)
            # a boundary after each sublayer, and layer 0's input
            assert len(calls) - n == cfg.nb_blocks * (5 + cfg.n_streams) + 1
            want, kv_ref = reference_decode_step(model, state, tokens, pos,
                                                 kv_ref)
            assert torch.equal(got, want)
            for (k, v), (kr, vr) in zip(kv, kv_ref):
                assert torch.equal(k, kr) and torch.equal(v, vr)


@pytest.mark.parametrize("name", ["av", "text"])
def test_beam_nbests_equal_the_chain_before_the_op(name):
    cfg = _cfg(**CONFIGS[name])
    model = _model(cfg, seed=5)
    db = _batch(cfg, np.random.default_rng(6), B=3)
    kw = dict(maxlen=8, beam=3, nbest=3, penalty=1.0)
    dec, ref = BeamDecoder(model, DecodeConfig(**kw)), \
        BeamDecoder(model, DecodeConfig(**kw))
    ref._step = lambda s, tok, pos, kv: reference_decode_step(model, s, tok,
                                                              pos, kv)
    got = dec.beam_results(dec.beam_batch_raw(db), db.valid)
    want = ref.beam_results(ref.beam_batch_raw(db), db.valid)
    assert [(r.tokens, r.scores) for r in got] == \
        [(r.tokens, r.scores) for r in want]
    assert any(len(t) > 1 for r in got for t in r.tokens)


def test_no_op_call_in_training_or_under_grad(monkeypatch):
    """The op runs only where nothing needs its gradient: a training
    forward (and its backward) and a decode step with grad on take the
    plain chain, which autograd differentiates."""
    cfg = _cfg(**AV)
    model = _model(cfg, seed=7)
    db = _batch(cfg, np.random.default_rng(8))
    calls = []
    op = nk.add_norm_op
    monkeypatch.setattr(nk, "add_norm_op",
                        lambda *a: calls.append(1) or op(*a))
    model.train()
    masks = SourceMasks(query=pad_mask(db.query, 1), his=pad_mask(db.his, 1),
                        cap=pad_mask(db.cap, 1),
                        vid=tuple(length_mask(n, f.shape[1])
                                  for f, n in zip(db.fts, db.fts_len)))
    tgt_mask = torch.ones(3, 2, 2, dtype=torch.bool).tril()
    out, _ = model(db.query, db.his, db.cap, db.fts, masks, db.answer_in,
                   tgt_mask)
    out.float().sum().backward()
    model.eval()
    state = _state(model, db)
    logp, _ = model.decode_step(state, db.answer_in[:, 0], 0,
                                model.init_self_kv(3, 4))
    logp.sum().backward()
    assert not calls
    w_o = model.decoder.layers[0].self_attn.w_o
    assert w_o.bias.grad is not None and w_o.bias.grad.abs().sum() > 0


@pytest.mark.parametrize("mode", ["float", "int8", "row"])
def test_unbiased_leaves_the_bias_to_the_caller_in_every_mode(mode,
                                                               monkeypatch):
    import mtn_tpu_torch.models.layers as layers
    from mtn_tpu_torch.parallel.collectives import Axis
    lin = layers.ParamLinear(8, 8, torch.bfloat16)
    with torch.no_grad():
        lin.kernel.normal_()
        lin.bias.normal_()
    if mode == "int8":
        q = torch.randint(-127, 128, (8, 8), dtype=torch.int8)
        lin.load_int8(q, torch.rand(8) / 100)
    if mode == "row":
        # one rank: the row-parallel sum is the identity
        monkeypatch.setattr(layers, "reduce_from_model", lambda y, axis: y)
        lin.set_parallel("row", Axis(1, 0))
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    product, bias = lin.unbiased(x)
    assert bias is lin.bias and torch.equal(product + bias, lin(x))
    # add_norm's bias fold rounds as the layer's own bias add
    scale, nbias = torch.ones(8), torch.zeros(8)
    res = torch.randn(3, 8, dtype=torch.bfloat16)
    got = nk.add_norm(res, product, bias, scale, nbias, 1e-6)
    want = nk.add_norm(res, lin(x), None, scale, nbias, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
