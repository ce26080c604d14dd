"""The kernels as ``torch.library`` ops and the decode step at a tensor
position, on the CPU (no JAX; a small port model with seeded weights):

- ``mtn_tpu_torch::attention`` and ``::ffn`` bitwise equal to their plain
  versions, their fake implementations' shapes and dtypes, and a function
  that calls each surviving ``torch.export`` → ``save`` → ``load`` with
  the op still in its graph;
- an exported prefix program holds exactly as many attention nodes as
  the live gate admits at its shapes, and the step program as many FFN
  nodes as the live step calls (d_ff 256: inside the FFN gate) and as
  many ``add_norm`` nodes (one a sublayer boundary and one for layer 0's
  input; none in the prefix);
- ``decode_step`` at an ``int`` and at a 0-d tensor position, bitwise
  equal at every position (logits and caches).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mtn_tpu_torch.config import DataConfig, DecodeConfig, ModelConfig
from mtn_tpu_torch.ops import attention_kernel as ak
from mtn_tpu_torch.ops import ffn_kernel as fk
from mtn_tpu_torch.ops import norm_kernel as nk
from mtn_tpu_torch.serve import Request, ServingSession, encode_requests
from mtn_tpu_torch.utils.aot import AotSession, export_decode
from mtn_tpu_torch.weights import (init_params, load_model, save_checkpoint,
                                   save_conf)
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATTENTION = torch.ops.mtn_tpu_torch.attention.default
FFN = torch.ops.mtn_tpu_torch.ffn.default
ADD_NORM = torch.ops.mtn_tpu_torch.add_norm.default
KERNELS = {"use_pallas_attention": True, "use_pallas_ffn": True}


def _cfg(**kw):
    return ModelConfig(**dict(dict(
        vocab_size=40, nb_blocks=2, d_model=16, d_ff=256, att_h=2,
        dropout=0.0, attn_dropout=0.0, ft_sizes=[12, 8], diff_encoder=True,
        auto_encoder_ft="query", max_len=64), **kw))


def _weights(cfg, seed=0):
    """init_params with every tensor perturbed (biases and norms too)."""
    gen = torch.Generator().manual_seed(seed)
    return {k: v + 0.1 * torch.randn(v.shape, generator=gen)
            for k, v in init_params(cfg, gen).items()}


def _qkv(rng, B, H, Lq, Lk, D, dtype):
    mk = lambda L: torch.from_numpy(
        rng.standard_normal((B, H, L, D)).astype(np.float32)).to(dtype)
    return mk(Lq), mk(Lk), mk(Lk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_are_the_plain_versions_bitwise(dtype):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 2, 16, 20, 8, dtype)
    full = torch.from_numpy(rng.random((2, 16, 20)) > 0.3)
    keys = torch.from_numpy(rng.random((2, 1, 20)) > 0.3)
    for mask in (None, full, keys, keys.expand(2, 16, 20), keys[:, None]):
        got = ak.attention(q, k, v, mask)
        assert torch.equal(got, ak.attention_plain(q, k, v, mask))
        assert torch.equal(ATTENTION(q, k, v, mask), got)
    x = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((16, 256), (256,), (256, 16), (16,))]
    x, w = x.to(dtype), [t.to(dtype) for t in w]
    assert torch.equal(fk.ffn(x, *w), fk.ffn_plain(x, *w))
    assert torch.equal(FFN(x, *w), fk.ffn_plain(x, *w))
    with FakeTensorMode() as mode:
        fq, fkk, fv = (mode.from_tensor(t) for t in (q, k, v))
        out = ATTENTION(fq, fkk, fv, mode.from_tensor(keys))
        assert out.shape == q.shape and out.dtype == dtype
        fx = mode.from_tensor(x)
        out = FFN(fx, *(mode.from_tensor(t) for t in w))
        assert out.shape == x.shape and out.dtype == dtype


def test_ops_survive_export_save_and_load(tmp_path):
    class Both(torch.nn.Module):
        def forward(self, q, k, v, mask, x, w1, b1, w2, b2):
            y = ak.attention(q, k, v, mask[:, None].expand(2, 16, 20))
            return y.sum() + fk.ffn(x, w1, b1, w2, b2)

    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 2, 16, 20, 8, torch.float32)
    args = (q, k, v, torch.from_numpy(rng.random((2, 20)) > 0.3),
            torch.randn(5, 16), torch.randn(16, 256), torch.randn(256),
            torch.randn(256, 16), torch.randn(16))
    ep = torch.export.export(Both(), args, strict=False)
    path = str(tmp_path / "both.pt2")
    torch.export.save(ep, path)
    loaded = torch.export.load(path)
    targets = [n.target for n in loaded.graph.nodes
               if n.op == "call_function"]
    assert targets.count(ATTENTION) == 1 and targets.count(FFN) == 1
    assert torch.equal(loaded.module()(*args), Both()(*args))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A port checkpoint of the small config, a beam artifact of it (rows
    2, query 16: the AE attentions inside the gate) and the live
    session."""
    root = tmp_path_factory.mktemp("aot_ops")
    cfg = _cfg()
    vocab = {"<unk>": 0, "<blank>": 1, "<sos>": 2, "<eos>": 3}
    vocab.update({f"w{i}": i + 4 for i in range(cfg.vocab_size - 4)})
    prefix = str(root / "mtn")
    save_conf(prefix, vocab, model=cfg, data=DataConfig(
        fea_type=["a", "b"], include_caption="caption,summary",
        separate_caption=True, length_bucket=8, feature_bucket=4))
    save_checkpoint(prefix, 1, _weights(cfg))
    dcfg = DecodeConfig(maxlen=5, beam=2, nbest=2, turn_batch=2)
    art = str(root / "art")
    export_decode(prefix + "_best", art, batch=2, query_len=16, his_len=16,
                  cap_len=8, frames=[8, 8], decode_cfg=dcfg, device="cpu",
                  model_overrides=KERNELS, stream=False)
    live = ServingSession.from_checkpoint(prefix + "_best", dcfg,
                                          device="cpu",
                                          model_overrides=KERNELS)
    return art, live


def _count_calls(monkeypatch, module, name):
    calls = []
    op = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(1) or op(*a))
    return calls


def test_programs_hold_one_op_node_per_live_call(small, monkeypatch):
    art, live = small
    session = AotSession(art, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(question="w1 w2 w3 w4 w5", caption="w6",
                    features={"a": rng.standard_normal((6, 12)),
                              "b": rng.standard_normal((3, 8))}),
            Request(question="w7", history=[("w8", "w9 w10")])]
    got = [r.nbest for r in session.respond_batch(reqs)]
    hb = encode_requests(reqs, live.model_cfg, live.data_cfg, live.vocab,
                         pad_rows_to=2)
    m = session.meta
    fit = [session._fit_features(f, n, T)
           for f, n, T in zip(hb.fts, hb.fts_len, m["frames"])]
    hb = dataclasses.replace(
        hb, query=session._fit_tokens(hb.query, 16, "query"),
        his=session._fit_tokens(hb.his, 16, "his"),
        cap=session._fit_tokens(hb.cap, 8, "cap"),
        fts=[f for f, _ in fit], fts_len=[n for _, n in fit])
    db = live.to_device(hb)
    assert got == [r.texts(live.vlist) for r in live.decoder.beam_batch(db)]

    attn = _count_calls(monkeypatch, ak, "attention_op")
    ffn = _count_calls(monkeypatch, fk, "ffn_op")
    norm = _count_calls(monkeypatch, nk, "add_norm_op")
    with torch.no_grad():
        state = live.decoder._decode_state(db)      # the prefix program
    n_attn, n_ffn = len(attn), len(ffn)
    assert n_attn == 4 * 2   # AE self and AE->video, 2 streams, 2 layers
    assert not norm
    from mtn_tpu_torch.decode.steps import beam_init, beam_step
    dcfg = live.decode_cfg
    with torch.no_grad():
        beam_step(live.decoder._stepper(state.map(
            lambda t: t.repeat_interleave(dcfg.beam, dim=0))),
            torch.tensor(0), *beam_init(2, dcfg, "cpu"),
            live.model.init_self_kv(2 * dcfg.beam, dcfg.maxlen), dcfg)
    assert len(attn) == n_attn   # Lq 1: outside the attention gate

    def nodes(name):
        graph = session._program(name).graph
        targets = [n.target for n in graph.nodes if n.op == "call_function"]
        return (targets.count(ATTENTION), targets.count(FFN),
                targets.count(ADD_NORM))
    assert nodes("decode_b2_prefix.pt2") == (n_attn, n_ffn, 0)
    assert nodes("decode_b2_step.pt2") == (0, len(ffn) - n_ffn, len(norm))
    assert len(ffn) - n_ffn == 2  # the decoder FFN of each layer
    assert len(norm) == 2 * 7 + 1  # 7 sublayers a layer, and layer 0's input


@pytest.mark.parametrize("fused", [False, True])
def test_decode_step_at_int_and_tensor_positions_is_bitwise(fused):
    cfg = _cfg(fused_decode_qkv=fused, **KERNELS)
    model = load_model(cfg, _weights(cfg, seed=3), "cpu")
    rng = np.random.default_rng(4)
    B, maxlen = 3, 6
    tok = lambda L: torch.from_numpy(rng.integers(4, 40, (B, L)))
    query, his, cap = tok(16), tok(9), tok(5)
    fts = [torch.from_numpy(rng.standard_normal((B, T, d)).astype(
        np.float32)) for T, d in ((7, 12), (4, 8))]
    from mtn_tpu_torch.models.mtn import SourceMasks
    from mtn_tpu_torch.ops.masks import length_mask, pad_mask
    masks = SourceMasks(query=pad_mask(query, 1), his=pad_mask(his, 1),
                        cap=pad_mask(cap, 1),
                        vid=tuple(length_mask(torch.tensor([T, 2, 1]), T)
                                  for T in (7, 4)))
    with torch.no_grad():
        state = model.init_decode_state(query, his, cap, fts, masks)
        kv_int = model.init_self_kv(B, maxlen)
        kv_t = model.init_self_kv(B, maxlen)
        pos = torch.arange(maxlen)
        for l in range(maxlen):
            cur = tok(1)[:, 0]
            a, kv_int = model.decode_step(state, cur, l, kv_int)
            b, kv_t = model.decode_step(state, cur, pos[l], kv_t)
            assert torch.equal(a, b), l
            for (k1, v1), (k2, v2) in zip(kv_int, kv_t):
                assert torch.equal(k1, k2) and torch.equal(v1, v2), l
