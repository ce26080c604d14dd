"""The port's MTN against the JAX MTN: the forward pass, init_decode_state
and decode steps, over a matrix of config branches (f32, CPU)."""

import jax
import numpy as np
import pytest
import torch

from mtn_tpu.models.mtn import MTN as JMTN
from mtn_tpu.train.batch import batch_masks as jax_masks
from mtn_tpu_torch.models.mtn import MTN
from mtn_tpu_torch.train.batch import batch_masks as torch_masks
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import (PAD, both_batches, host_fields,
                                interpret_pallas, one_thread, port_model,
                                seeded_params)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 5e-5   # the whole-model tolerance of tests/test_pallas.py
STEPS = 4

CASES = {
    "query_diff_encoder": dict(),
    "query_shared_seed_separate_embeds": dict(
        diff_encoder=False, separate_his_embed=True,
        separate_cap_embed=True),
    "caption_diff_embed_gen": dict(auto_encoder_ft="caption",
                                   diff_embed=True, diff_gen=True),
    "fused_decode_qkv": dict(fused_decode_qkv=True),
    "kernels_on": dict(use_pallas_attention=True, use_pallas_ffn=True,
                       d_ff=128),
}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("case", sorted(CASES) + ["no_video"])
def test_model_matches_jax(monkeypatch, case):
    if case == "kernels_on":
        interpret_pallas(monkeypatch)
    rng = np.random.default_rng(0)
    ft_dims = () if case == "no_video" else (12, 8)
    # Lq = 16 so the AE attentions pass the attention kernel's gate
    fields = host_fields(rng, Lq=16, ft_dims=ft_dims,
                         T=() if case == "no_video" else (5, 4),
                         lengths=None if case == "no_video"
                         else [[5, 3], [2, 4]])
    fields["query"][1, 9:] = PAD   # padded keys
    fields["cap"][0, :] = PAD      # a fully masked source row
    jdb, tdb = both_batches(fields)
    cfg = tiny_model_cfg(30, ft_dims, dropout=0.0,
                         **CASES.get(case, {}))
    params = seeded_params(cfg)
    jm = JMTN(cfg)
    tm = port_model(cfg, params)
    assert isinstance(tm, MTN)
    jmask, jtgt = jax_masks(jdb, PAD)
    tmask, ttgt = torch_masks(tdb, PAD)
    v = {"params": params}

    # forward pass + both heads
    jx, jae = jax.jit(lambda p: jm.apply(p, jdb.query, jdb.his, jdb.cap,
                                         jdb.fts, jmask, jdb.answer_in,
                                         jtgt))(v)
    with torch.no_grad():
        tx, tae = tm(tdb.query, tdb.his, tdb.cap, tdb.fts, tmask,
                     tdb.answer_in, ttgt)
        np.testing.assert_allclose(_np(tx), _np(jx), atol=ATOL)
        for a, b in zip(tae, jae):
            np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)
        np.testing.assert_allclose(
            _np(tm.generate_logprobs(tx)),
            _np(jm.apply(v, jx, method=JMTN.generate_logprobs)), atol=ATOL)
        for a, b in zip(tm.ae_logprobs(tae),
                        jm.apply(v, jae, method=JMTN.ae_logprobs)):
            np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)

        # decode state: every cached K/V, mask and the AE mask
        jstate = jax.jit(lambda p: jm.apply(
            p, jdb.query, jdb.his, jdb.cap, jdb.fts, jmask,
            method=JMTN.init_decode_state))(v)
        tstate = tm.init_decode_state(tdb.query, tdb.his, tdb.cap, tdb.fts,
                                      tmask)
        tleaves = []
        tstate.map(lambda t: tleaves.append(t) or t)
        jleaves = _flat(jstate)
        assert len(tleaves) == len(jleaves)
        for a, b in zip(tleaves, jleaves):
            np.testing.assert_allclose(_np(a), b.astype(np.float32),
                                       atol=ATOL)

        # decode steps over the same token stream
        B, maxlen = fields["query"].shape[0], STEPS + 1
        jkv = jm.apply(v, B, maxlen, method=JMTN.init_self_kv)
        tkv = tm.init_self_kv(B, maxlen, "cpu")
        jstep = jax.jit(lambda p, s, t, pos, kv: jm.apply(
            p, s, t, pos, kv, method=JMTN.decode_step))
        tokens = np.full((B,), 2, np.int32)
        for pos in range(STEPS):
            jlogp, jkv = jstep(v, jstate, tokens, pos, jkv)
            tlogp, tkv = tm.decode_step(tstate, torch.from_numpy(tokens).long(),
                                        pos, tkv)
            np.testing.assert_allclose(_np(tlogp), _np(jlogp), atol=ATOL,
                                       err_msg=f"pos={pos}")
            tokens = np.argmax(np.asarray(jlogp), axis=-1).astype(np.int32)


def test_unported_branches_raise():
    """Every branch of the config is ported: ``batched_ae`` builds (its
    numerics are held in tests/test_torch_batched_ae.py) and ``remat``
    too (tests/test_torch_train.py holds its loss and gradients)."""
    cfg = tiny_model_cfg(30, (12, 8))
    from tests.torch_parity import port_cfg
    c = port_cfg(cfg)
    c.batched_ae = True
    assert MTN(c).cfg.batched_ae
    c = port_cfg(cfg)
    c.remat = True
    assert MTN(c).cfg.remat
