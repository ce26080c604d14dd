"""The port's beam and greedy decoders against mtn_tpu's BeamDecoder:
tokens and scores with early stop on and off (margin-aware), greedy, and
an exact tie that pins the ``lax.top_k`` tie order."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtn_tpu.config import DecodeConfig as JDecodeConfig
from mtn_tpu.decode.beam import BeamDecoder as JBeamDecoder
from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.decode.beam import BeamDecoder, top_k
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import (both_batches, host_fields, one_thread,
                                port_model, seeded_params)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

EPS = 1e-4      # near-tie margin (f32 cross-framework noise is ~1e-6)
SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    fields = host_fields(rng, B=6, vocab=20)
    fields["valid"][4] = False  # a padded row is dropped by both
    jdb, tdb = both_batches(fields)
    cfg = tiny_model_cfg(20, (12, 8), dropout=0.0)
    params = seeded_params(cfg, seed=5, gen_scale=6.0)
    return cfg, params, jdb, tdb, port_model(cfg, params)


def _assert_margin_aware(jres, tres):
    """Robust-margin rows match token for token; near-tied rows decode a
    hypothesis JAX scored within EPS of its 1-best; most rows are robust."""
    assert len(jres) == len(tres)
    robust = 0
    for j, t in zip(jres, tres):
        margin = j.scores[0] - j.scores[1] if len(j.scores) > 1 \
            else float("inf")
        if margin > EPS:
            robust += 1
            assert t.tokens == j.tokens
            np.testing.assert_allclose(t.scores, j.scores, atol=SCORE_TOL)
        else:
            tied = [tok for tok, s in zip(j.tokens, j.scores)
                    if j.scores[0] - s <= EPS]
            assert t.tokens[0] in tied
    assert robust * 2 >= len(jres), "fixture too flat to prove anything"


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("penalty", [1.0, 0.0])
def test_beam_matches_jax(setup, early_stop, penalty):
    cfg, params, jdb, tdb, model = setup
    kw = dict(maxlen=8, beam=3, nbest=3, penalty=penalty,
              early_stop=early_stop)
    jres = JBeamDecoder(cfg, JDecodeConfig(**kw)).beam_batch(params, jdb)
    dec = BeamDecoder(model, DecodeConfig(**kw))
    raw = dec.beam_batch_raw(tdb)
    tres = dec.beam_results(raw, tdb.valid)
    _assert_margin_aware(jres, tres)
    if not early_stop:
        assert raw.n_steps == kw["maxlen"]


def _table_decoders(setup, table, **kw):
    """JAX and port decoders whose every step returns ``table``."""
    cfg, params, jdb, tdb, model = setup
    jdec = JBeamDecoder(cfg, JDecodeConfig(**kw))
    jdec._step = lambda p, s, tok, pos, kv: (jnp.asarray(table), kv)
    tdec = BeamDecoder(model, DecodeConfig(**kw))
    tdec._step = lambda s, tok, pos, kv: (torch.from_numpy(table), kv)
    return jdec, tdec


def test_early_stop_is_output_identical(setup):
    """A likely <eos> fills the n-best early, so the bound closes before
    maxlen; the early-stopped run matches the full run and JAX's."""
    cfg, params, jdb, tdb, model = setup
    beam, rows = 3, jdb.query.shape[0] * 3
    table = np.full((rows, cfg.vocab_size), np.float32(-9.0))
    table[:, 4:8] = np.log(np.array([0.2, 0.1, 0.1, 0.05], np.float32))
    table[:, 3] = np.float32(np.log(0.5))
    kw = dict(maxlen=12, beam=beam, nbest=2, penalty=0.5)
    jfull, tfull = _table_decoders(setup, table, early_stop=False, **kw)
    jearly, tearly = _table_decoders(setup, table, early_stop=True, **kw)
    raw = tearly.beam_batch_raw(tdb)
    assert raw.n_steps < kw["maxlen"]
    got = tearly.beam_results(raw, tdb.valid)
    assert got == tfull.beam_batch(tdb)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in jearly.beam_batch(params, jdb)]


def test_greedy_matches_jax(setup):
    cfg, params, jdb, tdb, model = setup
    for early_stop in (True, False):
        want = JBeamDecoder(cfg, JDecodeConfig(
            maxlen=6, early_stop=early_stop)).greedy_batch(params, jdb)
        got = BeamDecoder(model, DecodeConfig(
            maxlen=6, early_stop=early_stop)).greedy_batch(tdb)
        assert got == want


def test_top_k_tie_order_matches_lax():
    import jax
    x = np.array([[0.5, 1.0, 1.0, -2.0, 1.0, 0.5],
                  [3.0, 3.0, 3.0, 3.0, 3.0, 3.0]], np.float32)
    tv, ti = top_k(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0].tolist() == [1, 2, 4, 0]


def test_beam_exact_ties_follow_jax(setup):
    """Every decode step returns one constructed log-prob table full of
    exact ties; both decoders must pick the same parents, tokens and
    completions."""
    cfg, params, jdb, tdb, model = setup
    V, beam = cfg.vocab_size, 3
    levels = np.log(np.array([0.25, 0.25, 0.125, 0.125], np.float32))
    table = np.full((jdb.query.shape[0] * beam, V), np.float32(-9.0))
    table[:, 4:8] = levels            # two exact ties per row
    table[:, 3] = np.float32(-1.5)     # <eos>
    jdec, tdec = _table_decoders(setup, table, maxlen=5, beam=beam, nbest=3,
                                 penalty=1.0, early_stop=False)
    jres, tres = jdec.beam_batch(params, jdb), tdec.beam_batch(tdb)
    assert [dataclasses.astuple(r) for r in tres] == \
        [dataclasses.astuple(r) for r in jres]
