"""The port's token stream: reassembled, it equals greedy_batch and
sample_batch token for token; invalid rows are dropped from every yield
and do not keep the stream alive; beam style raises (the laws of
``tests/test_beam.py``'s stream tests)."""

import dataclasses

import numpy as np
import pytest
import torch

from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.decode.beam import BeamDecoder
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import (EOS, both_batches, host_fields, one_thread,
                                port_model, seeded_params)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(9)
    fields = host_fields(rng, B=5, vocab=20)
    _, tdb = both_batches(fields)
    cfg = tiny_model_cfg(20, (12, 8), dropout=0.0)
    return tdb, port_model(cfg, seeded_params(cfg, seed=2, gen_scale=3.0))


def _assemble(gen, n_valid, eos=EOS):
    """Per-row tokens of the yields, cut at each row's first <eos>, and
    the number of yields."""
    rows, done, steps = [[] for _ in range(n_valid)], [False] * n_valid, 0
    for step_tokens in gen:
        steps += 1
        assert len(step_tokens) == n_valid
        for i, t in enumerate(step_tokens):
            if done[i]:
                continue
            if int(t) == eos:
                done[i] = True
            else:
                rows[i].append(int(t))
    return rows, steps


def test_stream_matches_greedy(setup):
    tdb, model = setup
    dec = BeamDecoder(model, DecodeConfig(maxlen=8))
    want = dec.greedy_batch(tdb)
    got, steps = _assemble(dec.stream_tokens(tdb, style="greedy"), len(want))
    assert got == want
    assert steps <= 8


@pytest.mark.parametrize("fold", [0, 2])
def test_stream_matches_sample(setup, fold):
    tdb, model = setup
    dec = BeamDecoder(model, DecodeConfig(maxlen=8, decode_style="sample",
                                          temperature=1.0, top_p=0.9))
    want = dec.sample_batch(tdb, fold=fold)
    got, _ = _assemble(dec.stream_tokens(tdb, style="sample", fold=fold),
                       len(want))
    assert got == want


def test_stream_respects_invalid_rows(setup):
    """Invalid rows are dropped from every yield; a table that makes the
    invalid rows never emit <eos> must not keep the stream going past the
    valid rows' <eos>."""
    tdb, model = setup
    valid = torch.tensor([True, False, True, False, True])
    tdb2 = dataclasses.replace(tdb, valid=valid)
    dec = BeamDecoder(model, DecodeConfig(maxlen=6))
    want = dec.greedy_batch(tdb2)
    assert len(want) == 3
    got, _ = _assemble(dec.stream_tokens(tdb2), 3)
    assert got == want

    table = torch.full((5, 20), -9.0)
    table[:, 7] = -0.1                       # every row: token 7 ...
    table[valid, EOS] = 0.0                  # ... valid rows: <eos> first
    dec._step = lambda state, tok, pos, kv: (table.clone(), kv)
    yields = list(dec.stream_tokens(tdb2))
    assert len(yields) == 1
    assert yields[0].tolist() == [EOS] * 3


def test_stream_rejects_beam_style(setup):
    tdb, model = setup
    dec = BeamDecoder(model, DecodeConfig(maxlen=6))
    with pytest.raises(ValueError):
        next(dec.stream_tokens(tdb, style="beam_search"))
