"""The port's candidate ranking against mtn_tpu's: ``rank_batch`` within
1e-4 per option (a sum of per-step f32 log-probs), the (N, L) bucket law
padding-invariant, a row mismatch raising, and ``cli.rank`` end to end on
the tiny corpus with a candidates file from
``scripts/make_rank_candidates.py``, against JAX's ``rank_dataset``."""

import json
import os
import runpy

import numpy as np
import pytest

from mtn_tpu.cli.rank import _align_candidates as jax_align
from mtn_tpu.cli.rank import rank_dataset as jax_rank_dataset
from mtn_tpu.config import DataConfig as JDataConfig
from mtn_tpu.config import DecodeConfig as JDecodeConfig
from mtn_tpu.data import load as jax_load
from mtn_tpu.data.vocab import get_vocabulary
from mtn_tpu.decode.beam import BeamDecoder as JBeamDecoder
from mtn_tpu_torch.cli.rank import main
from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.decode.beam import BeamDecoder
from mtn_tpu_torch.weights import from_flax, save_checkpoint, save_conf
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import (both_batches, host_fields, one_thread,
                                port_model, seeded_params)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANDS = [[[5, 9, 4], [7], [11, 12, 13, 14, 6], [8, 8, 8, 8, 8, 8, 8, 8, 8]],
         [[8, 8], [10, 4, 6]],
         [],
         [[19], [4, 5, 6, 7, 8, 9, 10], [12, 3]]]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(13)
    fields = host_fields(rng, B=4, vocab=20)
    fields["valid"][3] = False
    jdb, tdb = both_batches(fields)
    cfg = tiny_model_cfg(20, (12, 8), dropout=0.0)
    params = seeded_params(cfg, seed=8, gen_scale=3.0)
    return cfg, params, jdb, tdb, port_model(cfg, params)


@pytest.mark.parametrize("include_eos", [True, False])
def test_rank_matches_jax(setup, include_eos):
    cfg, params, jdb, tdb, model = setup
    want = JBeamDecoder(cfg, JDecodeConfig()).rank_batch(
        params, jdb, CANDS, include_eos=include_eos)
    got = BeamDecoder(model, DecodeConfig()).rank_batch(
        tdb, CANDS, include_eos=include_eos)
    assert [len(r) for r in got] == [len(r) for r in want] == [4, 2, 0]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_rank_bucketing_is_padding_invariant(setup):
    """Padded candidate slots and tail positions add exactly 0."""
    *_, tdb, model = setup
    dec = BeamDecoder(model, DecodeConfig())
    a = dec.rank_batch(tdb, CANDS, len_bucket=4, cand_bucket=2)
    b = dec.rank_batch(tdb, CANDS, len_bucket=16, cand_bucket=8)
    for ra, rb in zip(a, b):
        np.testing.assert_allclose(ra, rb, rtol=0, atol=1e-5)


def test_rank_row_mismatch_and_empty_batch(setup):
    *_, tdb, model = setup
    dec = BeamDecoder(model, DecodeConfig())
    with pytest.raises(ValueError, match="candidates has 1 rows"):
        dec.rank_batch(tdb, [[[5]]])
    assert dec.rank_batch(tdb, [[], [], [], []]) == [[], [], []]


# -- cli.rank -----------------------------------------------------------------
DATA = dict(include_caption="caption,summary", separate_caption=True,
            length_bucket=8, feature_bucket=4)


def test_cli_rank_matches_jax_rank_dataset(tiny_corpus, tmp_path, capsys):
    c = tiny_corpus
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    cfg = tiny_model_cfg(len(vocab), c.ft_dims, dropout=0.0)
    params = seeded_params(cfg, seed=3, gen_scale=3.0)
    build = runpy.run_path(os.path.join(
        REPO, "scripts", "make_rank_candidates.py"))["build_candidates"]
    with open(c.lbl_test_set) as f:
        cands = build(json.load(f), num_options=6, seed=1, last_only=True)
    cand_path = tmp_path / "cands.json"
    cand_path.write_text(json.dumps(cands))
    prefix = str(tmp_path / "mtn")
    save_conf(prefix, vocab, model=cfg,
              data=JDataConfig(fea_type=list(c.fea_types), **DATA))
    save_checkpoint(prefix, 1, from_flax(params))
    out = tmp_path / "ranks.json"
    assert main(["--model", prefix + "_best", "--device", "cpu",
                 "--dtype", "float32", "--test-path", c.fea_path,
                 "--test-set", c.test_set, "--candidates", str(cand_path),
                 "--undisclosed-only", "1", "--turn-batch", "2",
                 "--use-pallas-attention", "1", "--use-pallas-ffn", "1",
                 "--output", str(out)]) == 0
    printed = capsys.readouterr().out
    for key in ("r@1", "r@5", "r@10", "mean_rank", "mrr"):
        assert f"{key}: " in printed
    result = json.loads(out.read_text())
    turns = [t for d in result["dialogs"] for t in d["dialog"]]
    assert set(result["metrics"]) == {"r@1", "r@5", "r@10", "mean_rank",
                                      "mrr"}

    jdata = jax_load(c.fea_types, c.fea_path, c.test_set, vocab,
                     include_caption="caption,summary",
                     separate_caption=True, undisclosed_only=True)
    want, _, n = jax_rank_dataset(params, cfg, jdata,
                                  jax_align(jdata, cands, True),
                                  JDataConfig(**DATA), vocab, turn_batch=2)
    assert n == len(turns) == len(want)
    for turn, w in zip(turns, want):
        assert len(turn["scores"]) == len(turn["answer_options"]) == len(w)
        np.testing.assert_allclose(turn["scores"], w, rtol=0, atol=TOL)
        gt = turn["gt_index"]
        gap = min((abs(w[gt] - s) for i, s in enumerate(w) if i != gt),
                  default=np.inf)
        if gap > TOL:
            want_rank = 1 + sum(s > w[gt] for s in w)
            assert turn["gt_rank"] == want_rank


def test_cli_rank_int8_feature_transfer_matches_jax(tiny_corpus, tmp_path):
    """``--feature-transfer int8``: the int8 wire into the same rank scores
    as JAX's rank_dataset with ``feature_transfer="int8"``."""
    c = tiny_corpus
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    cfg = tiny_model_cfg(len(vocab), c.ft_dims, dropout=0.0)
    params = seeded_params(cfg, seed=3, gen_scale=3.0)
    build = runpy.run_path(os.path.join(
        REPO, "scripts", "make_rank_candidates.py"))["build_candidates"]
    with open(c.lbl_test_set) as f:
        cands = build(json.load(f), num_options=4, seed=2, last_only=True)
    cand_path = tmp_path / "cands.json"
    cand_path.write_text(json.dumps(cands))
    prefix = str(tmp_path / "mtn")
    save_conf(prefix, vocab, model=cfg,
              data=JDataConfig(fea_type=list(c.fea_types), **DATA))
    save_checkpoint(prefix, 1, from_flax(params))
    out = tmp_path / "ranks.json"
    assert main(["--model", prefix + "_best", "--device", "cpu",
                 "--dtype", "float32", "--test-path", c.fea_path,
                 "--test-set", c.test_set, "--candidates", str(cand_path),
                 "--undisclosed-only", "1", "--turn-batch", "2",
                 "--feature-transfer", "int8", "--output", str(out)]) == 0
    turns = [t for d in json.loads(out.read_text())["dialogs"]
             for t in d["dialog"]]
    jdata = jax_load(c.fea_types, c.fea_path, c.test_set, vocab,
                     include_caption="caption,summary",
                     separate_caption=True, undisclosed_only=True)
    want, _, n = jax_rank_dataset(params, cfg, jdata,
                                  jax_align(jdata, cands, True),
                                  JDataConfig(**DATA), vocab, turn_batch=2,
                                  feature_transfer="int8")
    assert n == len(turns)
    for turn, w in zip(turns, want):
        np.testing.assert_allclose(turn["scores"], w, rtol=0, atol=TOL)


def test_cli_rank_refuses_multihost_and_bad_candidates(tiny_corpus,
                                                       tmp_path):
    from mtn_tpu_torch.cli.rank import _align_candidates
    from mtn_tpu_torch.data.dataset import load
    with pytest.raises(ValueError, match="--multihost expects 'auto' or"):
        main(["--device", "cpu", "--candidates", "x", "--multihost",
              "h:1,2"])
    c = tiny_corpus
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    data = load(c.fea_types, c.fea_path, c.test_set, vocab,
                include_caption="caption,summary", separate_caption=True,
                undisclosed_only=True)
    jdata = jax_load(c.fea_types, c.fea_path, c.test_set, vocab,
                     include_caption="caption,summary",
                     separate_caption=True, undisclosed_only=True)
    ids = [d["image_id"] for d in data.original["dialogs"]]
    good = {"dialogs": [{"image_id": i, "dialog": [
        {"answer_options": ["a cat", "no"], "gt_index": 1}]} for i in ids]}
    bad = [
        {"dialogs": good["dialogs"][:-1]},
        {"dialogs": [dict(good["dialogs"][0], image_id="zzz")]
         + good["dialogs"][1:]},
        {"dialogs": [dict(d, dialog=d["dialog"] * 2)
                     for d in good["dialogs"]]},
        {"dialogs": [{"image_id": i, "dialog": [
            {"answer_options": ["a", " "]}]} for i in ids]},
        {"dialogs": [{"image_id": i, "dialog": [
            {"answer_options": ["a"], "gt_index": 1}]} for i in ids]},
    ]
    assert _align_candidates(data, good, True) == \
        jax_align(jdata, good, True)
    for cand in bad:
        with pytest.raises(ValueError) as want:
            jax_align(jdata, cand, True)
        with pytest.raises(ValueError) as got:
            _align_candidates(data, cand, True)
        assert str(got.value) == str(want.value)
