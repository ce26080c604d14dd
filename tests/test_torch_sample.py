"""The port's sampler against mtn_tpu's: the temperature / top-k / top-p
transform equal to JAX's, the degenerate settings equal to greedy, draws
keyed by (seed, fold, position) and distributed as the softmax
(chi-square), and the sample path of generate at temperature 0 equal to
JAX's result JSON."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from mtn_tpu.cli.generate import generate_responses as jax_generate
from mtn_tpu.config import DataConfig as JDataConfig
from mtn_tpu.config import DecodeConfig as JDecodeConfig
from mtn_tpu.data import load as jax_load
from mtn_tpu.data.vocab import get_vocabulary
from mtn_tpu.decode.beam import BeamDecoder as JBeamDecoder
from mtn_tpu_torch.cli.generate import generate_responses, main
from mtn_tpu_torch.config import DataConfig, DecodeConfig
from mtn_tpu_torch.data.batching import make_batch, make_batch_indices
from mtn_tpu_torch.data.batching import uniform_plans
from mtn_tpu_torch.data.dataset import load
from mtn_tpu_torch.decode.beam import (BeamDecoder, NEG_INF, draw_seed,
                                       gumbel_argmax)
from mtn_tpu_torch.train.batch import device_batch
from mtn_tpu_torch.weights import from_flax, save_checkpoint, save_conf
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import (both_batches, host_fields, one_thread,
                                port_model, seeded_params)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V = 20
EPS = 1e-4         # near-tie margin of a greedy step (f32 noise ~1e-6)
TOP_P_EDGE = 1e-6  # cumsum(p) - p this close to top_p may flip either way


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    fields = host_fields(rng, B=6, vocab=V)
    fields["valid"][4] = False
    jdb, tdb = both_batches(fields)
    cfg = tiny_model_cfg(V, (12, 8), dropout=0.0)
    params = seeded_params(cfg, seed=5, gen_scale=6.0)
    return cfg, params, jdb, tdb, port_model(cfg, params)


def _logp(seed=0, rows=8):
    """Seeded (rows, V) f32 log-probs with exact ties in every row."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((rows, V))).astype(np.float32)
    x[:, 5] = x[:, 2]
    x[::2, 9] = x[::2, 2]
    x = x - np.log(np.exp(x.astype(np.float64)).sum(-1, keepdims=True))
    return x.astype(np.float32)


@pytest.mark.parametrize("top_p", [0.0, 0.5, 0.9, 1e-9])
@pytest.mark.parametrize("top_k", [0, 1, 3, V, 10 ** 6])
@pytest.mark.parametrize("temp", [0.7, 1.0, 5.0])
def test_transform_matches_jax(setup, temp, top_k, top_p):
    cfg = setup[0]
    logp = _logp()
    kw = dict(temperature=temp, top_k=top_k, top_p=top_p)
    want = np.asarray(JBeamDecoder(cfg, JDecodeConfig(**kw))
                      ._sample_transform()(jnp.asarray(logp)))
    got = BeamDecoder(None, DecodeConfig(**kw)).sample_transform(
        torch.from_numpy(logp)).numpy()
    near = np.zeros(logp.shape, bool)
    if top_p > 0:  # JAX's own cumsum(p) - p before the nucleus cut
        pre = JBeamDecoder(cfg, JDecodeConfig(**dict(kw, top_p=0.0))) \
            ._sample_transform()(jnp.asarray(logp))
        srt, idx = jax.lax.top_k(pre, V)
        probs = jax.nn.softmax(srt, axis=-1)
        mass = np.asarray(jnp.cumsum(probs, axis=-1) - probs)
        np.put_along_axis(near, np.asarray(idx),
                          np.abs(mass - top_p) <= TOP_P_EDGE, axis=1)
    kept_w, kept_g = want > NEG_INF / 2, got > NEG_INF / 2
    assert np.all((kept_w == kept_g) | near)
    both = kept_w & kept_g
    np.testing.assert_array_equal(got[both], want[both])
    assert np.all(got[~kept_g] == NEG_INF)
    assert kept_g.any(axis=1).all()


@pytest.mark.parametrize("kw", [{"top_k": 1}, {"temperature": 0.0},
                                {"top_p": 1e-9}])
def test_sample_degenerates_to_greedy(setup, kw):
    model, tdb = setup[4], setup[3]
    greedy = BeamDecoder(model, DecodeConfig(maxlen=5)).greedy_batch(tdb)
    dec = BeamDecoder(model, DecodeConfig(maxlen=5, decode_style="sample",
                                          **kw))
    assert dec.sample_batch(tdb) == greedy


def test_sample_is_keyed_by_seed_fold_and_position(setup):
    """Same seed, same draws; fold 0 is the default and other folds draw
    anew; early stop on equals off; another seed draws anew."""
    model, tdb = setup[4], setup[3]
    mk = lambda **kw: BeamDecoder(model, DecodeConfig(
        maxlen=8, decode_style="sample", temperature=5.0, **kw))
    base = mk().sample_batch(tdb)
    assert mk().sample_batch(tdb) == base
    assert mk().sample_batch(tdb, fold=0) == base
    assert any(mk().sample_batch(tdb, fold=f) != base for f in (1, 2, 3))
    assert mk(sample_seed=2).sample_batch(tdb) != base
    top = dict(top_k=3, temperature=1.0)
    full = BeamDecoder(model, DecodeConfig(maxlen=8, decode_style="sample",
                                           early_stop=False, **top))
    early = BeamDecoder(model, DecodeConfig(maxlen=8, decode_style="sample",
                                            early_stop=True, **top))
    assert full.sample_batch(tdb, fold=1) == early.sample_batch(tdb, fold=1)


def test_draw_seed_mixes_every_integer():
    seeds = {draw_seed(s, f, p) for s in (0, 1, 2) for f in (0, 1, 7)
             for p in range(30)}
    assert len(seeds) == 3 * 3 * 30
    assert all(0 <= s < 2 ** 64 for s in seeds)


def test_draws_follow_the_softmax():
    """32,000 draws from one transformed row (temperature 0.8, top-k 12):
    chi-square against its softmax, and no masked token ever drawn."""
    logp = torch.from_numpy(_logp(seed=4, rows=1))
    logits = BeamDecoder(None, DecodeConfig(temperature=0.8, top_k=12)) \
        .sample_transform(logp)[0]
    kept = logits > NEG_INF / 2
    probs = torch.softmax(logits.double(), dim=0).numpy()
    counts = np.zeros(V, np.int64)
    rows = logits.expand(8000, V)
    for pos in range(4):
        draws = gumbel_argmax(rows, draw_seed(1, 0, pos)).numpy()
        counts += np.bincount(draws, minlength=V)
    assert counts.sum() == 32000
    assert counts[~kept.numpy()].sum() == 0
    k = kept.numpy()
    p_value = chisquare(counts[k], probs[k] * counts.sum()).pvalue
    assert p_value > 1e-4, (counts, probs)


# -- the sample path of generate ---------------------------------------------
DATA = dict(include_caption="caption,summary", separate_caption=True,
            length_bucket=8, feature_bucket=4)
DECODE = dict(maxlen=10, turn_batch=4, decode_style="sample",
              temperature=0.0, undisclosed_only=True)


@pytest.fixture(scope="module")
def corpus_setup(tiny_corpus):
    c = tiny_corpus
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    cfg = tiny_model_cfg(len(vocab), c.ft_dims, dropout=0.0)
    params = seeded_params(cfg, seed=3, gen_scale=6.0)
    data = load(c.fea_types, c.fea_path, c.test_set, vocab,
                include_caption="caption,summary", separate_caption=True,
                undisclosed_only=True)
    return c, vocab, cfg, params, data


def _greedy_margins(model, data):
    """Per qa_id, the smallest gap between the two best log-probs over
    the greedy steps up to the row's <eos>."""
    dec = BeamDecoder(model, DecodeConfig(**dict(DECODE, early_stop=False)))
    seen = []
    step = dec._step

    def recording(state, tokens, pos, kv):
        logp, kv = step(state, tokens, pos, kv)
        seen.append(logp)
        return logp, kv
    dec._step = recording
    plans, _ = make_batch_indices(data, 4, max_length=10 ** 9,
                                  separate_caption=True)
    out = {}
    for plan in uniform_plans(plans):
        hb = make_batch(data, plan, separate_caption=True, length_bucket=8,
                        feature_bucket=4, pad_rows_to=4)
        seen.clear()
        toks = dec.greedy_tokens(device_batch(hb, "cpu"))
        top2 = torch.stack([torch.topk(s, 2).values for s in seen])
        gaps = (top2[..., 0] - top2[..., 1]).T       # (B, steps)
        for b, qa in enumerate(plan.qa_ids):
            ends = (toks[b, 1:] == dec.eos).nonzero()
            last = int(ends[0]) + 1 if len(ends) else gaps.shape[1]
            out[qa] = float(gaps[b, :last].min())
    return out


def _answers(result):
    return [(d["image_id"], t, qa["answer"]) for d in result["dialogs"]
            for t, qa in enumerate(d["dialog"])]


def test_sample_path_at_temperature_0_matches_jax(corpus_setup):
    c, vocab, cfg, params, data = corpus_setup
    jdata = jax_load(c.fea_types, c.fea_path, c.test_set, vocab,
                     include_caption="caption,summary",
                     separate_caption=True, undisclosed_only=True)
    want, _, n = jax_generate(params, cfg, jdata, JDecodeConfig(**DECODE),
                              JDataConfig(**DATA), vocab, log=False)
    model = port_model(cfg, params)
    got, stats = generate_responses(model, data, DecodeConfig(**DECODE),
                                    DataConfig(**DATA), vocab, "cpu",
                                    log_hyps=False)
    assert stats["turns"] == n == len(_answers(want))
    margins = _greedy_margins(model, data)
    robust = 0
    for qa, (w, g) in enumerate(zip(_answers(want), _answers(got))):
        assert w[:2] == g[:2]
        if margins[qa] > EPS:
            robust += 1
            assert g == w
    assert robust * 2 >= n
    greedy, _ = generate_responses(
        model, data, DecodeConfig(**dict(DECODE, decode_style="greedy")),
        DataConfig(**DATA), vocab, "cpu", log_hyps=False)
    assert greedy == got


def test_cli_samples_on_port_checkpoint(corpus_setup, tmp_path):
    """``--decode-style sample`` runs end to end on the CPU; one seed
    writes one result, another seed another."""
    c, vocab, cfg, params, _ = corpus_setup
    prefix = str(tmp_path / "mtn")
    save_conf(prefix, vocab, model=cfg,
              data=JDataConfig(fea_type=list(c.fea_types), **DATA))
    save_checkpoint(prefix, 1, from_flax(params))

    def run(name, seed):
        out = tmp_path / name
        assert main(["--model", prefix + "_best", "--device", "cpu",
                     "--dtype", "float32", "--test-path", c.fea_path,
                     "--test-set", c.test_set, "--decode-style", "sample",
                     "--temperature", "3", "--top-k", "8", "--top-p", "0.95",
                     "--sample-seed", str(seed), "--maxlen", "10",
                     "--turn-batch", "2", "--undisclosed-only", "1",
                     "--use-pallas-attention", "1", "--use-pallas-ffn", "1",
                     "--output", str(out)]) == 0
        return json.loads(out.read_text())
    a, again, other = run("a.json", 1), run("b.json", 1), run("c.json", 9)
    answers = _answers(a)
    assert answers and all(x != "__UNDISCLOSED__" for _, _, x in answers)
    assert a == again
    assert other != a
