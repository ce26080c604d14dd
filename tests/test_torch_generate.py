"""The port's generate against mtn_tpu's on the tiny DSTC7-format corpus:
the same params give the same result JSON (margin-aware), and the port's
CLI runs end to end on a checkpoint in its own format."""

import json
import re

import numpy as np
import pytest
import torch

from mtn_tpu.cli.generate import generate_responses as jax_generate
from mtn_tpu.config import DataConfig as JDataConfig
from mtn_tpu.config import DecodeConfig as JDecodeConfig
from mtn_tpu.data import load as jax_load
from mtn_tpu.data.vocab import get_vocabulary
from mtn_tpu_torch.cli.generate import generate_responses, main
from mtn_tpu_torch.config import DataConfig, DecodeConfig
from mtn_tpu_torch.data.batching import make_batch as t_make_batch
from mtn_tpu_torch.data.batching import make_batch_indices as t_indices
from mtn_tpu_torch.data.batching import uniform_plans
from mtn_tpu_torch.data.dataset import load
from mtn_tpu_torch.decode.beam import BeamDecoder
from mtn_tpu_torch.train.batch import device_batch as t_device_batch
from mtn_tpu_torch.weights import from_flax, save_checkpoint, save_conf
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import one_thread, port_model, seeded_params  # noqa

pytestmark = pytest.mark.usefixtures("one_thread")

EPS = 1e-4
DATA = dict(include_caption="caption,summary", separate_caption=True,
            length_bucket=8, feature_bucket=4)
DECODE = dict(maxlen=10, beam=3, nbest=3, penalty=1.0, turn_batch=4,
              decode_style="beam_search", undisclosed_only=True)


@pytest.fixture(scope="module")
def setup(tiny_corpus):
    c = tiny_corpus
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    cfg = tiny_model_cfg(len(vocab), c.ft_dims, dropout=0.0)
    params = seeded_params(cfg, seed=3, gen_scale=6.0)
    return c, vocab, cfg, params


def _answers(result):
    return [(d["image_id"], t, qa["answer"]) for d in result["dialogs"]
            for t, qa in enumerate(d["dialog"])]


def _nbest(model, data, vocab):
    """The port's n-best per qa_id on the generate batches."""
    from mtn_tpu_torch.data.vocab import vocab_list
    dec = BeamDecoder(model, DecodeConfig(**DECODE))
    plans, _ = t_indices(data, 4, max_length=10 ** 9,
                         separate_caption=True)
    out = {}
    for plan in uniform_plans(plans):
        hb = t_make_batch(data, plan, separate_caption=True,
                          length_bucket=8, feature_bucket=4, pad_rows_to=4)
        for qa, res in zip(plan.qa_ids,
                           dec.beam_batch(t_device_batch(hb, "cpu"))):
            out[qa] = res.texts(vocab_list(data.vocab))
    return out


def test_generate_matches_jax(setup):
    c, vocab, cfg, params = setup
    jdata = jax_load(c.fea_types, c.fea_path, c.test_set, vocab,
                     include_caption="caption,summary",
                     separate_caption=True, undisclosed_only=True)
    want, _, n = jax_generate(params, cfg, jdata, JDecodeConfig(**DECODE),
                              JDataConfig(**DATA), vocab, log=False)
    data = load(c.fea_types, c.fea_path, c.test_set, vocab,
                include_caption="caption,summary", separate_caption=True,
                undisclosed_only=True)
    model = port_model(cfg, params)
    got, stats = generate_responses(model, data, DecodeConfig(**DECODE),
                                    DataConfig(**DATA), vocab, "cpu",
                                    log_hyps=False)
    assert stats["turns"] == n == len(_answers(want))
    nbest = _nbest(model, data, vocab)
    robust = 0
    for qa, ((vid, t, w), (vid2, t2, g)) in enumerate(
            zip(_answers(want), _answers(got))):
        assert (vid, t) == (vid2, t2)
        texts = nbest[qa]
        margin = texts[0][1] - texts[1][1] if len(texts) > 1 else np.inf
        if margin > EPS:
            robust += 1
            assert g == w, f"{vid} turn {t}"
        else:
            assert w in {s for s, sc in texts if texts[0][1] - sc <= EPS}
    assert robust * 2 >= n
    # the written structure is the JAX one, answers aside
    strip = lambda r: [(d["image_id"], [q["question"] for q in d["dialog"]])
                       for d in r["dialogs"]]
    assert strip(got) == strip(want)


def test_cli_end_to_end_on_port_checkpoint(setup, tmp_path):
    c, vocab, cfg, params = setup
    prefix = str(tmp_path / "mtn")
    save_conf(prefix, vocab, model=cfg,
              data=JDataConfig(fea_type=list(c.fea_types), **DATA))
    save_checkpoint(prefix, 1, from_flax(params))
    out, stats = tmp_path / "result.json", tmp_path / "stats.json"
    rc = main(["--model", prefix + "_best", "--device", "cpu",
               "--dtype", "float32", "--test-path", c.fea_path,
               "--test-set", c.test_set, "--decode-style", "beam_search",
               "--beam", "3", "--nbest", "3", "--penalty", "1.0",
               "--maxlen", "10", "--turn-batch", "4",
               "--undisclosed-only", "1", "--labeled-test", c.lbl_test_set,
               "--use-pallas-attention", "1", "--use-pallas-ffn", "1",
               "--output", str(out), "--stats-output", str(stats)])
    assert rc == 0
    result = json.loads(out.read_text())
    answers = _answers(result)
    assert answers and all(a != "__UNDISCLOSED__" for _, _, a in answers)
    assert json.loads(stats.read_text())["turns"] == len(answers)
    # the kernels' plain versions on the CPU decode what the plain path does
    data = load(c.fea_types, c.fea_path, c.test_set, vocab,
                include_caption="caption,summary", separate_caption=True,
                undisclosed_only=True)
    plain, _ = generate_responses(port_model(cfg, params), data,
                                  DecodeConfig(**DECODE), DataConfig(**DATA),
                                  vocab, "cpu", log_hyps=False)
    assert _answers(plain) == answers


MESH_ERRORS = [
    (["--mesh-model", "2"], AssertionError,
     "1 devices not divisible by model=2"),
    (["--mesh-data", "2", "--mesh-model", "2"], AssertionError,
     "mesh 2x2 > 1 devices"),
    (["--multihost", "localhost:1,two,0"], ValueError,
     "--multihost expects 'auto' or 'host:port,nprocs,procid'")]


@pytest.mark.parametrize("flag,error,match", MESH_ERRORS)
def test_cli_refuses_unported_flags(flag, error, match):
    """The parallel flags are ported (``tests/test_torch_distributed.py``
    runs them on gloo worlds); a mesh larger than the world raises as
    JAX's ``make_mesh`` asserts, and a bad ``--multihost`` spec with JAX's
    message, before anything is loaded."""
    with pytest.raises(error, match=re.escape(match)):
        main(["--device", "cpu", *flag])


@pytest.mark.parametrize("quant", ["int8", "int8-fp-head"])
def test_cli_int8_weights_and_features(setup, tmp_path, quant):
    """--weights-quant and --feature-transfer int8 decode what the
    quantized model decodes on int8-transferred features."""
    from mtn_tpu_torch.utils.quantize import quantize_model
    c, vocab, cfg, params = setup
    prefix = str(tmp_path / "mtn")
    save_conf(prefix, vocab, model=cfg,
              data=JDataConfig(fea_type=list(c.fea_types), **DATA))
    save_checkpoint(prefix, 1, from_flax(params))
    out = tmp_path / "result.json"
    assert main(["--model", prefix + "_best", "--device", "cpu",
                 "--dtype", "float32", "--test-path", c.fea_path,
                 "--test-set", c.test_set, "--decode-style", "beam_search",
                 "--beam", "3", "--nbest", "3", "--penalty", "1.0",
                 "--maxlen", "10", "--turn-batch", "4",
                 "--undisclosed-only", "1", "--weights-quant", quant,
                 "--feature-transfer", "int8", "--output", str(out)]) == 0
    data = load(c.fea_types, c.fea_path, c.test_set, vocab,
                include_caption="caption,summary", separate_caption=True,
                undisclosed_only=True)
    model = quantize_model(port_model(cfg, params), from_flax(params),
                           skip_generator=quant == "int8-fp-head")
    want, _ = generate_responses(model, data, DecodeConfig(**DECODE),
                                 DataConfig(**DATA), vocab, "cpu",
                                 feature_dtype="int8", log_hyps=False)
    assert _answers(json.loads(out.read_text())) == _answers(want)


def test_cli_needs_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--model", "x"])


def test_in_flight_generate_matches_one_at_a_time_and_jax(setup,
                                                          monkeypatch):
    """Every turn its own batch (9 batches of one shape, the decoder's
    program sets run on the host): 8 batches in flight give the result
    JSON of 1 in flight and, margin-aware, JAX's ``generate_responses``."""
    import mtn_tpu_torch.decode.beam as beam_mod
    from mtn_tpu_torch.cli import generate as gen_mod
    from mtn_tpu_torch.decode import graphs
    c, vocab, cfg, params = setup
    runners = []

    def runner():
        runners.append(graphs.GraphRunner(capture=False))
        return runners[-1]
    monkeypatch.setattr(beam_mod, "GraphRunner", runner)
    monkeypatch.setattr(BeamDecoder, "graphed", lambda self, t: True)
    dcfg = dict(DECODE, turn_batch=1, undisclosed_only=False)
    data = load(c.fea_types, c.fea_path, c.test_set, vocab,
                include_caption="caption,summary", separate_caption=True)
    model = port_model(cfg, params)
    got = {}
    for depth in (8, 1):
        monkeypatch.setattr(gen_mod, "MAX_IN_FLIGHT", depth)
        got[depth], stats = generate_responses(
            model, data, DecodeConfig(**dcfg), DataConfig(**DATA), vocab,
            "cpu", log_hyps=True)
        assert stats["batches"] >= 9
    assert json.dumps(got[8]) == json.dumps(got[1])
    assert all(r.captures == 1 and r.eager == 1 for r in runners)
    jdata = jax_load(c.fea_types, c.fea_path, c.test_set, vocab,
                     include_caption="caption,summary",
                     separate_caption=True)
    want, _, n = jax_generate(params, cfg, jdata, JDecodeConfig(**dcfg),
                              JDataConfig(**DATA), vocab, log=False)
    decoder = BeamDecoder(model, DecodeConfig(**dcfg))
    plans, _ = t_indices(data, 1, max_length=10 ** 9, separate_caption=True)
    from mtn_tpu_torch.data.vocab import vocab_list
    nbest = {}
    for plan in uniform_plans(plans):
        hb = t_make_batch(data, plan, separate_caption=True,
                          length_bucket=8, feature_bucket=4, pad_rows_to=1)
        for qa, res in zip(plan.qa_ids,
                           decoder.beam_batch(t_device_batch(hb, "cpu"))):
            nbest[qa] = res.texts(vocab_list(vocab))
    assert len(nbest) == n
    for qa, ((vid, t, w), (_, _, g)) in enumerate(
            zip(_answers(want), _answers(got[8]))):
        texts = nbest[qa]
        margin = texts[0][1] - texts[1][1] if len(texts) > 1 else np.inf
        if margin > EPS:
            assert g == w, f"{vid} turn {t}"
        else:
            assert w in {s for s, sc in texts if texts[0][1] - sc <= EPS}
