"""The port's serving layer against the JAX package's, on a checkpoint
trained by ``mtn_tpu`` (the session-scoped ``served`` fixture), dumped by
``scripts/dump_flax_params.py`` and imported by
``mtn_tpu_torch.utils.import_flax`` (f32, CPU):

- the imported checkpoint holds JAX's params bit for bit and decodes, by
  ``cli.generate``, what JAX's ``cli.generate`` decodes (margin-aware);
- ``ServingSession`` answers and n-best scores within 5e-5 of JAX's
  session, in full precision and both int8 modes; rank log-probs within
  1e-4 per option; the greedy stream token for token;
- sampling, ``reload`` and ``AsyncServer`` keep the behaviour of
  ``tests/test_serve.py``.
"""

import importlib.util
import json
import os
import shutil
import threading
import time
import types

import numpy as np
import pytest
import torch

from mtn_tpu.config import DecodeConfig as JDecodeConfig
from mtn_tpu.serve import Request as JRequest
from mtn_tpu.serve import ServingSession as JSession
from mtn_tpu.serve import encode_requests as jax_encode
from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.serve import (AsyncServer, DeadlineExceeded, Request,
                                 ServerOverloaded, ServingSession,
                                 encode_requests)
from mtn_tpu_torch.utils.import_flax import import_flax, load_npz
from mtn_tpu_torch.utils.import_flax import main as import_main
from mtn_tpu_torch.weights import (load_checkpoint, load_conf,
                                   save_checkpoint)
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 5e-5       # answers' scores: the whole-model tolerance
RANK_ATOL = 1e-4  # rank log-probs per option
EPS = 0.05        # a robust n-best margin (tests/refpipe.py)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUESTIONS = ["is there any sound ?", "what is he doing ?",
             "does the man speak ?", "is it a long video ?",
             "are there people ?", "is there music playing ?"]


def _dump_module():
    spec = importlib.util.spec_from_file_location(
        "dump_flax_params", os.path.join(REPO, "scripts",
                                         "dump_flax_params.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bridged(served, tmp_path_factory):
    """A copy of the served JAX run with its best checkpoint dumped and
    imported into the port: (prefix, features, npz path)."""
    prefix, feats = served
    root = tmp_path_factory.mktemp("bridge")
    shutil.copytree(os.path.dirname(prefix), root / "exp")
    prefix = str(root / "exp" / os.path.basename(prefix))
    npz = str(root / "params.npz")
    assert _dump_module().dump(prefix + "_best", npz) == 1
    import_flax(npz, prefix)
    return prefix, feats, npz


def _requests(feats, n=len(QUESTIONS), cls=Request):
    return [cls(question=q, history=[("is anyone there ?", "yes a man")],
                caption="a man sits on a couch reading a book",
                features=feats if i % 2 == 0 else {})
            for i, q in enumerate(QUESTIONS[:n])]


def _port(prefix, **kw):
    return ServingSession.from_checkpoint(
        prefix + "_best", DecodeConfig(**kw.pop("dcfg")), device="cpu",
        **kw)


def _jax(prefix, **kw):
    return JSession.from_checkpoint(prefix + "_best",
                                    JDecodeConfig(**kw.pop("dcfg")), **kw)


BEAM = dict(maxlen=6, beam=3, nbest=3, turn_batch=4)


# -- the checkpoint bridge ----------------------------------------------------
def test_dump_and_import_hold_the_jax_params_bitwise(bridged, tmp_path):
    import jax
    from mtn_tpu.utils.quantize import raw_params
    prefix, _, npz = bridged
    sd, epoch = load_checkpoint(prefix, "best")
    assert epoch == 1
    params = raw_params(_jax(prefix, dcfg=BEAM).params)
    flat = {".".join(str(p.key) for p in path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(flat) == set(sd)
    for k, v in flat.items():
        assert np.array_equal(sd[k].numpy(), v), k
    # the CLI writes another epoch and points best at it; a dump that
    # does not fit is refused
    shutil.copytree(os.path.dirname(prefix), tmp_path / "exp")
    copy = str(tmp_path / "exp" / os.path.basename(prefix))
    assert import_main([npz, copy, "--epoch", "4"]) == 0
    assert load_checkpoint(copy, "best")[1] == 4
    assert load_checkpoint(copy, "latest")[1] == 4
    assert all(torch.equal(v, sd[k])
               for k, v in load_checkpoint(copy, 4)[0].items())
    from mtn_tpu_torch.config import config_from_dict
    cfg = config_from_dict("model", load_conf(prefix)[1]["model"])
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    key = "generator.proj.bias"
    for name, bad in (("missing", {k: v for k, v in arrays.items()
                                   if k != key}),
                      ("shape", dict(arrays, **{key: arrays[key][:-1]}))):
        path = str(tmp_path / f"{name}.npz")
        np.savez(path, **bad)
        with pytest.raises(ValueError, match="does not fit"):
            load_npz(path, cfg)


def _nbest(session, data, vocab):
    """The port's n-best per qa_id over the generate CLI's batches."""
    from mtn_tpu_torch.data.batching import (make_batch, make_batch_indices,
                                             uniform_plans)
    from mtn_tpu_torch.data.vocab import vocab_list
    plans, _ = make_batch_indices(data, 4, max_length=10 ** 9,
                                  separate_caption=True)
    out = {}
    for plan in uniform_plans(plans):
        hb = make_batch(data, plan, separate_caption=True, length_bucket=8,
                        feature_bucket=4, pad_rows_to=4)
        for qa, res in zip(plan.qa_ids,
                           session.decoder.beam_batch(session.to_device(hb))):
            out[qa] = res.texts(vocab_list(vocab))
    return out


def test_generate_cli_decodes_the_jax_checkpoint_like_jax(bridged,
                                                          tiny_corpus,
                                                          tmp_path):
    from mtn_tpu.cli.generate import main as jax_main
    from mtn_tpu_torch.cli.generate import main
    from mtn_tpu_torch.data.dataset import load
    prefix, _, _ = bridged
    c = tiny_corpus
    flags = ["--test-path", c.fea_path, "--test-set", c.test_set,
             "--model", prefix + "_best", "--beam", "3", "--penalty", "1.0",
             "--nbest", "3", "--maxlen", "8", "--decode-style",
             "beam_search", "--undisclosed-only", "1", "--labeled-test",
             c.lbl_test_set, "--turn-batch", "4", "--dtype", "float32"]
    outs = [str(tmp_path / n) for n in ("jax.json", "port.json")]
    assert jax_main(flags + ["--output", outs[0]]) == 0
    assert main(flags + ["--output", outs[1], "--device", "cpu"]) == 0
    want, got = (json.load(open(p)) for p in outs)
    answers = lambda r: [(d["image_id"], qa["answer"])
                         for d in r["dialogs"] for qa in d["dialog"]]
    vocab, _ = load_conf(prefix)
    data = load(list(c.fea_types), c.fea_path, c.test_set, vocab,
                include_caption="caption,summary", separate_caption=True,
                undisclosed_only=True)
    nbest = _nbest(_port(prefix, dcfg=dict(BEAM, maxlen=8)), data, vocab)
    robust = 0
    for qa, ((vid, w), (vid2, g)) in enumerate(zip(answers(want),
                                                   answers(got))):
        assert vid == vid2
        texts = nbest[qa]
        margin = texts[0][1] - texts[1][1] if len(texts) > 1 else np.inf
        if margin > EPS:
            robust += 1
            assert g == w, vid
        else:
            assert w in {s for s, sc in texts if texts[0][1] - sc <= EPS}
    assert robust * 2 >= len(answers(want))


# -- ServingSession ----------------------------------------------------------
@pytest.mark.parametrize("quant", ["", "int8", "int8-fp-head"])
def test_respond_batch_matches_jax(bridged, quant):
    prefix, feats, _ = bridged
    port = _port(prefix, dcfg=BEAM, weights_quant=quant)
    jax_session = _jax(prefix, dcfg=BEAM, weights_quant=quant)
    assert port.epoch == jax_session.epoch == 1
    got = port.respond_batch(_requests(feats))
    want = jax_session.respond_batch(_requests(feats, cls=JRequest))
    assert len(got) == len(want) == len(QUESTIONS)
    for g, w in zip(got, want):
        assert len(g.nbest) == len(w.nbest)
        np.testing.assert_allclose([s for _, s in g.nbest],
                                   [s for _, s in w.nbest], atol=ATOL)
        ties = {a for a, s in w.nbest if w.nbest[0][1] - s <= ATOL}
        assert g[0] == w[0] or g[0] in ties
    # an oversize batch runs as one batch of its own size
    assert len(port.respond_batch(_requests(feats) * 2)) == 12


def test_encode_requests_equals_jax(bridged):
    prefix, feats, _ = bridged
    port = _port(prefix, dcfg=BEAM)
    hb = encode_requests(_requests(feats), port.model_cfg, port.data_cfg,
                         port.vocab, port._lb, port._fb, pad_rows_to=8)
    jax_session = _jax(prefix, dcfg=BEAM)
    jhb = jax_encode(_requests(feats, cls=JRequest), jax_session.model_cfg,
                     jax_session.data_cfg, jax_session.vocab, 8, 4,
                     pad_rows_to=8)
    for name in ("query", "his", "cap", "answer_in", "valid"):
        assert np.array_equal(getattr(hb, name), getattr(jhb, name)), name
    for a, b in zip(hb.fts + hb.fts_len, jhb.fts + jhb.fts_len):
        assert np.array_equal(a, b)


def test_encode_requests_honors_merge_and_history_laws():
    from mtn_tpu_torch.config import DataConfig, ModelConfig
    vocab = {"<unk>": 0, "<blank>": 1, "<sos>": 2, "<eos>": 3,
             "a": 4, "b": 5, "c": 6}
    mc = ModelConfig(vocab_size=7, ft_sizes=[])
    r = Request(question="a", history=[("a b", "c"), ("b", "a a")],
                caption="c c")
    base = encode_requests([r], mc, DataConfig(
        include_caption="caption", separate_caption=True), vocab)
    qa1, qa2 = 4 + 3, 3 + 4  # each word + the sos/eos wrappers
    assert base.his.shape[1] == 1 + qa1 + qa2
    assert base.query.shape[1] == 3
    trunc = encode_requests([r], mc, DataConfig(
        include_caption="caption", separate_caption=True,
        max_history_length=1), vocab)
    assert trunc.his.shape[1] == 1 + qa2
    merged = encode_requests([r], mc, DataConfig(
        include_caption="caption", separate_caption=True,
        merge_source=True), vocab)
    assert merged.query.shape[1] == 4 + (1 + qa1 + qa2) + 3


def test_rank_and_stream_match_jax(bridged):
    prefix, feats, _ = bridged
    port = _port(prefix, dcfg=BEAM)
    jax_session = _jax(prefix, dcfg=BEAM)
    cands = ["he sits on the couch", "a dog walks", "yes",
             "no people at all"]
    for req, jreq in zip(_requests(feats, 2), _requests(feats, 2, JRequest)):
        for eos in (True, False):
            got = port.rank(req, cands, include_eos=eos)
            want = jax_session.rank(jreq, cands, include_eos=eos)
            assert [c for c, _, _ in got] == cands
            np.testing.assert_allclose([s for _, s, _ in got],
                                       [s for _, s, _ in want],
                                       atol=RANK_ATOL)
            assert [r for _, _, r in got] == [r for _, _, r in want]
        assert list(port.stream(req)) == list(jax_session.stream(jreq))
    with pytest.raises(ValueError):
        port.rank(_requests(feats, 1)[0], [])


def test_sample_is_deterministic_and_folds_per_call(bridged):
    prefix, feats, _ = bridged
    dcfg = dict(maxlen=6, decode_style="sample", temperature=1.0, top_k=5,
                turn_batch=4)
    s1, s2 = _port(prefix, dcfg=dcfg), _port(prefix, dcfg=dcfg)
    reqs = _requests(feats, 4)
    first = s1.respond_batch(reqs)
    assert s2.respond_batch(reqs) == first
    assert s1._sample_calls == s2._sample_calls == 1
    # the second call draws with fold 1, in both sessions alike
    second = s1.respond_batch(reqs)
    assert s2.respond_batch(reqs) == second
    from mtn_tpu_torch.decode.beam import detokenize
    db = s1.to_device(encode_requests(reqs, s1.model_cfg, s1.data_cfg,
                                      s1.vocab, s1._lb, s1._fb, 4))
    for fold, got in ((0, first), (1, second)):
        rows = s1.decoder.sample_batch(db, fold=fold)
        assert [detokenize(r, s1.vlist) for r in rows] == \
            [a for a, _ in got]
    # a sampled stream takes the next fold too
    list(s1.stream(reqs[0], style="sample"))
    assert s1._sample_calls == 3
    assert all(s == 0.0 for _, s in first)


def test_reload_swaps_weights_and_a_decode_in_flight_keeps_the_old(
        bridged, tmp_path):
    prefix, feats, _ = bridged
    shutil.copytree(os.path.dirname(prefix), tmp_path / "exp")
    prefix = str(tmp_path / "exp" / os.path.basename(prefix))
    sd, _ = load_checkpoint(prefix, 1)
    bumped = {k: v + 0.05 for k, v in sd.items()}
    save_checkpoint(prefix, 2, bumped, best=False)
    req = _requests(feats, 1)
    session = _port(prefix, dcfg=BEAM)
    old = session.respond_batch(req)[0].nbest
    want_new = ServingSession.from_checkpoint(
        prefix + "_2", DecodeConfig(**BEAM), device="cpu"
    ).respond_batch(req)[0].nbest

    # a decode stopped inside its first step while the weights swap
    decoder, inside, release, out = (session.decoder, threading.Event(),
                                     threading.Event(), [])
    step = decoder._step

    def held_step(*args):
        inside.set()
        assert release.wait(120)
        return step(*args)
    decoder._step = held_step
    t = threading.Thread(target=lambda: out.append(
        session.respond_batch(req)[0].nbest))
    t.start()
    assert inside.wait(120)
    assert session.reload(prefix + "_2") == 2
    release.set()
    t.join(120)
    assert not t.is_alive()
    assert out == [old]
    assert session.decoder is not decoder and session.epoch == 2
    new = session.respond_batch(req)[0].nbest
    assert new == want_new and new != old
    for k, v in session.model.state_dict().items():
        assert torch.equal(v, bumped[k])
    # back to epoch 1 reproduces the original answer exactly
    assert session.reload(prefix + "_1") == 1
    assert session.respond_batch(req)[0].nbest == old
    # a checkpoint of another architecture, or none, is refused
    save_checkpoint(prefix, 3, {k: v for k, v in sd.items()
                                if "generator" not in k}, best=False)
    with pytest.raises(ValueError, match="served architecture"):
        session.reload(prefix + "_3")
    with pytest.raises(FileNotFoundError):
        session.reload(str(tmp_path / "nope" / "mtn_best"))
    assert session.epoch == 1


def test_reload_keeps_int8(bridged):
    prefix, feats, _ = bridged
    session = _port(prefix, dcfg=BEAM, weights_quant="int8")
    before = session.respond_batch(_requests(feats, 2))
    assert session.reload() == 1
    assert session.model.generator.proj.is_int8
    assert session.respond_batch(_requests(feats, 2)) == before


def test_model_overrides_and_refusals(bridged):
    prefix, feats, _ = bridged
    base = _port(prefix, dcfg=BEAM)
    fused = _port(prefix, dcfg=BEAM,
                  model_overrides={"fused_decode_qkv": True})
    assert fused.model_cfg.fused_decode_qkv is True
    reqs = _requests(feats, 3)
    assert [a for a, _ in fused.respond_batch(reqs)] == \
        [a for a, _ in base.respond_batch(reqs)]
    with pytest.raises(ValueError, match="unknown ModelConfig field"):
        _port(prefix, dcfg=BEAM, model_overrides={"nope": 1})
    with pytest.raises(ValueError, match="weights_quant"):
        _port(prefix, dcfg=BEAM, weights_quant="int4")
    # JAX's refusal of a turn batch that does not divide over the data
    # axis, before the mesh is used (tests/test_torch_serve_parallel.py
    # serves real meshes)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(3, 1))
    with pytest.raises(ValueError, match="does not divide over the "
                       "mesh's data axis"):
        _port(prefix, dcfg=BEAM, mesh=mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            ServingSession.from_checkpoint(prefix + "_best")


def test_warmup_and_feature_transfer_int8(bridged):
    prefix, feats, _ = bridged
    base = _port(prefix, dcfg=BEAM)
    q8 = _port(prefix, dcfg=BEAM, feature_transfer="int8")
    assert q8.warmup(stream=True) >= 0.0
    # zero-feature requests quantize exactly: bitwise the same decode
    req = [Request(question="is there any sound ?")]
    assert q8.respond_batch(req)[0].nbest == base.respond_batch(req)[0].nbest
    jq8 = _jax(prefix, dcfg=BEAM, feature_transfer="int8")
    got = q8.respond_batch(_requests(feats, 2))
    want = jq8.respond_batch(_requests(feats, 2, JRequest))
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g.nbest],
                                   [s for _, s in w.nbest], atol=ATOL)


# -- AsyncServer -------------------------------------------------------------
@pytest.fixture(scope="module")
def async_session(bridged):
    prefix, feats, _ = bridged
    return _port(prefix, dcfg=dict(maxlen=6, beam=2, nbest=2,
                                   turn_batch=4)), feats


def test_async_server_continuous_batching(async_session):
    session, feats = async_session
    reqs = [Request(question=q, caption="a man reads a book",
                    features=feats) for q in QUESTIONS * 2]
    sync = [session.respond_batch([r])[0] for r in reqs]
    srv = AsyncServer(session, max_in_flight=2, max_wait_ms=300)
    futs = [srv.submit(r) for r in reqs]
    got = [f.result(timeout=300) for f in futs]
    srv.stop()
    for s, g in zip(sync, got):
        assert g[0] == s[0] and g.nbest == s.nbest
    assert srv.launches < len(reqs), srv.launches


def test_async_server_surfaces_errors(async_session):
    session, feats = async_session
    srv = AsyncServer(session, max_wait_ms=1.0)
    bad = Request(question="hello")
    bad.features = {"i3d_rgb": "not-an-array"}  # encode raises
    with pytest.raises(Exception):
        srv.submit(bad).result(timeout=120)
    ok = srv.respond(Request(question="is there any sound ?",
                             features=feats), timeout=120)
    srv.stop()
    assert isinstance(ok[0], str)


def test_async_server_survives_cancelled_future(async_session):
    session, feats = async_session
    srv = AsyncServer(session, max_wait_ms=200)
    futs = [srv.submit(r) for r in _requests(feats, 4)]
    cancelled = futs[2].cancel()  # may lose the race with the scheduler
    for i, f in enumerate(futs):
        if i == 2 and cancelled:
            assert f.cancelled()
            continue
        assert isinstance(f.result(timeout=300)[0], str)
    ok = srv.respond(Request(question="is it raining ?"), timeout=300)
    srv.stop()
    assert isinstance(ok[0], str)


def test_async_server_stop_submit_race_never_hangs(async_session):
    session, feats = async_session
    srv = AsyncServer(session, max_wait_ms=1.0)
    srv._stop.set()  # stop() wins the race
    fut = srv.submit(Request(question="is there any sound ?"))
    srv._thread.join(timeout=300)
    assert not srv._thread.is_alive()
    assert fut.done()
    try:
        assert isinstance(fut.result(timeout=0)[0], str)
    except RuntimeError as e:
        assert "stopped" in str(e)


def test_async_server_backpressure(async_session, monkeypatch):
    session, _ = async_session
    monkeypatch.setattr(AsyncServer, "_loop", lambda self: None)
    srv = AsyncServer(session, max_queue=2)
    r = Request(question="is there any sound ?")
    f1 = srv.submit(r)
    srv.submit(r)
    assert srv.queue_depth() == 2
    with pytest.raises(ServerOverloaded):
        srv.submit(r)
    srv._q.get_nowait()  # a launch frees a slot
    assert type(srv.submit(r)) is type(f1)
    assert srv.queue_depth() == 2


def test_async_server_deadline_shedding(async_session):
    session, _ = async_session
    srv = AsyncServer(session, max_wait_ms=1.0)
    fut = srv.submit(Request(question="hello",
                             deadline=time.monotonic() - 0.001))
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=120)
    rank_fut = srv.submit_rank(Request(question="hi ?",
                                       deadline=time.monotonic() - 0.001),
                               ["yes", "no"])
    with pytest.raises(DeadlineExceeded):
        rank_fut.result(timeout=120)
    assert srv.n_expired == 2
    ok = srv.respond(Request(question="is there any sound ?",
                             deadline=time.monotonic() + 600.0),
                     timeout=120)
    srv.stop()
    assert isinstance(ok[0], str)


def test_async_server_rank_batching(async_session):
    session, feats = async_session
    cands = ["he sits on the couch", "a dog walks", "no", "i am not sure"]
    reqs = _requests(feats)
    sync = [session.rank(r, cands) for r in reqs]
    sync_noeos = session.rank(reqs[0], cands, include_eos=False)
    sync_ans = session.respond_batch([reqs[0]])[0]
    srv = AsyncServer(session, max_in_flight=2, max_wait_ms=300)
    futs = [srv.submit_rank(r, cands) for r in reqs]
    fut_beam = srv.submit(reqs[0])
    fut_noeos = srv.submit_rank(reqs[0], cands, include_eos=False)
    got = [f.result(timeout=300) for f in futs]
    for s, g in zip(sync, got):
        assert [c for c, _, _ in g] == cands
        assert [r for _, _, r in g] == [r for _, _, r in s]
        np.testing.assert_allclose([x for _, x, _ in g],
                                   [x for _, x, _ in s], atol=1e-5)
    assert fut_beam.result(timeout=300).nbest == sync_ans.nbest
    assert [r for _, _, r in fut_noeos.result(timeout=300)] == \
        [r for _, _, r in sync_noeos]
    srv.stop()
    # 6 rank requests, cap 4, + a beam and a no-eos group
    assert srv.launches < len(reqs) + 2, srv.launches
    with pytest.raises(ValueError):
        srv.submit_rank(reqs[0], [])


def test_async_server_needs_a_beam_session(bridged):
    prefix, _, _ = bridged
    greedy = _port(prefix, dcfg=dict(maxlen=6, decode_style="greedy",
                                     turn_batch=2))
    assert greedy.respond_batch([Request(question="hi ?")])[0].nbest[0][1] \
        == 0.0
    with pytest.raises(ValueError, match="beam_search"):
        AsyncServer(greedy)


def test_async_server_in_flight_answers_as_one_at_a_time(bridged):
    """``max_in_flight`` 2 overlaps the batches and changes no answer:
    beam and rank requests through the decoder's program sets (run on
    the host here) give with 2 in flight what they give with 1, and what
    the session answers alone."""
    from mtn_tpu_torch.decode.graphs import GraphRunner
    prefix, feats, _ = bridged
    session = _port(prefix, dcfg=dict(maxlen=6, beam=2, nbest=2,
                                      turn_batch=4))
    session.decoder.graphs = GraphRunner(capture=False)
    session.decoder.graphed = lambda t: True
    cands = ["he sits on the couch", "a dog walks", "no"]
    reqs = [Request(question=q, caption="a man reads a book",
                    features=feats) for q in QUESTIONS * 2]
    runs = []
    for depth in (2, 1, 2):
        srv = AsyncServer(session, max_in_flight=depth, max_wait_ms=2000)
        try:
            futs = [srv.submit(r) for r in reqs] + \
                [srv.submit_rank(r, cands) for r in reqs[:4]]
            runs.append([f.result(timeout=300) for f in futs])
        finally:
            srv.stop()
    assert runs[0] == runs[1] == runs[2]
    assert session.decoder.graphs.captures >= 1
    alone = [session.respond_batch([r])[0] for r in reqs]
    assert [g.nbest for g in runs[0][:len(reqs)]] == [a.nbest for a in alone]
