"""The port's AOT artifact (``mtn_tpu_torch/utils/aot.py``) on the CPU, on
the JAX-trained ``served`` checkpoint dumped and imported into the port
(f32, both kernel flags on: the ops run their plain versions here):

- beam, greedy, sample, rank, stream and int8-fp-head artifacts against
  the live port ``ServingSession`` at the same frozen shapes, bit for
  bit; beam n-bests against JAX's live session, margin-aware;
- hermetic loading (checkpoint deleted, ``MTN`` refused, no model code
  or JAX in a fresh process), bucket chunking, the oversize errors;
- ``main export|info|run``, ``serve_http --aot``'s frozen flags, HTTP
  from the artifact (501 where a program is absent, ``"aot": true``),
  ``reload`` and the watcher on a re-export.
"""

import dataclasses
import json
import logging
import os
import shutil
import subprocess
import sys
import time
import urllib.request
from urllib.error import HTTPError

import numpy as np
import pytest
import torch

from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.serve import Request, ServingSession, encode_requests
from mtn_tpu_torch.utils.aot import AotSession, export_decode, main
from mtn_tpu_torch.utils.import_flax import import_flax
from tests.test_torch_serve import _dump_module
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEAM = dict(maxlen=6, beam=2, nbest=2, turn_batch=4)
SHAPES = dict(query_len=16, his_len=32, cap_len=16, frames=[8, 8])
KERNELS = {"use_pallas_attention": True, "use_pallas_ffn": True}
EPS = 0.05        # a robust n-best margin (tests/refpipe.py)
ATOL = 5e-5       # scores against JAX's session (tests/test_torch_serve.py)


@pytest.fixture(scope="module")
def bridged(served, tmp_path_factory):
    """The served JAX run's best checkpoint in the port's format."""
    prefix, feats = served
    root = tmp_path_factory.mktemp("aot_bridge")
    shutil.copytree(os.path.dirname(prefix), root / "exp")
    prefix = str(root / "exp" / os.path.basename(prefix))
    npz = str(root / "params.npz")
    assert _dump_module().dump(prefix + "_best", npz) == 1
    import_flax(npz, prefix)
    return prefix, feats


def _export(bridged, root, name, dcfg, **kw):
    """Export from a copy of the checkpoint, then delete the copy: every
    load of the artifact is hermetic."""
    prefix, _ = bridged
    src = root / f"{name}_ckpt"
    shutil.copytree(os.path.dirname(prefix), src)
    art = str(root / name)
    meta = export_decode(str(src / os.path.basename(prefix)) + "_best", art,
                         decode_cfg=DecodeConfig(**dcfg), device="cpu",
                         model_overrides=KERNELS,
                         **dict(SHAPES, **kw))
    shutil.rmtree(src)
    return art, meta


@pytest.fixture(scope="module")
def artifact(bridged, tmp_path_factory):
    """A beam artifact with row buckets 1 and 4, the rank programs and
    the stream programs; the live port session beside it."""
    root = tmp_path_factory.mktemp("aot")
    art, meta = _export(bridged, root, "rich", BEAM, batches=[1, 4],
                        rank=(6, 12))
    return art, meta, _live(bridged[0], BEAM)


@pytest.fixture(scope="module")
def session(artifact):
    """One session on the rich artifact: each program loads once."""
    return AotSession(artifact[0], device="cpu")


def _live(prefix, dcfg, **kw):
    return ServingSession.from_checkpoint(
        prefix + "_best", DecodeConfig(**dcfg), device="cpu",
        model_overrides=KERNELS, **kw)


def _requests(feats):
    return [Request(question="what is he doing ?", caption="a dog walks",
                    features=feats),
            Request(question="are there people ?",
                    history=[("what is it ?", "a cat")]),
            Request(question="is it raining ?")]


def _fitted(session, requests, rows, vocab_session):
    """The live host batch of ``requests`` at the artifact's frozen
    shapes (the session's own fit laws)."""
    s = vocab_session
    hb = encode_requests(requests, s.model_cfg, s.data_cfg, s.vocab,
                         pad_rows_to=rows)
    m = session.meta
    fit = [session._fit_features(f, n, T)
           for f, n, T in zip(hb.fts, hb.fts_len, m["frames"])]
    return dataclasses.replace(
        hb, query=session._fit_tokens(hb.query, m["query_len"], "query"),
        his=session._fit_tokens(hb.his, m["his_len"], "his"),
        cap=session._fit_tokens(hb.cap, m["cap_len"], "cap"),
        fts=[f for f, _ in fit], fts_len=[n for _, n in fit])


def _live_beam(session, live, requests):
    hb = _fitted(session, requests, session.buckets[-1], live)
    return [r.texts(live.vlist) for r in
            live.decoder.beam_batch(live.to_device(hb))]


# -- beam: the live port session, JAX's session ---------------------------------
def test_beam_artifact_is_the_live_session_bitwise(artifact, session, served):
    art, meta, live = artifact
    reqs = _requests(served[1])
    got = [r.nbest for r in session.respond_batch(reqs)]
    assert got == _live_beam(session, live, reqs)
    assert [r.nbest for r in session.respond_batch(reqs)] == got
    assert meta["device"] == "cpu" and meta["torch_version"]
    assert meta["batches"] == [1, 4] and meta["batch"] == 4


def test_beam_artifact_matches_jax_margin_aware(artifact, session, bridged):
    from mtn_tpu.config import DecodeConfig as JDecodeConfig
    from mtn_tpu.data.batching import HostBatch as JHostBatch
    from mtn_tpu.decode.beam import completions_to_results as jresults
    from mtn_tpu.serve import ServingSession as JSession
    from mtn_tpu.train.batch import device_batch as jdevice_batch
    prefix, feats = bridged
    art, _, live = artifact
    reqs = _requests(feats)
    got = [r.nbest for r in session.respond_batch(reqs)]
    # JAX's live decoder on the same frozen batch (the port's request
    # encoding is JAX's: tests/test_torch_serve.py)
    hb = vars(_fitted(session, reqs, 4, live))
    for k in ("query", "his", "cap"):
        hb[k] = hb[k].astype(np.int32)
    hb["fts_len"] = [n.astype(np.int32) for n in hb["fts_len"]]
    jsession = JSession.from_checkpoint(prefix + "_best",
                                        JDecodeConfig(**BEAM))
    raw = jsession.decoder.beam_batch_raw(jsession.params,
                                          jdevice_batch(JHostBatch(**hb)))
    want = [r.texts(jsession.vlist) for r in jresults(
        *(np.asarray(x) for x in raw[:3]), hb["valid"])]
    assert len(got) == len(want) == len(reqs)
    robust = 0
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=ATOL)
        margin = w[0][1] - w[1][1] if len(w) > 1 else np.inf
        if margin > EPS:
            robust += 1
            assert [a for a, _ in g] == [a for a, _ in w]
        else:
            assert g[0][0] in {a for a, s in w if w[0][1] - s <= EPS}
    assert robust * 2 >= len(reqs)


# -- hermetic loading, chunking, buckets ------------------------------------------
def test_artifact_is_hermetic(artifact, served, monkeypatch):
    from mtn_tpu_torch.models import mtn
    art, meta, _ = artifact
    assert sorted(os.listdir(art)) == sorted(
        ["conf.json", "meta.json", "vocab.json", "weights.pt",
         "decode_b1_prefix.pt2", "decode_b1_step.pt2",
         "decode_b4_prefix.pt2", "decode_b4_step.pt2", "rank_step.pt2",
         "stream_step_greedy.pt2", "stream_step_sample.pt2"])
    assert not os.path.exists(meta["model_arg"].rsplit("_", 1)[0]
                              + "_torch")

    def refuse(*args, **kw):
        raise AssertionError("an artifact's session built MTN")
    monkeypatch.setattr(mtn.MTN, "__init__", refuse)
    reqs = _requests(served[1])
    want = [r.nbest for r in AotSession(art, device="cpu").respond_batch(
        reqs[2:])]
    code = (
        "import json, sys\n"
        "from mtn_tpu_torch.utils.aot import AotSession\n"
        "from mtn_tpu_torch.serve import Request\n"
        f"s = AotSession({art!r}, device='cpu')\n"
        f"reqs = [Request(question=q, history=h) for q, h in "
        f"{[(r.question, r.history) for r in reqs[2:]]!r}]\n"
        "out = [r.nbest for r in s.respond_batch(reqs)]\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'mtn_tpu_torch.models', 'mtn_tpu.')) "
        "or n == 'mtn_tpu')\n"
        "print(json.dumps({'out': out, 'bad': bad}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert [[tuple(x) for x in nb] for nb in res["out"]] == want


def test_chunking_buckets_and_oversize(artifact, session):
    art, meta, live = artifact
    assert session.buckets == [1, 4]
    assert session._chunk_sizes(5) == [4, 1]
    assert session._chunk_sizes(1) == [1]
    assert session._chunk_sizes(9) == [4, 4, 1]
    reqs = [Request(question=f"is there a {w} ?")
            for w in ("dog", "cat", "man", "book", "couch", "sound")]
    out = session.respond_batch(reqs)      # 6 rows: two b4 chunks
    assert len(out) == 6
    one = session.respond_batch(reqs[:1])  # the b1 program
    assert [a for a, _ in one[0].nbest] == [a for a, _ in out[0].nbest]
    np.testing.assert_allclose([s for _, s in one[0].nbest],
                               [s for _, s in out[0].nbest], atol=1e-5)
    dup = session.respond_batch([reqs[0], reqs[5], reqs[0]])
    assert dup[0].nbest == dup[2].nbest
    assert {"decode_b1_prefix.pt2", "decode_b1_step.pt2",
            "decode_b4_prefix.pt2", "decode_b4_step.pt2"} <= \
        set(session._programs)   # loaded when first used
    with pytest.raises(ValueError, match="exceeds the exported"):
        session.respond_batch(
            [Request(question="why " * (meta["query_len"] + 4))])


def test_an_artifact_for_another_device_raises(artifact, tmp_path):
    art, _, _ = artifact
    work = str(tmp_path / "art")
    shutil.copytree(art, work)
    with open(os.path.join(work, "meta.json")) as f:
        m = json.load(f)
    m["device"] = "cuda"
    with open(os.path.join(work, "meta.json"), "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="exported for device 'cuda'"):
        AotSession(work, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            AotSession(art)


# -- rank and stream -------------------------------------------------------------------
def test_rank_matches_live(artifact, session, served):
    art, meta, live = artifact
    req = _requests(served[1])[0]
    cands = ["he sits on the couch", "a cat", "no"]
    for eos in (True, False):
        got = session.rank(req, cands, include_eos=eos)
        cand, clen = session.rank_tensors(cands, eos)
        db = live.to_device(_fitted(session, [req], 1, live))
        want = live.decoder._rank(db, cand, clen)[0, :len(cands)]
        assert [s for _, s, _ in got] == want.tolist()
        ranked = live.rank(req, cands, include_eos=eos)
        assert [r for _, _, r in got] == [r for _, _, r in ranked]
    with pytest.raises(ValueError, match="exceed the exported rank"):
        session.rank(req, ["x"] * 7)
    with pytest.raises(ValueError, match="rank length"):
        session.rank(req, ["is " * 12])


def test_stream_matches_live(artifact, session, bridged, served):
    art, meta, live = artifact
    assert meta["stream"]["styles"] == ["greedy", "sample"]
    reqs = _requests(served[1])
    for req in reqs[:2]:
        got = list(session.stream(req))                  # greedy
        assert got == list(live.stream(req, style="greedy"))
        db = live.to_device(_fitted(session, [req], 1, live))
        toks = live.decoder.greedy_batch(db)[0]
        assert got == [live.vlist[t] for t in toks]
    # sample: both at the same fold, each taking the next per call
    live2 = _live(bridged[0], BEAM)
    live2._sample_calls = session._sample_calls
    for _ in range(2):
        assert list(session.stream(reqs[0], style="sample")) == \
            list(live2.stream(reqs[0], style="sample"))
    with pytest.raises(ValueError, match="style"):
        list(session.stream(reqs[0], style="beam_search"))


def test_stream_runs_on_its_program_set(artifact, bridged, served):
    """``warmup(stream=True)`` builds a stream set a style; a stream runs
    on its style's set (a prefix replay and one step replay a token),
    the live stream's words, eager and through the live decoder's own
    stream set; one opened while another is open runs eagerly, counted;
    a closed stream gives the set back."""
    art, meta, live = artifact
    session = AotSession(art, device="cpu")
    session.warmup(stream=True)
    assert ("stream_greedy", 1) in session.sets
    assert ("stream_sample", 1) in session.sets
    req = _requests(served[1])[0]
    want = list(live.stream(req, style="greedy"))
    assert len(want) >= 2, "the stream must outlast a yield"
    graphed = _graphed_live(_live(bridged[0], BEAM))
    for _ in range(2):          # the shape's first stream runs eagerly
        assert list(graphed.stream(req)) == want
    assert graphed.decoder.graphs.captures == 1
    ps = session.sets[("stream_greedy", 1)]
    replays = ps.replays
    assert list(session.stream(req)) == want and not ps.held
    steps = min(len(want) + 1, meta["stream"]["maxlen"])
    assert ps.replays == replays + 1 + steps
    a = session.stream(req)
    first = next(a)
    assert ps.held
    assert list(session.stream(req)) == want
    assert session.eager_streams == 1
    assert [first, *a] == want and not ps.held
    a = session.stream(req)
    next(a)
    a.close()
    assert not ps.held and session.eager_streams == 1


# -- greedy, sample, int8 ----------------------------------------------------------
def test_cli_export_info_run_and_greedy_artifact(bridged, tmp_path, capsys,
                                                 monkeypatch):
    prefix, feats = bridged
    src = tmp_path / "ckpt"
    shutil.copytree(os.path.dirname(prefix), src)
    art = str(tmp_path / "greedy")
    # main sets up logging on the captured stream; later tests log too
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    assert main(["export", "--model",
                 str(src / os.path.basename(prefix)) + "_best", "--out", art,
                 "--batch", "2", "--query-len", "16", "--his-len", "32",
                 "--cap-len", "16", "--frames", "8,8", "--maxlen", "6",
                 "--decode-style", "greedy", "--stream", "0", "--device",
                 "cpu", "--use-pallas-attention", "1",
                 "--use-pallas-ffn", "1"]) == 0
    shutil.rmtree(src)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["style"] == "greedy" and out["batches"] == [2]
    assert main(["info", art]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["device"] == "cpu" and info["stream"] is None
    assert main(["run", art, "--question", "what is he doing ?",
                 "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 1 and set(lines[0]) == {"answer", "score"}

    session = AotSession(art, device="cpu")
    assert not hasattr(session, "rank") and not hasattr(session, "stream")
    reqs = _requests(feats)[:2]
    live = _live(prefix, dict(maxlen=6, decode_style="greedy",
                              turn_batch=2))
    got = [r.nbest for r in session.respond_batch(reqs)]
    db = live.to_device(_fitted(session, reqs, 2, live))
    assert got == [[(" ".join(live.vlist[t] for t in r), 0.0)]
                   for r in live.decoder.greedy_batch(db)]
    assert lines[0]["answer"] == session.respond("what is he doing ?")
    if not torch.cuda.is_available():   # the card is the default device
        for argv in (["run", art, "--question", "hi ?"],
                     ["export", "--model", prefix + "_best", "--out",
                      str(tmp_path / "none")]):
            with pytest.raises(RuntimeError, match="--device cpu"):
                main(argv)


def test_sample_artifact_draws_the_live_draws(bridged, tmp_path):
    prefix, feats = bridged
    dcfg = dict(maxlen=6, decode_style="sample", temperature=1.0, top_k=5,
                sample_seed=3, turn_batch=2)
    art, meta = _export(bridged, tmp_path, "sample", dcfg, batch=2,
                        stream=False)
    session = AotSession(art, device="cpu")
    live = _live(prefix, dcfg)
    reqs = _requests(feats)[:2]
    db = live.to_device(_fitted(session, reqs, 2, live))
    for fold in (0, 1):
        got = [r.nbest[0][0] for r in session.respond_batch(reqs)]
        want = [" ".join(live.vlist[t] for t in r)
                for r in live.decoder.sample_batch(db, fold=fold)]
        assert got == want
    assert session._sample_calls == 2


def test_int8_artifact_is_the_live_int8_session(bridged, served, tmp_path):
    prefix, feats = bridged
    dcfg = dict(BEAM, turn_batch=2)
    art, meta = _export(bridged, tmp_path, "int8", dcfg, batch=2,
                        stream=False, weights_quant="int8-fp-head")
    session = AotSession(art, device="cpu")
    assert session.weights_quant == meta["weights_quant"] == "int8-fp-head"
    live = _live(prefix, dcfg, weights_quant="int8-fp-head")
    reqs = _requests(feats)[:2]
    got = [r.nbest for r in session.respond_batch(reqs)]
    assert got == _live_beam(session, live, reqs)


# -- serve_http --aot --------------------------------------------------------------------
@pytest.mark.parametrize("flags", [
    ["--beam", "10"], ["--turn-batch", "4"], ["--feature-transfer", "int8"],
    ["--mesh-model", "2"], ["--maxlen", "10"], ["--use-pallas-ffn", "1"],
    ["--decode-style", "greedy"]])
def test_serve_http_refuses_frozen_flags(flags, capsys):
    from mtn_tpu_torch.serve_http import main as http_main
    with pytest.raises(SystemExit) as ei:
        http_main(["--aot", "some/dir", "--device", "cpu"] + flags)
    assert ei.value.code == 2
    assert "frozen in the AOT artifact" in capsys.readouterr().err


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read().decode()
        return r.status, (json.loads(body) if r.headers["Content-Type"]
                          == "application/json" else body)


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


def test_http_serves_the_artifact(artifact, session, served):
    from mtn_tpu_torch.serve_http import start_server
    art, meta, _ = artifact
    reqs = _requests(served[1])
    direct = session.respond_batch(reqs)
    stream_want = list(session.stream(reqs[1]))
    srv = start_server(session, port=0)
    try:
        base = "http://%s:%d" % srv.server_address
        assert srv.async_server is None
        code, out = _post(base, "/v1/respond", {
            "question": reqs[0].question, "caption": reqs[0].caption,
            "features": {k: v.tolist() for k, v in served[1].items()},
            "nbest": 2})
        assert code == 200 and (out["answer"], out["score"]) == \
            tuple(direct[0])
        code, out = _post(base, "/v1/respond_batch", {"requests": [
            {"question": r.question, "history": [list(t) for t in
                                                 r.history]}
            for r in reqs[1:]]})
        assert [(d["answer"], d["score"]) for d in out["results"]] == \
            [tuple(r) for r in direct[1:]]
        code, out = _post(base, "/v1/rank", {
            "question": "is it raining ?", "candidates": ["a cat", "no"]})
        assert code == 200 and {c["rank"] for c in out["candidates"]} == \
            {1, 2}
        code, text = _post(base, "/v1/stream", {
            "question": reqs[1].question,
            "history": [list(t) for t in reqs[1].history]})
        events = [json.loads(ln[6:]) for ln in text.splitlines()
                  if ln.startswith("data: ")]
        assert [e["token"] for e in events[:-1]] == stream_want
        stats = _get(base, "/stats")
        assert stats["aot"] is True and stats["turn_batch"] == 4
        assert stats["epoch"] == meta["epoch"]
        assert stats["model"] and "/" not in stats["model"]
        code, out = _post(base, "/admin/reload", {})
        assert code == 200 and out == {"ok": True, "epoch": meta["epoch"]}
    finally:
        srv.close()


def test_http_answers_501_for_absent_programs(artifact, tmp_path):
    """An artifact without the rank and stream programs (their files and
    meta entries removed) answers 501 there, counted apart from errors."""
    from mtn_tpu_torch.serve_http import start_server
    art, _, _ = artifact
    work = str(tmp_path / "art")
    shutil.copytree(art, work)
    with open(os.path.join(work, "meta.json")) as f:
        m = json.load(f)
    m["rank"] = m["stream"] = None
    with open(os.path.join(work, "meta.json"), "w") as f:
        json.dump(m, f)
    srv = start_server(AotSession(work, device="cpu"), port=0)
    try:
        base = "http://%s:%d" % srv.server_address
        for path, payload in [
                ("/v1/rank", {"question": "hi ?", "candidates": ["a"]}),
                ("/v1/stream", {"question": "hi ?"})]:
            with pytest.raises(HTTPError) as ei:
                _post(base, path, payload)
            assert ei.value.code == 501
            assert "export" in json.loads(ei.value.read())["error"]
        stats = _get(base, "/stats")
        assert stats["unsupported"] == 2 and stats["errors"] == 0
    finally:
        srv.close()


def test_reload_and_watcher_follow_a_reexport(artifact, tmp_path):
    from mtn_tpu_torch.serve_http import start_server, start_watcher
    art, meta, _ = artifact
    work = str(tmp_path / "art")
    shutil.copytree(art, work)
    session = AotSession(work, device="cpu")
    first = session.export_id
    assert first == meta["export_id"]
    out0 = session.respond(question="is it raining ?")
    assert session.reload() == meta["epoch"]
    assert hasattr(session, "rank") and hasattr(session, "stream")
    assert session._programs == {}   # the reloaded artifact's, on use
    srv = start_server(session, port=0)
    try:
        start_watcher(srv, 0.2)
        with open(os.path.join(work, "meta.json")) as f:
            m = json.load(f)
        m["export_id"] = "feedfacecafe" + m["export_id"][12:]
        with open(os.path.join(work, "meta.json"), "w") as f:
            json.dump(m, f)
        deadline = time.time() + 60
        while srv.session.export_id == first and time.time() < deadline:
            time.sleep(0.1)
        assert srv.session.export_id.startswith("feedfacecafe")
        assert srv.session.respond(question="is it raining ?") == out0
        with srv._count_lock:
            assert srv.n_reloads >= 1
    finally:
        srv.close()


def _graphed_live(live):
    """``live``'s decoder taking its program sets for CPU tensors, run on
    the host."""
    from mtn_tpu_torch.decode.graphs import GraphRunner
    live.decoder.graphs = GraphRunner(capture=False)
    live.decoder.graphed = lambda t: True
    return live


def test_warmup_builds_a_program_set_a_bucket(artifact, bridged, served):
    """``warmup`` builds the set of every row bucket and the rank shape;
    each chunk of a burst is then one launch of its bucket's loop, and
    the answers are the live session's through its own program sets,
    bit for bit, ranks too."""
    art, meta, _ = artifact
    session = AotSession(art, device="cpu")
    assert not session.sets
    session.warmup()
    assert sorted(session.sets) == [("beam", 1), ("beam", 4), ("rank", 1)]
    assert all(not ps.capture for ps in session.sets.values())
    reqs = (_requests(served[1]) * 2)[:5]             # chunks of 4 and 1
    before = {k: ps.launches for k, ps in session.sets.items()}
    got = [r.nbest for r in session.respond_batch(reqs)]
    assert {k: ps.launches - before[k] for k, ps in session.sets.items()} \
        == {("beam", 1): 1, ("beam", 4): 1, ("rank", 1): 0}
    live = _graphed_live(_live(bridged[0], BEAM))
    want = []
    for chunk, rows in ((reqs[:4], 4), (reqs[4:], 1)):
        db = live.to_device(_fitted(session, chunk, rows, live))
        for _ in range(2):        # the shape's first batch runs eagerly
            raws = live.decoder.beam_batch_raw(db)
        want += [r.texts(live.vlist)
                 for r in live.decoder.beam_results(raws, db.valid)]
    assert got == want
    cands = ["he sits on the couch", "a cat", "no"]
    cand, clen = session.rank_tensors(cands, True)
    db = live.to_device(_fitted(session, reqs[:1], 1, live))
    for _ in range(2):            # the shape's first batch runs eagerly
        scores = live.decoder._rank(db, cand, clen)[0, :len(cands)]
    assert [s for _, s, _ in session.rank(reqs[0], cands)] == \
        scores.tolist()
    assert session.sets[("rank", 1)].launches == 1


@pytest.mark.parametrize("style", ["greedy", "sample"])
def test_token_program_sets_are_the_live_decode(bridged, tmp_path, style):
    """A greedy or sampled artifact's program set answers as the live
    decoder's eager loop and its program set, bit for bit, fold after
    fold."""
    prefix, feats = bridged
    dcfg = dict(maxlen=6, decode_style=style, temperature=1.0, top_k=5,
                sample_seed=3, turn_batch=2)
    art, _ = _export(bridged, tmp_path, style, dcfg, batch=2, stream=False)
    session = AotSession(art, device="cpu")
    session.warmup()                                  # fold 0 for sample
    assert list(session.sets) == [("tokens", 2)]
    live = _live(prefix, dcfg)
    reqs = _requests(feats)[:2]
    db = live.to_device(_fitted(session, reqs, 2, live))
    graphed = _graphed_live(_live(prefix, dcfg))
    for fold in (1, 2):
        got = [r.nbest[0][0] for r in session.respond_batch(reqs)]
        eager = (live.decoder.sample_batch(db, fold=fold) if style ==
                 "sample" else live.decoder.greedy_batch(db))
        sets = (graphed.decoder.sample_batch(db, fold=fold) if style ==
                "sample" else graphed.decoder.greedy_batch(db))
        assert sets == eager
        assert got == [" ".join(live.vlist[t] for t in r) for r in eager]
    assert session.sets[("tokens", 2)].launches == 3
