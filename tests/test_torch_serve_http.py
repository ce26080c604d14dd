"""The port's HTTP front end over loopback sockets, on a port-format
checkpoint on the CPU (``--device cpu``): every route of
``mtn_tpu_torch/serve_http.py``, with the cases of
``tests/test_serve_http.py``, and HTTP answers equal to the session's
own."""

import base64
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mtn_tpu.config import DataConfig as JDataConfig
from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.data.vocab import get_vocabulary
from mtn_tpu_torch.serve import (DeadlineExceeded, Request,
                                 ServerOverloaded, ServingSession,
                                 encode_requests)
from mtn_tpu_torch.serve_http import (BadRequest, main, parse_request,
                                      start_server, start_watcher)
from mtn_tpu_torch.weights import (from_flax, load_checkpoint,
                                   save_checkpoint, save_conf)
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import one_thread, seeded_params  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEAM = dict(maxlen=6, beam=2, nbest=2, turn_batch=4)


def _post(url, payload, timeout=300, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get_text(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _code(fn, *args):
    """The HTTP status of a call expected to fail."""
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn(*args)
    return ei.value.code


@pytest.fixture(scope="module")
def checkpoint(tiny_corpus, tmp_path_factory):
    """A port-format checkpoint of the tiny config with seeded weights:
    (prefix, features by stream)."""
    c = tiny_corpus
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    cfg = tiny_model_cfg(len(vocab), c.ft_dims, dropout=0.0)
    prefix = str(tmp_path_factory.mktemp("serve_http") / "mtn")
    save_conf(prefix, vocab, model=cfg, data=JDataConfig(
        fea_type=list(c.fea_types), include_caption="caption,summary",
        separate_caption=True, length_bucket=8, feature_bucket=4))
    save_checkpoint(prefix, 1, from_flax(seeded_params(cfg, seed=3,
                                                       gen_scale=6.0)))
    rng = np.random.default_rng(0)
    feats = {ft: rng.standard_normal((5, d)).astype(np.float32)
             for ft, d in zip(c.fea_types, c.ft_dims)}
    return prefix, feats


def _session(prefix, **kw):
    return ServingSession.from_checkpoint(
        prefix + "_best", DecodeConfig(**kw.pop("dcfg", BEAM)),
        device="cpu", **kw)


@pytest.fixture(scope="module")
def http_server(checkpoint):
    prefix, feats = checkpoint
    srv = start_server(_session(prefix), port=0, max_wait_ms=150.0)
    yield srv, "http://%s:%d" % srv.server_address, feats
    srv.close()


def _lists(feats):
    return {k: v.tolist() for k, v in feats.items()}


def test_healthz_and_stats(http_server):
    srv, base, _ = http_server
    assert _get(base + "/healthz") == (200, {"ok": True})
    code, stats = _get(base + "/stats")
    assert code == 200
    assert stats["decode_style"] == "beam_search"
    assert stats["turn_batch"] == 4 and stats["uptime_s"] >= 0
    assert stats["model"] == "mtn_best" and stats["epoch"] == 1
    assert stats["aot"] is False


@pytest.mark.parametrize("quant", ["", "int8-fp-head"])
def test_respond_equals_the_session(checkpoint, quant):
    """/v1/respond answers what the session's own respond_batch answers
    for the same request, bit for bit (full precision and int8)."""
    prefix, feats = checkpoint
    session = _session(prefix, weights_quant=quant)
    srv = start_server(session, port=0, max_wait_ms=1.0)
    try:
        base = "http://%s:%d" % srv.server_address
        payload = {"question": "is there any sound ?",
                   "history": [["what is he doing ?", "he sits on it"]],
                   "caption": "a man sits on a couch reading a book",
                   "features": _lists(feats), "nbest": 2}
        code, out = _post(base + "/v1/respond", payload)
        want = session.respond_batch([parse_request(payload)])[0]
        assert code == 200
        assert (out["answer"], out["score"]) == (want[0], want[1])
        assert out["nbest"] == [{"answer": a, "score": s}
                                for a, s in want.nbest]
        assert _post(base + "/v1/respond", payload)[1] == out
    finally:
        srv.close()


def test_respond_npy_b64_features(http_server):
    srv, base, feats = http_server

    def b64(a):
        buf = io.BytesIO()
        np.save(buf, a)
        return {"npy_b64": base64.b64encode(buf.getvalue()).decode()}

    q = {"question": "are there people in the video ?"}
    assert (_post(base + "/v1/respond", dict(q, features=_lists(feats)))[1]
            == _post(base + "/v1/respond", dict(q, features={
                k: b64(v) for k, v in feats.items()}))[1])


def test_concurrent_requests_batch_together(http_server):
    srv, base, feats = http_server
    payload = {"question": "what is the person doing ?",
               "features": _lists(feats)}
    before = srv.async_server.launches
    results, errs = [None] * 4, []

    def call(i):
        try:
            results[i] = _post(base + "/v1/respond", payload)
        except Exception as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not errs and not any(t.is_alive() for t in ts)
    assert all(r is not None and r[0] == 200 for r in results)
    assert len({r[1]["answer"] for r in results}) == 1
    assert srv.async_server.launches - before < 4


def test_respond_batch_endpoint(http_server):
    srv, base, feats = http_server
    reqs = [{"question": "is it raining ?"},
            {"question": "is there any sound ?", "features": _lists(feats)}]
    code, out = _post(base + "/v1/respond_batch", {"requests": reqs})
    assert code == 200 and len(out["results"]) == 2
    want = srv.session.respond_batch([parse_request(r) for r in reqs])
    assert [r["answer"] for r in out["results"]] == [a for a, _ in want]


def test_http_error_codes(http_server):
    srv, base, _ = http_server
    bad_json = urllib.request.Request(base + "/v1/respond", data=b"{nope",
                                      method="POST")
    assert _code(urllib.request.urlopen, bad_json) == 400
    assert _code(_post, base + "/v1/respond", {"caption": "a man"}) == 400
    assert _code(_post, base + "/v1/respond",
                 {"question": "hm ?", "features": {"i3d_rgb": [1.0]}}) == 400
    assert _code(_post, base + "/v1/oops", {"question": "hm ?"}) == 404
    assert _code(_get, base + "/nope") == 404
    assert _code(_post, base + "/v1/respond_batch", {"requests": []}) == 400
    assert _get(base + "/healthz")[0] == 200
    assert _get(base + "/stats")[1]["errors"] >= 4


def test_keep_alive_connection_reuse(http_server):
    import http.client
    srv, _, _ = http_server
    conn = http.client.HTTPConnection(*srv.server_address, timeout=300)
    try:
        body = json.dumps({"question": "hm ?"})
        headers = {"Content-Type": "application/json"}
        conn.request("POST", "/v1/oops", body=body, headers=headers)
        r1 = conn.getresponse()
        assert r1.status == 404
        r1.read()
        conn.request("POST", "/v1/respond", body=body, headers=headers)
        r2 = conn.getresponse()
        assert r2.status == 200
        assert isinstance(json.loads(r2.read())["answer"], str)
    finally:
        conn.close()


def test_greedy_session_lock_path(checkpoint):
    prefix, feats = checkpoint
    session = _session(prefix, dcfg=dict(maxlen=6, decode_style="greedy",
                                         turn_batch=4))
    srv = start_server(session, port=0)
    try:
        base = "http://%s:%d" % srv.server_address
        assert srv.async_server is None
        payload = {"question": "is there any sound ?",
                   "features": _lists(feats)}
        code, out = _post(base + "/v1/respond", payload)
        assert code == 200
        assert out["answer"] == session.respond_batch(
            [parse_request(payload)])[0][0]
        assert _get(base + "/stats")[1]["launches"] is None
    finally:
        srv.close()


def test_parse_request_validation():
    for bad in ([], {"question": ""}, {"question": "q",
                                       "history": [["only-q"]]},
                {"question": "q", "caption": 3},
                {"question": "q", "features": {"x": {"b": 1}}},
                {"question": "q", "deadline_ms": True}):
        with pytest.raises(BadRequest):
            parse_request(bad)
    r = parse_request({"question": "q", "history": [["a", "b"]],
                       "features": {"x": [[1, 2], [3, 4]],
                                    "y": [[[1], [2]], [[3], [4]]]}})
    assert r.features["x"].shape == (2, 2)
    assert r.features["y"].shape == (2, 2, 1)


def test_admin_reload_endpoint(http_server):
    srv, base, _ = http_server
    status, out = _post(base + "/admin/reload", {})
    assert (status, out) == (200, {"ok": True, "epoch": 1})
    status, out = _post(base + "/v1/respond",
                        {"question": "is there any sound ?"})
    assert status == 200 and isinstance(out["answer"], str)
    assert _code(_post, base + "/admin/reload",
                 {"model": "/no/such/prefix_best"}) == 400
    assert _get(base + "/healthz")[0] == 200


def test_metrics_endpoint_and_latency_stats(http_server):
    srv, base, _ = http_server
    _post(base + "/v1/respond", {"question": "is there any sound ?"})
    code, stats = _get(base + "/stats")
    lat = stats["latency"]
    assert code == 200 and lat["count"] >= 1
    assert lat["mean_ms"] > 0 and lat["p50_ms"] > 0
    assert lat["p90_ms"] >= lat["p50_ms"]
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    lines = text.splitlines()
    metrics = {l.split(" ")[0]: l.split(" ")[1] for l in lines
               if l and not l.startswith("#") and "{" not in l.split(" ")[0]}
    assert int(metrics["mtn_requests_total"]) == stats["requests"]
    assert int(metrics["mtn_errors_total"]) == stats["errors"]
    assert int(metrics["mtn_launches_total"]) >= 1
    assert float(metrics["mtn_uptime_seconds"]) > 0
    assert int(metrics["mtn_request_latency_seconds_count"]) == lat["count"]
    buckets = [l for l in lines
               if l.startswith("mtn_request_latency_seconds_bucket")]
    counts = [int(l.rsplit(" ", 1)[1]) for l in buckets]
    assert counts == sorted(counts) and 'le="+Inf"' in buckets[-1]
    assert counts[-1] == lat["count"]


def _events(base, body):
    req = urllib.request.Request(
        base + "/v1/stream", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "text/event-stream"
        return [json.loads(l.decode().strip()[len("data: "):]) for l in r
                if l.decode().strip().startswith("data: ")]


def test_stream_endpoint_sse(http_server):
    """Tokens as Server-Sent Events, then the joined answer: the greedy
    decode of the same request, twice alike."""
    srv, base, feats = http_server
    body = {"question": "is there any sound ?", "features": _lists(feats)}
    events = _events(base, body)
    assert events and events[-1].get("done") is True
    tokens = [e["token"] for e in events[:-1]]
    assert events[-1]["answer"] == " ".join(tokens)
    session = srv.session
    db = session.to_device(encode_requests(
        [parse_request(body)], session.model_cfg, session.data_cfg,
        session.vocab, session._lb, session._fb, pad_rows_to=4))
    greedy = session.decoder.greedy_batch(db)[0]
    assert tokens == [session.vlist[t] for t in greedy]
    assert _events(base, body) == events
    assert _code(_post, base + "/v1/stream",
                 {"question": "x", "style": "beam"}) == 400


def test_admin_token_gate(checkpoint):
    prefix, _ = checkpoint
    srv = start_server(_session(prefix, dcfg=dict(BEAM, turn_batch=2)),
                       port=0, admin_token="sekrit")
    base = "http://%s:%d" % srv.server_address
    try:
        assert _code(_post, base + "/admin/reload", {}) == 400
        status, out = _post(base + "/admin/reload", {},
                            headers={"Authorization": "Bearer sekrit"})
        assert status == 200 and out["ok"] is True
        assert _post(base + "/v1/respond", {"question": "hi ?"})[0] == 200
    finally:
        srv.close()


def test_drain_and_resume(http_server):
    srv, base, _ = http_server
    try:
        status, out = _post(base + "/admin/drain", {})
        assert (status, out["draining"]) == (200, True)
        assert _code(_get, base + "/healthz") == 503
        assert _code(_post, base + "/v1/respond", {"question": "x"}) == 503
        assert _code(_post, base + "/v1/stream", {"question": "x"}) == 503
        code, stats = _get(base + "/stats")
        assert code == 200 and stats["draining"] is True
        assert stats["rejected"] >= 2
        assert "mtn_draining 1" in _get_text(base + "/metrics")
    finally:
        status, out = _post(base + "/admin/drain", {"resume": True})
    assert (status, out["draining"]) == (200, False)
    assert _get(base + "/healthz") == (200, {"ok": True})
    assert _post(base + "/v1/respond", {"question": "is it ?"})[0] == 200


def test_overload_maps_to_503_with_retry_after(http_server):
    srv, base, _ = http_server

    def overloaded(req):
        raise ServerOverloaded("decode queue full (1 requests waiting)")

    srv.respond_one = overloaded  # shadow the bound method
    try:
        before = srv.stats()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/v1/respond", {"question": "x"})
        assert ei.value.code == 503
        assert ei.value.headers["Retry-After"] == "1"
        assert "queue full" in json.loads(ei.value.read())["error"]
        after = srv.stats()
        assert after["rejected"] == before["rejected"] + 1
        assert after["errors"] == before["errors"]
    finally:
        del srv.respond_one
    assert _post(base + "/v1/respond", {"question": "is it ?"})[0] == 200


def test_checkpoint_watcher_hot_reloads(checkpoint, tmp_path):
    prefix, _ = checkpoint
    shutil.copytree(os.path.dirname(prefix), tmp_path / "exp")
    prefix = str(tmp_path / "exp" / os.path.basename(prefix))
    session = _session(prefix, dcfg=dict(BEAM, turn_batch=2))
    srv = start_server(session, port=0)
    try:
        assert session.epoch == 1
        stop = start_watcher(srv, interval_s=0.1)
        bumped = {k: v + 0.01 for k, v in load_checkpoint(prefix)[0].items()}
        save_checkpoint(prefix, 2, bumped)  # a new best epoch lands
        deadline = time.time() + 120
        while session.epoch != 2 and time.time() < deadline:
            time.sleep(0.1)
        assert session.epoch == 2, "watcher did not pick up epoch 2"
        for k, v in session.model.state_dict().items():
            assert torch.equal(v, bumped[k])
        assert srv.stats()["epoch"] == 2 and srv.n_reloads == 1
        stop.set()
    finally:
        srv.close()


def test_respond_nbest_over_http(http_server):
    srv, base, _ = http_server
    code, out = _post(base + "/v1/respond",
                      {"question": "is there any sound ?", "nbest": 2})
    assert code == 200
    assert out["nbest"][0] == {"answer": out["answer"],
                               "score": out["score"]}
    assert 1 <= len(out["nbest"]) <= 2
    plain = _post(base + "/v1/respond",
                  {"question": "is there any sound ?"})[1]
    assert "nbest" not in plain
    code, bout = _post(base + "/v1/respond_batch",
                       {"requests": [{"question": "is it raining ?"}],
                        "nbest": 2})
    assert code == 200 and "nbest" in bout["results"][0]
    assert _code(_post, base + "/v1/respond",
                 {"question": "x", "nbest": 0}) == 400


def test_deadline_ms_over_http(http_server):
    srv, base, _ = http_server
    _, stats0 = _get(base + "/stats")
    assert _code(_post, base + "/v1/respond",
                 {"question": "is there any sound ?",
                  "deadline_ms": 0.01}) == 504
    code, out = _post(base + "/v1/respond",
                      {"question": "is there any sound ?",
                       "deadline_ms": 600000})
    assert code == 200 and isinstance(out["answer"], str)
    assert _code(_post, base + "/v1/respond",
                 {"question": "x ?", "deadline_ms": -5}) == 400
    _, stats1 = _get(base + "/stats")
    assert stats1["expired"] >= stats0["expired"] + 1
    assert stats1["errors"] == stats0["errors"] + 1
    assert "mtn_expired_total" in _get_text(base + "/metrics")


def test_respond_batch_mixed_deadlines_per_row(http_server):
    srv, base, _ = http_server
    _, stats0 = _get(base + "/stats")
    code, out = _post(base + "/v1/respond_batch", {"requests": [
        {"question": "is there any sound ?", "deadline_ms": 600000},
        {"question": "what is he doing ?", "deadline_ms": 0.01}]})
    rows = out["results"]
    assert code == 200
    assert isinstance(rows[0]["answer"], str) and "error" not in rows[0]
    assert rows[1]["code"] == 504 and "answer" not in rows[1]
    assert _code(_post, base + "/v1/respond_batch", {"requests": [
        {"question": "x ?", "deadline_ms": 0.01},
        {"question": "y ?", "deadline_ms": 0.01}]}) == 504
    _, stats1 = _get(base + "/stats")
    assert stats1["expired"] >= stats0["expired"] + 3
    assert stats1["errors"] == stats0["errors"]
    # the lock path (no AsyncServer) keeps the per-row law
    saved, srv.async_server = srv.async_server, None
    try:
        live = Request(question="is there any sound ?")
        dead = Request(question="x ?", deadline=time.monotonic() - 1)
        got = srv.respond_many([dead, live])
        assert isinstance(got[0], DeadlineExceeded)
        assert isinstance(got[1][0], str)
        with pytest.raises(DeadlineExceeded):
            srv.respond_many([dead, dead])
    finally:
        srv.async_server = saved


def test_rank_endpoint(http_server):
    srv, base, _ = http_server
    body = {"question": "what is he doing ?",
            "caption": "a man sits on a couch",
            "candidates": ["he sits on the couch", "a dog walks", "yes"]}
    code, out = _post(base + "/v1/rank", body)
    got = out["candidates"]
    assert code == 200
    assert [g["answer"] for g in got] == body["candidates"]
    scores = [g["logp"] for g in got]
    for i, g in enumerate(got):
        assert g["rank"] == 1 + sum(1 for j, s in enumerate(scores)
                                    if j != i and s > scores[i])
    direct = srv.session.rank(Request(question=body["question"],
                                      caption=body["caption"]),
                              body["candidates"])
    assert scores == pytest.approx([s for _, s, _ in direct], abs=1e-6)
    for bad in ({"question": "hi ?"},
                {"question": "hi ?", "candidates": []},
                {"question": "hi ?", "candidates": ["ok"],
                 "include_eos": "yes"}):
        assert _code(_post, base + "/v1/rank", bad) == 400, bad


def test_setup_logging_wins_over_import_side_effects():
    import logging

    import mtn_tpu_torch.serve_http  # noqa: F401
    from mtn_tpu_torch.cli.common import setup_logging
    setup_logging(0)
    root = logging.getLogger()
    assert root.getEffectiveLevel() <= logging.INFO
    assert len(root.handlers) == 1


def test_main_refuses_aot_and_a_missing_gpu(checkpoint, tmp_path, capsys):
    prefix, _ = checkpoint
    # --aot is ported: a missing artifact raises, a frozen flag is an
    # argparse error
    with pytest.raises(FileNotFoundError, match="meta.json"):
        main(["--aot", str(tmp_path / "artifact"), "--device", "cpu"])
    with pytest.raises(SystemExit) as ei:
        main(["--aot", str(tmp_path / "artifact"), "--beam", "3"])
    assert ei.value.code == 2
    assert "frozen in the AOT artifact" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="ROADMAP: parallel"):
        main(["--model", prefix + "_best", "--device", "cpu",
              "--mesh-data", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--model", prefix + "_best"])


def test_http_cli_main_end_to_end(checkpoint):
    """``python -m mtn_tpu_torch.serve_http --device cpu`` boots with
    --warmup, announces its address, serves, and exits 0 on SIGINT."""
    prefix, _ = checkpoint
    proc = subprocess.Popen(
        [sys.executable, "-m", "mtn_tpu_torch.serve_http",
         "--model", prefix + "_best", "--device", "cpu", "--host",
         "127.0.0.1", "--port", "0", "--beam", "2", "--nbest", "2",
         "--maxlen", "6", "--turn-batch", "2", "--warmup", "--max-queue",
         "64", "--weights-quant", "int8", "--feature-transfer", "int8",
         "--use-pallas-attention", "1", "--use-pallas-ffn", "1"],
        cwd=REPO, stderr=subprocess.PIPE, text=True)
    base = None
    try:
        warmed = False
        for line in proc.stderr:
            warmed |= "warmup" in line
            m = re.search(r"serving .* on (http://[0-9.]+:[0-9]+)", line)
            if m:
                base = m.group(1)
                break
        assert base, "server exited before announcing its address"
        assert warmed, "--warmup did not run before the socket opened"
        code, out = _post(base + "/v1/respond",
                          {"question": "is there any sound ?", "nbest": 2})
        assert code == 200 and len(out["nbest"]) >= 1
        assert _get(base + "/healthz") == (200, {"ok": True})
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert rc == 0
