"""Serving under a (data, model) mesh: ``python -m mtn_tpu_torch.serve_http
--multihost ... --mesh-data D --mesh-model M`` as two gloo ranks on the
CPU, held against the port's one process and ``mtn_tpu``'s
``ServingSession`` under the same mesh of JAX's CPU devices.

One module fixture writes a seeded checkpoint on the tiny corpus and
starts three worlds at once: 2x1, 1x2 and 1x2 with int8 weights. Rank 0
of each serves HTTP and rank 1 follows it. Each rank runs in a directory
of its own whose ``ckpt/`` holds the same epoch 1; only rank 0's also
holds an epoch 2, so a reload of ``ckpt/mtn_2`` fails on rank 1 alone.
The traffic: two 4-request batches (``turn_batch``), one rank request,
one greedy stream, three malformed requests, the refused reload, the
first batch again, a reload of the served checkpoint; then SIGINT to
rank 0.

Tolerances: 2x1 runs each row as one process does, so its answers,
scores, rank log-probs and stream are bitwise one process's; 1x2 sums
its row-parallel products over the ranks in another order, so it is held
margin-aware with scores within 1e-5, as ``tests/test_torch_distributed.
py`` holds its decodes; JAX's session margin-aware (``tests/refpipe.py``)
with scores within 5e-5 and rank log-probs within 1e-4, as
``tests/test_torch_serve.py``.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from mtn_tpu_torch.config import DataConfig, DecodeConfig
from mtn_tpu_torch.data.vocab import get_vocabulary
from mtn_tpu_torch.serve import AsyncServer, ServingSession
from mtn_tpu_torch.serve_http import _result_json, parse_request
from mtn_tpu_torch.weights import from_flax, save_checkpoint, save_conf
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import one_thread, port_cfg, seeded_params  # noqa

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = {"2x1": ["--mesh-data", "2"],
          "1x2": ["--mesh-model", "2"],
          "1x2-int8": ["--mesh-model", "2", "--weights-quant", "int8"]}
DECODE = dict(beam=2, nbest=2, maxlen=5, turn_batch=4, penalty=1.0)
EPS = 0.05          # a robust n-best margin (tests/refpipe.py)
ATOL = 1e-5         # a mesh's scores against one process's (f32 sums)
JAX_ATOL = 5e-5     # against JAX's session: the whole-model tolerance
RANK_ATOL = 1e-4    # JAX's rank log-probs per option
CANDIDATES = ["yes there is", "no", "a man is talking to the camera",
              "i can not tell"]


def _bodies(c):
    """/v1/respond bodies: the last turn of 8 dialogs of the corpus, with
    their history, caption and both feature streams."""
    dialogs = []
    for path in (c.train_set, c.test_set):
        with open(path) as f:
            dialogs += json.load(f)["dialogs"]
    out = []
    for d in dialogs[:8]:
        feats = {ft: np.load(c.fea_path.replace("<FeaType>", ft).replace(
            "<ImageID>", d["image_id"])).tolist() for ft in c.fea_types}
        out.append({"question": d["dialog"][-1]["question"],
                    "history": [[t["question"], t["answer"]]
                                for t in d["dialog"][:-1]],
                    "caption": d["caption"], "features": feats})
    return out


def _http(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=(
        "GET" if data is None else "POST"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, text = e.code, e.read().decode()
    try:
        return code, json.loads(text)
    except json.JSONDecodeError:
        return code, text


def _events(text):
    return [json.loads(line[len("data: "):]) for line in text.splitlines()
            if line.startswith("data: ")]


def _traffic(base, bodies, mesh: bool):
    """The fixture's requests against one server; what each returned."""
    out = {}
    for i in (0, 1):
        out[f"batch{i}"] = _http(base, "/v1/respond_batch", {
            "requests": bodies[4 * i:4 * i + 4], "nbest": 2})
    out["rank"] = _http(base, "/v1/rank",
                        dict(bodies[0], candidates=CANDIDATES))
    out["stream"] = _http(base, "/v1/stream", bodies[1])
    if mesh:
        out["concurrent"] = _concurrent(base, bodies)
    out["malformed"] = [
        _http(base, "/v1/respond", {"question": ""})[0],
        _http(base, "/v1/rank", dict(bodies[0], candidates=[]))[0],
        _http(base, "/v1/stream", dict(bodies[1], style="beam"))[0]]
    if mesh:
        out["refused_reload"] = _http(base, "/admin/reload",
                                      {"model": "ckpt/mtn_2"})
        out["after_refusal"] = _http(base, "/v1/respond_batch", {
            "requests": bodies[:4], "nbest": 2})
        out["reload"] = _http(base, "/admin/reload", {})
        out["stats"] = _http(base, "/stats")[1]
        out["healthz"] = _http(base, "/healthz")
        out["metrics"] = _http(base, "/metrics")[1]
    return out


def _concurrent(base, bodies):
    """8 threads of two /v1/respond each and one /v1/stream at once: the
    HTTP handlers, the batcher and a stream reach the model together, and
    rank 0's one queue orders them for the follower."""
    results = [None] * 17

    def call(i):
        results[i] = (_http(base, "/v1/stream", bodies[2]) if i == 16 else
                      _http(base, "/v1/respond", bodies[i % 8]))
    threads = [threading.Thread(target=lambda k=k: [call(2 * k), call(
        2 * k + 1)]) for k in range(8)] + [
        threading.Thread(target=call, args=(16,))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return results


def _one_process(root, bodies, weights_quant=""):
    """The same calls in one process, batched as the server batches them
    (a beam session's rank goes through AsyncServer, 4 rows)."""
    session = ServingSession.from_checkpoint(
        str(root / "r0" / "ckpt" / "mtn_best"), DecodeConfig(**DECODE),
        weights_quant=weights_quant, device="cpu")
    reqs = [parse_request(b) for b in bodies]
    out = {f"batch{i}": [_result_json(r, 2) for r in session.respond_batch(
        reqs[4 * i:4 * i + 4])] for i in (0, 1)}
    srv = AsyncServer(session, max_wait_ms=1.0)
    try:
        out["rank"] = srv.submit_rank(reqs[0], CANDIDATES).result(60)
    finally:
        srv.stop()
    out["stream"] = list(session.stream(reqs[1]))
    out["stream3"] = list(session.stream(reqs[2]))
    return out


def _jax_session(jcfg, tree, vocab, fea_types, mesh):
    from mtn_tpu.config import DataConfig as JDataConfig
    from mtn_tpu.config import DecodeConfig as JDecodeConfig
    from mtn_tpu.parallel import make_mesh
    from mtn_tpu.serve import ServingSession as JSession
    data, model = (int(v) for v in mesh.split("x"))
    return JSession(tree, jcfg, JDataConfig(
        fea_type=list(fea_types), include_caption="caption,summary",
        separate_caption=True, length_bucket=8, feature_bucket=4), vocab,
        JDecodeConfig(**DECODE), mesh=make_mesh(data=data, model=model))


def _jax(jcfg, tree, vocab, fea_types, bodies):
    """JAX's session under each mesh: the two batches and the rank."""
    from mtn_tpu.serve import Request as JRequest
    reqs = [parse_request(b) for b in bodies]
    jreqs = [JRequest(question=r.question, history=r.history,
                      caption=r.caption, features=r.features) for r in reqs]
    out = {}
    for mesh in ("2x1", "1x2"):
        s = _jax_session(jcfg, tree, vocab, fea_types, mesh)
        out[mesh] = dict(
            nbest=[r.nbest for i in (0, 1)
                   for r in s.respond_batch(jreqs[4 * i:4 * i + 4])],
            rank=s.rank(jreqs[0], CANDIDATES))
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _address(log_path, proc, timeout=240):
    """Rank 0's base URL, read from its log."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        with open(log_path) as f:
            m = re.search(r"serving .* on (http://[0-9.]+:[0-9]+)", f.read())
        if m:
            return m.group(1)
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    with open(log_path) as f:
        raise AssertionError("rank 0 did not announce its address:\n"
                             + f.read()[-4000:])


@pytest.fixture(scope="module")
def worlds(tiny_corpus, tmp_path_factory):
    c = tiny_corpus
    root = tmp_path_factory.mktemp("served_mesh")
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    jcfg = tiny_model_cfg(len(vocab), c.ft_dims, dropout=0.0)
    tree = seeded_params(jcfg, seed=3, gen_scale=3.0)
    for r in (0, 1):
        prefix = str(root / f"r{r}" / "ckpt" / "mtn")
        os.makedirs(os.path.dirname(prefix))
        save_conf(prefix, vocab, model=port_cfg(jcfg), data=DataConfig(
            fea_type=list(c.fea_types), include_caption="caption,summary",
            separate_caption=True, length_bucket=8, feature_bucket=4))
        save_checkpoint(prefix, 1, from_flax(tree))
        if r == 0:
            save_checkpoint(prefix, 2, from_flax(seeded_params(
                jcfg, seed=4, gen_scale=3.0)), best=False)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = {}
    for name, flags in WORLDS.items():
        port = _free_port()
        for r in (0, 1):
            log = root / f"{name}_r{r}.log"
            procs[name, r] = (subprocess.Popen(
                [sys.executable, "-m", "mtn_tpu_torch.serve_http",
                 "--model", "ckpt/mtn_best", "--device", "cpu",
                 "--port", "0", "--max-wait-ms", "200", "--warmup",
                 "--multihost", f"localhost:{port},2,{r}", *flags,
                 *[a for k, v in DECODE.items()
                   for a in (f"--{k.replace('_', '-')}", str(v))]],
                cwd=root / f"r{r}", env=env, stdout=subprocess.DEVNULL,
                stderr=open(log, "w")), log)
    try:
        bodies = _bodies(c)
        single = {"": _one_process(root, bodies),
                  "int8": _one_process(root, bodies, "int8")}
        jax_out = _jax(jcfg, tree, vocab, c.fea_types, bodies)
        served, rcs, logs = {}, {}, {}
        for name in WORLDS:
            base = _address(procs[name, 0][1], procs[name, 0][0])
            served[name] = _traffic(base, bodies, mesh=True)
            procs[name, 0][0].send_signal(signal.SIGINT)
        for (name, r), (p, log) in procs.items():
            rcs[name, r] = p.wait(timeout=120)
            logs[name, r] = log.read_text()
    finally:   # no rank outlives the fixture
        for p, _ in procs.values():
            p.kill()
    return dict(served=served, single=single, jax=jax_out, rcs=rcs,
                logs=logs)


def _nbests(results):
    """[(answers, scores)] of a respond_batch's JSON results."""
    return [([h["answer"] for h in r["nbest"]],
             [h["score"] for h in r["nbest"]]) for r in results]


def _same_nbest(got, want, atol):
    """Row by row: a robust row (1-best margin above EPS) decodes the same
    n-best with scores within ``atol``; a near-tied row's 1-best is one of
    ``want``'s hypotheses within EPS of its 1-best."""
    assert len(got) == len(want)
    robust = 0
    for (ga, gs), (wa, ws) in zip(got, want):
        if len(ws) < 2 or ws[0] - ws[1] > EPS:
            robust += 1
            assert ga == wa
            np.testing.assert_allclose(gs, ws, rtol=0, atol=atol)
        else:
            assert ga[0] in [a for a, s in zip(wa, ws) if ws[0] - s <= EPS]
    assert robust * 2 >= len(want)


def _single_of(name, worlds):
    return worlds["single"]["int8" if name.endswith("int8") else ""]


@pytest.mark.parametrize("name", list(WORLDS))
def test_served_mesh_answers_match_one_process(worlds, name):
    """2x1: bitwise one process's answers and scores (both batches);
    1x2 and its int8 weights: margin-aware, scores within 1e-5."""
    got, want = worlds["served"][name], _single_of(name, worlds)
    for key in ("batch0", "batch1"):
        code, body = got[key]
        assert code == 200
        if name == "2x1":
            assert body["results"] == want[key]
        else:
            _same_nbest(_nbests(body["results"]), _nbests(want[key]), ATOL)


@pytest.mark.parametrize("name", ["2x1", "1x2"])
def test_served_mesh_matches_jax_session_under_the_same_mesh(worlds, name):
    got = worlds["served"][name]
    want = worlds["jax"][name]
    _same_nbest(_nbests(got["batch0"][1]["results"]
                        + got["batch1"][1]["results"]),
                [([a for a, _ in n], [s for _, s in n])
                 for n in want["nbest"]], JAX_ATOL)
    code, ranked = got["rank"]
    assert code == 200
    np.testing.assert_allclose([c["logp"] for c in ranked["candidates"]],
                               [s for _, s, _ in want["rank"]], rtol=0,
                               atol=RANK_ATOL)


@pytest.mark.parametrize("name", list(WORLDS))
def test_rank_and_stream_under_the_mesh(worlds, name):
    """Rank log-probs and the greedy stream: bitwise one process's under
    2x1, within 1e-5 (the same words) under 1x2."""
    got, want = worlds["served"][name], _single_of(name, worlds)
    code, ranked = got["rank"]
    assert code == 200
    assert [(c["answer"], c["rank"]) for c in ranked["candidates"]] == \
        [(c, r) for c, _, r in want["rank"]]
    logps = [c["logp"] for c in ranked["candidates"]]
    if name == "2x1":
        assert logps == [s for _, s, _ in want["rank"]]
    else:
        np.testing.assert_allclose(logps, [s for _, s, _ in want["rank"]],
                                   rtol=0, atol=ATOL)
    code, text = got["stream"]
    events = _events(text)
    assert code == 200 and events[-1]["done"] is True
    assert [e["token"] for e in events[:-1]] == want["stream"]
    assert events[-1]["answer"] == " ".join(want["stream"])


@pytest.mark.parametrize("name", list(WORLDS))
def test_a_reload_one_rank_fails_keeps_every_rank_on_the_old_weights(
        worlds, name):
    """``ckpt/mtn_2`` exists in rank 0's directory only: the reload is
    refused with rank 1's error, every rank keeps epoch 1 (the first
    batch decodes as before, which a follower on other weights would
    not), and a reload of the served checkpoint then succeeds."""
    got = worlds["served"][name]
    code, body = got["refused_reload"]
    assert code == 400
    assert "rank 1: " in body["error"] and "epoch_2.pt" in body["error"]
    assert "rank 0" not in body["error"]
    assert got["after_refusal"] == got["batch0"]
    assert got["reload"] == (200, {"ok": True, "epoch": 1})
    assert got["stats"]["epoch"] == 1


@pytest.mark.parametrize("name", list(WORLDS))
def test_refused_requests_never_reach_the_follower(worlds, name):
    """The malformed requests are answered 400 by rank 0 and broadcast
    nothing: the follower ran exactly the commands rank 0 broadcast, in
    the order of one queue also while 8 threads and a stream called at
    once: the warmup's decode and stream and the traffic's launches,
    streams and reloads."""
    got = worlds["served"][name]
    assert got["malformed"] == [400, 400, 400]
    assert all(code == 200 for code, _ in got["concurrent"])
    events = _events(got["concurrent"][16][1])
    assert events[-1]["answer"] == " ".join(worlds["single"][
        "int8" if name.endswith("int8") else ""]["stream3"])
    stats = got["stats"]
    # every batch and the rank request are one launch each; the batches
    # of the 16 concurrent requests depend on their timing
    want = {"beam": 1 + stats["launches"] - 1, "rank": 1, "stream": 3,
            "reload": 2}
    assert stats["launches"] >= 6
    assert stats["commands"] == want
    m = re.search(r"rank 1: rank 0 stopped; ran (\{.*\})",
                  worlds["logs"][name, 1])
    assert m, worlds["logs"][name, 1][-4000:]
    assert json.loads(m.group(1)) == want


@pytest.mark.parametrize("name", list(WORLDS))
def test_stop_ends_the_follower_with_rc_0(worlds, name):
    """SIGINT to rank 0: it closes the server, broadcasts ``stop``, and
    both ranks exit 0."""
    assert worlds["rcs"][name, 0] == 0, worlds["logs"][name, 0][-4000:]
    assert worlds["rcs"][name, 1] == 0, worlds["logs"][name, 1][-4000:]
    assert "shutting down" in worlds["logs"][name, 0]


@pytest.mark.parametrize("name", list(WORLDS))
def test_healthz_stats_and_metrics_report_the_mesh(worlds, name):
    got = worlds["served"][name]
    shape = {"data": 2, "model": 1} if name == "2x1" else \
        {"data": 1, "model": 2}
    assert got["healthz"] == (200, {"ok": True, "mesh": shape})
    assert got["stats"]["mesh"] == shape
    for axis, n in shape.items():
        assert f'mtn_mesh_size{{axis="{axis}"}} {n}' in got["metrics"]
    assert 'mtn_commands_total{op="reload"} 2' in got["metrics"]
