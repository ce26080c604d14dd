"""The span recorder (``mtn_tpu_torch/utils/profiling.py``) and the spans
of ``generate_responses``: off, it records nothing; on, spans nest on
each thread, carry their batch and land on one clock with the device's
events; a traced pass decodes what an untraced one does; ``cli.generate
--profile-dir`` writes them as a Chrome trace; and the benchmark's union
and idle attribution (``benchmark/harness/spans.py``). The card test
checks the clock on a CUDA card and skips without one; this file imports
no JAX, so it runs there too (``--noconftest``)."""

import json
import logging
import sys
import threading
import types

import pytest
import torch

from benchmark.harness import spans as bench_spans
from mtn_tpu_torch.cli import generate as generate_cli
from mtn_tpu_torch.cli.generate import generate_responses
from mtn_tpu_torch.config import DataConfig, DecodeConfig, ModelConfig
from mtn_tpu_torch.data.dataset import load
from mtn_tpu_torch.data.vocab import get_vocabulary
from mtn_tpu_torch.utils import profiling
from mtn_tpu_torch.weights import (init_params, load_model, save_checkpoint,
                                   save_conf)
from tests.fixtures import write_tiny_corpus

DATA = dict(include_caption="caption,summary", separate_caption=True,
            length_bucket=8, feature_bucket=4)
DECODE = dict(maxlen=8, beam=3, nbest=3, penalty=1.0, turn_batch=2,
              decode_style="beam_search", undisclosed_only=True)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A corpus of 6 test dialogs (3 turn batches of 2), its vocabulary,
    and a seeded one-block model's config and weights."""
    c = write_tiny_corpus(tmp_path_factory.mktemp("spans"),
                          n_test_dialogs=6)
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    cfg = ModelConfig(vocab_size=len(vocab), nb_blocks=1, d_model=16,
                      d_ff=32, att_h=2, dropout=0.0, attn_dropout=0.0,
                      ft_sizes=list(c.ft_dims), diff_encoder=True,
                      auto_encoder_ft="query")
    sd = init_params(cfg, torch.Generator().manual_seed(3))
    return c, vocab, cfg, sd


def _decode(tiny, device):
    """``generate_responses`` on the tiny split: (result, stats, the
    logged n-bests)."""
    c, vocab, cfg, sd = tiny
    data = load(c.fea_types, c.fea_path, c.test_set, vocab,
                include_caption="caption,summary", separate_caption=True,
                undisclosed_only=True)
    hyps = []

    class Keep(logging.Handler):
        def emit(self, record):
            hyps.append(record.getMessage())
    log = logging.getLogger(generate_cli.__name__)
    keep, level = Keep(logging.INFO), log.level
    log.addHandler(keep)
    log.setLevel(logging.INFO)
    try:
        result, stats = generate_responses(
            load_model(cfg, sd, device), data, DecodeConfig(**DECODE),
            DataConfig(fea_type=c.fea_types, **DATA), vocab, device,
            log_hyps=True)
    finally:
        log.removeHandler(keep)
        log.setLevel(level)
    return result, stats, [h for h in hyps if h.startswith("HYP[")]


def test_recorder_off_records_nothing():
    assert profiling.active() is None
    assert profiling.span("decode.pass") is profiling.NULL
    assert profiling.span("decode.launch", 3) is profiling.NULL
    # off, a CUDA device span makes no event (none could be made here)
    assert profiling.device_span("x", torch.device("cuda")) is \
        profiling.NULL
    assert profiling.driven_span("x", torch.device("cuda")) is \
        profiling.NULL
    with profiling.span("decode.pass") as s:
        assert s is None
    with profiling.recording() as rec:
        assert profiling.active() is rec
        assert profiling.device_span("x", torch.device("cpu")) is \
            profiling.NULL
        assert profiling.driven_span("x", torch.device("cpu")) is \
            profiling.NULL
    assert profiling.active() is None and rec.device == []


def test_spans_nest_carry_batches_and_threads():
    with profiling.recording() as rec:
        with profiling.span("pass") as root:
            with profiling.span("launch", 4):
                with profiling.span("capture") as cap:
                    cap.count(sets=1)
            with profiling.span("fetch", 5):
                pass

            def produce():
                with profiling.span("make_batch", 7, root):
                    with profiling.span("upload"):
                        pass
            t = threading.Thread(target=produce, name="producer")
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            root.count(batches=2, exit_steps=[3, 4])
    recs = {s["name"]: s for s in rec.records()["host"]}
    assert [s.id for s in rec.spans] == list(range(6))
    assert recs["pass"]["parent"] is None
    assert recs["pass"]["counters"] == {"batches": 2, "exit_steps": [3, 4]}
    assert recs["launch"]["parent"] == recs["pass"]["id"]
    assert recs["capture"]["parent"] == recs["launch"]["id"]
    assert recs["capture"]["batch"] == 4 and recs["fetch"]["batch"] == 5
    assert recs["capture"]["counters"] == {"sets": 1}
    assert recs["make_batch"]["parent"] == recs["pass"]["id"]
    assert recs["upload"]["parent"] == recs["make_batch"]["id"]
    assert recs["upload"]["batch"] == 7
    assert recs["upload"]["thread"] == "producer"
    assert recs["launch"]["thread"] == threading.current_thread().name
    for s in recs.values():
        assert 0 < s["start_ns"] <= s["end_ns"]
    assert recs["pass"]["start_ns"] <= recs["launch"]["start_ns"] <= \
        recs["capture"]["end_ns"] <= recs["launch"]["end_ns"]


def test_spans_from_many_threads_keep_their_ids():
    """Threads recording at once, switching often: every span keeps the
    id of its place in the recording, and none is lost."""
    n_threads, n_spans = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work(k):
                for i in range(n_spans):
                    with profiling.span(f"t{k}", i):
                        pass
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert [s.id for s in rec.spans] == list(range(n_threads * n_spans))
    for k in range(n_threads):
        mine = [s for s in rec.spans if s.name == f"t{k}"]
        assert [s.batch for s in mine] == list(range(n_spans))
        assert all(s.parent is None and s.end_ns >= s.start_ns
                   for s in mine)


class FakeEvent:
    """A CUDA event on a fake device clock (ms)."""
    device_ms = [0.0]

    def __init__(self, enable_timing=False):
        self.ms = None

    def record(self, stream=None):
        self.ms = self.device_ms[0]

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


def _kernel(start_ns, end_ns, stream, name="k",
            device=torch.autograd.DeviceType.CUDA):
    """A profiler's record of one activity on the card."""
    return types.SimpleNamespace(
        device_type=lambda: device, name=lambda: name,
        start_ns=lambda: start_ns, duration_ns=lambda: end_ns - start_ns,
        device_resource_id=lambda: stream)


class FakeProfiler:
    """A stopped profiler's results: ``kernels`` on its own clock."""

    def __init__(self, kernels):
        self.profiler = types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: kernels))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_device_spans_land_on_the_host_clock(monkeypatch):
    """The anchor's host time plus the anchor's elapsed time to each
    event: an anchor at device 100 ms read at host 5 s puts a span
    recorded at device 102.5-110 ms at host 5.0025-5.010 s. A driven
    span's kernels move with its end event: the last kernel of the stream
    that ran most of them ends there; copies to and from the host and
    the host's own activity are left out."""
    host_ns = [5_000_000_000]
    monkeypatch.setattr(profiling.torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: host_ns[0]))
    monkeypatch.setattr(profiling, "_kernel_profiler", lambda: FakeProfiler([
        _kernel(900, 1_000, 7), _kernel(1_500, 2_000, 7),
        _kernel(1_200, 2_100, 3), _kernel(2_000, 2_400, 7, "Memcpy DtoH"),
        _kernel(0, 9_000, 7, "Memcpy HtoD (Pinned -> Device)"),
        _kernel(0, 9_000, 7, "cudaLaunchKernel",
                torch.autograd.DeviceType.CPU)]))
    cuda = types.SimpleNamespace(type="cuda")
    with profiling.recording() as rec:
        FakeEvent.device_ms[0] = 100.0
        rec.anchor("cuda")
        host_ns[0] = 5_000_100_000
        with profiling.span("launch", 2):
            FakeEvent.device_ms[0] = 102.5
            with profiling.device_span("graphed", cuda) as ds:
                FakeEvent.device_ms[0] = 110.0
        assert ds.start_ns == 0    # resolved only at the end
        with profiling.span("eager", 3):
            FakeEvent.device_ms[0] = 111.0
            with profiling.driven_span("eager", cuda):
                FakeEvent.device_ms[0] = 112.0
    d, e = rec.records()["device"]
    assert (d["start_ns"], d["end_ns"]) == (5_002_500_000, 5_010_000_000)
    assert d["batch"] == 2 and d["parent"] == rec.spans[0].id
    assert not d["driven"] and d["kernels"] == []
    assert (e["start_ns"], e["end_ns"]) == (5_011_000_000, 5_012_000_000)
    assert e["driven"] and e["batch"] == 3
    end = 5_012_000_000
    assert e["kernels"] == [(end - 1_100, end - 1_000), (end - 800, end + 100),
                            (end - 500, end)]
    assert [s.name for s in rec.spans] == ["launch", "eager",
                                           "profiler.start", "profiler.stop"]
    assert rec.spans[2].parent is rec.spans[1]


def test_generate_responses_is_the_same_traced(tiny):
    """A traced pass returns the untraced pass's result and n-bests, and
    records each boundary: the root and its counters, the plan, each
    batch's producer spans on the producer thread, queue waits, launches
    and fetches by batch, the eager batches (the CPU's every batch), the
    results."""
    result, stats, hyps = _decode(tiny, "cpu")
    with profiling.recording() as rec:
        t_result, t_stats, t_hyps = _decode(tiny, "cpu")
    assert t_result == result and t_hyps == hyps and len(hyps) == 18
    keep = ("turns", "batches", "mean_exit_step", "captures",
            "eager_batches")
    assert {k: t_stats[k] for k in keep} == {k: stats[k] for k in keep}
    assert stats["captures"] == 0 and stats["batches"] == 3
    recs = rec.records()
    host = recs["host"]
    (root,) = [s for s in host if s["name"] == "decode.pass"]
    by = lambda n: [s for s in host if s["name"] == n]
    assert root["counters"]["turns"] == 6
    assert root["counters"]["batches"] == 3
    assert len(root["counters"]["exit_steps"]) == 3
    assert root["counters"]["graph_launches"] == 0
    assert len(by("decode.plan")) == len(by("decode.results")) == 1
    # the device spans are resolved at the pass's end, inside it
    assert [s["parent"] for s in by("profiler.resolve")] == [root["id"]]
    for name in ("decode.make_batch", "decode.upload", "decode.launch",
                 "decode.fetch", "decode.convert", "decode.eager_batch"):
        assert sorted(s["batch"] for s in by(name)) == [0, 1, 2], name
    for s in by("decode.make_batch") + by("decode.upload"):
        assert s["thread"] == "decode-producer"
    assert [s["batch"] for s in by("decode.queue_wait")] == [0, 1, 2, 3]
    ids = {s["id"]: s for s in host}
    for s in host:
        if s is not root:    # every span hangs from the pass
            p = s
            while p["parent"] is not None:
                p = ids[p["parent"]]
            assert p is root, s["name"]
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
            root["end_ns"]
    assert recs["device"] == []
    summary = bench_spans.pass_summary(recs)
    assert summary["device_busy_s"] == 0.0
    assert summary["idle_by_host"]["decode.eager_batch"] > 0
    assert sum(summary["idle_by_host"].values()) == \
        pytest.approx(summary["pass_s"])


def test_cli_generate_profile_dir_writes_a_chrome_trace(tiny, tmp_path):
    c, vocab, cfg, sd = tiny
    prefix = str(tmp_path / "mtn")
    save_conf(prefix, vocab, model=cfg,
              data=DataConfig(fea_type=c.fea_types, **DATA))
    save_checkpoint(prefix, 1, sd)
    out = tmp_path / "prof"
    assert generate_cli.main([
        "--model", prefix + "_best", "--device", "cpu", "--dtype",
        "float32", "--test-path", c.fea_path, "--test-set", c.test_set,
        "--beam", "3", "--nbest", "3", "--maxlen", "8", "--turn-batch", "2",
        "--undisclosed-only", "1", "--profile-dir", str(out)]) == 0
    (path,) = out.iterdir()
    assert path.name.startswith("decode_spans_") and path.suffix == ".json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"decode.pass", "decode.queue_wait", "decode.launch",
            "decode.make_batch"} <= names
    threads = {e["args"]["name"] for e in events
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "decode-producer" in threads
    (root,) = [e for e in events if e["name"] == "decode.pass"]
    assert root["args"]["turns"] == 6 and root["dur"] > 0


def _host(name, sid, start, end):
    return dict(id=sid, name=name, start_ns=start, end_ns=end, parent=None,
                thread="main", batch=None, counters={})


def test_union_and_idle_attribution():
    """Busy is the union of the device work inside the pass (graphed
    spans, driven spans' kernels); each idle piece goes to the innermost
    consumer span over it, the rest to the pass; the producer's spans
    take none; the tracer's own spans leave the readings."""
    assert bench_spans.union([(5, 9), (0, 2), (1, 3), (9, 10), (4, 4)]) \
        == [(0, 3), (5, 10)]
    assert bench_spans.gaps([(0, 3), (5, 10)], 0, 12) == [(3, 5), (10, 12)]
    assert bench_spans.gaps([(-5, 3)], 0, 2) == []
    host = [_host("decode.pass", 0, 0, 100),
            dict(_host("decode.launch", 1, 10, 40), parent=0),
            dict(_host("decode.capture", 2, 15, 30), parent=1),
            _host("decode.fetch", 3, 50, 90),
            _host("decode.wait", 4, 50, 60),
            dict(_host("decode.make_batch", 5, 0, 100),
                 thread="decode-producer"),
            dict(_host("profiler.stop", 6, 16, 17), parent=2)]
    host[0]["counters"] = {"batches": 2}
    graphed = dict(name="decode.graphed_batch", parent=1, driven=False,
                   kernels=[])
    device = [dict(name="capture.warm_up", start_ns=12, end_ns=20,
                   parent=2, batch=0, driven=True,
                   kernels=[(12, 14), (17, 20), (13, 14)]),
              dict(graphed, start_ns=35, end_ns=55, batch=0),
              dict(graphed, start_ns=58, end_ns=120, batch=1)]
    s = bench_spans.pass_summary({"host": host, "device": device})
    # the warm-up's kernels are busy, its span's gaps idle
    assert s["device_busy_s"] == pytest.approx(5e-9 + 20e-9 + 42e-9)
    assert s["driven"] == {"capture.warm_up": {
        "s": [pytest.approx(8e-9)], "kernel_ms": [pytest.approx(5e-6)]}}
    idle = {k: round(v * 1e9) for k, v in s["idle_by_host"].items()}
    # idle: 0-12 (pass 0-10, launch 10-12), 14-17 (launch 14-15,
    # capture 15-16, the tracer 16-17), 20-35 (capture 20-30, launch
    # 30-35), 55-58 (wait)
    assert idle == {"decode.pass": 10, "decode.launch": 8,
                    "decode.capture": 11, "profiler.stop": 1,
                    "decode.wait": 3}
    assert s["tracer_idle_s"] == pytest.approx(1e-9)
    # the tracer's second leaves every span that holds it
    assert {k: round(v * 1e9) for k, v in s["host_s"].items()} == {
        "decode.pass": 99, "decode.launch": 29, "decode.capture": 14,
        "decode.fetch": 40, "decode.wait": 10, "decode.make_batch": 100,
        "profiler.stop": 1}
    assert s["device_outside_pass"] == 1
    assert s["graphed_batch_device_ms"] == pytest.approx([20e-6, 62e-6])
    assert s["device_busy_s"] + sum(s["idle_by_host"].values()) == \
        pytest.approx(s["pass_s"])
    assert bench_spans.idle_by_host([(200, 210)], host) == {
        "uncovered": 1e-8}
    passes = [{"spans": s}, {"spans": s}]
    r = bench_spans.readings(passes, window_s=250e-9)
    # the tracer's idle leaves the window: 250 - 2 ns, 134 ns busy
    assert r["device_idle_pct.decode"] == pytest.approx(100 * 114 / 248)
    assert r["decode_capture_s"] == pytest.approx(14e-9)
    assert r["decode_eager_batch_s"] == 0.0
    assert r["producer_batch_ms.decode"] == pytest.approx(1e3 * 200e-9 / 4)
    assert bench_spans.between_passes(passes, 250e-9) == \
        pytest.approx(50e-9)
    assert bench_spans.readings([{}], 1.0) == dict.fromkeys(
        bench_spans.NAMES)


def test_device_spans_agree_with_the_host_clock_on_the_card(tiny):
    """On a CUDA card: every device span of a traced pass lies inside the
    pass, each graphed batch's device end falls before the end of its
    ``decode.wait``, and each driven span (the eager batch, the capture's
    warm-up) holds its kernels, which keep the card busy for less than
    the span (0.5 ms allowed for the anchor's read)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with profiling.recording() as rec:
        _decode(tiny, "cuda")
    recs = rec.records()
    summary = bench_spans.pass_summary(recs)
    assert summary["device_outside_pass"] == 0
    graphed = [d for d in recs["device"]
               if d["name"] == "decode.graphed_batch"]
    assert len(graphed) == 2   # the shape's first batch runs eagerly
    waits = {s["batch"]: s for s in recs["host"]
             if s["name"] == "decode.wait"}
    for d in graphed:
        assert d["end_ns"] <= waits[d["batch"]]["end_ns"] + 500_000
    driven = {d["name"]: d for d in recs["device"] if d["driven"]}
    assert set(driven) == {"decode.eager_batch", "capture.warm_up"}
    for d in driven.values():
        assert d["kernels"], d["name"]
        assert d["start_ns"] - 500_000 <= d["kernels"][0][0]
        assert max(b for a, b in d["kernels"]) <= d["end_ns"] + 500_000
    (eager,) = summary["driven"]["decode.eager_batch"]["kernel_ms"]
    (eager_s,) = summary["driven"]["decode.eager_batch"]["s"]
    assert 0 < eager < 1e3 * eager_s
    assert summary["counters"]["eager_batches"] == 1
    assert summary["counters"]["captures"] == 1
    assert summary["device_busy_s"] + sum(
        summary["idle_by_host"].values()) == pytest.approx(
        summary["pass_s"], rel=1e-6)
