"""The card's busy time and its idle gaps in a traced pass, and the
per-layer readings of a traced window, from the spans the program
records (``mtn_tpu_torch.utils.profiling.recording`` over one
``generate_responses`` pass; its ``records()``: times in ns on one host
clock, device spans placed on it).

- ``busy``: the union of the pass's device work, clipped to its root
  span ``decode.pass``: each device span whose stream runs its work back
  to back (a graphed batch: static-input copy and graph launch), and
  each kernel of a driven span (an eager batch, a capture's warm-up:
  work the host drives kernel by kernel, so the card idles inside the
  span while the host launches or reads; the profiler times its
  kernels). Uploads and reads to the host are in neither and count as
  idle.
- ``idle_by_host``: each idle interval of the pass cut where a span of
  the root's thread (the consumer) starts or ends, each piece filed under
  the innermost such span that covers it; ``decode.pass`` itself takes
  what no child covers. So busy plus idle is the pass's time.
- Between two passes the card is idle by construction (no device span
  lies outside a pass): the window files that time under
  ``between_passes``.
- The tracer's own host spans (``profiler.*``: starting and stopping the
  profiler around a driven span, resolving the device spans at the end
  of the pass) are not the program's: host seconds by span name leave
  them out of every span that holds them, and ``device_idle_pct.decode``
  leaves their idle seconds out of the window's idle and of the window,
  so that it reads what an untraced window would.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = "decode.pass"
GRAPHED = "decode.graphed_batch"
TRACER = "profiler."   # the tracer's own host spans
# the readings of a traced window (:func:`readings`)
NAMES = ("device_idle_pct.decode", "decode_graphed_batch_device_ms",
         "decode_capture_s", "decode_eager_batch_s", "decode_queue_wait_ms",
         "producer_batch_ms.decode")
Interval = Tuple[int, int]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The disjoint, sorted intervals that cover the same points."""
    out: List[List[int]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of [lo, hi) that the sorted, disjoint ``busy`` leaves
    uncovered."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def idle_by_host(idle: Sequence[Interval], host: Sequence[dict]
                 ) -> Dict[str, float]:
    """Seconds of ``idle`` by the innermost span of ``host`` (spans of one
    thread, properly nested) covering each piece: the latest to start,
    the later opened on a tie. A piece no span covers goes to
    ``uncovered``."""
    spans = sorted(host, key=lambda s: (s["start_ns"], s["id"]))
    starts = [s["start_ns"] for s in spans]
    out: Dict[str, float] = {}
    for a, b in idle:
        cuts = {a, b}
        near = spans[:bisect_left(starts, b)]
        for s in near:
            if s["end_ns"] > a:
                cuts.update(t for t in (s["start_ns"], s["end_ns"])
                            if a < t < b)
        edges = sorted(cuts)
        for x, y in zip(edges, edges[1:]):
            inner = None
            for s in near:
                if s["start_ns"] <= x and s["end_ns"] >= y:
                    inner = s   # sorted by start: the last one is innermost
            name = inner["name"] if inner is not None else "uncovered"
            out[name] = out.get(name, 0.0) + (y - x) / 1e9
    return out


def work(device: Sequence[dict]) -> List[Interval]:
    """The device work of a recording's ``device`` records: the spans
    that are not driven, and the driven spans' kernels."""
    return [k for d in device for k in (
        d["kernels"] if d["driven"] else [(d["start_ns"], d["end_ns"])])]


def pass_summary(records: dict) -> dict:
    """One traced pass's spans in brief: its seconds, the card's busy
    seconds, ``idle_by_host``, host seconds and counts by span name (every
    thread; less the tracer's spans inside each), the idle seconds under
    the tracer's own spans, the graphed batches' device ms, each driven
    span's seconds and its kernels' busy ms by name, the root's counters,
    and the device spans that fall outside the pass (none, where the
    clock holds)."""
    host, device = records["host"], records["device"]
    root = next(s for s in host if s["name"] == ROOT and s["parent"] is None)
    lo, hi = root["start_ns"], root["end_ns"]
    busy = union([(max(a, lo), min(b, hi)) for a, b in work(device)])
    driven: Dict[str, dict] = {}
    for d in device:
        if d["driven"]:
            mine = driven.setdefault(d["name"], {"s": [], "kernel_ms": []})
            mine["s"].append((d["end_ns"] - d["start_ns"]) / 1e9)
            mine["kernel_ms"].append(sum(
                b - a for a, b in union(d["kernels"])) / 1e6)
    consumer = [s for s in host if s["thread"] == root["thread"]]
    dur = lambda s: (s["end_ns"] - s["start_ns"]) / 1e9
    ids = {s["id"]: s for s in host}
    tracer_in: Dict[int, float] = {}   # the tracer's seconds inside a span
    for s in host:
        if s["name"].startswith(TRACER):
            p = s["parent"]
            while p is not None:
                tracer_in[p] = tracer_in.get(p, 0.0) + dur(s)
                p = ids[p]["parent"]
    host_s: Dict[str, float] = {}
    host_n: Dict[str, int] = {}
    for s in host:
        host_s[s["name"]] = host_s.get(s["name"], 0.0) + dur(s) - \
            tracer_in.get(s["id"], 0.0)
        host_n[s["name"]] = host_n.get(s["name"], 0) + 1
    idle = idle_by_host(gaps(busy, lo, hi), consumer)
    return {
        "pass_s": (hi - lo) / 1e9,
        "device_busy_s": sum(b - a for a, b in busy) / 1e9,
        "idle_by_host": idle,
        "tracer_idle_s": sum(v for k, v in idle.items()
                             if k.startswith(TRACER)),
        "host_s": host_s, "host_n": host_n,
        "graphed_batch_device_ms": [(d["end_ns"] - d["start_ns"]) / 1e6
                                    for d in device
                                    if d["name"] == GRAPHED],
        "driven": driven,
        "device_spans": len(device),
        "device_outside_pass": sum(d["start_ns"] < lo or d["end_ns"] > hi
                                   for d in device),
        "counters": root["counters"]}


def between_passes(passes: Sequence[dict], window_s: float) -> float:
    """The window's seconds outside its passes' root spans (the collection
    after each pass)."""
    return window_s - sum(p["spans"]["pass_s"] for p in passes)


def _mean(xs: Sequence[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def readings(passes: Sequence[dict], window_s: float
             ) -> Dict[str, Optional[float]]:
    """The six per-layer readings of a traced window whose pass entries
    carry ``spans`` (:func:`pass_summary`); each None where nothing was
    recorded (an untraced window, or no device span: the CPU)."""
    traced = [p["spans"] for p in passes if p.get("spans")]
    if not traced or not window_s:
        return dict.fromkeys(NAMES)
    on_card = any(s["device_spans"] for s in traced)
    batches = sum(s["counters"]["batches"] for s in traced)

    def per_pass(name):
        return _mean([s["host_s"].get(name, 0.0) for s in traced])

    def ms_a_batch(*names):
        total = sum(s["host_s"].get(n, 0.0) for s in traced for n in names)
        return 1e3 * total / batches if batches else None
    graphed = [ms for s in traced for ms in s["graphed_batch_device_ms"]]
    return {
        "device_idle_pct.decode": 100.0 * (1.0 - sum(
            s["device_busy_s"] for s in traced) / (window_s - sum(
                s["tracer_idle_s"] for s in traced)))
        if on_card else None,
        "decode_graphed_batch_device_ms": _mean(graphed)
        if on_card else None,
        "decode_capture_s": per_pass("decode.capture"),
        "decode_eager_batch_s": per_pass("decode.eager_batch"),
        "decode_queue_wait_ms": ms_a_batch("decode.queue_wait"),
        "producer_batch_ms.decode": ms_a_batch("decode.make_batch",
                                               "decode.upload"),
    }

