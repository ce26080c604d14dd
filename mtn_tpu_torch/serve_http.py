"""HTTP front end for a served MTN checkpoint (``mtn_tpu/serve_http.py``).

Exposes :class:`~mtn_tpu_torch.serve.ServingSession` (interactive
decode) and :class:`~mtn_tpu_torch.serve.AsyncServer` (continuous
batching) over HTTP with the standard library only.

    python -m mtn_tpu_torch.serve_http --model exps/x/mtn_best \\
        --use-pallas-attention 1 --use-pallas-ffn 1 --warmup

runs on the card; ``--device cpu`` runs the kernels' plain versions on the
CPU, and without it a machine with no CUDA device refuses to start. A JAX
checkpoint is served after ``scripts/dump_flax_params.py`` and ``python -m
mtn_tpu_torch.utils.import_flax``.

API (all JSON)::

    POST /v1/respond        {"question": str,
                             "history": [[q, a], ...],      # optional
                             "caption": str,                # optional
                             "features": {name: value},     # optional
                             "nbest": int,                  # optional
                             "deadline_ms": number}         # optional
                        ->  {"answer": str, "score": float}
                            (+ "nbest": [{"answer", "score"}, ...] when
                            nbest > 1: the ranked beam hypotheses)
    POST /v1/respond_batch  {"requests": [<respond body>, ...],
                             "nbest": int}                  # optional
                        ->  {"results": [{"answer", "score"}, ...]}
                            (a row whose deadline passed comes back as
                            {"error", "code": 504})
    POST /v1/rank           <respond body minus nbest>
                            + {"candidates": [str, ...],
                               "include_eos": bool}         # optional
                        ->  {"candidates": [{"answer", "logp",
                            "rank"}, ...]} in input order (candidates
                            scored by generative log-likelihood)
    POST /v1/stream         <respond body> (+ optional "style":
                            "greedy"|"sample")
                        ->  Server-Sent Events: one
                            ``data: {"token": word}`` per decoded
                            word as it lands, then
                            ``data: {"done": true, "answer": str}``.
                            Beam sessions stream greedily (an n-best
                            cannot stream token by token).
    GET  /healthz       ->  {"ok": true} (+ "mesh": {"data", "model"}
                            under a mesh)
    GET  /stats         ->  {"requests", "errors", "launches",
                             "uptime_s", "decode_style", "turn_batch",
                             "latency": {count, mean_ms, p50_ms, p90_ms}}
                            (+ "mesh" and "commands", the calls rank 0
                            broadcast by kind, under a mesh)
    GET  /metrics       ->  Prometheus text exposition (request/error/
                            launch/reload counters + request-latency
                            histogram + uptime)
    POST /admin/reload      {"model": "<prefix_best>"}   # optional body
                        ->  {"ok": true, "epoch": N}
                            hot-swaps the served weights from a
                            checkpoint of the same architecture. Admin
                            routes require ``--admin-token`` as a bearer
                            token, or default to loopback-only.
    POST /admin/drain       {"resume": bool}              # optional body
                        ->  {"ok": true, "draining": bool}
                            while draining, /v1/* and /healthz return
                            503 (load balancers eject the instance;
                            requests in flight finish), admin/stats/
                            metrics stay up; {"resume": true} re-admits.

Backpressure: with ``--max-queue N``, requests beyond N waiting are
rejected with 503 + ``Retry-After`` (:class:`ServerOverloaded`): for
beam sessions the bound is the continuous batcher's waiting queue, for
greedy/sample/stream sessions the number of requests admitted to the
serialized session.

Operations: ``--warmup`` runs every decode path on a blank request before
the socket opens (it builds the CUDA kernels, so no request pays the
build); ``--watch-seconds N`` polls the checkpoint and hot-reloads
whenever the model arg (``_best``/``_latest``) resolves to a new epoch.

A feature ``value`` is either a nested list (2-D ``(T, D)`` or 3-D
``(T, R, D)``, converted to float32) or ``{"npy_b64": "..."}``: the
base64 of an ``np.save`` byte string.

Concurrency: ``ThreadingHTTPServer`` gives one handler thread per
connection. ``beam_search`` sessions route every respond and rank
request through ``AsyncServer``, so concurrent HTTP callers share
``turn_batch``-padded launches. ``greedy``/``sample`` sessions and every
stream serialize behind a lock (``ServingSession`` is thread-unsafe and
the sample path advances a fold counter).

``--aot <dir>`` serves an artifact of ``python -m mtn_tpu_torch.utils.aot
export`` instead of a checkpoint (:class:`~mtn_tpu_torch.utils.aot.
AotSession`): the decode flags are frozen in it, so any non-default
decode, mesh, transfer or quantization flag is refused; every route
serializes behind the session lock (no ``AsyncServer``); ``/v1/rank`` and
``/v1/stream`` answer 501 where the artifact lacks their programs;
``/admin/reload`` and ``--watch-seconds`` swap in a re-export (a changed
``export_id`` in its ``meta.json``).

Under a mesh (``--mesh-data``, ``--mesh-model``) the port runs one
process per device, joined by ``--multihost`` (``auto`` under
``torchrun``, or ``host:port,nprocs,procid``, as the other CLIs)::

    torchrun --nproc-per-node 2 -m mtn_tpu_torch.serve_http \
        --multihost auto --mesh-data 2 --model exps/x/mtn_best

Every rank loads its part of the model (``ServingSession(mesh=)``).
Rank 0 binds the port and serves every route; each call that reaches
the model is broadcast to the other ranks, which run it in lockstep
(``ServingSession.follow``) and exit 0 when rank 0 shuts down. The
counters are rank 0's.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from mtn_tpu_torch.serve import (AsyncServer, DeadlineExceeded, Request,
                                 ServerOverloaded, ServingSession)


class BadRequest(ValueError):
    """Client-side error -> HTTP 400 with the message."""


class NotSupported(Exception):
    """Route not available for this session type -> HTTP 501 (a
    duck-typed session without ``rank``, ``stream`` or ``reload``)."""


def _parse_features(obj) -> Dict[str, np.ndarray]:
    if obj is None:
        return {}
    if not isinstance(obj, dict):
        raise BadRequest("'features' must be an object {name: array}")
    out = {}
    for name, val in obj.items():
        if isinstance(val, dict):
            b64 = val.get("npy_b64")
            if b64 is None:
                raise BadRequest(
                    f"feature {name!r}: object form needs 'npy_b64'")
            try:
                arr = np.load(io.BytesIO(base64.b64decode(b64)),
                              allow_pickle=False)
            except Exception as e:
                raise BadRequest(f"feature {name!r}: bad npy_b64 ({e})")
        else:
            try:
                arr = np.asarray(val, dtype=np.float32)
            except (TypeError, ValueError) as e:
                raise BadRequest(f"feature {name!r}: not numeric ({e})")
        if arr.ndim not in (2, 3):
            raise BadRequest(
                f"feature {name!r}: rank {arr.ndim}, want 2-D (T, D) "
                "or 3-D (T, R, D)")
        out[name] = np.asarray(arr, dtype=np.float32)
    return out


def parse_nbest(obj) -> int:
    """Optional 'nbest' field: how many ranked hypotheses to return."""
    if not isinstance(obj, dict):
        return 1
    k = obj.get("nbest", 1)
    if isinstance(k, bool) or not isinstance(k, int) or k < 1:
        raise BadRequest("'nbest' must be a positive integer")
    return k


def _result_json(result, k: int) -> dict:
    answer, score = result
    out = {"answer": answer, "score": float(score)}
    if k > 1:
        ranked = getattr(result, "nbest", [(answer, score)])
        out["nbest"] = [{"answer": a, "score": float(s)}
                        for a, s in ranked[:k]]
    return out


def parse_request(obj) -> Request:
    """One /v1/respond JSON body -> serve.Request (with validation)."""
    if not isinstance(obj, dict):
        raise BadRequest("request body must be a JSON object")
    question = obj.get("question")
    if not isinstance(question, str) or not question.strip():
        raise BadRequest("'question' (non-empty string) is required")
    history_raw = obj.get("history", [])
    if not isinstance(history_raw, list):
        raise BadRequest("'history' must be a list of [question, answer]")
    history: List[Tuple[str, str]] = []
    for turn in history_raw:
        if (not isinstance(turn, (list, tuple)) or len(turn) != 2
                or not all(isinstance(t, str) for t in turn)):
            raise BadRequest(
                "'history' entries must be [question, answer] string pairs")
        history.append((turn[0], turn[1]))
    caption = obj.get("caption", "")
    if not isinstance(caption, str):
        raise BadRequest("'caption' must be a string")
    deadline = None
    if "deadline_ms" in obj:
        dl = obj["deadline_ms"]
        if not isinstance(dl, (int, float)) or isinstance(dl, bool) \
                or dl <= 0:
            raise BadRequest("'deadline_ms' must be a positive number")
        deadline = time.monotonic() + float(dl) / 1e3
    return Request(question=question, history=history, caption=caption,
                   features=_parse_features(obj.get("features")),
                   deadline=deadline)


class LatencyHistogram:
    """Lock-protected fixed-bucket latency histogram (seconds).

    Buckets follow the Prometheus convention: ``counts[i]`` is the
    number of observations ≤ ``BOUNDS[i]`` (cumulative at export time);
    quantiles are linearly interpolated within the winning bucket."""

    BOUNDS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
              10.0)

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.BOUNDS) + 1)  # +1 = +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, seconds: float):
        i = 0
        while i < len(self.BOUNDS) and seconds > self.BOUNDS[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += seconds
            self._count += 1

    def snapshot(self):
        with self._lock:
            return list(self._counts), self._sum, self._count

    def quantile(self, q: float) -> float:
        """Approximate quantile (seconds) by bucket interpolation."""
        counts, _, total = self.snapshot()
        if total == 0:
            return 0.0
        target = q * total
        seen = 0
        lo = 0.0
        for i, c in enumerate(counts):
            hi = self.BOUNDS[i] if i < len(self.BOUNDS) else lo * 2 or 1.0
            if seen + c >= target:
                frac = (target - seen) / c if c else 0.0
                return lo + frac * (hi - lo)
            seen += c
            lo = hi
        return lo

    def summary(self) -> dict:
        _, s, n = self.snapshot()
        return {
            "count": n,
            "mean_ms": round(1e3 * s / n, 3) if n else 0.0,
            "p50_ms": round(1e3 * self.quantile(0.5), 3),
            "p90_ms": round(1e3 * self.quantile(0.9), 3),
        }


class MTNServer(ThreadingHTTPServer):
    """ThreadingHTTPServer + the shared serving state.

    ``beam_search`` sessions get an :class:`AsyncServer` so requests
    from different connections share beam launches; other decode styles
    get a plain lock around the (thread-unsafe) session.

    ``session`` is duck-typed: any object with ``respond_batch``,
    ``decode_cfg`` and ``epoch`` serves, concretely
    :class:`~mtn_tpu_torch.serve.ServingSession` or
    :class:`~mtn_tpu_torch.utils.aot.AotSession` (``is_aot``: served
    behind the plain lock). The optional surface (``rank`` / ``stream`` /
    ``reload`` / ``model_arg``) gates the matching routes: a session
    without it answers 501 on those paths.
    """

    daemon_threads = True
    # socketserver's default listen backlog is 5; a turn_batch-sized
    # burst of concurrent clients would get connection resets
    request_queue_size = 128

    def __init__(self, addr, session: ServingSession,
                 max_in_flight: int = 2, max_wait_ms: float = 5.0,
                 admin_token: Optional[str] = None, max_queue: int = 0):
        super().__init__(addr, _Handler)
        self.session = session
        # /admin/* auth: bearer token if set, else loopback-only
        self.admin_token = admin_token
        self.max_queue = max_queue
        self.draining = False
        self.async_server: Optional[AsyncServer] = None
        # an artifact's session runs behind the plain lock: AsyncServer
        # drives the live decoder's launch/drain split
        if session.decode_cfg.decode_style == "beam_search" and \
                not getattr(session, "is_aot", False):
            self.async_server = AsyncServer(
                session, max_in_flight=max_in_flight,
                max_wait_ms=max_wait_ms, max_queue=max_queue)
        self._lock = threading.Lock()
        self._t0 = time.time()
        self.n_requests = 0
        self.n_errors = 0
        self.n_reloads = 0
        self.n_rejected = 0
        self.n_unsupported = 0
        self.n_expired_lock = 0  # lock-path deadline sheds (504); the
        #                          async path counts its own n_expired
        self._admitted = 0
        self._count_lock = threading.Lock()
        self.latency = LatencyHistogram()

    # -- serving ------------------------------------------------------------
    def _admission(self):
        """Load-shedding gate for the lock-serialized session paths
        (greedy/sample respond + all streams): bounds the number of
        requests queued on the session lock when max_queue is set."""
        import contextlib

        @contextlib.contextmanager
        def gate():
            if self.max_queue:
                with self._count_lock:
                    if self._admitted >= self.max_queue:
                        raise ServerOverloaded(
                            f"session queue full ({self._admitted} "
                            "requests in flight)")
                    self._admitted += 1
                try:
                    yield
                finally:
                    with self._count_lock:
                        self._admitted -= 1
            else:
                yield
        return gate()

    def _check_deadline(self, req: Request):
        """Lock-path deadline shed: checked AFTER the session lock is
        acquired, i.e. just before device work would start (the async
        path does the same at launch, AsyncServer._launch)."""
        if req.expired():
            self.count_expired()
            raise DeadlineExceeded(
                "deadline passed while waiting for the decode slot")

    def respond_one(self, req: Request) -> Tuple[str, float]:
        if self.async_server is not None:
            return self.async_server.respond(req)
        with self._admission(), self._lock:
            self._check_deadline(req)
            return self.session.respond_batch([req])[0]

    def rank_one(self, req: Request, candidates: List[str],
                 include_eos: bool = True):
        if not hasattr(self.session, "rank"):
            raise NotSupported("this session does not rank: serve a "
                               "checkpoint (--model) or an artifact "
                               "exported with --rank N,L")
        if self.async_server is not None:
            # continuous batching: concurrent rank requests pack into one
            # candidate-tiled launch (AsyncServer.submit_rank)
            return self.async_server.submit_rank(
                req, candidates, include_eos=include_eos).result()
        with self._admission(), self._lock:
            self._check_deadline(req)
            return self.session.rank(req, candidates,
                                     include_eos=include_eos)

    def respond_many(self, reqs: List[Request]):
        """Batch decode with PER-ROW deadline semantics:
        a row whose deadline passed before its launch is shed
        individually — its slot in the returned list holds the
        DeadlineExceeded exception while live rows still decode — so a
        mixed batch matches the single-request path instead of quietly
        serving expired callers. Only when EVERY row expired does the
        whole call raise (mapped to 504, like /v1/respond)."""
        if self.async_server is not None:
            # submit all first so the scheduler can pack them together;
            # if the queue bound hits mid-way, release what was queued
            futs = []
            try:
                for r in reqs:
                    futs.append(self.async_server.submit(r))
            except ServerOverloaded:
                for f in futs:
                    f.cancel()
                raise
            out = []
            for f in futs:
                try:
                    out.append(f.result())
                except DeadlineExceeded as e:  # shed at launch; counted
                    out.append(e)              # in AsyncServer.n_expired
            if out and all(isinstance(r, DeadlineExceeded) for r in out):
                raise DeadlineExceeded(
                    "every request's deadline passed before the decode "
                    "launched")
            return out
        with self._admission(), self._lock:
            live = [(i, r) for i, r in enumerate(reqs) if not r.expired()]
            for _ in range(len(reqs) - len(live)):
                self.count_expired()
            if reqs and not live:
                raise DeadlineExceeded(
                    "every request's deadline passed while waiting "
                    "for the decode slot")
            results = self.session.respond_batch([r for _, r in live])
            out = [DeadlineExceeded("deadline passed while waiting for "
                                    "the decode slot")] * len(reqs)
            for (i, _), res in zip(live, results):
                out[i] = res
            return out

    def queue_depth(self) -> int:
        if self.async_server is not None:
            return self.async_server.queue_depth()
        with self._count_lock:
            return self._admitted

    def mesh(self) -> dict:
        """The mesh's axis sizes and the commands rank 0 broadcast, under
        a mesh; else empty."""
        shape = getattr(self.session, "mesh_shape", None)
        if not shape:
            return {}
        lockstep = getattr(self.session, "lockstep", None)
        return {"mesh": shape, "commands": dict(
            lockstep.commands) if lockstep is not None else {}}

    def stats(self) -> dict:
        with self._count_lock:
            n, e, rej = self.n_requests, self.n_errors, self.n_rejected
            unsup = self.n_unsupported
        return {
            "requests": n,
            "errors": e,
            "rejected": rej,
            "unsupported": unsup,
            "expired": self.n_expired(),
            "queue_depth": self.queue_depth(),
            "draining": self.draining,
            "launches": (self.async_server.launches
                         if self.async_server else None),
            "uptime_s": round(time.time() - self._t0, 3),
            "decode_style": self.session.decode_cfg.decode_style,
            "turn_batch": self.session.decode_cfg.turn_batch,
            # which weights are live (reload/watcher swaps show up
            # here); basename only — /stats is unauthenticated, so the
            # server's directory layout must not leak to clients
            "model": (os.path.basename(self.session.model_arg)
                      if getattr(self.session, "model_arg", None) else None),
            "epoch": self.session.epoch,
            # an exported artifact (serve_http --aot) or a live session
            "aot": bool(getattr(self.session, "is_aot", False)),
            "latency": self.latency.summary(),
            **self.mesh(),
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition (version 0.0.4) of the serving
        counters — the standard scrape format, so a deployment plugs
        into an existing monitoring stack with no adapter."""
        with self._count_lock:
            n, e, r = self.n_requests, self.n_errors, self.n_reloads
            rejected = self.n_rejected
            unsupported = self.n_unsupported
        counts, lat_sum, lat_count = self.latency.snapshot()
        lines = [
            "# HELP mtn_requests_total Completed API requests.",
            "# TYPE mtn_requests_total counter",
            f"mtn_requests_total {n}",
            "# HELP mtn_errors_total Requests that returned 4xx/5xx.",
            "# TYPE mtn_errors_total counter",
            f"mtn_errors_total {e}",
            "# HELP mtn_reloads_total Successful /admin/reload swaps.",
            "# TYPE mtn_reloads_total counter",
            f"mtn_reloads_total {r}",
            "# HELP mtn_launches_total Decode batch launches.",
            "# TYPE mtn_launches_total counter",
            "mtn_launches_total %d" % (self.async_server.launches
                                       if self.async_server else 0),
            "# HELP mtn_rejected_total Requests shed with 503 "
            "(overload or draining).",
            "# TYPE mtn_rejected_total counter",
            f"mtn_rejected_total {rejected}",
            "# HELP mtn_unsupported_total Probes of routes this session "
            "type does not serve (501; not errors).",
            "# TYPE mtn_unsupported_total counter",
            f"mtn_unsupported_total {unsupported}",
            "# HELP mtn_expired_total Requests shed with 504 because "
            "their deadline passed before the decode launched.",
            "# TYPE mtn_expired_total counter",
            f"mtn_expired_total {self.n_expired()}",
            "# HELP mtn_queue_depth Requests waiting for a decode slot.",
            "# TYPE mtn_queue_depth gauge",
            f"mtn_queue_depth {self.queue_depth()}",
            "# HELP mtn_draining 1 while /admin/drain is in effect.",
            "# TYPE mtn_draining gauge",
            f"mtn_draining {int(self.draining)}",
            "# HELP mtn_uptime_seconds Seconds since server start.",
            "# TYPE mtn_uptime_seconds gauge",
            f"mtn_uptime_seconds {time.time() - self._t0:.3f}",
            "# HELP mtn_request_latency_seconds End-to-end request "
            "latency (decode requests only).",
            "# TYPE mtn_request_latency_seconds histogram",
        ]
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            le = (repr(LatencyHistogram.BOUNDS[i])
                  if i < len(LatencyHistogram.BOUNDS) else "+Inf")
            lines.append(
                'mtn_request_latency_seconds_bucket{le="%s"} %d'
                % (le, cum))
        lines.append(f"mtn_request_latency_seconds_sum {lat_sum:.6f}")
        lines.append(f"mtn_request_latency_seconds_count {lat_count}")
        mesh = self.mesh()
        if mesh:
            lines += ["# HELP mtn_mesh_size Ranks on each mesh axis.",
                      "# TYPE mtn_mesh_size gauge"]
            lines += [f'mtn_mesh_size{{axis="{a}"}} {n}'
                      for a, n in mesh["mesh"].items()]
            lines += ["# HELP mtn_commands_total Calls rank 0 broadcast "
                      "to the mesh, by kind.",
                      "# TYPE mtn_commands_total counter"]
            lines += [f'mtn_commands_total{{op="{op}"}} {n}'
                      for op, n in sorted(mesh["commands"].items())]
        return "\n".join(lines) + "\n"

    def count(self, error: bool = False):
        with self._count_lock:
            self.n_requests += 1
            if error:
                self.n_errors += 1

    def count_rejected(self):
        with self._count_lock:
            self.n_rejected += 1

    def count_expired(self):
        with self._count_lock:
            self.n_expired_lock += 1

    def n_expired(self) -> int:
        """Total requests shed for a passed deadline (504), both paths."""
        with self._count_lock:
            n = self.n_expired_lock
        if self.async_server is not None:
            n += self.async_server.n_expired
        return n

    def count_unsupported(self):
        # 501s (a route this session type does not serve) are tracked on
        # their own counter, not as errors: a healthy server probed for
        # such a route must not trip error-rate alerts
        with self._count_lock:
            self.n_unsupported += 1

    def reload_session(self, model: Optional[str] = None):
        """``session.reload(model)``; an artifact's swap holds the session
        lock, which every one of its decodes holds (AotSession.reload is
        not synchronized)."""
        if getattr(self.session, "is_aot", False):
            with self._lock:
                return self.session.reload(model)
        return self.session.reload(model)

    def close(self):
        """Stop accepting connections and drain the batcher."""
        stop = getattr(self, "_watch_stop", None)
        if stop is not None:
            stop.set()
        self.shutdown()
        self.server_close()
        if self.async_server is not None:
            self.async_server.stop()


def start_watcher(srv: MTNServer, interval_s: float) -> threading.Event:
    """Hot-reload watcher: poll the model arg (typically
    ``<prefix>_best`` or ``<prefix>_latest``) and reload whenever it
    resolves to another epoch than the one served, so a server pointed
    at a training run follows it. For an artifact's session, poll its
    ``meta.json`` and swap in the re-export when ``export_id`` changes
    (the exporter writes meta.json last). Returns the stop event (also
    set by ``srv.close``)."""
    import logging

    from mtn_tpu_torch.cli.generate import _split_model_arg
    from mtn_tpu_torch.weights import resolve_epoch

    log = logging.getLogger("mtn_tpu_torch.serve_http.watch")
    is_aot = getattr(srv.session, "is_aot", False)
    if not getattr(srv.session, "model_arg", None) and not is_aot:
        raise ValueError("checkpoint watch needs a session built via "
                         "ServingSession.from_checkpoint or an artifact's "
                         "AotSession")
    stop = threading.Event()
    srv._watch_stop = stop

    def changed() -> bool:
        if is_aot:
            with open(os.path.join(srv.session.art_dir, "meta.json")) as f:
                seen = json.load(f).get("export_id")
            return seen is not None and seen != srv.session.export_id
        target = resolve_epoch(*_split_model_arg(srv.session.model_arg))
        return target is not None and target != srv.session.epoch

    def loop():
        while not stop.wait(interval_s):
            try:
                if changed():
                    ep = srv.reload_session()
                    with srv._count_lock:
                        srv.n_reloads += 1
                    log.info("hot-reloaded epoch %s", ep)
            except Exception:  # keep watching; next save may be whole
                log.exception("watch: reload failed")

    threading.Thread(target=loop, daemon=True, name="mtn-watch").start()
    return stop


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: MTNServer  # set by ThreadingHTTPServer machinery

    # -- plumbing -----------------------------------------------------------
    def _send(self, code: int, payload: dict,
              extra_headers: Optional[Dict[str, str]] = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, body: str,
                   ctype: str = "text/plain; version=0.0.4"):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # route to logging, not stderr
        import logging
        logging.getLogger("mtn_tpu_torch.serve_http").debug(fmt, *args)

    def _check_admin(self):
        """Gate /admin/* routes: require the configured bearer token, or
        (when no token is set) a loopback client — /admin/reload loads
        weights from a server-side filesystem path and must not be open
        to arbitrary network clients."""
        token = getattr(self.server, "admin_token", None)
        if token:
            got = self.headers.get("Authorization", "")
            if got != f"Bearer {token}":
                raise BadRequest("admin: invalid or missing bearer token")
        elif self.client_address[0] not in ("127.0.0.1", "::1"):
            raise BadRequest("admin: loopback-only (start the server "
                             "with --admin-token to allow remote admin)")

    def _read_json(self):
        n = int(self.headers.get("Content-Length") or 0)
        if n <= 0:
            raise BadRequest("empty body")
        try:
            return json.loads(self.rfile.read(n))
        except json.JSONDecodeError as e:
            raise BadRequest(f"invalid JSON: {e}")

    # -- routes -------------------------------------------------------------
    def do_GET(self):
        if self.path == "/healthz":
            if self.server.draining:
                # 503 so load balancers eject the draining instance
                self._send(503, {"ok": False, "draining": True})
            else:
                mesh = self.server.mesh()
                self._send(200, {"ok": True, **(
                    {"mesh": mesh["mesh"]} if mesh else {})})
        elif self.path == "/stats":
            self._send(200, self.server.stats())
        elif self.path == "/metrics":
            self._send_text(200, self.server.metrics_text())
        else:
            self._send(404, {"error": f"no such path: {self.path}"})

    def _stream_events(self, req, style):
        """SSE: emit each decoded word as soon as the device yields it.
        The response has no Content-Length — the connection closes at
        the final event (close_connection below), which every SSE
        client treats as end-of-stream."""
        srv = self.server
        # admission BEFORE headers: an overload rejection must still be
        # a clean 503 (mapped by do_POST), not a broken event stream
        with srv._admission():
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True

            def event(obj):
                self.wfile.write(b"data: " + json.dumps(obj).encode()
                                 + b"\n\n")
                self.wfile.flush()

            words = []
            t0 = time.monotonic()
            try:
                # streams serialize behind the session lock (the sample
                # fold counter is shared mutable state); a beam
                # session's batcher traffic does not take the lock
                # a client gone mid-stream makes event() raise: the
                # stream is closed and gives its program set back
                with srv._lock, contextlib.closing(
                        srv.session.stream(req, style=style)) as stream:
                    for word in stream:
                        words.append(word)
                        event({"token": word})
                srv.latency.observe(time.monotonic() - t0)
                srv.count()
                event({"done": True, "answer": " ".join(words)})
            except Exception as e:  # headers are gone; surface in-stream
                srv.count(error=True)
                event({"error": f"{type(e).__name__}: {e}"})

    def _discard_body(self):
        """Drain the unread body so a keep-alive connection's next
        request parses from a clean stream."""
        n = int(self.headers.get("Content-Length") or 0)
        if n > 0:
            self.rfile.read(n)

    def do_POST(self):
        srv = self.server
        try:
            if self.path.startswith("/v1/") and srv.draining:
                self._discard_body()
                srv.count_rejected()
                self._send(503, {"error": "draining"},
                           extra_headers={"Retry-After": "5"})
                return
            if self.path == "/v1/respond":
                t0 = time.monotonic()
                body = self._read_json()
                k = parse_nbest(body)
                req = parse_request(body)
                result = srv.respond_one(req)
                srv.latency.observe(time.monotonic() - t0)
                srv.count()
                self._send(200, _result_json(result, k))
            elif self.path == "/admin/reload":
                self._check_admin()
                n = int(self.headers.get("Content-Length") or 0)
                body = self._read_json() if n > 0 else {}
                if not isinstance(body, dict):
                    raise BadRequest("body must be a JSON object")
                model = body.get("model")
                if model is not None and not isinstance(model, str):
                    raise BadRequest("'model' must be a string")
                if not hasattr(srv.session, "reload"):
                    raise NotSupported(
                        "this session type does not support hot-reload")
                try:
                    epoch = srv.reload_session(model)
                except (ValueError, FileNotFoundError) as e:
                    raise BadRequest(str(e))
                with srv._count_lock:
                    srv.n_reloads += 1
                srv.count()
                self._send(200, {"ok": True, "epoch": epoch})
            elif self.path == "/admin/drain":
                self._check_admin()
                n = int(self.headers.get("Content-Length") or 0)
                body = self._read_json() if n > 0 else {}
                if not isinstance(body, dict):
                    raise BadRequest("body must be a JSON object")
                resume = body.get("resume", False)
                if not isinstance(resume, bool):
                    raise BadRequest("'resume' must be a boolean")
                srv.draining = not resume
                srv.count()
                self._send(200, {"ok": True, "draining": srv.draining})
            elif self.path == "/v1/stream":
                body = self._read_json()
                style = (body or {}).get("style") \
                    if isinstance(body, dict) else None
                if style is not None and style not in ("greedy", "sample"):
                    raise BadRequest(
                        "'style' must be 'greedy' or 'sample'")
                if not hasattr(srv.session, "stream"):
                    raise NotSupported("this session does not stream: "
                                       "serve a checkpoint (--model) or an "
                                       "artifact exported with --stream 1")
                req = parse_request(body)
                self._stream_events(req, style)
            elif self.path == "/v1/rank":
                t0 = time.monotonic()
                body = self._read_json()
                req = parse_request(body)
                cands = body.get("candidates")
                if (not isinstance(cands, list) or not cands
                        or not all(isinstance(c, str) and c.strip()
                                   for c in cands)):
                    raise BadRequest("'candidates' (non-empty list of "
                                     "non-empty strings) is required")
                include_eos = body.get("include_eos", True)
                if not isinstance(include_eos, bool):
                    raise BadRequest("'include_eos' must be a boolean")
                ranked = srv.rank_one(req, cands, include_eos)
                srv.latency.observe(time.monotonic() - t0)
                srv.count()
                self._send(200, {"candidates": [
                    {"answer": c, "logp": s, "rank": r}
                    for c, s, r in ranked]})
            elif self.path == "/v1/respond_batch":
                t0 = time.monotonic()
                body = self._read_json()
                raw = body.get("requests") if isinstance(body, dict) else None
                if not isinstance(raw, list) or not raw:
                    raise BadRequest(
                        "'requests' (non-empty list) is required")
                k = parse_nbest(body)
                reqs = [parse_request(r) for r in raw]
                results = srv.respond_many(reqs)
                srv.latency.observe(time.monotonic() - t0)
                srv.count()
                # per-row deadline sheds come back as error entries;
                # the shed itself was already counted in
                # mtn_expired_total
                self._send(200, {"results": [
                    {"error": str(r), "code": 504}
                    if isinstance(r, DeadlineExceeded)
                    else _result_json(r, k) for r in results]})
            else:
                self._discard_body()
                self._send(404, {"error": f"no such path: {self.path}"})
        except ServerOverloaded as e:
            srv.count_rejected()
            self._send(503, {"error": str(e)},
                       extra_headers={"Retry-After": "1"})
        except DeadlineExceeded as e:
            # the shed itself is already counted (count_expired /
            # AsyncServer.n_expired); 504 is not an error: the server
            # is healthy, the caller's budget ran out
            self._send(504, {"error": str(e)})
        except NotSupported as e:
            srv.count_unsupported()
            self._send(501, {"error": str(e)})
        except BadRequest as e:
            srv.count(error=True)
            self._send(400, {"error": str(e)})
        except Exception as e:  # device/model failure
            srv.count(error=True)
            self._send(500, {"error": f"{type(e).__name__}: {e}"})


def start_server(session: ServingSession,
                 host: str = "127.0.0.1",
                 port: int = 0, max_in_flight: int = 2,
                 max_wait_ms: float = 5.0,
                 admin_token: Optional[str] = None,
                 max_queue: int = 0) -> MTNServer:
    """Bind and serve on a daemon thread; returns the (running) server.
    ``port=0`` binds an ephemeral port (``server.server_address[1]``).
    ``session`` is duck-typed — see :class:`MTNServer`."""
    srv = MTNServer((host, port), session, max_in_flight=max_in_flight,
                    max_wait_ms=max_wait_ms, admin_token=admin_token,
                    max_queue=max_queue)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="mtn-http")
    t.start()
    return srv


def main(argv=None) -> int:
    import argparse
    import logging

    from mtn_tpu_torch.cli.common import (add_logging_args, init_parallel,
                                          setup_logging)
    from mtn_tpu_torch.parallel.multihost import shutdown
    from mtn_tpu_torch.config import DecodeConfig

    parser = argparse.ArgumentParser(
        description="Serve a trained MTN checkpoint over HTTP")
    parser.add_argument("--model",
                        help="checkpoint prefix (e.g. exps/x/mtn_best)")
    parser.add_argument("--aot",
                        help="serve an artifact directory of python -m "
                             "mtn_tpu_torch.utils.aot export instead of a "
                             "checkpoint: the decode flags are frozen in "
                             "it")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", default=8080, type=int)
    parser.add_argument("--beam", default=5, type=int)
    parser.add_argument("--penalty", default=1.0, type=float)
    parser.add_argument("--nbest", default=5, type=int)
    parser.add_argument("--maxlen", default=30, type=int)
    parser.add_argument("--min-len", default=1, type=int)
    parser.add_argument("--decode-style", default="beam_search",
                        choices=["beam_search", "greedy", "sample"])
    parser.add_argument("--temperature", default=1.0, type=float)
    parser.add_argument("--top-k", default=0, type=int)
    parser.add_argument("--top-p", default=0.0, type=float)
    parser.add_argument("--sample-seed", default=1, type=int)
    parser.add_argument("--turn-batch", default=16, type=int,
                        help="server batch size (requests per launch)")
    parser.add_argument("--max-wait-ms", default=5.0, type=float,
                        help="batching window: max wait for co-riders")
    parser.add_argument("--max-in-flight", default=2, type=int,
                        help="batches launched before the oldest is "
                             "drained (inert until the beam step stops "
                             "waiting for the host)")
    parser.add_argument("--admin-token", default=None,
                        help="bearer token for /admin/* routes; without "
                             "it, admin is loopback-only")
    parser.add_argument("--max-queue", default=0, type=int,
                        help="reject requests with 503 once this many "
                             "are waiting (0 = unbounded)")
    parser.add_argument("--warmup", action="store_true",
                        help="run the decode paths on a blank request "
                             "before accepting traffic")
    parser.add_argument("--watch-seconds", default=0.0, type=float,
                        help="poll the checkpoint every N seconds and "
                             "hot-reload when its best/latest epoch "
                             "changes (0 = off)")
    parser.add_argument("--mesh-data", default=-1, type=int,
                        help="data-parallel mesh axis size (-1: all ranks)")
    parser.add_argument("--mesh-model", default=1, type=int,
                        help="tensor-parallel mesh axis size")
    parser.add_argument("--multihost", default="", type=str,
                        help="'auto' (torchrun's environment) or "
                             "'host:port,nprocs,procid': serve under a "
                             "mesh of processes, one per device; rank 0 "
                             "binds the port, the others follow it")
    parser.add_argument("--fused-decode-qkv", default=0, type=int,
                        help="fuse decode-time self-attention q/k/v into "
                             "one (D, 3D) product")
    parser.add_argument("--feature-transfer", default="",
                        choices=["", "bfloat16", "int8"],
                        help="host->device feature format (default: the "
                             "model compute dtype; int8 ships int8 "
                             "features and f32 row scales, dequantized on "
                             "the device)")
    parser.add_argument("--weights-quant", default="",
                        choices=["", "int8", "int8-fp-head"],
                        help="serve weight-only int8 weights "
                             "(mtn_tpu_torch/utils/quantize.py); "
                             "int8-fp-head keeps the vocab head full "
                             "precision")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; 'cpu' runs the kernels' plain "
                             "versions on the CPU")
    parser.add_argument("--use-pallas-attention", default=0, type=int,
                        help="use the hand-written fused attention kernel "
                             "(csrc/attention.cu)")
    parser.add_argument("--use-pallas-ffn", default=0, type=int,
                        help="use the hand-written fused FFN kernel "
                             "(csrc/ffn.cu)")
    add_logging_args(parser)
    args = parser.parse_args(argv)
    setup_logging(args.verbose)

    if bool(args.model) == bool(args.aot):
        parser.error("exactly one of --model / --aot is required")
    if args.aot:
        # a flag the artifact froze at export is refused, not ignored:
        # serving the artifact's value instead would mislead
        frozen = ["beam", "penalty", "nbest", "maxlen", "min_len",
                  "decode_style", "temperature", "top_k", "top_p",
                  "sample_seed", "turn_batch", "mesh_data", "mesh_model",
                  "multihost", "fused_decode_qkv", "feature_transfer",
                  "weights_quant", "use_pallas_attention", "use_pallas_ffn"]
        bad = [f for f in frozen
               if getattr(args, f) != parser.get_default(f)]
        if bad:
            flags = ", ".join("--" + f.replace("_", "-") for f in bad)
            parser.error(
                f"{flags}: frozen in the AOT artifact at export time; "
                "re-export with 'python -m mtn_tpu_torch.utils.aot export' "
                "to change them")
        from mtn_tpu_torch.utils.aot import AotSession
        session = AotSession(args.aot, device=args.device)
        logging.info("loaded artifact %s (exported from %s, epoch %s, "
                     "buckets %s)", args.aot, session.model_arg,
                     session.epoch, session.buckets)
    else:
        device, shardings = init_parallel(args, args.turn_batch)
        decode_cfg = DecodeConfig(
            maxlen=args.maxlen, beam=args.beam, penalty=args.penalty,
            nbest=args.nbest, min_len=args.min_len,
            decode_style=args.decode_style, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p,
            sample_seed=args.sample_seed, turn_batch=args.turn_batch)
        overrides = {"use_pallas_attention": bool(args.use_pallas_attention),
                     "use_pallas_ffn": bool(args.use_pallas_ffn),
                     "fused_decode_qkv": bool(args.fused_decode_qkv)}
        session = ServingSession.from_checkpoint(
            args.model, decode_cfg,
            mesh=shardings.mesh if shardings is not None else None,
            model_overrides=overrides,
            feature_transfer=args.feature_transfer,
            weights_quant=args.weights_quant, device=str(device))
    if session.model_cfg.dtype == "float32":
        import torch
        # full f32 products (no TF32), as the JAX package asks "highest"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if getattr(session, "mesh_rank", 0) != 0:
        done = session.follow()
        logging.info("rank %d: rank 0 stopped; ran %s", session.mesh_rank,
                     json.dumps(done, sort_keys=True))
        shutdown()
        return 0
    if args.warmup:
        sec = session.warmup(stream=True)
        logging.info("warmup: decode paths ran in %.1fs", sec)
    srv = MTNServer((args.host, args.port), session,
                    max_in_flight=args.max_in_flight,
                    max_wait_ms=args.max_wait_ms,
                    admin_token=args.admin_token,
                    max_queue=args.max_queue)
    if args.watch_seconds > 0:
        start_watcher(srv, args.watch_seconds)
        logging.info("watching %s every %.1fs for new checkpoints",
                     args.model or args.aot, args.watch_seconds)
    logging.info("serving %s on http://%s:%d (style=%s, turn_batch=%d, "
                 "device=%s, mesh=%s)", args.model or args.aot,
                 *srv.server_address, session.decode_cfg.decode_style,
                 session.decode_cfg.turn_batch, session.device,
                 getattr(session, "mesh_shape", None))
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        logging.info("shutting down")
        srv.close()
    finally:
        if hasattr(session, "close"):
            session.close()   # under a mesh: the other ranks stop
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
