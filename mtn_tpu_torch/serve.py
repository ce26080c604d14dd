"""Interactive serving session and continuous batching
(``mtn_tpu/serve.py``).

Load a checkpoint once, then answer dialogue turns with the port's
batched decoder. Requests are padded to ``turn_batch`` rows and to the
length buckets, so every batch of a session has the shapes of the last.

Usage::

    session = ServingSession.from_checkpoint("exps/x/mtn_best")
    answer = session.respond(
        question="is there any audio ?",
        history=[("are there people ?", "yes there is a man")],
        caption="a man sits on a couch reading a book",
        features={"i3d_rgb": arr1, "vggish": arr2},   # (T, D) each
    )

The session runs on the card unless it is built with ``device="cpu"``
(the kernels' plain versions); a CUDA device that is not there raises.
It holds the served model and its decoder in one attribute, swapped
whole by :meth:`ServingSession.reload`: a decode that started before a
reload finishes on the old weights.

Importing this module imports no model code (the decoder, the model and
device batches are imported where a session builds them), so an AOT
artifact's session (:mod:`mtn_tpu_torch.utils.aot`), which shares the
request encoding here, loads without it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mtn_tpu_torch.config import DecodeConfig, config_from_dict
from mtn_tpu_torch.data.batching import HostBatch, pad_seqs
from mtn_tpu_torch.data.vocab import BLANK, vocab_list, words2ids
from mtn_tpu_torch.decode.steps import detokenize
from mtn_tpu_torch.evalmetrics.retrieval import rank_of


def _round_up(n: int, m: int) -> int:
    return n if m <= 1 else -(-n // m) * m


class ServerOverloaded(RuntimeError):
    """Load-shedding signal: the serving queue is at capacity. HTTP
    maps this to 503 + Retry-After so callers back off instead of
    piling onto an unbounded queue."""


class DeadlineExceeded(RuntimeError):
    """A request's deadline passed before its decode launched. Expired
    requests are shed before they take device time, so under overload
    the device only works on requests whose caller is still waiting.
    HTTP maps this to 504."""


class DecodeResult(tuple):
    """An ``(answer, score)`` pair that also carries the full n-best.

    Unpacks like a 2-tuple; ``.nbest`` is the ranked ``[(answer_i,
    score_i), ...]`` list (beam sessions have ``nbest`` entries,
    greedy/sample sessions a single one)."""

    def __new__(cls, nbest):
        self = tuple.__new__(cls, nbest[0])
        self.nbest = list(nbest)
        return self


@dataclasses.dataclass
class Request:
    question: str
    history: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    caption: str = ""
    features: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # absolute time.monotonic() seconds; None = no deadline. Checked at
    # launch (AsyncServer) or once the session lock is held (serve_http)
    deadline: Optional[float] = None

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline


def encode_requests(requests: Sequence[Request], model_cfg, data_cfg, vocab,
                    length_bucket: int = 1, feature_bucket: int = 1,
                    pad_rows_to: int = 0) -> HostBatch:
    """Raw dialogue requests -> one padded HostBatch, by the history law
    of the data pipeline (the reference's data_handler)."""
    blank = np.array([vocab[BLANK]], dtype=np.int32)
    sep_cap = data_cfg.include_caption != "none" and data_cfg.separate_caption
    h_seqs, q_seqs, c_seqs = [], [], []
    ft_arrays: List[List[np.ndarray]] = [[] for _ in model_cfg.ft_sizes]
    for r in requests:
        caption = words2ids(r.caption, vocab) if r.caption else blank
        turns = list(r.history)
        if data_cfg.max_history_length > 0:  # data_handler.py:117-120 law
            turns = turns[-data_cfg.max_history_length:]
        qa = [np.concatenate([words2ids(q, vocab), words2ids(a, vocab)])
              for q, a in turns]
        head = blank if sep_cap else caption
        history = np.concatenate([head] + qa).astype(np.int32) if qa else head
        question = words2ids(r.question, vocab)
        if data_cfg.merge_source:  # data_handler.py:126-127 law
            question = np.concatenate(
                (caption, history, question)).astype(np.int32)
        h_seqs.append(history)
        q_seqs.append(question)
        c_seqs.append(caption if sep_cap else blank)
        for i, dim in enumerate(model_cfg.ft_sizes):
            name = (data_cfg.fea_type[i]
                    if i < len(data_cfg.fea_type) else str(i))
            ft = r.features.get(name) if r.features else None
            if ft is None:
                ft = np.zeros((1, dim), np.float32)
            ft = np.asarray(ft, np.float32)
            if ft.ndim == 3:  # (T, R, D) spatial: flatten regions
                ft = ft.reshape(-1, ft.shape[-1])
            ft_arrays[i].append(ft)
    n = len(requests)
    B = max(n, pad_rows_to) if pad_rows_to else n
    pad = vocab[BLANK]
    lb = max(length_bucket, 1)
    fb = max(feature_bucket, 1)

    def padded(seqs):
        L = _round_up(max(len(s) for s in seqs), lb)
        return pad_seqs(seqs, L, pad, B)

    fts, fts_len = [], []
    for i, dim in enumerate(model_cfg.ft_sizes):
        T = _round_up(max(a.shape[0] for a in ft_arrays[i]), fb)
        arr = np.zeros((B, T, dim), np.float32)
        ln = np.zeros((B,), np.int32)
        for j, a in enumerate(ft_arrays[i]):
            n_fr = min(a.shape[0], T)
            arr[j, :n_fr] = a[:n_fr, :dim]
            ln[j] = n_fr
        fts.append(arr)
        fts_len.append(ln)
    ans = np.full((B, lb), pad, np.int32)
    return HostBatch(query=padded(q_seqs), his=padded(h_seqs),
                     answer_in=ans, answer_out=ans, cap=padded(c_seqs),
                     fts=fts, fts_len=fts_len,
                     valid=(np.arange(B) < n))


def check_mesh(mesh: Optional[Mapping[str, int]]) -> None:
    """Only one device is ported: a mesh of axis sizes (``{"data": n,
    "model": m}``) with an axis larger than 1 raises."""
    if mesh and any(n > 1 for n in mesh.values()):
        raise NotImplementedError(
            "not ported to mtn_tpu_torch yet: mesh sizes > 1 "
            "(ROADMAP: parallel)")


class Served(NamedTuple):
    """The weights a session serves: its model and the decoder on it,
    replaced together."""

    model: torch.nn.Module
    decoder: BeamDecoder


class ServingSession:
    """Single-model interactive decoder (thread-unsafe; one per worker).

    ``state_dict`` is the f32 checkpoint (``weights.load_checkpoint``).
    ``weights_quant``: "" full precision; "int8" weight-only int8 decode
    (``mtn_tpu_torch/utils/quantize.py``; the FFN kernel is skipped for
    int8 weights, attention still runs); "int8-fp-head" keeps the
    vocabulary head(s) in full precision. ``feature_transfer``: the
    host-to-device feature format ("" the compute dtype, "bfloat16" or
    "int8": int8 features and f32 row scales, dequantized on the
    device)."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor], model_cfg,
                 data_cfg, vocab: Dict[str, int],
                 decode_cfg: Optional[DecodeConfig] = None, mesh=None,
                 feature_transfer: str = "", weights_quant: str = "",
                 device: str = "cuda"):
        from mtn_tpu_torch.cli.common import resolve_device
        if weights_quant not in ("", "int8", "int8-fp-head"):
            raise ValueError(f"weights_quant {weights_quant!r} "
                             "(expected '', 'int8' or 'int8-fp-head')")
        check_mesh(mesh)
        self.device = resolve_device(device)
        self.weights_quant = weights_quant
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.vocab = vocab
        self.vlist = vocab_list(vocab)
        self.decode_cfg = decode_cfg or DecodeConfig()
        self.feature_dtype = feature_transfer or model_cfg.dtype
        self.served = self._build(state_dict)
        self._lb = max(self.data_cfg.length_bucket, 1)
        self._fb = max(self.data_cfg.feature_bucket, 1)
        self._sample_calls = 0  # fold per call so noise isn't reused
        self.epoch = None       # checkpoint epoch currently served

    def _build(self, state_dict) -> Served:
        """The model on the session's device, quantized if asked, and its
        decoder. Grad mode is per thread: set here, not inherited."""
        from mtn_tpu_torch.decode.beam import BeamDecoder
        from mtn_tpu_torch.utils.quantize import quantize_model
        from mtn_tpu_torch.weights import load_model
        with torch.no_grad():
            model = load_model(self.model_cfg, state_dict, self.device)
            if self.weights_quant:
                quantize_model(
                    model, state_dict,
                    skip_generator=self.weights_quant == "int8-fp-head")
        return Served(model, BeamDecoder(model, self.decode_cfg))

    @property
    def model(self) -> torch.nn.Module:
        return self.served.model

    @property
    def decoder(self) -> BeamDecoder:
        return self.served.decoder

    def to_device(self, hb: HostBatch):
        from mtn_tpu_torch.train.batch import device_batch
        return device_batch(hb, self.device, self.feature_dtype)

    @classmethod
    def from_checkpoint(cls, model_arg: str,
                        decode_cfg: Optional[DecodeConfig] = None,
                        mesh=None, model_overrides: Optional[Dict] = None,
                        feature_transfer: str = "",
                        weights_quant: str = "",
                        device: str = "cuda") -> "ServingSession":
        """``model_arg``: a prefix with ``_best``, ``_latest`` or
        ``_<epoch>``, in the port's format (a JAX checkpoint after
        ``mtn_tpu_torch.utils.import_flax``). ``model_overrides``:
        ModelConfig fields set on top of the sidecar config, knobs with no
        effect on the weights (dtype, ``fused_decode_qkv``, the kernel
        flags)."""
        from mtn_tpu_torch.cli.common import resolve_device
        from mtn_tpu_torch.cli.generate import _split_model_arg
        from mtn_tpu_torch.weights import load_checkpoint, load_conf
        resolve_device(device)
        prefix, epoch = _split_model_arg(model_arg)
        vocab, conf = load_conf(prefix)
        model_cfg = config_from_dict("model", conf["model"])
        for key, val in (model_overrides or {}).items():
            if not hasattr(model_cfg, key):
                raise ValueError(f"unknown ModelConfig field {key!r}")
            setattr(model_cfg, key, val)
        data_cfg = config_from_dict("data", conf["data"])
        state_dict, used_epoch = load_checkpoint(prefix, epoch)
        session = cls(state_dict, model_cfg, data_cfg, vocab, decode_cfg,
                      mesh=mesh, feature_transfer=feature_transfer,
                      weights_quant=weights_quant, device=device)
        session.model_arg = model_arg
        session.epoch = used_epoch
        return session

    def reload(self, model_arg: Optional[str] = None) -> int:
        """Hot-swap the served weights from a checkpoint of the same
        architecture; returns its epoch. A new model is built on the
        device (quantized like the old one) and swapped in by one
        assignment, so decodes already running finish on the old weights
        and later ones use the new. A checkpoint that does not fit the
        served architecture raises ValueError."""
        from mtn_tpu_torch.cli.generate import _split_model_arg
        from mtn_tpu_torch.weights import load_checkpoint

        arg = model_arg or getattr(self, "model_arg", None)
        if not arg:
            raise ValueError("no checkpoint path: session was not built "
                             "via from_checkpoint and model_arg is None")
        prefix, epoch = _split_model_arg(arg)
        try:
            state_dict, used_epoch = load_checkpoint(prefix, epoch)
            served = self._build(state_dict)
        except (ValueError, FileNotFoundError):
            raise
        except Exception as e:  # key, shape or read failures
            raise ValueError(
                f"cannot restore {arg} into the served architecture: "
                f"{type(e).__name__}: {e}") from e
        self.served = served  # atomic
        self.model_arg = arg
        self.epoch = used_epoch
        return used_epoch

    def warmup(self, stream: bool = False) -> float:
        """Run the session's decode on a blank padded request (and the
        stream with ``stream=True``), so the first real request finds the
        kernels built and the device warm. A sample-style warmup advances
        the per-call fold like any other call. Returns seconds spent."""
        t0 = time.monotonic()
        blank = Request(question="")
        self.respond_batch([blank])
        if stream:
            for _ in self.stream(blank):
                pass
        return time.monotonic() - t0

    def respond_batch(self, requests: Sequence[Request]
                      ) -> List[Tuple[str, float]]:
        # pad the batch axis to turn_batch so every batch of at most
        # turn_batch requests has one shape
        rows = max(len(requests), self.decode_cfg.turn_batch)
        decoder = self.decoder
        db = self.to_device(encode_requests(
            requests, self.model_cfg, self.data_cfg, self.vocab, self._lb,
            self._fb, pad_rows_to=rows))
        eos = self.vocab["<eos>"]
        style = self.decode_cfg.decode_style
        if style in ("greedy", "sample"):
            if style == "sample":
                rows_out = decoder.sample_batch(db, fold=self._sample_calls)
                self._sample_calls += 1
            else:
                rows_out = decoder.greedy_batch(db)
            return [DecodeResult([(detokenize(r, self.vlist, eos), 0.0)])
                    for r in rows_out]
        return [DecodeResult([(a, float(s)) for a, s in
                              res.texts(self.vlist, eos)])
                for res in decoder.beam_batch(db)]

    def respond(self, question: str, history: Sequence[Tuple[str, str]] = (),
                caption: str = "",
                features: Optional[Dict[str, np.ndarray]] = None) -> str:
        req = Request(question=question, history=list(history),
                      caption=caption, features=features or {})
        return self.respond_batch([req])[0][0]

    def cand_ids(self, candidates: Sequence[str]) -> List[List[int]]:
        """Candidate strings -> token ids for rank_batch, without the
        <sos>/<eos> that words2ids wraps them in (rank_batch supplies its
        own <sos> input and, with include_eos, the <eos> target)."""
        return [words2ids(c, self.vocab)[1:-1].tolist() for c in candidates]

    def rank(self, request: Request, candidates: Sequence[str],
             include_eos: bool = True) -> List[Tuple[str, float, int]]:
        """VisDial-style discriminative mode: the candidates scored by
        generative log-likelihood under the dialogue context. Returns
        ``[(candidate, logp, rank), ...]`` in input order; ``rank`` is the
        1-indexed position under descending log-likelihood
        (``evalmetrics.retrieval.rank_of``'s tie law)."""
        if not candidates:
            raise ValueError("no candidates to rank")
        # one row: the turn is tiled over its candidates on the device
        db = self.to_device(encode_requests(
            [request], self.model_cfg, self.data_cfg, self.vocab, self._lb,
            self._fb))
        scores = self.decoder.rank_batch(db, [self.cand_ids(candidates)],
                                         include_eos=include_eos)[0]
        return [(c, s, rank_of(scores, i))
                for i, (c, s) in enumerate(zip(candidates, scores))]

    def stream(self, request: Request, style: Optional[str] = None):
        """Generator of answer words for ONE request, as they are decoded
        (one device-to-host copy per step). ``style`` is 'greedy' or
        'sample'; by default the session's, with beam sessions streaming
        greedily (an n-best cannot stream). Ends at <eos> or maxlen."""
        if style is None:
            style = self.decode_cfg.decode_style
            if style == "beam_search":
                style = "greedy"
        decoder = self.decoder
        db = self.to_device(encode_requests(
            [request], self.model_cfg, self.data_cfg, self.vocab, self._lb,
            self._fb, pad_rows_to=self.decode_cfg.turn_batch))
        fold = 0
        if style == "sample":
            fold = self._sample_calls
            self._sample_calls += 1
        eos = self.vocab["<eos>"]
        for step_tokens in decoder.stream_tokens(db, style=style, fold=fold):
            t = int(step_tokens[0])   # the one valid row
            if t == eos:
                return
            yield self.vlist[t]


class AsyncServer:
    """Continuous-batching wrapper around a :class:`ServingSession`.

    Callers ``submit`` requests at any time and get a
    ``concurrent.futures.Future``. A scheduler thread packs waiting
    requests into ``turn_batch``-padded batches and resolves futures as
    batches drain in order.

    Batching policy: a batch launches as soon as the device has a free
    in-flight slot AND either ``turn_batch`` requests are waiting or
    ``max_wait_ms`` has passed since the oldest waiting request.

    ``max_in_flight`` keeps its meaning (batches launched before the
    oldest is drained), but overlaps nothing yet: the beam loop waits for
    the device at every step for its early-stop test, so a launch returns
    with its batch decoded.

    Backpressure: with ``max_queue > 0``, ``submit`` raises
    :class:`ServerOverloaded` once that many requests are already
    waiting (approximate under concurrency: the bound protects the queue
    from runaway growth, not an exact count).
    """

    def __init__(self, session: ServingSession, max_in_flight: int = 2,
                 max_wait_ms: float = 5.0, max_queue: int = 0):
        import queue
        import threading
        if session.decode_cfg.decode_style != "beam_search":
            raise ValueError(
                "AsyncServer drives the beam decoder; build the "
                "ServingSession with decode_style='beam_search' "
                f"(got {session.decode_cfg.decode_style!r})")
        self.session = session
        self.max_in_flight = max_in_flight
        self.max_wait = max_wait_ms / 1e3
        self.max_queue = max_queue
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.launches = 0       # batch launches (for tests/metrics)
        self.n_expired = 0      # requests shed at launch (DeadlineExceeded)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request: Request):
        return self._submit("beam", request, None)

    def submit_rank(self, request: Request, candidates: Sequence[str],
                    include_eos: bool = True):
        """Enqueue a ranking request; the scheduler packs concurrent rank
        requests into one tiled rank launch (grouped by include_eos, which
        changes the scored event). The future resolves to the
        ``ServingSession.rank`` structure."""
        if not candidates:
            raise ValueError("no candidates to rank")
        return self._submit("rank", request, (list(candidates), include_eos))

    def _submit(self, kind, request, extra):
        from concurrent.futures import Future
        if self.max_queue and self._q.qsize() >= self.max_queue:
            raise ServerOverloaded(
                f"decode queue full ({self.max_queue} requests waiting)")
        fut: Future = Future()
        self._q.put((kind, request, extra, fut))
        return fut

    def queue_depth(self) -> int:
        """Approximate number of requests waiting for a launch slot."""
        return self._q.qsize()

    def respond(self, request: Request, timeout: Optional[float] = None):
        return self.submit(request).result(timeout)

    def stop(self):
        self._stop.set()
        self._thread.join()

    # -- scheduler thread ---------------------------------------------------
    def _collect(self):
        """Gather up to turn_batch waiting items, launching early only
        after max_wait_ms from the first one."""
        import queue
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.time() + self.max_wait
        cap = self.session.decode_cfg.turn_batch
        while len(batch) < cap:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _launch(self, items):
        """Launch one homogeneous group (all "beam" or all "rank" with one
        include_eos; the scheduler partitions before calling)."""
        # Claim each future first: a caller may have cancelled it while it
        # waited, and set_result on a cancelled future raises (which would
        # kill this thread); the survivors become uncancellable.
        items = [it for it in items if it[3].set_running_or_notify_cancel()]
        # shed expired requests before they take device time
        live = []
        for it in items:
            if it[1].expired():
                self.n_expired += 1
                it[3].set_exception(DeadlineExceeded(
                    "deadline passed before the decode launched"))
            else:
                live.append(it)
        items = live
        if not items:
            return None
        kind = items[0][0]
        s = self.session
        decoder = s.decoder  # one snapshot: a reload does not reach it
        reqs = [r for _, r, _, _ in items]
        db = s.to_device(encode_requests(
            reqs, s.model_cfg, s.data_cfg, s.vocab, s._lb, s._fb,
            pad_rows_to=s.decode_cfg.turn_batch))
        if kind == "rank":
            include_eos = items[0][2][1]
            cand_ids = [s.cand_ids(extra[0]) for _, _, extra, _ in items]
            cand_ids += [[] for _ in range(db.query.shape[0] - len(items))]
            raw = decoder.rank_batch_raw(db, cand_ids,
                                         include_eos=include_eos)
        else:
            raw = decoder.beam_batch_raw(db)
        self.launches += 1
        return (kind, items, raw, db.valid)

    def _drain(self, inflight_item):
        from mtn_tpu_torch.decode.beam import BeamDecoder
        kind, items, raw, valid = inflight_item
        s = self.session
        try:
            if kind == "rank":
                rows = BeamDecoder.rank_results(raw, valid)
                for (_, _, extra, fut), scores in zip(items, rows):
                    if not fut.done():
                        fut.set_result([
                            (c, sc, rank_of(scores, i))
                            for i, (c, sc) in enumerate(zip(extra[0],
                                                            scores))])
                return
            results = BeamDecoder.beam_results(raw, valid)
            for (_, _, _, fut), res in zip(items, results):
                if not fut.done():
                    fut.set_result(DecodeResult(
                        [(a, float(sc)) for a, sc in
                         res.texts(s.vlist, s.vocab["<eos>"])]))
        except Exception as e:  # surface device errors to callers
            for _, _, _, fut in items:
                if not fut.done():
                    fut.set_exception(e)

    @staticmethod
    def _partition(items):
        """Split a collected FIFO run into homogeneous launch groups:
        beam items together; rank items grouped by include_eos."""
        beams, ranks = [], {}
        for it in items:
            if it[0] == "beam":
                beams.append(it)
            else:
                ranks.setdefault(it[2][1], []).append(it)
        return ([beams] if beams else []) + list(ranks.values())

    def _loop(self):
        in_flight = []
        while not self._stop.is_set() or not self._q.empty() or in_flight:
            pairs = [] if (self._stop.is_set() and self._q.empty()) \
                else self._collect()
            for group in self._partition(pairs):
                try:
                    item = self._launch(group)
                    if item is not None:
                        in_flight.append(item)
                except Exception as e:  # encode/launch failure
                    for _, _, _, fut in group:
                        if not fut.done():
                            fut.set_exception(e)
            # drain when at capacity, or whenever there is nothing new to
            # launch (so lone batches resolve promptly)
            if in_flight and (not pairs
                              or len(in_flight) >= self.max_in_flight):
                self._drain(in_flight.pop(0))
        # A submit() racing stop() can enqueue after the final emptiness
        # check above; fail such leftovers instead of hanging callers.
        import queue
        while True:
            try:
                _, _, _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if fut.set_running_or_notify_cancel():
                fut.set_exception(RuntimeError("AsyncServer stopped"))
