"""Each decode batch on a CUDA device as one device program: the
counterpart of ``jax.jit`` over ``mtn_tpu``'s ``beam_fn``, ``greedy_fn``,
``sample_fn`` and ``rank_fn`` (``mtn_tpu/decode/beam.py``); and each
token stream as two, a prefix and a one-token step
(:class:`StreamPrograms`, ``_build_stream``'s two jitted programs).

A :class:`GraphRunner` (one per
:class:`~mtn_tpu_torch.decode.beam.BeamDecoder`) keeps one program set
per batch shape (:class:`BeamPrograms`, :class:`TokenPrograms`,
:class:`RankPrograms`):

- static input buffers, into which each batch is copied (one ``copy_``
  a tensor);
- the prefix program: the source's prefix of the mode (the decoder's
  :meth:`~mtn_tpu_torch.decode.beam.BeamDecoder.beam_prefix`,
  ``token_prefix``, ``rank_prefix``, or an AOT artifact's, in
  :mod:`mtn_tpu_torch.utils.aot`: the per-turn precompute, the tiling
  over the beam or the candidates, the zeroed KV caches and the loop's
  first carry), left in static buffers, and the exit test of step 0;
- the loop programs over that carry, built of the source's one-step
  functions (``beam_advance``, ``token_next``, ``rank_advance``). With
  ``early_stop``, a chunk of ``k`` steps (``CHUNK``) repeated while the
  exit test that the program before it left on the device holds and
  ``l <= maxlen - k``, then a tail of ``r = maxlen mod k`` steps if the
  test still holds: JAX's ``lax.while_loop``. A chunk's first step runs
  as it is, since its test held; the steps after it are masked
  (:func:`~mtn_tpu_torch.decode.steps.beam_step_masked`,
  :func:`~mtn_tpu_torch.decode.steps.token_step_at`) and end the chunk
  with its next test. Steps past the exit run and are thrown away: the
  masked pool does not move, and ``n_steps``, a device count of the
  chunks' first steps and the live masked steps, is the count of JAX's
  loop. No chunk steps past ``maxlen - 1``. Without ``early_stop``, one
  program of ``maxlen`` steps (JAX's ``lax.scan``); rank, one program of
  its L steps.

The position is a 0-d tensor of the carry that each step advances
(``l.add_(1)``), so no program bakes in a position. A sampled batch
draws the uniforms of all ``maxlen`` positions before its loop, each as
the eager loop draws it (``gumbel_uniforms(draw_seed(seed, fold, l))``),
into a static ``(maxlen, B, V)`` input: every draw is bitwise the eager
loop's.

A stream (:meth:`GraphRunner.stream`) has no loop program: the host
drives its steps, as JAX's ``stream_tokens`` does. Each step is one
replay of the step program, its (B,) tokens copied behind it into
pinned memory and read after that copy's event alone; a sampled step's
uniforms are drawn before its replay, one position at a time (a stream
usually ends early), by the same law. A stream holds its set from its
first yield to its last: the cache never drops a held set, a second
stream of the same key opened meanwhile runs eagerly, and the runner's
lock is taken for each replay only, so batches run between the steps.

On CUDA each program is a PyTorch capture, taken (under the caller's
``torch.inference_mode``) after one eager run of the prefix and one
step on a side stream, which builds and loads the kernels and sets their
attributes; the captures of a set share one memory pool, and a decode
set's are never replayed on their own:
:class:`~mtn_tpu_torch.ops.graph_loop.GraphLoop` copies them into one
executable graph, the loop as a WHILE node and the
tail as an IF node whose conditions a one-thread kernel sets on the
device (``csrc/graph_loop.cu``). A batch is then one copy into the
static inputs, one graph launch and one clone of the outputs, all
stream-ordered: nothing is read on the host until the caller fetches
the results, so the next batch can be loaded and launched behind it. A
failure to capture, to build the graph or to launch it raises: nothing
falls back to a host-driven or an eager loop. On the CPU the same
program sets run the same structure on the host
(:class:`~mtn_tpu_torch.ops.graph_loop.HostLoop`, ``capture=False``,
each test read from the tensors): the CPU tests hold them to the eager
loop and to JAX, while the decoder's CPU path stays the eager loop.

A capture launches nothing: the kernel wrappers' calls during it go to
the capture's record (:func:`mtn_tpu_torch.ops._build.recording`). A
launch of the graph adds each program's record times the number of
times it ran (:func:`mtn_tpu_torch.ops._build.replayed`): the prefix
once, the chunk and the tail as many times as the final position says,
which reaches the host with the batch's results
(:func:`mtn_tpu_torch.ops._build.defer`). So the counts stay counts of
real launches. The graphs read the model's weights where they lie: an
update in place reaches them, a new model needs a new decoder.

Program sets are keyed by every value that fixes a shape or a branch
(the mode, the batch's tensor shapes and types, the ``DecodeConfig``
fields the loop reads, the model's config and whether its weights are
int8), the role of ``jax.jit``'s cache, and admitted by
:class:`ProgramCache`, whose admission the trainer's step programs
(:mod:`mtn_tpu_torch.train.graphs`) share with their own eviction rule. A capture costs about as
much as a few eager batches and holds device memory, and served traffic
can bring many shapes (each length rounded to its bucket), so a set is
built only for a shape that comes back: a shape's first batch runs the
eager loop. At most ``MAX_PROGRAMS`` sets are kept, the least recently
used dropped first, and a shape takes the place of that set only when
it has been seen more often; a batch whose shape is refused runs the
eager loop too. Traffic that cycles over more shapes than the cache
holds thus keeps the sets it has rather than capturing at every batch.
The counts by shape (at most ``MAX_SEEN`` shapes, the least recently
seen forgotten first) are halved every ``MAX_SEEN`` batches, so that
traffic that moves on to other shapes displaces the old sets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from collections import OrderedDict
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mtn_tpu_torch.decode.steps import (all_ended_t, beam_open_t,
                                        beam_step_masked, token_init,
                                        token_step_at)
from mtn_tpu_torch.ops import _build
from mtn_tpu_torch.ops.graph_loop import GraphLoop, HostLoop
from mtn_tpu_torch.utils import profiling

# steps a chunk, from the card's sweep (chip_smoke [graphs]): a step past
# the exit costs more device time than one more pass of the WHILE node
CHUNK = 1
MAX_PROGRAMS = 8   # program sets a decoder keeps (~0.8 GB each at B160)
MAX_SEEN = 1024    # shapes a decoder counts


_FETCH_STREAMS: Dict[int, torch.cuda.Stream] = {}
_FETCH_LOCK = threading.Lock()


def _ready() -> torch.cuda.Event:
    """An event on the current stream, behind a batch's launch and the
    copies of its outputs."""
    ev = torch.cuda.Event()
    ev.record()
    return ev


@contextlib.contextmanager
def fetching(ready: Optional[torch.cuda.Event]):
    """Reads of one batch's outputs inside the block wait for ``ready``
    (recorded behind that batch) alone, not for the batches queued after
    it on the stream: they run on a side stream that waits for the event.
    With ``ready`` None (an eager or a CPU batch) the block runs as it
    is."""
    if ready is None:
        yield
        return
    dev = torch.cuda.current_device()
    with _FETCH_LOCK:
        if dev not in _FETCH_STREAMS:
            _FETCH_STREAMS[dev] = torch.cuda.Stream(dev)
        stream = _FETCH_STREAMS[dev]
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        yield


def _flat(obj) -> List[torch.Tensor]:
    """Every tensor of a (nested) tuple, dataclass or tensor, in order."""
    if torch.is_tensor(obj):
        return [obj]
    if dataclasses.is_dataclass(obj):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _flat(x)]
    return []


def _signature(obj) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in _flat(obj))


def _clone(obj):
    """A copy of a (nested) batch with every tensor cloned."""
    if torch.is_tensor(obj):
        return obj.clone()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _clone(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_clone(x) for x in obj)
    return obj


def _copy_into(dst, src) -> None:
    for d, s in zip(_flat(dst), _flat(src)):
        d.copy_(s)


class Program:
    """``fn()``, a function that reads and writes the static tensors of
    its set, as one CUDA graph (``capture``) or as it is. ``generators``:
    the CUDA generators ``fn`` draws from, registered with the graph, so
    that each replay draws from the seed and offset they hold then and
    advances them as a run of ``fn`` would. With ``keep``, the capture's
    graph is kept for a :class:`~mtn_tpu_torch.ops.graph_loop.GraphLoop`
    to copy and is never instantiated or replayed on its own."""

    def __init__(self, fn: Callable[[], None], capture: bool, pool=None,
                 generators: Sequence[torch.Generator] = (),
                 keep: bool = False):
        self.fn, self.graph, self.calls = fn, None, {}
        if capture:
            self.graph = torch.cuda.CUDAGraph(keep_graph=keep)
            for g in generators:
                self.graph.register_generator_state(g)
            ctx = torch.cuda.graph(self.graph, pool=pool,
                                   capture_error_mode="thread_local")
            # the backward's launches come from autograd's device thread,
            # on the capture stream
            with _build.recording(ctx.capture_stream.cuda_stream) as calls:
                with ctx:
                    fn()
            self.calls, self.fn = dict(calls), None

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()
            _build.replayed(self.calls)


class ProgramSet:
    """The static inputs of one batch shape and the programs over them;
    ``replays`` counts this set's program runs."""

    def __init__(self, batch, capture: bool, pool=None):
        self.capture = capture
        self.device = _flat(batch)[0].device
        self.batch = _clone(batch)
        self.pool = (pool if pool is not None or not capture
                     else torch.cuda.graph_pool_handle())
        self.programs: Dict[str, Program] = {}
        self.replays = 0

    def _build(self, warm_up: List[Callable[[], None]],
               programs: Dict[str, Callable[[], None]],
               generators: Sequence[torch.Generator] = (),
               keep: bool = False) -> None:
        """Capture ``programs`` in their order after running ``warm_up``
        once on a side stream (run nothing when not capturing); the
        warm-up is the driven device span ``capture.warm_up``."""
        if self.capture:
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side), \
                    profiling.driven_span("capture.warm_up", self.device):
                for fn in warm_up:
                    fn()
            main.wait_stream(side)
        for name, fn in programs.items():
            self.programs[name] = Program(fn, self.capture, self.pool,
                                          generators, keep)

    def run_program(self, name: str) -> None:
        self.programs[name]()
        self.replays += 1

    def load(self, batch) -> None:
        """Copy ``batch`` into the static inputs."""
        _copy_into(self.batch, batch)


class LoopPrograms(ProgramSet):
    """A decode set: the prefix and the loop's programs as one
    :class:`~mtn_tpu_torch.ops.graph_loop.GraphLoop` (CUDA) or
    :class:`~mtn_tpu_torch.ops.graph_loop.HostLoop` (the CPU), launched
    once a batch. ``launches`` counts the launches, ``reads`` the host
    reads of an exit test (the CPU's), ``iterations`` the chunks and
    tails run, the CPU's at once and the card's when the batch's final
    position reaches the host."""

    def __init__(self, batch, capture: bool):
        super().__init__(batch, capture)
        self.launches = self.reads = 0
        self.iterations = [0, 0]
        self.chunk, self.tail, self.loop = 0, 0, None

    def _build_loop(self, src) -> None:
        """The prefix and the ``chunk{n}`` programs of a decode loop: with
        ``early_stop`` a chunk of ``CHUNK`` steps repeated while the test
        ``flag`` holds, and a tail of ``maxlen mod CHUNK``; else one of
        ``maxlen`` steps."""
        cfg = self.cfg = dataclasses.replace(src.cfg)  # the key's values
        self.chunk = min(CHUNK, cfg.maxlen)
        self.tail = cfg.maxlen % self.chunk if cfg.early_stop else 0
        sizes = ({self.chunk, self.tail} - {0} if cfg.early_stop
                 else {cfg.maxlen})
        self._build([lambda: self._prefix(src), lambda: self._steps(src, 1)],
                    {"prefix": lambda: self._prefix(src),
                     **{f"chunk{n}": (lambda n=n: self._steps(src, n))
                        for n in sorted(sizes)}}, keep=True)
        if not cfg.early_stop:
            self._assemble([("prefix", None), (f"chunk{cfg.maxlen}", None)])
            return
        maxlen = cfg.maxlen
        plan = [("prefix", None),
                (f"chunk{self.chunk}", (maxlen - self.chunk, False))]
        if self.tail:
            plan.append((f"chunk{self.tail}", (maxlen - self.tail, True)))
        self._assemble(plan)

    def _assemble(self, plan: Sequence[Tuple[str, Optional[tuple]]]
                  ) -> None:
        """The loop of ``plan``: each program run once (test None) or,
        with ``(limit, once)``, while (if) the set's flag holds and ``l
        <= limit``."""
        self.plan = list(plan)
        if not self.capture:
            # the CPU's prefix makes the flag and the position anew at
            # each run: the host loop reads them at each test
            self.loop = HostLoop()
            for name, test in plan:
                body = functools.partial(self.run_program, name)
                if test is None:
                    self.loop.run(body)
                else:
                    self.loop.repeat(body, self.flag, lambda: self.l, *test)
            return
        self.loop = GraphLoop()
        for name, test in plan:
            if test is None:
                self.loop.run(self.programs[name].graph)
            else:
                self.loop.repeat(self.programs[name].graph, self.flag(),
                                 self.l, *test)
        self.loop.instantiate()

    def flag(self) -> torch.Tensor:
        """The loop's exit test, left on the device by each program."""
        raise NotImplementedError

    def runs(self, l_final: int) -> Dict[str, int]:
        """How often each program ran in a launch that ended at position
        ``l_final``: a chunk of k steps ``l // k`` times, the tail once if
        ``l mod k`` is not 0 (``r < k``)."""
        if not self.cfg.early_stop:
            return {name: 1 for name, _ in self.plan}
        out = {"prefix": 1, f"chunk{self.chunk}": l_final // self.chunk}
        if self.tail:
            out[f"chunk{self.tail}"] = int(l_final % self.chunk != 0)
        return out

    def _account(self, l_final: int) -> None:
        """Add each program's recorded launches times its runs."""
        runs = self.runs(l_final)
        for name, n in runs.items():
            _build.replayed(self.programs[name].calls, n)
        self.replays += sum(runs.values())
        self.iterations = [runs.get(f"chunk{self.chunk}", 0),
                           runs.get(f"chunk{self.tail}", 0)
                           if self.tail else 0]

    def launch(self) -> None:
        """The prefix and the loop over the loaded batch: one graph
        launch on CUDA, whose launches are counted once its final
        position reaches the host, with no read before; the loop on the
        host on the CPU."""
        self.launches += 1
        if not self.capture:
            reads = self.loop.reads
            self.loop.launch()
            self.reads += self.loop.reads - reads
            self.iterations = (self.loop.iterations + [0, 0])[:2]
            return
        self.loop.launch()
        if self.cfg.early_stop:
            _build.defer(self.l.reshape(1).clone(),
                         lambda v: self._account(v[0]))
        else:
            self._account(self.cfg.maxlen)

    def close(self) -> None:
        """Free the executable graph (a launch in flight completes)."""
        if isinstance(self.loop, GraphLoop):
            self.loop.close()


class BeamPrograms(LoopPrograms):
    """``beam_fn``: the prefix, then the chunk and tail (with
    ``early_stop``) or the ``maxlen`` steps in one program. ``flags``
    holds the next step's test and the step count."""

    def __init__(self, src, batch, capture: bool):
        super().__init__(batch, capture)
        self._build_loop(src)

    def flag(self) -> torch.Tensor:
        return self.flags[0]

    def _prefix(self, src) -> None:
        self.state, self.carry = src.beam_prefix(self.batch)
        self.l = torch.zeros((), dtype=torch.int64, device=self.device)
        self.flags = torch.zeros(2, dtype=torch.int64, device=self.device)
        if self.cfg.early_stop:
            self.flags[0].copy_(beam_open_t(self.carry[1], self.carry[2],
                                            self.l, self.cfg))

    def _steps(self, src, n: int) -> None:
        cfg = self.cfg
        advance = functools.partial(src.beam_advance, self.state)
        *carry, self_kv = self.carry
        count = self.flags[1]
        alive, live = True, count
        for i in range(n):
            if i == 0 or not cfg.early_stop:
                # a chunk runs only after its first step's test held
                *carry, self_kv = advance(self.l, *carry, self_kv)
                if cfg.early_stop:
                    live = live + 1
            else:
                *carry, self_kv, alive, live = beam_step_masked(
                    advance, self.l, *carry, self_kv, alive, live, cfg)
            self.l.add_(1)
        _copy_into(self.carry, (*carry, self_kv))
        if cfg.early_stop:
            # the next step's test, read by the next chunk's
            nxt = beam_open_t(carry[1], carry[2], self.l, cfg)
            self.flags[0].copy_(nxt if alive is True else alive & nxt)
            count.copy_(live)

    def run(self, batch):
        """``(comp_scores, comp_buf, comp_len)`` of ``batch`` and its step
        count (a 0-d device tensor with ``early_stop``), copied out of
        the static buffers behind the launch."""
        self.load(batch)
        self.launch()
        n_steps = (self.flags[1].clone() if self.cfg.early_stop
                   else self.cfg.maxlen)
        return tuple(t.clone() for t in self.carry[2:5]), n_steps


class TokenPrograms(LoopPrograms):
    """``greedy_fn`` and ``sample_fn``: the prefix, then the chunk and
    tail of :func:`~mtn_tpu_torch.decode.steps.token_step_at` (with
    ``early_stop``) or the ``maxlen`` steps in one program; a sampled set
    takes the uniforms of every position as a static input."""

    def __init__(self, src, batch, sampled: bool, capture: bool):
        super().__init__(batch, capture)
        B = _flat(batch)[0].shape[0]
        self.u = (torch.empty((src.cfg.maxlen, B, src.vocab_size),
                              dtype=torch.float32, device=self.device)
                  if sampled else None)
        self._build_loop(src)

    def flag(self) -> torch.Tensor:
        return self.alive

    def _prefix(self, src) -> None:
        dev, B = self.device, _flat(self.batch)[0].shape[0]
        self.state, self.self_kv = src.token_prefix(self.batch)
        self.toks = token_init(B, self.cfg.maxlen, dev, src.pad, src.sos)
        self.l = torch.zeros((), dtype=torch.int64, device=dev)
        if self.cfg.early_stop:
            self.alive = ~all_ended_t(self.toks, src.eos)

    def _steps(self, src, n: int) -> None:
        cfg = self.cfg

        def pick(l, cur):
            u = (None if self.u is None
                 else self.u.index_select(0, l.reshape(1))[0])
            return src.token_next(self.state, l, cur, self.self_kv, u)
        alive = True
        for i in range(n):
            # toks is written in place; a chunk runs only after its first
            # step's test held
            masked = cfg.early_stop and i > 0
            _, out = token_step_at(pick, self.l, self.toks,
                                   alive if masked else None, src.pad,
                                   src.eos)
            if masked:
                alive = out
            self.l.add_(1)
        if cfg.early_stop:
            nxt = ~all_ended_t(self.toks, src.eos)
            self.alive.copy_(nxt if alive is True else alive & nxt)

    def run(self, batch, uniforms: Callable[[int], Optional[torch.Tensor]]
            ) -> torch.Tensor:
        """(B, maxlen+1) tokens of ``batch``; ``uniforms(l)`` the (B, V)
        noise of position l (sampled sets)."""
        self.load(batch)
        if self.u is not None:
            for l in range(self.cfg.maxlen):
                self.u[l].copy_(uniforms(l))
        self.launch()
        return self.toks.clone()


class RankPrograms(LoopPrograms):
    """``rank_fn``: the prefix over the (B, N, L) candidates, then the L
    teacher-forced steps in one program (``_build_rank``'s scan)."""

    def __init__(self, src, batch, cand: torch.Tensor,
                 cand_len: torch.Tensor, capture: bool):
        super().__init__(batch, capture)
        self.cand, self.cand_len = cand.clone(), cand_len.clone()
        self.cfg = dataclasses.replace(src.cfg, early_stop=False)
        L = cand.shape[2]
        self._build([lambda: self._prefix(src), lambda: self._steps(src, 1)],
                    {"prefix": lambda: self._prefix(src),
                     "steps": lambda: self._steps(src, L)}, keep=True)
        self._assemble([("prefix", None), ("steps", None)])

    def _prefix(self, src) -> None:
        (self.state, self.self_kv, self.rows, self.inputs, self.lens,
         self.total) = src.rank_prefix(self.batch, self.cand, self.cand_len)
        self.l = torch.zeros((), dtype=torch.int64, device=self.device)

    def _steps(self, src, n: int) -> None:
        total = self.total
        for _ in range(n):
            total = src.rank_advance(self.state, self.l, self.rows,
                                     self.inputs, self.lens, total,
                                     self.self_kv)
            self.l.add_(1)
        self.total.copy_(total)

    def run(self, batch, cand: torch.Tensor,
            cand_len: torch.Tensor) -> torch.Tensor:
        """(B, N) log-likelihoods of the candidates."""
        self.load(batch)
        self.cand.copy_(cand)
        self.cand_len.copy_(cand_len)
        self.launch()
        return self.total.reshape(self.cand.shape[:2]).clone()


def eager_stream(src, batch, uniforms: Callable[[int], Optional[
        torch.Tensor]], gather: Callable = lambda t: t
                 ) -> Iterator[np.ndarray]:
    """The eager token stream of ``src`` (a decoder or an artifact's
    source): ``src.token_prefix(batch)``, then one ``src.token_next`` a
    position after ``<sos>``, each step's (B,) tokens (``gather``-ed over
    a mesh's data ranks) read to the host and yielded."""
    dev, B = _flat(batch)[0].device, _flat(batch)[0].shape[0]
    with torch.inference_mode():
        state, self_kv = src.token_prefix(batch)
        pos = torch.arange(src.cfg.maxlen, device=dev)
        cur = torch.full((B,), src.sos, dtype=torch.int64, device=dev)
    for l in range(src.cfg.maxlen):
        with torch.inference_mode():
            cur = src.token_next(state, pos[l], cur, self_kv, uniforms(l))
            host = gather(cur).cpu().numpy()
        yield host


class StreamPrograms(ProgramSet):
    """A token stream, JAX's ``_build_stream``: a prefix program
    (``token_prefix``, ``cur`` = ``<sos>``, the position ``l`` = 0) and a
    one-token step program (``token_next`` at ``l``, then ``cur`` takes
    the token and ``l`` advances), each replayed on its own: the host
    drives the loop and reads each step's tokens, as it reads each of
    JAX's. A sampled set takes the step's (B, V) uniforms as a static
    input, drawn before each replay by the eager stream's law. ``held``:
    a stream runs on the set (between its first and its last yield); a
    held set is never a cache's victim, and no other stream takes it."""

    def __init__(self, src, batch, sampled: bool, capture: bool):
        super().__init__(batch, capture)
        B = _flat(batch)[0].shape[0]
        self.cfg = dataclasses.replace(src.cfg)
        self.u = (torch.zeros((B, src.vocab_size), dtype=torch.float32,
                              device=self.device) if sampled else None)
        self.host = (torch.empty(B, dtype=torch.int64, pin_memory=True)
                     if capture else None)
        self.held = False
        self._build([lambda: self._prefix(src), lambda: self._step(src)],
                    {"prefix": lambda: self._prefix(src),
                     "step": lambda: self._step(src)})

    def _prefix(self, src) -> None:
        B = _flat(self.batch)[0].shape[0]
        self.state, self.self_kv = src.token_prefix(self.batch)
        self.cur = torch.full((B,), src.sos, dtype=torch.int64,
                              device=self.device)
        self.l = torch.zeros((), dtype=torch.int64, device=self.device)

    def _step(self, src) -> None:
        self.cur.copy_(src.token_next(self.state, self.l, self.cur,
                                      self.self_kv, self.u))
        self.l.add_(1)

    def stream(self, batch, uniforms: Callable[[int], Optional[
            torch.Tensor]], lock=None) -> Iterator[np.ndarray]:
        """Each step's (B,) host tokens of ``batch`` (``maxlen`` steps;
        the caller stops early). The caller has set ``held``; it is
        cleared when the stream ends, raises or is closed. ``lock`` is
        taken around each replay and not across a yield, nor while the
        host waits for the step's tokens."""
        lock = lock if lock is not None else contextlib.nullcontext()
        try:
            with lock, torch.inference_mode():
                self.load(batch)
                self.run_program("prefix")
            for l in range(self.cfg.maxlen):
                u = uniforms(l)
                done = None
                with lock, torch.inference_mode():
                    if self.u is not None:
                        self.u.copy_(u)
                    self.run_program("step")
                    if self.capture:
                        # behind the replay into pinned memory: the wait
                        # below is for this copy alone
                        self.host.copy_(self.cur, non_blocking=True)
                        done = _ready()
                if done is not None:
                    done.synchronize()
                yield (self.cur if done is None else self.host).numpy().copy()
        finally:
            with lock:
                self.held = False


class ProgramCache:
    """Program sets by key, and the policy that admits them (see the
    module's docstring): at most ``max_sets`` kept, shapes counted up to
    ``max_seen``; a shape takes a full cache's place of the set
    :meth:`_victim` names when it has been seen more than ``margin``
    times as often. ``batches`` counts the lookups, ``captures`` the sets
    built, ``evictions`` the sets dropped for another, ``eager`` the
    batches refused a set. Building a set (its warm-up, its captures and,
    for a loop, the graph's assembly and instantiation) is the span
    ``capture_span``."""

    capture_span = "capture"

    def __init__(self, capture: bool, max_sets: int, max_seen: int,
                 margin: int = 1):
        self.capture = capture
        self.max_sets, self.max_seen, self.margin = max_sets, max_seen, margin
        self.sets: "OrderedDict[tuple, ProgramSet]" = OrderedDict()
        self.seen: "OrderedDict[tuple, int]" = OrderedDict()
        self.batches = self.captures = self.evictions = self.eager = 0

    def _victim(self) -> Optional[tuple]:
        """The key of the set a new shape would replace: the least
        recently used that no open stream holds (None if they all are
        held)."""
        return next((k for k, ps in self.sets.items()
                     if not getattr(ps, "held", False)), None)

    def _set(self, key: tuple, make: Callable[[], ProgramSet]
             ) -> Optional[ProgramSet]:
        """The set of ``key``, built now if the shape is admitted; None
        for a batch that runs eagerly."""
        n = self.seen[key] = self.seen.pop(key, 0) + 1
        self.batches += 1
        if self.batches % self.max_seen == 0:
            for k in self.seen:
                self.seen[k] //= 2
        while len(self.seen) > self.max_seen:
            del self.seen[next(k for k in self.seen if k not in self.sets)]
        ps = self.sets.get(key)
        if ps is None:
            full = len(self.sets) >= self.max_sets
            victim = self._victim() if full else None
            if n < 2 or (full and (victim is None or n <= self.margin
                                   * self.seen[victim])):
                self.eager += 1
                return None
            if full:
                dropped = self.sets.pop(victim)
                if hasattr(dropped, "close"):
                    dropped.close()
                self.evictions += 1
            with profiling.span(self.capture_span):
                ps = self.sets[key] = make()
            self.captures += 1
        self.sets.move_to_end(key)
        return ps


class GraphRunner(ProgramCache):
    """A decoder's program sets by key and its decodes: through a set
    where one is kept or admitted, else through the decoder's eager loop
    (see the module's docstring). One decode runs at a time: the sets'
    buffers are static. A graphed batch's copy into the static inputs,
    its launch and the copies of its outputs are the device span
    ``decode.graphed_batch``."""

    capture_span = "decode.capture"

    def __init__(self, capture: bool = True):
        super().__init__(capture, MAX_PROGRAMS, MAX_SEEN)
        self._lock = threading.Lock()

    @staticmethod
    def _model_key(dec) -> tuple:
        m = dec.model
        return (repr(m.cfg), any(b.dtype == torch.int8 for b in m.buffers()),
                dec.pad, dec.sos, dec.eos, dec.unk)

    def beam(self, dec, batch):
        """``BeamDecoder.beam_batch_raw`` of ``batch``."""
        from mtn_tpu_torch.decode.beam import BeamRaw
        cfg = dec.cfg
        key = ("beam", self._model_key(dec), _signature(batch), CHUNK,
               cfg.maxlen, cfg.beam, cfg.nbest, cfg.penalty, cfg.min_len,
               cfg.early_stop)
        with self._lock:
            ps = self._set(key, lambda: BeamPrograms(dec, batch,
                                                     self.capture))
            if ps is None:
                return dec.beam_eager(batch)
            with profiling.device_span("decode.graphed_batch", ps.device):
                pool, n_steps = ps.run(batch)
            ready = _ready() if ps.capture else None
        return BeamRaw(*pool, n_steps, ready=ready)

    def tokens(self, dec, batch, style: str, fold: int) -> torch.Tensor:
        """``BeamDecoder._token_loop`` of ``batch``."""
        cfg = dec.cfg
        sampled = style == "sample" and cfg.temperature > 0.0
        key = ("sample" if sampled else "greedy", self._model_key(dec),
               _signature(batch), CHUNK, cfg.maxlen, cfg.early_stop,
               (cfg.temperature, cfg.top_k, cfg.top_p) if sampled else None)
        with self._lock:
            ps = self._set(key, lambda: TokenPrograms(
                dec, batch, sampled, self.capture))
            if ps is None:
                return dec.tokens_eager(batch, style, fold)
            with profiling.device_span("decode.graphed_batch", ps.device):
                return ps.run(batch, dec._uniforms(
                    style, fold, batch.query.shape[0], batch.query.device))

    def rank(self, dec, batch, cand: torch.Tensor, cand_len: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """``BeamDecoder._rank`` of ``batch`` and the candidates, and the
        event behind a launch (None for an eager batch)."""
        key = ("rank", self._model_key(dec), _signature(batch),
               _signature((cand, cand_len)))
        with self._lock:
            ps = self._set(key, lambda: RankPrograms(dec, batch, cand,
                                                     cand_len, self.capture))
            if ps is None:
                return dec.rank_eager(batch, cand, cand_len), None
            scores = ps.run(batch, cand, cand_len)
            return scores, _ready() if ps.capture else None

    def stream(self, dec, batch, style: str, fold: int
               ) -> Iterator[np.ndarray]:
        """``BeamDecoder.stream_tokens``' (B,) host tokens a step: through
        the :class:`StreamPrograms` set of the key where one is kept or
        admitted and no other open stream holds it, else the decoder's
        eager stream (counted in ``eager``). The runner's lock is taken
        for each replay, so batches run between a stream's steps."""
        cfg = dec.cfg
        sampled = style == "sample" and cfg.temperature > 0.0
        key = ("stream", "sample" if sampled else "greedy",
               self._model_key(dec), _signature(batch), cfg.maxlen,
               (cfg.temperature, cfg.top_k, cfg.top_p) if sampled else None)
        uniforms = dec._uniforms(style, fold, batch.query.shape[0],
                                 batch.query.device)
        with self._lock, torch.inference_mode():
            ps = self._set(key, lambda: StreamPrograms(
                dec, batch, sampled, self.capture))
            if ps is not None and ps.held:
                self.eager += 1
                ps = None
            elif ps is not None:
                ps.held = True
        if ps is None:
            yield from dec.stream_eager(batch, style, fold)
        else:
            yield from ps.stream(batch, uniforms, self._lock)
