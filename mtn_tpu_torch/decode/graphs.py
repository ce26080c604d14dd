"""Each decode batch on a CUDA device as captured device programs: the
counterpart of ``jax.jit`` over ``mtn_tpu``'s ``beam_fn``, ``greedy_fn``,
``sample_fn`` and ``rank_fn`` (``mtn_tpu/decode/beam.py``).

A :class:`GraphRunner` (one per
:class:`~mtn_tpu_torch.decode.beam.BeamDecoder`) keeps one program set
per batch shape (:class:`BeamPrograms`, :class:`TokenPrograms`,
:class:`RankPrograms`):

- static input buffers, into which each batch is copied (one ``copy_``
  a tensor);
- the prefix program: the decoder's prefix of the mode
  (:meth:`~mtn_tpu_torch.decode.beam.BeamDecoder.beam_prefix`,
  ``token_prefix``, ``rank_prefix``: the per-turn precompute, the tiling
  over the beam or the candidates, the zeroed KV caches and the loop's
  first carry), left in static buffers, and the exit test of step 0;
- the loop programs over that carry, built of the step functions of
  :mod:`mtn_tpu_torch.decode.steps`. With ``early_stop``, a chunk of
  ``k`` steps and a tail of ``maxlen mod k``, each replayed after one
  host read of the exit test that the program before it left on the
  device: the eager loop reads once a step, JAX's ``lax.while_loop``
  never. A chunk's first step runs as it is, since its test read true;
  the steps after it are masked (:func:`~mtn_tpu_torch.decode.steps.
  beam_step_masked`, :func:`~mtn_tpu_torch.decode.steps.token_step_at`)
  and end the chunk with its next test. Steps past the exit run and are
  thrown away: the masked pool does not move, and ``n_steps`` is the
  count of JAX's loop. No chunk steps past ``maxlen - 1``. At ``k = 1``
  (``CHUNK``) nothing is masked. Without ``early_stop``, one program of
  ``maxlen`` steps (JAX's ``lax.scan``); rank, one program of its L
  steps.

The position is a 0-d tensor of the carry that each step advances
(``l.add_(1)``), so no program bakes in a position. A sampled batch
draws the uniforms of all ``maxlen`` positions before its loop, each as
the eager loop draws it (``gumbel_uniforms(draw_seed(seed, fold, l))``),
into a static ``(maxlen, B, V)`` input: every draw is bitwise the eager
loop's.

On CUDA each program is a CUDA graph, captured (under the caller's
``torch.inference_mode``) after one eager run of the prefix and one
step on a side stream, which builds and loads the kernels and sets their
attributes before the capture; the graphs of a set share one memory
pool. A failure to capture or to replay raises: nothing falls back to
the eager loop. On the CPU the same program sets run their functions as
they are (``capture=False``): the CPU tests hold them to the eager loop
and to JAX, while the decoder's CPU path stays the eager loop.

A capture launches nothing: the kernel wrappers' calls during it go to
the capture's record (:func:`mtn_tpu_torch.ops._build.recording`), and
each replay adds the graph's launches to the kernels' counts
(:func:`mtn_tpu_torch.ops._build.replayed`), so the counts stay counts
of real launches. The graphs read the model's weights where they lie:
an update in place reaches them, a new model needs a new decoder.

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

Not built: reading chunk i's flag while chunk i+1 replays (a pinned
copy and an event), which would never stall the card at the cost of up
to one more chunk.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import torch

from mtn_tpu_torch.decode.steps import (all_ended_t, beam_open_t,
                                        beam_step, beam_step_masked,
                                        rank_step, token_init,
                                        token_step_at)
from mtn_tpu_torch.ops import _build

# steps a chunk, from the card's sweep (chip_smoke [graphs]): a wasted
# step past the exit costs more device time than a host read
CHUNK = 1
MAX_PROGRAMS = 8   # program sets a decoder keeps (~0.8 GB each at B160)
MAX_SEEN = 1024    # shapes a decoder counts


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
    advances them as a run of ``fn`` would."""

    def __init__(self, fn: Callable[[], None], capture: bool, pool=None,
                 generators: Sequence[torch.Generator] = ()):
        self.fn, self.graph, self.calls, self.capture_s = fn, None, {}, 0.0
        if capture:
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
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
            self.capture_s = time.perf_counter() - t0

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()
            _build.replayed(self.calls)


class ProgramSet:
    """The static inputs of one batch shape and the programs over them;
    ``replays`` and ``reads`` (host reads of the exit test) count this
    set's runs."""

    def __init__(self, batch, capture: bool, pool=None):
        self.capture = capture
        self.device = _flat(batch)[0].device
        self.batch = _clone(batch)
        self.pool = (pool if pool is not None or not capture
                     else torch.cuda.graph_pool_handle())
        self.programs: Dict[str, Program] = {}
        self.replays = self.reads = 0

    def _build(self, warm_up: List[Callable[[], None]],
               programs: Dict[str, Callable[[], None]],
               generators: Sequence[torch.Generator] = ()) -> None:
        """Capture ``programs`` in their order after running ``warm_up``
        once on a side stream (run nothing when not capturing)."""
        if self.capture:
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for fn in warm_up:
                    fn()
            main.wait_stream(side)
        for name, fn in programs.items():
            self.programs[name] = Program(fn, self.capture, self.pool,
                                          generators)

    def run_program(self, name: str) -> None:
        self.programs[name]()
        self.replays += 1

    def load(self, batch) -> None:
        """Copy ``batch`` into the static inputs."""
        _copy_into(self.batch, batch)

    def capture_s(self) -> Dict[str, float]:
        return {name: p.capture_s for name, p in self.programs.items()}

    def _build_loop(self, dec) -> None:
        """The prefix and the ``chunk{n}`` programs of a decode loop: with
        ``early_stop`` a chunk of ``CHUNK`` steps and a tail of ``maxlen
        mod CHUNK``, else one of ``maxlen`` steps."""
        cfg = self.cfg = dataclasses.replace(dec.cfg)  # the key's values
        self.chunk = min(CHUNK, cfg.maxlen)
        sizes = ({self.chunk, cfg.maxlen % self.chunk} - {0}
                 if cfg.early_stop else {cfg.maxlen})
        self._build([lambda: self._prefix(dec), lambda: self._steps(dec, 1)],
                    {"prefix": lambda: self._prefix(dec),
                     **{f"chunk{n}": (lambda n=n: self._steps(dec, n))
                        for n in sorted(sizes)}})

    def _chunked(self, read: Callable[[], bool]) -> int:
        """Replay the chunk programs (the tail last) while ``read()``, one
        host read of the test the last program left, is true and fewer
        than ``maxlen`` steps have run; the number of chunks replayed."""
        done = chunks = 0
        while True:
            self.reads += 1
            if not read() or done == self.cfg.maxlen:
                return chunks
            n = min(self.chunk, self.cfg.maxlen - done)
            self.run_program(f"chunk{n}")
            done += n
            chunks += 1


class BeamPrograms(ProgramSet):
    """``beam_fn``: the prefix, then the chunk and tail (with
    ``early_stop``) or the ``maxlen`` steps in one program. ``flags``
    holds the next step's test and the live masked steps' count."""

    def __init__(self, dec, batch, capture: bool):
        super().__init__(batch, capture)
        self._build_loop(dec)

    def _prefix(self, dec) -> None:
        self.state, self.carry = dec.beam_prefix(self.batch)
        self.l = torch.zeros((), dtype=torch.int64, device=self.device)
        self.flags = torch.zeros(2, dtype=torch.int64, device=self.device)
        if self.cfg.early_stop:
            self.flags[0].copy_(beam_open_t(self.carry[1], self.carry[2],
                                            self.l, self.cfg))

    def _steps(self, dec, n: int) -> None:
        cfg = self.cfg
        step = dec._stepper(self.state)
        *carry, self_kv = self.carry
        count = self.flags[1]
        alive, live = True, count
        for i in range(n):
            if i == 0 or not cfg.early_stop:
                # a chunk runs only after its first step's test read true
                *carry, self_kv = beam_step(step, self.l, *carry, self_kv,
                                            cfg, dec.eos, dec.unk)
            else:
                *carry, self_kv, alive, live = beam_step_masked(
                    step, self.l, *carry, self_kv, alive, live, cfg,
                    dec.eos, dec.unk)
            self.l.add_(1)
        _copy_into(self.carry, (*carry, self_kv))
        if cfg.early_stop:
            # the next step's test, read before the next chunk
            nxt = beam_open_t(carry[1], carry[2], self.l, cfg)
            self.flags[0].copy_(nxt if alive is True else alive & nxt)
            if live is not count:
                count.copy_(live)

    def run(self, batch):
        """``(comp_scores, comp_buf, comp_len)`` of ``batch`` and its step
        count."""
        cfg = self.cfg
        self.load(batch)
        self.run_program("prefix")
        if not cfg.early_stop:
            self.run_program(f"chunk{cfg.maxlen}")
            n_steps = cfg.maxlen
        else:
            box = []

            def read() -> bool:
                box[:] = self.flags.tolist()
                return bool(box[0])
            # each chunk's first step, then the live masked steps
            n_steps = self._chunked(read) + box[1]
        return tuple(t.clone() for t in self.carry[2:5]), n_steps


class TokenPrograms(ProgramSet):
    """``greedy_fn`` and ``sample_fn``: the prefix, then the chunk and
    tail of :func:`~mtn_tpu_torch.decode.steps.token_step_at` (with
    ``early_stop``) or the ``maxlen`` steps in one program; a sampled set
    takes the uniforms of every position as a static input."""

    def __init__(self, dec, batch, sampled: bool, capture: bool):
        super().__init__(batch, capture)
        B = batch.query.shape[0]
        self.u = (torch.empty((dec.cfg.maxlen, B, dec.model.cfg.vocab_size),
                              dtype=torch.float32, device=self.device)
                  if sampled else None)
        self._build_loop(dec)

    def _prefix(self, dec) -> None:
        dev, B = self.device, self.batch.query.shape[0]
        self.state, self.self_kv = dec.token_prefix(self.batch)
        self.toks = token_init(B, self.cfg.maxlen, dev, dec.pad, dec.sos)
        self.l = torch.zeros((), dtype=torch.int64, device=dev)
        if self.cfg.early_stop:
            self.alive = ~all_ended_t(self.toks, dec.eos)

    def _steps(self, dec, n: int) -> None:
        cfg = self.cfg
        step = dec._stepper(self.state)
        alive = True
        for i in range(n):
            u = (None if self.u is None
                 else self.u.index_select(0, self.l.reshape(1))[0])
            # toks is written in place; a chunk runs only after its first
            # step's test read true
            masked = cfg.early_stop and i > 0
            _, out = token_step_at(step, self.l, self.toks, self.self_kv,
                                   u, cfg, alive if masked else None,
                                   dec.pad, dec.eos)
            if masked:
                alive = out
            self.l.add_(1)
        if cfg.early_stop:
            nxt = ~all_ended_t(self.toks, dec.eos)
            self.alive.copy_(nxt if alive is True else alive & nxt)

    def run(self, batch, uniforms: Callable[[int], Optional[torch.Tensor]]
            ) -> torch.Tensor:
        """(B, maxlen+1) tokens of ``batch``; ``uniforms(l)`` the (B, V)
        noise of position l (sampled sets)."""
        cfg = self.cfg
        self.load(batch)
        if self.u is not None:
            for l in range(cfg.maxlen):
                self.u[l].copy_(uniforms(l))
        self.run_program("prefix")
        if cfg.early_stop:
            self._chunked(lambda: bool(self.alive))
        else:
            self.run_program(f"chunk{cfg.maxlen}")
        return self.toks.clone()


class RankPrograms(ProgramSet):
    """``rank_fn``: the prefix over the (B, N, L) candidates, then the L
    teacher-forced steps in one program (``_build_rank``'s scan)."""

    def __init__(self, dec, batch, cand: torch.Tensor,
                 cand_len: torch.Tensor, capture: bool):
        super().__init__(batch, capture)
        self.cand, self.cand_len = cand.clone(), cand_len.clone()
        L = cand.shape[2]
        self._build([lambda: self._prefix(dec), lambda: self._steps(dec, 1)],
                    {"prefix": lambda: self._prefix(dec),
                     "steps": lambda: self._steps(dec, L)})

    def _prefix(self, dec) -> None:
        (self.state, self.self_kv, self.rows, self.inputs, self.lens,
         self.total) = dec.rank_prefix(self.batch, self.cand, self.cand_len)
        self.l = torch.zeros((), dtype=torch.int64, device=self.device)

    def _steps(self, dec, n: int) -> None:
        step = dec._stepper(self.state)
        total = self.total
        for _ in range(n):
            total = rank_step(step, self.l, self.rows, self.inputs,
                              self.lens, total, self.self_kv)
            self.l.add_(1)
        self.total.copy_(total)

    def run(self, batch, cand: torch.Tensor,
            cand_len: torch.Tensor) -> torch.Tensor:
        """(B, N) log-likelihoods of the candidates."""
        self.load(batch)
        self.cand.copy_(cand)
        self.cand_len.copy_(cand_len)
        self.run_program("prefix")
        self.run_program("steps")
        return self.total.reshape(self.cand.shape[:2]).clone()


class ProgramCache:
    """Program sets by key, and the policy that admits them (see the
    module's docstring): at most ``max_sets`` kept, shapes counted up to
    ``max_seen``; a shape takes a full cache's place of the set
    :meth:`_victim` names when it has been seen more than ``margin``
    times as often. ``batches`` counts the lookups, ``captures`` the sets
    built, ``evictions`` the sets dropped for another, ``eager`` the
    batches refused a set."""

    def __init__(self, capture: bool, max_sets: int, max_seen: int,
                 margin: int = 1):
        self.capture = capture
        self.max_sets, self.max_seen, self.margin = max_sets, max_seen, margin
        self.sets: "OrderedDict[tuple, ProgramSet]" = OrderedDict()
        self.seen: "OrderedDict[tuple, int]" = OrderedDict()
        self.batches = self.captures = self.evictions = self.eager = 0

    def _victim(self) -> tuple:
        """The key of the set a new shape would replace: the least
        recently used."""
        return next(iter(self.sets))

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
            if n < 2 or (full and n <= self.margin * self.seen[victim]):
                self.eager += 1
                return None
            if full:
                del self.sets[victim]
                self.evictions += 1
            ps = self.sets[key] = make()
            self.captures += 1
        self.sets.move_to_end(key)
        return ps


class GraphRunner(ProgramCache):
    """A decoder's program sets by key and its decodes: through a set
    where one is kept or admitted, else through the decoder's eager loop
    (see the module's docstring). One decode runs at a time: the sets'
    buffers are static."""

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
            pool, n_steps = ps.run(batch)
        return BeamRaw(*pool, n_steps)

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
            return ps.run(batch, dec._uniforms(
                style, fold, batch.query.shape[0], batch.query.device))

    def rank(self, dec, batch, cand: torch.Tensor,
             cand_len: torch.Tensor) -> torch.Tensor:
        """``BeamDecoder._rank`` of ``batch`` and the candidates."""
        key = ("rank", self._model_key(dec), _signature(batch),
               _signature((cand, cand_len)))
        with self._lock:
            ps = self._set(key, lambda: RankPrograms(dec, batch, cand,
                                                     cand_len, self.capture))
            if ps is None:
                return dec.rank_eager(batch, cand, cand_len)
            return ps.run(batch, cand, cand_len)
