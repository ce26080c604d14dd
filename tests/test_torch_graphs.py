"""The device-exit decode loops of ``mtn_tpu_torch.decode.graphs``, run
eagerly on the CPU (``GraphRunner(capture=False)``): the chunked beam
loop bitwise the eager loop and margin-aware JAX's ``beam_batch`` for
every chunk length, its step count JAX's ``while_loop`` count, the
early-stop table closing before ``maxlen``; greedy, sample (the uniforms
drawn before the loop) and rank bitwise their eager loops; the launch
record of a capture; the program cache and its admission of shapes; and
the branch that keeps the CPU and meshes out of the capture code."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from mtn_tpu.config import DecodeConfig as JDecodeConfig
from mtn_tpu.decode.beam import BeamDecoder as JBeamDecoder
from mtn_tpu_torch.config import DecodeConfig
from mtn_tpu_torch.decode import graphs
from mtn_tpu_torch.decode.beam import BeamDecoder
from mtn_tpu_torch.decode.steps import (NEG_INF, all_ended, all_ended_t,
                                        beam_open, beam_open_t)
from mtn_tpu_torch.ops import _build
from tests.test_torch_beam import (_assert_margin_aware,  # noqa: F401
                                   _table_decoders, setup)
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MAXLEN = 8
CHUNKS = [1, 2, 3, MAXLEN]
RANK_TOL = 1e-4


def _graphed(dec, chunk, monkeypatch):
    """``dec`` taking its runner for CPU tensors, the runner running its
    program sets eagerly, ``chunk`` steps a chunk."""
    monkeypatch.setattr(graphs, "CHUNK", chunk)
    dec.graphs = graphs.GraphRunner(capture=False)
    dec.graphed = lambda t: True
    return dec


def _second(dec, fn):
    """``fn()`` twice: the shape's first batch runs the eager loop and
    builds no set, the second runs the set built for it; both results."""
    first = fn()
    assert not dec.graphs.sets and dec.graphs.eager == 1
    second = fn()
    assert len(dec.graphs.sets) == 1 and dec.graphs.captures == 1
    return first, second


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX's results by call, each compiled and run once for the module."""
    cfg, params, jdb, tdb, model = setup
    cache = {}

    def run(kind, **kw):
        key = (kind, tuple(sorted(kw.items())))
        if key not in cache:
            dec = JBeamDecoder(cfg, JDecodeConfig(**kw))
            if kind == "beam":
                raw = dec.beam_batch_raw(params, jdb)
                cache[key] = (dec.beam_results(raw, jdb.valid), int(raw[3]))
            else:
                cache[key] = dec.greedy_batch(params, jdb)
        return cache[key]
    return run


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("penalty", [0.0, 1.0])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_beam_matches_eager_and_jax(setup, jax_runs, chunk,
                                            penalty, monkeypatch):
    cfg, params, jdb, tdb, model = setup
    kw = dict(maxlen=MAXLEN, beam=3, nbest=3, penalty=penalty)
    jres, jsteps = jax_runs("beam", **kw)
    dec = _graphed(BeamDecoder(model, DecodeConfig(**kw)), chunk,
                   monkeypatch)
    first, raw = _second(dec, lambda: dec.beam_batch_raw(tdb))
    want = dec.beam_eager(tdb)
    for got in (first, raw):
        _assert_same((got.comp_scores, got.comp_buf, got.comp_len),
                     (want.comp_scores, want.comp_buf, want.comp_len))
    assert raw.n_steps == first.n_steps == want.n_steps == jsteps
    _assert_margin_aware(jres, dec.beam_results(raw, tdb.valid))
    ps = next(iter(dec.graphs.sets.values()))
    # one host read before each chunk and one after the last, the last
    # chunk the one that holds the exit
    chunks = -(-raw.n_steps // chunk)
    assert ps.reads == chunks + 1
    assert int(ps.l) == min(chunks * chunk, MAXLEN)
    assert sorted(ps.programs) == sorted(
        ["prefix"] + [f"chunk{n}" for n in {chunk, MAXLEN % chunk} - {0}])


@pytest.mark.parametrize("chunk", [1, 3])
def test_fixed_loop_is_one_program(setup, chunk, monkeypatch):
    """Without early_stop the loop is one program of maxlen steps (the
    scan), bitwise the eager loop, with no host read."""
    cfg, params, jdb, tdb, model = setup
    kw = dict(maxlen=MAXLEN, beam=3, nbest=3, penalty=1.0, early_stop=False)
    dec = _graphed(BeamDecoder(model, DecodeConfig(**kw)), chunk,
                   monkeypatch)
    _, raw = _second(dec, lambda: dec.beam_batch_raw(tdb))
    want = dec.beam_eager(tdb)
    _assert_same((raw.comp_scores, raw.comp_buf, raw.comp_len),
                 (want.comp_scores, want.comp_buf, want.comp_len))
    assert raw.n_steps == MAXLEN
    ps = next(iter(dec.graphs.sets.values()))
    assert sorted(ps.programs) == ["chunk8", "prefix"] and ps.reads == 0
    assert ps.replays == 2


@pytest.mark.parametrize("chunk", CHUNKS)
def test_table_early_stop_closes_before_maxlen(setup, chunk, monkeypatch):
    """The early-stop table of ``test_torch_beam``: the chunked loop
    closes before maxlen, masks every step after its exit, and equals
    the full run and JAX's early-stopped run."""
    cfg, params, jdb, tdb, model = setup
    beam, rows = 3, jdb.query.shape[0] * 3
    table = np.full((rows, cfg.vocab_size), np.float32(-9.0))
    table[:, 4:8] = np.log(np.array([0.2, 0.1, 0.1, 0.05], np.float32))
    table[:, 3] = np.float32(np.log(0.5))
    kw = dict(maxlen=12, beam=beam, nbest=2, penalty=0.5)
    _, tfull = _table_decoders(setup, table, early_stop=False, **kw)
    jearly, tearly = _table_decoders(setup, table, early_stop=True, **kw)
    _graphed(tearly, chunk, monkeypatch)
    _, raw = _second(tearly, lambda: tearly.beam_batch_raw(tdb))
    want = tearly.beam_eager(tdb)
    jraw = jearly.beam_batch_raw(params, jdb)
    assert raw.n_steps == want.n_steps == int(jraw[3]) < kw["maxlen"]
    _assert_same((raw.comp_scores, raw.comp_buf, raw.comp_len),
                 (want.comp_scores, want.comp_buf, want.comp_len))
    got = tearly.beam_results(raw, tdb.valid)
    assert got == tfull.beam_batch(tdb)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in jearly.beam_batch(params, jdb)]


def test_masked_pool_does_not_move_after_the_exit(setup, monkeypatch):
    """Steps past the exit run and are thrown away: a chunk as long as
    maxlen over the table decoder leaves the pool at the exit's, and the
    host reads the test twice, before the chunk and after it."""
    cfg, params, jdb, tdb, model = setup
    rows = jdb.query.shape[0] * 3
    table = np.full((rows, cfg.vocab_size), np.float32(-9.0))
    table[:, 4:8] = np.log(np.array([0.2, 0.1, 0.1, 0.05], np.float32))
    table[:, 3] = np.float32(np.log(0.5))
    _, dec = _table_decoders(setup, table, maxlen=12, beam=3, nbest=2,
                             penalty=0.5, early_stop=True)
    _graphed(dec, 12, monkeypatch)
    _, raw = _second(dec, lambda: dec.beam_batch_raw(tdb))
    want = dec.beam_eager(tdb)
    ps = next(iter(dec.graphs.sets.values()))
    assert raw.n_steps < 12 and ps.reads == 2 and int(ps.l) == 12
    _assert_same((raw.comp_scores, raw.comp_buf, raw.comp_len),
                 (want.comp_scores, want.comp_buf, want.comp_len))


@pytest.mark.parametrize("penalty", [-0.3, 0.0, 2.0])
def test_open_tests_on_the_device(penalty):
    """The tensor forms of the early-stop tests agree with the host
    booleans at every position, around the bound too."""
    cfg = DecodeConfig(maxlen=6, penalty=penalty)
    rng = np.random.default_rng(3)
    scores = torch.from_numpy(
        -rng.uniform(0, 4, (4, 3)).astype(np.float32))
    for l in range(cfg.maxlen):
        future = (penalty * cfg.maxlen if penalty >= 0
                  else penalty * (l + 1.0))
        edge = scores.max(dim=1).values + future
        for shift in (-1e-3, 0.0, 1e-3):
            comp = torch.full((4, 2), NEG_INF)
            comp[:, -1] = edge + shift
            want = bool((edge >= comp[:, -1]).any())
            t = beam_open_t(scores, comp, torch.tensor(l), cfg)
            assert t.dtype == torch.bool and t.dim() == 0
            assert bool(t) == beam_open(scores, comp, l, cfg) == want
    toks = torch.tensor([[2, 5, 3, 1], [2, 3, 1, 1]])
    assert bool(all_ended_t(toks, 3)) and all_ended(toks, 3)
    toks[0, 2] = 6
    assert not bool(all_ended_t(toks, 3)) and not all_ended(toks, 3)


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_greedy_matches_eager_and_jax(setup, jax_runs, chunk,
                                              early_stop, monkeypatch):
    cfg, params, jdb, tdb, model = setup
    dcfg = dict(maxlen=6, early_stop=early_stop)
    dec = _graphed(BeamDecoder(model, DecodeConfig(**dcfg)), chunk,
                   monkeypatch)
    _, toks = _second(dec, lambda: dec.greedy_tokens(tdb))
    want = dec.tokens_eager(tdb, "greedy", 0)
    assert torch.equal(toks, want)
    assert dec.greedy_batch(tdb) == jax_runs("greedy", **dcfg)


@pytest.mark.parametrize("fold", [0, 3])
@pytest.mark.parametrize("chunk", [1, 4, 6])
def test_chunked_sample_matches_eager(setup, chunk, fold, monkeypatch):
    """The uniforms of every position drawn before the loop give the
    eager loop's draws bitwise."""
    cfg, params, jdb, tdb, model = setup
    dcfg = DecodeConfig(maxlen=6, temperature=1.5, top_k=8, top_p=0.9,
                        sample_seed=11)
    dec = _graphed(BeamDecoder(model, dcfg), chunk, monkeypatch)
    first, toks = _second(dec, lambda: dec.sample_tokens(tdb, fold))
    want = dec.tokens_eager(tdb, "sample", fold)
    assert torch.equal(toks, want) and torch.equal(first, want)
    ps = next(iter(dec.graphs.sets.values()))
    assert ps.u.shape == (6, tdb.query.shape[0], cfg.vocab_size)


def test_rank_is_one_program(setup, monkeypatch):
    """Rank: the prefix and one program of L steps, bitwise the eager
    loop and within 1e-4 of JAX's ``rank_batch``."""
    cfg, params, jdb, tdb, model = setup
    cands = [[[5, 9, 4], [7], [11, 12, 13, 14, 6]], [[8, 8], [10, 4, 6]],
             [[19], [4, 5, 6, 7, 8, 9, 10]], [[12, 3]], [[6]], [[7, 7]]]
    dec = _graphed(BeamDecoder(model, DecodeConfig()), 1, monkeypatch)
    first, got = _second(dec, lambda: dec.rank_batch(tdb, cands))
    assert got == first == BeamDecoder(model, DecodeConfig()).rank_batch(
        tdb, cands)
    ps = next(iter(dec.graphs.sets.values()))
    assert sorted(ps.programs) == ["prefix", "steps"] and ps.reads == 0
    want = JBeamDecoder(cfg, JDecodeConfig()).rank_batch(params, jdb, cands)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=RANK_TOL)


def test_program_cache_keys_and_bound(setup, monkeypatch):
    """One set per shape and branch, built at the shape's second batch
    (the first runs eagerly); at most ``MAX_PROGRAMS``, the least
    recently used dropped first, and only for a shape seen more often
    than it; a hit runs the cached set."""
    cfg, params, jdb, tdb, model = setup
    monkeypatch.setattr(graphs, "MAX_PROGRAMS", 2)
    dec = _graphed(BeamDecoder(model, DecodeConfig(maxlen=4, beam=2,
                                                   nbest=2)), 2, monkeypatch)
    half = dataclasses.replace(
        tdb, **{f.name: (getattr(tdb, f.name)[:3]
                         if torch.is_tensor(getattr(tdb, f.name))
                         else tuple(t[:3] for t in getattr(tdb, f.name)))
                for f in dataclasses.fields(tdb)})
    runner = dec.graphs
    a = runner.beam(dec, tdb)                 # first batches: eager
    runner.beam(dec, half)
    assert not runner.sets and runner.eager == 2
    b = runner.beam(dec, tdb)                 # second batches: built
    runner.beam(dec, half)
    assert len(runner.sets) == 2 and runner.captures == 2
    first = next(iter(runner.sets.values()))
    c = runner.beam(dec, tdb)                 # a hit: now the newest
    assert next(reversed(runner.sets.values())) is first
    assert runner.captures == 2
    for got in (b, c):
        _assert_same((a.comp_scores, a.comp_buf),
                     (got.comp_scores, got.comp_buf))
    dec.cfg.early_stop = False                # another branch
    runner.beam(dec, tdb)
    runner.beam(dec, tdb)     # seen as often as the oldest set: refused
    assert runner.captures == 2 and runner.eager == 4
    runner.beam(dec, tdb)     # seen more often: takes the oldest's place
    assert runner.captures == 3 and len(runner.sets) == 2
    assert first in runner.sets.values()
    runner.tokens(dec, tdb, "greedy", 0)      # another mode
    assert len(runner.sets) == 2 and runner.eager == 5


def test_cycling_shapes_keep_their_sets(monkeypatch):
    """Traffic cycling over more shapes than the cache holds keeps the
    sets it built and runs the other shapes eagerly, with no capture at
    every batch; a shape that comes more often than the least recently
    used set takes its place."""
    monkeypatch.setattr(graphs, "MAX_PROGRAMS", 2)
    runner = graphs.GraphRunner(capture=False)
    built = []

    def get(key):
        return runner._set(key, lambda: built.append(key) or key)
    for _ in range(5):
        for key in "abcd":
            get(key)
    assert built == ["a", "b"] and runner.eager == 12
    assert [get("e") for _ in range(6)] == [None] * 5 + ["e"]
    assert built == ["a", "b", "e"] and list(runner.sets) == ["b", "e"]


def test_shape_counts_are_bounded_and_age(monkeypatch):
    """At most ``MAX_SEEN`` shapes are counted (the least recently seen
    without a set forgotten first, a kept set's never), and every
    ``MAX_SEEN`` batches the counts halve."""
    monkeypatch.setattr(graphs, "MAX_PROGRAMS", 1)
    monkeypatch.setattr(graphs, "MAX_SEEN", 4)
    runner = graphs.GraphRunner(capture=False)

    def get(key):
        return runner._set(key, lambda: key)
    assert [get("a") for _ in range(3)] == [None, "a", "a"]
    assert runner.seen["a"] == 3
    get("a")                                  # the 4th batch: halved
    assert runner.seen["a"] == 2
    for key in "bcdef":
        get(key)
    assert list(runner.seen) == ["a", "d", "e", "f"]
    assert runner.seen["a"] == 1 and list(runner.sets) == ["a"]


def test_capture_record_counts_replays():
    """A wrapper's launch under ``recording`` (a capture) goes to the
    record by argument shapes; each replay adds it to the kernel's count
    and tells the listeners."""
    kernel = _build.Kernel("probe", lambda lib: None)
    x, w = torch.zeros(5, 8), torch.zeros(8, 16)
    kernel.count((x, w, True))
    assert kernel.launches == 1
    with _build.recording() as calls:
        kernel.count((x, w, True))
        kernel.count((x, w, True))
        kernel.count((w, w, False))
    assert kernel.launches == 1
    assert calls == {(kernel, ((5, 8), (8, 16), True)): 2,
                     (kernel, ((8, 16), (8, 16), False)): 1}
    heard = []
    _build.REPLAY_LISTENERS.append(heard.append)
    try:
        _build.replayed(calls)
        _build.replayed(calls)
    finally:
        _build.REPLAY_LISTENERS.remove(heard.append)
    assert kernel.launches == 7 and heard == [calls, calls]
    kernel.count((x, w, True))
    assert kernel.launches == 8


def test_cpu_and_meshes_never_reach_the_capture_code(setup, monkeypatch):
    """The decoder takes the runner only for CUDA tensors without a
    mesh: on the CPU every mode decodes through the eager loops, with the
    runner and the capture made to raise; a decoder with a data or a
    model axis refuses the runner for a CUDA tensor too."""
    cfg, params, jdb, tdb, model = setup

    def refuse(*a, **k):
        raise AssertionError("reached the capture code")
    for name in ("beam", "tokens", "rank"):
        monkeypatch.setattr(graphs.GraphRunner, name, refuse)
    monkeypatch.setattr(graphs.Program, "__init__", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    dcfg = DecodeConfig(maxlen=5, beam=2, nbest=2, temperature=1.0)
    dec = BeamDecoder(model, dcfg)
    assert dec.beam_batch(tdb)
    assert dec.greedy_batch(tdb) and dec.sample_batch(tdb, fold=1)
    assert dec.rank_batch(tdb, [[[5, 6]]] * tdb.query.shape[0])
    cuda_like = types.SimpleNamespace(is_cuda=True)
    assert dec.graphed(cuda_like) and not dec.graphed(tdb.query)
    for data, model_axis in ((object(), None), (None, object())):
        meshed = BeamDecoder(model, dcfg, shardings=types.SimpleNamespace(
            data=data, model=model_axis))
        assert not meshed.graphed(cuda_like)


@pytest.mark.parametrize("penalty", [0.0, 1.0])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_loop_exit_count_is_jax_while_loop_count(setup, jax_runs, chunk,
                                                 penalty, monkeypatch):
    """The loop's passes (the chunk's and the tail's) are the chunks
    JAX's ``while_loop`` count needs, ``n_steps`` is that count, and the
    card's accounting, which sees only the final position, finds the
    same passes."""
    cfg, params, jdb, tdb, model = setup
    kw = dict(maxlen=MAXLEN, beam=3, nbest=3, penalty=penalty)
    _, jsteps = jax_runs("beam", **kw)
    dec = _graphed(BeamDecoder(model, DecodeConfig(**kw)), chunk,
                   monkeypatch)
    _, raw = _second(dec, lambda: dec.beam_batch_raw(tdb))
    ps = next(iter(dec.graphs.sets.values()))
    assert torch.is_tensor(raw.n_steps) and raw.n_steps.dim() == 0
    assert int(raw.n_steps) == jsteps
    passes, tail = ps.iterations
    assert passes + tail == -(-jsteps // chunk)
    assert tail == int(MAXLEN % chunk != 0 and passes * chunk < jsteps)
    runs = ps.runs(int(ps.l))
    assert runs[f"chunk{chunk}"] == passes and runs["prefix"] == 1
    assert runs.get(f"chunk{MAXLEN % chunk}", 0) == tail or \
        MAXLEN % chunk == 0
    assert ps.launches == 1 and ps.replays == 1 + passes + tail
    dec.beam_results(raw, tdb.valid)
    assert raw.n_steps == jsteps and isinstance(raw.n_steps, int)


@pytest.mark.parametrize("chunk", [1, 4, 6])
def test_token_loop_passes(setup, chunk, monkeypatch):
    """Greedy's loop makes as many passes as the chunks of the eager
    loop's steps, and the accounting from the final position agrees."""
    cfg, params, jdb, tdb, model = setup
    dec = _graphed(BeamDecoder(model, DecodeConfig(maxlen=6)), chunk,
                   monkeypatch)
    _, toks = _second(dec, lambda: dec.greedy_tokens(tdb))
    eager_steps = next(l for l in range(7) if l == 6 or all_ended(
        toks[:, :l + 1], dec.eos))
    ps = next(iter(dec.graphs.sets.values()))
    assert sum(ps.iterations) == -(-eager_steps // chunk)
    runs = ps.runs(int(ps.l))
    assert sum(n for name, n in runs.items() if name != "prefix") == \
        sum(ps.iterations)


class _Device:
    """The loop as the device runs it: host reads allowed only inside
    :class:`~mtn_tpu_torch.ops.graph_loop.HostLoop`'s launch."""

    def __init__(self, monkeypatch):
        self.inside = False
        self.launches = 0
        launch = graphs.HostLoop.launch

        def device_launch(loop):
            self.launches += 1
            self.inside = True
            try:
                launch(loop)
            finally:
                self.inside = False
        monkeypatch.setattr(graphs.HostLoop, "launch", device_launch)
        for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                     "numpy"):
            orig = getattr(torch.Tensor, name)

            def guarded(t, *a, _orig=orig, _name=name, **k):
                if not self.inside and self.armed:
                    raise AssertionError(f"host read ({_name}) before "
                                         "the fetch")
                return _orig(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, guarded)
        self.armed = False


def test_no_host_read_before_the_fetch(setup, monkeypatch):
    """A batch on a program set is one launch of the loop and returns
    with no host read outside it (on the card nothing reads until the
    fetch): the step count stays a device tensor; greedy, sample and
    rank alike. The fetched results are the eager loop's."""
    cfg, params, jdb, tdb, model = setup
    dcfg = DecodeConfig(maxlen=6, beam=3, nbest=3, penalty=1.0,
                        temperature=1.0, top_k=8, sample_seed=5)
    dec = _graphed(BeamDecoder(model, dcfg), 2, monkeypatch)
    cands = [[[5, 9, 4], [7]]] * tdb.query.shape[0]
    calls = {"beam": lambda: dec.beam_batch_raw(tdb),
             "greedy": lambda: dec.greedy_tokens(tdb),
             "sample": lambda: dec.sample_tokens(tdb, 2),
             "rank": lambda: dec.rank_batch_raw(tdb, cands)[0]}
    for fn in calls.values():
        _second(dec, fn) if not dec.graphs.sets else (fn(), fn())
    assert len(dec.graphs.sets) == 4
    device = _Device(monkeypatch)
    got = {}
    for name, fn in calls.items():
        device.armed = True
        n = device.launches
        got[name] = fn()
        device.armed = False
        assert device.launches == n + 1, name
    assert torch.is_tensor(got["beam"].n_steps)
    want = dec.beam_eager(tdb)
    _assert_same((got["beam"].comp_scores, got["beam"].comp_buf,
                  got["beam"].comp_len),
                 (want.comp_scores, want.comp_buf, want.comp_len))
    assert int(got["beam"].n_steps) == want.n_steps
    assert torch.equal(got["greedy"], dec.tokens_eager(tdb, "greedy", 0))
    assert torch.equal(got["sample"], dec.tokens_eager(tdb, "sample", 2))
    assert torch.equal(got["rank"], dec.rank_batch_raw(tdb, cands)[0])


def test_launch_accounting_adds_body_calls_times_passes(setup,
                                                        monkeypatch):
    """A launch adds each program's recorded calls times its runs, the
    chunk's and the tail's from the final position (the card's
    accounting), and tells the listeners once a run."""
    cfg, params, jdb, tdb, model = setup
    dec = _graphed(BeamDecoder(model, DecodeConfig(maxlen=MAXLEN, beam=3,
                                                   nbest=3)), 3, monkeypatch)
    _second(dec, lambda: dec.beam_batch_raw(tdb))
    ps = next(iter(dec.graphs.sets.values()))
    kernel = _build.Kernel("probe", lambda lib: None)
    for name, n in (("prefix", 5), ("chunk3", 7), ("chunk2", 11)):
        ps.programs[name].calls = {(kernel, ((4, 4),)): n}
    heard = []
    _build.REPLAY_LISTENERS.append(heard.append)
    try:
        ps._account(8)       # 2 passes of 3 steps, then the tail of 2
        assert kernel.launches == 5 + 2 * 7 + 11
        ps._account(6)       # 2 passes, no tail
        assert kernel.launches == 30 + 5 + 2 * 7
        ps._account(3)       # 1 pass: the exit after it
        assert kernel.launches == 49 + 5 + 7
    finally:
        _build.REPLAY_LISTENERS.remove(heard.append)
    assert len(heard) == 4 + 3 + 2
    assert ps.iterations == [1, 0]
    _build.replayed({(kernel, ()): 2}, times=3)
    assert kernel.launches == 61 + 6
