"""The trainer's step programs of ``mtn_tpu_torch.train.graphs``, run
without capture on the CPU (``StepGraphs(capture=False)``): train,
accumulation and eval steps through the program sets bitwise the eager
trainer, the set built inside the run; the program-run steps against
JAX's ``train_step``; Noam/Adam with its scalars on the device against
optax across the warmup and after a resume; dropout draws keyed by
``(seed, step, microbatch)`` and a resumed run equal to the
uninterrupted one; the admission of step shapes; the launch record of a
capture's other threads; and the branch that keeps the CPU, meshes and
``nan_checks`` out of the capture code (tiny configs, f32)."""

import dataclasses
import threading
import types

import jax
import numpy as np
import optax
import pytest
import torch

from mtn_tpu.train.schedule import make_optimizer
from mtn_tpu_torch.decode import graphs as decode_graphs
from mtn_tpu_torch.ops import _build
from mtn_tpu_torch.train import graphs
from mtn_tpu_torch.train.batch import blank_like
from mtn_tpu_torch.train.schedule import NoamAdam
from mtn_tpu_torch.train.trainer import load_opt_state, opt_state_by_name
from mtn_tpu_torch.weights import (from_flax, opt_state_from_optax,
                                   optax_adam_fields)
from tests.test_torch_train import (ATOL, _cfg, _fields, _port_trainer,
                                    jax_step)  # noqa: F401
from tests.torch_parity import (both_batches, one_thread,  # noqa: F401
                                seeded_params)

pytestmark = pytest.mark.usefixtures("one_thread")


def _programs(tr):
    """``tr`` taking its step programs for CPU tensors, the programs run
    as they are."""
    tr.graphs = graphs.StepGraphs(capture=False)
    tr.graphed = lambda t: True
    return tr


def _batch(seed, B=2):
    return both_batches(_fields(seed=seed, B=B))[1]


def _rows(db, lo, n):
    """Rows ``[lo, lo + n)`` of a device batch."""
    cut = lambda v: (tuple(t[lo:lo + n] for t in v) if isinstance(v, tuple)
                     else v[lo:lo + n])
    return dataclasses.replace(db, **{f.name: cut(getattr(db, f.name))
                                      for f in dataclasses.fields(db)})


def _state_tensors(state):
    o = state.opt_state
    return [*state.params.values(), *o.mu, *o.nu, o.t]


def _assert_same_state(a, b):
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# -- Noam/Adam with device scalars --------------------------------------------
def _tree(rng, scale):
    return {"dec": {"w": (rng.standard_normal((4, 3)) * scale).astype(
        np.float32), "b": (rng.standard_normal(3) * scale).astype(
            np.float32)}, "emb": (rng.standard_normal((5, 2)) * scale
                                  ).astype(np.float32)}


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_device_scalar_adam_matches_optax_across_warmup_and_resume(clip):
    """Eight updates at warmup 4 (the rate's corner at update 3), the
    rate and bias corrections computed on the device from ``t``; after
    the fifth the optax state is carried into a fresh ``AdamState``
    (``load_opt_state``, as a resumed run does) and three more updates
    follow on both sides."""
    rng = np.random.default_rng(5)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, 2.0) for _ in range(8)]
    opt = make_optimizer(16, 4, grad_clip=clip)
    jstate, jp, states = opt.init(params), params, []
    for g in grads:
        upd, jstate = opt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        states.append((jax.tree.map(np.asarray, jp),
                       jax.tree.map(np.asarray, jstate)))
    names = list(from_flax(params))
    adam = NoamAdam(16, 4, grad_clip=clip)

    def run(tp, st, gs):
        for g in gs:
            gd = from_flax(g)
            adam.prepare(st)
            adam.apply(tp, [gd[n].clone() for n in names], st)
            st.count += 1
            assert float(st.t) == st.count - 1   # the count it read

    def check(tp, k):
        want = from_flax(states[k][0])
        for n, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), want[n].numpy(),
                                       rtol=0, atol=ATOL, err_msg=n)
    sd = from_flax(params)
    tp = [sd[n].clone() for n in names]
    st = adam.init(tp)
    run(tp, st, grads)
    check(tp, 7)
    # resumed after the fifth update
    p5, s5 = states[4]
    sd5 = from_flax(p5)
    tp = [sd5[n].clone() for n in names]
    resumed = types.SimpleNamespace(params=dict(zip(names, tp)),
                                    opt_state=adam.init(tp))
    load_opt_state(resumed, opt_state_from_optax(*optax_adam_fields(s5)))
    assert resumed.opt_state.count == 5
    run(tp, resumed.opt_state, grads[5:])
    check(tp, 7)


# -- the step programs against the eager trainer and JAX ----------------------
def test_programs_run_bitwise_the_eager_trainer():
    """Train, accumulation (with clipping) and eval steps at dropout 0.1
    with remat, through the program sets and eagerly, from one state:
    every step's metrics, and the masters, moments, device count and
    counts after the run, bitwise equal. Each mode's first step of a
    shape runs eagerly, its second builds the set (inside the run), its
    later ones run the set."""
    cfg = _cfg(dropout=0.1, attn_dropout=0.1)
    sd = from_flax(seeded_params(cfg, seed=8))
    a, b = _batch(1), _batch(2, B=4)
    micro = [_rows(b, 0, 2), _rows(b, 2, 2)]
    steps = [("train", a), ("train", a), ("train", b), ("accum", micro),
             ("train", a), ("accum", micro), ("train", b),
             ("accum", [micro[0], blank_like(micro[0])]), ("accum", micro),
             ("eval", a), ("eval", a), ("eval", a)]
    runs = []
    for graphed in (False, True):
        tr = _port_trainer(cfg, grad_clip=0.5, remat=True)
        if graphed:
            _programs(tr)
        state = tr.state_from(sd)
        out = []
        for mode, batch in steps:
            if mode == "train":
                m = tr.train_step(state, batch, 3)[1]
            elif mode == "accum":
                m = tr.train_step_accum(state, batch, 3)[1]
            else:
                tr.load(state.params)
                m = tr.eval_step(batch)
            out.append({k: v.clone() for k, v in m.items()})
        runs.append((tr, state, out))
    (_, s_eager, m_eager), (tr, s_prog, m_prog) = runs
    for (mode, _), x, y in zip(steps, m_eager, m_prog):
        assert x.keys() == y.keys()
        for k in x:
            torch.testing.assert_close(x[k], y[k], rtol=0, atol=0,
                                       msg=f"{mode} {k}")
    _assert_same_state(s_eager, s_prog)
    assert s_prog.step == 9
    # sets: train a, train b, accum (two microbatches; a blank-tailed
    # group has their shapes), eval a; the eager steps are each shape's
    # first; without capture the step that builds a set runs its program
    assert {k[0] for k in tr.graphs.sets} == {"train", "accum", "eval"}
    assert tr.graphs.captures == 4 and tr.graphs.eager == 4
    ps = tr.graphs.sets[next(k for k in tr.graphs.sets if k[0] == "accum")]
    assert ps.replays == 3


def test_program_steps_match_jax(jax_step):
    """The port trainer, through the program sets, takes JAX's state
    after two ``train_step``s (clipping on) and steps three times, the
    same state reloaded in place before each: the shape's first step
    runs eagerly, the second builds the set and runs it, the third runs
    it again; each gives JAX's third state. The K projections' biases
    apart, as in ``test_jax_train_state_resumes_in_the_port`` (their
    true gradient is 0, so Adam turns rounding noise into steps of about
    the rate)."""
    st2, st3 = jax_step["states"][1], jax_step["states"][2]
    tr = _programs(_port_trainer(jax_step["cfg"], grad_clip=1.0))
    opt = lambda: opt_state_from_optax(*optax_adam_fields(st2.opt_state))
    state = tr.state_from(from_flax(st2.params), opt(), step=2)
    want = from_flax(st3.params)
    for k in range(3):
        if k:   # JAX's second state again, in the same tensors
            with torch.no_grad():
                for n, t in from_flax(st2.params).items():
                    state.params[n].copy_(t)
            load_opt_state(state, opt())
            state.step = 2
        state, _ = tr.train_step(state, jax_step["tdb"], 0)
        assert state.step == state.opt_state.count == 3
        for n, t in state.params.items():
            if not n.endswith(".w_k.bias"):
                np.testing.assert_allclose(t.numpy(), want[n].numpy(),
                                           atol=1e-5, err_msg=f"{k} {n}")
    assert tr.graphs.captures == 1 and tr.graphs.eager == 1
    assert next(iter(tr.graphs.sets.values())).replays == 2


# -- dropout draws ------------------------------------------------------------
def test_dropout_draws_are_keyed_by_seed_step_and_microbatch():
    """A microbatch's masks are a function of its key alone: the same key
    in another microbatch's generators draws the same, another
    microbatch's key differs; an accumulation step's loss is the sum of
    its microbatches' losses at keys ``(seed, step, i)``, bitwise; a run
    with remat draws what a run without it draws."""
    cfg = _cfg(dropout=0.1, attn_dropout=0.1)
    sd = from_flax(seeded_params(cfg, seed=6))
    b = _batch(2)
    out = {}
    for remat in (False, True):
        tr = _port_trainer(cfg, remat=remat)
        tr.state_from(sd)
        torch.manual_seed(11)          # the global RNG plays no part
        loss = lambda key, micro, norm=None: tr.loss_and_grads(
            b, key, norm=norm, micro=micro)[0].clone()
        assert torch.equal(loss((4, 9, 1), 1), loss((4, 9, 1), 0))
        assert not torch.equal(loss((4, 9, 1), 1), loss((4, 9, 0), 1))
        ntok = torch.clamp((b.answer_out != 1).sum().float() * 2, min=1.0)
        ae = torch.clamp((b.query != 1).sum().float() * 2, min=1.0)
        parts = [loss((4, 9, i), i, (ntok, ae)) for i in range(2)]
        state = tr.state_from(sd, step=9)
        _, m = tr.train_step_accum(state, [b, b], 4)
        torch.testing.assert_close(m["loss"], parts[0] + parts[1], rtol=0,
                                   atol=0)
        out[remat] = parts
    for x, y in zip(out[False], out[True]):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


@pytest.mark.parametrize("accum", [1, 2])
def test_resumed_run_equals_the_uninterrupted_one(accum):
    """Six updates through the program sets at dropout 0.1, against
    three, the state carried by name into a new trainer (a checkpoint's
    content), and three more: masters, moments and counts bitwise."""
    cfg = _cfg(dropout=0.1, attn_dropout=0.1)
    sd = from_flax(seeded_params(cfg, seed=9))
    b = _batch(3, B=4)
    batch = [_rows(b, 0, 2), _rows(b, 2, 2)] if accum > 1 else b

    def steps(tr, state, n):
        for _ in range(n):
            state = (tr.train_step_accum(state, batch, 5) if accum > 1
                     else tr.train_step(state, batch, 5))[0]
        return state
    tr = _programs(_port_trainer(cfg, grad_clip=0.5))
    whole = steps(tr, tr.state_from(sd), 6)
    tr = _programs(_port_trainer(cfg, grad_clip=0.5))
    half = steps(tr, tr.state_from(sd), 3)
    saved = ({n: t.clone() for n, t in half.params.items()},
             {k: (v if k == "count" else {n: t.clone() for n, t in
                                          v.items()})
              for k, v in opt_state_by_name(half).items()}, half.step)
    tr = _programs(_port_trainer(cfg, grad_clip=0.5))
    resumed = steps(tr, tr.state_from(*saved), 3)
    _assert_same_state(whole, resumed)
    assert tr.graphs.captures == 1


# -- admission of step shapes -------------------------------------------------
def test_step_sets_keys_and_bound(monkeypatch):
    """Sets are keyed by mode, state, the model's config and
    ``grad_clip``, the number of microbatches and the batches' shapes; at
    most ``MAX_PROGRAMS`` are kept (the decode runner's admission: a
    shape's second step builds; a full cache's least often seen set goes,
    and only for a shape seen more than ``MARGIN`` times as often); a new
    state drops them."""
    monkeypatch.setattr(graphs, "MAX_PROGRAMS", 2)
    cfg = _cfg()
    tr = _programs(_port_trainer(cfg, grad_clip=0.5))
    state = tr.state_from(from_flax(seeded_params(cfg, seed=4)))
    a, b = _batch(1), _batch(2, B=4)
    assert isinstance(tr.graphs, decode_graphs.ProgramCache)
    for _ in range(2):
        tr.train_step(state, a, 0)
        tr.eval_step(a)
    assert tr.graphs.captures == 2 and tr.graphs.eager == 2
    (train_key, _), (eval_key, _) = tr.graphs.sets.items()
    assert train_key[:3] == ("train", id(state), (repr(tr.model_cfg), 0.5))
    assert eval_key[:2] == ("eval", (repr(tr.model_cfg), 0.5))
    assert train_key[-1] == decode_graphs._signature(a)
    for _ in range(4):                         # at most twice as often
        tr.train_step(state, b, 0)
    assert tr.graphs.captures == 2 and len(tr.graphs.sets) == 2
    tr.train_step(state, b, 0)                 # more: replaces a's set
    assert tr.graphs.captures == 3 and tr.graphs.evictions == 1
    assert [k[0] for k in tr.graphs.sets] == ["eval", "train"]
    assert next(reversed(tr.graphs.sets))[-1] == decode_graphs._signature(b)
    micro = [_rows(b, 0, 2), _rows(b, 2, 2)]
    for _ in range(5):                         # replaces eval, seen least
        tr.train_step_accum(state, micro, 0)
    key = next(reversed(tr.graphs.sets))
    assert key[0] == "accum" and key[3] == 2
    assert [k[0] for k in tr.graphs.sets] == ["train", "accum"]
    assert tr.graphs.captures == 4 and len(tr.graphs.sets) == 2
    tr.state_from(from_flax(seeded_params(cfg, seed=4)))
    assert not tr.graphs.sets


def test_equally_frequent_shapes_keep_their_sets(monkeypatch):
    """Traffic over more shapes than the cache holds, each about as
    often as the others, keeps the sets it built first (none is
    rebuilt); a shape seen more than twice as often as the least often
    seen set replaces that one, not the least recently used; every set
    of a trainer captures into the one pool."""
    monkeypatch.setattr(graphs, "MAX_PROGRAMS", 2)
    sg = graphs.StepGraphs(capture=False)
    built = []

    def get(key):
        return sg._set(key, lambda: built.append(key) or key)
    for key in "aaaaabb":
        get(key)
    for _ in range(10):
        for key in "cdab":
            get(key)
    assert built == ["a", "b"] and sg.evictions == 0
    assert (sg.seen["a"], sg.seen["b"], sg.seen["c"]) == (15, 12, 10)
    get("b")                           # the least seen, used last
    assert [get("e") for _ in range(27)] == [None] * 26 + ["e"]
    assert list(sg.sets) == ["a", "e"] and sg.evictions == 1
    sg.capture = True
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 7))
    assert sg._pool() == (0, 7) and sg._pool() is sg.pool


def test_capture_records_the_launches_of_other_threads(monkeypatch):
    """Under ``recording(stream)`` a wrapper's launch from another thread
    (autograd's device thread runs the backward) goes to the record when
    that thread's current stream is the capture stream, and is counted
    as a launch when it is another stream."""
    kernel = _build.Kernel("probe", lambda lib: None)
    local = threading.local()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: types.
                        SimpleNamespace(cuda_stream=getattr(local, "s", 0)))
    x = torch.zeros(3, 4)

    def other(stream):
        local.s = stream
        kernel.count((x, True))
    with _build.recording(stream=7) as calls:
        for s in (7, 7, 8):
            t = threading.Thread(target=other, args=(s,))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    assert calls == {(kernel, ((3, 4), True)): 2} and kernel.launches == 1
    assert not _build._BY_STREAM
    kernel.count((x, True))
    assert kernel.launches == 2


# -- what never reaches the capture code --------------------------------------
def test_cpu_meshes_and_nan_checks_never_reach_the_capture_code(
        monkeypatch):
    """The trainer takes its programs only for CUDA tensors, without a
    mesh and without ``nan_checks``: on the CPU train, accumulation and
    eval steps run eagerly with the programs and the capture made to
    raise."""
    def refuse(*a, **k):
        raise AssertionError("reached the capture code")
    monkeypatch.setattr(graphs.StepGraphs, "step", refuse)
    monkeypatch.setattr(decode_graphs.Program, "__init__", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    cfg = _cfg()
    tr = _port_trainer(cfg)
    state = tr.state_from(from_flax(seeded_params(cfg, seed=4)))
    a = _batch(1)
    for _ in range(2):
        tr.train_step(state, a, 0)
        tr.train_step_accum(state, [a, a], 0)
        tr.eval_step(a)
    assert state.step == 4 and not tr.graphs.sets
    cuda_like = types.SimpleNamespace(is_cuda=True)
    assert tr.graphed(cuda_like) and not tr.graphed(a.query)
    tr.nan_checks = True
    assert not tr.graphed(cuda_like)
    for data, layout in ((object(), None), (None, object())):
        meshed = _port_trainer(cfg)
        meshed.data, meshed.layout = data, layout
        assert not meshed.graphed(cuda_like)
