"""The port's training tools against ``mtn_tpu``'s: checkpoint averaging
(``utils/average.py``), the async checkpoint save, ``--nan-checks``,
``--profile-dir``, ``--batched-ae 1`` on the train CLI, and the parallel
set-up of the CLIs on a world of one (CPU)."""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtn_tpu.utils.average import _resolve_epochs as jax_resolve
from mtn_tpu_torch.cli import generate as generate_cli
from mtn_tpu_torch.cli import rank as rank_cli
from mtn_tpu_torch.cli import train as train_cli
from mtn_tpu_torch.cli.common import make_mesh_from_args
from mtn_tpu_torch.config import TrainConfig
from mtn_tpu_torch.train.trainer import Trainer
from mtn_tpu_torch.utils import average, profiling
from mtn_tpu_torch.utils.checkpoint import CheckpointManager
from mtn_tpu_torch.weights import from_flax, load_checkpoint, save_conf
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import (one_thread, port_cfg, seeded_params,
                                train_argv)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

AVAILABLE = [1, 2, 3, 5]
SPECS = [["all"], ["last"], ["last2"], ["last9"], ["2", "3"], ["5"],
         ["last0"], ["4"], ["2", "7"]]


@pytest.mark.parametrize("spec", SPECS, ids=["-".join(s) for s in SPECS])
def test_resolve_epochs_equals_jax(spec):
    def outcome(fn, available):
        try:
            return fn(spec, available)
        except (ValueError, FileNotFoundError) as e:
            return type(e)
    assert outcome(average._resolve_epochs, AVAILABLE) == \
        outcome(jax_resolve, AVAILABLE)
    assert outcome(average._resolve_epochs, []) == \
        outcome(jax_resolve, []) == FileNotFoundError


def _family(tmp_path, n_epochs=3):
    """A port checkpoint family of seeded params, one seed per epoch."""
    cfg = tiny_model_cfg(30, (12, 8))
    prefix = str(tmp_path / "src" / "mtn")
    os.makedirs(os.path.dirname(prefix))
    save_conf(prefix, {"<unk>": 0}, model=cfg)
    ckpt = CheckpointManager(prefix)
    trees = []
    for e in range(1, n_epochs + 1):
        tree = seeded_params(cfg, seed=10 + e)
        trees.append(tree)
        tr = Trainer(port_cfg(cfg), TrainConfig(), "cpu")
        ckpt.save(e, tr.state_from(from_flax(tree)), val_loss=float(e))
    return prefix, trees


def test_average_equals_jax_average(tmp_path):
    """The averaged epoch is JAX's mean of the same params (f32 sum in
    epoch order, divided, cast back), bit for bit; the family carries
    the sidecars, the best pointer and a fresh optimizer state."""
    prefix, trees = _family(tmp_path)
    out = str(tmp_path / "avg" / "mtn-avg")
    assert average.average_checkpoints(prefix, ["last2"], out,
                                       "cpu") == [2, 3]
    acc = None
    for tree in trees[1:]:
        p32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree)
        acc = p32 if acc is None else jax.tree.map(jnp.add, acc, p32)
    want = from_flax(jax.tree.map(lambda s: np.asarray(s / 2), acc))
    got, epoch = load_checkpoint(out, "best")
    assert epoch == 1 and got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert os.path.exists(out + ".conf.json")
    assert json.load(open(out + ".vocab.json")) == {"<unk>": 0}
    opt = torch.load(out + "_torch/epoch_1.opt.pt", weights_only=True)
    assert opt["step"] == 0 and opt["count"] == 0
    assert all(not t.any() for t in opt["mu"].values())


def test_average_main_and_all_epochs(tmp_path):
    prefix, trees = _family(tmp_path)
    out = str(tmp_path / "avg" / "all")
    assert average.main(["--model", prefix, "--epochs", "all",
                         "--out", out, "--device", "cpu"]) == 0
    got, _ = load_checkpoint(out, "best")
    flat = [from_flax(t) for t in trees]
    for k, v in got.items():
        mean = (flat[0][k] + flat[1][k] + flat[2][k]) / 3
        torch.testing.assert_close(v, mean, rtol=0, atol=1e-6)
    with pytest.raises(FileNotFoundError):
        average.average_checkpoints(prefix, ["9"], out, "cpu")


def test_average_needs_a_gpu_unless_told_cpu(tmp_path):
    """The mean runs on the card by default, as every entry point does;
    with no GPU it raises before it reads or writes a file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "avg" / "mtn-avg")
    with pytest.raises(RuntimeError, match="--device cpu"):
        average.main(["--model", str(tmp_path / "none"), "--out", out])
    assert not os.path.exists(tmp_path / "avg")


def test_averaged_family_decodes_through_generate(tiny_corpus, tmp_path):
    c = tiny_corpus
    prefix = str(tmp_path / "run" / "mtn")
    assert train_cli.main(train_argv(c, prefix, "--num-epochs", "2")) == 0
    out = str(tmp_path / "run" / "mtn-avg")
    average.main(["--model", prefix, "--epochs", "last2", "--out", out,
                  "--device", "cpu"])
    result = tmp_path / "result.json"
    assert generate_cli.main([
        "--model", out + "_best", "--device", "cpu", "--dtype", "float32",
        "--test-path", c.fea_path, "--test-set", c.test_set, "--beam", "3",
        "--nbest", "3", "--maxlen", "8", "--turn-batch", "4",
        "--undisclosed-only", "1", "--output", str(result)]) == 0
    answers = [qa["answer"] for d in json.loads(result.read_text())["dialogs"]
               for qa in d["dialog"]]
    assert answers and "__UNDISCLOSED__" not in answers


def _state(seed=0):
    cfg = port_cfg(tiny_model_cfg(30, (12, 8)))
    tr = Trainer(cfg, TrainConfig(), "cpu")
    state = tr.state_from(from_flax(seeded_params(
        tiny_model_cfg(30, (12, 8)), seed=seed)))
    state.step = 7
    state.opt_state.count = 7
    return state


def _disk_meta(ckpt):
    path = os.path.join(ckpt.dir, "meta.json")
    return json.load(open(path)) if os.path.exists(path) else {}


def test_async_save_defers_the_commit_and_writes_the_sync_files(tmp_path):
    sync = CheckpointManager(str(tmp_path / "sync" / "mtn"))
    asyn = CheckpointManager(str(tmp_path / "async" / "mtn"),
                             async_save=True)
    state = _state()
    for ckpt in (sync, asyn):
        ckpt.save(1, state, val_loss=2.0)
    assert _disk_meta(sync)["epochs"] == [1]
    assert _disk_meta(asyn) == {}           # the commit waits
    # the saved state is a copy: changing the live state changes nothing
    with torch.no_grad():
        for t in state.params.values():
            t.add_(1.0)
    asyn.save(2, state, val_loss=1.0, keep=1)   # commits epoch 1 first
    assert _disk_meta(asyn)["epochs"] == [1]
    sync.save(2, state, val_loss=1.0, keep=1)
    asyn.flush()
    assert _disk_meta(asyn) == _disk_meta(sync) == {
        "epochs": [2], "best_loss": 1.0, "best_epoch": 2}
    assert sorted(os.listdir(asyn.dir)) == sorted(os.listdir(sync.dir))
    for name in os.listdir(sync.dir):
        if name.endswith(".pt"):
            with open(os.path.join(sync.dir, name), "rb") as a, \
                    open(os.path.join(asyn.dir, name), "rb") as b:
                assert a.read() == b.read(), name


def test_async_step_slot_rotates_and_restores(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "mtn"), async_save=True)
    ckpt.save_step(_state(seed=1), epoch=0, batch_idx=3)
    assert "step" not in _disk_meta(ckpt)
    state = _state(seed=2)
    ckpt.save_step(state, epoch=1, batch_idx=5)
    assert _disk_meta(ckpt)["step_batch"] == 3
    restored, epoch, batch = ckpt.restore_step(_state(seed=9))
    assert (epoch, batch, restored.step) == (1, 5, 7)
    for k, t in state.params.items():
        assert torch.equal(restored.params[k], t), k


def test_async_save_raises_a_failed_write(tmp_path, monkeypatch):
    ckpt = CheckpointManager(str(tmp_path / "mtn"), async_save=True)

    def fail(obj, path):
        raise OSError("disk full")
    monkeypatch.setattr(CheckpointManager, "_save_atomic",
                        staticmethod(fail))
    ckpt.save(1, _state())
    with pytest.raises(OSError, match="disk full"):
        ckpt.flush()


def test_cli_train_async_save_equals_sync(tiny_corpus, tmp_path):
    runs = {}
    for tag, extra in (("sync", []), ("async", ["--async-save", "1"])):
        prefix = str(tmp_path / tag / "mtn")
        assert train_cli.main(train_argv(tiny_corpus, prefix,
                                         "--num-epochs", "2",
                                         "--keep-checkpoints", "1",
                                         *extra)) == 0
        runs[tag] = prefix + "_torch"
    for name in sorted(os.listdir(runs["sync"])):
        with open(os.path.join(runs["sync"], name), "rb") as a, \
                open(os.path.join(runs["async"], name), "rb") as b:
            assert a.read() == b.read(), name
    assert sorted(os.listdir(runs["sync"])) == \
        sorted(os.listdir(runs["async"]))


def _nan_corpus(c, tmp_path):
    """A copy of the corpus's features with every frame of every video
    NaN in the first stream."""
    feats = tmp_path / "nan_feats"
    for i, ft in enumerate(c.fea_types):
        os.makedirs(feats / ft)
        for p in (c.root / ft).glob("*.npy"):
            a = np.load(p)
            np.save(feats / ft / p.name, np.full_like(a, np.nan)
                    if i == 0 else a)
    return str(feats / "<FeaType>" / "<ImageID>.npy")


def test_nan_checks_raise_on_an_injected_nan(tiny_corpus, tmp_path):
    argv = train_argv(tiny_corpus, str(tmp_path / "a" / "mtn"),
                      "--num-epochs", "1")
    nan_path = _nan_corpus(tiny_corpus, tmp_path)
    argv = [nan_path if a == tiny_corpus.fea_path else a for a in argv]
    with pytest.raises(FloatingPointError, match="train step 0"):
        train_cli.main(argv + ["--nan-checks", "1"])
    # unchecked, the run goes on with a NaN loss, as JAX's does
    assert train_cli.main(
        [a.replace("/a/", "/b/") for a in argv]) == 0


def test_check_finite_names_the_step_and_the_tensor():
    ok = torch.ones(3)
    profiling.check_finite(4, torch.tensor(1.0), [ok, ok])
    with pytest.raises(FloatingPointError, match="loss at train step 4"):
        profiling.check_finite(4, torch.tensor(float("nan")), [ok])
    with pytest.raises(FloatingPointError, match="gradient at train step 9"):
        profiling.check_finite(9, torch.tensor(1.0),
                               [ok, torch.tensor([0.0, float("inf")])])


def test_profile_dir_writes_a_trace(tiny_corpus, tmp_path):
    prof = tmp_path / "prof"
    assert train_cli.main(train_argv(
        tiny_corpus, str(tmp_path / "mtn"), "--num-epochs", "1",
        "--profile-dir", str(prof))) == 0
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("train_step#") for n in names)
    assert any(n.startswith("eval_step#") for n in names)


def test_profile_dir_writes_a_trace_when_nan_checks_raise(tiny_corpus,
                                                          tmp_path):
    """A run stopped by --nan-checks still leaves its trace."""
    argv = train_argv(tiny_corpus, str(tmp_path / "mtn"), "--num-epochs",
                      "1", "--nan-checks", "1", "--profile-dir",
                      str(tmp_path / "prof"))
    nan_path = _nan_corpus(tiny_corpus, tmp_path)
    argv = [nan_path if a == tiny_corpus.fea_path else a for a in argv]
    with pytest.raises(FloatingPointError, match="train step 0"):
        train_cli.main(argv)
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name", "") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert "train_step#0" in names


def test_trace_records_a_bounded_window(tmp_path):
    """Only the first TRACE_STEPS steps are recorded; the trace is written
    once, at the end of the window."""
    n = profiling.TRACE_STEPS + 5
    with profiling.trace(str(tmp_path)):
        for j in range(n):
            with profiling.step_annotation("train_step", j):
                torch.ones(4).add_(1)
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name", "") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    steps = {n for n in names if n.startswith("train_step#")}
    assert steps == {f"train_step#{j}"
                     for j in range(profiling.TRACE_STEPS)}
    assert profiling._profiler is None


def test_trace_of_none_is_a_no_op(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(""):
        pass
    assert not os.listdir(tmp_path)


def test_checkify_fn_and_timer():
    f = profiling.checkify_fn(lambda x: {"y": (x * 2, [x.log()])})
    out = f(torch.ones(2))
    assert torch.equal(out["y"][0], torch.full((2,), 2.0))
    with pytest.raises(FloatingPointError, match="non-finite"):
        f(torch.tensor([-1.0]))
    t = profiling.Timer()
    assert t.elapsed() >= 0 and t.reset() >= 0


def test_cli_train_batched_ae_writes_the_sidecar(tiny_corpus, tmp_path):
    """``--batched-ae 1`` trains, and its sidecar decodes with the flag,
    through ``cli.generate``."""
    c = tiny_corpus
    prefix = str(tmp_path / "mtn")
    assert train_cli.main(train_argv(c, prefix, "--num-epochs", "1",
                                     "--batched-ae", "1")) == 0
    conf = json.load(open(prefix + ".conf.json"))
    assert conf["model"]["batched_ae"] is True
    result = tmp_path / "result.json"
    assert generate_cli.main([
        "--model", prefix + "_best", "--device", "cpu", "--dtype",
        "float32", "--test-path", c.fea_path, "--test-set", c.test_set,
        "--beam", "2", "--nbest", "2", "--maxlen", "6", "--turn-batch", "4",
        "--undisclosed-only", "1", "--output", str(result)]) == 0


def _args(**kw):
    base = dict(multihost="", mesh_data=-1, mesh_model=1, profile_dir=None,
                nan_checks=0, batched_ae=0, feature_cache="", async_save=0)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw,error", [
    (dict(multihost="h:1,two,0"), ValueError),
    (dict(mesh_data=2), None),
    (dict(mesh_model=4), AssertionError),
    (dict(profile_dir="p", nan_checks=1, batched_ae=1, feature_cache="c",
          async_save=1), None),
])
def test_check_unported_refuses_only_the_parallel_flags(kw, error):
    """Nothing of the parallel flags is refused any more. On a world of
    one the mesh is JAX's: ``--mesh-data 2`` is the single-device case,
    ``--mesh-model 4`` fails JAX's assert, and a bad ``--multihost`` spec
    raises JAX's message; the tool flags leave the mesh alone."""
    import jax
    from mtn_tpu.parallel import make_mesh as jax_make_mesh
    from mtn_tpu.parallel.multihost import initialize_from_flag as jax_flag
    from mtn_tpu_torch.parallel.multihost import initialize_from_flag
    args = _args(**kw)
    if error is None:
        assert make_mesh_from_args(args, 4) == (None, None)
        return
    with pytest.raises(error) as want:
        if error is ValueError:
            jax_flag(args.multihost)
        else:   # JAX's make_mesh over one device
            jax_make_mesh(data=-1, model=4, devices=jax.devices()[:1])
    with pytest.raises(error) as got:
        if error is ValueError:
            initialize_from_flag(args.multihost, device="cpu")
        else:
            make_mesh_from_args(args)
    assert str(got.value) == str(want.value)


def test_mesh_from_args_raises_where_the_batch_does_not_divide(
        monkeypatch):
    """The port's mesh takes every rank, so instead of JAX's fit of the
    data axis to the batch on fewer devices, 3 ranks and a turn batch of
    32 raise, naming both numbers."""
    from mtn_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "world_size", lambda: 3)
    with pytest.raises(ValueError, match=r"batch size 32 .* 3 data"):
        make_mesh_from_args(_args(), 32)


PORTED = [("train", ["--batched-ae", "1"], "batched_ae", 1),
          ("train", ["--feature-cache", "c"], "feature_cache", "c"),
          ("train", ["--async-save", "1"], "async_save", 1),
          ("train", ["--feature-transfer", "int8", "--feature-cache", "c"],
           "feature_transfer", "int8"),
          ("train", ["--profile-dir", "p"], "profile_dir", "p"),
          ("train", ["--nan-checks", "1"], "nan_checks", 1),
          ("generate", ["--profile-dir", "p"], "profile_dir", "p"),
          ("generate", ["--nan-checks", "1"], "nan_checks", 1),
          ("rank", ["--profile-dir", "p"], "profile_dir", "p"),
          ("rank", ["--nan-checks", "1"], "nan_checks", 1)]


@pytest.mark.parametrize("cli,flag,dest,value", PORTED,
                         ids=[f"{c}{' '.join(f)}" for c, f, _, _ in PORTED])
def test_cli_accepts_the_ported_flags(cli, flag, dest, value):
    """Each CLI's parser takes the flags this port runs (or, in the
    decode CLIs, ignores as JAX's do), and the parallel set-up lets them
    through: one device, no mesh."""
    mod = {"train": train_cli, "generate": generate_cli,
           "rank": rank_cli}[cli]
    required = ["--candidates", "c"] if cli == "rank" else []
    args = mod.build_parser().parse_args(["--device", "cpu", *required,
                                          *flag])
    assert getattr(args, dest) == value
    assert make_mesh_from_args(args) == (None, None)

