"""The port's training checkpoints against mtn_tpu's rules: the best
pointer, pruning, meta.json, the step slot, early stopping across a resume,
and an exact mid-epoch resume through the train CLI (CPU)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtn_tpu.train.trainer import EarlyStopper as JEarlyStopper
from mtn_tpu.train.trainer import TrainState as JTrainState
from mtn_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager
from mtn_tpu_torch.cli import train as train_cli
from mtn_tpu_torch.config import ModelConfig, TrainConfig
from mtn_tpu_torch.train.trainer import EarlyStopper, Trainer
from mtn_tpu_torch.utils.checkpoint import CheckpointManager
from mtn_tpu_torch.weights import load_checkpoint
from tests.torch_parity import one_thread, train_argv  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# (epoch, validation loss): a tie with the best, a worse epoch, new bests
LOSSES = [(1, 3.0), (2, 2.0), (3, 2.0), (4, 5.0), (5, 1.5), (6, 1.5)]


def _tiny_trainer():
    cfg = ModelConfig(vocab_size=20, nb_blocks=1, d_model=16, d_ff=32,
                      att_h=2, ft_sizes=[6])
    return Trainer(cfg, TrainConfig(warmup_steps=10), "cpu")


@pytest.mark.parametrize("keep", [0, 2])
def test_best_pointer_pruning_and_meta_follow_jax(tmp_path, keep):
    jm = JCheckpointManager(str(tmp_path / "jax" / "m"))
    jstate = JTrainState(params={"w": jnp.zeros(3)}, opt_state={},
                         step=jnp.zeros((), jnp.int32))
    tr = _tiny_trainer()
    state = tr.init_state(0)
    tm = CheckpointManager(str(tmp_path / "port" / "m"))
    for epoch, loss in LOSSES:
        jm.save(epoch, jstate, val_loss=loss, keep=keep)
        state.step = epoch * 10
        tm.save(epoch, state, val_loss=loss, keep=keep)
        assert tm.meta() == jm._meta()
    jm.save_step(jstate, 6, 3)
    tm.save_step(state, 6, 3)
    got, want = tm.meta(), jm._meta()
    assert got.pop("step") == 60 and want.pop("step") == 0
    assert got == want
    assert got["best_epoch"] == 5 and got["best_loss"] == 1.5
    kept = sorted(int(f[6:-3]) for f in os.listdir(tm.dir)
                  if f.startswith("epoch_") and f.endswith(".pt")
                  and not f.endswith(".opt.pt"))
    assert kept == got["epochs"] == ([5, 6] if keep else list(range(1, 7)))
    assert tm.best_epoch() == 5 and tm.latest_epoch() == 6


def test_restore_round_trip(tmp_path):
    tr = _tiny_trainer()
    state = tr.init_state(1)
    for p in state.opt_state.mu:
        p.normal_()
    state.opt_state.count, state.step = 7, 7
    want = {n: t.clone() for n, t in state.params.items()}
    want_mu = [t.clone() for t in state.opt_state.mu]
    cm = CheckpointManager(str(tmp_path / "m"))
    cm.save(1, state, val_loss=2.0)
    cm.save_step(state, 1, 4)
    fresh = tr.init_state(2)
    for restore in (lambda s: cm.restore(s, "best"),
                    lambda s: cm.restore(s, 1),
                    lambda s: cm.restore_step(s)[:2]):
        s, ep = restore(tr.init_state(2))
        assert int(ep) == 1 and s.step == 7 and s.opt_state.count == 7
        for n, t in s.params.items():
            assert torch.equal(t, want[n]), n
        for a, b in zip(s.opt_state.mu, want_mu):
            assert torch.equal(a, b)
    assert cm.restore_step(fresh)[1:] == (1, 4)
    # the f32 params file is the weights format that generate reads
    sd, epoch = load_checkpoint(cm.prefix, "best")
    assert epoch == 1 and all(torch.equal(sd[n], want[n]) for n in want)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "none")).restore(fresh, "latest")


def test_early_stopper_follows_jax():
    meta = {"epochs": [1, 2, 3, 4], "best_epoch": 2, "best_loss": 1.0}
    for patience in (0, 1, 2):
        j, t = JEarlyStopper(patience), EarlyStopper(patience)
        j.seed_from_meta(meta, 4)
        t.seed_from_meta(meta, 4)
        for loss in (2.0, 1.0, 0.5, 0.5, 0.7, 0.4, 0.9):
            assert t.update(loss) == j.update(loss)
            assert (t.best, t.bad_epochs) == (j.best, j.bad_epochs)


class _Interrupt(Exception):
    pass


def test_resume_step_is_bitwise_exact(tiny_corpus, tmp_path, monkeypatch):
    """A run stopped after the step checkpoint at batch 3 of epoch 1 and
    resumed with --resume step ends with the same bits as an uninterrupted
    run (dropout, cut_a and the shuffle all on)."""
    extra = ["--num-epochs", "2", "--dropout", "0.1", "--cut-a", "1",
             "--checkpoint-every-steps", "3", "--report-interval", "2"]
    whole = str(tmp_path / "whole" / "mtn")
    assert train_cli.main(train_argv(tiny_corpus, whole, *extra)) == 0

    cut = str(tmp_path / "cut" / "mtn")
    save_step = CheckpointManager.save_step

    def save_then_stop(self, state, epoch, batch_idx=0):
        save_step(self, state, epoch, batch_idx)
        raise _Interrupt

    monkeypatch.setattr(CheckpointManager, "save_step", save_then_stop)
    with pytest.raises(_Interrupt):
        train_cli.main(train_argv(tiny_corpus, cut, *extra))
    monkeypatch.undo()
    meta = json.load(open(cut + "_torch/meta.json"))
    assert (meta["step"], meta["step_epoch"], meta["step_batch"]) == (3, 0, 3)
    assert train_cli.main(train_argv(tiny_corpus, cut, *extra,
                                     "--resume", "step")) == 0
    for epoch in (1, 2):
        a = torch.load(f"{whole}_torch/epoch_{epoch}.pt")
        b = torch.load(f"{cut}_torch/epoch_{epoch}.pt")
        assert a.keys() == b.keys()
        for n in a:
            assert torch.equal(a[n], b[n]), (epoch, n)
        oa = torch.load(f"{whole}_torch/epoch_{epoch}.opt.pt")
        ob = torch.load(f"{cut}_torch/epoch_{epoch}.opt.pt")
        assert oa["step"] == ob["step"] and oa["count"] == ob["count"]
        for n in oa["nu"]:
            assert torch.equal(oa["nu"][n], ob["nu"][n]), (epoch, n)
    assert np.isfinite(json.load(open(cut + "_torch/meta.json"))[
        "best_loss"])
