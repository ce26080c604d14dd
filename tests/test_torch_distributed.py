"""The port's parallel layer (``mtn_tpu_torch/parallel``) on gloo worlds on
the CPU, held against the port's single process and ``mtn_tpu``.

The worker processes (``tests/torch_dist_worker.py``) start once for the
module: 2 ranks as a 2x1 (data) and a 1x2 (model) mesh, 4 ranks as 2x2,
with the tiny config of ``tests/test_parallel.py`` (dropout 0, attention
dropout 0). Each runs three train steps, a checkpoint save and restore,
a step at dropout and attention dropout 0.1, an update from two
microbatches, beam, greedy, sample, rank and int8 beam decodes, then
``cli.generate``, ``cli.rank`` and ``cli.train`` (``--accum-steps 2``)
under ``--multihost`` with the same mesh flags.
The tolerances are the repo's: rtol 1e-5 between a multi-process and a
single-process run (``tests/test_multihost.py:81``), JAX's single-device
loss at rel 2e-4 under data and 2e-3 under model parallelism
(``tests/test_parallel.py:46,55``), parameters within 5e-5 (the
whole-model tolerance), beams margin-aware where the sums over ranks
change the order of f32 additions.
"""

import copy
import json
import os
import runpy
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mtn_tpu.config import TrainConfig as JTrainConfig
from mtn_tpu.train.trainer import Trainer as JTrainer
from mtn_tpu.train.trainer import TrainState as JTrainState
from mtn_tpu_torch.config import DataConfig, DecodeConfig, TrainConfig
from mtn_tpu_torch.data.batching import HostBatch
from mtn_tpu_torch.data.vocab import get_vocabulary
from mtn_tpu_torch.decode.beam import BeamDecoder
from mtn_tpu_torch.train.batch import device_batch
from mtn_tpu_torch.train.trainer import Trainer
from mtn_tpu_torch.utils.quantize import quantize_model
from mtn_tpu_torch.weights import (from_flax, load_checkpoint, load_model,
                                   save_checkpoint, save_conf)
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import (both_batches, host_fields, port_cfg,
                                seeded_params, train_argv)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
MESHES = {"2x1": 2, "1x2": 2, "2x2": 4}
PARAM_TOL = 5e-5
EPS = 1e-4        # near-tie margin of a beam's 1-best
DECODE = dict(maxlen=5, beam=2, nbest=2)


def _ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _single(cfg, dcfg, params, hb, cands):
    """The port's single-process run of every scenario."""
    db = device_batch(hb, "cpu")
    tr = Trainer(cfg, TrainConfig(warmup_steps=10), "cpu")
    state = tr.state_from(params)
    losses, one_step = [], None
    for _ in range(3):
        state, m = tr.train_step(state, db, 1)
        losses.append(float(m["loss"]))
        one_step = one_step or {n: t.clone() for n, t in
                                state.params.items()}
    drop = copy.deepcopy(cfg)
    drop.dropout = drop.attn_dropout = 0.1
    tr = Trainer(drop, TrainConfig(warmup_steps=10), "cpu")
    dropout_loss = float(tr.train_step(tr.state_from(params), db, 1)[1][
        "loss"])
    dec = BeamDecoder(load_model(dcfg, params, "cpu"),
                      DecodeConfig(**DECODE))
    net = load_model(dcfg, params, "cpu")
    quantize_model(net, params)
    return dict(
        losses=losses, params=dict(state.params), one_step=one_step,
        dropout_loss=dropout_loss,
        beam=[(r.tokens, r.scores) for r in dec.beam_batch(db)],
        greedy=dec.greedy_batch(db), sample=dec.sample_batch(db, fold=3),
        rank=dec.rank_batch(db, cands),
        int8=[(r.tokens, r.scores) for r in BeamDecoder(
            net, DecodeConfig(**DECODE)).beam_batch(db)])


def _jax_losses(jcfg, tree, fields):
    jdb, _ = both_batches(fields)
    jt = JTrainer(jcfg, JTrainConfig(warmup_steps=10))
    st = JTrainState(params=tree, opt_state=jt.optimizer.init(tree),
                     step=jax.numpy.zeros((), jax.numpy.int32))
    losses = []
    for _ in range(3):
        st, m = jt.train_step(st, jdb, jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    return losses


def _cli_inputs(c, d):
    """A seeded port-format checkpoint on the tiny corpus, a candidates
    file, and the flags of the three CLIs."""
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    jcfg = tiny_model_cfg(len(vocab), c.ft_dims, dropout=0.0)
    prefix = str(d / "seeded" / "mtn")
    os.makedirs(os.path.dirname(prefix))
    save_conf(prefix, vocab, model=port_cfg(jcfg), data=DataConfig(
        fea_type=list(c.fea_types), include_caption="caption,summary",
        separate_caption=True, length_bucket=8, feature_bucket=4))
    save_checkpoint(prefix, 1, from_flax(seeded_params(jcfg, seed=3,
                                                       gen_scale=3.0)))
    build = runpy.run_path(os.path.join(
        REPO, "scripts", "make_rank_candidates.py"))["build_candidates"]
    with open(c.lbl_test_set) as f:
        cands = build(json.load(f), num_options=5, seed=1, last_only=True)
    (d / "cands.json").write_text(json.dumps(cands))
    common = ["--model", prefix + "_best", "--device", "cpu", "--dtype",
              "float32", "--test-path", c.fea_path, "--test-set",
              c.test_set, "--undisclosed-only", "1", "--turn-batch", "4"]
    return dict(
        generate_argv=common + ["--decode-style", "beam_search", "--beam",
                                "2", "--nbest", "2", "--maxlen", "5"],
        rank_argv=common + ["--candidates", str(d / "cands.json")],
        train_argv=train_argv(c, "MODEL", "--num-epochs", "1",
                              "--prefetch", "0"))


@pytest.fixture(scope="module")
def runs(tiny_corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    torch.set_num_threads(1)
    jcfg = tiny_model_cfg(32, (16, 8), dropout=0.0, attn_dropout=0.0,
                          d_model=8, d_ff=16)
    tree = seeded_params(jcfg, seed=0, gen_scale=4.0)
    params = from_flax(tree)
    fields = host_fields(np.random.default_rng(0), B=8, ft_dims=(16, 8),
                         vocab=32, lengths=[[5, 3, 4, 5, 2, 5, 1, 4],
                                            [4, 4, 2, 3, 4, 1, 4, 3]])
    fields["valid"][6] = False
    rng = np.random.default_rng(1)
    cands = [[rng.integers(4, 32, rng.integers(1, 4)).tolist()
              for _ in range(rng.integers(1, 4))] for _ in range(8)]
    cfg = port_cfg(jcfg)
    dcfg = port_cfg(jcfg)
    dcfg.use_pallas_attention = dcfg.use_pallas_ffn = True
    inputs = dict(cfg=cfg, decode_cfg=dcfg, params=params, batch=fields,
                  cands=cands, decode=DECODE, **_cli_inputs(tiny_corpus, d))
    torch.save(inputs, d / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = []
    ports = iter(_ports(4 * len(MESHES)))
    for mesh, world in MESHES.items():
        mine = [str(next(ports)) for _ in range(4)]
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(r), str(world), mine[0], mesh,
                 str(d)] + mine[1:], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    try:
        single = _single(cfg, dcfg, params, HostBatch(**fields), cands)
        single["jax_losses"] = _jax_losses(jcfg, tree, fields)
        from mtn_tpu_torch.cli import generate, rank as rank_cli
        assert generate.main(inputs["generate_argv"] + [
            "--output", str(d / "single_generate.json")]) == 0
        assert rank_cli.main(inputs["rank_argv"] + [
            "--output", str(d / "single_rank.json")]) == 0
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:   # no rank outlives the fixture (a hung collective)
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = {mesh: [torch.load(d / f"{mesh}_r{r}.pt", weights_only=False)
                    for r in range(world)]
             for mesh, world in MESHES.items()}
    logs = iter(logs)
    logs = {mesh: [next(logs) for _ in range(world)]
            for mesh, world in MESHES.items()}
    return dict(dir=d, single=single, ranks=ranks, logs=logs)


def _same_beams(got, want, exact):
    """Every row token for token where ``exact`` or the row's margin is
    robust (scores within 1e-5); a near-tied row decodes a hypothesis
    scored within EPS of the 1-best."""
    assert len(got) == len(want)
    for (gt, gs), (wt, ws) in zip(got, want):
        margin = ws[0] - ws[1] if len(ws) > 1 else float("inf")
        if exact or margin > EPS:
            assert gt == wt
            np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
        else:
            assert gt[0] in [t for t, s in zip(wt, ws) if ws[0] - s <= EPS]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_losses_equal_across_ranks_and_match_single(runs, mesh):
    single = runs["single"]
    losses = [r["losses"] for r in runs["ranks"][mesh]]
    assert all(l == losses[0] for l in losses)
    np.testing.assert_allclose(losses[0], single["losses"], rtol=1e-5)
    rel = 2e-4 if mesh == "2x1" else 2e-3
    np.testing.assert_allclose(losses[0], single["jax_losses"], rtol=rel)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gathered_params_match_single(runs, mesh):
    """The K projections' biases (true gradient 0, noise-driven Adam
    steps) are left out, as in the other parameter comparisons."""
    want = runs["single"]["params"]
    for r in runs["ranks"][mesh]:
        assert r["params"].keys() == want.keys()
        for n, t in r["params"].items():
            if not n.endswith(".w_k.bias"):
                torch.testing.assert_close(t, want[n], rtol=0,
                                           atol=PARAM_TOL, msg=n)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_beam_decode_matches_single(runs, mesh):
    """Data parallelism runs each row as the single process does: token
    for token. Under model parallelism the ranks hold the same gathered
    log-probs bit for bit, so their n-bests are equal, and they match the
    single process margin-aware."""
    ranks = runs["ranks"][mesh]
    assert all(r["beam"] == ranks[0]["beam"] for r in ranks)
    _same_beams(ranks[0]["beam"], runs["single"]["beam"],
                exact=mesh == "2x1")
    assert len(ranks[0]["beam"]) == 7      # one result per valid row
    assert [r["local_rows"] for r in ranks] == \
        [8 // int(mesh[0])] * len(ranks)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_greedy_sample_and_rank_match_single(runs, mesh):
    """Sampling draws the whole batch's noise on every rank, so a sample
    does not depend on the mesh."""
    single = runs["single"]
    for r in runs["ranks"][mesh]:
        assert r["greedy"] == single["greedy"]
        assert r["sample"] == single["sample"]
        for got, want in zip(r["rank"], single["rank"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert len(r["rank"]) == len(single["rank"]) == 7


@pytest.mark.parametrize("mesh", list(MESHES))
def test_checkpoint_loads_on_one_process(runs, mesh):
    """Rank 0 writes full tensors: one process loads what the mesh
    trained, and the mesh restores it slab for slab."""
    sd, epoch = load_checkpoint(str(runs["dir"] / f"ckpt_{mesh}" / "mtn"),
                                1)
    assert epoch == 1
    gathered = runs["ranks"][mesh][0]["params"]
    assert sd.keys() == gathered.keys()
    for n, t in sd.items():
        assert torch.equal(t, gathered[n]), n
    assert all(r["restored"] for r in runs["ranks"][mesh])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_int8_decode_under_mesh(runs, mesh):
    ranks = runs["ranks"][mesh]
    assert all(r["int8"] == ranks[0]["int8"] for r in ranks)
    _same_beams(ranks[0]["int8"], runs["single"]["int8"],
                exact=mesh == "2x1")


def test_dropout_draws_depend_on_the_mesh(runs):
    """As JAX's one key for the whole batch: every rank is seeded alike
    and each data rank keeps its rows of the whole batch's masks, so at
    dropout and attention dropout 0.1 the 2x1 step's loss is the single
    process's to the parity tolerance (the masks do not depend on the
    mesh; the sum over ranks takes its own order), and the ranks agree
    on the reduced loss."""
    got = [r["dropout_loss"] for r in runs["ranks"]["2x1"]]
    want = runs["single"]["dropout_loss"]
    assert got[0] == got[1] and np.isfinite(got[0])
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
    # the loss moves with the masks: dropout changes it well beyond rtol
    assert abs(want - runs["single"]["losses"][0]) > 1e-3 * abs(want)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_accumulated_step_matches_one_big_batch(runs, mesh):
    """One update from two 4-row microbatches under the mesh (each cut
    over ``data``): the loss and parameters of the single process's one
    step on the 8-row batch."""
    single = runs["single"]
    for r in runs["ranks"][mesh]:
        np.testing.assert_allclose(r["accum_loss"], single["losses"][0],
                                   rtol=1e-5)
        for n, t in r["accum_params"].items():
            if not n.endswith(".w_k.bias"):
                torch.testing.assert_close(t, single["one_step"][n], rtol=0,
                                           atol=PARAM_TOL, msg=n)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_dropout_masks_follow_the_data_ranks_only(runs, mesh):
    """The model ranks of a data rank keep their slices of one mask over
    each sharded activation (the FFN's hidden units, the probabilities of
    all heads): at dropout and attention dropout 0.1 a 1x2 step draws one
    process's masks and a 2x2 step the 2x1 step's, so the losses agree to
    the parity tolerance. Ranks that each dropped their slice with one
    repeated mask would not."""
    want = (runs["single"] if mesh == "1x2" else
            runs["ranks"]["2x1"][0])["dropout_loss"]
    got = [r["dropout_loss"] for r in runs["ranks"][mesh]]
    assert all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], want, rtol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cli_generate_two_processes(runs, mesh):
    """Turn batches cut over the data ranks, the model over the model
    ranks, n-bests gathered, rank 0 writes: the JSON is byte-identical to
    the single process's."""
    d = runs["dir"]
    assert (d / f"{mesh}_generate.json").read_bytes() == \
        (d / "single_generate.json").read_bytes()
    data, model = mesh.split("x")
    line = f"running under mesh {{'data': {data}, 'model': {model}}}"
    for log in runs["logs"][mesh]:   # generate, rank and train
        assert log.count(line) == 3, log[-4000:]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cli_rank_two_processes(runs, mesh):
    d = runs["dir"]
    single, multi = (json.loads((d / f).read_text())
                     for f in ("single_rank.json", f"{mesh}_rank.json"))
    assert single["metrics"] == multi["metrics"]
    for da, db in zip(single["dialogs"], multi["dialogs"]):
        for ta, tb in zip(da["dialog"], db["dialog"]):
            assert ta["gt_rank"] == tb["gt_rank"]
            np.testing.assert_allclose(ta["scores"], tb["scores"], atol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cli_train_two_processes(runs, mesh):
    """Every rank reports the same (reduced) epoch loss; only rank 0
    writes the logs, sidecars and checkpoint, which one process loads."""
    def epoch_loss(log):
        lines = [l for l in log.splitlines() if "train loss:" in l]
        assert lines, log[-4000:]
        return lines[-1].rsplit(":", 1)[1].strip()
    losses = [epoch_loss(log) for log in runs["logs"][mesh]]
    assert all(l == losses[0] for l in losses)
    prefix = str(runs["dir"] / f"{mesh}_train" / "mtn")
    assert os.path.exists(prefix + ".conf.json")
    meta = json.load(open(prefix + "_torch/meta.json"))
    assert meta["epochs"] == [1]
    assert len(open(prefix + "_train.csv").read().splitlines()) > 1
    sd, _ = load_checkpoint(prefix, 1)
    assert all(torch.isfinite(t).all() for t in sd.values())
