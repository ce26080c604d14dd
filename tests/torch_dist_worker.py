"""One rank of a gloo world on the CPU, for tests/test_torch_distributed.py.

    python tests/torch_dist_worker.py <rank> <world> <port> <DxM> <dir>
        <generate port> <rank port> <train port>

Reads ``<dir>/inputs.pt`` (the test's seeded parameters, batch, configs
and CLI arguments), runs on a (D, M) mesh of ``mtn_tpu_torch.parallel``:
three train steps, a checkpoint save and restore, a step at dropout and
attention dropout 0.1, one update from two 4-row microbatches
(``train_step_accum``), beam, greedy, sample and rank decodes, an int8
beam decode; writes what
it saw to ``<dir>/<DxM>_r<rank>.pt``. Then it runs ``cli.generate``,
``cli.rank`` and ``cli.train`` under ``--multihost`` and the same mesh
flags, on the three other ports, writing ``<dir>/<DxM>_generate.json``,
``<dir>/<DxM>_rank.json`` and ``<dir>/<DxM>_train/mtn*``.
"""

import copy
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def scenarios(rank, world, port, mesh, d):
    from mtn_tpu_torch.config import DecodeConfig, TrainConfig
    from mtn_tpu_torch.data.batching import HostBatch
    from mtn_tpu_torch.decode.beam import BeamDecoder
    from mtn_tpu_torch.parallel import Shardings, make_mesh, multihost
    from mtn_tpu_torch.train.trainer import Trainer
    from mtn_tpu_torch.utils.checkpoint import CheckpointManager
    from mtn_tpu_torch.utils.quantize import quantize_model
    from mtn_tpu_torch.weights import load_model

    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    multihost.initialize_from_flag(f"localhost:{port},{world},{rank}",
                                   device="cpu")
    data, model = (int(v) for v in mesh.split("x"))
    sh = Shardings(make_mesh(data=data, model=model, device_type="cpu"))
    hb = HostBatch(**inp["batch"])
    db = sh.put_host_batch(hb, "cpu")
    out = {"local_rows": int(db.query.shape[0])}

    tr = Trainer(inp["cfg"], TrainConfig(warmup_steps=10), "cpu",
                 shardings=sh)
    state = tr.state_from(inp["params"])
    losses = []
    for _ in range(3):
        state, m = tr.train_step(state, db, 1)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    gather = tr.layout.gather if tr.layout is not None else dict
    out["params"] = gather(state.params)
    ckpt = CheckpointManager(os.path.join(d, f"ckpt_{mesh}", "mtn"),
                             layout=tr.layout)
    ckpt.save(1, state, val_loss=1.0)
    torch.distributed.barrier()
    again, _ = ckpt.restore(tr.state_from(inp["params"]), 1)
    out["restored"] = all(torch.equal(again.params[n], t)
                          for n, t in state.params.items())

    cfg = copy.deepcopy(inp["cfg"])
    cfg.dropout = cfg.attn_dropout = 0.1
    tr = Trainer(cfg, TrainConfig(warmup_steps=10), "cpu", shardings=sh)
    out["dropout_loss"] = float(tr.train_step(tr.state_from(inp["params"]),
                                              db, 1)[1]["loss"])

    tr = Trainer(inp["cfg"], TrainConfig(warmup_steps=10), "cpu",
                 shardings=sh)
    b = inp["batch"]
    micro = [sh.put_host_batch(HostBatch(**{
        k: [a[lo:lo + 4] for a in v] if k in ("fts", "fts_len")
        else v[lo:lo + 4] for k, v in b.items()}), "cpu") for lo in (0, 4)]
    state, m = tr.train_step_accum(tr.state_from(inp["params"]), micro, 1)
    out["accum_loss"] = float(m["loss"])
    gather = tr.layout.gather if tr.layout is not None else dict
    out["accum_params"] = gather(state.params)

    dec_cfg = DecodeConfig(**inp["decode"])
    net = load_model(inp["decode_cfg"], inp["params"], "cpu")
    sh.shard_model(net)
    dec = BeamDecoder(net, dec_cfg, shardings=sh)
    beam = dec.beam_batch(db)
    out["beam"] = [(r.tokens, r.scores) for r in beam]
    out["greedy"] = dec.greedy_batch(db)
    out["sample"] = dec.sample_batch(db, fold=3)
    out["rank"] = dec.rank_batch(db, inp["cands"])
    net = load_model(inp["decode_cfg"], inp["params"], "cpu")
    quantize_model(net, inp["params"])
    sh.shard_model(net)
    out["int8"] = [(r.tokens, r.scores) for r in
                   BeamDecoder(net, dec_cfg, shardings=sh).beam_batch(db)]
    torch.save(out, os.path.join(d, f"{mesh}_r{rank}.pt"))
    multihost.shutdown()
    return inp


def clis(rank, world, ports, mesh, inp, d):
    from mtn_tpu_torch.cli import generate, rank as rank_cli, train
    data, model = mesh.split("x")
    mh = lambda p: ["--multihost", f"localhost:{p},{world},{rank}",
                    "--mesh-data", data, "--mesh-model", model]
    assert generate.main(inp["generate_argv"] + mh(ports[0]) + [
        "--output", os.path.join(d, f"{mesh}_generate.json")]) == 0
    assert rank_cli.main(inp["rank_argv"] + mh(ports[1]) + [
        "--output", os.path.join(d, f"{mesh}_rank.json")]) == 0
    prefix = os.path.join(d, f"{mesh}_train", "mtn")
    assert train.main([prefix if a == "MODEL" else a
                       for a in inp["train_argv"]] + mh(ports[2]) + [
                           "--uniform-shapes", "1", "--accum-steps", "2"]) == 0


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    mesh, d = sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    inp = scenarios(rank, world, port, mesh, d)
    clis(rank, world, [int(p) for p in sys.argv[6:9]], mesh, inp, d)


if __name__ == "__main__":
    main()
