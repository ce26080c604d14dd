"""Checkpoint averaging: several epoch checkpoints into one
(``mtn_tpu/utils/average.py``, the port's files).

Averages the parameters of the chosen epochs (in float32, on the card
unless given ``--device cpu``, cast back to the stored dtypes) and
writes them as a servable checkpoint family:
``<out>.conf.json`` / ``<out>.vocab.json`` sidecars and
``<out>_torch/epoch_1.pt`` with the best pointer on it, so every
downstream entry point takes it unchanged::

    python -m mtn_tpu_torch.utils.average --model exps/x/mtn \\
        --epochs last3 --out exps/x/mtn-avg
    python -m mtn_tpu_torch.cli.generate --model exps/x/mtn-avg_best ...

The written checkpoint carries a fresh optimizer state and step 0: it is
an artifact for evaluation and serving. Training resumed from it starts
the Noam schedule again from step 0.
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Iterable, List, Sequence

import torch

log = logging.getLogger(__name__)


def _resolve_epochs(spec: Sequence[str], available: List[int]) -> List[int]:
    """['2','3'] -> [2, 3]; ['last3'] -> newest 3; ['all'] -> all."""
    if not available:
        raise FileNotFoundError("no epoch checkpoints to average")
    if len(spec) == 1 and spec[0] == "all":
        return list(available)
    if len(spec) == 1 and spec[0].startswith("last"):
        k = int(spec[0][4:] or 1)
        if k <= 0:
            raise ValueError(f"bad epoch spec {spec[0]!r}")
        return list(available[-k:])
    epochs = [int(s) for s in spec]
    missing = [e for e in epochs if e not in available]
    if missing:
        raise FileNotFoundError(
            f"epochs {missing} not found (available: {available})")
    return epochs


def mean_state_dict(state_dicts: Iterable[Dict[str, torch.Tensor]],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The f32 mean of ``state_dicts`` (summed on ``device`` in the given
    order), cast back to each parameter's stored dtype, on the host."""
    acc, dtypes, n = None, None, 0
    for sd in state_dicts:
        if acc is None:
            dtypes = {k: v.dtype for k, v in sd.items()}
            acc = {k: v.to(device, torch.float32, copy=True)
                   for k, v in sd.items()}
        elif sd.keys() != acc.keys():
            raise KeyError("the checkpoints hold different parameters")
        else:
            for k, v in sd.items():
                acc[k] += v.to(device, torch.float32)
        n += 1
    return {k: (v / n).to(dtypes[k]).cpu() for k, v in acc.items()}


def average_checkpoints(model_prefix: str, epochs_spec: Sequence[str],
                        out_prefix: str, device: str = "cuda") -> List[int]:
    """Average ``epochs_spec`` of ``model_prefix`` into ``out_prefix`` on
    ``device``; returns the epochs averaged."""
    from mtn_tpu_torch.cli.common import resolve_device
    from mtn_tpu_torch.train.schedule import NoamAdam
    from mtn_tpu_torch.train.trainer import TrainState
    from mtn_tpu_torch.utils.checkpoint import CheckpointManager
    from mtn_tpu_torch.weights import load_checkpoint, load_conf

    dev = resolve_device(device)
    vocab, conf = load_conf(model_prefix)
    available = CheckpointManager(model_prefix).meta().get("epochs", [])
    epochs = sorted(_resolve_epochs(epochs_spec, available))
    mean = mean_state_dict((load_checkpoint(model_prefix, e)[0]
                            for e in epochs), dev)
    state = TrainState(params=mean, step=0,
                       opt_state=NoamAdam.init(list(mean.values())))
    out = CheckpointManager(out_prefix)
    out.save_conf(vocab, **conf)
    # one epoch; val_loss 0.0 puts the best pointer on it, so
    # `<out>_best` resolves
    out.save(1, state, val_loss=0.0)
    log.info("averaged epochs %s of %s on %s -> %s (epoch_1, best)",
             epochs, model_prefix, dev, out_prefix)
    return epochs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Average epoch checkpoints into one servable "
                    "checkpoint family")
    parser.add_argument("--model", required=True,
                        help="source checkpoint prefix (e.g. exps/x/mtn)")
    parser.add_argument("--epochs", nargs="+", default=["all"],
                        help="epoch numbers, or 'lastK', or 'all'")
    parser.add_argument("--out", required=True,
                        help="output prefix (e.g. exps/x/mtn-avg)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the mean; 'cpu' runs it on "
                             "the CPU")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    average_checkpoints(args.model, args.epochs, args.out, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
