"""Import a dumped JAX checkpoint into the port's checkpoint format.

    python scripts/dump_flax_params.py exps/x/mtn_best params.npz
    python -m mtn_tpu_torch.utils.import_flax params.npz exps/x/mtn

The ``.npz`` holds the flattened flax params under the port's
``state_dict`` names (``decoder.layer_0.self_attn.w_q.kernel``) and the
checkpoint epoch under ``__epoch__``. Every key and shape is checked
against ``weights.param_shapes`` of the config in ``<prefix>.conf.json``
(the sidecar the JAX training wrote, read as it is); then
``<prefix>_torch/epoch_<e>.pt`` and its meta are written, so
``cli.generate``, ``cli.rank`` and ``serve_http`` take the JAX
checkpoint's prefix unchanged. Uses torch and numpy only.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np

EPOCH_KEY = "__epoch__"


def load_npz(path: str, cfg) -> Tuple[dict, Optional[int]]:
    """The state dict in ``path``, checked key by key and shape by shape
    against ``MTN(cfg)``, and the epoch the dump recorded (or None)."""
    from mtn_tpu_torch.weights import from_flax, param_shapes
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    epoch = arrays.pop(EPOCH_KEY, None)
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(arrays))
    extra = sorted(set(arrays) - set(want))
    wrong = sorted(k for k in set(want) & set(arrays)
                   if tuple(arrays[k].shape) != want[k])
    if missing or extra or wrong:
        raise ValueError(
            f"{path} does not fit the model of the config: missing "
            f"{missing[:5]}, unexpected {extra[:5]}, wrong shape "
            f"{[(k, tuple(arrays[k].shape), want[k]) for k in wrong[:5]]}")
    return from_flax(arrays), None if epoch is None else int(epoch)


def import_flax(npz: str, prefix: str, epoch: Optional[int] = None) -> str:
    """Write ``npz`` as ``<prefix>_torch/epoch_<epoch>.pt`` (default: the
    epoch recorded in the dump) and move the best pointer to it. Returns
    the written path."""
    from mtn_tpu_torch.config import config_from_dict
    from mtn_tpu_torch.weights import load_conf, save_checkpoint
    _, conf = load_conf(prefix)
    state_dict, dumped = load_npz(npz, config_from_dict("model",
                                                        conf["model"]))
    epoch = dumped if epoch is None else epoch
    if epoch is None:
        raise ValueError(f"{npz} records no epoch: pass --epoch")
    return save_checkpoint(prefix, epoch, state_dict)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Import a dumped JAX checkpoint (.npz) as a "
                    "mtn_tpu_torch checkpoint")
    parser.add_argument("npz", help="params dumped by "
                                    "scripts/dump_flax_params.py")
    parser.add_argument("prefix", help="model prefix whose .conf.json and "
                                       ".vocab.json the JAX run wrote")
    parser.add_argument("--epoch", type=int, default=None,
                        help="epoch to write (default: the dumped one)")
    args = parser.parse_args(argv)
    path = import_flax(args.npz, args.prefix, args.epoch)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
