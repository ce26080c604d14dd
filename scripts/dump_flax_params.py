#!/usr/bin/env python3
"""Dump the params of a JAX checkpoint to a ``.npz`` for mtn_tpu_torch.

    python scripts/dump_flax_params.py exps/x/mtn_best params.npz
    python -m mtn_tpu_torch.utils.import_flax params.npz exps/x/mtn

The model argument is a checkpoint prefix with its ``_best``, ``_latest``
or ``_<epoch>`` suffix, as ``generate.py --model`` takes it. The params are
restored as the serving session restores them
(``CheckpointManager.restore_params`` into an abstract state built from
the sidecar config) and written flat, with ``a.b.c`` keys (the port's
``state_dict`` names), in their stored dtype; the restored epoch goes under
``__epoch__``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

EPOCH_KEY = "__epoch__"


def flatten(tree, prefix: str = ""):
    """Nested ``{name: subtree | array}`` -> ``{"a.b.c": np.ndarray}``."""
    out = {}
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if hasattr(sub, "items"):
            out.update(flatten(sub, key + "."))
        else:
            out[key] = np.asarray(sub)
    return out


def dump(model_arg: str, out: str) -> int:
    """Write the params of ``model_arg`` to ``out``; returns the epoch."""
    from mtn_tpu.cli.generate import _split_model_arg
    from mtn_tpu.config import config_from_dict
    from mtn_tpu.serve import _restore_params
    from mtn_tpu.utils.checkpoint import CheckpointManager

    prefix, epoch = _split_model_arg(model_arg)
    ckpt = CheckpointManager(prefix)
    vocab, conf = ckpt.load_conf()
    params, used_epoch = _restore_params(
        ckpt, epoch, config_from_dict("model", conf["model"]),
        config_from_dict("data", conf["data"]), vocab)
    arrays = flatten(params)
    arrays[EPOCH_KEY] = np.asarray(int(used_epoch), np.int64)
    np.savez(out, **arrays)
    return int(used_epoch)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model", help="checkpoint prefix with _best, "
                                      "_latest or _<epoch>")
    parser.add_argument("out", help="the .npz to write")
    args = parser.parse_args(argv)
    epoch = dump(args.model, args.out)
    print(f"wrote {args.out} (epoch {epoch})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
