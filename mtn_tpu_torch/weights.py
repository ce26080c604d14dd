"""Weights: the flax-tree bridge, initialisation, and the port's checkpoints.

The port's modules carry the flax parameter names and layouts, so the
bridge is a flatten/unflatten with no transposes: the flax path
``decoder/layer_0/sl_self/norm/scale`` is the ``state_dict`` key
``decoder.layer_0.sl_self.norm.scale``.

Checkpoint format (written by :func:`save_checkpoint`, read by
:func:`load_checkpoint` and ``python -m mtn_tpu_torch.cli.generate``):

- ``<prefix>.conf.json`` and ``<prefix>.vocab.json``: the same sidecars
  as the JAX package's ``CheckpointManager.save_conf``;
- ``<prefix>_torch/epoch_<e>.pt``: the f32 ``state_dict``;
- ``<prefix>_torch/meta.json``: ``{"epochs": [...], "best_epoch": e}``.

A JAX checkpoint reaches the port by dumping its params to a ``.npz``
(``scripts/dump_flax_params.py``, the JAX side) and ``python -m
mtn_tpu_torch.utils.import_flax``, which checks every key and shape and
writes ``<prefix>_torch/`` beside the JAX checkpoint's sidecars; its optax
Adam state, dumped the same way, by :func:`opt_state_from_optax`. The
training checkpoints (optimiser state, the mid-epoch slot) are
``mtn_tpu_torch.utils.checkpoint``'s, beside the same params files.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from mtn_tpu_torch.config import ModelConfig, dump_config, load_config

StateDict = Dict[str, torch.Tensor]


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only a bf16 flax tree needs it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def from_flax(tree: Mapping[str, Any], prefix: str = "") -> StateDict:
    """Nested ``{name: subtree | array}`` -> ``{"a.b.c": tensor}``."""
    out: StateDict = {}
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if isinstance(sub, Mapping):
            out.update(from_flax(sub, key + "."))
        else:
            out[key] = _to_tensor(sub)
    return out


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``{"a.b.c": tensor}`` -> nested ``{name: subtree | np.ndarray}``."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _to_numpy(t)
    return tree


def optax_adam_fields(opt_state) -> Tuple[Any, Any, Any]:
    """``(mu, nu, count)`` of the Adam state inside an optax state given
    as numpy trees: ``optax.adam``'s ``(ScaleByAdamState,
    ScaleByScheduleState)``, or under ``--grad-clip`` the chain
    ``(EmptyState, (ScaleByAdamState, ScaleByScheduleState))``. Found by
    its fields, so nothing of optax is imported."""
    if all(hasattr(opt_state, f) for f in ("mu", "nu", "count")):
        return opt_state.mu, opt_state.nu, opt_state.count
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            try:
                return optax_adam_fields(sub)
            except ValueError:
                pass
    raise ValueError("no Adam state (mu, nu, count) in the optax state")


def opt_state_from_optax(mu: Mapping[str, Any], nu: Mapping[str, Any],
                         count) -> Dict[str, Any]:
    """optax's Adam moments (flax-shaped numpy trees) and update count ->
    the port's optimiser state by parameter name (``{"count": int, "mu":
    {name: f32 tensor}, "nu": {...}}``), which ``Trainer.state_from``
    takes. With :func:`from_flax` on the params, a JAX ``TrainState``
    resumes in the port."""
    f32 = lambda sd: {k: v.float() for k, v in sd.items()}
    return {"count": int(np.asarray(count)), "mu": f32(from_flax(mu)),
            "nu": f32(from_flax(nu))}


def opt_state_to_optax(opt_state: Mapping[str, Any]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any], np.ndarray]:
    """The inverse of :func:`opt_state_from_optax`: (mu, nu, count) as
    flax-shaped numpy trees and an int32 count."""
    return (to_flax(opt_state["mu"]), to_flax(opt_state["nu"]),
            np.asarray(opt_state["count"], np.int32))


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of ``MTN(cfg)`` and its shape (no allocation)."""
    from mtn_tpu_torch.models.mtn import MTN
    with torch.device("meta"):
        model = MTN(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def init_params(cfg: ModelConfig,
                generator: Optional[torch.Generator] = None) -> StateDict:
    """Fresh f32 parameters by flax's laws (not its draws): xavier-uniform
    kernels and embeddings, zero biases, unit norm scales."""
    sd: StateDict = {}
    for key, shape in param_shapes(cfg).items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("kernel", "embedding"):
            fan_in, fan_out = shape[-2], shape[-1]
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            t = torch.rand(shape, generator=generator) * (2 * limit) - limit
        elif leaf == "scale":
            t = torch.ones(shape)
        elif leaf == "bias":
            t = torch.zeros(shape)
        else:
            raise KeyError(f"no init law for parameter {key}")
        sd[key] = t
    return sd


def load_model(cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor],
               device: Union[str, torch.device]):
    """``MTN(cfg)`` on ``device`` with ``state_dict`` loaded (linear and
    embedding weights cast to the compute dtype once), in eval mode."""
    from mtn_tpu_torch.models.mtn import MTN
    model = MTN(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


# -- checkpoints ------------------------------------------------------------
def _ckpt_dir(prefix: str) -> str:
    return prefix + "_torch"


def save_conf(prefix: str, vocab: dict, **config_sections) -> None:
    dump_config(prefix + ".conf.json", **config_sections)
    with open(prefix + ".vocab.json", "w") as f:
        json.dump(vocab, f)


def load_conf(prefix: str) -> Tuple[dict, dict]:
    """Returns (vocab, config sections) from the sidecars."""
    with open(prefix + ".vocab.json") as f:
        vocab = json.load(f)
    return vocab, load_config(prefix + ".conf.json")


def _meta_path(prefix: str) -> str:
    return os.path.join(_ckpt_dir(prefix), "meta.json")


def _meta(prefix: str) -> dict:
    path = _meta_path(prefix)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def save_checkpoint(prefix: str, epoch: int,
                    state_dict: Mapping[str, torch.Tensor],
                    best: bool = True) -> str:
    """Write ``<prefix>_torch/epoch_<epoch>.pt`` (f32, CPU) and update
    ``meta.json``; ``best`` moves the best pointer to this epoch."""
    os.makedirs(_ckpt_dir(prefix), exist_ok=True)
    path = os.path.join(_ckpt_dir(prefix), f"epoch_{epoch}.pt")
    torch.save({k: v.detach().to("cpu", torch.float32)
                for k, v in state_dict.items()}, path)
    meta = _meta(prefix)
    meta["epochs"] = sorted(set(meta.get("epochs", []) + [epoch]))
    if best:
        meta["best_epoch"] = epoch
    with open(_meta_path(prefix), "w") as f:
        json.dump(meta, f)
    return path


def resolve_epoch(prefix: str, epoch: Union[int, str]) -> Optional[int]:
    """The epoch number "best" or "latest" names under ``prefix`` (None
    when there is none); a number is returned as it is."""
    meta = _meta(prefix)
    if epoch == "best":
        return meta.get("best_epoch")
    if epoch == "latest":
        epochs = meta.get("epochs", [])
        return epochs[-1] if epochs else None
    return epoch


def load_checkpoint(prefix: str, epoch: Union[int, str] = "best"
                    ) -> Tuple[StateDict, int]:
    """Returns (state_dict, epoch); ``epoch`` is a number, "best" or
    "latest"."""
    epoch = resolve_epoch(prefix, epoch)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint under {_ckpt_dir(prefix)}")
    path = os.path.join(_ckpt_dir(prefix), f"epoch_{epoch}.pt")
    return torch.load(path, map_location="cpu", weights_only=True), epoch
