"""Weight-only int8 quantization of the decode and serving path
(``mtn_tpu/utils/quantize.py``).

Every linear kernel the decode step reads is stored as int8 with a
per-output-channel float32 scale. For a kernel ``K`` of shape
``(d_in, d_out)``, symmetric per output channel::

    scale_j = max_i |K_ij| / 127        (shape (d_out,), float32)
    q_ij    = clip(round(K_ij / scale_j), -127, 127)  (int8)

so ``|K_ij - q_ij·scale_j| <= scale_j / 2`` elementwise. The quantizer is
the JAX package's numpy code, so both packages hold the same bits.

The flax ``QuantizedParams`` bundle (int8 ``kernel`` leaves plus a
``qscales`` collection) becomes, on each quantized
:class:`~mtn_tpu_torch.models.layers.ParamLinear`, an int8 ``kernel``
buffer beside a float32 ``kernel_scale`` buffer. Buffers, because an int8
tensor cannot be a parameter that requires grad; both are in the
module's ``state_dict()``. ``ParamLinear`` then computes ``(x @ q) * scale
+ b`` in the compute dtype, in JAX's order.

Opt-in and decode-only, as in JAX: training never quantizes.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# Modules whose ``kernel`` is read by ParamLinear. "proj" is both the
# generator head(s) and the video feature projections (vid_encoder_*),
# which are left out unless asked for: they run once per turn, not per
# decode step, and take the raw float features.
_QUANT_MODULES = ("w_q", "w_k", "w_v", "w_o", "w_1", "w_2", "proj")


def quantize_kernel(kernel: np.ndarray,
                    bits: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel quantization of one (d_in, d_out)
    kernel. Returns ``(q int8, scale float32 (d_out,))``."""
    k = np.asarray(kernel, np.float32)
    qmax = float(2 ** (bits - 1) - 1)
    scale = np.max(np.abs(k), axis=0) / qmax
    scale = np.maximum(scale, np.float32(1e-12))
    q = np.clip(np.rint(k / scale), -qmax, qmax).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_kernel(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale[None, :]


def quantized_modules(keys, include_vid_encoder: bool = False,
                      skip_generator: bool = False) -> List[str]:
    """The dotted module paths, among the ``state_dict`` keys ``keys``,
    whose ``kernel`` quantizes: the JAX package's module and path rules
    applied to ``a.b.kernel`` keys."""
    out = []
    for key in keys:
        *path, leaf = key.split(".")
        if leaf != "kernel" or not path or path[-1] not in _QUANT_MODULES:
            continue
        in_vid = any(p.startswith("vid_encoder") for p in path)
        in_gen = any(p == "generator" or p.startswith("ae_generator")
                     for p in path)
        if (include_vid_encoder or not in_vid) and \
                not (skip_generator and in_gen):
            out.append(".".join(path))
    return out


def _numpy_f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def quantize_params(state_dict: Mapping[str, torch.Tensor],
                    include_vid_encoder: bool = False, bits: int = 8,
                    skip_generator: bool = False) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` with every decode-path linear kernel
    quantized: int8 ``<module>.kernel`` and a float32
    ``<module>.kernel_scale`` for the attention projections
    (w_q/w_k/w_v/w_o), the FFN layers (w_1/w_2) and the generator head(s)
    (proj). Embeddings, norms, biases and the positional tables stay as
    they are. ``include_vid_encoder`` also quantizes the video feature
    projections; ``skip_generator`` keeps the vocabulary head(s) in full
    precision (the ``int8-fp-head`` mode)."""
    out = dict(state_dict)
    mods = quantized_modules(state_dict, include_vid_encoder, skip_generator)
    if not mods:
        raise ValueError("quantize_params: no quantizable kernels found")
    for mod in mods:
        q, scale = quantize_kernel(_numpy_f32(state_dict[mod + ".kernel"]),
                                   bits)
        out[mod + ".kernel"] = torch.from_numpy(q)
        out[mod + ".kernel_scale"] = torch.from_numpy(scale)
    return out


def quantize_model(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                   skip_generator: bool = False) -> nn.Module:
    """Swap int8 kernels and their scales into ``model``'s linear layers,
    in place, on the layers' device; returns ``model``. ``state_dict`` is
    the checkpoint's f32 weights, which JAX quantizes (not the model's
    copy in its compute dtype)."""
    qsd = quantize_params(state_dict, skip_generator=skip_generator)
    mods = dict(model.named_modules())
    with torch.no_grad():
        for name in quantized_modules(qsd, skip_generator=skip_generator):
            mods[name].load_int8(qsd[name + ".kernel"],
                                 qsd[name + ".kernel_scale"])
    return model


def quantized_size_bytes(state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, int]:
    """Byte accounting of a (quantized) ``state_dict``: ``int8`` (the
    int8 kernels) and ``other`` (every other weight), as the JAX function
    counts its param tree; and ``scales`` (the ``kernel_scale`` buffers,
    which JAX keeps in a collection of their own)."""
    out = {"int8": 0, "other": 0, "scales": 0}
    for key, t in state_dict.items():
        n = t.numel() * t.element_size()
        if key.endswith(".kernel_scale"):
            out["scales"] += n
        elif t.dtype == torch.int8:
            out["int8"] += n
        else:
            out["other"] += n
    return out
