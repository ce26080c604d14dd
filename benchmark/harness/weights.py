"""Seeded weights, made on the device in one draw.

Every parameter of the reference's :func:`param_spec` comes from one
``torch.rand`` call on the run's device, seeded with the configuration's
``weights.seed``, and is
cut into its leaves: xavier-uniform kernels and embeddings (flax's law),
linear biases uniform in ``±bias``, norm scales in ``1 ± norm_scale`` and
norm biases in ``±norm_bias``. Kernels, embeddings and linear biases are
kept in the served dtype, norm parameters in float32, as the port holds
them. The generator's kernel and bias are multiplied by
``generator_scale``, one temperature on the output projection. The same
tensors go to the program and, widened to float32, to the reference.

The weights do not follow ``--seed``: the beam's exit step depends on
them (16.4 to 27.8 mean steps over three weight seeds at one scale), so
a run seed that drew them would change the work; ``--seed`` draws the
inputs.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

SEED_MASK = (1 << 63) - 1


def device_generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``salt``."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + salt) & SEED_MASK)
    return g


def make_weights(spec: Dict[str, Tuple[int, ...]], device,
                 dtype: torch.dtype, laws: dict) -> Dict[str, torch.Tensor]:
    seed = laws["seed"]
    total = sum(math.prod(s) for s in spec.values())
    u = torch.rand(total, generator=device_generator(seed, device, 1),
                   device=device, dtype=torch.float32)
    u.mul_(2).sub_(1)                      # uniform in [-1, 1)
    out, at = {}, 0
    for name, shape in spec.items():
        n = math.prod(shape)
        x = u[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        is_norm = ".norm" in name or name.split(".")[-2].startswith(
            ("norm", "ae_norm"))
        if leaf in ("kernel", "embedding"):
            x = x * math.sqrt(6.0 / (shape[-2] + shape[-1]))
        elif leaf == "scale":
            x = 1 + x * laws["norm_scale"]
        elif is_norm:
            x = x * laws["norm_bias"]
        else:
            x = x * laws["bias"]
        if name.startswith("generator."):
            x = x * laws["generator_scale"]
        out[name] = x.to(torch.float32 if is_norm else dtype)
    return out
