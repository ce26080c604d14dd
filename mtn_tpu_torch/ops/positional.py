"""Sinusoidal positional encodings (``mtn_tpu/ops/positional.py``)."""

from __future__ import annotations

import numpy as np
import torch


def sinusoidal_table(max_len: int, d_model: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """(max_len, d_model) table: sin on even dims, cos on odd dims.

    Built in f32 numpy, then cast to ``dtype`` (rounded in bf16, as the
    JAX package rounds it)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[-1]])
    return torch.from_numpy(pe).to(device=device, dtype=dtype)
