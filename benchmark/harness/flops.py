"""Operations and bytes of the model's work, counted from shapes.

A product of an (m, k) and a (k, n) matrix is ``2·m·k·n`` operations;
attention over all heads of width ``d`` (the model width) is ``2·Lq·Lk·d``
for the scores and as many for the weighted sum. Only products count:
norms, softmax and elementwise work are left out, as MFU leaves them
out. Padding counts as no work: every length is the turn's own.

The kernels' counts (:func:`attention_kernel`, :func:`ffn_kernel`) read
each input once and write each output once.
"""

from __future__ import annotations

from typing import Sequence


def linear(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def attention_core(lq: int, lk: int, d: int) -> int:
    return 4 * lq * lk * d


def mha(lq: int, lk: int, d: int) -> int:
    """One attention: q, k, v, o projections and the core."""
    return 2 * linear(lq, d, d) + 2 * linear(lk, d, d) \
        + attention_core(lq, lk, d)


def decode_turn(cfg: dict, lq: int, lh: int, lc: int,
                frames: Sequence[int], steps: int, beam: int) -> int:
    """One turn's beam decode: the encoders, each layer's auto-encoder
    and cross-attention keys and values once, then ``steps`` positions of
    ``beam`` rows (self-attention over the positions so far)."""
    D, F, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    ae = lc if cfg["auto_encoder_ft"] in ("caption", "summary") else lq
    n = sum(linear(T, w, D) for T, w in zip(frames, cfg["ft_sizes"]))
    per_layer = 2 * (linear(lh, D, D) + linear(lc, D, D) + linear(lq, D, D))
    for T in frames:
        per_layer += mha(ae, ae, D) + mha(ae, T, D) \
            + linear(ae, D, F) + linear(ae, F, D) + 2 * linear(ae, D, D)
    n += cfg["nb_blocks"] * per_layer
    for p in range(steps):
        step = 4 * linear(1, D, D) + attention_core(1, p + 1, D)
        for lk in (lh, lc, lq):
            step += 2 * linear(1, D, D) + attention_core(1, lk, D)
        step += len(frames) * (2 * linear(1, D, D)
                               + attention_core(1, ae, D))
        step += linear(1, D, F) + linear(1, F, D)
        n += beam * (cfg["nb_blocks"] * step + linear(1, D, V))
    return n


def attention_kernel(B: int, H: int, lq: int, lk: int, dh: int,
                     elem: int) -> tuple:
    """(operations, bytes) of one attention kernel call: q, k, v and the
    output of ``elem`` bytes, a (B, Lk) boolean key mask."""
    ops = 4 * B * H * lq * lk * dh
    nbytes = elem * B * H * dh * (2 * lq + 2 * lk) + B * lk
    return ops, nbytes


def ffn_kernel(N: int, D: int, F: int, elem: int) -> tuple:
    """(operations, bytes) of one fused FFN call on N rows: x, both
    weights, both biases and the output."""
    ops = 4 * N * D * F
    nbytes = elem * (2 * N * D + 2 * D * F + F + D)
    return ops, nbytes
