#!/usr/bin/env python3
"""Smoke run of mtn_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels (mtn_tpu_torch/csrc/*.cu, one nvcc per
   source, all started together);
3. holds each kernel against its plain PyTorch version on the card, in f32
   and bf16, at the shapes of the beam-decode path, of the sample, rank,
   serving and AOT paths (the FFN at 5, 32, 64, 80 and 200 rows,
   attention at 1, 2 and 16 turns), of a served mesh's rank (attention
   at 8 turns and at 16 turns × 4 heads, the FFN at 40 and 8 rows and at
   d_ff 1024 at 80 and 16), of the batched_ae precompute (attention at B64 = 2 streams
   × 32 turns, Lk 32, and Lk 64 with the shorter stream's padded keys
   masked) and outside its gate (the FFN also at 16, 161 and 256 rows;
   bf16 attention also at
   the edges of its design: Lq 20, Lk 61, Lk 130 and 2048 (two passes over
   key chunks), D 33, 40, 128 and 256, fully masked rows at Lk 61, 130 and
   2048, a per-query mask with two passes),
   each case twice on the same inputs, which must agree bitwise, and times
   kernel, plain version and the one-call PyTorch yardstick
   (``library_*``) beside the bound of the card, two ways: ``*ms`` is the
   host-inclusive time per call (CUDA events around 200 back-to-back calls
   from Python, so at these sizes mostly the host's cost of a call),
   ``*device_us`` the device time per call (the CUDA kernels 50 more
   calls launched, summed by torch.profiler); attention also at a
   model-parallel rank's 4 heads and the FFN at its d_ff 1024, with the
   f32 output that rank's sum takes;
4. drives the main path — ``python -m mtn_tpu_torch.cli.generate`` beam
   decode (beam 5, maxlen 30, 32 turns per batch, bf16, both kernels on) —
   at the full width of the flagship MTN config (6 blocks, d_model 512,
   d_ff 2048, 8 heads, I3D 2048 + VGGish 128 streams, vocab 6000) with
   seeded random weights, on a synthetic DSTC7-format test set, and checks
   that every undisclosed answer was filled and that both kernels launched;
5. checks the flagship model on the card against the same model on the CPU
   (f32, plain versions) on a small batch; then ``[norm-kernel]``: the
   sublayer boundary's residual add and LayerNorm (``csrc/norm.cu``)
   against its plain chain in bf16 and f32 at 1 to 1,024 rows and D 128
   to 4,096 (x_new bitwise; normed no further from the formula in f64
   than the plain chain's, plus one last place at unit scale; two calls
   bitwise), timed beside the plain chain at 1, 32, 160 and
   1,024 rows, and a graphed av beam batch launching it 43 times a step
   with the eager batch's n-bests bitwise;
6. profiles one warm turn batch of the main path (torch.profiler): host
   wall time, device time by kernel group, the hand-written kernels'
   device time per call, and the device's idle share. Every decode batch
   of the one-process paths runs as captured CUDA graphs once its shape
   has come back (``mtn_tpu_torch/decode/graphs.py``; a shape's first
   batch and meshes run eagerly), each token stream as a captured prefix
   and a captured one-token step replayed once a step, and the kernels'
   launch counts add each graph's launches at every replay.
   ``[graphs]``: the flagship in bf16 and f32 (both kernels) on the
   64-turn set, 32 turns a batch: beam (early stop on and off: n-best
   tokens, scores, lengths and step counts), greedy, sampled and rank
   decodes bitwise equal through the eager loop and the captured
   programs, with launches of each; one beam batch eager and graphed
   under torch.profiler (both kernels seen inside the replays, and in
   every profiled call the profiler's count of each kernel equal to its
   own count); the graphed beam at the chunk length k = 1
   (host wall per warm batch, device busy, idle share, device launches,
   host reads and replays a batch, capture seconds per program and the
   bytes a program set holds); ``cli.generate --uniform-shapes 0`` at 8
   turns a batch, eager and graphed (bitwise equal JSON, responses/sec,
   the shapes, captures and eager batches); then ``[parallel]``
   (the main path's ``cli.generate`` in a NCCL world of one through
   ``--multihost``, its JSON bitwise ``[main]``'s; two ranks on the card
   over gloo as a 2x1 and a 1x2 mesh, spawned through the port's Python
   API: two bf16 train steps at batch 8, losses equal on both ranks and
   within 1e-3 of one process's; a 32-turn beam decode, its n-best equal
   on both ranks, under 2x1 equal to one process's margin-aware; under
   1x2 the bf16 beam traced step by step against one process's: the
   log-probs
   of every hypothesis both runs hold within one bf16 step of a logit,
   each turn whose beam parts first doing so at a decision (the last
   hypothesis kept against the first dropped) closer than the runs'
   score differences, and with attention and the FFN replicated (their
   f32 sums in one process's order) the decode bitwise one process's;
   an f32 decode within 1e-3 of one process's, and
   every kernel launch on the rank's shard: attention at 4 heads, the FFN
   at d_ff 1024; under 2x1 also a step at dropout and attention dropout
   0.1, each rank's rows of the dropout masks bitwise one process's and
   the loss within 1e-3, and an update from two 4-row microbatches
   within 1e-3 of one process's 8-row step); then drives the other decode
   modes and stage 4 on the same corpus and weights:
   ``[sample]`` (``cli.generate --decode-style sample``,
   temperature 1, top-k 50, top-p 0.9, through both kernels, counted;
   the same seed again bitwise equal; temperature 0 bitwise equal to
   greedy; 32,000 draws of the card's generator against their softmax by
   chi-square), ``[stream]`` (the greedy and sample streams, folds 0 and
   3, of one turn batch in bf16 and f32, each style's second stream
   captured: every graphed stream step for step the eager stream's and,
   reassembled, the batch decoders' token for token, one program run a
   warm step, launches equal to the eager stream's; host ms a step both
   ways, capture seconds and pool bytes; one warm graphed stream under
   torch.profiler: device µs a step, the kernels' counts equal to the
   profiler's),
   ``[rank]`` (``scripts/make_rank_candidates.py`` with 100 options, then
   ``python -m mtn_tpu_torch.cli.rank`` at 2 turns a batch through both
   kernels, counted, with its retrieval block and its decoder's shapes
   and captures; the same command through the eager loops, its JSON
   bitwise equal; 2 turns' f32 scores on the card against the CPU within
   1e-3) and ``[evaluate]`` (``python -m
   mtn_tpu_torch.cli.evaluate`` on the beam result: the Bleu_1..CIDEr
   block, meaningless on random weights); then ``[int8]``
   (``cli.generate --weights-quant`` int8-fp-head and int8, counted:
   every answer filled, attention launched and the FFN kernel never; the
   f32 int8 model on the card against the CPU within 1e-3; an
   int8-transfer batch on the card bitwise equal to the CPU's; resident
   weight bytes and top-1 agreement of int8 with bf16 logits) and
   ``[serve]`` (an in-process ``serve_http.start_server`` over a bf16
   beam session with both kernels at 16 turns a batch, then over an
   int8-fp-head one: /v1/respond bitwise equal to the session's own
   answer, 32 requests from 8 threads in fewer launches (with the
   decoder's shapes and captures in that load; for bf16 the load again
   through the eager loops, then graphed and warm), /v1/rank with
   100 candidates, a reassembled /v1/stream equal to the greedy decode,
   then again captured, warm (its launches counted), through the eager
   loop and, for bf16, beside the 32-request load's ``AsyncServer``
   batches, each answer the same, with host ms a step of each,
   /admin/reload, /metrics; kernel launches counted over the HTTP
   traffic: both kernels for bf16, attention and never the FFN for
   int8), ``[serve-parallel]`` (two ranks on the card over gloo as 2x1
   and 1x2, rank 0 serving HTTP and rank 1 following it in lockstep: the
   32 requests as two 16-request batches, 8 again from 8 threads, one
   /v1/rank, one greedy /v1/stream, one /admin/reload; under 2x1 the
   n-bests and the stream bitwise one process's, under 1x2 an f32
   session's 16 n-bests margin-aware within 1e-3; both ranks launch both
   kernels (1x2: at 4 heads and d_ff 1024), run the same commands and
   exit 0) and ``[aot]`` (``mtn_tpu_torch.utils.aot``: a bf16 beam
   artifact with row buckets 1 and 16, rank 100 × 24 and the stream
   programs, exported and loaded, seconds and bytes per program; the
   32 requests decoded through it in 16-row chunks bitwise equal to a
   live session at the same frozen shapes with the same launches per
   kernel, host ms per step of both; an in-process ``serve_http`` over
   the artifact from 8 threads, each answer bitwise the live 1-row
   decode, kernel launches counted over the HTTP traffic, /v1/rank,
   /v1/stream; the artifact's greedy stream on its stream set equal to
   the live decoder's stream at the frozen shapes, eager and graphed,
   with host ms a step of each; the f32 artifact on the card within 1e-3 of the CPU's;
   an int8-fp-head artifact at 1 block bitwise its live session,
   attention launched and the FFN kernel never);
7. ``[grad]``: for each kernel in f32 and bf16, the output and the
   gradients through its autograd wrapper (kernel forward, plain
   backward) against its plain version's, at the shapes of a batch-8
   train step;
8. ``[train-graphs]``: each train, accumulation and eval step of the
   seeded flagship as one captured CUDA graph
   (``mtn_tpu_torch/train/graphs.py``) against an eager twin from the
   same state, over four steps (the shape's first eager, then the
   capture, then replays): run (b)'s train step (batch 8, dropout 0,
   both kernels) in bf16 and f32, run (a)'s (batch 32, dropout and
   attention dropout 0.1, remat), an update from two 4-row microbatches
   with --grad-clip and remat (the kernels also launched by the
   recomputation), and an eval step; each step's metrics, dropout
   masks and kernel launches bitwise, then the masters, Adam's moments,
   its device count and the counts; run (a) also saved as an async step
   checkpoint after those steps, resumed in a new graphed trainer and
   stepped on beside the uninterrupted one, bitwise; the capture's
   seconds and pool bytes; host wall per warm step, device busy and idle, launches and
   tokens/sec of both, under the profiler the kernels' counts equal to
   the profiler's;
   ``[train]``: drives run.sh stage 2, ``python -m mtn_tpu_torch.cli.train``,
   at the flagship width on synthetic train and valid sets (vocab 6000),
   two epochs each, its steps graphed: (a) run.sh's settings (dropout
   0.1, batch 32, remat, cut_a), where the kernels run only in
   validation, as in JAX; (b) dropout 0 and batch 8, where both kernels
   also run inside the train steps; checks that the loss falls and the
   checkpoint meta has a best epoch, and reports the trainer's step
   programs (steps, distinct train shapes, captures, eager steps); then
   decodes (a)'s best checkpoint with ``cli.generate``;
   ``[run-torch]``: run.sh's stages 2-4 on the port, ``bash run_torch.sh
   2`` from the checkout's root (``python -m mtn_tpu_torch.cli.train``,
   ``.generate``, ``.evaluate``) at run.sh's settings and its vocabulary
   cutoff of 5, one epoch, with both kernels switched on: the kernels
   run only in validation (read from the trainer's log), the loss falls;
   stage 3's beam decode of the best checkpoint through both kernels,
   its result JSON byte-equal to ``cli.generate`` run here with the same
   flags and its launches equal to those counted here; stage 4's
   Bleu_1..CIDEr block; each stage's wall seconds;
9. ``[train-reference]``: one f32 train step of the trained flagship
   model on the card (kernels) against the CPU (plain versions): the loss
   within 1e-5 and every gradient within a relative L2 difference of
   1e-3, beside the same step on the card with the kernels off;
10. ``[train-profile]``: a warm bf16 train step of run (b)'s
    configuration, eager with both kernels and with both off, beside
    ``[train-graphs]`` b_bf16's graphed step, under torch.profiler (host wall time, tokens/sec, device
    busy and idle, launches per step, device time by kernel group, the
    kernels' counts equal to the profiler's, top host ops), and
    ``[train-kernel]`` lines: each kernel's device µs per call at every
    shape that step launched it at, beside the plain version's and SDPA's,
    and forward plus backward per call through the wrapper (nested
    autograd), through plain autograd, and (attention) with the backward
    written out;
11. ``[batched-ae]``: ``cli.generate`` beam decode of the seeded flagship
    under a ``batched_ae`` sidecar, counted by kernel and shape
    (attention only at B64, the FFN kernel only at the decode step's 160
    rows), the f32 model on the card against the CPU within 1e-3 (two
    turns: no 64-row AE FFN launch, attention at B4), and one bf16
    batch-8 train step against the sequential chain's on the same
    weights (loss within 1e-3 relative; 12 fewer attention and FFN
    launches), with ``[batched-ae-kernel]`` times at its B16 shapes;
12. ``[data]``: the flagship turn batch built by numpy, by the C++ loader
    (``features.native_in_use()`` must be true) and through the feature
    cache (fill, then hits) in f32, bf16 and int8, all bitwise equal on
    the card, with host ms per batch by route;
13. ``[tools]``: ``cli.train`` at 2 blocks and full widths, graphed,
    with ``--profile-dir --async-save 1 --feature-cache`` against an
    eager run under ``--nan-checks 1`` with blocking saves (bitwise equal
    checkpoints, the trace written, the graphed run's captures), then
    ``python -m mtn_tpu_torch.utils.average`` on the card (its mean
    bitwise the CPU's) and ``cli.generate`` on the averaged family.

It exits non-zero, printing no result, without a CUDA device or without
the package beside it. Its last line is ``{"ok": true, "device": ...}``.

    python3 chip_smoke.py --train-traffic

builds the kernels, then measures the trainer's step programs on lengths
that vary as DSTC7-AVSD's do (``[train-traffic]``): the step shapes of
stage 2's batch plans at that data's scale, counted on the host; then
``cli.train`` at run.sh's settings (batch 32, dropout 0.1, remat, cut_a,
buckets of 32, no ``--uniform-shapes``) for three epochs of 400 such
dialogs, graphed, graphed with at most 8 sets kept, and eager, all three
bitwise equal: each epoch's wall seconds, shapes, captures, evictions,
rebuilt sets, capture seconds, the card's peak reserved bytes and the
host's resident bytes.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,           # dense tensor-core bf16
            "float32": 67e12}             # f32 outside the tensor cores
TOL = {  # kernel vs its plain version, max abs
    ("attention", "float32"): 1e-5,       # f32 sums in another order
    ("attention", "bfloat16"): 2 ** -6,   # one bf16 step of |out| < 2
    ("ffn", "float32"): 1e-4,             # 2560-term f32 sums
    ("ffn", "bfloat16"): 2 ** -5,         # one bf16 step of |y| < 4
    # bf16 inputs, f32 output (a model rank's partial sum): h is rounded to
    # bf16 alike on both sides, so only the f32 sums' order is left; an
    # output rounded to bf16 would be off by up to 2^-9 at |y| in [1/2, 1)
    ("ffn", "bfloat16 f32 out"): 1e-4,
}
L2_BYTES = 50 * 2 ** 20

FLAGSHIP = dict(vocab_size=6000, nb_blocks=6, d_model=512, d_ff=2048,
                att_h=8, dropout=0.1, ft_sizes=[2048, 128],
                diff_encoder=True, auto_encoder_ft="query")
GRAD_TOL = {  # wrapper vs plain gradients, max abs over the largest
    "float32": 1e-5,    # the kernel's forward error, through the backward
    "bfloat16": 2 ** -6,  # a few bf16 steps of the gradients themselves
}
# card (kernels) vs CPU (plain), f32: the loss, relative; each gradient's
# relative L2 difference. Sums in another order, amplified where the
# softmax backward cancels (the last layers' self-attention Q and K
# gradients); the card's plain path is printed beside it as the yardstick.
TRAIN_REF_TOL = {"loss": 1e-5, "grad": 1e-3}
N_DIALOGS = 64
N_TRAIN_DIALOGS = 128                     # 384 turns
N_VALID_DIALOGS = 16
FRAMES = ((40, 64), (20, 32))             # -> buckets 64 and 32
WARMUP = 100


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, iters: int = 25, warmup: int = 10):
    """Device time per call of ``fn`` in µs: the durations of the CUDA
    kernels that ``iters`` calls launched, summed by torch.profiler, over
    ``iters``; "not measured" if the profiler saw no device activity.
    (The profiler's own processing, not the calls, takes most of this
    function's time: 25 calls keep the whole script within its time.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(event_device_us(e) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / iters if total > 0 else "not measured"


def event_device_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


def timed(row: dict, prefix: str, fn) -> None:
    """``<prefix>ms`` (host-inclusive) and ``<prefix>device_us`` of fn."""
    row[prefix + "ms"] = time_ms(fn)
    row[prefix + "device_us"] = device_us(fn)


def bound_ms(nbytes: int, ops: int, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# -- kernel phases ----------------------------------------------------------
def attention_cases(torch, ak, dtype_name: str, gen):
    """Each case: max abs error against the plain version, and times.
    Every case runs twice on the same inputs and must agree bitwise; bf16
    adds the edges of its design (ragged Lq, Lk past a key chunk, two
    passes, fully masked rows, D not a multiple of 16 or of 8, D up to
    256)."""
    import torch.nn.functional as F
    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    rows = []
    cases = [  # (B, H, Lq, Lk, D, mask)
        ((32, 8, 32, 32, 64), "keys"),   # AE self-attention (main path)
        ((32, 8, 32, 64, 64), "keys"),   # AE->video attention (main path)
        ((2, 8, 32, 32, 64), "keys"),    # the same at rank's 2 turns
        ((2, 8, 32, 64, 64), "keys"),
        ((16, 8, 32, 32, 64), "keys"),   # the same at serving's 16 turns
        ((16, 8, 32, 64, 64), "keys"),
        ((1, 8, 32, 32, 64), "keys"),    # the same at one turn (serve_http
        ((1, 8, 32, 64, 64), "keys"),    # --aot decodes each request alone)
        ((32, 4, 32, 32, 64), "keys"),   # a rank's 4 heads under
        ((32, 4, 32, 64, 64), "keys"),   # --mesh-model 2 ([parallel])
        ((8, 8, 32, 32, 64), "keys"),    # a served mesh's rank: 8 of 16
        ((8, 8, 32, 64, 64), "keys"),    # turns (2x1), 4 heads (1x2)
        ((16, 4, 32, 32, 64), "keys"),
        ((16, 4, 32, 64, 64), "keys"),
        ((64, 8, 32, 32, 64), "keys"),   # batched_ae: 2 streams x 32 turns
        ((64, 8, 32, 64, 64), "padded"),  # ... AE->video, keys 32-63 of
        #                                   the VGGish half padded
        ((160, 8, 1, 30, 64), "keys"),   # Lq = 1, outside the gate
        ((4, 8, 32, 64, 64), "empty"),   # a fully masked row
        ((4, 8, 32, 64, 64), "full"),    # a (B, 1, Lq, Lk) mask
        ((4, 8, 32, 64, 64), "none"),
    ]
    if dtype_name == "bfloat16":
        cases += [
            ((4, 8, 20, 64, 64), "keys"),    # Lq not a multiple of 16
            ((4, 8, 32, 61, 64), "keys"),    # keys past Lk in the chunk
            ((4, 8, 32, 61, 64), "empty"),   # ... and a fully masked row
            ((4, 8, 16, 130, 64), "keys"),   # two passes, 3 chunks
            ((4, 8, 16, 130, 64), "empty"),  # ... and a fully masked row
            ((4, 8, 32, 130, 64), "full"),   # ... a (B, 1, Lq, Lk) mask
            ((2, 8, 16, 2048, 64), "keys"),  # two passes, the gate's Lk
            ((2, 8, 16, 2048, 64), "empty"),
            ((4, 8, 32, 64, 40), "keys"),    # D padded to 48
            ((4, 8, 32, 64, 33), "keys"),    # D % 8 != 0: element copies
            ((4, 8, 32, 64, 128), "keys"),   # one 128-column slice
            ((4, 8, 32, 130, 256), "keys"),  # two slices, two passes
            ((4, 8, 64, 64, 256), "full"),   # two slices, one pass
        ]
    for (B, H, Lq, Lk, D), kind in cases:
        q = torch.randn(B, H, Lq, D, generator=gen).to(dev, dt)
        k = torch.randn(B, H, Lk, D, generator=gen).to(dev, dt)
        v = torch.randn(B, H, Lk, D, generator=gen).to(dev, dt)
        if kind == "none":
            mask = None
        elif kind == "full":
            mask = (torch.rand(B, 1, Lq, Lk, generator=gen) > 0.3).to(dev)
        else:
            mask = (torch.rand(B, 1, 1, Lk, generator=gen) > 0.2)
            mask[:, :, :, 0] = True
            if kind == "empty":
                mask[0] = False
            if kind == "padded":  # the stacked second stream's padding
                mask[B // 2:, :, :, Lk // 2:] = False
            mask = mask.to(dev)
        got = ak.attention(q, k, v, mask)
        again = ak.attention(q, k, v, mask)
        want = ak.attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        what = f"attention {dtype_name} {(B, H, Lq, Lk, D)} {kind}"
        err = (got.float() - want.float()).abs().max().item()
        if math.isnan(err) or torch.isnan(got.float()).any():
            raise AssertionError(f"{what}: NaN")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two calls on the same inputs "
                                 "differ")
        if kind == "empty":  # uniform average of v for the masked batch
            avg = v[0].float().mean(dim=1, keepdim=True).expand(H, Lq, D)
            err = max(err, (got[0].float() - avg).abs().max().item())
        row = dict(kernel="attention", dtype=dtype_name,
                   shape=[B, H, Lq, Lk, D], mask=kind, max_abs_err=err,
                   tol=TOL[("attention", dtype_name)])
        timed(row, "", lambda: ak.attention(q, k, v, mask))
        timed(row, "plain_", lambda: ak.attention_plain(q, k, v, mask))
        timed(row, "library_", lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes(q, k, v, q, mask), 4 * B * H * Lq * Lk * D, dtype_name)
        rows.append(row)
    return rows


def ffn_cases(torch, fk, dtype_name: str, gen):
    """FFN at the decode step's 160 rows (beam), 32 (sample and stream),
    200 (rank: 2 turns × 100 options) and 80 (serving: 16 turns × beam
    5), and at rank's precompute (the AE FFN over 2 turns × 32 query
    positions, 64 rows); at 5 (an artifact's one-turn beam step, as
    ``serve_http --aot`` decodes each request) and 1 (its one-row stream
    step); at 40 and 8 (a 2x1 served
    rank's beam and stream steps, 8 turns); at 16, 161 (a
    ragged row tile) and 256 rows (the gate's edge); and at 300 and 1024
    rows, outside the gate. Then a tensor-parallel rank's d_ff slice
    (F 1024 under ``--mesh-model 2``) at the decode step's 160 rows, a
    train step's 256 and the served beam and stream steps' 80 and 16, in
    bf16 also with the f32 output that rank sums
    (``f32_out``). Each case runs twice on the same inputs and must agree
    bitwise. Weights rotate over copies larger than L2 together, so every
    timed launch reads them from device memory, as a decode step does
    (each layer's FFN weights are evicted by the other layers')."""
    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    D = 512
    elt = torch.empty((), dtype=dt).element_size()
    outs = (False, True) if dtype_name == "bfloat16" else (False,)
    cases = [(2048, (160, 32, 200, 80, 64, 16, 5, 1, 40, 8, 161, 256, 300,
                     1024), (False,)), (1024, (160, 256, 80, 16), outs)]
    rows = []
    for F, Ns, f32_outs in cases:
        copies = max(2, -(-2 * L2_BYTES // (2 * D * F * elt)))
        weights = []
        for _ in range(copies):
            weights.append(tuple(t.to(dev, dt).contiguous() for t in (
                torch.randn(D, F, generator=gen) / D ** 0.5,
                torch.randn(F, generator=gen) * 0.1,
                torch.randn(F, D, generator=gen) / F ** 0.5,
                torch.randn(D, generator=gen) * 0.1)))
        for N in Ns:
            for f32_out in f32_outs:
                rows.append(ffn_case(torch, fk, dtype_name, gen, weights, N,
                                     f32_out))
    return rows


def ffn_case(torch, fk, dtype_name, gen, weights, N, f32_out):
    dt = getattr(torch, dtype_name)
    w1, b1, w2, b2 = weights[0]
    D, F = w1.shape
    x = torch.randn(N, D, generator=gen).to("cuda", dt)
    got = fk.ffn(x, w1, b1, w2, b2, f32_out)
    again = fk.ffn(x, w1, b1, w2, b2, f32_out)
    want = fk.ffn_plain(x, w1, b1, w2, b2, f32_out)
    torch.cuda.synchronize()
    what = f"ffn {dtype_name} N={N} F={F}" + (" f32 out" if f32_out else "")
    err = (got.float() - want.float()).abs().max().item()
    if math.isnan(err) or torch.isnan(got.float()).any():
        raise AssertionError(f"{what}: NaN")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two calls on the same inputs differ")
    if got.dtype != (torch.float32 if f32_out else dt):
        raise AssertionError(f"{what}: output dtype {got.dtype}")
    turn = [0]

    def rotating(fn):
        def call():
            turn[0] = (turn[0] + 1) % len(weights)
            return fn(x, *weights[turn[0]], f32_out)
        return call
    tol = TOL[("ffn", dtype_name + (" f32 out" if f32_out else ""))]
    row = dict(kernel="ffn", dtype=dtype_name, shape=[N, D, F],
               f32_out=f32_out, max_abs_err=err, tol=tol)
    timed(row, "", rotating(fk.ffn))
    timed(row, "plain_", rotating(fk.ffn_plain))
    row["library_ms"] = None  # no single PyTorch call fuses the MLP
    row["library_device_us"] = None
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes(x, w1, b1, w2, b2, got), 4 * N * D * F, dtype_name)
    return row


def grad_cases(torch, ak, fk, dtype_name: str, gen):
    """Gradients through each kernel's autograd wrapper (kernel forward,
    plain backward) against the gradients of its plain version, on the
    same inputs at the shapes of a batch-8 train step: self-attention
    (causal mask), history (Lk 96: two passes in bf16) and video
    attention, and the FFN's 256 rows. The loss, sum(w·out + out²/2),
    feeds the forward's own error into the backward. Error: max abs
    difference over all inputs' gradients, relative to the largest plain
    gradient; and the wrapper's output against the plain version's, max
    abs, at the ``[kernel]`` tolerance (``fwd_err``, ``fwd_tol``)."""
    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")

    def run(fn, inputs, w):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        loss = (out.float() * w).sum() + 0.5 * (out.float() ** 2).sum()
        loss.backward()
        return out, [t.grad for t in leaves]

    rows = []
    cases = [("attention", (8, 8, 32, 32, 64), "causal"),
             ("attention", (8, 8, 32, 96, 64), "keys"),
             ("attention", (8, 8, 32, 64, 64), "keys"),
             ("ffn", (256, 512, 2048), None)]
    for kernel, shape, kind in cases:
        if kernel == "attention":
            B, H, Lq, Lk, D = shape
            inputs = [torch.randn(B, H, L, D, generator=gen).to(dev, dt)
                      for L in (Lq, Lk, Lk)]
            if kind == "causal":
                mask = torch.ones(Lq, Lk, dtype=torch.bool).tril()[None,
                                                                   None]
            else:
                mask = torch.rand(B, 1, 1, Lk, generator=gen) > 0.2
                mask[..., 0] = True
            mask = mask.to(dev)
            wrapped = lambda q, k, v: ak.attention(q, k, v, mask)
            plain = lambda q, k, v: ak.attention_plain(q, k, v, mask)
            out_shape = (B, H, Lq, D)
        else:
            N, D, F = shape
            inputs = [t.to(dev, dt).contiguous() for t in (
                torch.randn(N, D, generator=gen),
                torch.randn(D, F, generator=gen) / D ** 0.5,
                torch.randn(F, generator=gen) * 0.1,
                torch.randn(F, D, generator=gen) / F ** 0.5,
                torch.randn(D, generator=gen) * 0.1)]
            wrapped, plain, out_shape = fk.ffn, fk.ffn_plain, (N, D)
        w = torch.randn(*out_shape, generator=gen).to(dev)
        launches = ak.KERNEL.launches + fk.KERNEL.launches
        out, got = run(wrapped, inputs, w)
        plain_out, want = run(plain, inputs, w)
        torch.cuda.synchronize()
        what = f"grad {kernel} {dtype_name} {shape}"
        if out.grad_fn is None or \
                ak.KERNEL.launches + fk.KERNEL.launches != launches + 1:
            raise AssertionError(f"{what}: the wrapper did not launch the "
                                 "kernel behind autograd")
        if not all(torch.isfinite(g.float()).all() for g in got):
            raise AssertionError(f"{what}: a gradient is not finite")
        err = max((g.float() - p.float()).abs().max().item()
                  for g, p in zip(got, want))
        scale = max(p.float().abs().max().item() for p in want)
        fwd_err = (out.float() - plain_out.float()).abs().max().item()
        rows.append(dict(kernel=kernel, dtype=dtype_name, shape=list(shape),
                         mask=kind, grad_fn=type(out.grad_fn).__name__,
                         fwd_err=fwd_err, fwd_tol=TOL[(kernel, dtype_name)],
                         max_abs_err=err, max_abs_grad=scale,
                         rel_err=err / scale,
                         tol=GRAD_TOL[dtype_name]))
    return rows


# -- main path ----------------------------------------------------------------
def write_corpus(root: str, seed: int = 0) -> dict:
    """DSTC7-format data at the flagship width, .npy features for every
    video, and the flagship config with seeded random weights in the
    port's checkpoint format (``prefix``): a test set with undisclosed
    last answers (``test_set``, decoded with a 6000-entry vocabulary), the
    same dialogs with their real last answers (``lbl_test_set``), and
    train and valid sets whose answers are disclosed (``train_set``,
    ``valid_set``). The train captions and summaries run through every
    word, so the vocabulary the train CLI builds from them (cutoff 0)
    also has 6000 entries."""
    import copy

    import numpy as np
    import torch
    from mtn_tpu_torch.config import DataConfig, ModelConfig
    from mtn_tpu_torch.data.vocab import SPECIALS
    from mtn_tpu_torch.weights import init_params, save_checkpoint, save_conf

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(FLAGSHIP["vocab_size"] - len(SPECIALS))]
    vocab = dict(SPECIALS)
    for w in words:
        vocab[w] = len(vocab)
    say = lambda lo, hi: " ".join(rng.choice(words, int(rng.integers(lo,
                                                                        hi))))
    cover = iter(np.resize(rng.permutation(words), N_TRAIN_DIALOGS * 48))
    # a trailing space keeps the reference's raw caption + summary
    # concatenation from fusing two words into a new one
    tell = lambda: " ".join(next(cover) for _ in range(24)) + " "

    def dialogs(prefix, n, caption):
        out = []
        for d in range(n):
            turns = [{"question": say(20, 30), "answer": say(5, 15)}
                     for _ in range(3)]
            out.append({"image_id": f"{prefix}{d:03d}", "caption": caption(),
                        "summary": caption(), "dialog": turns})
        return out

    sets = {"test_set": dialogs("vid", N_DIALOGS, lambda: say(10, 20)),
            "train_set": dialogs("tr", N_TRAIN_DIALOGS, tell),
            "valid_set": dialogs("va", N_VALID_DIALOGS, lambda: say(10, 20))}
    labeled = copy.deepcopy(sets["test_set"])
    for d in sets["test_set"]:
        d["dialog"][-1]["answer"] = "__UNDISCLOSED__"
    corpus = {}
    for name, ds in list(sets.items()) + [("lbl_test_set", labeled)]:
        corpus[name] = os.path.join(root, name + ".json")
        with open(corpus[name], "w") as f:
            json.dump({"type": "test", "version": "0.1", "dialogs": ds}, f)
    fea_types = ["i3d_rgb", "vggish"]
    for ftype, dim, (lo, hi) in zip(fea_types, FLAGSHIP["ft_sizes"], FRAMES):
        os.makedirs(os.path.join(root, ftype))
        for d in (d for ds in sets.values() for d in ds):
            n = int(rng.integers(lo, hi + 1))
            np.save(os.path.join(root, ftype, d["image_id"] + ".npy"),
                    rng.standard_normal((n, dim)).astype(np.float32))
    cfg = ModelConfig(**FLAGSHIP)
    corpus["prefix"] = os.path.join(root, "mtn")
    save_conf(corpus["prefix"], vocab, model=cfg, data=DataConfig(
        fea_type=fea_types, include_caption="caption,summary",
        separate_caption=True))
    save_checkpoint(corpus["prefix"], 1, init_params(
        cfg, torch.Generator().manual_seed(seed)))
    corpus["fea_path"] = os.path.join(root, "<FeaType>", "<ImageID>.npy")
    corpus["fea_types"] = fea_types
    return corpus


def reference_check(torch, prefix, test_set, fea_path, weights_quant=""):
    """The flagship model on the card (f32, both kernels) against the same
    weights on the CPU (f32, plain versions): init_decode_state and three
    decode steps on two turns; returns the max abs log-prob difference.
    ``weights_quant`` quantizes both models alike (int8 kernels: the FFN
    kernel is skipped, attention runs)."""
    from mtn_tpu_torch.config import config_from_dict
    from mtn_tpu_torch.data.batching import make_batch, make_batch_indices
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.train.batch import batch_masks, device_batch
    from mtn_tpu_torch.utils.quantize import quantize_model
    from mtn_tpu_torch.weights import load_checkpoint, load_conf, load_model

    vocab, conf = load_conf(prefix)
    cfg = config_from_dict("model", conf["model"])
    cfg.use_pallas_attention = cfg.use_pallas_ffn = True
    data = load(conf["data"]["fea_type"], fea_path, test_set, vocab,
                include_caption="caption,summary", separate_caption=True,
                undisclosed_only=True)
    plans, _ = make_batch_indices(data, 2, max_length=10 ** 9,
                                  separate_caption=True)
    hb = make_batch(data, plans[0], separate_caption=True,
                    length_bucket=32, feature_bucket=32)
    sd, _ = load_checkpoint(prefix)
    logps = []
    for dev in ("cuda", "cpu"):
        model = load_model(cfg, sd, dev)
        if weights_quant:
            quantize_model(model, sd,
                           skip_generator=weights_quant == "int8-fp-head")
        db = device_batch(hb, dev)
        with torch.inference_mode():
            masks, _ = batch_masks(db, 1)
            state = model.init_decode_state(db.query, db.his, db.cap,
                                            db.fts, masks)
            kv = model.init_self_kv(db.query.shape[0], 4, dev)
            tok = torch.full((db.query.shape[0],), 2, dtype=torch.int64,
                             device=dev)
            out = []
            for pos in range(3):
                logp, kv = model.decode_step(state, tok, pos, kv)
                out.append(logp.float().cpu())
                tok = torch.tensor([7, 9])[:db.query.shape[0]].to(dev)
        logps.append(torch.stack(out))
        del model
    if not torch.isfinite(logps[0]).all() or \
            logps[0].shape != (3, hb.query.shape[0], cfg.vocab_size):
        raise AssertionError(f"card log-probs: shape {tuple(logps[0].shape)}"
                             ", or not finite")
    return (logps[0] - logps[1]).abs().max().item()


def kernel_group(name: str) -> str:
    if "mtn_attention_" in name:
        return "attention (csrc)"
    if "ffn_" in name:
        return "ffn (csrc)"
    if "add_norm" in name:
        return "norm (csrc)"
    # cuBLASLt names its Hopper GEMMs nvjet_*
    if any(s in name for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    if "sort" in name.lower() or "radix" in name.lower():
        return "sort (top-k)"
    if "multi_tensor_apply" in name:
        return "optimizer (foreach)"
    return "other"


def device_groups(torch, prof):
    """(device ms by kernel group, kernel launches, top kernels) of a
    torch.profiler run."""
    groups, top, launches = {}, [], 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = event_device_us(e)
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:60]))
        launches += e.count
    return groups, launches, sorted(top, reverse=True)[:8]


# a beam step's host ranges, innermost first where they nest: (module,
# owner in it or None, function, group)
STEP_GROUPS = (
    ("mtn_tpu_torch.models.layers", "RefLayerNorm", "forward", "norm"),
    ("mtn_tpu_torch.models.layers", "ParamLinear", "forward", "bias adds"),
    ("mtn_tpu_torch.models.layers", "Sublayer", "forward", "residual adds"),
    ("mtn_tpu_torch.models.layers", None, "multi_head_attention",
     "attention"),
    ("mtn_tpu_torch.models.mtn", "MTN", "decode_step", "rest of the step"),
    ("mtn_tpu_torch.decode.beam", None, "beam_step", "beam"),
    ("mtn_tpu_torch.decode.beam", "BeamDecoder", "beam_prefix", "prefix"))
# kernels filed by name before their host range
NAMED_GROUPS = ("matmul (cuBLAS)", "ffn (csrc)", "norm (csrc)",
                "attention (csrc)")


@contextlib.contextmanager
def step_ranges(torch):
    """Each function of :data:`STEP_GROUPS` runs inside a
    ``record_function`` range named after its group."""
    import importlib
    saved = []
    for mod, owner, name, group in STEP_GROUPS:
        obj = importlib.import_module(mod)
        obj = getattr(obj, owner) if owner else obj
        fn = getattr(obj, name)

        def wrapped(*a, _fn=fn, _group=group, **kw):
            with torch.profiler.record_function("group: " + _group):
                return _fn(*a, **kw)
        saved.append((obj, name, fn))
        setattr(obj, name, wrapped)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def step_groups(prof, steps: int) -> dict:
    """Kernels and device ms a step by group of a profile taken under
    :func:`step_ranges`: a kernel in :data:`NAMED_GROUPS` by its name,
    any other under its innermost range; the batch's prefix (encoder, AE
    chain, cross K/V) apart, for the batch."""
    out = {}
    for evt in prof.events():
        for k in getattr(evt, "kernels", []):
            labels, parent = [], evt
            while parent is not None:
                if parent.name.startswith("group: "):
                    labels.append(parent.name[len("group: "):])
                parent = parent.cpu_parent
            group = kernel_group(k.name)
            if "prefix" in labels:
                group = "prefix"
            elif group not in NAMED_GROUPS:
                group = labels[0] if labels else "unlabelled"
            row = out.setdefault(group, [0, 0.0])
            row[0] += 1
            row[1] += k.duration
    prefix = out.pop("prefix", [0, 0.0])
    return {"steps": steps,
            "kernels_a_step": sum(n for n, _ in out.values()) / steps,
            "device_ms_a_step": sum(us for _, us in out.values())
            / steps / 1e3,
            "by_group_a_step": {g: {"kernels": n / steps,
                                    "device_ms": us / steps / 1e3}
                                for g, (n, us) in sorted(out.items())},
            "prefix": {"kernels": prefix[0], "device_ms": prefix[1] / 1e3}}


def profile_decode(torch, prefix, test_set, fea_path):
    """One warm beam-decoded turn batch of the main path (bf16, both
    kernels), one graph launch: host wall time, the device's time on it
    (CUDA events) and idle share (:func:`event_batches`); then the same
    batch through the eager loop under torch.profiler: device time by
    kernel group and the hand-written kernels' device time per wrapper
    call. Returns a dict."""
    from mtn_tpu_torch.config import DecodeConfig, config_from_dict
    from mtn_tpu_torch.data.batching import make_batch, make_batch_indices
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.decode.beam import BeamDecoder
    from mtn_tpu_torch.ops import attention_kernel as ak
    from mtn_tpu_torch.ops import ffn_kernel as fk
    from mtn_tpu_torch.ops import norm_kernel as nk
    from mtn_tpu_torch.train.batch import device_batch
    from mtn_tpu_torch.weights import load_checkpoint, load_conf, load_model
    from torch.profiler import ProfilerActivity, profile

    vocab, conf = load_conf(prefix)
    cfg = config_from_dict("model", conf["model"])
    cfg.dtype = "bfloat16"
    cfg.use_pallas_attention = cfg.use_pallas_ffn = True
    data = load(conf["data"]["fea_type"], fea_path, test_set, vocab,
                include_caption="caption,summary", separate_caption=True,
                undisclosed_only=True)
    plans, _ = make_batch_indices(data, 32, max_length=10 ** 9,
                                  separate_caption=True)
    hb = make_batch(data, plans[0], separate_caption=True, length_bucket=32,
                    feature_bucket=32, pad_rows_to=32)
    model = load_model(cfg, load_checkpoint(prefix)[0], "cuda")
    db = device_batch(hb, "cuda", "bfloat16")
    dec = BeamDecoder(model, DecodeConfig(maxlen=30, beam=5, nbest=5,
                                          penalty=1.0))
    dec.beam_batch_raw(db)   # the shape's first batch runs eagerly,
    raw = dec.beam_batch_raw(db)   # its second captures
    dec.beam_results(raw, db.valid)
    timed = event_batches(torch, ak, fk, dec, [db], fetch=False)
    # kernel time by group from the eager twin of the same batch: the
    # profiler does not run over a graph with conditional nodes
    zero_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            step_ranges(torch):
        eager = eager_twin(dec).beam_batch_raw(db)
        torch.cuda.synchronize()
    calls = {"attention (csrc)": ak.KERNEL.launches,
             "ffn (csrc)": fk.KERNEL.launches,
             "norm (csrc)": nk.KERNEL.launches}
    groups, launches, top = device_groups(torch, prof)
    measured = launches > 0
    return {"wall_ms": timed["wall_ms"], "steps": int(raw.n_steps),
            "device_ms": timed["device_ms"],
            "idle_share": timed["idle_share"],
            "graph_launches": timed["graph_launches"],
            "kernel_launches_counted": timed["kernel_launches_counted"],
            "eager_device_ms": sum(groups.values()) if measured
            else "not measured",
            "eager_device_ms_by_group": groups,
            "eager_device_launches": launches,
            "kernel_calls": calls,
            "eager_step": step_groups(prof, int(eager.n_steps))
            if measured else "not measured",
            "device_us_per_call": {
                g: groups.get(g, 0.0) * 1e3 / n if measured and n
                else "not measured" for g, n in calls.items()},
            "top_kernels": top}


def event_batches(torch, ak, fk, dec, batches, depth: int = 0,
                  fetch: bool = True, rounds: int = 2) -> dict:
    """``dec``'s graphed beam batches timed without the profiler, which
    must not run over a graph with conditional nodes: host wall per
    round (ending in a synchronize), the batches launched ``depth`` ahead
    of their fetch (all of them with 0; none fetched without ``fetch``),
    each launch bracketed by CUDA events on the stream, whose spans sum
    to the device's time on the batches (``device_ms``); the idle share,
    graph launches and the kernels' counts of the last round."""
    walls, busy = [], []
    depth = depth or len(batches)
    for _ in range(rounds):
        before = (ak.KERNEL.launches, fk.KERNEL.launches)
        n = graph_loop_launches()
        spans, pending = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for db in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            raw = dec.beam_batch_raw(db)
            end.record()
            spans.append((start, end))
            pending.append((raw, db.valid))
            if fetch and len(pending) >= depth:
                dec.beam_results(*pending.pop(0))
        while fetch and pending:
            dec.beam_results(*pending.pop(0))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        busy.append(sum(a.elapsed_time(b) for a, b in spans))
    wall, device = sum(walls) / rounds, sum(busy) / rounds
    return dict(wall_ms=wall, walls_ms=walls, device_ms=device,
                idle_share=1 - device / wall,
                graph_launches=graph_loop_launches() - n,
                kernel_launches_counted={
                    "attention": ak.KERNEL.launches - before[0],
                    "ffn": fk.KERNEL.launches - before[1]})


def graph_loop_launches() -> int:
    from mtn_tpu_torch.ops import graph_loop
    return graph_loop.LAUNCHES


# -- [norm-kernel]: a sublayer boundary's residual add and LayerNorm --------
NORM_ROWS = (1, 5, 16, 32, 80, 160, 256, 1024)
NORM_TIMED_ROWS = (1, 32, 160, 1024)
NORM_BF16_SHARE = 0.99   # of bf16 outputs bitwise the plain chain's
MANTISSA_BITS = {"float32": 23, "bfloat16": 7}


def ulps_at_unit_scale(torch, got, want, dtype_name: str) -> float:
    """max |got - want| in units of the dtype's last place at max(|want|,
    1): a normed row has unit scale, and the order of its two sums shows
    at that scale, not at an element's own (near 0 the formula's f32
    rounding is already coarser than the element's last place)."""
    mag = want.float().abs().clamp(min=1.0)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - MANTISSA_BITS[dtype_name])
    return ((got.float() - want.float()).abs() / ulp).max().item()


def norm_case(torch, nk, gen, dtype_name, R, D, parts="delta_bias",
              param_dtype="float32", timed_case=False):
    """The kernel against the plain chain on the card: x_new bitwise;
    normed's distance from the plain chain's, and each one's distance
    from the formula in f64 on the same x_new, in last places at unit
    scale: the kernel no further from it than the plain chain is, plus
    one last place (the two round the row's sums differently: the
    kernel's in f64, the plain chain's in f32); in bf16 also within one
    last place of the plain chain's, and bitwise for
    ``NORM_BF16_SHARE`` of the outputs; two calls bitwise; with
    ``timed_case``, times of both beside the bound (8·R·D bytes in
    bf16: x and delta read, x_new and normed written)."""
    dt, pdt = getattr(torch, dtype_name), getattr(torch, param_dtype)
    mk = lambda *s, a=1.0: (a * torch.randn(*s, generator=gen)).to("cuda")
    x = mk(R, 1, D, a=3.0).to(dt)
    delta = mk(R, 1, D).to(dt) if parts != "none" else None
    bias = mk(D, a=0.1).to(dt) if parts == "delta_bias" else None
    scale, nbias = (mk(D, a=0.1) + 1).to(pdt), mk(D, a=0.02).to(pdt)
    args = (x, delta, bias, scale, nbias, 1e-6)
    n = nk.KERNEL.launches
    got, again = nk.add_norm(*args), nk.add_norm(*args)
    want = nk.add_norm_plain(*args)
    torch.cuda.synchronize()
    row = dict(kernel="add_norm", dtype=dtype_name, params=param_dtype,
               shape=[R, D], parts=parts,
               launches=nk.KERNEL.launches - n,
               x_new_bitwise=torch.equal(got[0], want[0]),
               normed_bitwise_share=(got[1] == want[1]).float().mean().item(),
               normed_max_ulps=ulps_at_unit_scale(torch, got[1], want[1],
                                                  dtype_name),
               repeat_bitwise=all(torch.equal(a, b)
                                  for a, b in zip(got, again)),
               finite=bool(torch.isfinite(got[1].float()).all()))
    xd = want[0].double()     # the formula in f64 on the same x_new
    mean = xd.mean(-1, keepdim=True)
    var = (xd - mean).square().sum(-1, keepdim=True) / (D - 1)
    exact = scale.double() * (xd - mean) / (var.sqrt() + 1e-6) \
        + nbias.double()
    row["normed_ulps_from_f64"] = ulps_at_unit_scale(torch, got[1], exact,
                                                     dtype_name)
    row["plain_ulps_from_f64"] = ulps_at_unit_scale(torch, want[1], exact,
                                                    dtype_name)
    row["ok"] = (row["launches"] == 2 and row["x_new_bitwise"]
                 and row["normed_ulps_from_f64"]
                 <= row["plain_ulps_from_f64"] + 1
                 and row["repeat_bitwise"] and row["finite"])
    if dtype_name == "bfloat16":
        # a last place of bf16 at unit scale is coarser than a wrong
        # divisor or eps: hold the rounded output to the plain chain's
        row["ok"] &= (row["normed_max_ulps"] <= 1
                      and row["normed_bitwise_share"] >= NORM_BF16_SHARE)
    if timed_case:
        timed(row, "", lambda: nk.add_norm(*args))
        timed(row, "plain_", lambda: nk.add_norm_plain(*args))
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes(x, delta, *got), 0, dtype_name)
    return row


def norm_graphed_beam(torch, nk, corpus: dict) -> dict:
    """One 32-turn av beam batch of the flagship (bf16, both kernels):
    the eager loop and a graphed replay (the shape's third batch: its
    first runs eagerly, its second captures), their n-bests bitwise,
    and the kernel's launches in each, 43 a step (7 sublayers in each of
    6 layers, and layer 0's input)."""
    from mtn_tpu_torch.config import DecodeConfig
    from mtn_tpu_torch.decode.beam import BeamDecoder
    from mtn_tpu_torch.train.batch import device_batch
    from mtn_tpu_torch.weights import load_model
    hbs, cfg, sd = flagship_batches(corpus, 32)
    cfg.use_pallas_attention = cfg.use_pallas_ffn = True
    cfg.dtype = "bfloat16"
    model = load_model(cfg, sd, "cuda")
    db = device_batch(hbs[0], "cuda", "bfloat16")
    dec = BeamDecoder(model, DecodeConfig(early_stop=True, **GRAPH_DECODE))
    per_step = cfg.nb_blocks * (5 + cfg.n_streams) + 1

    def counted(fn):
        n = nk.KERNEL.launches
        raw = fn()
        torch.cuda.synchronize()
        return raw, nk.KERNEL.launches - n
    eager, eager_n = counted(lambda: eager_twin(dec).beam_batch_raw(db))
    for _ in range(2):
        dec.beam_batch_raw(db)
    graphed, graphed_n = counted(lambda: dec.beam_batch_raw(db))
    same = int(eager.n_steps) == int(graphed.n_steps) and all(
        torch.equal(a, b) for a, b in zip(
            (eager.comp_scores, eager.comp_buf, eager.comp_len),
            (graphed.comp_scores, graphed.comp_buf, graphed.comp_len)))
    steps = int(graphed.n_steps)
    out = dict(steps=steps, per_step=per_step, eager_launches=eager_n,
               graphed_launches=graphed_n, nbest_bitwise=same,
               graph_runs=dec.graphs.batches)
    out["ok"] = (same and eager_n == per_step * int(eager.n_steps)
                 and graphed_n == per_step * steps)
    del dec, model
    torch.cuda.empty_cache()
    return out


def norm_phase(torch, nk, corpus: dict) -> dict:
    """``[norm-kernel]``: the kernel against the plain chain at the
    decode paths' rows (a served stream's 1 to the AE width's 1,024) in
    bf16 and f32 at D 512 and 1,024, at the edges of its gate (D 128,
    384 and 4,096), without bias and without delta, with bf16 norm
    parameters; timed at 1, 32, 160 and 1,024 rows; then
    :func:`norm_graphed_beam`."""
    gen = torch.Generator().manual_seed(20)
    rows = []
    for dtype_name in ("bfloat16", "float32"):
        for D in (512, 1024):
            for R in NORM_ROWS:
                rows.append(norm_case(torch, nk, gen, dtype_name, R, D,
                                      timed_case=D == 512
                                      and R in NORM_TIMED_ROWS))
        for D in (128, 384, 4096):
            rows.append(norm_case(torch, nk, gen, dtype_name, 7, D))
        for parts in ("delta", "none"):
            rows.append(norm_case(torch, nk, gen, dtype_name, 160, 512,
                                  parts))
    rows.append(norm_case(torch, nk, gen, "bfloat16", 160, 512,
                          param_dtype="bfloat16"))
    beam = norm_graphed_beam(torch, nk, corpus)
    return dict(rows=rows, beam=beam,
                ok=all(r["ok"] for r in rows) and beam["ok"])


# -- [graphs]: each decode batch as one device program ------------------------
GRAPH_CHUNKS = (1,)        # k under the WHILE node (PR 14's sweep: k 2 and
                           # 4 read 34.56-34.81 and 33.92-34.19 ms a batch
                           # against k 1's 31.13-31.65)
GRAPH_DECODE = dict(maxlen=30, beam=5, nbest=5, penalty=1.0)
GRAPH_SAMPLE = dict(maxlen=30, temperature=1.0, top_k=50, top_p=0.9,
                    sample_seed=1)
IN_FLIGHT = 8              # cli.generate's MAX_IN_FLIGHT


@contextlib.contextmanager
def capture_seconds():
    """The seconds of each program set built inside the block (its
    ``*capture`` spans, :func:`mtn_tpu_torch.utils.profiling.recording`,
    less the tracer's own ``profiler.*`` spans inside them), filled in
    when the block ends."""
    from mtn_tpu_torch.utils import profiling
    built = []
    with profiling.recording() as rec:
        yield built
    ns = lambda sp: sp.end_ns - sp.start_ns
    built.extend((ns(sp) - sum(ns(t) for t in rec.spans if t.parent is sp
                               and t.name.startswith("profiler."))) / 1e9
                 for sp in rec.spans if sp.name.endswith("capture"))


@contextlib.contextmanager
def no_host_reads(torch):
    """Raise at any operation that waits for the device inside the block
    (``torch.cuda.set_sync_debug_mode("error")``): a read of a device
    value, a copy to or from pageable memory, a synchronize."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def flagship_batches(corpus: dict, rows: int):
    """Every batch of ``rows`` turns of the undisclosed test set at one
    shape (the main path's ``uniform_shapes``), the config and the
    checkpoint."""
    from mtn_tpu_torch.config import config_from_dict
    from mtn_tpu_torch.data.batching import (make_batch, make_batch_indices,
                                             uniform_plans)
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.weights import load_checkpoint, load_conf
    vocab, conf = load_conf(corpus["prefix"])
    data = load(conf["data"]["fea_type"], corpus["fea_path"],
                corpus["test_set"], vocab, include_caption="caption,summary",
                separate_caption=True, undisclosed_only=True)
    plans, _ = make_batch_indices(data, rows, max_length=10 ** 9,
                                  separate_caption=True)
    hbs = [make_batch(data, plan, separate_caption=True, length_bucket=32,
                      feature_bucket=32, pad_rows_to=rows)
           for plan in uniform_plans(plans)]
    return (hbs, config_from_dict("model", conf["model"]),
            load_checkpoint(corpus["prefix"])[0])


def eager_twin(dec):
    """A decoder on ``dec``'s model and config that runs the eager loops
    (the decoder's own switch, set on this instance)."""
    from mtn_tpu_torch.decode.beam import BeamDecoder
    twin = BeamDecoder(dec.model, dec.cfg)
    twin.graphed = lambda t: False
    return twin


def graph_equality(torch, ak, fk, model, dbs, rank_db, cands) -> dict:
    """Every decode mode on ``dbs`` through the eager loop and through a
    graphed decoder (three times: a shape's first batch runs eagerly, its
    second captures), compared bitwise: beam with early stop on and off
    (n-best tokens, scores, lengths, step counts), greedy and sampled
    tokens, rank log-probs. The third run's calls, on sets built before
    it, run under :func:`no_host_reads` and must each make one graph
    launch."""
    from mtn_tpu_torch.config import DecodeConfig
    from mtn_tpu_torch.decode.beam import BeamDecoder
    from mtn_tpu_torch.ops import graph_loop
    out = {}

    def compare(name, dec, fn, same, batches=dbs):
        twin, secs, launches = eager_twin(dec), [], []

        def timed(d, watched=False):
            t0 = time.perf_counter()
            res = []
            for db in batches:
                n = graph_loop.LAUNCHES
                with (no_host_reads(torch) if watched
                      else contextlib.nullcontext()):
                    res.append(fn(d, db))
                launches.append(graph_loop.LAUNCHES - n)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            return res
        eager, e_n, _ = run_path(torch, ak, fk, lambda: timed(twin))
        with capture_seconds() as built:   # the shapes' eager, captured
            runs = [run_path(torch, ak, fk, lambda: timed(dec))
                    for _ in range(2)]
        runs.append(run_path(torch, ak, fk, lambda: timed(dec, True)))
        ps = list(dec.graphs.sets.values())
        watched = launches[-len(batches):]
        out[name] = dict(
            bitwise=all(same(a, r) for run, _, _ in runs
                        for a, r in zip(eager, run)),
            launches_eager=e_n,
            launches_graphed=[n for _, n, _ in runs], eager_s=secs[0],
            graphed_s=secs[1:], capture_s=built,
            host_reads_before_fetch=0, graph_launches_per_batch=watched,
            one_launch=watched == [1] * len(batches),
            reads=sum(p.reads for p in ps), replays=sum(p.replays for p in ps),
            runner=runner_counts([dec.graphs]))
        return eager

    def same_raw(a, b):
        return int(a.n_steps) == int(b.n_steps) and all(
            torch.equal(x, y) for x, y in zip(
                (a.comp_scores, a.comp_buf, a.comp_len),
                (b.comp_scores, b.comp_buf, b.comp_len)))
    for es in (True, False):
        dec = BeamDecoder(model, DecodeConfig(early_stop=es, **GRAPH_DECODE))
        raws = compare(f"beam_early_stop_{'on' if es else 'off'}", dec,
                       lambda d, db: d.beam_batch_raw(db), same_raw)
        out[f"beam_early_stop_{'on' if es else 'off'}"]["n_steps"] = [
            int(r.n_steps) for r in raws]
        del dec
    compare("greedy", BeamDecoder(model, DecodeConfig(**GRAPH_SAMPLE)),
            lambda d, db: d.greedy_tokens(db), torch.equal)
    compare("sample", BeamDecoder(model, DecodeConfig(**GRAPH_SAMPLE)),
            lambda d, db: d.sample_tokens(db, fold=3), torch.equal)
    dec = BeamDecoder(model, DecodeConfig())
    compare("rank", dec, lambda d, db: d.rank_batch_raw(
        db, cands, cand_bucket=N_OPTIONS)[0], torch.equal, [rank_db])
    del dec
    out["ok"] = all(v["bitwise"] and v["one_launch"] for v in out.values())
    return out


def profiled_batches(torch, ak, fk, fn, rounds: int = 2) -> dict:
    """Host wall per call of ``fn`` (warm, ``rounds`` calls, each ending
    in a synchronize), then one more under torch.profiler: device busy,
    idle share, device launches, and the hand-written kernels' launches
    by name (those inside graph replays too), seen by the profiler and
    counted by the kernels' counts over the same call."""
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    before = (ak.KERNEL.launches, fk.KERNEL.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counted = {"attention": ak.KERNEL.launches - before[0],
               "ffn": fk.KERNEL.launches - before[1]}
    groups, launches, _ = device_groups(torch, prof)
    named = {"attention": 0, "ffn": 0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = kernel_group(e.key)
            if g in ("attention (csrc)", "ffn (csrc)"):
                named[g.split()[0]] += e.count
    wall = sum(walls) / len(walls)
    busy = sum(groups.values())
    measured = launches > 0
    return dict(wall_ms=wall, walls_ms=walls,
                device_busy_ms=busy if measured else "not measured",
                idle_share=1 - busy / wall if measured else "not measured",
                device_launches=launches if measured else "not measured",
                kernel_launches_seen=named if measured else "not measured",
                kernel_launches_counted=counted,
                counts_match=named == counted)


@contextlib.contextmanager
def graph_runners(cls=None):
    """Every decoder's ``GraphRunner`` (or every ``cls``: a trainer's
    ``StepGraphs``) made inside the block (the CLIs' and sessions' own),
    to read their counts after it."""
    from mtn_tpu_torch.decode import graphs
    cls = cls or graphs.GraphRunner
    made, init = [], cls.__init__

    def recorded(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)
    cls.__init__ = recorded
    try:
        yield made
    finally:
        cls.__init__ = init


def runner_counts(runners) -> dict:
    """Batches, the distinct shapes among them, the program sets built
    (captures), dropped for another (evictions), kept, and the batches
    run eagerly, over ``runners``; for a trainer's, the distinct train
    (and accumulation) shapes."""
    from mtn_tpu_torch.train.graphs import StepGraphs
    out = dict(batches=sum(r.batches for r in runners),
               shapes=sum(len(r.seen) for r in runners),
               captures=sum(r.captures for r in runners),
               evictions=sum(r.evictions for r in runners),
               sets=sum(len(r.sets) for r in runners),
               eager=sum(r.eager for r in runners))
    if any(isinstance(r, StepGraphs) for r in runners):
        out["train_shapes"] = sum(k[0] != "eval" for r in runners
                                  for k in r.seen)
    return out


@contextlib.contextmanager
def eager_decoders():
    """Every ``BeamDecoder`` runs its eager loops inside the block."""
    from mtn_tpu_torch.decode.beam import BeamDecoder
    graphed = BeamDecoder.graphed
    BeamDecoder.graphed = lambda self, t: False
    try:
        yield
    finally:
        BeamDecoder.graphed = graphed


def graphs_phase(torch, ak, fk, corpus: dict, root: str) -> dict:
    """``[graphs]``: the flagship (bf16 and f32, both kernels) on the
    64-turn synthetic set, 32 turns a batch at one shape: every decode
    mode bitwise equal through the eager loop and the captured programs
    (:func:`graph_equality`); one beam batch eager and graphed under
    torch.profiler (both kernels inside the replays, the profiler's
    count of each equal to the kernels' own); for each chunk length k
    of ``GRAPH_CHUNKS``: host wall per warm beam batch, device busy, idle share,
    device launches, host reads, graph launches and program runs,
    capture seconds per program and the bytes the program set holds
    (``memory_reserved`` after ``empty_cache``, its capture against
    before it); ``IN_FLIGHT`` batches in flight against one; then
    ``cli.generate --uniform-shapes 0`` eager and graphed
    (:func:`shape_traffic`)."""
    import numpy as np
    from mtn_tpu_torch.decode import graphs
    from mtn_tpu_torch.train.batch import device_batch
    from mtn_tpu_torch.weights import load_model
    hbs, cfg, sd = flagship_batches(corpus, 32)
    rank_hb = flagship_batch(corpus, RANK_TURNS)[0]
    rng = np.random.default_rng(2)
    cands = [[rng.integers(4, cfg.vocab_size,
                           int(rng.integers(3, 12))).tolist()
              for _ in range(N_OPTIONS)] for _ in range(RANK_TURNS)]
    cfg.use_pallas_attention = cfg.use_pallas_ffn = True
    out = {"chunk": graphs.CHUNK, "batches": len(hbs)}
    for dtype in ("bfloat16", "float32"):
        cfg.dtype = dtype
        model = load_model(cfg, sd, "cuda")
        dbs = [device_batch(hb, "cuda", dtype) for hb in hbs]
        out[dtype] = graph_equality(torch, ak, fk, model, dbs,
                                    device_batch(rank_hb, "cuda", dtype),
                                    cands)
        if dtype == "bfloat16":
            out.update(graph_timing(torch, ak, fk, graphs, model, dbs))
        del model, dbs
        torch.cuda.empty_cache()
    out["traffic"] = shape_traffic(torch, corpus, root)
    seen = out["profile"]["graphed_fixed"]["kernel_launches_seen"]
    out["kernels_in_replays"] = (isinstance(seen, dict)
                                 and min(seen.values()) > 0)
    profiled = [out["profile"]["eager"], out["profile"]["graphed_fixed"],
                out["sweep_eager"]]
    out["counts_match_profiler"] = all(p["counts_match"] for p in profiled)
    # a WHILE loop's launches (each pass's record times the passes) equal
    # the eager loop's, whose the profiler holds (k = 1: no masked step)
    # (the last run: the runs before it hold the shape's eager batch and
    # the capture's warm-up)
    out["loop_counts_equal_eager"] = all(
        row["launches_graphed"][-1] == row["launches_eager"]
        for dtype in ("bfloat16", "float32")
        for row in out[dtype].values() if isinstance(row, dict)) and (
        graphs.CHUNK != 1 or out["sweep"][0]["kernel_launches_counted"]
        == out["sweep_eager"]["kernel_launches_counted"])
    out["ok"] = bool(out["bfloat16"]["ok"] and out["float32"]["ok"]
                     and out["kernels_in_replays"]
                     and out["counts_match_profiler"]
                     and out["loop_counts_equal_eager"]
                     and out["traffic"]["bitwise"])
    return out


def graph_timing(torch, ak, fk, graphs, model, dbs) -> dict:
    """One warm beam batch eager and graphed under the profiler, the
    sweep of k over ``dbs`` and ``IN_FLIGHT`` batches in flight against
    one (see :func:`graphs_phase`)."""
    from mtn_tpu_torch.config import DecodeConfig
    from mtn_tpu_torch.decode.beam import BeamDecoder
    from mtn_tpu_torch.ops import _build
    out = {}
    # one warm batch: eager under the profiler, graphed timed with CUDA
    # events (the profiler must not run over a graph with conditional
    # nodes), and the fixed loop's graph (early stop off: no conditional
    # node) under the profiler, its kernels counted inside the launch
    # (the shape's first batch runs eagerly, its second captures)
    dec = BeamDecoder(model, DecodeConfig(**GRAPH_DECODE))
    twin = eager_twin(dec)
    fixed = BeamDecoder(model, DecodeConfig(early_stop=False,
                                            **GRAPH_DECODE))
    for d in (dec, dec, fixed, fixed):
        d.beam_batch_raw(dbs[0])
    torch.cuda.synchronize()
    out["profile"] = {
        "eager": profiled_batches(torch, ak, fk,
                                  lambda: twin.beam_batch_raw(dbs[0])),
        "graphed": event_batches(torch, ak, fk, dec, dbs[:1], fetch=False),
        "graphed_fixed": profiled_batches(
            torch, ak, fk, lambda: fixed.beam_batch_raw(dbs[0]))}
    del fixed
    # the sweep of k over both batches: wall per warm batch
    sweep, chunk = [], graphs.CHUNK
    try:
        for k in GRAPH_CHUNKS:
            dec.graphs = None
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            graphs.CHUNK = k
            dec.graphs = graphs.GraphRunner()
            dec.beam_batch_raw(dbs[0])          # the first batch: eager
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            allocated = torch.cuda.memory_allocated()
            with capture_seconds() as built:
                dec.beam_batch_raw(dbs[0])      # the second: captured
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            ps = next(iter(dec.graphs.sets.values()))
            row = dict(k=k, capture_s=built,
                       pool_bytes=torch.cuda.memory_reserved() - reserved,
                       live_bytes=torch.cuda.memory_allocated() - allocated)
            ps.reads = ps.replays = ps.launches = 0
            timed = event_batches(torch, ak, fk, dec, dbs, fetch=False)
            _build.settle()
            row.update(timed, wall_ms_per_batch=timed["wall_ms"] / len(dbs),
                       reads_per_batch=ps.reads / (2 * len(dbs)),
                       launches_per_batch=ps.launches / (2 * len(dbs)),
                       program_runs_per_batch=ps.replays / (2 * len(dbs)))
            sweep.append(row)
            del ps   # the next k's bytes count its set alone
    finally:
        graphs.CHUNK = chunk
    eager = profiled_batches(
        torch, ak, fk, lambda: [twin.beam_batch_raw(db) for db in dbs])
    eager["wall_ms_per_batch"] = eager["wall_ms"] / len(dbs)
    out["sweep"] = sweep
    out["sweep_eager"] = eager
    # IN_FLIGHT batches launched before the first is fetched, against
    # each fetched before the next is launched (the graphed sets of k =
    # graphs.CHUNK), in turns
    dec.graphs = graphs.GraphRunner()
    dec.beam_batch_raw(dbs[0])
    dec.beam_batch_raw(dbs[0])
    torch.cuda.synchronize()
    batches = [dbs[i % len(dbs)] for i in range(IN_FLIGHT)]
    runs = {IN_FLIGHT: [], 1: []}
    for depth in (IN_FLIGHT, 1, 1, IN_FLIGHT):
        runs[depth].append(event_batches(torch, ak, fk, dec, batches,
                                         depth=depth, rounds=1))
    out["in_flight"] = {str(depth): dict(
        wall_ms_per_batch=[r["wall_ms"] / IN_FLIGHT for r in rs],
        device_ms_per_batch=[r["device_ms"] / IN_FLIGHT for r in rs],
        idle_share=[r["idle_share"] for r in rs],
        graph_launches=[r["graph_launches"] for r in rs])
        for depth, rs in runs.items()}
    return out


def in_flight_main(torch, corpus: dict, root: str) -> dict:
    """The main path (``cli.generate`` at the flagship width, bf16 beam,
    both kernels) at 8 turns a batch, 8 batches of one shape, with
    ``MAX_IN_FLIGHT`` = ``IN_FLIGHT``, then 1, then ``IN_FLIGHT`` again:
    the result JSON and the n-best log (``--verbose 1``'s QS and HYP
    lines) identical, and each run's responses/sec after loading (the
    stats file: the shape's first batch, run eagerly, and the capture
    included)."""
    import logging
    from mtn_tpu_torch.cli import generate
    out, texts, logs = {}, [], []
    depth0 = generate.MAX_IN_FLIGHT

    class Keep(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith(("QS:", "HYP[")):
                logs[-1].append(msg)
    keep = Keep()
    logging.getLogger(generate.__name__).addHandler(keep)
    try:
        for i, depth in enumerate((IN_FLIGHT, 1, IN_FLIGHT)):
            generate.MAX_IN_FLIGHT = depth
            path = os.path.join(root, f"in_flight_{i}.json")
            stats_path = os.path.join(root, f"in_flight_{i}_stats.json")
            logs.append([])
            rc = generate.main(generate_argv(
                corpus, corpus["prefix"], path, *BEAM_FLAGS, "--turn-batch",
                "8", "--stats-output", stats_path, "--verbose", "1"))
            torch.cuda.synchronize()
            if rc != 0:
                raise AssertionError(f"generate (in flight {depth}) "
                                     f"exited {rc}")
            with open(path) as f:
                texts.append(f.read())
            with open(stats_path) as f:
                stats = json.load(f)
            out.setdefault(str(depth), []).append(dict(
                responses_per_sec=stats["responses_per_sec"],
                seconds=stats["seconds"], batches=stats["batches"]))
    finally:
        generate.MAX_IN_FLIGHT = depth0
        logging.getLogger(generate.__name__).removeHandler(keep)
    out["json_identical"] = texts[0] == texts[1] == texts[2]
    out["log_identical"] = bool(logs[0]) and logs[0] == logs[1] == logs[2]
    out["ok"] = out["json_identical"] and out["log_identical"]
    return out


def shape_traffic(torch, corpus: dict, root: str) -> dict:
    """``cli.generate --uniform-shapes 0 --turn-batch 8`` on the 64-turn
    set (each batch at its own lengths, rounded to their buckets), with
    the decoders' eager loops and then graphed: the JSON bitwise equal,
    responses/sec of each after loading (the stats file's decode
    seconds), and the graphed run's batches, distinct shapes, captures
    and eager batches."""
    from mtn_tpu_torch.cli import generate
    out = {}
    for mode in ("eager", "graphed"):
        path = os.path.join(root, f"traffic_{mode}.json")
        stats_path = os.path.join(root, f"traffic_{mode}_stats.json")
        argv = generate_argv(corpus, corpus["prefix"], path, *BEAM_FLAGS,
                             "--uniform-shapes", "0", "--turn-batch", "8",
                             "--stats-output", stats_path)
        with graph_runners() as runners, (
                eager_decoders() if mode == "eager"
                else contextlib.nullcontext()):
            rc = generate.main(argv)
            torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"generate ({mode}) exited {rc}")
        with open(stats_path) as f:
            stats = json.load(f)
        out[mode] = dict(responses_per_sec=stats["turns"] / stats["seconds"],
                         seconds=stats["seconds"], batches=stats["batches"],
                         runner=runner_counts(runners))
        out[mode + "_answers"] = answers_of(path)
    out["bitwise"] = out.pop("eager_answers") == out.pop("graphed_answers")
    return out


# -- sample, stream, rank, evaluate -------------------------------------------
SAMPLE_FLAGS = ("--temperature", "1", "--top-k", "50", "--top-p", "0.9")
BEAM_FLAGS = ("--decode-style", "beam_search", "--beam", "5", "--penalty",
              "1.0", "--nbest", "5")
N_OPTIONS = 100
RANK_TURNS = 2          # x 100 options = 200 rows, inside the FFN gate
RANK_REF_TOL = 1e-3     # card (kernels) vs CPU (plain), f32, per option
INT8_REF_TOL = 1e-3     # the same for the int8 model, f32 (as [reference])
DRAW_P_MIN = 1e-4       # chi-square p-value of the card's draws
METRIC_LINE = re.compile(r"^(Bleu_[1-4]|METEOR|ROUGE_L|CIDEr): ")


def generate_argv(corpus: dict, prefix: str, out: str, *extra):
    """``mtn_tpu_torch.cli.generate`` flags of the main path (the
    undisclosed test set, maxlen 30, 32 turns a batch, bf16, both
    kernels) on the checkpoint ``prefix``, then ``extra``."""
    return ["--model", prefix + "_best", "--test-path", corpus["fea_path"],
            "--test-set", corpus["test_set"], "--maxlen", "30",
            "--turn-batch", "32", "--undisclosed-only", "1", "--dtype",
            "bfloat16", "--device", "cuda", "--use-pallas-attention", "1",
            "--use-pallas-ffn", "1", "--output", out, *extra]


def kernel_ops() -> dict:
    """The hand-written kernels' wrapper modules, by kernel name."""
    from mtn_tpu_torch.ops import attention_kernel, ffn_kernel, norm_kernel
    return {"attention": attention_kernel, "ffn": ffn_kernel,
            "norm": norm_kernel}


def zero_launches() -> None:
    for m in kernel_ops().values():
        m.KERNEL.launches = 0


def launch_counts() -> dict:
    """Every hand-written kernel's launches since :func:`zero_launches`."""
    return {name: m.KERNEL.launches for name, m in kernel_ops().items()}


def norm_label(shapes) -> str:
    """A norm launch's rows and width, and whether it adds a delta."""
    *lead, D = shapes[0]
    return f"norm R{math.prod(lead)} D{D}" + (
        "" if shapes[1] is None else " add")


def all_launched(launches: dict, train: bool = False) -> bool:
    """Every hand-written kernel launched on a decode path; on a train
    path the attention and FFN kernels, and the norm kernel never (a
    train step's sublayers take the plain chain under autograd)."""
    if train:
        return launches["norm"] == 0 and launches["attention"] > 0 \
            and launches["ffn"] > 0
    return min(launches.values()) > 0


def on_model_shard(label: str) -> bool:
    """A launch label of a ``--mesh-model 2`` rank on its shard: the
    attention on 4 of 8 heads, the FFN on d_ff 1,024 with an f32 output;
    the norm on the whole residual stream, which every rank holds."""
    if label.startswith("attention"):
        return " H4 " in label
    if label.startswith("norm"):
        return label.split()[2] == f"D{FLAGSHIP['d_model']}"
    return " F1024" in label and "f32 out" in label


def run_path(torch, ak, fk, fn):
    """``fn()`` with every kernel's count set to 0 just before it; its
    result, the counts just after it, and the calls per kernel shape."""
    box = []
    zero_launches()
    seen = record_launches(ak, fk, lambda: box.append(fn()))
    torch.cuda.synchronize()
    launches = launch_counts()
    calls = {}
    for (name, *shapes), rec in seen.items():
        if name == "ffn":
            label = f"ffn N{shapes[0][0]}"
        elif name == "norm":
            label = norm_label(shapes)
        else:
            B, _, Lq, _ = shapes[0]
            label = f"attention B{B} Lq{Lq} Lk{shapes[1][2]}"
        calls[label] = calls.get(label, 0) + rec["calls"]
    return box[0], launches, calls


def answers_of(path: str):
    with open(path) as f:
        return [qa["answer"] for d in json.load(f)["dialogs"]
                for qa in d["dialog"]]


def draw_law(torch) -> dict:
    """32,000 draws on the card from one transformed row (V 20,
    temperature 0.8, top-k 12) through the sampler's own
    ``gumbel_argmax`` (its generator lives on the logits' device: a CPU
    generator cannot fill a CUDA tensor): the chi-square p-value against
    the row's softmax, and the draws of masked tokens (must be 0)."""
    import numpy as np
    from scipy.stats import chisquare
    from mtn_tpu_torch.config import DecodeConfig
    from mtn_tpu_torch.decode.beam import (NEG_INF, BeamDecoder, draw_seed,
                                           gumbel_argmax)
    V = 20
    rng = np.random.default_rng(4)
    logp = torch.log_softmax(torch.from_numpy(
        2.0 * rng.standard_normal((1, V))).float().cuda(), dim=-1)
    logits = BeamDecoder(None, DecodeConfig(
        temperature=0.8, top_k=12)).sample_transform(logp)[0]
    kept = (logits > NEG_INF / 2).cpu().numpy()
    probs = torch.softmax(logits.double(), dim=0).cpu().numpy()
    counts = np.zeros(V, np.int64)
    for pos in range(4):
        draws = gumbel_argmax(logits.expand(8000, V), draw_seed(1, 0, pos))
        if draws.device.type != "cuda":
            raise AssertionError("the draws left the card")
        counts += np.bincount(draws.cpu().numpy(), minlength=V)
    p_value = chisquare(counts[kept], probs[kept] * counts.sum()).pvalue
    return dict(draws=int(counts.sum()), kept=int(kept.sum()),
                p_value=float(p_value), p_min=DRAW_P_MIN,
                masked_draws=int(counts[~kept].sum()),
                ok=bool(p_value > DRAW_P_MIN and not counts[~kept].any()))


def sample_phase(torch, ak, fk, generate, corpus: dict, root: str) -> dict:
    """``cli.generate --decode-style sample`` (temperature 1, top-k 50,
    top-p 0.9) through both kernels, counted; the same run again (the
    result JSON must be bitwise equal); ``--temperature 0`` against
    greedy (bitwise equal); the draw law on the card."""
    prefix = corpus["prefix"]
    path = lambda name: os.path.join(root, name + ".json")
    stats_path = path("sample_stats")
    t0 = time.time()
    rc, launches, calls = run_path(torch, ak, fk, lambda: generate.main(
        generate_argv(corpus, prefix, path("sample"), "--decode-style",
                      "sample", *SAMPLE_FLAGS, "--stats-output",
                      stats_path)))
    wall = time.time() - t0
    rcs = [rc]
    rcs.append(generate.main(generate_argv(
        corpus, prefix, path("sample_again"), "--decode-style", "sample",
        *SAMPLE_FLAGS)))
    rcs.append(generate.main(generate_argv(
        corpus, prefix, path("sample_t0"), "--decode-style", "sample",
        "--temperature", "0")))
    rcs.append(generate.main(generate_argv(
        corpus, prefix, path("greedy"), "--decode-style", "greedy")))
    if any(rcs):
        raise AssertionError(f"sample: generate exit codes {rcs}")
    read = lambda name: open(path(name), "rb").read()
    answers = answers_of(path("sample"))
    with open(stats_path) as f:
        stats = json.load(f)
    return dict(
        launches=launches, calls_by_shape=calls, wall_s=wall,
        responses_per_sec=stats["responses_per_sec"],
        answers=len(answers), example=answers[0],
        filled=len(answers) == N_DIALOGS and "__UNDISCLOSED__" not in answers,
        same_seed_bitwise=read("sample") == read("sample_again"),
        temperature_0_equals_greedy=read("sample_t0") == read("greedy"),
        draw_law=draw_law(torch))


def assemble(stream, n_rows: int, eos: int):
    """Per-row tokens of a token stream, cut at each row's first <eos>;
    and the number of yields."""
    rows, done, steps = [[] for _ in range(n_rows)], [False] * n_rows, 0
    for tokens in stream:
        steps += 1
        for i, t in enumerate(tokens):
            if not done[i]:
                done[i] = int(t) == eos
                if not done[i]:
                    rows[i].append(int(t))
    return rows, steps


def flagship_batch(corpus: dict, rows: int):
    """The first (longest) batch of ``rows`` turns of the undisclosed test
    set at the main path's buckets, its plan, the dataset, the config and
    the checkpoint."""
    from mtn_tpu_torch.config import config_from_dict
    from mtn_tpu_torch.data.batching import make_batch, make_batch_indices
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.weights import load_checkpoint, load_conf
    vocab, conf = load_conf(corpus["prefix"])
    data = load(conf["data"]["fea_type"], corpus["fea_path"],
                corpus["test_set"], vocab, include_caption="caption,summary",
                separate_caption=True, undisclosed_only=True)
    plans, _ = make_batch_indices(data, rows, max_length=10 ** 9,
                                  separate_caption=True)
    hb = make_batch(data, plans[0], separate_caption=True, length_bucket=32,
                    feature_bucket=32, pad_rows_to=rows)
    return (hb, plans[0], data, config_from_dict("model", conf["model"]),
            load_checkpoint(corpus["prefix"])[0])


STREAM_CASES = (("greedy", 0), ("sample", 0), ("sample", 3))


def stream_sets(dec) -> dict:
    """``dec``'s stream program sets by style."""
    from mtn_tpu_torch.decode.graphs import StreamPrograms
    return {key[1]: ps for key, ps in dec.graphs.sets.items()
            if isinstance(ps, StreamPrograms)}


def stream_run(torch, ak, fk, dec, db, style: str, fold: int) -> dict:
    """One stream of ``db`` through ``dec`` (its yields, steps and host
    ms a step; its last step's read waits for the device), with the
    kernels' launches (their counts set to 0 just before it and read
    just after) and the program runs of its stream set over it."""
    before = {k: ps.replays for k, ps in stream_sets(dec).items()}
    zero_launches()
    t0 = time.perf_counter()
    ys = [y.tolist() for y in dec.stream_tokens(db, style, fold)]
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    runs = sum(ps.replays - before.get(k, 0)
               for k, ps in stream_sets(dec).items())
    return dict(yields=ys, steps=len(ys), host_ms_per_step=ms / len(ys),
                launches=launches, program_runs=runs)


def stream_phase(torch, ak, fk, corpus: dict) -> dict:
    """One flagship turn batch (32 turns, both kernels), in bf16 and f32:
    the greedy stream and the sample stream (folds 0 and 3) through the
    eager loop and through the captured stream programs (each style's
    first stream eager, its second captured, then warm), every graphed
    stream step for step the eager stream's and, reassembled, the batch
    decoders' (``greedy_batch``, ``sample_batch``) token for token; host
    ms a step of both, program runs (graph launches) a warm step, the
    sets' capture seconds and pool bytes; one warm graphed greedy stream
    under torch.profiler (device µs a step; the kernels' counts against
    the profiler's)."""
    from mtn_tpu_torch.config import DecodeConfig
    from mtn_tpu_torch.decode.beam import BeamDecoder
    from mtn_tpu_torch.train.batch import device_batch
    from mtn_tpu_torch.weights import load_model
    hb, _, _, cfg, sd = flagship_batch(corpus, 32)
    cfg.use_pallas_attention = cfg.use_pallas_ffn = True
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg.dtype = dtype
        db = device_batch(hb, "cuda", dtype)
        dec = BeamDecoder(load_model(cfg, sd, "cuda"), DecodeConfig(
            maxlen=30, decode_style="sample", temperature=1.0, top_k=50,
            top_p=0.9))
        twin = eager_twin(dec)
        n = int(db.valid.sum())
        sets = {}
        for style in ("greedy", "sample"):
            first = stream_run(torch, ak, fk, dec, db, style, 0)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            with capture_seconds() as built:
                captured = stream_run(torch, ak, fk, dec, db, style, 0)
            torch.cuda.empty_cache()
            sets[style] = dict(
                capture_s=built,
                pool_bytes=torch.cuda.memory_reserved() - reserved,
                first_equals_captured=first["yields"] == captured["yields"],
                first_program_runs=first["program_runs"])
        rows = {}
        for style, fold in STREAM_CASES:
            want = (dec.greedy_batch(db) if style == "greedy"
                    else dec.sample_batch(db, fold=fold))
            eager = stream_run(torch, ak, fk, twin, db, style, fold)
            graphed = stream_run(torch, ak, fk, dec, db, style, fold)
            got, steps = assemble(graphed["yields"], n, dec.eos)
            rows[f"{style}_fold{fold}"] = dict(
                equal=got == want, bitwise_eager=graphed["yields"]
                == eager["yields"], steps=steps, tokens=sum(map(len, got)),
                host_ms_per_step=graphed["host_ms_per_step"],
                eager_host_ms_per_step=eager["host_ms_per_step"],
                program_runs_per_step=(graphed["program_runs"] - 1) / steps,
                launches=graphed["launches"],
                eager_launches=eager["launches"])
        out[dtype] = dict(rows, sets=sets, runner=runner_counts(
            [dec.graphs]))
        if dtype == "bfloat16":
            prof = profiled_batches(torch, ak, fk, lambda: list(
                dec.stream_tokens(db, "greedy", 0)))
            steps = rows["greedy_fold0"]["steps"]
            busy = prof["device_busy_ms"]
            out["profile"] = dict(
                prof, steps=steps, host_ms_per_step=prof["wall_ms"] / steps,
                device_us_per_step=busy * 1e3 / steps
                if isinstance(busy, float) else busy)
        del dec, twin, db
        torch.cuda.empty_cache()
    cases = [out[d][c] for d in ("bfloat16", "float32")
             for c in (f"{s}_fold{f}" for s, f in STREAM_CASES)]
    out["ok"] = bool(
        all(c["equal"] and c["bitwise_eager"]
            and c["program_runs_per_step"] == 1.0
            and c["launches"] == c["eager_launches"] for c in cases)
        and all(v["first_equals_captured"] and v["first_program_runs"] == 0
                for d in ("bfloat16", "float32")
                for v in out[d]["sets"].values())
        and out["profile"]["counts_match"])
    return out


def rank_reference(torch, corpus: dict, cand_path: str) -> dict:
    """Rank scores of the first 2 turns' 100 options, f32, on the card
    (both kernels) and on the CPU (plain versions): max |Δ| per option."""
    from mtn_tpu_torch.cli.rank import _align_candidates
    from mtn_tpu_torch.config import DecodeConfig
    from mtn_tpu_torch.data.vocab import words2ids
    from mtn_tpu_torch.decode.beam import BeamDecoder
    from mtn_tpu_torch.train.batch import device_batch
    from mtn_tpu_torch.weights import load_model
    hb, plan, data, cfg, sd = flagship_batch(corpus, RANK_TURNS)
    cfg.use_pallas_attention = cfg.use_pallas_ffn = True
    with open(cand_path) as f:
        turn_cands = _align_candidates(data, json.load(f), True)
    cands = [[words2ids(o, data.vocab)[1:-1].tolist()
              for o in turn_cands[q]["answer_options"]] for q in plan.qa_ids]
    got = {}
    for dev in ("cuda", "cpu"):
        dec = BeamDecoder(load_model(cfg, sd, dev), DecodeConfig())
        got[dev] = torch.tensor(dec.rank_batch(device_batch(hb, dev), cands,
                                               cand_bucket=N_OPTIONS))
    card, cpu = got["cuda"], got["cpu"]
    if card.shape != (RANK_TURNS, N_OPTIONS) or \
            not torch.isfinite(card).all():
        raise AssertionError(f"rank reference: card scores of shape "
                             f"{tuple(card.shape)}, or not finite")
    return dict(max_abs_diff=(card - cpu).abs().max().item(),
                tol=RANK_REF_TOL, score_range=[card.min().item(),
                                               card.max().item()])


def rank_phase(torch, ak, fk, corpus: dict, root: str) -> dict:
    """Candidates built by ``scripts/make_rank_candidates.py`` (100
    options per last turn); ``cli.rank --turn-batch 2`` (bf16, both
    kernels: 200 rows a decode step), counted, with its decoder's
    batches, shapes and captures; its scores, ranks and the retrieval
    block; the same command with the decoders' eager loops (scores
    bitwise equal, options/sec); then the f32 card-vs-CPU reference."""
    from mtn_tpu_torch.cli import rank
    cand_path = os.path.join(root, "cands.json")
    subprocess.run([sys.executable, os.path.join(HERE, "scripts",
                                                 "make_rank_candidates.py"),
                    corpus["lbl_test_set"], cand_path, "--last",
                    "--num-options", str(N_OPTIONS), "--seed", "1"],
                   check=True, capture_output=True, text=True, timeout=120)
    out = os.path.join(root, "ranks.json")
    printed = io.StringIO()

    def run(path=out, sink=printed):
        with contextlib.redirect_stdout(sink):
            return rank.main([
                "--model", corpus["prefix"] + "_best", "--test-path",
                corpus["fea_path"], "--test-set", corpus["test_set"],
                "--candidates", cand_path, "--undisclosed-only", "1",
                "--turn-batch", str(RANK_TURNS), "--dtype", "bfloat16",
                "--device", "cuda", "--use-pallas-attention", "1",
                "--use-pallas-ffn", "1", "--output", path])
    t0 = time.time()
    with graph_runners() as runners:
        rc, launches, calls = run_path(torch, ak, fk, run)
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"rank exited {rc}")
    with open(out) as f:
        result = json.load(f)
    eager_out = os.path.join(root, "ranks_eager.json")
    t0 = time.time()
    with eager_decoders():
        rc = run(eager_out, io.StringIO())
        torch.cuda.synchronize()
    eager_wall = time.time() - t0
    with open(eager_out) as f:
        eager_result = json.load(f)
    turns = [t for d in result["dialogs"] for t in d["dialog"]]
    block = [line for line in printed.getvalue().splitlines()
             if line.split(":")[0] in ("r@1", "r@5", "r@10", "mean_rank",
                                        "mrr")]
    ok = (len(turns) == N_DIALOGS and len(block) == 5
          and all(len(t["scores"]) == N_OPTIONS and "gt_rank" in t
                  and all(math.isfinite(s) for s in t["scores"])
                  for t in turns))
    return dict(launches=launches, calls_by_shape=calls, wall_s=wall,
                turns=len(turns), options=N_OPTIONS,
                options_per_sec=len(turns) * N_OPTIONS / wall,
                runner=runner_counts(runners),
                eager_options_per_sec=len(turns) * N_OPTIONS / eager_wall,
                eager_bitwise=rc == 0 and eager_result == result,
                metrics=result.get("metrics"), block=block, ok=ok,
                reference=rank_reference(torch, corpus, cand_path))


def evaluate_phase(corpus: dict, result_path: str, root: str) -> dict:
    """run.sh stage 4 on the ``[main]`` result JSON against the labeled
    test set: ``python -m mtn_tpu_torch.cli.evaluate`` annotation,
    hypotheses and score, each its own process; the printed block."""
    ref, hyp, scores = (os.path.join(root, n) for n in
                        ("ref.json", "hyp.json", "scores.json"))

    def evaluate(*args):
        return subprocess.run(
            [sys.executable, "-m", "mtn_tpu_torch.cli.evaluate", *args],
            cwd=HERE, check=True, capture_output=True, text=True,
            timeout=300).stdout
    evaluate("annotation", "--last", corpus["lbl_test_set"], ref)
    evaluate("hypotheses", "--last", result_path, hyp)
    block = [line for line in evaluate("score", "--json", scores, ref,
                                       hyp).splitlines()
             if METRIC_LINE.match(line)]
    with open(ref) as f:
        n_refs = len(json.load(f)["annotations"])
    with open(scores) as f:
        return dict(block=block, scores=json.load(f), references=n_refs,
                    ok=len(block) == 7 and n_refs == N_DIALOGS)


# -- int8 and serving ---------------------------------------------------------
INT8_MODES = ("int8-fp-head", "int8")
SERVE_TURN_BATCH = 16   # x beam 5 = 80 rows a step, inside the FFN gate
SERVE_REQUESTS = 32
SERVE_THREADS = 8


def int8_weights(torch, corpus: dict) -> dict:
    """The flagship bf16 model with full-precision, int8-fp-head and int8
    weights on the card: ``quantized_size_bytes`` of each state_dict and
    the ``torch.cuda.memory_allocated`` the model holds; and, on one
    32-turn batch, three decode steps fed the bf16 model's argmax tokens:
    the share of rows whose argmax under int8 weights is the bf16 one."""
    from mtn_tpu_torch.train.batch import batch_masks, device_batch
    from mtn_tpu_torch.utils.quantize import (quantize_model,
                                              quantized_size_bytes)
    from mtn_tpu_torch.weights import load_model
    hb, _, _, cfg, sd = flagship_batch(corpus, 32)
    cfg.dtype = "bfloat16"
    cfg.use_pallas_attention = cfg.use_pallas_ffn = True
    db = device_batch(hb, "cuda", "bfloat16")
    B = db.query.shape[0]
    sizes, argmax, teacher = {}, {}, []
    for quant in ("",) + INT8_MODES:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        model = load_model(cfg, sd, "cuda")
        if quant:
            quantize_model(model, sd, skip_generator=quant == "int8-fp-head")
        torch.cuda.synchronize()
        name = quant or "bf16"
        sizes[name] = dict(memory_allocated=torch.cuda.memory_allocated()
                           - before, **quantized_size_bytes(
                               model.state_dict()))
        with torch.inference_mode():
            masks, _ = batch_masks(db, 1)
            state = model.init_decode_state(db.query, db.his, db.cap,
                                            db.fts, masks)
            kv = model.init_self_kv(B, 4, "cuda")
            tok = torch.full((B,), 2, dtype=torch.int64, device="cuda")
            out = []
            for pos in range(3):
                logp, kv = model.decode_step(state, tok, pos, kv)
                out.append(logp.argmax(dim=-1))
                if not quant:
                    teacher.append(out[-1])
                tok = teacher[pos]
        argmax[name] = torch.stack(out)
        del model, state, kv
        torch.cuda.empty_cache()
    return dict(weights=sizes, top1_agreement_with_bf16={
        q: (argmax[q] == argmax["bf16"]).float().mean().item()
        for q in INT8_MODES}, agreement_rows=3 * B)


def int8_phase(torch, ak, fk, generate, corpus: dict, root: str) -> dict:
    """``cli.generate --weights-quant`` int8-fp-head and int8 (bf16, both
    kernel flags, beam 5) on the 64-turn test set, each counted: every
    answer filled, attention launched and the FFN kernel never (JAX skips
    it for int8 weights); the f32 int8 model on the card against the CPU
    (both kernels vs plain versions); an int8-transfer batch on the card
    against the CPU's, bitwise; resident weight bytes and top-1 agreement
    (``int8_weights``)."""
    from mtn_tpu_torch.train.batch import device_batch
    out = {}
    for quant in INT8_MODES:
        path = os.path.join(root, f"result_{quant}.json")
        stats_path = os.path.join(root, f"stats_{quant}.json")
        t0 = time.time()
        rc, launches, calls = run_path(torch, ak, fk, lambda: generate.main(
            generate_argv(corpus, corpus["prefix"], path, *BEAM_FLAGS,
                          "--weights-quant", quant, "--stats-output",
                          stats_path)))
        wall = time.time() - t0
        if rc != 0:
            raise AssertionError(f"int8: generate {quant} exited {rc}")
        answers = answers_of(path)
        with open(stats_path) as f:
            stats = json.load(f)
        out[quant] = dict(
            launches=launches, calls_by_shape=calls, wall_s=wall,
            responses_per_sec=stats["responses_per_sec"],
            mean_exit_step=stats["mean_exit_step"], example=answers[0],
            filled=len(answers) == N_DIALOGS
            and "__UNDISCLOSED__" not in answers)
    out["reference"] = dict(
        max_abs_diff=reference_check(torch, corpus["prefix"],
                                     corpus["test_set"], corpus["fea_path"],
                                     weights_quant="int8"),
        tol=INT8_REF_TOL)
    hb = flagship_batch(corpus, 32)[0]
    card, cpu = (device_batch(hb, dev, "int8") for dev in ("cuda", "cpu"))
    out["transfer_bitwise"] = all(
        a.device.type == "cuda" and torch.equal(a.cpu(), b)
        for a, b in zip(card.fts, cpu.fts))
    out.update(int8_weights(torch, corpus))
    return out


def serve_bodies(corpus: dict, n: int):
    """/v1/respond bodies for the last turns of the first ``n`` test
    dialogs: question, history, caption and both feature streams as
    ``npy_b64`` (the compact form for I3D-size payloads)."""
    import base64

    import numpy as np
    with open(corpus["test_set"]) as f:
        dialogs = json.load(f)["dialogs"][:n]

    def b64(path):
        buf = io.BytesIO()
        np.save(buf, np.load(path))
        return {"npy_b64": base64.b64encode(buf.getvalue()).decode()}
    fea = corpus["fea_path"]
    return [{"question": d["dialog"][-1]["question"],
             "history": [[t["question"], t["answer"]]
                         for t in d["dialog"][:-1]],
             "caption": d["caption"],
             "features": {ft: b64(fea.replace("<FeaType>", ft).replace(
                 "<ImageID>", d["image_id"])) for ft in corpus["fea_types"]}}
            for d in dialogs]


def http(base: str, path: str, body=None, timeout: float = 300):
    """(status, parsed JSON or text) of one request to the server."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data, headers={"Content-Type": "application/json"},
        method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        text = r.read().decode()
        kind = r.headers["Content-Type"]
        return r.status, (json.loads(text) if kind == "application/json"
                          else text)


def serve_session(corpus: dict, quant: str = "", dtype: str = "bfloat16",
                  mesh=None, device: str = "cuda"):
    """The served beam session of the checkpoint (beam 5, maxlen 30, both
    kernels, ``turn_batch`` 16); ``mesh``: served by the mesh's ranks."""
    from mtn_tpu_torch.config import DecodeConfig
    from mtn_tpu_torch.serve import ServingSession
    return ServingSession.from_checkpoint(
        corpus["prefix"] + "_best", DecodeConfig(
            maxlen=30, beam=5, nbest=5, penalty=1.0,
            turn_batch=SERVE_TURN_BATCH),
        mesh=mesh, model_overrides={"dtype": dtype,
                                    "use_pallas_attention": True,
                                    "use_pallas_ffn": True},
        weights_quant=quant, device=device)


def rank_candidates(corpus: dict):
    """N_OPTIONS candidate answers of 3-11 random vocabulary words."""
    import numpy as np
    from mtn_tpu_torch.weights import load_conf
    vocab, _ = load_conf(corpus["prefix"])
    words = [w for w in vocab if w.startswith("w")]
    rng = np.random.default_rng(5)
    return [" ".join(rng.choice(words, int(rng.integers(3, 12))))
            for _ in range(N_OPTIONS)]


def concurrent_respond(base: str, bodies) -> dict:
    """The bodies as /v1/respond requests from SERVE_THREADS threads:
    how many were answered, the wall time and requests/sec."""
    import threading
    results = [None] * len(bodies)
    per = len(bodies) // SERVE_THREADS

    def caller(i):
        for j in range(i * per, (i + 1) * per):
            results[j] = http(base, "/v1/respond", bodies[j])
    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    return dict(requests=len(bodies), threads=SERVE_THREADS,
                answered=sum(r is not None and r[0] == 200
                             and isinstance(r[1]["answer"], str)
                             for r in results),
                wall_s=wall, requests_per_sec=len(bodies) / wall)


def async_in_flight(torch, session, bodies, rounds: int = 4) -> dict:
    """``AsyncServer`` over ``session`` with ``max_in_flight`` 2, 1, 1, 2:
    the bodies ``rounds`` times, all submitted at once, packed into
    batches of ``turn_batch`` (a long ``max_wait_ms`` makes the packing
    the same in every run), the answers of every run bitwise equal;
    requests/sec of each (submit to the last answer)."""
    from mtn_tpu_torch.serve import AsyncServer
    from mtn_tpu_torch.serve_http import parse_request
    reqs = [parse_request(dict(b, nbest=5)) for b in bodies] * rounds
    out, answers = {}, []
    for depth in (2, 1, 1, 2):
        server = AsyncServer(session, max_in_flight=depth,
                             max_wait_ms=1000.0)
        try:
            t0 = time.perf_counter()
            futs = [server.submit(r) for r in reqs]
            got = [f.result(600).nbest for f in futs]
            wall = time.perf_counter() - t0
        finally:
            server.stop()
        answers.append(got)
        out.setdefault(str(depth), []).append(dict(
            requests=len(reqs), batches=server.launches, wall_s=wall,
            requests_per_sec=len(reqs) / wall))
    out["bitwise"] = all(a == answers[0] for a in answers)
    return out


def serve_phase(torch, ak, fk, corpus: dict, quant: str = "") -> dict:
    """An in-process ``serve_http.start_server`` on 127.0.0.1:0 over a
    bf16 beam session (:func:`serve_session`: beam 5, maxlen 30, both
    kernels, ``turn_batch`` 16), warmed up (``quant``: its weights):
    /v1/respond against the
    session's own respond_batch of the same request, bitwise; 32 requests
    from 8 threads (requests/sec, /stats latency, batch launches, the
    decoder's batches, shapes, captures and eager batches; for bf16 the
    same load again through the eager loops and then graphed and warm,
    and :func:`async_in_flight`); /v1/rank with 100 candidates; a /v1/stream reassembled against the
    greedy decode of the same request; /admin/reload (the epoch, and the
    same answer after it); /metrics. Kernel launches are counted over the
    HTTP traffic alone: the counts are set to 0 before each request (or
    the 32 concurrent ones) and read after it."""
    from mtn_tpu_torch.serve import encode_requests
    from mtn_tpu_torch.serve_http import parse_request, start_server
    session = serve_session(corpus, quant=quant)
    warmup_s = session.warmup(stream=True)
    bodies = serve_bodies(corpus, SERVE_REQUESTS)
    launches, calls = {name: 0 for name in kernel_ops()}, {}

    def counted(fn, sink=None):
        result, n, by_shape = run_path(torch, ak, fk, fn)
        for name, count in n.items():
            launches[name] += count
        for label, count in by_shape.items():
            calls[label] = calls.get(label, 0) + count
        if sink is not None:
            sink.update(n)
        return result

    srv = start_server(session, port=0, max_wait_ms=20.0)
    base = "http://%s:%d" % srv.server_address
    out = dict(weights_quant=quant or None, warmup_s=warmup_s)
    try:
        one = dict(bodies[0], nbest=5)
        code, got = counted(lambda: http(base, "/v1/respond", one))
        want = session.respond_batch([parse_request(one)])[0]
        out["respond_equals_session"] = code == 200 and got == {
            "answer": want[0], "score": want[1], "nbest": [
                {"answer": a, "score": sc} for a, sc in want.nbest]}

        before = srv.async_server.launches
        runner = session.decoder.graphs
        start = runner_counts([runner])
        load = counted(lambda: concurrent_respond(base, bodies))
        stats = http(base, "/stats")[1]
        end = runner_counts([runner])
        out.update(load, batch_launches=srv.async_server.launches - before,
                   stats_latency=stats["latency"],
                   runner_in_load={k: end[k] - start[k] for k in end})
        if not quant:
            # the same load through the decoder's eager loops, then
            # graphed again with the sets the first load built
            session.decoder.graphed = lambda t: False
            try:
                out["eager_load"] = concurrent_respond(base, bodies)
            finally:
                del session.decoder.graphed
            out["warm_load"] = concurrent_respond(base, bodies)
            out["async_in_flight"] = async_in_flight(torch, session, bodies)

        code, ranked = counted(lambda: http(base, "/v1/rank", dict(
            bodies[1], candidates=rank_candidates(corpus))))
        logps = [c["logp"] for c in ranked["candidates"]]
        ranks = sorted(c["rank"] for c in ranked["candidates"])
        out["rank"] = dict(
            candidates=len(logps), logp_range=[min(logps), max(logps)],
            ok=code == 200 and len(logps) == N_OPTIONS
            and all(math.isfinite(x) for x in logps)
            and 1 <= ranks[0] and ranks[-1] <= N_OPTIONS)

        tokens = counted(lambda: stream_words(base, bodies[2]))
        db = session.to_device(encode_requests(
            [parse_request(bodies[2])], session.model_cfg, session.data_cfg,
            session.vocab, session._lb, session._fb,
            pad_rows_to=SERVE_TURN_BATCH))
        greedy = [session.vlist[t]
                  for t in session.decoder.greedy_batch(db)[0]]
        out["stream"] = dict(tokens=len(tokens or []),
                             equals_greedy=tokens == greedy)
        out["stream"].update(served_streams(
            torch, ak, fk, session, base, bodies, tokens, counted,
            in_flight=not quant))

        code, reloaded = http(base, "/admin/reload", {})
        code2, again = counted(lambda: http(base, "/v1/respond", one))
        out["reload"] = dict(response=reloaded, same_answer=(
            code == 200 and reloaded == {"ok": True, "epoch": 1}
            and code2 == 200 and again == got))
        metrics = http(base, "/metrics")[1]
        out["metrics_lines"] = len(metrics.splitlines())
    finally:
        srv.close()
    out["launches"], out["calls_by_shape"] = launches, calls
    out["ok"] = bool(
        out["respond_equals_session"] and out["answered"] == SERVE_REQUESTS
        and out["batch_launches"] < SERVE_REQUESTS and out["rank"]["ok"]
        and out["stream"]["equals_greedy"] and out["stream"]["ok"]
        and out["reload"]["same_answer"]
        and "mtn_requests_total" in metrics
        and (quant or out["async_in_flight"]["bitwise"]))
    del session, srv
    torch.cuda.empty_cache()
    return out


def timed_stream(base: str, body) -> tuple:
    """A /v1/stream's words and its host ms a decode step (the words and
    the step that emitted <eos>, or maxlen 30)."""
    t0 = time.perf_counter()
    words = stream_words(base, body)
    ms = (time.perf_counter() - t0) * 1e3
    return words, ms / min(len(words or []) + 1, 30)


def served_streams(torch, ak, fk, session, base, bodies, first, counted,
                   in_flight: bool) -> dict:
    """The [serve] phase's /v1/stream of ``bodies[2]`` after its first
    (eager) one, whose words are ``first``: again, captured into its
    stream set, then warm on it (its launches counted), then through the
    decoder's eager loop, every answer ``first``; with ``in_flight``,
    once more while the 32-request load keeps ``AsyncServer`` batches in
    flight (its answers counted). Host ms a step of each; the stream
    sets' capture seconds and program runs a warm step."""
    import threading
    from mtn_tpu_torch.decode.graphs import StreamPrograms
    dec = session.decoder
    with capture_seconds() as built:
        captured, _ = timed_stream(base, bodies[2])  # the shape's second
    sets = [ps for ps in dec.graphs.sets.values()
            if isinstance(ps, StreamPrograms)]
    runs = sum(ps.replays for ps in sets)
    box = {}
    graphed, ms = counted(lambda: timed_stream(base, bodies[2]), box)
    runs = sum(ps.replays for ps in sets) - runs
    dec.graphed = lambda t: False
    try:
        eager, eager_ms = timed_stream(base, bodies[2])
    finally:
        del dec.graphed
    steps = min(len(graphed or []) + 1, 30)
    out = dict(graphed_equals_eager=first is not None and
               captured == graphed == eager == first,
               host_ms_per_step=ms, eager_host_ms_per_step=eager_ms,
               program_runs_per_step=(runs - 1) / steps, launches=box,
               capture_s=built)
    ok = out["graphed_equals_eager"] and out["program_runs_per_step"] == 1
    if in_flight:
        load = {}
        thread = threading.Thread(target=lambda: load.update(
            concurrent_respond(base, bodies)))
        thread.start()
        time.sleep(0.05)
        words, flight_ms = timed_stream(base, bodies[2])
        thread.join(600)
        out["in_flight"] = dict(
            host_ms_per_step=flight_ms, equals=words == first,
            load_answered=load.get("answered"),
            load_requests_per_sec=load.get("requests_per_sec"))
        ok = ok and words == first and load.get("answered") == \
            SERVE_REQUESTS
    out["ok"] = bool(ok)
    return out


# -- [serve-parallel]: serving under a mesh of lockstep ranks ---------------
SERVE_PAR_WARMUP_COMMANDS = 2   # warmup(stream=True): a decode and a stream
SERVE_PAR_LOAD = 8              # requests from the 8 threads, under a mesh
SERVE_PAR_F32_REQUESTS = 16     # the f32 session's n-bests (one batch)


def serve_batches(base: str, bodies) -> list:
    """The bodies as /v1/respond_batch calls of SERVE_TURN_BATCH requests
    (each one AsyncServer launch): [[answers], [scores]] per request."""
    out = []
    for lo in range(0, len(bodies), SERVE_TURN_BATCH):
        code, body = http(base, "/v1/respond_batch", {
            "requests": bodies[lo:lo + SERVE_TURN_BATCH], "nbest": 5})
        if code != 200:
            raise AssertionError(f"respond_batch answered {code}: {body}")
        out += [[[h["answer"] for h in r["nbest"]],
                 [h["score"] for h in r["nbest"]]] for r in body["results"]]
    return out


def stream_words(base: str, body) -> list:
    """A /v1/stream's words; None unless it ended with its answer."""
    text = http(base, "/v1/stream", body)[1]
    events = [json.loads(line[len("data: "):])
              for line in text.splitlines() if line.startswith("data: ")]
    words = [e["token"] for e in events if "token" in e]
    done = events and events[-1].get("done") is True and \
        events[-1]["answer"] == " ".join(words)
    return words if done else None


def device_split(torch, fn) -> dict:
    """``fn()`` under torch.profiler: its wall ms and this process's
    device busy ms (kernel time summed) and idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    groups, launches, _ = device_groups(torch, prof)
    busy = sum(groups.values())
    return dict(wall_ms=wall, device_busy_ms=busy if launches else
                "not measured", device_launches=launches,
                idle_share=1 - busy / wall if launches else "not measured")


def serve_one_process(torch, corpus: dict, bodies, dtype: str) -> dict:
    """What one process's session answers to the served mesh's traffic,
    batched as the server batches it, through the eager loops: the two
    16-request batches (their host/device split under the profiler,
    bf16), and in bf16 the rank request (through AsyncServer, 16 rows)
    and the greedy stream."""
    from mtn_tpu_torch.serve import AsyncServer
    from mtn_tpu_torch.serve_http import parse_request
    session = serve_session(corpus, dtype=dtype)
    # the eager loops, as the mesh's ranks run them: the profiler must
    # not run over a graph with conditional nodes
    session.decoder.graphed = lambda t: False
    session.warmup()
    reqs = [parse_request(b) for b in bodies]
    out = {}
    out["split"] = device_split(torch, lambda: out.update(
        nbest=session_nbests(session, corpus, SERVE_REQUESTS if dtype ==
                             "bfloat16" else SERVE_PAR_F32_REQUESTS)))
    if dtype == "bfloat16":
        srv = AsyncServer(session, max_wait_ms=1.0)
        try:
            out["rank"] = [sc for _, sc, _ in srv.submit_rank(
                reqs[1], rank_candidates(corpus)).result(300)]
        finally:
            srv.stop()
        out["stream"] = list(session.stream(reqs[2]))
    del session
    torch.cuda.empty_cache()
    return out


def serve_leader(torch, ak, fk, session, corpus: dict) -> dict:
    """Rank 0: ``serve_http.start_server`` over the mesh's session and the
    traffic through it: the 32 requests as two 16-request batches (their
    host/device split), 8 of them again from 8 threads (requests/sec), one
    /v1/rank with 100 candidates, one greedy /v1/stream, one
    /admin/reload of the served checkpoint; launches counted over the
    traffic alone."""
    from mtn_tpu_torch.serve_http import start_server
    bodies = serve_bodies(corpus, SERVE_REQUESTS)
    srv = start_server(session, port=0, max_wait_ms=20.0)
    base = "http://%s:%d" % srv.server_address
    out = {}

    def traffic():
        out["split"] = device_split(torch, lambda: out.update(
            nbest=serve_batches(base, bodies)))
        out["load"] = concurrent_respond(base, bodies[:SERVE_PAR_LOAD])
        code, ranked = http(base, "/v1/rank", dict(
            bodies[1], candidates=rank_candidates(corpus)))
        out["rank"] = [c["logp"] for c in ranked["candidates"]] \
            if code == 200 else None
        out["stream"] = stream_words(base, bodies[2])
        out["reload"] = http(base, "/admin/reload", {})
    try:
        _, out["count"] = counted_run(torch, ak, fk, traffic)
        out["stats"] = http(base, "/stats")[1]
        out["healthz"] = http(base, "/healthz")[1]
    finally:
        srv.close()
    return out


def serve_follower(torch, ak, fk, session) -> dict:
    """A follower's loop, its launches counted from the first command
    after rank 0's warmup, and the host/device split of its part of the
    two 16-request batches (the next two commands; none where only one
    came)."""
    from torch.profiler import ProfilerActivity, profile
    orig, n, out = session._run, [0], {}
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])

    def run(op, args, sink=None):
        if n[0] == SERVE_PAR_WARMUP_COMMANDS:
            torch.cuda.synchronize()
            zero_launches()
            out["t0"] = time.perf_counter()
            prof.start()
        result = orig(op, args, sink)
        n[0] += 1
        if n[0] == SERVE_PAR_WARMUP_COMMANDS + 2:
            torch.cuda.synchronize()
            prof.stop()
            wall = (time.perf_counter() - out.pop("t0")) * 1e3
            groups, launches, _ = device_groups(torch, prof)
            busy = sum(groups.values())
            out["split"] = dict(
                wall_ms=wall, device_busy_ms=busy if launches else
                "not measured", device_launches=launches,
                idle_share=1 - busy / wall if launches else "not measured")
        return result
    session._run = run
    seen = record_launches(ak, fk, lambda: out.update(
        commands=session.follow()))
    if "t0" in out:   # one batch after the warmup (the f32 session's)
        prof.stop()
        del out["t0"]
    torch.cuda.synchronize()
    out["count"] = dict(launches=launch_counts(),
                        shapes=launch_shapes(seen))
    return out


def serve_rank(rank: int, world: int, port: int, mesh: str, corpus: dict,
               out_dir: str, device: str = "cuda") -> None:
    """One rank of a served ``mesh`` on cuda:0 over gloo: the bf16
    session (rank 0 warms it up and leads the traffic, the other rank
    follows until ``stop``); under a model axis then an f32 session whose
    rank 0 answers the two 16-request batches. Writes what it saw."""
    import torch
    from mtn_tpu_torch.ops import attention_kernel as ak
    from mtn_tpu_torch.ops import ffn_kernel as fk
    from mtn_tpu_torch.parallel import make_mesh, multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = multihost.initialize(f"localhost:{port}", world, rank,
                               device=device, backend="gloo")
    data, model = (int(v) for v in mesh.split("x"))
    grid = make_mesh(data=data, model=model, device_type=dev.type)
    res = dict(rank=rank, device=str(dev))
    for dtype in ("bfloat16", "float32") if model > 1 else ("bfloat16",):
        session = serve_session(corpus, dtype=dtype, mesh=grid,
                                device=str(dev))
        t0 = time.time()
        if rank == 0:
            session.warmup(stream=True)
            if dtype == "bfloat16":
                part = serve_leader(torch, ak, fk, session, corpus)
            else:
                part = dict(nbest=session_nbests(session, corpus,
                                                 SERVE_PAR_F32_REQUESTS))
            session.close()
        else:
            part = serve_follower(torch, ak, fk, session)
        part["seconds"] = time.time() - t0
        res[dtype] = part
        del session
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"serve_{mesh}_r{rank}.json"),
              "w") as f:
        json.dump(res, f)
    multihost.shutdown()


def session_nbests(session, corpus: dict,
                   requests: int = SERVE_REQUESTS) -> list:
    """The first ``requests`` of the 32 requests as respond_batch calls
    of the session, 16 a call: [[answers], [scores]] per request."""
    from mtn_tpu_torch.serve_http import parse_request
    reqs = [parse_request(b) for b in serve_bodies(corpus, requests)]
    return [[[a for a, _ in r.nbest], [sc for _, sc in r.nbest]]
            for lo in range(0, len(reqs), SERVE_TURN_BATCH)
            for r in session.respond_batch(reqs[lo:lo + SERVE_TURN_BATCH])]


def serve_parallel_phase(torch, corpus: dict, root: str,
                         serve_rps: float) -> dict:
    """Serving under a mesh: two ranks on cuda:0 over gloo as 2x1 and
    1x2, each rank a process (spawned as ``[parallel]``'s), rank 0
    serving HTTP and rank 1 following it, against one process's session
    on the same traffic. 2x1: the n-bests and the stream bitwise one
    process's. 1x2 (bf16 beams part at near ties, as ``[parallel]``'s
    traces show): the bf16 n-bests reported margin-aware, an f32
    session's held to one process's margin-aware with scores within
    PAR_F32_TOL. Both ranks exit 0 and launch both kernels at their shard
    shapes."""
    bodies = serve_bodies(corpus, SERVE_REQUESTS)
    single = {d: serve_one_process(torch, corpus, bodies, d)
              for d in ("bfloat16", "float32")}
    res = {"single": dict(split=single["bfloat16"]["split"],
                          requests_per_sec_serve=serve_rps)}
    ok = True
    for mesh in ("2x1", "1x2"):
        t0 = time.time()
        ranks = spawn_ranks(mesh, corpus, root, f32=False,
                            target=serve_rank, prefix="serve")
        lead, follow = ranks[0]["bfloat16"], ranks[1]["bfloat16"]
        want = single["bfloat16"]
        row = dict(
            seconds=time.time() - t0,
            nbest=compare_nbest(lead["nbest"], want["nbest"],
                                PAR_MARGIN["bfloat16"]),
            stream_equal=lead["stream"] is not None
            and lead["stream"] == want["stream"],
            rank_max_abs_diff=max(abs(a - b) for a, b in zip(
                lead["rank"], want["rank"])) if lead["rank"] else None,
            reload=lead["reload"], answered=lead["load"]["answered"],
            requests_per_sec=lead["load"]["requests_per_sec"],
            split=[lead["split"], follow["split"]],
            commands=[lead["stats"]["commands"], follow["commands"]],
            healthz=lead["healthz"],
            launches=[lead["count"]["launches"],
                      follow["count"]["launches"]],
            shapes=[lead["count"]["shapes"], follow["count"]["shapes"]])
        row["exitcodes"] = [r["exitcode"] for r in ranks]
        good = row["answered"] == SERVE_PAR_LOAD and \
            row["reload"] == [200, {"ok": True, "epoch": 1}] and \
            row["commands"][0] == row["commands"][1] and \
            row["rank_max_abs_diff"] is not None and \
            math.isfinite(row["rank_max_abs_diff"]) and \
            row["exitcodes"] == [0, 0] and \
            all(min(n.values()) > 0 for n in row["launches"])
        if mesh == "2x1":
            good &= row["nbest"]["bitwise"] and row["stream_equal"]
        else:
            f32 = compare_nbest(ranks[0]["float32"]["nbest"],
                                single["float32"]["nbest"],
                                PAR_MARGIN["float32"])
            row["nbest_f32"] = f32
            good &= f32["ok"] and f32["max_score_diff"] <= PAR_F32_TOL
            row["shard_shapes_only"] = all(
                on_model_shard(k) for shapes in row["shapes"] for k in shapes)
            good &= row["shard_shapes_only"]
        row["ok"] = bool(good)
        res[mesh] = row
        ok &= row["ok"]
    res["ok"] = bool(ok)
    return res


# -- the AOT artifact ---------------------------------------------------------
AOT_BATCHES = [1, SERVE_TURN_BATCH]
AOT_RANK = (N_OPTIONS, 24)
AOT_REF_TOL = 1e-3       # f32 artifact, card (kernels) vs CPU (plain)
AOT_INT8_BLOCKS = 1


def aot_decode_cfg(turn_batch: int):
    from mtn_tpu_torch.config import DecodeConfig
    return DecodeConfig(maxlen=30, beam=5, nbest=5, penalty=1.0,
                        turn_batch=turn_batch)


def aot_lengths(reqs, session) -> dict:
    """The frozen token lengths of the artifact: the longest query,
    history and caption of ``reqs``, rounded up to 32; the corpus's
    frame buckets."""
    from mtn_tpu_torch.serve import encode_requests
    hb = encode_requests(reqs, session.model_cfg, session.data_cfg,
                         session.vocab)
    up = lambda n: -(-n // 32) * 32
    return dict(query_len=up(hb.query.shape[1]), his_len=up(hb.his.shape[1]),
                cap_len=up(hb.cap.shape[1]),
                frames=[hi for _, hi in FRAMES])


def aot_fitted(session, live, reqs, rows: int):
    """The live session's device batch of ``reqs`` at the artifact's
    frozen shapes (the artifact's own fit laws)."""
    import dataclasses
    from mtn_tpu_torch.serve import encode_requests
    hb = encode_requests(reqs, live.model_cfg, live.data_cfg, live.vocab,
                         pad_rows_to=rows)
    m = session.meta
    fit = [session._fit_features(f, n, T)
           for f, n, T in zip(hb.fts, hb.fts_len, m["frames"])]
    return live.to_device(dataclasses.replace(
        hb, query=session._fit_tokens(hb.query, m["query_len"], "query"),
        his=session._fit_tokens(hb.his, m["his_len"], "his"),
        cap=session._fit_tokens(hb.cap, m["cap_len"], "cap"),
        fts=[f for f, _ in fit], fts_len=[n for _, n in fit]))


def aot_live_nbest(live, dbs, eager: bool = False):
    """The live decoder's n-best texts and its decode steps over ``dbs``;
    ``eager``: through its eager loop, which steps as the artifact's
    session does (one program call a step), not its captured programs."""
    out, steps = [], 0
    for db in dbs:
        raw = (live.decoder.beam_eager(db) if eager
               else live.decoder.beam_batch_raw(db))
        out += [r.texts(live.vlist)
                for r in live.decoder.beam_results(raw, db.valid)]
        steps += raw.n_steps
    return out, steps


def aot_export(torch, corpus, art, lengths, decode_cfg, **kw) -> tuple:
    """``export_decode`` of the corpus checkpoint (``kw`` over it); the
    meta and the seconds it took."""
    from mtn_tpu_torch.utils.aot import export_decode
    t0 = time.perf_counter()
    meta = export_decode(kw.pop("model_arg", corpus["prefix"] + "_best"),
                         art, decode_cfg=decode_cfg, **lengths, **kw)
    return meta, time.perf_counter() - t0


def aot_load(torch, art: str, device: str = "cuda"):
    """An AotSession with every program loaded; (session, seconds, the
    device bytes its weights hold)."""
    from mtn_tpu_torch.utils.aot import AotSession
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    session = AotSession(art, device=device)
    for name in session.meta["blobs"]:
        if name.endswith(".pt2"):
            session._program(name)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return session, seconds, torch.cuda.memory_allocated() - before


def aot_reference(torch, corpus, root, reqs, lengths) -> dict:
    """The flagship f32 artifact (both kernel flags) exported for the card
    and for the CPU, two turns each: the max |Δ| of the prefix program's
    state (every cross-attention K/V: the attention kernel's output) and
    of the n-best scores."""
    from mtn_tpu_torch.utils.aot import AotSession
    nbest, state = {}, {}
    for dev in ("cuda", "cpu"):
        art = os.path.join(root, f"aot_f32_{dev}")
        aot_export(torch, corpus, art, lengths, aot_decode_cfg(2), batch=2,
                   device=dev, stream=False, model_overrides={
                       "dtype": "float32", "use_pallas_attention": True,
                       "use_pallas_ffn": True})
        session = AotSession(art, device=dev)
        nbest[dev] = [r.nbest for r in session.respond_batch(reqs[:2])]
        with torch.inference_mode():
            state[dev] = [t.cpu() for t in session._state(
                2, session._inputs(reqs[:2], 2)[1]) if t.is_floating_point()]
    diff = max(abs(a[1] - b[1]) for g, w in zip(nbest["cuda"], nbest["cpu"])
               for a, b in zip(g, w))
    state_diff = max((a - b).abs().max().item()
                     for a, b in zip(state["cuda"], state["cpu"]))
    scores = [s for nb in nbest["cuda"] for _, s in nb]
    finite = all(math.isfinite(x) for x in scores) and all(
        torch.isfinite(t).all() for t in state["cuda"])
    return dict(max_abs_diff=diff, state_max_abs_diff=state_diff,
                state_values=sum(t.numel() for t in state["cuda"]),
                tol=AOT_REF_TOL, turns=2,
                same_answers=sum(g[0][0] == w[0][0] for g, w in
                                 zip(nbest["cuda"], nbest["cpu"])),
                finite=finite, ok=bool(diff <= AOT_REF_TOL and state_diff
                                       <= AOT_REF_TOL and finite))


def aot_int8(torch, ak, fk, corpus, root, reqs, lengths) -> dict:
    """An int8-fp-head artifact of the corpus weights cut to
    ``AOT_INT8_BLOCKS`` blocks (bf16, both kernel flags): 16 turns
    against the live int8-fp-head session at the frozen shapes, bitwise;
    launches of both (attention, never the FFN kernel)."""
    from mtn_tpu_torch.serve import ServingSession
    from mtn_tpu_torch.weights import (load_checkpoint, load_conf,
                                       save_checkpoint, save_conf)
    vocab, conf = load_conf(corpus["prefix"])
    conf["model"]["nb_blocks"] = AOT_INT8_BLOCKS
    prefix = os.path.join(root, "aot_int8_ckpt", "mtn")
    os.makedirs(os.path.dirname(prefix))
    save_conf(prefix, vocab, **conf)
    keep = tuple(f"decoder.layer_{i}." for i in range(AOT_INT8_BLOCKS))
    sd = {k: v for k, v in load_checkpoint(corpus["prefix"])[0].items()
          if not k.startswith("decoder.layer_") or k.startswith(keep)}
    save_checkpoint(prefix, 1, sd)
    overrides = {"dtype": "bfloat16", "use_pallas_attention": True,
                 "use_pallas_ffn": True}
    dcfg = aot_decode_cfg(SERVE_TURN_BATCH)
    art = os.path.join(root, "aot_int8")
    meta, export_s = aot_export(
        torch, corpus, art, lengths, dcfg, model_arg=prefix + "_best",
        batch=SERVE_TURN_BATCH, stream=False, weights_quant="int8-fp-head",
        model_overrides=overrides)
    session, load_s, resident = aot_load(torch, art)
    session.build_programs()
    live = ServingSession.from_checkpoint(
        prefix + "_best", dcfg, model_overrides=overrides,
        weights_quant="int8-fp-head", device="cuda")
    chunk = reqs[:SERVE_TURN_BATCH]
    got, aot_launches, _ = run_path(torch, ak, fk,
                                    lambda: session.respond_batch(chunk))
    db = aot_fitted(session, live, chunk, SERVE_TURN_BATCH)
    (want, _), live_launches, _ = run_path(
        torch, ak, fk, lambda: aot_live_nbest(live, [db], eager=True))
    out = dict(blocks=AOT_INT8_BLOCKS, weights_quant="int8-fp-head",
               export_s=export_s, bytes=meta["blob_bytes"], load_s=load_s,
               resident_bytes=resident, launches=aot_launches,
               live_launches=live_launches,
               bitwise_live=[r.nbest for r in got] == want)
    out["ok"] = bool(out["bitwise_live"] and aot_launches == live_launches
                     and aot_launches["attention"] > 0
                     and aot_launches["ffn"] == 0)
    del session, live
    torch.cuda.empty_cache()
    return out


def aot_stream(torch, ak, fk, session, live, req) -> dict:
    """The artifact's greedy stream of ``req`` on its stream set (built at
    ``warmup``), its launches counted, against the live decoder's stream
    of the same request at the artifact's frozen shapes (one row): the
    eager loop, then three graphed streams (the shape's first eager, its
    second captured, its third warm); the same words from each, host ms
    a step of each, the artifact's program runs a step."""
    import contextlib as cl
    db = aot_fitted(session, live, [req], 1)
    eos = live.vocab["<eos>"]

    def live_words(dec):
        words, t0 = [], time.perf_counter()
        with cl.closing(dec.stream_tokens(db, "greedy")) as steps:
            for y in steps:
                if int(y[0]) == eos:
                    break
                words.append(live.vlist[int(y[0])])
        return words, (time.perf_counter() - t0) * 1e3
    ps = session.sets[("stream_greedy", 1)]
    runs = ps.replays
    zero_launches()
    t0 = time.perf_counter()
    got = list(session.stream(req))
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    runs = ps.replays - runs
    eager, eager_ms = live_words(eager_twin(live.decoder))
    graphed = [live_words(live.decoder) for _ in range(3)]
    steps = min(len(got) + 1, session.meta["stream"]["maxlen"])
    out = dict(words=len(got), steps=steps, host_ms_per_step=ms / steps,
               live_eager_host_ms_per_step=eager_ms / steps,
               live_graphed_host_ms_per_step=graphed[-1][1] / steps,
               equals_live=all(w == got for w, _ in graphed + [(eager, 0)]),
               program_runs_per_step=(runs - 1) / steps, launches=launches)
    out["ok"] = bool(out["equals_live"] and out["program_runs_per_step"]
                     == 1 and min(launches.values()) > 0)
    return out


def op_dispatch(torch, ak, fk) -> dict:
    """Host-inclusive ms per call (200 calls, CUDA events) of each kernel
    through its ``torch.library`` op (``ak.attention``, ``fk.ffn``) and
    through its wrapper's direct launch, at the serving shapes (bf16,
    attention B16 H8 Lq32 Lk32, FFN N80)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=g)
    q, k, v = (torch.randn(16, 8, 32, 64, **bf) for _ in range(3))
    mask = torch.ones(16, 1, 32, dtype=torch.bool, device="cuda")
    x = torch.randn(80, 512, **bf)
    w = [torch.randn(*s, **bf) * 0.02 for s in ((512, 2048), (2048,),
                                                (2048, 512), (512,))]
    return {"attention_op_ms": time_ms(lambda: ak.attention(q, k, v, mask)),
            "attention_launch_ms": time_ms(lambda: ak.launch(q, k, v, mask)),
            "ffn_op_ms": time_ms(lambda: fk.ffn(x, *w)),
            "ffn_launch_ms": time_ms(lambda: fk.launch(x, *w))}


def aot_phase(torch, ak, fk, corpus: dict, root: str) -> dict:
    """``mtn_tpu_torch.utils.aot``: the flagship bf16 beam artifact (both
    kernels, row buckets 1 and 16, rank 100 × 24, the stream programs)
    exported and loaded, its program sets built at ``warmup``; the
    [serve] phase's 32 requests decoded through it against a live
    session at the same frozen shapes (16-row chunks, bitwise, the same
    launches per kernel, one graph launch a chunk), with host ms per
    chunk and per decode step of both; then served by an in-process ``serve_http`` over the
    artifact from 8 threads (each answer bitwise the live session's on
    its 1-row batch; launches, requests/sec, latency), /v1/rank,
    /v1/stream and /stats; the f32 artifact card vs CPU; an int8-fp-head
    artifact at 2 blocks."""
    import threading

    from mtn_tpu_torch.ops import graph_loop
    from mtn_tpu_torch.serve import ServingSession
    from mtn_tpu_torch.serve_http import parse_request, start_server
    overrides = {"dtype": "bfloat16", "use_pallas_attention": True,
                 "use_pallas_ffn": True}
    dcfg = aot_decode_cfg(SERVE_TURN_BATCH)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    live = ServingSession.from_checkpoint(
        corpus["prefix"] + "_best", dcfg, model_overrides=overrides,
        device="cuda")
    torch.cuda.synchronize()
    live_resident = torch.cuda.memory_allocated() - before
    bodies = serve_bodies(corpus, SERVE_REQUESTS)
    reqs = [parse_request(b) for b in bodies]
    lengths = aot_lengths(reqs, live)
    art = os.path.join(root, "aot")
    meta, export_s = aot_export(
        torch, corpus, art, lengths, dcfg, batches=AOT_BATCHES,
        rank=AOT_RANK, stream=True, device="cuda",
        model_overrides=overrides)
    session, load_s, resident = aot_load(torch, art)
    warmup_s = session.warmup(stream=True)
    out = dict(lengths=lengths, buckets=AOT_BATCHES, rank=list(AOT_RANK),
               export_s=export_s, export_s_by_program=meta["export_s"],
               bytes=meta["blob_bytes"], bytes_by_file=meta["blobs"],
               load_s=load_s, resident_bytes=resident,
               live_resident_bytes=live_resident, warmup_s=warmup_s,
               torch_version=meta["torch_version"])

    # 32 requests in 16-row chunks: artifact, live (its eager loop, which
    # steps as the artifact does), live graphed, then the same reversed
    # (the graphed times are warm, the capture falls in the first run)
    dbs = [aot_fitted(session, live, reqs[i:i + SERVE_TURN_BATCH],
                      SERVE_TURN_BATCH)
           for i in range(0, SERVE_REQUESTS, SERVE_TURN_BATCH)]
    walls = {"aot": [], "live": [], "live_graphed": []}
    graph_launches = []

    def timed_run(kind):
        n = graph_loop.LAUNCHES
        t0 = time.perf_counter()
        if kind == "aot":
            res = [r.nbest for r in session.respond_batch(reqs)]
        else:
            res = aot_live_nbest(live, dbs, eager=kind == "live")
        torch.cuda.synchronize()
        walls[kind].append(time.perf_counter() - t0)
        if kind == "aot":
            graph_launches.append(graph_loop.LAUNCHES - n)
        return res
    got, aot_launches, aot_calls = run_path(
        torch, ak, fk, lambda: timed_run("aot"))
    (want, steps), live_launches, _ = run_path(
        torch, ak, fk, lambda: timed_run("live"))
    graphed = [timed_run("live_graphed")[0]]   # eager, then captured
    walls["live_graphed"].clear()
    graphed.append(timed_run("live_graphed")[0])
    timed_run("live")
    timed_run("aot")
    host_ms = {k: 1e3 * sum(v) / len(v) / steps for k, v in walls.items()}
    chunk_ms = {k: 1e3 * sum(v) / len(v) / len(dbs)
                for k, v in walls.items()}
    out.update(bitwise_live=got == want, chunk_ms=chunk_ms,
               graph_launches_per_chunk=[n / len(dbs)
                                         for n in graph_launches],
               sets=[list(k) for k in session.sets],
               graphed_bitwise_live=all(g == want for g in graphed),
               steps=steps,
               launches=aot_launches, live_launches=live_launches,
               calls_by_shape=aot_calls, host_ms_per_step=host_ms,
               wall_s=walls)

    out["stream"] = aot_stream(torch, ak, fk, session, live, reqs[2])

    # each request alone (the b1 programs), as serve_http --aot decodes it
    single = []
    for r in reqs:
        single += aot_live_nbest(live, [aot_fitted(session, live, [r], 1)])[0]
    srv = start_server(session, port=0)
    base = "http://%s:%d" % srv.server_address
    try:
        results = [None] * SERVE_REQUESTS
        per = SERVE_REQUESTS // SERVE_THREADS

        def caller(i):
            for j in range(i * per, (i + 1) * per):
                results[j] = http(base, "/v1/respond", dict(bodies[j],
                                                            nbest=5))

        def concurrent():
            threads = [threading.Thread(target=caller, args=(i,))
                       for i in range(SERVE_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
        t0 = time.perf_counter()
        _, http_launches, http_calls = run_path(torch, ak, fk, concurrent)
        wall = time.perf_counter() - t0
        answers = [None if r is None or r[0] != 200 else
                   [(d["answer"], d["score"]) for d in r[1]["nbest"]]
                   for r in results]
        stats = http(base, "/stats")[1]
        code, ranked = http(base, "/v1/rank", dict(bodies[1], candidates=[
            " ".join(f"w{(7 * i + j) % 5000}" for j in range(3 + i % 9))
            for i in range(N_OPTIONS)]))
        text = http(base, "/v1/stream", bodies[2])[1]
        tokens = [json.loads(ln[6:]).get("token") for ln in
                  text.splitlines() if ln.startswith("data: ")][:-1]
        out["http"] = dict(
            requests=SERVE_REQUESTS, threads=SERVE_THREADS, wall_s=wall,
            requests_per_sec=SERVE_REQUESTS / wall,
            latency=stats["latency"], aot=stats["aot"],
            launches=http_launches, calls_by_shape=http_calls,
            bitwise_live=answers == single,
            rank_ok=code == 200 and len(ranked["candidates"]) == N_OPTIONS
            and all(math.isfinite(c["logp"]) for c in ranked["candidates"]),
            stream_equals_session=tokens == list(session.stream(reqs[2])))
    finally:
        srv.close()
    del session, srv
    torch.cuda.empty_cache()
    out["op_dispatch"] = op_dispatch(torch, ak, fk)
    out["reference"] = aot_reference(torch, corpus, root, reqs, lengths)
    out["int8"] = aot_int8(torch, ak, fk, corpus, root, reqs, lengths)
    h = out["http"]
    out["ok"] = bool(
        out["bitwise_live"] and aot_launches == live_launches
        and out["graphed_bitwise_live"]
        and out["graph_launches_per_chunk"] == [1.0] * len(graph_launches)
        and min(aot_launches.values()) > 0 and h["bitwise_live"]
        and h["aot"] is True and min(h["launches"].values()) > 0
        and h["rank_ok"] and h["stream_equals_session"]
        and out["stream"]["ok"]
        and out["reference"]["ok"] and out["int8"]["ok"])
    del live
    torch.cuda.empty_cache()
    return out


# -- training ---------------------------------------------------------------
# -- batched_ae, the data path, the training tools ---------------------------
BATCHED_REF_TOL = 1e-3   # card (kernels) vs CPU (plain), f32, as [reference]
BATCHED_LOSS_TOL = 1e-3  # bf16 step: batched vs sequential loss, relative
TOOLS_BLOCKS = 2


def batched_prefix(corpus: dict, root: str) -> str:
    """The corpus's seeded checkpoint under a sidecar with batched_ae."""
    from mtn_tpu_torch.weights import (load_checkpoint, load_conf,
                                       save_checkpoint, save_conf)
    vocab, conf = load_conf(corpus["prefix"])
    conf["model"]["batched_ae"] = True
    prefix = os.path.join(root, "batched", "mtn")
    os.makedirs(os.path.dirname(prefix))
    save_conf(prefix, vocab, **conf)
    save_checkpoint(prefix, 1, load_checkpoint(corpus["prefix"])[0])
    return prefix


def attention_rows(torch, ak, seen) -> list:
    """Device µs per call of the attention kernel at every shape in
    ``seen`` (``record_launches``), beside the plain version's, SDPA's and
    the bound."""
    import torch.nn.functional as F
    rows = []
    for key, rec in seen.items():
        if key[0] != "attention":
            continue
        q, k, v, mask = rec["args"]
        B, H, Lq, D = q.shape
        row = dict(kernel="attention", shape=[B, H, Lq, k.shape[2], D],
                   dtype=str(q.dtype).split(".")[-1],
                   mask=None if mask is None else list(mask.shape),
                   calls=rec["calls"])
        row["device_us"] = device_us(lambda: ak.launch(q, k, v, mask))
        row["plain_device_us"] = device_us(
            lambda: ak.attention_plain(q, k, v, mask))
        row["library_device_us"] = device_us(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        bound, row["bound_by"] = bound_ms(
            nbytes(q, k, v, q, mask), 4 * B * H * Lq * k.shape[2] * D,
            row["dtype"])
        row["bound_us"] = bound * 1e3
        rows.append(row)
    return rows


def batched_train_step(torch, ak, fk, corpus: dict) -> dict:
    """One bf16 batch-8 train step (dropout 0, both kernels) of the seeded
    flagship with batched_ae, against the sequential chain's step on the
    same weights and batch: the losses, the launches by shape, and the
    attention kernel's times at the batched step's shapes."""
    from mtn_tpu_torch.config import TrainConfig, config_from_dict
    from mtn_tpu_torch.train.batch import device_batch
    from mtn_tpu_torch.train.trainer import Trainer
    from mtn_tpu_torch.weights import load_checkpoint

    conf, hb = train_batch(corpus, corpus["prefix"], 8)
    sd, _ = load_checkpoint(corpus["prefix"])
    db = device_batch(hb, "cuda", "bfloat16")
    out = {}
    for name, batched in (("sequential", False), ("batched", True)):
        cfg = config_from_dict("model", conf["model"])
        cfg.dtype = "bfloat16"
        cfg.dropout = cfg.attn_dropout = 0.0
        cfg.remat = False
        cfg.use_pallas_attention = cfg.use_pallas_ffn = True
        cfg.batched_ae = batched
        tr = Trainer(cfg, TrainConfig(warmup_steps=WARMUP), "cuda")
        state = tr.state_from(sd)
        (_, metrics), launches, calls = run_path(
            torch, ak, fk, lambda: tr.train_step(state, db, 0))
        out[name] = dict(loss=metrics["loss"].item(), launches=launches,
                         calls=calls)
        S, layers = len(cfg.ft_sizes), cfg.nb_blocks
        if batched:
            seen = record_launches(ak, fk,
                                   lambda: tr.train_step(state, db, 0))
            out["kernel_rows"] = attention_rows(torch, ak, seen)
        del tr, state
        torch.cuda.empty_cache()
    seq, bat = out["sequential"], out["batched"]
    out["loss_rel_diff"] = abs(seq["loss"] - bat["loss"]) / abs(seq["loss"])
    # per layer the stack saves S - 1 launches of each AE attention and
    # every AE FFN launch (8 turns × 32 query rows: inside the FFN gate)
    out["ok"] = (math.isfinite(bat["loss"])
                 and out["loss_rel_diff"] <= BATCHED_LOSS_TOL
                 and bat["launches"]["attention"]
                 == seq["launches"]["attention"] - 2 * layers * (S - 1)
                 and bat["launches"]["ffn"]
                 == seq["launches"]["ffn"] - layers * S
                 and any(k.startswith("attention B16 ") for k in bat["calls"]))
    return out


def batched_ae_phase(torch, ak, fk, generate, corpus: dict,
                     root: str) -> dict:
    """The main path with a batched_ae sidecar: ``cli.generate`` beam
    decode at the flagship width (both kernels), counted by kernel and
    shape (the stacked precompute attends at 2 streams × 32 turns = B64;
    the decoder FFN runs at 160 rows and the stacked AE FFN never
    reaches the kernel); the f32 model on the card against the CPU on two
    turns, where the sequential chain's 64-row AE FFN would launch the
    kernel and the stacked one must not; and one bf16 train step against
    the sequential step."""
    prefix = batched_prefix(corpus, root)
    out_path = os.path.join(root, "batched.json")
    rc, launches, calls = run_path(torch, ak, fk, lambda: generate.main(
        generate_argv(corpus, prefix, out_path, *BEAM_FLAGS)))
    answers = answers_of(out_path)
    diff, ref_launches, ref_calls = run_path(
        torch, ak, fk, lambda: reference_check(
            torch, prefix, corpus["test_set"], corpus["fea_path"]))
    step = batched_train_step(torch, ak, fk, corpus)
    ffn_rows = sorted({int(k.split("N")[1]) for k in calls
                       if k.startswith("ffn")})
    att_batches = sorted({int(k.split()[1][1:]) for k in calls
                          if k.startswith("attention")})
    out = dict(filled=rc == 0 and len(answers) == N_DIALOGS
               and "__UNDISCLOSED__" not in answers,
               launches=launches, calls=calls,
               reference=dict(max_abs_diff=diff, tol=BATCHED_REF_TOL,
                              calls=ref_calls),
               train_step=step)
    out["ok"] = (out["filled"] and att_batches == [64]
                 and ffn_rows == [160] and diff <= BATCHED_REF_TOL
                 and "ffn N64" not in ref_calls
                 and "attention B4 Lq32 Lk32" in ref_calls
                 and step["ok"])
    return out


def data_phase(torch, corpus: dict, root: str) -> dict:
    """The host's batch build at the flagship batch (32 turns, I3D
    2048 × 64 frames, VGGish 128 × 32) over the test set's six turn
    batches, by route: numpy, the C++ loader, and the feature cache at
    each transfer (filling, then hits). Every route's batches reach the
    card bitwise equal to numpy's at the same transfer. Host ms per batch
    is ``make_batch``'s wall time (the files sit in the page cache after
    the first pass: the reads are from memory); ``upload_ms`` is
    ``device_batch`` to the card."""
    from mtn_tpu_torch.data import features
    from mtn_tpu_torch.data.batching import make_batch, make_batch_indices
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.data.feature_cache import FeatureCache
    from mtn_tpu_torch.train.batch import device_batch
    from mtn_tpu_torch.weights import load_conf

    vocab, _ = load_conf(corpus["prefix"])
    data = load(corpus["fea_types"], corpus["fea_path"],
                corpus["test_set"], vocab,
                include_caption="caption,summary", separate_caption=True)
    plans, _ = make_batch_indices(data, 32, max_length=10 ** 9,
                                  separate_caption=True)
    kw = dict(separate_caption=True, length_bucket=32, feature_bucket=32,
              pad_rows_to=32)

    def build(**extra):
        t0 = time.perf_counter()
        hbs = [make_batch(data, p, **kw, **extra) for p in plans]
        return hbs, (time.perf_counter() - t0) * 1e3 / len(plans)
    build(use_native_loader=False)        # the page cache, warm
    numpy_hbs, numpy_ms = build(use_native_loader=False)
    native_hbs, native_ms = build()
    shapes = [list(f.shape) for f in numpy_hbs[0].fts]
    routes = {"numpy": {"host_ms_per_batch": numpy_ms},
              "native": {"host_ms_per_batch": native_ms}}
    equal = True
    for transfer in ("float32", "bfloat16", "int8"):
        def upload(hbs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dbs = [device_batch(hb, "cuda", transfer) for hb in hbs]
            torch.cuda.synchronize()
            return dbs, (time.perf_counter() - t0) * 1e3 / len(hbs)
        want, upload_ms = upload(numpy_hbs)
        routes["numpy"][f"upload_ms_{transfer}"] = upload_ms
        cache = FeatureCache(os.path.join(root, "fcache", transfer),
                             transfer)
        runs = {"native": native_hbs}
        runs[f"cache_fill_{transfer}"], fill_ms = build(
            feature_cache=cache)
        runs[f"cache_hit_{transfer}"], hit_ms = build(feature_cache=cache)
        routes[f"cache_fill_{transfer}"] = {"host_ms_per_batch": fill_ms}
        routes[f"cache_hit_{transfer}"] = {
            "host_ms_per_batch": hit_ms, "hits": cache.hits,
            "misses": cache.misses}
        for name, hbs in runs.items():
            got, ms = upload(hbs)
            routes[name][f"upload_ms_{transfer}"] = ms
            same = all(torch.equal(a, b) for da, db in zip(want, got)
                       for a, b in zip(da.fts + da.fts_len,
                                       db.fts + db.fts_len))
            routes[name][f"bitwise_{transfer}"] = same
            equal = equal and same
    return dict(batches=len(plans), feature_shapes=shapes,
                native_in_use=features.native_in_use(), routes=routes,
                bitwise=equal, ok=equal and features.native_in_use())


def tools_phase(torch, generate, corpus: dict, root: str) -> dict:
    """``cli.train`` on the card at the flagship widths and 2 blocks, three
    epochs of one 48-turn batch (the valid set): run (t) with
    ``--profile-dir --async-save 1 --feature-cache``, its train and
    validation steps graphed (each shape's first step eager, its second
    captured, its third replayed), run (s) with ``--nan-checks 1``, which
    runs every step eagerly, blocking saves and no profiler (the cache
    now warm). Both checkpoint directories must be bitwise equal and the
    trace must exist; then ``python -m mtn_tpu_torch.utils.average``
    averages (t)'s last two epochs on the card, bitwise equal to the
    same mean on the CPU, and ``cli.generate`` beam-decodes the averaged
    family."""
    from mtn_tpu_torch.cli import train as train_cli
    from mtn_tpu_torch.train.graphs import StepGraphs
    from mtn_tpu_torch.utils import average
    from mtn_tpu_torch.utils.profiling import TRACE_STEPS
    from mtn_tpu_torch.weights import load_checkpoint
    base = os.path.join(root, "tools")
    cache, prof = os.path.join(base, "cache"), os.path.join(base, "prof")
    common = ("--nb-blocks", str(TOOLS_BLOCKS), "--train-set",
              corpus["valid_set"], "--batch-size", "48",
              "--keep-checkpoints", "0", "--num-epochs", "3",
              "--feature-cache", cache)
    runs, walls, programs = {}, {}, {}
    for name, extra in (("t", ("--profile-dir", prof, "--async-save", "1")),
                        ("s", ("--nan-checks", "1"))):
        prefix = os.path.join(base, name, "mtn")
        t0 = time.time()
        with graph_runners(StepGraphs) as made:
            rc = train_cli.main(train_argv(corpus, prefix, *common, *extra))
        walls[name] = time.time() - t0
        programs[name] = runner_counts(made)
        if rc != 0:
            raise AssertionError(f"tools run ({name}): exit code {rc}")
        runs[name] = prefix
    files = {n: sorted(os.listdir(p + "_torch")) for n, p in runs.items()}

    def same(name):
        with open(os.path.join(runs["t"] + "_torch", name), "rb") as a, \
                open(os.path.join(runs["s"] + "_torch", name), "rb") as b:
            return a.read() == b.read()
    bitwise = files["t"] == files["s"] and all(same(f) for f in files["t"])
    traces = [os.path.join(prof, f) for f in os.listdir(prof)] \
        if os.path.isdir(prof) else []
    avg = os.path.join(base, "avg", "mtn")
    t0 = time.time()
    avg_rc = subprocess.run(
        [sys.executable, "-m", "mtn_tpu_torch.utils.average", "--model",
         runs["t"], "--epochs", "last2", "--out", avg], cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
        text=True, timeout=600).returncode
    out_path = os.path.join(base, "avg.json")
    gen_rc = generate.main(generate_argv(corpus, avg, out_path,
                                         *BEAM_FLAGS))
    answers = answers_of(out_path) if gen_rc == 0 else []
    avg_s = time.time() - t0
    # the card's mean (the subprocess, on cuda by default) against the
    # CPU's: the same f32 sums and division, so bitwise
    avg_cpu = os.path.join(base, "avg_cpu", "mtn")
    average.average_checkpoints(runs["t"], ["last2"], avg_cpu, "cpu")
    card_mean = load_checkpoint(avg, "best")[0] if avg_rc == 0 else {}
    cpu_mean = load_checkpoint(avg_cpu, "best")[0]
    average_bitwise = card_mean.keys() == cpu_mean.keys() and all(
        torch.equal(card_mean[k], cpu_mean[k]) for k in cpu_mean)
    out = dict(blocks=TOOLS_BLOCKS, files=files["t"], bitwise=bitwise,
               trace_bytes=[os.path.getsize(t) for t in traces],
               trace_steps=TRACE_STEPS,
               cache_entries=len(os.listdir(cache)), wall_s=walls,
               step_programs=programs,
               average_rc=avg_rc, average_and_decode_s=avg_s,
               average_card_equals_cpu=average_bitwise,
               averaged_answers=len(answers),
               averaged_example=answers[0] if answers else None)
    out["ok"] = (bitwise and len(traces) == 1 and avg_rc == 0
                 and programs["t"]["captures"] == 2
                 and programs["s"]["batches"] == 0
                 and average_bitwise
                 and len(answers) == N_DIALOGS
                 and "__UNDISCLOSED__" not in answers
                 and out["cache_entries"] > 0)
    return out


def train_argv(corpus: dict, prefix: str, *extra):
    """``mtn_tpu_torch.cli.train`` flags for ``corpus`` at the flagship
    width (two epochs, bf16, both kernels, run.sh's max length), then
    ``extra``."""
    return ["--fea-type", *corpus["fea_types"],
            "--train-path", corpus["fea_path"],
            "--train-set", corpus["train_set"],
            "--valid-path", corpus["fea_path"],
            "--valid-set", corpus["valid_set"],
            "--include-caption", "caption,summary", "--separate-caption",
            "1", "--model", prefix,
            "--nb-blocks", str(FLAGSHIP["nb_blocks"]),
            "--d-model", str(FLAGSHIP["d_model"]),
            "--d-ff", str(FLAGSHIP["d_ff"]),
            "--att-h", str(FLAGSHIP["att_h"]),
            "--diff-encoder", "1", "--auto-encoder-ft", "query",
            "--vocab-cutoff", "0", "--num-epochs", "2", "--max-length",
            "256", "--warmup-steps", str(WARMUP), "--report-interval", "1",
            "--keep-checkpoints", "1", "--device", "cuda", "--dtype",
            "bfloat16", "--use-pallas-attention", "1", "--use-pallas-ffn",
            "1", *extra]


class StepLaunches:
    """Kernel launches made inside ``Trainer.train_step`` (the method is
    wrapped for the duration of a run), beside the run's totals."""

    def __init__(self):
        self.counts = {name: 0 for name in kernel_ops()}

    def __enter__(self):
        from mtn_tpu_torch.train.trainer import Trainer
        self.orig = orig = Trainer.train_step
        counts = self.counts

        def train_step(tr, *args, **kwargs):
            before = launch_counts()
            try:
                return orig(tr, *args, **kwargs)
            finally:
                for name, n in launch_counts().items():
                    counts[name] += n - before[name]
        Trainer.train_step = train_step
        return self

    def __exit__(self, *exc):
        from mtn_tpu_torch.train.trainer import Trainer
        Trainer.train_step = self.orig


def read_csv(path: str):
    with open(path) as f:
        head, *rows = [line.strip().split(",") for line in f if line.strip()]
    return [dict(zip(head, r)) for r in rows]


def train_run(torch, ak, fk, corpus: dict, root: str, name: str,
              *extra) -> dict:
    """One ``cli.train.main`` run (two epochs) in this process: its row
    (:func:`train_row`) with its kernel launches counted here (all, and
    those inside train steps) and its trainer's step programs."""
    from mtn_tpu_torch.cli import train as train_cli
    from mtn_tpu_torch.train.graphs import StepGraphs
    prefix = os.path.join(root, name, "mtn")
    zero_launches()
    t0 = time.time()
    with StepLaunches() as steps, \
            graph_runners(StepGraphs) as runners:
        rc = train_cli.main(train_argv(corpus, prefix, *extra))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    if rc != 0:
        raise AssertionError(f"train run {name}: exit code {rc}")
    return train_row(name, prefix, wall, launches, steps.counts,
                     runner_counts(runners))


def train_row(name: str, prefix: str, wall: float, launches: dict,
              train_step_launches: dict, step_programs: dict) -> dict:
    """A stage-2 run's row from what it wrote: steps and losses
    (``<prefix>_train.csv``), epoch losses (``_trace.csv``), the best
    epoch (the checkpoint meta), beside its kernel launches and step
    programs. Fails if a loss is not finite, if the mean of the last
    steps' losses is not below the first steps', or if meta.json has no
    best epoch."""
    rows = read_csv(prefix + "_train.csv")
    losses = [float(r["loss"]) for r in rows]
    tps = [float(r["tokens_per_sec"]) for r in rows]
    with open(os.path.join(prefix + "_torch", "meta.json")) as f:
        meta = json.load(f)
    k = max(1, min(5, len(losses) // 4))
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    out = dict(run=name, prefix=prefix, steps=len(losses),
               first_steps_loss=first, last_steps_loss=last,
               epochs={f"{r['epoch']} {r['split']}": float(r["avg_loss"])
                       for r in read_csv(prefix + "_trace.csv")},
               best_epoch=meta.get("best_epoch"), wall_s=wall,
               launches=launches, train_step_launches=train_step_launches,
               step_programs=step_programs,
               median_reported_tokens_per_sec=(
                   sorted(tps[1:])[len(tps[1:]) // 2] if len(tps) > 1
                   else None))
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train run {name}: a loss is not finite")
    if not last < first:
        raise AssertionError(f"train run {name}: the loss did not fall "
                             f"({first:.4f} -> {last:.4f})")
    if meta.get("best_epoch") is None:
        raise AssertionError(f"train run {name}: meta.json has no best "
                             "epoch")
    return out


# -- run_torch.sh: stages 2-4 through the port's stage driver --------------
RUN_TORCH_EPOCHS = 1
RUN_TORCH_RESULT = "result_test_set_b5_p1.0_beam_search_undisclosed1"
STAGE_LINE = re.compile(r"^stage ([1-4]): ")
TRAIN_LAUNCHES = re.compile(
    r"kernel launches: train (\{[^}]*\}), validation (\{[^}]*\})$")
DECODE_LAUNCHES = re.compile(r"kernel launches: (\{[^}]*\})$")
STEP_PROGRAMS = re.compile(
    r"step programs: (\d+) steps, (\d+) shapes, (\d+) captures, "
    r"(\d+) evicted, (\d+) eager, (\d+) kept$")


def run_torch_layout(corpus: dict):
    """run.sh's stage-3/4 layout over the corpus: ``<FeaType>_testset``
    feature directories and the undisclosed-only labeled set (each
    dialog's last turn). Returns (the corpus root, which is the stages'
    ``fea_dir``, the eval set)."""
    root = os.path.dirname(corpus["prefix"])
    for ft in corpus["fea_types"]:
        link = os.path.join(root, f"{ft}_testset")
        if not os.path.lexists(link):
            os.symlink(os.path.join(root, ft), link)
    with open(corpus["lbl_test_set"]) as f:
        lbl = json.load(f)
    for d in lbl["dialogs"]:
        d["dialog"] = d["dialog"][-1:]
    eval_set = os.path.join(root, "lbl_undisclosedonly_test_set.json")
    with open(eval_set, "w") as f:
        json.dump(lbl, f)
    return root, eval_set


def stage3_argv(corpus: dict, expdir: str, out: str):
    """The ``cli.generate`` flags ``run_torch.sh`` stage 3 passes with its
    defaults, the kernel overrides of :func:`run_torch` and the stage's
    result path ``out``."""
    root = os.path.dirname(corpus["prefix"])
    return ["--test-path", os.path.join(root, "<FeaType>_testset",
                                        "<ImageID>.npy"),
            "--test-set", corpus["test_set"],
            "--model-conf", os.path.join(expdir, "mtn.conf.json"),
            "--model", os.path.join(expdir, "mtn_best"), "--beam", "5",
            "--penalty", "1.0", "--nbest", "5", "--output", out,
            "--decode-style", "beam_search", "--undisclosed-only", "1",
            "--labeled-test", corpus["lbl_test_set"], "--turn-batch", "32",
            "--dtype", "bfloat16", "--mesh-data", "-1", "--mesh-model", "1",
            "--use-pallas-attention", "1", "--use-pallas-ffn", "1",
            "--feature-transfer", "", "--uniform-shapes", "1",
            "--early-stop", "1", "--temperature", "1.0", "--top-k", "0",
            "--top-p", "0.0", "--sample-seed", "1", "--device", "cuda"]


def run_torch(corpus: dict, expdir: str, log_path: str):
    """``bash run_torch.sh 2`` (stages 2-4) from the checkout's root, as
    run.sh runs: run.sh's settings at the flagship width (batch 32,
    dropout 0.1, remat, cut_a, bf16, beam 5, 32 turns a batch) for
    ``RUN_TORCH_EPOCHS`` epochs, with both kernels switched on, a
    training report every step, and the corpus's paths as overrides.
    Returns (its exit code, wall seconds by stage); the output goes to
    ``log_path``."""
    root, eval_set = run_torch_layout(corpus)
    fea = corpus["fea_types"]
    argv = ["bash", "run_torch.sh", "2", " ".join(fea), "+".join(fea),
            str(RUN_TORCH_EPOCHS), str(WARMUP), "0.1",
            "--use_pallas_attention", "1", "--use_pallas_ffn", "1",
            "--report_interval", "1", "--train_set", corpus["train_set"],
            "--valid_set", corpus["valid_set"], "--test_set",
            corpus["test_set"], "--labeled_test", corpus["lbl_test_set"],
            "--eval_set", eval_set, "--fea_dir", root, "--expdir", expdir]
    marks = {}
    t0 = time.time()
    with open(log_path, "w") as log, subprocess.Popen(
            argv, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) as proc:
        for line in proc.stdout:
            log.write(line)
            m = STAGE_LINE.match(line)
            if m:
                marks[int(m.group(1))] = time.time()
        rc = proc.wait()
    ends = sorted(marks)[1:] + [None]
    seconds = {f"stage {s}": (marks[e] if e else time.time()) - marks[s]
               for s, e in zip(sorted(marks), ends)}
    seconds["total"] = time.time() - t0
    return rc, seconds


def run_torch_phase(torch, ak, fk, generate, corpus: dict,
                    root: str) -> dict:
    """``[run-torch]``: :func:`run_torch`, read from what it wrote.
    Stage 2 (run.sh's settings, as ``[train]`` run (a) in this process,
    but at run.sh's vocabulary cutoff of 5 and for one epoch): the losses
    fall, the meta has a best epoch, the kernels launch in validation
    only (the trainer's log line each epoch), its step programs. Stage 3:
    every undisclosed answer replaced, the result JSON byte-equal to
    ``cli.generate.main`` run here on the same checkpoint with the same
    flags, whose launches are counted here and equal the stage's logged
    ones. Stage 4: the ``.eval`` and the printed summary hold the 7
    metric lines, over one reference a dialog."""
    expdir = os.path.join(root, "run_torch")
    log_path = os.path.join(root, "run_torch.log")
    torch.cuda.empty_cache()
    rc, seconds = run_torch(corpus, expdir, log_path)
    with open(log_path) as f:
        log = f.read()
    if rc != 0:
        raise AssertionError(f"run_torch.sh exited {rc}:\n{log[-6000:]}")
    lines = log.splitlines()
    epochs = [m.groups() for m in map(TRAIN_LAUNCHES.search, lines) if m]
    train_launches, valid_launches = ({
        k: sum(json.loads(e[i])[k] for e in epochs)
        for k in kernel_ops()} for i in (0, 1))
    programs = [m.groups() for m in map(STEP_PROGRAMS.search, lines) if m]
    decoded = [json.loads(m.group(1))
               for m in map(DECODE_LAUNCHES.search, lines) if m]
    if len(epochs) != RUN_TORCH_EPOCHS or not programs or len(decoded) != 1:
        raise AssertionError("run_torch.sh: the stages' logs lack their "
                             f"launch or program lines:\n{log[-6000:]}")
    stage2 = train_row(
        "run_torch", os.path.join(expdir, "mtn"), seconds["stage 2"],
        {k: train_launches[k] + valid_launches[k] for k in train_launches},
        train_launches, dict(zip(("batches", "shapes", "captures",
                                  "evictions", "eager", "sets"),
                                 map(int, programs[-1]))))
    result = os.path.join(expdir, RUN_TORCH_RESULT + ".json")
    here = os.path.join(root, "run_torch_here.json")
    from mtn_tpu_torch.cli.common import kernel_launches
    zero_launches()
    grc = generate.main(stage3_argv(corpus, expdir, here))
    torch.cuda.synchronize()
    launches = kernel_launches()   # the keys of the stage's log line
    with open(result, "rb") as f, open(here, "rb") as g:
        same = f.read() == g.read()
    answers = answers_of(result)
    stage3 = dict(answers=len(answers), example=answers[0],
                  byte_equal_in_process=same, launches=decoded[0],
                  in_process_launches=launches,
                  ok=grc == 0 and same and decoded[0] == launches
                  and min(launches.values()) > 0
                  and len(answers) == N_DIALOGS
                  and "__UNDISCLOSED__" not in answers)
    with open(os.path.join(expdir, RUN_TORCH_RESULT + ".eval")) as f:
        block = [ln for ln in f.read().splitlines() if METRIC_LINE.match(ln)]
    with open(os.path.join(expdir, RUN_TORCH_RESULT + "_ref.json")) as f:
        refs = len(json.load(f)["annotations"])
    summary = log.split("--- summary ---\n", 1)[-1].split("-----")[0]
    stage4 = dict(block=block, references=refs,
                  ok=len(block) == 7 and refs == N_DIALOGS
                  and summary.splitlines() == block)
    return dict(stage2=stage2, stage3=stage3, stage4=stage4,
                seconds=seconds,
                ok=stage3["ok"] and stage4["ok"]
                and stage2["launches"]["attention"] > 0
                and not any(train_launches.values()))


def train_batch(corpus: dict, prefix: str, rows: int):
    """The first (longest-history) host batch of ``rows`` turns of the
    train set, with the trained model's vocabulary."""
    from mtn_tpu_torch.data.batching import make_batch, make_batch_indices
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.weights import load_conf
    vocab, conf = load_conf(prefix)
    data = load(corpus["fea_types"], corpus["fea_path"],
                corpus["train_set"], vocab,
                include_caption="caption,summary", separate_caption=True)
    plans, _ = make_batch_indices(data, rows, max_length=256,
                                  separate_caption=True)
    return conf, make_batch(data, plans[0], separate_caption=True,
                            length_bucket=32, feature_bucket=32,
                            pad_rows_to=rows)


def train_reference(torch, ak, fk, corpus: dict, prefix: str) -> dict:
    """One f32 train step of the trained flagship model (dropout 0) on the
    card, both kernels behind their wrappers, against the same step on
    the CPU (plain versions), on a two-turn batch: the loss difference
    and each gradient's relative L2 difference. The same step on the card
    with the kernels off is the yardstick: it differs from the CPU only
    by the card's own f32 sums. The K projections' biases are reported
    apart: their true gradient is 0 (the softmax ignores a shift shared by
    a row's scores), so both sides hold rounding noise."""
    from mtn_tpu_torch.config import TrainConfig, config_from_dict
    from mtn_tpu_torch.train.batch import device_batch
    from mtn_tpu_torch.train.trainer import Trainer
    from mtn_tpu_torch.weights import load_checkpoint

    conf, hb = train_batch(corpus, prefix, 2)
    sd, _ = load_checkpoint(prefix)
    runs = (("card", "cuda", True), ("card_plain", "cuda", False),
            ("cpu", "cpu", True))
    got = {}
    for name, dev, kernels in runs:
        cfg = config_from_dict("model", conf["model"])
        cfg.dtype = "float32"
        cfg.dropout = cfg.attn_dropout = 0.0
        cfg.remat = False
        cfg.use_pallas_attention = cfg.use_pallas_ffn = kernels
        zero_launches()
        tr = Trainer(cfg, TrainConfig(warmup_steps=WARMUP), dev)
        tr.state_from(sd)
        loss, _, grads = tr.loss_and_grads(device_batch(hb, dev), (0, 0))
        got[name] = (loss.item(), {n: g.detach().float().cpu()
                                   for n, g in zip(tr.names, grads)},
                     {"attention": ak.KERNEL.launches,
                      "ffn": fk.KERNEL.launches})
        del tr, grads
        torch.cuda.empty_cache()
    (lc, gc, launches), (_, gq, _), (lp, gp, _) = (got[r[0]] for r in runs)

    def rel_l2(a):
        return {n: ((a[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
                for n, g in gp.items() if not n.endswith(".w_k.bias")}
    rel, rel_plain = rel_l2(gc), rel_l2(gq)
    worst = sorted(rel, key=lambda n: -rel[n])[:5]
    kbias = max(max(g[n].abs().max().item() for g in (gc, gp))
                for n in gp if n.endswith(".w_k.bias"))
    finite = math.isfinite(lc) and all(torch.isfinite(g).all()
                                       for g in gc.values())
    tol = TRAIN_REF_TOL
    return dict(loss_card=lc, loss_cpu=lp,
                loss_rel_diff=abs(lc - lp) / abs(lp),
                max_rel_l2=rel[worst[0]],
                plain_card_max_rel_l2=max(rel_plain.values()),
                worst=[(n, rel[n], rel_plain[n]) for n in worst],
                n_grads=len(rel), k_bias_max_abs_grad=kbias,
                launches=launches, finite=finite, tol=tol,
                ok=finite and rel[worst[0]] <= tol["grad"]
                and abs(lc - lp) <= tol["loss"] * abs(lp))


def record_launches(ak, fk, fn):
    """Run ``fn`` with the hand-written kernels' launches recorded: per
    kernel and distinct set of argument shapes, a copy of the first
    call's arguments and the number of calls. A launch inside a CUDA
    graph is recorded at each replay of the graph
    (``_build.REPLAY_LISTENERS``), with the argument shapes (and the
    values of the other arguments) in place of the arguments; a capture
    itself launches nothing and is not recorded."""
    from mtn_tpu_torch.ops import _build
    import torch
    seen = {}
    mods = kernel_ops()
    origs = {name: m.launch for name, m in mods.items()}

    def record(key, args, n):
        if key not in seen:
            seen[key] = {"args": args, "calls": 0}
        seen[key]["calls"] += n

    def recorder(name, orig):
        def launch(*args):
            if not torch.cuda.is_current_stream_capturing():
                record((name,) + tuple(tuple(a.shape) if hasattr(a, "shape")
                                       else None for a in args),
                       [a.detach().clone() if hasattr(a, "detach") else a
                        for a in args], 1)
            return orig(*args)
        return launch

    def replayed(calls):
        for (kernel, shapes), n in calls.items():
            record((kernel.name,) + tuple(
                s if isinstance(s, tuple) else None for s in shapes),
                list(shapes), n)
    for name, m in mods.items():
        m.launch = recorder(name, origs[name])
    _build.REPLAY_LISTENERS.append(replayed)
    try:
        fn()
        _build.settle()   # the graph launches still on the device
    finally:
        for name, m in mods.items():
            m.launch = origs[name]
        _build.REPLAY_LISTENERS.remove(replayed)
    return seen


def attention_backward_closed(torch, q, k, v, m, g):
    """The gradients (dq, dk, dv) of ``sdpa(q, k, v, m)`` against ``g``,
    written out with sdpa's casts: P recomputed, dV = Pᵀ·dO, dP = dO·Vᵀ,
    dS = P⊙(dP − rowsum(dP⊙P)), dQ = dS·K/√D, dK = dSᵀ·Q/√D. A yardstick
    for the wrapper's nested ``torch.autograd.grad``; the port does not
    use it."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if m is not None:
        s = torch.where(m, s, -1e9)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2)).to(v.dtype).float()
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    if m is not None:
        ds = torch.where(m, ds, 0.0)
    return (torch.matmul(ds, kf).to(q.dtype),
            torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype),
            dv.to(v.dtype))


def profile_step(torch, ak, fk, tr, state, db) -> dict:
    """One train step under torch.profiler: device time by kernel group,
    busy time, launches, the hand-written kernels' calls (counted, and
    seen by the profiler) and the top host ops by self time."""
    from torch.profiler import ProfilerActivity, profile
    zero_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_step(state, db, 0)
        torch.cuda.synchronize()
    groups, launches, top = device_groups(torch, prof)
    seen = {g: 0 for g in ("attention (csrc)", "ffn (csrc)")}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                kernel_group(e.key) in seen:
            seen[kernel_group(e.key)] += e.count
    calls = {"attention (csrc)": ak.KERNEL.launches,
             "ffn (csrc)": fk.KERNEL.launches}
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key[:60])
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)[:10]
    return {"device_busy_ms": sum(groups.values()) if launches
            else "not measured",
            "device_ms_by_group": groups, "device_launches": launches,
            "kernel_calls": calls,
            "kernel_calls_seen": seen if launches else "not measured",
            "counts_match": seen == calls,
            "top_kernels": top, "top_host_ops_self_ms": host}


def train_profile(torch, ak, fk, corpus: dict, prefix: str) -> dict:
    """Warm bf16 train steps of run (b)'s configuration (batch 8, dropout
    0) from its trained checkpoint, eager, with both kernels and with
    both off (the plain path, plain autograd; the graphed step's reading
    is ``[train-graphs]`` b_bf16's): host wall time per step (two rounds
    of 3 steps each, alternating, so host drift hits both) and tokens/sec;
    under torch.profiler each step's device time by kernel group, busy
    and idle share, launches, the kernels' calls counted and seen, and
    top host ops. Then each
    kernel's device µs per call at every shape the kernel step launched
    it at, beside the plain version's and SDPA's on the same inputs, and
    forward plus backward per call three ways: the wrapper (kernel, then
    the plain backward by nested autograd), plain autograd, and the kernel
    with the backward written out (attention)."""
    import torch.nn.functional as F
    from mtn_tpu_torch.config import TrainConfig, config_from_dict
    from mtn_tpu_torch.ops.attention import sdpa
    from mtn_tpu_torch.train.batch import device_batch
    from mtn_tpu_torch.train.trainer import Trainer
    from mtn_tpu_torch.weights import load_checkpoint

    conf, hb = train_batch(corpus, prefix, 8)
    sd = load_checkpoint(prefix)[0]
    db = device_batch(hb, "cuda", "bfloat16")
    runs = {}
    for name, kernels in (("eager", True), ("plain", False)):
        cfg = config_from_dict("model", conf["model"])
        cfg.use_pallas_attention = cfg.use_pallas_ffn = kernels
        tr = Trainer(cfg, TrainConfig(warmup_steps=WARMUP), "cuda")
        tr.graphed = lambda t: False
        state = tr.state_from(sd)
        tr.train_step(state, db, 0)
        runs[name] = (tr, state)
    torch.cuda.synchronize()
    walls = {name: [] for name in runs}
    for _ in range(2):
        for name, (tr, state) in runs.items():
            t0 = time.perf_counter()
            for _ in range(3):
                _, metrics = tr.train_step(state, db, 0)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / 3 * 1e3)
    ntok = metrics["ntokens"].item()
    tr, state = runs["eager"]   # the launches' own arguments
    seen = record_launches(ak, fk, lambda: tr.train_step(state, db, 0))
    torch.cuda.synchronize()
    steps = {}
    for name, (tr, state) in runs.items():
        wall = sum(walls[name]) / len(walls[name])
        prof = profile_step(torch, ak, fk, tr, state, db)
        busy = prof["device_busy_ms"]
        steps[name] = dict(
            wall_ms=wall, wall_ms_rounds=walls[name],
            tokens_per_sec=ntok / wall * 1e3, device_busy_ms=busy,
            idle_share=(1 - busy / wall) if not isinstance(busy, str)
            else busy, **{k: v for k, v in prof.items()
                          if k != "device_busy_ms"})
    rows = []
    for key, rec in seen.items():
        args = rec["args"]
        row = dict(kernel=key[0], shape=[list(s) for s in key[1:]
                                         if s is not None][:2],
                   calls_per_step=rec["calls"])
        leaves = [a.detach().requires_grad_() for a in args[:5]
                  if a is not None and a.is_floating_point()]
        g = torch.randn(args[0].shape, device="cuda").to(args[0].dtype)
        grad = lambda out: torch.autograd.grad(out, leaves, g)
        if key[0] == "attention":
            q, k, v, mask = args
            B, H, Lq, D = q.shape
            m = (None if mask is None else
                 ak._canon_mask(mask, B, Lq, k.shape[2])[:, None])
            row["mask"] = None if mask is None else list(mask.shape)
            row["device_us"] = device_us(lambda: ak.launch(q, k, v, mask))
            row["plain_device_us"] = device_us(
                lambda: ak.attention_plain(q, k, v, mask))
            row["library_device_us"] = device_us(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask))
            row["bound_us"], row["bound_by"] = bound_ms(
                nbytes(q, k, v, q, mask), 4 * B * H * Lq * k.shape[2] * D,
                "bfloat16")
            fwd_bwd = {
                "wrapper": lambda: grad(ak.AttentionFunction.apply(
                    *leaves, mask)),
                "plain": lambda: grad(sdpa(*leaves, m)),
                "closed": lambda: (ak.launch(q, k, v, mask),
                                   attention_backward_closed(
                                       torch, q, k, v, m, g))[1]}
            nested = fwd_bwd["wrapper"]()
            closed = fwd_bwd["closed"]()
            row["closed_bwd_rel_err"] = max(
                (a.float() - b.float()).abs().max().item()
                for a, b in zip(closed, nested)) / max(
                b.float().abs().max().item() for b in nested)
        else:
            x, w1 = args[0], args[1]
            row["device_us"] = device_us(lambda: fk.launch(*args))
            row["plain_device_us"] = device_us(lambda: fk.ffn_plain(*args))
            row["library_device_us"] = None
            row["bound_us"], row["bound_by"] = bound_ms(
                nbytes(*args[:5], x),
                4 * x.shape[0] * x.shape[1] * w1.shape[1], "bfloat16")
            fwd_bwd = {"wrapper": lambda: grad(fk.FFNFunction.apply(*leaves)),
                       "plain": lambda: grad(fk.ffn_plain(*leaves))}
        row["bound_us"] *= 1e3
        for name, fn in fwd_bwd.items():
            timed(row, f"fwd_bwd_{name}_", fn)
        rows.append(row)
    del runs, tr, state
    torch.cuda.empty_cache()
    out = {"batch": list(hb.query.shape), "answer_tokens": ntok,
           "eager": steps["eager"], "kernels_off": steps["plain"],
           "kernels": rows}
    out["counts_match"] = all(v["counts_match"] for v in steps.values())
    return out


# -- [train-graphs]: each train, accumulation and eval step as one program ----
TRAIN_GRAPH_STEPS = 4    # the shape's first step (eager), the capture, replays
TRAIN_GRAPH_RESUME = 3   # steps after a mid-run step checkpoint's resume
TRAIN_GRAPH_CLIP = 1.0   # the accumulation step's --grad-clip


@contextlib.contextmanager
def mask_tape(torch):
    """Every tensor ``bernoulli_`` fills inside the block (the dropout
    masks, scaled in place by 1/(1 - rate) after the draw), in call
    order, with whether the thread's stream was capturing: a capture's
    masks are the graph's own buffers, which each replay refills."""
    tape, orig = [], torch.Tensor.bernoulli_

    def bernoulli_(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        tape.append((torch.cuda.is_current_stream_capturing(), out))
        return out
    torch.Tensor.bernoulli_ = bernoulli_
    try:
        yield tape
    finally:
        torch.Tensor.bernoulli_ = orig


def state_tensors(state) -> list:
    """A train state's masters, Adam's moments and its device count."""
    o = state.opt_state
    return [*state.params.values(), *o.mu, *o.nu, o.t]


def graph_twins(torch, ak, fk, cfg, tcfg, sd, batch, step,
                resume_dir=None) -> dict:
    """A graphed trainer and its eager twin (``graphed`` False on this
    instance) from the same state, ``step(trainer, state, batch)`` on
    both in turns TRAIN_GRAPH_STEPS times (the graphed one: the shape's
    first step eager, then the capture, then replays): each step's
    metrics, dropout masks and kernel launches compared bitwise, then the
    masters, moments, device count and counts; the capture's seconds and
    pool bytes; with ``resume_dir``, the graphed state saved there as an
    async step checkpoint and restored into a new graphed trainer, and
    both trainers stepped TRAIN_GRAPH_RESUME more times (the resumed one
    from its shape's first step again), their metrics and states
    bitwise; then host wall per warm step, device busy and idle,
    launches and tokens/sec of each twin, one call of each under the
    profiler, whose kernel counts must equal the kernels' own."""
    from mtn_tpu_torch.train.trainer import Trainer
    tg = Trainer(cfg, tcfg, "cuda")
    te = Trainer(cfg, tcfg, "cuda")
    te.graphed = lambda t: False
    sg, se = tg.state_from(sd), te.state_from(sd)
    same_metrics = same_masks = same_launches = True
    kinds, masks, launches, captured, pool = [], [], [], [], None
    capture_s = None
    for _ in range(TRAIN_GRAPH_STEPS):
        counts = []
        for tr, state in ((te, se), (tg, sg)):
            before = (tr.graphs.captures, tr.graphs.eager)
            torch.cuda.synchronize()
            if tr is tg and before[1] == 1:     # this step captures
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
            n0 = (ak.KERNEL.launches, fk.KERNEL.launches)
            with mask_tape(torch) as tape, capture_seconds() as built:
                metrics = step(tr, state, batch)
                torch.cuda.synchronize()
            counts.append((ak.KERNEL.launches - n0[0],
                           fk.KERNEL.launches - n0[1]))
            if tr is te:
                want, want_masks = metrics, [t for _, t in tape]
                continue
            if tr.graphs.captures > before[0]:
                kinds.append("capture")
                capture_s = built
                captured = [t for c, t in tape if c]
                got_masks = [t for c, t in tape if not c]   # the warm-up
                torch.cuda.empty_cache()
                pool = torch.cuda.memory_reserved() - reserved
            elif tr.graphs.eager > before[1]:
                kinds.append("eager")
                got_masks = [t for _, t in tape]
            else:
                kinds.append("replay")
                got_masks = captured
        same_metrics &= want.keys() == metrics.keys() and all(
            torch.equal(want[k], metrics[k]) for k in want)
        same_masks &= len(want_masks) == len(got_masks) and all(
            torch.equal(a, b) for a, b in zip(want_masks, got_masks))
        same_launches &= counts[0] == counts[1]
        masks.append(len(want_masks))
        launches.append(counts[1])
    del want_masks, got_masks, captured
    same_state = (sg.step, sg.opt_state.count) == (se.step,
                                                   se.opt_state.count) and all(
        torch.equal(a, b) for a, b in zip(state_tensors(sg),
                                          state_tensors(se)))
    ntok = want["ntokens"].item()
    resumed = None
    if resume_dir is not None:
        from mtn_tpu_torch.utils.checkpoint import CheckpointManager
        ckpt = CheckpointManager(resume_dir, async_save=True)
        ckpt.save_step(sg, 0, TRAIN_GRAPH_STEPS)
        tr = Trainer(cfg, tcfg, "cuda")
        sr = ckpt.restore_step(tr.init_state(0))[0]
        same = sr.step == sg.step
        for _ in range(TRAIN_GRAPH_RESUME):
            a, b = step(tg, sg, batch), step(tr, sr, batch)
            same &= all(torch.equal(a[k], b[k]) for k in a)
        same &= (sr.step, sr.opt_state.count) == (
            sg.step, sg.opt_state.count) and all(
            torch.equal(a, b) for a, b in zip(state_tensors(sr),
                                              state_tensors(sg)))
        resumed = dict(at_step=TRAIN_GRAPH_STEPS, steps=TRAIN_GRAPH_RESUME,
                       bitwise=bool(same), runner=runner_counts([tr.graphs]))
        del tr, sr
    timing = {}
    for name, tr, state in (("graphed", tg, sg), ("eager", te, se)):
        row = profiled_batches(torch, ak, fk,
                               lambda: step(tr, state, batch))
        row["tokens_per_sec"] = ntok / row["wall_ms"] * 1e3
        timing[name] = row
    out = dict(steps=kinds, masks_per_step=masks,
               launches_per_step=launches, metrics_bitwise=same_metrics,
               masks_bitwise=same_masks, launches_equal=same_launches,
               state_bitwise=same_state, capture_s=capture_s,
               pool_bytes=pool, tokens_per_step=ntok, **timing,
               runner=runner_counts([tg.graphs]), resumed=resumed)
    out["ok"] = (same_metrics and same_masks and same_launches
                 and same_state and kinds[:2] == ["eager", "capture"]
                 and (resumed is None or resumed["bitwise"])
                 and set(kinds[2:]) == {"replay"}
                 and all(r["counts_match"] for r in timing.values()))
    del tg, te, sg, se
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_graphs_phase(torch, ak, fk, corpus: dict, root: str) -> dict:
    """``[train-graphs]``: on the seeded flagship (both kernels), graphed
    against eager (:func:`graph_twins`) for run (b)'s train step (batch
    8, dropout 0) in bf16 and f32, run (a)'s (bf16, batch 32, dropout and
    attention dropout 0.1, remat: the kernels stay out of the train step,
    as in JAX; also resumed from a step checkpoint taken mid-run), an
    accumulation step of two 4-row microbatches with
    --grad-clip and remat (run (b)'s settings otherwise: the kernels
    launch in the forward and again in the recomputation, from autograd's
    device thread) and an eval step (batch 8)."""
    import copy
    from mtn_tpu_torch.config import TrainConfig, config_from_dict
    from mtn_tpu_torch.train.batch import device_batch
    from mtn_tpu_torch.weights import load_checkpoint
    conf, hb8 = train_batch(corpus, corpus["prefix"], 8)
    _, hb32 = train_batch(corpus, corpus["prefix"], 32)
    sd = load_checkpoint(corpus["prefix"])[0]
    base = config_from_dict("model", conf["model"])
    base.use_pallas_attention = base.use_pallas_ffn = True
    base.dropout = base.attn_dropout = 0.0

    def cfg(dtype="bfloat16", **kw):
        c = copy.deepcopy(base)
        c.dtype = dtype
        for k, v in kw.items():
            setattr(c, k, v)
        return c
    tcfg = TrainConfig(warmup_steps=WARMUP)
    train = lambda tr, state, b: tr.train_step(state, b, 1)[1]
    accum = lambda tr, state, b: tr.train_step_accum(state, b, 1)[1]

    def evaluate(tr, state, b):
        tr.load(state.params)
        return tr.eval_step(b)
    cases = {
        "b_bf16": (cfg(), tcfg, device_batch(hb8, "cuda", "bfloat16"),
                   train),
        "b_f32": (cfg("float32"), tcfg, device_batch(hb8, "cuda",
                                                     "float32"), train),
        "a_bf16": (cfg(dropout=0.1, attn_dropout=0.1, remat=True), tcfg,
                   device_batch(hb32, "cuda", "bfloat16"), train),
        "accum_bf16": (cfg(remat=True), TrainConfig(
            warmup_steps=WARMUP, grad_clip=TRAIN_GRAPH_CLIP),
                       [device_batch(host_rows(hb8, lo, 4), "cuda",
                                     "bfloat16") for lo in (0, 4)], accum),
        "eval_bf16": (cfg(), tcfg, device_batch(hb8, "cuda", "bfloat16"),
                      evaluate),
    }
    out = {}
    for name, (c, t, b, step) in cases.items():
        t0 = time.time()
        out[name] = graph_twins(
            torch, ak, fk, c, t, sd, b, step,
            os.path.join(root, "train_graphs", "mtn") if name == "a_bf16"
            else None)
        out[name]["seconds"] = time.time() - t0
    seen = out["b_bf16"]["graphed"]["kernel_launches_seen"]
    out["kernels_in_replays"] = (isinstance(seen, dict)
                                 and min(seen.values()) > 0)
    out["ok"] = out["kernels_in_replays"] and all(
        v["ok"] for k, v in out.items() if isinstance(v, dict))
    return out


# -- --train-traffic: stage 2 over the many step shapes of varied lengths ---
TRAFFIC_DIALOGS = (400, 100)   # train, valid; 10 turns each
TRAFFIC_EPOCHS = 3
TRAFFIC_BOUND = 8              # the bound the policy also runs at, below
                               # the shapes' count


def traffic_dialogs(rng, prefix: str, n: int):
    """``n`` dialogs in DSTC7-AVSD's layout (10 question-answer turns, a
    caption and a summary a video) whose lengths vary as that data's do,
    and each video's (I3D, VGGish) frame counts: words a question ~
    lognormal(ln 7.5, 0.35) in [3, 30], an answer ~ lognormal(ln 9,
    0.55) in [1, 45], a caption ~ lognormal(ln 16, 0.4) in [5, 60] and a
    summary ~ lognormal(ln 17, 0.45) in [5, 70]; I3D frames uniform in
    [40, 80] and VGGish in [20, 40], as ``scripts/make_synth_dstc7.py``
    draws them. Words are the flagship vocabulary's 6000, the captions
    and summaries running through all of them in turn."""
    import numpy as np
    words = np.array([f"w{i}" for i in range(FLAGSHIP["vocab_size"] - 4)])
    at = [0]

    def say(mu, sigma, lo, hi, cover=False):
        k = int(np.clip(np.round(rng.lognormal(np.log(mu), sigma)), lo, hi))
        if cover:
            idx = (at[0] + np.arange(k)) % len(words)
            at[0] += k
        else:
            idx = rng.integers(0, len(words), k)
        return " ".join(words[idx])
    out, frames = [], {}
    for d in range(n):
        vid = f"{prefix}{d:05d}"
        out.append({"image_id": vid,
                    # a trailing space keeps caption + summary apart
                    "caption": say(16, 0.4, 5, 60, True) + " ",
                    "summary": say(17, 0.45, 5, 70, True) + " ",
                    "dialog": [{"question": say(7.5, 0.35, 3, 30),
                                "answer": say(9, 0.55, 1, 45)}
                               for _ in range(10)]})
        frames[vid] = (int(rng.integers(40, 81)), int(rng.integers(20, 41)))
    return out, frames


def write_traffic_corpus(root: str, seed: int = 1) -> dict:
    """Train and valid sets of TRAFFIC_DIALOGS :func:`traffic_dialogs`
    and their .npy features at the flagship width."""
    import numpy as np
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    corpus = {"fea_types": ["i3d_rgb", "vggish"],
              "fea_path": os.path.join(root, "<FeaType>", "<ImageID>.npy")}
    frames = {}
    for name, prefix, n in (("train_set", "tt", TRAFFIC_DIALOGS[0]),
                            ("valid_set", "tv", TRAFFIC_DIALOGS[1])):
        ds, fr = traffic_dialogs(rng, prefix, n)
        frames.update(fr)
        corpus[name] = os.path.join(root, name + ".json")
        with open(corpus[name], "w") as f:
            json.dump({"type": "test", "version": "0.1", "dialogs": ds}, f)
    for j, (ftype, dim) in enumerate(zip(corpus["fea_types"],
                                         FLAGSHIP["ft_sizes"])):
        os.makedirs(os.path.join(root, ftype))
        for vid, fr in frames.items():
            np.save(os.path.join(root, ftype, vid + ".npy"),
                    rng.standard_normal((fr[j], dim)).astype(np.float32))
    return corpus


def traffic_shapes(root: str, n_dialogs: dict, seed: int = 2) -> dict:
    """The step shapes stage 2 would meet on :func:`traffic_dialogs` at
    ``n_dialogs`` (split -> dialogs; DSTC7-AVSD has 7,659 train and 1,787
    valid dialogs), from the train CLI's own batch plans (batch 32,
    ``--max-length 256``, buckets of 32) on the host, without features
    on disk: each split's batches and distinct shapes, and the share of
    train steps the most frequent 8, 16, 32, 64 and 128 shapes take."""
    import collections

    import numpy as np
    from mtn_tpu_torch.data.batching import _round_up, make_batch_indices
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.data.vocab import get_vocabulary
    rng = np.random.default_rng(seed)
    out = {}
    for split, n in n_dialogs.items():
        ds, frames = traffic_dialogs(rng, split[:2], n)
        path = os.path.join(root, f"shapes_{split}.json")
        with open(path, "w") as f:
            json.dump({"dialogs": ds}, f)
        vocab = get_vocabulary(path, cutoff=0,
                               include_caption="caption,summary")
        data = load(None, "", path, vocab, include_caption="caption,summary",
                    separate_caption=True)
        data.features = _Frames(frames)
        plans, _ = make_batch_indices(data, 32, max_length=256,
                                      separate_caption=True)
        r = lambda n: _round_up(n, 32)
        count = collections.Counter(
            (p.n_seqs, r(p.h_len), r(p.q_len), r(p.a_len), r(p.c_len),
             tuple(r(x) for x in p.x_len)) for p in plans)
        top = sorted(count.values(), reverse=True)
        out[split] = dict(dialogs=n, batches=len(plans), shapes=len(count),
                          once=sum(c == 1 for c in top),
                          top_share={k: sum(top[:k]) / len(plans)
                                     for k in (8, 16, 32, 64, 128)})
    return out


class _Frames:
    """Frame counts by video, as a feature registry gives them."""

    def __init__(self, frames: dict):
        self.frames = frames

    def __len__(self) -> int:
        return 2

    def n_frames(self, stream: int, vid: str) -> int:
        return self.frames[vid][stream]


def vm_rss() -> int:
    """This process's resident host bytes."""
    with open("/proc/self/status") as f:
        kb = next(line.split()[1] for line in f
                  if line.startswith("VmRSS:"))
    return int(kb) * 1024


def traffic_run(torch, corpus: dict, root: str, name: str,
                bound=None, eager: bool = False) -> dict:
    """One ``cli.train`` run of stage 2 at run.sh's settings (batch 32,
    dropout 0.1, remat, cut_a, lengths and frames in buckets of 32, no
    ``--uniform-shapes``) for TRAFFIC_EPOCHS epochs, its steps graphed
    (with ``bound``: at most that many sets kept) or ``eager``: each
    epoch's train and validation wall seconds, the step programs'
    counts with the sets rebuilt (built again after their eviction) and
    the seconds spent capturing, the card's peak reserved bytes and the
    host's resident bytes at each epoch's end, the losses and the last
    epoch's checkpoint."""
    from mtn_tpu_torch.cli import train as train_cli
    from mtn_tpu_torch.decode.graphs import ProgramCache
    from mtn_tpu_torch.train import graphs
    from mtn_tpu_torch.train.trainer import Trainer
    from mtn_tpu_torch.weights import load_checkpoint
    prefix = os.path.join(root, name, "mtn")
    epochs, built, capture_s = [], [], [0.0]
    orig_epoch, orig_graphed = Trainer.run_epoch, Trainer.graphed
    orig_set, orig_bound = graphs.StepGraphs._set, graphs.MAX_PROGRAMS

    def run_epoch(tr, state, batches, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_epoch(tr, state, batches, *args, **kwargs)
        torch.cuda.synchronize()
        epochs.append(dict(train=kwargs.get("train", True),
                           seconds=time.perf_counter() - t0,
                           reserved_peak=torch.cuda.max_memory_reserved(),
                           host_rss=vm_rss(), sets=len(tr.graphs.sets)))
        return out

    def step_set(sg, key, make):
        n = sg.captures
        with capture_seconds() as seconds:
            ps = ProgramCache._set(sg, key, make)
        if sg.captures > n:
            built.append(key)
            capture_s[0] += sum(seconds)
        return ps
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rss0 = vm_rss()
    Trainer.run_epoch = run_epoch
    graphs.StepGraphs._set = step_set
    if eager:
        Trainer.graphed = lambda tr, t: False
    if bound is not None:
        graphs.MAX_PROGRAMS = bound
    t0 = time.time()
    try:
        with graph_runners(graphs.StepGraphs) as runners:
            rc = train_cli.main(train_argv(
                corpus, prefix, "--batch-size", "32", "--cut-a", "1",
                "--remat", "1", "--num-epochs", str(TRAFFIC_EPOCHS)))
            torch.cuda.synchronize()
    finally:
        Trainer.run_epoch, Trainer.graphed = orig_epoch, orig_graphed
        graphs.StepGraphs._set, graphs.MAX_PROGRAMS = orig_set, orig_bound
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"traffic run {name}: exit code {rc}")
    counts = runner_counts(runners)
    counts["eval_shapes"] = counts["shapes"] - counts["train_shapes"]
    counts["rebuilt"] = len(built) - len(set(built))
    counts["capture_s"] = capture_s[0]
    del runners
    rows = read_csv(prefix + "_train.csv")
    return dict(run=name, bound=bound if bound is not None else (
        None if eager else graphs.MAX_PROGRAMS), eager=eager, wall_s=wall,
                steps=len(rows), epochs=epochs, host_rss_start=rss0,
                step_programs=counts,
                losses=[r["loss"] for r in rows],
                checkpoint=load_checkpoint(prefix, "latest")[0])


def train_traffic(torch, root: str) -> dict:
    """``chip_smoke.py --train-traffic``: stage 2 on a corpus of varied
    lengths (:func:`write_traffic_corpus`, more step shapes than
    TRAFFIC_BOUND), three ways from the same seed: graphed under the
    trainer's own bound, graphed at TRAFFIC_BOUND (the admission policy
    at work), eager. Every run's losses and last checkpoint must be
    bitwise the eager run's."""
    plans = traffic_shapes(root, {"train": 7659, "valid": 1787})
    corpus = write_traffic_corpus(os.path.join(root, "traffic"))
    runs = {"graphed": traffic_run(torch, corpus, root, "graphed"),
            "bounded": traffic_run(torch, corpus, root, "bounded",
                                   bound=TRAFFIC_BOUND),
            "eager": traffic_run(torch, corpus, root, "eager", eager=True)}
    ref = runs["eager"]
    for r in runs.values():
        r["bitwise_eager"] = r["losses"] == ref["losses"] and all(
            torch.equal(t, ref["checkpoint"][k])
            for k, t in r["checkpoint"].items())
    for r in runs.values():
        del r["losses"], r["checkpoint"]
    shapes = runs["graphed"]["step_programs"]
    out = dict(dstc7_scale_plans=plans, runs=runs,
               ok=all(r["bitwise_eager"] for r in runs.values())
               and shapes["shapes"] > TRAFFIC_BOUND
               and shapes["train_shapes"] > TRAFFIC_BOUND)
    return out


# -- [parallel]: the (data, model) mesh over torch.distributed ranks ---------
PAR_STEPS = 2            # bf16 train steps at run (b)'s settings
PAR_LOSS_TOL = 1e-3      # a mesh's step loss against one process's, relative
PAR_F32_TOL = 1e-3       # f32 n-best scores, model-parallel vs one process
PAR_MARGIN = {"bfloat16": 0.1, "float32": 1e-3}  # a 1-best margin below
#   this is a near tie (bf16: one rounding of each step's log-probs, ~1e-2,
#   summed over the steps; f32: the sums over ranks in another order)
PAR_LOGP_TOL = 2 ** -4   # bf16: a 1x2 step's log-probs against one
#   process's on the same hypothesis: one bf16 step of a logit below 16
PAR_TIMEOUT_S = 600
PAR_DECODE = dict(maxlen=30, beam=5, nbest=5, penalty=1.0, turn_batch=32)
# a 1x2 decode traced with attention and the FFN replicated: their sums
# taken in another order are what part a beam from one process's (sharding
# rule words; the head, attention or FFN alone replicated left beams
# parting in PR 10's runs)
PAR_REPLICATED = {"attention_ffn": ("w_q", "w_o", "w_1", "w_2")}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_shapes(seen) -> dict:
    """Calls per kernel and shape of a ``record_launches`` run, labelled
    with the heads of attention and the d_ff of the FFN."""
    calls = {}
    for (name, *shapes), rec in seen.items():
        if name == "attention":
            B, H, Lq, _ = shapes[0]
            label = f"attention B{B} H{H} Lq{Lq} Lk{shapes[1][2]}"
        elif name == "norm":
            label = norm_label(shapes)
        else:
            label = f"ffn N{shapes[0][0]} F{shapes[1][1]}" + (
                " f32 out" if rec["args"][5] else "")
        calls[label] = calls.get(label, 0) + rec["calls"]
    return calls


def traced_beam(dec, db):
    """``dec.beam_batch(db)`` through the eager loop with every step kept
    on the host: the carry going in, the step's log-probs and the carry
    coming out. The decoder's own eager loop runs (a rank under a mesh
    runs no other); ``decode.beam.beam_step`` is wrapped for the call."""
    import mtn_tpu_torch.decode.beam as beam_mod
    orig, steps = beam_mod.beam_step, []

    def kept_step(step, l, tok_buf, scores, comp_scores, *rest):
        rec = dict(tok_in=tok_buf.cpu(), scores_in=scores.cpu(),
                   comp_in=comp_scores.cpu())

        def kept(cur, pos, kv):
            logp, kv = step(cur, pos, kv)
            rec["logp"] = logp.float().cpu()
            return logp, kv
        out = orig(kept, l, tok_buf, scores, comp_scores, *rest)
        rec.update(tok_out=out[0].cpu(), comp_out=out[2].cpu(),
                   comp_buf_out=out[3].cpu())
        steps.append(rec)
        return out
    beam_mod.beam_step = kept_step
    try:
        res = dec.beam_results(dec.beam_eager(db),
                               dec.gather_rows(db.valid))
    finally:
        beam_mod.beam_step = orig
    return [[r.tokens, r.scores] for r in res], steps


def trace_compare(torch, a, b, cfg) -> dict:
    """Two step traces (:func:`traced_beam`) of one beam decode: ``a``
    one process's, ``b`` a mesh's. A turn's step has the same inputs in
    both while the turn's beams and n-best pools have been equal as sets;
    on those steps each hypothesis' log-probs are compared over the whole
    vocabulary, and so are its scores. The first step whose output
    differs is the turn's divergence: there ``a``'s decision gap (the
    last candidate kept against the first dropped, in the beam and in
    the n-best pool) must lie within twice the largest difference of a
    candidate's score between the runs (score plus log-prob), or the
    parting is not a near tie flipped by roundings."""
    from mtn_tpu_torch.data.vocab import SPECIALS
    eos, unk = SPECIALS["<eos>"], SPECIALS["<unk>"]
    beam, nbest = cfg.beam, cfg.nbest
    turns = a[0]["tok_in"].shape[0]
    T = min(len(a), len(b))
    finite = -1e29

    def pool(step, turn):
        return sorted(tuple(r) for r, sc in zip(
            step["comp_buf_out"][turn].tolist(),
            step["comp_out"][turn].tolist()) if sc > finite)

    alike, pairs, parted = set(range(turns)), [], []
    for t in range(T):
        ha = a[t]["tok_in"][:, :, :t + 1].tolist()
        hb = b[t]["tok_in"][:, :, :t + 1].tolist()
        for turn in sorted(alike):
            rows = {}
            for k, h in enumerate(hb[turn]):
                rows.setdefault(tuple(h), []).append(k)
            for k, h in enumerate(ha[turn]):
                pairs.append((t, turn * beam + k,
                              turn * beam + rows[tuple(h)].pop(0)))
            outs = [sorted(tuple(r) for r in x[t]["tok_out"][turn][
                :, :t + 2].tolist()) for x in (a, b)]
            if outs[0] != outs[1] or pool(a[t], turn) != pool(b[t], turn):
                parted.append((turn, t))
                alike.discard(turn)
    A = torch.stack([x["logp"] for x in a[:T]])
    Bt = torch.stack([x["logp"] for x in b[:T]])
    Sa = torch.stack([x["scores_in"].reshape(-1) for x in a[:T]])
    Sb = torch.stack([x["scores_in"].reshape(-1) for x in b[:T]])
    ti, ra, rb = (torch.tensor(v) for v in zip(*pairs))
    dl = (A[ti, ra] - Bt[ti, rb]).abs().amax(dim=1)
    ds = (Sa[ti, ra] - Sb[ti, rb]).abs()
    rows = []
    for turn, t in parted:
        sel = (ti == t) & (ra // beam == turn)
        diff = float((dl[sel] + ds[sel]).max())
        s_in = Sa[t, turn * beam:(turn + 1) * beam]
        lp = A[t, turn * beam:(turn + 1) * beam]
        cand = s_in[:, None] + lp
        cand[:, [eos, unk]] = -float("inf")
        v = cand.reshape(-1).topk(beam + 1).values
        gaps = [float(v[beam - 1] - v[beam])]
        eos_sc = s_in + lp[:, eos] + cfg.penalty * (t + 1)
        if t < cfg.min_len:
            eos_sc = torch.full_like(eos_sc, -float("inf"))
        p = torch.cat([a[t]["comp_in"][turn], eos_sc]).sort(
            descending=True).values
        if p[nbest] > finite:
            gaps.append(float(p[nbest - 1] - p[nbest]))
        rows.append(dict(turn=turn, step=t, gap=min(gaps), score_diff=diff,
                         explained=min(gaps) <= 2 * diff))
    return dict(steps=T, row_steps=len(pairs),
                logp_max_abs_diff=float(dl.max()),
                logp_bitwise_share=float((dl == 0).float().mean()),
                score_max_abs_diff=float(ds.max()),
                turns_parted=len(parted), parted=rows,
                explained=all(r["explained"] for r in rows))


def counted_run(torch, ak, fk, fn):
    """``fn()`` with both kernels' counts set to 0 just before it: its
    result, and its seconds, launches by kernel and by shape."""
    box = []
    zero_launches()
    t0 = time.time()
    seen = record_launches(ak, fk, lambda: box.append(fn()))
    torch.cuda.synchronize()
    return box[0], dict(
        seconds=time.time() - t0,
        launches=launch_counts(),
        shapes=launch_shapes(seen))


def host_rows(hb, lo: int, n: int):
    """Rows ``[lo, lo + n)`` of a host batch."""
    import dataclasses
    cut = lambda a: None if a is None else a[lo:lo + n]
    return dataclasses.replace(
        hb, query=cut(hb.query), his=cut(hb.his), cap=cut(hb.cap),
        answer_in=cut(hb.answer_in), answer_out=cut(hb.answer_out),
        fts=[cut(f) for f in hb.fts], fts_len=[cut(l) for l in hb.fts_len],
        valid=cut(hb.valid), qa_ids=cut(hb.qa_ids))


def mask_draws(torch, shardings, dev, rows: int = 8) -> dict:
    """``sharded_dropout``'s mask over a batch-8 FFN hidden activation
    (32 tokens, d_ff 2048, bf16) on the card's generator: this data
    rank's draw against its rows of the whole batch's, bitwise; in one
    process, whether ``F.dropout`` (CUDA's fused kernel) draws the same
    bits as the law the port uses."""
    from mtn_tpu_torch.parallel.collectives import sharded_dropout
    data = shardings.data if shardings is not None else None
    n = rows // (data.size if data is not None else 1)
    lo = (data.rank if data is not None else 0) * n

    def draw(r, fn):
        torch.manual_seed(7)
        return fn(torch.ones(r, 32, 2048, device=dev, dtype=torch.bfloat16))

    def law(axis):
        return lambda x: sharded_dropout(x, 0.1, True, data=axis)
    whole = draw(rows, law(None))
    out = dict(rows_bitwise=bool(torch.equal(draw(n, law(data)),
                                             whole[lo:lo + n])),
               kept_share=whole.ne(0).float().mean().item())
    if data is None:
        out["f_dropout_same_bits"] = bool(torch.equal(whole, draw(
            rows, lambda x: torch.nn.functional.dropout(x, 0.1, True))))
    return out


def parallel_work(torch, ak, fk, corpus: dict, shardings, dev,
                  f32: bool, trace: bool = False) -> dict:
    """At the flagship width, both kernels on, the seeded weights:
    PAR_STEPS bf16 train steps at run (b)'s settings (batch 8, dropout 0)
    and one 32-turn beam decode with the main path's flags, under
    ``shardings`` (None: one process); with ``f32`` the decode again in
    f32. Each part's launches by kernel and by shape, counted from 0
    just before it. With ``trace`` the bf16 decode once more, traced
    step by step (:func:`traced_beam`), and under a model axis also with
    each group of PAR_REPLICATED replicated (the other layers sharded).
    Without a model axis also: one step at dropout and attention dropout
    0.1, one update from the batch's two 4-row halves
    (``train_step_accum``), and :func:`mask_draws`."""
    import copy
    from mtn_tpu_torch.config import DecodeConfig, TrainConfig
    from mtn_tpu_torch.decode.beam import BeamDecoder
    from mtn_tpu_torch.train.batch import to_device_fn
    from mtn_tpu_torch.train.trainer import Trainer
    from mtn_tpu_torch.weights import load_model

    _, thb = train_batch(corpus, corpus["prefix"], 8)
    dhb, _, _, cfg, sd = flagship_batch(corpus, 32)
    cfg.use_pallas_attention = cfg.use_pallas_ffn = True
    cfg.dropout = cfg.attn_dropout = 0.0
    to_device = to_device_fn("bfloat16", shardings, dev)

    def trainer(dropout=0.0):
        c = copy.deepcopy(cfg)
        c.dropout = c.attn_dropout = dropout
        return Trainer(c, TrainConfig(warmup_steps=WARMUP), dev,
                       shardings=shardings)

    def dropout_step():
        tr = trainer(0.1)
        return tr.train_step(tr.state_from(sd), to_device(thb), 1)[1][
            "loss"].item()

    def accum_step():
        tr = trainer()
        micro = [to_device(host_rows(thb, lo, 4)) for lo in (0, 4)]
        return tr.train_step_accum(tr.state_from(sd), micro, 1)[1][
            "loss"].item()

    def train():
        tr = Trainer(copy.deepcopy(cfg), TrainConfig(warmup_steps=WARMUP),
                     dev, shardings=shardings)
        state = tr.state_from(sd)
        db = to_device_fn("bfloat16", shardings, dev)(thb)
        losses = []
        for _ in range(PAR_STEPS):
            state, m = tr.train_step(state, db, 1)
            losses.append(m["loss"].item())
        return losses

    def decoder(dtype, sh):
        c = copy.deepcopy(cfg)
        c.dtype = dtype
        model = load_model(c, sd, dev)
        if sh is not None:
            sh.shard_model(model)
        dec = BeamDecoder(model, DecodeConfig(**PAR_DECODE), shardings=sh)
        return dec, to_device_fn(dtype, sh, dev)(dhb)

    def decode(dtype):
        dec, db = decoder(dtype, shardings)
        return [[r.tokens, r.scores] for r in dec.beam_batch(db)]

    out = {}
    out["losses"], out["train"] = counted_run(torch, ak, fk, train)
    out["nbest"], out["decode"] = counted_run(torch, ak, fk,
                                              lambda: decode("bfloat16"))
    if shardings is None or shardings.model is None:
        out["dropout_loss"] = dropout_step()
        out["accum_loss"], out["accum"] = counted_run(torch, ak, fk,
                                                      accum_step)
        out["masks"] = mask_draws(torch, shardings, dev)
    if f32:
        out["nbest_f32"], out["decode_f32"] = counted_run(
            torch, ak, fk, lambda: decode("float32"))
    if trace:
        out["nbest_traced"], out["trace"] = traced_beam(
            *decoder("bfloat16", shardings))
        if shardings is not None and shardings.model is not None:
            from mtn_tpu_torch.parallel import Shardings, default_rules
            for name, words in PAR_REPLICATED.items():
                rep = Shardings(shardings.mesh, rules=[
                    r for r in default_rules()
                    if not any(w in r[0] for w in words)])
                out[f"nbest_{name}_replicated"], \
                    out[f"trace_{name}_replicated"] = traced_beam(
                        *decoder("bfloat16", rep))
    torch.cuda.empty_cache()
    return out


def parallel_rank(rank: int, world: int, port: int, mesh: str,
                  corpus: dict, out_dir: str, f32: bool,
                  device: str = "cuda") -> None:
    """One rank of a ``mesh`` ("DxM") world of ``world`` processes on
    cuda:0 over gloo (NCCL puts one rank on a device): joins through the
    port's Python API and writes :func:`parallel_work`'s result."""
    import torch
    from mtn_tpu_torch.ops import attention_kernel as ak
    from mtn_tpu_torch.ops import ffn_kernel as fk
    from mtn_tpu_torch.parallel import Shardings, make_mesh, multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = multihost.initialize(f"localhost:{port}", world, rank,
                               device=device, backend="gloo")
    data, model = (int(v) for v in mesh.split("x"))
    sh = Shardings(make_mesh(data=data, model=model, device_type=dev.type))
    res = parallel_work(torch, ak, fk, corpus, sh, dev, f32, trace=f32)
    for key in [k for k in res if k.startswith("trace")]:
        trace = res.pop(key)   # step traces go to files of their own
        if rank == 0:
            torch.save(trace, os.path.join(out_dir,
                                           f"parallel_{mesh}_{key}.pt"))
    res.update(rank=rank, device=str(dev),
               backend=torch.distributed.get_backend())
    with open(os.path.join(out_dir, f"parallel_{mesh}_r{rank}.json"),
              "w") as f:
        json.dump(res, f)
    multihost.shutdown()


def spawn_ranks(mesh: str, corpus: dict, out_dir: str, f32: bool,
                device: str = "cuda", target=None, prefix: str = "parallel"):
    """The ranks of ``mesh`` as processes started with ``spawn``
    (``target``: :func:`parallel_rank`, or :func:`serve_rank`, which
    takes no ``f32``), each writing ``<prefix>_<mesh>_r<rank>.json``;
    fails if one raises (a non-zero exit) or all have not ended within
    PAR_TIMEOUT_S."""
    import torch.multiprocessing as mp
    d, m = (int(v) for v in mesh.split("x"))
    world = d * m
    args = (world, free_port(), mesh, corpus, out_dir) + (
        (f32, device) if target is None else (device,))
    ctx = mp.start_processes(target or parallel_rank, nprocs=world,
                             join=False, start_method="spawn", args=args)
    t0 = time.time()
    while not ctx.join(timeout=5):
        if time.time() - t0 > PAR_TIMEOUT_S:
            for p in ctx.processes:
                p.terminate()
            raise AssertionError(f"[{prefix}] {mesh}: the ranks did not "
                                 f"end within {PAR_TIMEOUT_S} s")
    out = []
    for r, p in enumerate(ctx.processes):
        with open(os.path.join(out_dir, f"{prefix}_{mesh}_r{r}.json")) as f:
            out.append(dict(json.load(f), exitcode=p.exitcode))
    return out


def compare_nbest(got, want, margin: float) -> dict:
    """Row by row: a row whose 1-best margin in ``want`` exceeds
    ``margin`` must decode the same n-best tokens; a near-tied row's
    1-best must be one of ``want``'s hypotheses within ``margin`` of its
    1-best. Also whether the two are equal bit for bit, and the largest
    score difference over hypotheses decoded alike."""
    robust = diff = 0
    ok = len(got) == len(want)
    max_score = 0.0
    for (gt, gs), (wt, ws) in zip(got, want):
        m = ws[0] - ws[1] if len(ws) > 1 else float("inf")
        if m > margin:
            robust += 1
            ok &= gt == wt
        else:
            ok &= gt[0] in [t for t, sc in zip(wt, ws) if ws[0] - sc <= margin]
        diff += gt != wt
        for a, sa in zip(gt, gs):
            if a in wt:
                max_score = max(max_score, abs(sa - ws[wt.index(a)]))
    return dict(ok=bool(ok), bitwise=got == want, rows=len(want),
                robust_rows=robust, rows_differing=diff,
                max_score_diff=max_score)


def nccl_world_of_one(corpus: dict, root: str, main_out: str) -> dict:
    """``python -m mtn_tpu_torch.cli.generate --multihost
    localhost:PORT,1,0``: the main path's decode in a NCCL world of one,
    its result JSON against ``[main]``'s bytes."""
    out = os.path.join(root, "result_nccl.json")
    argv = [sys.executable, "-m", "mtn_tpu_torch.cli.generate",
            *generate_argv(corpus, corpus["prefix"], out, *BEAM_FLAGS),
            "--multihost", f"localhost:{free_port()},1,0"]
    t0 = time.time()
    proc = subprocess.run(argv, cwd=HERE, capture_output=True, text=True,
                          timeout=PAR_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"[parallel] NCCL world of one exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    joined = [l for l in proc.stderr.splitlines()
              if "joined the process group" in l]
    with open(out, "rb") as a, open(main_out, "rb") as b:
        same = a.read() == b.read()
    return dict(seconds=time.time() - t0, log=joined[-1] if joined else None,
                nccl="backend nccl" in "".join(joined),
                bitwise_equal_to_main=same)


def parallel_phase(torch, ak, fk, corpus: dict, root: str,
                   main_out: str) -> dict:
    """The parallel layer on one card: a NCCL world of one through the
    real CLI, then two ranks on cuda:0 over gloo as a 2x1 (data) and a
    1x2 (model) mesh, each against the same work in this process. Two
    ranks on one card stage every collective through the host: none of
    these times is a figure of multi-GPU scaling."""
    from mtn_tpu_torch.config import DecodeConfig
    res = {"nccl_world_of_one": nccl_world_of_one(corpus, root, main_out)}
    t0 = time.time()
    single = parallel_work(torch, ak, fk, corpus, None, torch.device("cuda"),
                           f32=True, trace=True)
    res["single"] = dict(
        losses=single["losses"], train=single["train"],
        decode=single["decode"], dropout_loss=single["dropout_loss"],
        accum_loss=single["accum_loss"], masks=single["masks"],
        seconds=time.time() - t0)
    ok = res["nccl_world_of_one"]["nccl"] and \
        res["nccl_world_of_one"]["bitwise_equal_to_main"]
    for mesh in ("2x1", "1x2"):
        t0 = time.time()
        ranks = spawn_ranks(mesh, corpus, root, f32=mesh == "1x2")
        r0 = ranks[0]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                      single["losses"]))
        row = dict(
            seconds=time.time() - t0, backend=r0["backend"],
            devices=[r["device"] for r in ranks],
            losses=[r["losses"] for r in ranks],
            losses_equal_across_ranks=all(r["losses"] == r0["losses"]
                                          for r in ranks),
            loss_rel_diff=rel,
            nbest_equal_across_ranks=all(r["nbest"] == r0["nbest"]
                                         for r in ranks),
            nbest=compare_nbest(r0["nbest"], single["nbest"],
                                PAR_MARGIN["bfloat16"]),
            train=[r["train"] for r in ranks],
            decode=[r["decode"] for r in ranks])
        good = row["losses_equal_across_ranks"] and rel <= PAR_LOSS_TOL \
            and row["nbest_equal_across_ranks"]
        for r in ranks:
            for part in ("train", "decode"):
                good &= all_launched(r[part]["launches"], part == "train")
        if mesh == "2x1":
            good &= row["nbest"]["ok"]
            # every rank draws the whole batch's dropout masks and keeps
            # its rows (JAX's one key): each rank's rows of the masks bit
            # for bit, and so one process's step (the loss's sum over the
            # ranks may take another order: within PAR_LOSS_TOL, its bits
            # reported); an update from two microbatches: the one big
            # batch's
            row.update(
                dropout_losses=[r["dropout_loss"] for r in ranks],
                dropout_bitwise=all(r["dropout_loss"] ==
                                    single["dropout_loss"] for r in ranks),
                dropout_rel_diff=abs(r0["dropout_loss"]
                                     - single["dropout_loss"])
                / abs(single["dropout_loss"]),
                masks=[r["masks"] for r in ranks],
                accum_losses=[r["accum_loss"] for r in ranks],
                accum_rel_diff=abs(r0["accum_loss"] - single["losses"][0])
                / abs(single["losses"][0]),
                accum=[r["accum"] for r in ranks])
            good &= row["dropout_rel_diff"] <= PAR_LOSS_TOL and \
                all(r["dropout_loss"] == r0["dropout_loss"]
                    for r in ranks) and \
                all(m["rows_bitwise"] for m in row["masks"]) and \
                row["accum_rel_diff"] <= PAR_LOSS_TOL and \
                all(r["accum_loss"] == r0["accum_loss"] for r in ranks)
        if mesh == "1x2":
            # the n-best margin-aware is reported, not held: a beam can
            # part at a near tie inside the search that its final margin
            # does not show; the traces hold each parting to the rounding
            dcfg = DecodeConfig(**PAR_DECODE)
            for name in [""] + [f"_{k}_replicated" for k in PAR_REPLICATED]:
                got = torch.load(os.path.join(
                    root, f"parallel_{mesh}_trace{name}.pt"),
                    weights_only=False)
                row["trace" + name] = trace_compare(torch, single["trace"],
                                                    got, dcfg)
                row["trace" + name]["nbest"] = compare_nbest(
                    r0["nbest" + (name or "_traced")], single["nbest"],
                    PAR_MARGIN["bfloat16"])
                del got
            row["traced_equal_untraced"] = \
                r0["nbest_traced"] == r0["nbest"] and \
                single["nbest_traced"] == single["nbest"]
            # the cause: with attention and the FFN replicated (their f32
            # sums in one process's order) the decode is one process's
            good &= row["traced_equal_untraced"] and \
                row["trace"]["logp_max_abs_diff"] <= PAR_LOGP_TOL and \
                row["trace"]["explained"] and \
                row["trace_attention_ffn_replicated"]["nbest"]["bitwise"] \
                and row["trace_attention_ffn_replicated"][
                    "logp_bitwise_share"] == 1.0
            f32 = compare_nbest(r0["nbest_f32"], single["nbest_f32"],
                                PAR_MARGIN["float32"])
            row["nbest_f32"] = f32
            row["decode_f32"] = [r["decode_f32"] for r in ranks]
            good &= f32["ok"] and f32["max_score_diff"] <= PAR_F32_TOL
            labels = [k for r in ranks for part in ("train", "decode")
                      for k in r[part]["shapes"]]
            row["shard_shapes_only"] = all(map(on_model_shard, labels))
            good &= row["shard_shapes_only"]
        row["ok"] = bool(good)
        res[mesh] = row
        ok &= row["ok"]
    res["ok"] = bool(ok)
    return res


def main() -> int:
    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke run "
                    "needs an NVIDIA GPU")
    try:
        from mtn_tpu_torch.ops import _build
        from mtn_tpu_torch.ops import attention_kernel as ak
        from mtn_tpu_torch.ops import ffn_kernel as fk
        from mtn_tpu_torch.ops import norm_kernel as nk
        from mtn_tpu_torch.cli import generate
    except ImportError as e:
        return fail(f"mtn_tpu_torch is not importable (run from the repo "
                    f"root): {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    phase_s = {}
    t_phase = t0 = time.time()
    from mtn_tpu_torch.data import native_loader
    from mtn_tpu_torch.ops import graph_loop
    logs = _build.build_all([ak.KERNEL, fk.KERNEL, nk.KERNEL,
                             graph_loop.LIBRARY, native_loader.LIBRARY])
    print(f"[build] {time.time() - t0:.1f}s")
    for log in logs:
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                        "spill", "error")):
                print("[build] " + line.strip())
    if sys.argv[1:] == ["--train-traffic"]:
        with tempfile.TemporaryDirectory() as root:
            traffic = train_traffic(torch, root)
        print(f"[train-traffic] plans at DSTC7-AVSD's scale: "
              f"{json.dumps(traffic.pop('dstc7_scale_plans'))}")
        for name, row in traffic.pop("runs").items():
            print(f"[train-traffic] {name} {json.dumps(row)}")
        print(f"[train-traffic] {card}")
        if not traffic["ok"]:
            return fail("train-traffic: a graphed run differs from the "
                        "eager one, or the corpus brought too few shapes")
        return 0

    gen = torch.Generator().manual_seed(0)
    rows = []
    for dtype_name in ("float32", "bfloat16"):
        rows += attention_cases(torch, ak, dtype_name, gen)
        rows += ffn_cases(torch, fk, dtype_name, gen)
    bad = []
    for r in rows:
        print("[kernel] " + json.dumps(r))
        if not r["max_abs_err"] <= r["tol"]:
            bad.append(r)
    if bad:
        return fail(f"{len(bad)} kernel case(s) outside tolerance")
    grads = []
    for dtype_name in ("float32", "bfloat16"):
        grads += grad_cases(torch, ak, fk, dtype_name, gen)
    for r in grads:
        print("[grad] " + json.dumps(r))
    if not all(r["rel_err"] <= r["tol"] and r["fwd_err"] <= r["fwd_tol"]
               for r in grads):
        return fail("an output or a gradient through a kernel wrapper is "
                    "outside tolerance")
    phase_s["build, kernel, grad"] = time.time() - t_phase
    t_phase = time.time()

    with tempfile.TemporaryDirectory() as root:
        corpus = write_corpus(root)
        prefix, test_set = corpus["prefix"], corpus["test_set"]
        fea_path = corpus["fea_path"]
        out = os.path.join(root, "result.json")
        stats_path = os.path.join(root, "stats.json")
        zero_launches()
        t0 = time.time()
        with graph_runners() as runners:
            rc = generate.main(generate_argv(corpus, prefix, out, *BEAM_FLAGS,
                                             "--stats-output", stats_path))
            torch.cuda.synchronize()
        launches = launch_counts()
        wall = time.time() - t0
        if rc != 0:
            return fail(f"generate exited {rc}")
        with open(out) as f:
            result = json.load(f)
        with open(stats_path) as f:
            stats = json.load(f)
        answers = [qa["answer"] for d in result["dialogs"]
                   for qa in d["dialog"]]
        print(f"[main] {json.dumps(stats)}")
        # one shape: the first batch runs eagerly, the second captures
        # (after one eager prefix and step) and replays; k = graphs.CHUNK
        # steps a chunk
        from mtn_tpu_torch.decode import graphs
        k, layers = graphs.CHUNK, FLAGSHIP["nb_blocks"]
        # a step's sublayer boundaries: self, his, cap, src, one a video
        # stream, FFN; and layer 0's input
        per_step = layers * (5 + len(FLAGSHIP["ft_sizes"])) + 1
        steps = round(stats["mean_exit_step"] * stats["batches"])
        counts = runner_counts(runners)
        print(f"[main] launches {json.dumps(launches)}; main() wall "
              f"{wall:.2f}s incl. loading; decoder {json.dumps(counts)}; "
              f"graphed with k = {k}: FFN launches = {layers} x (sum over "
              f"batches of n_steps, rounded up to k on graphed batches, "
              f"plus a warm-up step a capture), norm {per_step} x the "
              f"same, attention 24 x (batches + a warm-up prefix a "
              f"capture)")
        captures = counts["captures"]
        if k == 1 and launches != {
                "attention": 24 * (stats["batches"] + captures),
                "ffn": layers * (steps + captures),
                "norm": per_step * (steps + captures)}:
            return fail(f"[main] launches {launches} are not those of "
                        f"{stats['batches']} batches of {steps} steps in "
                        f"all with {captures} captures")
        if len(answers) != N_DIALOGS or \
                any(a == "__UNDISCLOSED__" for a in answers):
            return fail("not every undisclosed answer was replaced")
        print(f"[main] {len(answers)} answers, e.g. {answers[0]!r}")
        if min(launches.values()) <= 0:
            return fail(f"a kernel of the path never launched: {launches}")
        print(f"[main] {stats['responses_per_sec']:.2f} responses/sec, "
              f"mean early-stop exit step {stats['mean_exit_step']} "
              "(random weights exit early: not representative)")
        flight = in_flight_main(torch, corpus, root)
        print(f"[main] in flight, 8 turns a batch: {json.dumps(flight)}; "
              f"{card}")
        if not flight["ok"]:
            return fail("[main]: the result JSON or the n-best log with "
                        f"{IN_FLIGHT} batches in flight differs from one "
                        "batch at a time")
        zero_launches()
        diff = reference_check(torch, prefix, test_set, fea_path)
        print(f"[reference] flagship f32, card (kernels) vs CPU (plain): "
              f"max |d logp| = {diff:.3e} (tol 1e-3)")
        if not diff <= 1e-3:
            return fail("the card disagrees with the CPU reference")
        prof = profile_decode(torch, prefix, test_set, fea_path)
        print(f"[profile] one warm turn batch (32 turns, beam 5, bf16): "
              f"{json.dumps(prof)}")
        phase_s["main"] = time.time() - t_phase

        # the sublayer boundary's kernel against the plain chain
        t_phase = time.time()
        norm = norm_phase(torch, nk, corpus)
        for r in norm["rows"]:
            print("[norm-kernel] " + json.dumps(r))
        print(f"[norm-kernel] beam {json.dumps(norm['beam'])}; {card}")
        if not norm["ok"]:
            return fail("norm-kernel: x_new differs from the plain chain, "
                        "normed is further from the f64 formula than the "
                        "plain chain's by more than one last place (in "
                        "bf16: from the plain chain's, or too few outputs "
                        "bitwise), or the graphed beam's n-bests or "
                        "launches are not the eager's")
        phase_s["norm-kernel"] = time.time() - t_phase

        # each decode batch as captured programs, against the eager loop
        t_phase = time.time()
        gph = graphs_phase(torch, ak, fk, corpus, root)
        for key in ("bfloat16", "float32", "profile", "traffic",
                    "in_flight"):
            print(f"[graphs] {key} {json.dumps(gph[key])}")
        for row in gph["sweep"] + [dict(gph["sweep_eager"], k="eager")]:
            print(f"[graphs] sweep {json.dumps(row)}")
        print(f"[graphs] chunk k = {gph['chunk']}, {gph['batches']} batches "
              f"of 32 turns, beam 5; both kernels inside the graph "
              f"launches: {gph['kernels_in_replays']}; the kernels' "
              f"counts equal the profiler's in every profiled call "
              f"(eager, and the fixed loop's graph): "
              f"{gph['counts_match_profiler']}; a WHILE loop's counts "
              f"(passes times the body's) equal the eager loop's: "
              f"{gph['loop_counts_equal_eager']}; {card}")
        if not gph["ok"]:
            return fail("graphs: a captured decode differs from the eager "
                        "loop or read the host before its fetch, a kernel "
                        "did not run inside a launch, or the kernels' "
                        "counts differ from the profiler's or the eager "
                        "loop's")
        phase_s["graphs"] = time.time() - t_phase

        # the (data, model) mesh: NCCL world of one, two gloo ranks
        t_phase = time.time()
        par = parallel_phase(torch, ak, fk, corpus, root, out)
        for key in ("nccl_world_of_one", "single", "2x1", "1x2"):
            print(f"[parallel] {key} {json.dumps(par[key])}")
        print("[parallel] two ranks on one card over gloo stage every "
              "collective through the host: no time here is a figure of "
              "multi-GPU scaling")
        if not par["ok"]:
            return fail("parallel: a check failed")
        tp_launches = par["1x2"]["decode"][0]["launches"]
        phase_s["parallel"] = time.time() - t_phase

        # the other decode modes, ranking and stage-4 scoring
        t_phase = time.time()
        sample = sample_phase(torch, ak, fk, generate, corpus, root)
        print(f"[sample] {json.dumps(sample)}")
        if not (sample["filled"] and sample["same_seed_bitwise"]
                and sample["temperature_0_equals_greedy"]
                and sample["draw_law"]["ok"]):
            return fail(f"the sample path failed a check: {sample}")
        if min(sample["launches"].values()) <= 0:
            return fail("a kernel never launched on the sample path: "
                        f"{sample['launches']}")
        stream = stream_phase(torch, ak, fk, corpus)
        for key in ("bfloat16", "float32", "profile"):
            print(f"[stream] {key} {json.dumps(stream[key])}")
        print(f"[stream] {card}")
        if not stream["ok"]:
            return fail("stream: a graphed stream differs from the eager "
                        "stream or its batch decode, a warm step is not one "
                        "replay, or the kernels' counts differ from the "
                        "eager stream's or the profiler's")
        ranked = rank_phase(torch, ak, fk, corpus, root)
        for line in ranked["block"]:
            print(f"[rank] {line}")
        print(f"[rank] {json.dumps(ranked)}")
        if not ranked["ok"]:
            return fail("rank: scores, ranks or the retrieval block are "
                        "missing or not finite")
        if not ranked["eager_bitwise"]:
            return fail("rank: the eager loops' result differs from the "
                        "captured programs'")
        if min(ranked["launches"].values()) <= 0:
            return fail("a kernel never launched on the rank path: "
                        f"{ranked['launches']}")
        if not ranked["reference"]["max_abs_diff"] <= RANK_REF_TOL:
            return fail("rank scores on the card disagree with the CPU")
        scored = evaluate_phase(corpus, out, root)
        for line in scored["block"]:
            print(f"[evaluate] {line}  (random weights and words: "
                  "meaningless as a score)")
        print(f"[evaluate] {json.dumps(scored)}")
        if not scored["ok"]:
            return fail("evaluate did not print the Bleu_1..CIDEr block")
        phase_s["sample, stream, rank, evaluate"] = time.time() - t_phase
        t_phase = time.time()

        # int8 weights and features; serving over HTTP
        int8 = int8_phase(torch, ak, fk, generate, corpus, root)
        print(f"[int8] {json.dumps(int8)}")
        if not all(int8[q]["filled"] for q in INT8_MODES):
            return fail("int8: not every undisclosed answer was replaced")
        if not all(int8[q]["launches"]["attention"] > 0
                   and int8[q]["launches"]["norm"] > 0
                   and int8[q]["launches"]["ffn"] == 0 for q in INT8_MODES):
            return fail("int8: attention and norm must launch and the FFN "
                        "kernel never: "
                        f"{[int8[q]['launches'] for q in INT8_MODES]}")
        if not int8["reference"]["max_abs_diff"] <= INT8_REF_TOL:
            return fail("int8: the card disagrees with the CPU reference")
        if not int8["transfer_bitwise"]:
            return fail("int8: the int8-transfer batch on the card differs "
                        "from the CPU's")
        phase_s["int8"] = time.time() - t_phase
        t_phase = time.time()
        served = {}
        for quant in ("", "int8-fp-head"):
            served[quant] = serve_phase(torch, ak, fk, corpus, quant)
            print(f"[serve] {json.dumps(served[quant])}")
            if not served[quant]["ok"]:
                return fail(f"serve ({quant or 'bf16'}): a check failed")
        serve_launches = served[""]["launches"]
        if min(serve_launches.values()) <= 0:
            return fail("serve: a kernel never launched for the bf16 "
                        f"session: {serve_launches}")
        q8 = served["int8-fp-head"]["launches"]
        if q8["attention"] <= 0 or q8["norm"] <= 0 or q8["ffn"] != 0:
            return fail("serve: under int8 attention and norm must launch "
                        f"and the FFN kernel never: {q8}")
        phase_s["serve"] = time.time() - t_phase
        t_phase = time.time()

        # the served mesh: two lockstep ranks on the card, 2x1 and 1x2
        sp = serve_parallel_phase(torch, corpus, root,
                                  served[""]["requests_per_sec"])
        for key in ("single", "2x1", "1x2"):
            print(f"[serve-parallel] {key} {json.dumps(sp[key])}")
        print("[serve-parallel] two ranks on one card over gloo stage every "
              "collective through the host: no time here is a figure of "
              "multi-GPU serving")
        if not sp["ok"]:
            return fail("serve-parallel: a check failed")
        phase_s["serve-parallel"] = time.time() - t_phase
        t_phase = time.time()

        # the AOT artifact: export, load, decode and serve through it
        aot = aot_phase(torch, ak, fk, corpus, root)
        print(f"[aot] {json.dumps(aot)}")
        if not aot["ok"]:
            return fail("aot: a check failed")
        phase_s["aot"] = time.time() - t_phase
        t_phase = time.time()

        # batched_ae, the host's data path, the training tools
        batched = batched_ae_phase(torch, ak, fk, generate, corpus, root)
        for r in batched["train_step"].pop("kernel_rows"):
            print("[batched-ae-kernel] " + json.dumps(r))
        print(f"[batched-ae] {json.dumps(batched)}")
        if not batched["ok"]:
            return fail("batched_ae: a check failed")
        phase_s["batched-ae"] = time.time() - t_phase
        t_phase = time.time()
        data = data_phase(torch, corpus, root)
        print(f"[data] {json.dumps(data)}")
        if not data["ok"]:
            return fail("data: a route differs or the C++ loader is not in "
                        "use")
        tools = tools_phase(torch, generate, corpus, root)
        print(f"[tools] {json.dumps(tools)}")
        if not tools["ok"]:
            return fail("tools: a check failed")
        phase_s["data, tools"] = time.time() - t_phase
        t_phase = time.time()

        # each train, accumulation and eval step as one captured program,
        # against the eager step
        tgraphs = train_graphs_phase(torch, ak, fk, corpus, root)
        for key, row in tgraphs.items():
            if isinstance(row, dict):
                print(f"[train-graphs] {key} {json.dumps(row)}")
        print(f"[train-graphs] both kernels inside run (b)'s replays: "
              f"{tgraphs['kernels_in_replays']}; {card}")
        if not tgraphs["ok"]:
            return fail("train-graphs: a graphed step differs from the eager "
                        "one, a kernel did not run inside a replay, or the "
                        "kernels' counts differ from the profiler's")
        phase_s["train-graphs"] = time.time() - t_phase
        t_phase = time.time()

        # stage 2: (a) run.sh's dropout, batch 32, remat and cut_a: the
        # kernels run only in validation, as in JAX; (b) dropout 0, batch
        # 8: both kernels run inside train steps too; both graphed
        run_a = train_run(torch, ak, fk, corpus, root, "a", "--batch-size",
                          "32", "--cut-a", "1", "--remat", "1")
        print(f"[train] {json.dumps(run_a)}")
        if run_a["launches"]["attention"] <= 0 or \
                any(run_a["train_step_launches"].values()):
            return fail("run (a): the kernels must launch in validation "
                        f"only: {run_a}")
        run_b = train_run(torch, ak, fk, corpus, root, "b", "--batch-size",
                          "8", "--dropout", "0", "--attn-dropout", "0")
        print(f"[train] {json.dumps(run_b)}")
        train_launches = run_b["train_step_launches"]
        if not all_launched(train_launches, train=True):
            return fail("run (b): a kernel never launched inside a train "
                        f"step, or the norm kernel did: {train_launches}")
        out = os.path.join(root, "trained.json")
        rc = generate.main(generate_argv(corpus, run_a["prefix"], out,
                                         *BEAM_FLAGS))
        trained = answers_of(out)
        if rc != 0 or len(trained) != N_DIALOGS or \
                "__UNDISCLOSED__" in trained:
            return fail("generate did not decode the trained checkpoint")
        print(f"[train] generate on run (a)'s best checkpoint: "
              f"{len(trained)} answers, e.g. {trained[0]!r}")
        phase_s["train"] = time.time() - t_phase
        t_phase = time.time()

        # run.sh's stages 2-4 through run_torch.sh at run.sh's settings,
        # both kernels on: stage 3 decodes the best checkpoint, stage 4
        # scores it
        ran = run_torch_phase(torch, ak, fk, generate, corpus, root)
        print(f"[run-torch] stage 2 {json.dumps(ran['stage2'])}")
        print(f"[run-torch] stage 3 {json.dumps(ran['stage3'])}")
        for line in ran["stage4"]["block"]:
            print(f"[run-torch] stage 4 {line}  (random words: meaningless "
                  "as a score)")
        print(f"[run-torch] seconds {json.dumps(ran['seconds'])}; {card}")
        if not ran["ok"]:
            return fail("run-torch: the kernels did not launch in validation "
                        "only, the stage-3 result differs from the "
                        "in-process decode or lacks an answer, or stage 4's "
                        f"block is not whole: {json.dumps(ran)}")
        phase_s["run-torch"] = time.time() - t_phase
        t_phase = time.time()
        ref = train_reference(torch, ak, fk, corpus, run_a["prefix"])
        print(f"[train-reference] {json.dumps(ref)}")
        if not ref["ok"]:
            return fail("a train step on the card disagrees with the CPU")
        tprof = train_profile(torch, ak, fk, corpus, run_b["prefix"])
        for r in tprof.pop("kernels"):
            print("[train-kernel] " + json.dumps(r))
        tprof = {"graphed": tgraphs["b_bf16"]["graphed"], **tprof}
        print(f"[train-profile] one warm train step (batch 8, bf16, dropout "
              f"0; graphed, from [train-graphs] b_bf16, and eager: both "
              f"kernels; kernels_off: both off, eager): {json.dumps(tprof)}")
        if not tprof["counts_match"]:
            return fail("train-profile: the kernels' counts differ from the "
                        "profiler's")
        phase_s["train-reference, train-profile"] = time.time() - t_phase
    print(f"[time] seconds by phase: {json.dumps(phase_s)}")

    def pick(kernel, shape, f32_out=False):
        return next(r for r in rows if r["kernel"] == kernel and
                    r["dtype"] == "bfloat16" and r["shape"] == shape and
                    r.get("f32_out", False) == f32_out)
    heads = [
        ("attention", "cuda", "mtn_tpu_torch/csrc/attention.cu",
         "mtn_tpu/ops/pallas_attention.py:56", pick("attention",
                                                    [32, 8, 32, 64, 64])),
        ("ffn", "cuda", "mtn_tpu_torch/csrc/ffn.cu",
         "mtn_tpu/ops/pallas_ffn.py:42", pick("ffn", [160, 512, 2048])),
    ]
    # a --mesh-model 2 rank's shapes, launched per rank in [parallel] 1x2
    tp_heads = [
        ("attention", pick("attention", [32, 4, 32, 64, 64])),
        ("ffn", pick("ffn", [160, 512, 1024], f32_out=True)),
    ]
    def path_launches(name):
        """The kernel's launches on each path, from that path's run."""
        return dict(launches=launches[name],
                    sample_launches=sample["launches"][name],
                    rank_launches=ranked["launches"][name],
                    serve_launches=serve_launches[name],
                    serve_mesh_launches={
                        m: [n[name] for n in sp[m]["launches"]]
                        for m in ("2x1", "1x2")},
                    aot_launches=aot["http"]["launches"][name],
                    stream_launches=stream["bfloat16"]["greedy_fold0"][
                        "launches"][name],
                    int8_launches=sum(int8[q]["launches"][name]
                                      for q in INT8_MODES),
                    train_launches=train_launches[name],
                    run_torch_launches=ran["stage3"]["launches"][name],
                    batched_ae_launches=batched["launches"][name])
    kernels = [dict(name=name, route=route, source=src, replaces=rep,
                    **path_launches(name),
                    max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"], device_us=r["device_us"],
                    plain_device_us=r["plain_device_us"],
                    library_device_us=r["library_device_us"])
               for name, route, src, rep, r in heads]
    kernels += [dict(name=name, route="cuda", source=k["source"],
                     replaces=k["replaces"], path="parallel 1x2 decode, "
                     "rank 0", shape=r["shape"],
                     launches=tp_launches[name],
                     max_abs_err=r["max_abs_err"], ms=r["ms"],
                     plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                     bound_by=r["bound_by"], library_ms=r["library_ms"],
                     device_us=r["device_us"],
                     plain_device_us=r["plain_device_us"],
                     library_device_us=r["library_device_us"])
                for (name, r), k in zip(tp_heads, kernels)]
    r = next(r for r in norm["rows"] if r["dtype"] == "bfloat16"
             and r["shape"] == [160, 512] and "device_us" in r)
    kernels.append(dict(
        name="norm", route="cuda", source="mtn_tpu_torch/csrc/norm.cu",
        replaces="mtn_tpu_torch/models/layers.py RefLayerNorm and the "
        "sublayer's bias and residual adds", shape=r["shape"],
        **path_launches("norm"), normed_max_ulps=r["normed_max_ulps"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], device_us=r["device_us"],
        plain_device_us=r["plain_device_us"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
