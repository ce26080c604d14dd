#!/usr/bin/env python3
"""Smoke run of mtn_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels (mtn_tpu_torch/csrc/*.cu, one nvcc per
   source, all started together);
3. holds each kernel against its plain PyTorch version on the card, in f32
   and bf16, at the shapes of the beam-decode path and outside its gate
   (the FFN also at 16, 161 and 256 rows; bf16 attention also at the edges
   of its design: Lq 20, Lk 61, Lk 130 and 2048 (two passes over key
   chunks), D 33, 40, 128 and 256, fully masked rows at Lk 61, 130 and
   2048, a per-query mask with two passes),
   each case twice on the same inputs, which must agree bitwise, and times
   kernel, plain version and the one-call PyTorch yardstick
   (``library_*``) beside the bound of the card, two ways: ``*ms`` is the
   host-inclusive time per call (CUDA events around 200 back-to-back calls
   from Python, so at these sizes mostly the host's cost of a call),
   ``*device_us`` the device time per call (the CUDA kernels the same 200
   calls launched, summed by torch.profiler);
4. drives the main path — ``python -m mtn_tpu_torch.cli.generate`` beam
   decode (beam 5, maxlen 30, 32 turns per batch, bf16, both kernels on) —
   at the full width of the flagship MTN config (6 blocks, d_model 512,
   d_ff 2048, 8 heads, I3D 2048 + VGGish 128 streams, vocab 6000) with
   seeded random weights, on a synthetic DSTC7-format test set, and checks
   that every undisclosed answer was filled and that both kernels launched;
5. checks the flagship model on the card against the same model on the CPU
   (f32, plain versions) on a small batch;
6. profiles one warm turn batch of the main path (torch.profiler): host
   wall time, device time by kernel group, the hand-written kernels'
   device time per call, and the device's idle share;
7. ``[grad]``: for each kernel in f32 and bf16, the output and the
   gradients through its autograd wrapper (kernel forward, plain
   backward) against its plain version's, at the shapes of a batch-8
   train step;
8. ``[train]``: drives run.sh stage 2, ``python -m mtn_tpu_torch.cli.train``,
   at the flagship width on synthetic train and valid sets (vocab 6000),
   two epochs each: (a) run.sh's settings (dropout 0.1, batch 32, remat,
   cut_a), where the kernels run only in validation, as in JAX; (b)
   dropout 0 and batch 8, where both kernels also run inside the train
   steps; checks that the loss falls and the checkpoint meta has a best
   epoch; then decodes (a)'s best checkpoint with ``cli.generate``;
9. ``[train-reference]``: one f32 train step of the trained flagship
   model on the card (kernels) against the CPU (plain versions): the loss
   within 1e-5 and every gradient within a relative L2 difference of
   1e-3, beside the same step on the card with the kernels off;
10. ``[train-profile]``: a warm bf16 train step of run (b)'s
    configuration, with both kernels and with both off, under
    torch.profiler (host wall time, tokens/sec, device busy and idle,
    launches per step, device time by kernel group, top host ops), and
    ``[train-kernel]`` lines: each kernel's device µs per call at every
    shape that step launched it at, beside the plain version's and SDPA's,
    and forward plus backward per call through the wrapper (nested
    autograd), through plain autograd, and (attention) with the backward
    written out.

It exits non-zero, printing no result, without a CUDA device or without
the package beside it. Its last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,           # dense tensor-core bf16
            "float32": 67e12}             # f32 outside the tensor cores
TOL = {  # kernel vs its plain version, max abs
    ("attention", "float32"): 1e-5,       # f32 sums in another order
    ("attention", "bfloat16"): 2 ** -6,   # one bf16 step of |out| < 2
    ("ffn", "float32"): 1e-4,             # 2560-term f32 sums
    ("ffn", "bfloat16"): 2 ** -5,         # one bf16 step of |y| < 4
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


def device_us(fn, iters: int = 200, warmup: int = 10):
    """Device time per call of ``fn`` in µs: the durations of the CUDA
    kernels that ``iters`` calls launched, summed by torch.profiler, over
    ``iters``; "not measured" if the profiler saw no device activity."""
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
    """FFN at the decode step's 160 rows; at 16, 161 (a ragged row tile)
    and 256 rows (the gate's edge); and at 300 and 1024 rows, outside the
    gate. Each case runs twice on the same inputs and must agree bitwise.
    Weights rotate over copies larger than L2 together, so every timed
    launch reads them from device memory, as a decode step does (each
    layer's FFN weights are evicted by the other layers')."""
    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    D, F = 512, 2048
    elt = torch.empty((), dtype=dt).element_size()
    copies = max(2, -(-2 * L2_BYTES // (2 * D * F * elt)))
    weights = []
    for _ in range(copies):
        weights.append(tuple(t.to(dev, dt).contiguous() for t in (
            torch.randn(D, F, generator=gen) / D ** 0.5,
            torch.randn(F, generator=gen) * 0.1,
            torch.randn(F, D, generator=gen) / F ** 0.5,
            torch.randn(D, generator=gen) * 0.1)))
    rows = []
    for N in (160, 16, 161, 256, 300, 1024):
        x = torch.randn(N, D, generator=gen).to(dev, dt)
        w1, b1, w2, b2 = weights[0]
        got = fk.ffn(x, w1, b1, w2, b2)
        again = fk.ffn(x, w1, b1, w2, b2)
        want = fk.ffn_plain(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if math.isnan(err) or torch.isnan(got.float()).any():
            raise AssertionError(f"ffn {dtype_name} N={N}: NaN")
        if not torch.equal(got, again):
            raise AssertionError(f"ffn {dtype_name} N={N}: two calls on the "
                                 "same inputs differ")
        turn = [0]

        def rotating(fn):
            def call():
                turn[0] = (turn[0] + 1) % copies
                return fn(x, *weights[turn[0]])
            return call
        row = dict(kernel="ffn", dtype=dtype_name, shape=[N, D, F],
                   max_abs_err=err, tol=TOL[("ffn", dtype_name)])
        timed(row, "", rotating(fk.ffn))
        timed(row, "plain_", rotating(fk.ffn_plain))
        row["library_ms"] = None  # no single PyTorch call fuses the MLP
        row["library_device_us"] = None
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes(x, w1, b1, w2, b2, x), 4 * N * D * F, dtype_name)
        rows.append(row)
    return rows


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
    last answers (``test_set``, decoded with a 6000-entry vocabulary), and
    train and valid sets whose answers are disclosed (``train_set``,
    ``valid_set``). The train captions and summaries run through every
    word, so the vocabulary the train CLI builds from them (cutoff 0)
    also has 6000 entries."""
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

    def dialogs(prefix, n, undisclosed, caption):
        out = []
        for d in range(n):
            turns = [{"question": say(20, 30), "answer": say(5, 15)}
                     for _ in range(3)]
            if undisclosed:
                turns[-1]["answer"] = "__UNDISCLOSED__"
            out.append({"image_id": f"{prefix}{d:03d}", "caption": caption(),
                        "summary": caption(), "dialog": turns})
        return out

    sets = {"test_set": dialogs("vid", N_DIALOGS, True,
                                lambda: say(10, 20)),
            "train_set": dialogs("tr", N_TRAIN_DIALOGS, False, tell),
            "valid_set": dialogs("va", N_VALID_DIALOGS, False,
                                 lambda: say(10, 20))}
    corpus = {}
    for name, ds in sets.items():
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


def reference_check(torch, prefix, test_set, fea_path):
    """The flagship model on the card (f32, both kernels) against the same
    weights on the CPU (f32, plain versions): init_decode_state and three
    decode steps on two turns; returns the max abs log-prob difference."""
    from mtn_tpu_torch.config import config_from_dict
    from mtn_tpu_torch.data.batching import make_batch, make_batch_indices
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.train.batch import batch_masks, device_batch
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
    if any(s in name for s in ("gemm", "gemv", "xmma", "cutlass")):
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


def profile_decode(torch, prefix, test_set, fea_path):
    """One warm beam-decoded turn batch of the main path (bf16, both
    kernels) under torch.profiler: host wall time, device busy time by
    kernel group, the hand-written kernels' device time per wrapper call,
    and the device's idle share. Returns a dict."""
    from mtn_tpu_torch.config import DecodeConfig, config_from_dict
    from mtn_tpu_torch.data.batching import make_batch, make_batch_indices
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.decode.beam import BeamDecoder
    from mtn_tpu_torch.ops import attention_kernel as ak
    from mtn_tpu_torch.ops import ffn_kernel as fk
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
    dec.beam_batch_raw(db)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = dec.beam_batch_raw(db)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ak.KERNEL.launches = fk.KERNEL.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.beam_batch_raw(db)
        torch.cuda.synchronize()
    calls = {"attention (csrc)": ak.KERNEL.launches,
             "ffn (csrc)": fk.KERNEL.launches}
    groups, launches, top = device_groups(torch, prof)
    busy = sum(groups.values())
    measured = launches > 0
    return {"wall_ms": wall * 1e3, "steps": raw.n_steps,
            "device_busy_ms": busy if measured else "not measured",
            "idle_share": (1 - busy / (wall * 1e3)) if measured
            else "not measured",
            "device_ms_by_group": groups, "device_launches": launches,
            "kernel_calls": calls,
            "device_us_per_call": {
                g: groups.get(g, 0.0) * 1e3 / n if measured and n
                else "not measured" for g, n in calls.items()},
            "top_kernels": top}


# -- training ---------------------------------------------------------------
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

    def __init__(self, ak, fk):
        self.ak, self.fk = ak, fk
        self.counts = {"attention": 0, "ffn": 0}

    def __enter__(self):
        from mtn_tpu_torch.train.trainer import Trainer
        self.orig = orig = Trainer.train_step
        ak, fk, counts = self.ak, self.fk, self.counts

        def train_step(tr, *args, **kwargs):
            before = ak.KERNEL.launches, fk.KERNEL.launches
            try:
                return orig(tr, *args, **kwargs)
            finally:
                counts["attention"] += ak.KERNEL.launches - before[0]
                counts["ffn"] += fk.KERNEL.launches - before[1]
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
    """One ``cli.train.main`` run (two epochs); its kernel launches (all,
    and those inside train steps), losses and checkpoint meta. Fails if a
    loss is not finite, if the mean of the last steps' losses is not
    below the first steps', or if meta.json has no best epoch."""
    from mtn_tpu_torch.cli import train as train_cli
    prefix = os.path.join(root, name, "mtn")
    ak.KERNEL.launches = fk.KERNEL.launches = 0
    t0 = time.time()
    with StepLaunches(ak, fk) as steps:
        rc = train_cli.main(train_argv(corpus, prefix, *extra))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"attention": ak.KERNEL.launches, "ffn": fk.KERNEL.launches}
    if rc != 0:
        raise AssertionError(f"train run {name}: exit code {rc}")
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
               launches=launches, train_step_launches=steps.counts,
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
        ak.KERNEL.launches = fk.KERNEL.launches = 0
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
    """Run ``fn`` with each kernel's launch recorded: per distinct set of
    argument shapes, a copy of the first call's arguments and the number
    of calls."""
    seen = {}
    origs = (ak.launch, fk.launch)

    def recorder(name, orig):
        def launch(*args):
            key = (name,) + tuple(None if a is None else tuple(a.shape)
                                  for a in args)
            if key not in seen:
                seen[key] = {"args": [None if a is None else
                                      a.detach().clone() for a in args],
                             "calls": 0}
            seen[key]["calls"] += 1
            return orig(*args)
        return launch
    ak.launch = recorder("attention", origs[0])
    fk.launch = recorder("ffn", origs[1])
    try:
        fn()
    finally:
        ak.launch, fk.launch = origs
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
    busy time, launches, the hand-written kernels' calls and the top host
    ops by self time."""
    from torch.profiler import ProfilerActivity, profile
    ak.KERNEL.launches = fk.KERNEL.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_step(state, db, 0)
        torch.cuda.synchronize()
    groups, launches, top = device_groups(torch, prof)
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key[:60])
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)[:10]
    return {"device_busy_ms": sum(groups.values()) if launches
            else "not measured",
            "device_ms_by_group": groups, "device_launches": launches,
            "kernel_calls": {"attention (csrc)": ak.KERNEL.launches,
                             "ffn (csrc)": fk.KERNEL.launches},
            "top_kernels": top, "top_host_ops_self_ms": host}


def train_profile(torch, ak, fk, corpus: dict, prefix: str) -> dict:
    """Warm bf16 train steps of run (b)'s configuration (batch 8, dropout
    0) from its trained checkpoint, with both kernels and with both off
    (the plain path, plain autograd): host wall time per step (two
    rounds of 3 steps each, alternating, so host drift hits both) and
    tokens/sec; under torch.profiler each step's device time by kernel
    group, busy and idle share, launches and top host ops. Then each
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
    for name, kernels in (("kernels", True), ("plain", False)):
        cfg = config_from_dict("model", conf["model"])
        cfg.use_pallas_attention = cfg.use_pallas_ffn = kernels
        tr = Trainer(cfg, TrainConfig(warmup_steps=WARMUP), "cuda")
        state = tr.state_from(sd)
        for _ in range(2):
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
    tr, state = runs["kernels"]
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
                nbytes(*args, x), 4 * x.shape[0] * x.shape[1] * w1.shape[1],
                "bfloat16")
            fwd_bwd = {"wrapper": lambda: grad(fk.FFNFunction.apply(*leaves)),
                       "plain": lambda: grad(fk.ffn_plain(*leaves))}
        row["bound_us"] *= 1e3
        for name, fn in fwd_bwd.items():
            timed(row, f"fwd_bwd_{name}_", fn)
        rows.append(row)
    del runs, tr, state
    torch.cuda.empty_cache()
    out = {"batch": list(hb.query.shape), "answer_tokens": ntok}
    out.update(steps.pop("kernels"))
    out["kernels_off"] = steps.pop("plain")
    out["kernels"] = rows
    return out


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

    t0 = time.time()
    logs = _build.build_all([ak.KERNEL, fk.KERNEL])
    print(f"[build] {time.time() - t0:.1f}s")
    for log in logs:
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                        "spill", "error")):
                print("[build] " + line.strip())

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

    with tempfile.TemporaryDirectory() as root:
        corpus = write_corpus(root)
        prefix, test_set = corpus["prefix"], corpus["test_set"]
        fea_path = corpus["fea_path"]
        out = os.path.join(root, "result.json")
        stats_path = os.path.join(root, "stats.json")
        ak.KERNEL.launches = 0
        fk.KERNEL.launches = 0
        t0 = time.time()
        rc = generate.main([
            "--model", prefix + "_best", "--test-path", fea_path,
            "--test-set", test_set, "--decode-style", "beam_search",
            "--beam", "5", "--penalty", "1.0", "--nbest", "5",
            "--maxlen", "30", "--turn-batch", "32", "--undisclosed-only",
            "1", "--dtype", "bfloat16", "--device", "cuda",
            "--use-pallas-attention", "1", "--use-pallas-ffn", "1",
            "--output", out, "--stats-output", stats_path])
        torch.cuda.synchronize()
        launches = {"attention": ak.KERNEL.launches,
                    "ffn": fk.KERNEL.launches}
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
        print(f"[main] launches {json.dumps(launches)}; main() wall "
              f"{wall:.2f}s incl. loading")
        if len(answers) != N_DIALOGS or \
                any(a == "__UNDISCLOSED__" for a in answers):
            return fail("not every undisclosed answer was replaced")
        print(f"[main] {len(answers)} answers, e.g. {answers[0]!r}")
        if min(launches.values()) <= 0:
            return fail(f"a kernel of the path never launched: {launches}")
        print(f"[main] {stats['responses_per_sec']:.2f} responses/sec, "
              f"mean early-stop exit step {stats['mean_exit_step']} "
              "(random weights exit early: not representative)")
        ak.KERNEL.launches = fk.KERNEL.launches = 0
        diff = reference_check(torch, prefix, test_set, fea_path)
        print(f"[reference] flagship f32, card (kernels) vs CPU (plain): "
              f"max |d logp| = {diff:.3e} (tol 1e-3)")
        if not diff <= 1e-3:
            return fail("the card disagrees with the CPU reference")
        prof = profile_decode(torch, prefix, test_set, fea_path)
        print(f"[profile] one warm turn batch (32 turns, beam 5, bf16): "
              f"{json.dumps(prof)}")

        # stage 2: (a) run.sh's dropout, batch 32, remat and cut_a: the
        # kernels run only in validation, as in JAX; (b) dropout 0, batch
        # 8: both kernels run inside train steps too
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
        if min(train_launches.values()) <= 0:
            return fail("run (b): a kernel never launched inside a train "
                        f"step: {train_launches}")
        out = os.path.join(root, "trained.json")
        rc = generate.main([
            "--model", run_a["prefix"] + "_best", "--test-path", fea_path,
            "--test-set", test_set, "--decode-style", "beam_search",
            "--beam", "5", "--penalty", "1.0", "--nbest", "5",
            "--maxlen", "30", "--turn-batch", "32", "--undisclosed-only",
            "1", "--dtype", "bfloat16", "--device", "cuda",
            "--use-pallas-attention", "1", "--use-pallas-ffn", "1",
            "--output", out])
        with open(out) as f:
            trained = [qa["answer"] for d in json.load(f)["dialogs"]
                       for qa in d["dialog"]]
        if rc != 0 or len(trained) != N_DIALOGS or \
                "__UNDISCLOSED__" in trained:
            return fail("generate did not decode the trained checkpoint")
        print(f"[train] generate on run (a)'s best checkpoint: "
              f"{len(trained)} answers, e.g. {trained[0]!r}")
        ref = train_reference(torch, ak, fk, corpus, run_a["prefix"])
        print(f"[train-reference] {json.dumps(ref)}")
        if not ref["ok"]:
            return fail("a train step on the card disagrees with the CPU")
        tprof = train_profile(torch, ak, fk, corpus, run_b["prefix"])
        for r in tprof.pop("kernels"):
            print("[train-kernel] " + json.dumps(r))
        print(f"[train-profile] one warm train step (batch 8, bf16, dropout "
              f"0, both kernels; kernels_off: both off): "
              f"{json.dumps(tprof)}")

    def pick(kernel, shape):
        return next(r for r in rows if r["kernel"] == kernel and
                    r["dtype"] == "bfloat16" and r["shape"] == shape)
    heads = [
        ("attention", "cuda", "mtn_tpu_torch/csrc/attention.cu",
         "mtn_tpu/ops/pallas_attention.py:56", pick("attention",
                                                    [32, 8, 32, 64, 64])),
        ("ffn", "cuda", "mtn_tpu_torch/csrc/ffn.cu",
         "mtn_tpu/ops/pallas_ffn.py:42", pick("ffn", [160, 512, 2048])),
    ]
    kernels = [dict(name=name, route=route, source=src, replaces=rep,
                    launches=launches[name],
                    train_launches=train_launches[name],
                    max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"], device_us=r["device_us"],
                    plain_device_us=r["plain_device_us"],
                    library_device_us=r["library_device_us"])
               for name, route, src, rep, r in heads]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
