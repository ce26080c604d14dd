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
   device time per call, and the device's idle share.

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
N_DIALOGS = 64
FRAMES = ((40, 64), (20, 32))             # -> buckets 64 and 32


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


# -- main path ----------------------------------------------------------------
def write_corpus(root: str, seed: int = 0):
    """A DSTC7-format test set with undisclosed last answers, .npy
    features, a 6000-entry vocabulary and the flagship config, plus seeded
    random weights in the port's checkpoint format."""
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
    dialogs = []
    for d in range(N_DIALOGS):
        turns = [{"question": say(20, 30), "answer": say(5, 15)}
                 for _ in range(3)]
        turns[-1]["answer"] = "__UNDISCLOSED__"
        dialogs.append({"image_id": f"vid{d:03d}", "caption": say(10, 20),
                        "summary": say(10, 20), "dialog": turns})
    test_set = os.path.join(root, "test_set.json")
    with open(test_set, "w") as f:
        json.dump({"type": "test", "version": "0.1", "dialogs": dialogs}, f)
    fea_types = ["i3d_rgb", "vggish"]
    for ftype, dim, (lo, hi) in zip(fea_types, FLAGSHIP["ft_sizes"], FRAMES):
        os.makedirs(os.path.join(root, ftype))
        for d in dialogs:
            n = int(rng.integers(lo, hi + 1))
            np.save(os.path.join(root, ftype, d["image_id"] + ".npy"),
                    rng.standard_normal((n, dim)).astype(np.float32))
    cfg = ModelConfig(**FLAGSHIP)
    prefix = os.path.join(root, "mtn")
    save_conf(prefix, vocab, model=cfg, data=DataConfig(
        fea_type=fea_types, include_caption="caption,summary",
        separate_caption=True))
    save_checkpoint(prefix, 1, init_params(
        cfg, torch.Generator().manual_seed(seed)))
    return prefix, test_set, os.path.join(root, "<FeaType>", "<ImageID>.npy")


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
    return "other"


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
    groups, top, launches = {}, [], 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = event_device_us(e)
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:60]))
        launches += e.count
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
            "top_kernels": sorted(top, reverse=True)[:8]}


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

    with tempfile.TemporaryDirectory() as root:
        prefix, test_set, fea_path = write_corpus(root)
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
                    launches=launches[name], max_abs_err=r["max_abs_err"],
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
