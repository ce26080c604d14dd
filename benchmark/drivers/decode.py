"""Decode cells: run.sh's stage 3 over a test split, pass after pass.

Set-up writes the traffic's test split (the run's ``TMPDIR``), loads it
through the port's data pipeline, makes the weights on the device from
the seed and runs one pass over a few of the split's dialogs whose
uniform batch shape is the whole split's (:func:`warm_subset`), which
builds the kernels and makes every first call of that shape. The window
then calls ``mtn_tpu_torch.cli.generate.generate_responses`` over the
whole split pass after pass, as stage 3 does, each pass with a decoder
of its own (its first batch eager, its second captured), and ends at the
end of the pass that crosses ``--seconds``; after each pass the
collector frees the pass's decoder and graphs (inside the window). Each
pass logs its n-bests as stage 3 does at ``-v 1`` (``HYP[n]: words (
score )``); the benchmark keeps those records, which are what the check
compares.

With ``--trace 1``, after the window: the host time to build and upload
each of a pass's batches (``make_batch``, then ``to_device_fn``), and a
decoder the benchmark holds decoding one pass of those batches, warm, 8
in flight, each launch bracketed by CUDA events (the profiler cannot
run over the loop's WHILE node). That held pass is the traced line's
``busy_s`` and ``window_s``, and gives the device time of a warm graphed
batch; it is not the window, whose own batches the program launches
with no hook for an event. The busiest kernels come from one eager
batch under ``torch.profiler``.

Then the program's state is freed and the check runs
(:mod:`benchmark.harness.check`).
"""

from __future__ import annotations

import gc
import logging
import shutil
import tempfile
import time

from benchmark.harness import (check, device, flops, kernels, traffic,
                               weights)
from benchmark.reference.mtn_ref import param_spec, turn_tokens

GENERATE_LOG = "mtn_tpu_torch.cli.generate"
IN_FLIGHT = 8


class NBestLog(logging.Handler):
    """Stage 3's n-best records of one pass: turn id -> [(words, score)]."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.nbest, self.turn = {}, None

    def emit(self, record):
        if record.msg == "%d %s_%d":
            self.turn = record.args[0]
            self.nbest[self.turn] = []
        elif record.msg.startswith("HYP["):
            self.nbest[self.turn].append((record.args[1], record.args[2]))


def model_config(cfg: dict):
    from mtn_tpu_torch.config import ModelConfig
    return ModelConfig(
        vocab_size=cfg["vocab_size"], nb_blocks=cfg["nb_blocks"],
        d_model=cfg["d_model"], d_ff=cfg["d_ff"], att_h=cfg["att_h"],
        dropout=cfg["dropout"], ft_sizes=list(cfg["ft_sizes"]),
        separate_his_embed=bool(cfg["sep_his_embed"]),
        separate_cap_embed=bool(cfg["sep_cap_embed"]),
        diff_encoder=bool(cfg["diff_encoder"]),
        diff_embed=bool(cfg["diff_embed"]), diff_gen=bool(cfg["diff_gen"]),
        auto_encoder_ft=cfg["auto_encoder_ft"], dtype=cfg["dtype"],
        use_pallas_attention=bool(cfg["use_pallas_attention"]),
        use_pallas_ffn=bool(cfg["use_pallas_ffn"]))


def reference_config(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("vocab_size", "nb_blocks", "d_model", "d_ff",
                                "att_h", "ft_sizes", "diff_encoder",
                                "auto_encoder_ft")}


class Decode:
    """One decode cell's run: :meth:`setup`, :meth:`window`,
    :meth:`trace`, :meth:`release`, :meth:`check`."""

    def __init__(self, cell, seed: int, dev, control: str = ""):
        self.cell, self.seed, self.dev, self.control = cell, seed, dev, control
        self.cfg, self.tr = cell.config, cell.traffic
        self.obs = {"driver": "decode"}

    # -- set-up ---------------------------------------------------------------
    def setup(self, warm: bool = True) -> None:
        import torch
        from mtn_tpu_torch.config import DataConfig, DecodeConfig
        from mtn_tpu_torch.data.dataset import load
        from mtn_tpu_torch.weights import load_model
        cfg, tr = self.cfg, self.tr
        phases, t = {}, time.perf_counter()

        def phase(name):
            nonlocal t
            self._sync()
            phases[name] = time.perf_counter() - t
            t = time.perf_counter()
        self.obs["setup_phases"] = phases
        if cfg["dtype"] == "float32":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.vocab = traffic.vocabulary(cfg["vocab_size"])
        streams = dict(zip(cfg["fea_type"], cfg["ft_sizes"]))
        self.corpus = traffic.make_dialogs(tr, self.seed, cfg["vocab_size"],
                                           streams, self.dev)
        self.tmp = tempfile.mkdtemp(prefix="bench-corpus-")
        phase("traffic")
        traffic.write_corpus(self.corpus, self.tmp)
        phase("write")
        self.dataset = load(self.corpus.fea_types or None,
                            self.corpus.fea_path, self.corpus.test_set,
                            self.vocab,
                            include_caption=cfg["include_caption"],
                            separate_caption=bool(cfg["sep_caption"]),
                            max_history_length=cfg["max_his_len"],
                            merge_source=bool(cfg["merge_source"]),
                            undisclosed_only=bool(tr["undisclosed_only"]))
        phase("load")
        self.model_cfg = model_config(cfg)
        dt = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
        self.weights = weights.make_weights(
            param_spec(reference_config(cfg)), self.dev, dt,
            cfg["weights"])
        self.model = load_model(self.model_cfg, self.weights, self.dev)
        phase("weights")
        self.data_cfg = DataConfig(
            fea_type=list(cfg["fea_type"]),
            include_caption=cfg["include_caption"],
            separate_caption=bool(cfg["sep_caption"]),
            max_history_length=cfg["max_his_len"],
            merge_source=bool(cfg["merge_source"]))
        d = tr["decode"]
        self.decode_cfg = DecodeConfig(
            maxlen=d["maxlen"], beam=d["beam"], penalty=d["penalty"],
            nbest=d["nbest"], decode_style="beam_search",
            undisclosed_only=bool(tr["undisclosed_only"]),
            turn_batch=d["turn_batch"], uniform_shapes=bool(
                d["uniform_shapes"]), early_stop=bool(d["early_stop"]))
        self.log = logging.getLogger(GENERATE_LOG)
        self.log.setLevel(logging.INFO)
        self.log.propagate = False
        if warm:
            self.one_pass(warm_subset(self.dataset, self.tr["decode"][
                "turn_batch"], bool(cfg["sep_caption"])))
        # the set-up's objects leave the collector's scans: a collection
        # over them inside a pass would time the harness, not the program
        gc.collect()
        gc.freeze()
        phase("warm_pass")

    def _sync(self):
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def one_pass(self, dataset=None):
        """One ``generate_responses`` pass over ``dataset`` (the test
        split by default): (stats, n-best records)."""
        from mtn_tpu_torch.cli.generate import generate_responses
        handler = NBestLog()
        self.log.addHandler(handler)
        try:
            _, stats = generate_responses(
                self.model, dataset or self.dataset, self.decode_cfg,
                self.data_cfg,
                self.vocab, self.dev, feature_dtype=self.cfg["dtype"],
                log_hyps=True)
        finally:
            self.log.removeHandler(handler)
        return stats, handler.nbest

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> None:
        import torch
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        passes, self.results = [], []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            stats, nbest = self.one_pass()
            # the last pass's decoder and its graphs go here, not at some
            # collection inside the next pass; the window counts it
            c = time.perf_counter()
            gc.collect()
            passes.append({"seconds": time.perf_counter() - t,
                           "collect_s": time.perf_counter() - c,
                           "responses": len(nbest),
                           "turns": stats["turns"],
                           "first_batch_seconds": stats["first_batch_seconds"],
                           "mean_exit_step": stats["mean_exit_step"]})
            self.results.append(nbest)
            if time.perf_counter() - t0 >= seconds:
                break
        self.obs["window_s"] = time.perf_counter() - t0
        self.obs["passes"] = passes
        self.obs["memory_peak_bytes"] = (
            torch.cuda.max_memory_allocated(self.dev)
            if self.dev.type == "cuda" else 0)
        self.obs["peak_flops"] = device.PEAK_FLOPS[self.cfg["dtype"]]
        self.obs["model_flops"] = sum(self.pass_flops(r)
                                      for r in self.results)

    def turn_lengths(self, qa_id: int):
        """(query, history, caption, frames) of turn ``qa_id`` by the
        reference's data law."""
        dialog, turn = self.turn_of(qa_id)
        q, h, c = turn_tokens(dialog, turn, self.vocab,
                              self.cfg["include_caption"])
        frames = [len(a) for a in self.corpus.features[dialog["image_id"]]]
        return q, h, c, frames

    def turn_of(self, qa_id: int):
        turns = self.tr["turns"]
        if self.tr["undisclosed_only"]:
            return self.corpus.dialogs[qa_id], turns - 1
        return self.corpus.dialogs[qa_id // turns], qa_id % turns

    def pass_flops(self, nbest: dict) -> int:
        beam = self.tr["decode"]["beam"]
        total = 0
        for qa_id, hyps in nbest.items():
            q, h, c, frames = self.turn_lengths(qa_id)
            steps = max(len(w.split()) for w, _ in hyps) + 1
            total += flops.decode_turn(self.cfg, len(q), len(h), len(c),
                                       frames, steps, beam)
        return total

    # -- --trace 1 ------------------------------------------------------------
    def trace(self) -> None:
        import torch
        from mtn_tpu_torch.data.batching import (make_batch,
                                                 make_batch_indices,
                                                 uniform_plans)
        from mtn_tpu_torch.decode.beam import BeamDecoder
        from mtn_tpu_torch.train.batch import to_device_fn
        d, dc = self.decode_cfg, self.data_cfg
        plans, _ = make_batch_indices(self.dataset, batchsize=d.turn_batch,
                                      max_length=10 ** 9,
                                      separate_caption=dc.separate_caption)
        if d.uniform_shapes:
            plans = uniform_plans(plans)
        to_device = to_device_fn(self.cfg["dtype"], None, self.dev)
        dbs, host_ms = [], []
        for plan in plans:
            t = time.perf_counter()
            hb = make_batch(self.dataset, plan,
                            separate_caption=dc.separate_caption,
                            skip=dc.skip, length_bucket=dc.length_bucket,
                            feature_bucket=dc.feature_bucket,
                            pad_rows_to=d.turn_batch)
            dbs.append(to_device(hb))
            self._sync()
            host_ms.append((time.perf_counter() - t) * 1e3)
        self.obs["host_batch_ms"] = host_ms
        dec = BeamDecoder(self.model, d)
        for _ in range(2):   # the shape's eager batch, then its capture
            dec.beam_results(dec.beam_batch_raw(dbs[0]), dbs[0].valid)
        if self.dev.type != "cuda":
            return
        spans, pending = [], []
        torch.cuda.synchronize(self.dev)
        t = time.perf_counter()
        for db in dbs:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            raw = dec.beam_batch_raw(db)
            end.record()
            spans.append((start, end))
            pending.append((raw, db.valid))
            if len(pending) >= IN_FLIGHT:
                dec.beam_results(*pending.pop(0))
        while pending:
            dec.beam_results(*pending.pop(0))
        torch.cuda.synchronize(self.dev)
        wall = time.perf_counter() - t
        busy = [a.elapsed_time(b) / 1e3 for a, b in spans]
        gaps = [(f"before batch {k}", spans[k - 1][1].elapsed_time(
            spans[k][0]) / 1e3) for k in range(1, len(spans))]
        self.obs["held"] = {"batches": len(dbs), "busy_s": sum(busy),
                            "wall_s": wall}
        self.obs["idle_gaps"] = sorted(gaps, key=lambda g: -g[1])[:10]
        self.obs["device_ops"], self.obs["device_groups"] = eager_profile(
            dec, dbs[0])

    # -- after the window -----------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        import torch
        self.model = self.dataset = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """(checks, attempted, failed): the sampled n-bests against the
        reference (:func:`benchmark.harness.check.decode_scores`)."""
        attempted = sum(p["turns"] for p in self.obs["passes"])
        answered = sum(p["responses"] for p in self.obs["passes"])
        checks = check.decode_scores(self, self.cell.limits, self.control)
        shutil.rmtree(self.tmp, ignore_errors=True)
        return checks, attempted, attempted - answered


def warm_subset(dataset, turn_batch: int, separate_caption: bool):
    """The dialogs of a few turns whose uniform batch shape is the whole
    split's: those that hold each length's and each stream's maximum,
    then the first others, up to two batches and a half one (an eager
    batch, a captured one and a part-filled replay), their turns
    renumbered in the order ``generate_responses`` counts them."""
    import dataclasses
    from collections import Counter
    turns = dataset.turns
    n_streams = len(dataset.features) if dataset.features else 0

    def sizes(t):
        frames = [dataset.features.n_frames(i, t.vid)
                  for i in range(n_streams)]
        cap = len(t.caption) if separate_caption else 0
        return [len(t.history), len(t.question), len(t.answer_in), cap,
                *frames]
    table = [sizes(t) for t in turns]
    picked = {turns[max(range(len(turns)), key=lambda i: table[i][k])].vid
              for k in range(len(table[0]))}
    per_vid = Counter(t.vid for t in turns)
    want = 2 * turn_batch + turn_batch // 2
    count = sum(per_vid[v] for v in picked)
    for t in turns:
        if count >= want:
            break
        if t.vid not in picked:
            picked.add(t.vid)
            count += per_vid[t.vid]
    sub = [dataclasses.replace(t, qa_id=i) for i, t in
           enumerate(u for u in turns if u.vid in picked)]
    original = dict(dataset.original, dialogs=[
        d for d in dataset.original["dialogs"] if d["image_id"] in picked])
    return dataclasses.replace(dataset, turns=sub, original=original)


def eager_profile(dec, db) -> tuple:
    """(the ten kernels that took most device time, seconds by kernel
    group) in one eager batch (``BeamDecoder.beam_eager``) under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.beam_eager(db)
        torch.cuda.synchronize()
    ops = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            ops.append([e.key[:120], us / 1e6])
    return sorted(ops, key=lambda o: -o[1])[:10], kernels.by_group(ops)


def run(cell, args, dev):
    return Decode(cell, args.seed, dev, control=args.control)
