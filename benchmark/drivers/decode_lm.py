"""Decode cells of a language model (``architecture: kimi_vl``): run.sh's
stage 3 over a test split as :mod:`benchmark.drivers.decode` runs it (the
same window, passes, n-best records and held pass; ``obs["driver"]`` is
``"decode"``, so the decode cells' metric readers read it), with a set-up,
a FLOP count, a check and traced readings of its own.

Set-up: the traffic's split as the MTN cells write and load it, and the
weights made on the device leaf by leaf (:func:`make_weights`: each
parameter from its own seeded generator, so no draw of the whole model
in float32 exists), put in place of the model's parameters
(``load_model``'s ``assign``); then one warm pass over a few dialogs of
the split's batch shape.

FLOPs (``mfu.decode``): :func:`benchmark.harness.lm_counts.decode_turn`
over each turn's real prompt tokens and the steps its n-best needs.

The check: the sampled turns (:func:`benchmark.harness.check.
sample_turns`) and each returned hypothesis scored by the plain reference
(:mod:`benchmark.reference.kimi_vl_lm_ref`, f32, TF32 off), every sampled
turn through one layer before the next; ``score_gap_per_token`` (the
widest gap per scored event) and ``unscored`` as the MTN cells compare
them, and ``score_gap_rms``, the root mean square of the per-event gaps:
the widest gap is one or two hypotheses of a word or two, where the
bf16 program and the fp8 control overlap, and the bulk is where they
part. Then the probe (:meth:`DecodeLM.probe`, the traffic's
``check.probe``): the program decodes one turn batch after the window
with each prompt cut to a few parts, and ``probe_gap_rms`` is the root
mean square of the gaps per event of its hypotheses of at least
``check.probe.min_tokens`` tokens (a short answer's gap is one or two
tokens' rounding; a long one's averages it out, and a fault from a
middle position on shows in most of its tokens). Under random weights a prompt of
~330 real tokens leaves the few generated tokens a few hundredths of
each softmax, so a fault in their latent cache or in the answer's
positions hardly moves the window's scores; over a prompt of the
question alone the generated tokens hold most of it. ``--control fp8``
puts the reference computed in float8 in the program's place.

``--trace 1`` adds two readings to the decode cells' (from one eager
batch each, after the held pass): ``lm_prefill_ms``, the device time of
the kernels inside the prefill's span ``lm.prefill`` of a recorded eager
batch; ``moe_experts_roofline_pct.decode``, the routed experts' grouped
GEMMs (``aten::_grouped_mm``) in that batch's decode steps, under the
profiler, as a share of the HBM roofline: the bytes of
:func:`~benchmark.harness.lm_counts.expert_step_bytes` for each step and
layer, by the experts and rows that step's routing took (read from the
model's counters after each step), over the kernels' time × 3.35e12 B/s.
"""

from __future__ import annotations

import gc
import logging
import math
import shutil
import tempfile
import time

import numpy as np

from benchmark.drivers import decode
from benchmark.harness import check, device, lm_counts, traffic
from benchmark.harness.weights import device_generator
from benchmark.reference.kimi_vl_lm_ref import KimiVLLMReference, param_spec
from benchmark.reference.mtn_ref import turn_tokens


def model_config(cfg: dict):
    import dataclasses
    from mtn_tpu_torch.config import LMConfig, ModelConfig
    keys = {f.name for f in dataclasses.fields(LMConfig)}
    return ModelConfig(vocab_size=cfg["vocab_size"],
                       ft_sizes=list(cfg["ft_sizes"]), dtype=cfg["dtype"],
                       architecture="kimi_vl",
                       lm={k: v for k, v in cfg.items() if k in keys})


def make_weights(cfg: dict, dev, dtype, laws: dict, only=None) -> dict:
    """Every parameter of :func:`param_spec` from its own generator on
    ``dev`` (seeded from ``laws["seed"]`` and its index), uniform:
    xavier for matrices (an expert's own fans), the token embeddings of
    root-mean-square ``embedding_rms``, biases in ``±bias``, norm weights
    in ``1 ± norm_scale``, the selection biases in ``±correction_bias``
    (float32). The residual branches' output projections (``o_proj``,
    every ``down_proj``) are scaled by ``residual_scale`` (GPT-2's and
    Megatron-LM's scaled initialisation, ``1/sqrt(2·layers)``), and each
    layer's routed experts are upcycled (Komatsuzaki et al., sparse
    upcycling, arXiv:2212.05055): one random MLP of the layer shared by
    its experts plus ``upcycle`` times an expert's own draw, over
    ``sqrt(1 + upcycle²)``. ``lm_head`` is times ``generator_scale``.
    ``only``: the names to make (all by default)."""
    import torch
    out = {}
    for i, (name, shape) in enumerate(param_spec(cfg).items()):
        if only is not None and name not in only:
            continue

        def draw(salt, shape=shape):
            x = torch.rand(shape, generator=device_generator(
                laws["seed"], dev, salt), device=dev, dtype=torch.float32)
            return x.mul_(2).sub_(1)
        x = draw(i + 1)
        keep = dtype
        if name.endswith("norm.weight"):
            x = 1 + x * laws["norm_scale"]
        elif name.endswith("e_score_correction_bias"):
            x, keep = x * laws["correction_bias"], torch.float32
        elif name.endswith("bias"):
            x = x * laws["bias"]
        elif name == "embed_tokens.weight":
            x = x * math.sqrt(3.0) * laws["embedding_rms"]
        else:
            fan = shape[-2] + shape[-1]
            if name.endswith("gate_up_proj"):
                fan = shape[-2] // 2 + shape[-1]
            if ".experts." in name:
                rho = laws["upcycle"]
                x = (draw(-(i + 1), shape[1:])[None] + rho * x) \
                    / math.sqrt(1 + rho * rho)
            x = x * math.sqrt(6.0 / fan)
            if name.endswith(("o_proj.weight", "down_proj.weight",
                              "experts.down_proj")):
                x = x * laws["residual_scale"]
            if name == "lm_head.weight":
                x = x * laws["generator_scale"]
        out[name] = x.to(keep)
        del x
    return out


class DecodeLM(decode.Decode):
    """One language-model decode cell's run."""

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
        self.weights = make_weights(cfg, self.dev, dt, cfg["weights"])
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
        self.log = logging.getLogger(decode.GENERATE_LOG)
        self.log.setLevel(logging.INFO)
        self.log.propagate = False
        if warm:
            self.one_pass(decode.warm_subset(self.dataset, d["turn_batch"],
                                             bool(cfg["sep_caption"])))
        gc.collect()
        gc.freeze()
        phase("warm_pass")

    def prompt_tokens(self, qa_id: int) -> int:
        """The real tokens of turn ``qa_id``'s prompt."""
        q, h, c, frames = self.turn_lengths(qa_id)
        blank = self.vocab["<blank>"]
        return sum(frames) + sum(t != blank for t in (*q, *h, *c))

    def pass_flops(self, nbest: dict) -> int:
        beam = self.tr["decode"]["beam"]
        total = 0
        for qa_id, hyps in nbest.items():
            frames = self.turn_lengths(qa_id)[3]
            steps = max(len(w.split()) for w, _ in hyps) + 1
            total += lm_counts.decode_turn(self.cfg, self.prompt_tokens(
                qa_id), frames, steps, beam)
        return total

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> None:
        super().window(seconds)
        self.probed = self.probe()

    def probe(self):
        """The check's probe, after the window (its time is not the
        window's): for each entry of the traffic's ``check.probe.prompts``
        (the prompt parts kept, of ``fts``, ``cap``, ``his`` and
        ``query``), the split's first turn batch with the other parts
        emptied (their tokens ``<blank>``, the streams of no frame),
        beam-decoded by the program as one eager batch. Returns (each
        valid row's ``(fts, cap, his, query, hyps)`` as the reference
        takes it, the program's scores of its hyps, the number of rows
        with no hypothesis)."""
        import dataclasses
        import torch
        from mtn_tpu_torch.decode.beam import BeamDecoder
        blank = self.vocab["<blank>"]
        dec = BeamDecoder(self.model, self.decode_cfg)
        tokens = lambda t, b: [x for x in t[b].tolist() if x != blank]
        turns, scores, empty = [], [], 0
        for keep in self.tr["check"]["probe"]["prompts"]:
            db = self.first_batch()
            cut = {p: torch.full_like(getattr(db, p), blank)
                   for p in ("cap", "his", "query") if p not in keep}
            if "fts" not in keep:
                cut["fts_len"] = tuple(torch.zeros_like(n)
                                       for n in db.fts_len)
            db = dataclasses.replace(db, **cut)
            results = dec.beam_results(dec.beam_eager(db), db.valid)
            rows = [b for b, v in enumerate(db.valid.tolist()) if v]
            for b, r in zip(rows, results):
                if r.tokens == [[]] and r.scores == [0.0]:  # no hypothesis
                    empty += 1
                    continue
                fts = [f[b, :int(n[b])] for f, n in zip(db.fts, db.fts_len)]
                turns.append((fts, tokens(db.cap, b), tokens(db.his, b),
                              tokens(db.query, b), list(r.tokens)))
                scores.append(list(r.scores))
        return turns, scores, empty

    # -- --trace 1 ------------------------------------------------------------
    def first_batch(self):
        """The pass's first turn batch on the device."""
        from mtn_tpu_torch.data.batching import (make_batch,
                                                 make_batch_indices,
                                                 uniform_plans)
        from mtn_tpu_torch.train.batch import to_device_fn
        d, dc = self.decode_cfg, self.data_cfg
        plans, _ = make_batch_indices(self.dataset, batchsize=d.turn_batch,
                                      max_length=10 ** 9,
                                      separate_caption=dc.separate_caption)
        if d.uniform_shapes:
            plans = uniform_plans(plans)
        hb = make_batch(self.dataset, plans[0],
                        separate_caption=dc.separate_caption, skip=dc.skip,
                        length_bucket=dc.length_bucket,
                        feature_bucket=dc.feature_bucket,
                        pad_rows_to=d.turn_batch)
        return to_device_fn(self.cfg["dtype"], None, self.dev)(hb)

    def trace(self) -> None:
        super().trace()
        if self.dev.type != "cuda":
            return
        from mtn_tpu_torch.decode.beam import BeamDecoder
        db = self.first_batch()
        dec = BeamDecoder(self.model, self.decode_cfg)
        self.obs["lm_prefill_ms"] = prefill_ms(dec, db)
        self.obs["moe_experts"] = expert_roofline(dec, db, self.cfg)

    # -- after the window -----------------------------------------------------
    def check(self):
        attempted = sum(p["turns"] for p in self.obs["passes"])
        answered = sum(p["responses"] for p in self.obs["passes"])
        checks = lm_scores(self, self.cell.limits, self.control)
        shutil.rmtree(self.tmp, ignore_errors=True)
        return checks, attempted, attempted - answered


def prefill_ms(dec, db) -> float:
    """Device ms of the kernels inside the span ``lm.prefill`` of one
    recorded eager batch (the driven span ``decode.eager_batch`` keeps the
    kernels; the prefill's span places them)."""
    from mtn_tpu_torch.utils import profiling
    from benchmark.harness.spans import union
    with profiling.recording() as rec:
        dec.beam_eager(db)
    spans = rec.records()["device"]
    eager = next(d for d in spans if d["name"] == "decode.eager_batch")
    pre = next(d for d in spans if d["name"] == "lm.prefill")
    lo, hi = pre["start_ns"], pre["end_ns"]
    inside = [(max(a, lo), min(b, hi)) for a, b in eager["kernels"]]
    return sum(b - a for a, b in union(inside)) / 1e6


def expert_roofline(dec, db, cfg: dict) -> dict:
    """One eager batch's decode steps under the profiler: the grouped
    GEMMs' device seconds, the bytes their steps' routing asked for, and
    their share of the HBM roofline (percent)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mtn_tpu_torch.decode.steps import beam_open, beam_step
    model, dcfg = dec.model, dec.cfg
    with torch.inference_mode():
        state, (*carry, self_kv) = dec.beam_prefix(db)
        step = dec._stepper(state)
        pos = torch.arange(dcfg.maxlen, device=db.query.device)
        rows = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for l in range(dcfg.maxlen):
                if dcfg.early_stop and not beam_open(carry[1], carry[2],
                                                     pos[l], dcfg):
                    break
                before = model.expert_rows.clone()
                *carry, self_kv = beam_step(step, pos[l], *carry, self_kv,
                                            dcfg, dec.eos, dec.unk)
                rows.append(model.expert_rows - before)
            torch.cuda.synchronize()
    seconds = 0.0
    for e in prof.key_averages():
        if e.key == "aten::_grouped_mm":
            seconds += e.device_time_total / 1e6
    nbytes = 0
    for r in rows:
        r = r.cpu()
        for touched, n in zip((r > 0).sum(1).tolist(), r.sum(1).tolist()):
            nbytes += lm_counts.expert_step_bytes(cfg, touched, n)
    pct = (100.0 * nbytes / (seconds * device.PEAK_BYTES_PER_S)
           if seconds else None)
    return {"steps": len(rows), "seconds": seconds, "bytes": nbytes,
            "roofline_pct": pct}


def lm_scores(run, limits: dict, control: str = ""):
    """``score_gap_per_token``, ``score_gap_rms``, ``probe_gap_rms`` and
    ``unscored`` of the sampled turns and the probe (:meth:`DecodeLM.
    probe`) against :class:`KimiVLLMReference` (see
    :func:`benchmark.harness.check.decode_scores`); each checked
    hypothesis's length and gap in ``run.hyp_gaps``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = KimiVLLMReference(run.cfg, run.weights)
    penalty = run.tr["decode"]["penalty"]
    rng = np.random.default_rng([run.seed, 17])
    unscored, turns, mine = 0, [], []
    for p, qa_id in check.sample_turns(run, rng):
        nbest = run.results[p].get(qa_id)
        if not nbest:
            unscored += 1
            continue
        hyps, scores = [], []
        for words, score in nbest:
            ids = [run.vocab.get(w) for w in words.split()]
            if None in ids:
                unscored += 1
                continue
            hyps.append(ids)
            scores.append(score)
        if not hyps:
            continue
        dialog, turn = run.turn_of(qa_id)
        q, h, c = turn_tokens(dialog, turn, run.vocab,
                              run.cfg["include_caption"])
        fts = [torch.from_numpy(a).to(run.dev)
               for a in run.corpus.features[dialog["image_id"]]]
        turns.append((fts, c, h, q, hyps))
        mine.append(scores)
    probe_turns, probe_mine, probe_empty = run.probed
    unscored += probe_empty
    every = turns + probe_turns
    theirs = ref.scores_many(every, penalty)
    mine = mine + probe_mine
    if control == "fp8":
        mine = KimiVLLMReference(run.cfg, run.weights,
                                 precision="fp8").scores_many(every, penalty)
    k = len(turns)
    main = hypothesis_gaps(turns, mine[:k], theirs[:k])
    probe = hypothesis_gaps(probe_turns, mine[k:], theirs[k:])
    run.hyp_gaps = {"main": main, "probe": probe}
    per_token = [g / (length + 1) for length, g in main]
    run.obs["checked_tokens"] = sum(length + 1 for length, _ in main)
    if main:
        lengths = [length for length, _ in main]
        qs = np.quantile(lengths, [0.25, 0.5, 0.75])
        run.obs["checked_lengths"] = {
            "hypotheses": len(lengths), "q1": float(qs[0]),
            "median": float(qs[1]), "q3": float(qs[2]),
            "max": int(max(lengths)),
            "from_5": int(sum(n >= 5 for n in lengths))}
        a, hg = np.abs(per_token), np.asarray([g for _, g in main])
        run.obs["gap_stats"] = {
            "p50": float(np.median(a)), "p90": float(np.quantile(a, 0.9)),
            "mean_signed": float(np.mean(per_token)),
            "hyp_abs_max": float(np.abs(hg).max()),
            "hyp_mean_signed": float(hg.mean())}
    if probe:
        run.obs["probe_lengths"] = {
            "hypotheses": len(probe),
            "median": float(np.median([length for length, _ in probe])),
            "from_5": int(sum(length >= 5 for length, _ in probe))}
    return check.as_checks({
        "score_gap_per_token": float(np.abs(per_token).max(initial=0.0)),
        "score_gap_rms": rms_per_token(main),
        "probe_gap_rms": rms_per_token(
            probe, run.tr["check"]["probe"].get("min_tokens", 0)),
        "unscored": unscored}, limits)


def hypothesis_gaps(turns, mine, theirs) -> list:
    """(tokens, program − reference score) of each hypothesis of
    ``turns``."""
    return [(len(hyp), a - b)
            for (*_, hyps), m, t in zip(turns, mine, theirs)
            for hyp, a, b in zip(hyps, m, t)]


def rms_per_token(gaps, min_tokens: int = 0) -> float:
    """The root mean square of the gaps per scored event (the tokens and
    the ``<eos>``) of the hypotheses of at least ``min_tokens`` tokens;
    0 where there is none."""
    per_event = [g / (n + 1) for n, g in gaps if n >= min_tokens]
    if not per_event:
        return 0.0
    return float(np.sqrt(np.mean(np.square(per_event))))


# the name the tools (tools/calibrate_lm.py, tools/lm_readings.py) and
# run.py's ``run`` build a cell's run by
Decode = DecodeLM


def run(cell, args, dev):
    return DecodeLM(cell, args.seed, dev, control=args.control)
