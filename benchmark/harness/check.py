"""The comparison that decides ``correct``.

Decode: once the window has closed and the program's state is freed, a
sample of the window's turns, drawn from the seed (``check.turns`` turns,
each from a pass drawn at random, and the ``check.longest`` turns whose
best hypothesis is longest in the last pass), is scored by the plain
reference (:mod:`benchmark.reference.mtn_ref`) in float32 with TF32
off: each returned hypothesis's tokens and its ``<eos>``, teacher
forced, give the beam score the program reported for it. The number
compared is the widest gap between the two scores over the sample, per
scored event (the hypothesis's tokens and its ``<eos>``):
``score_gap_per_token``. ``unscored`` counts sampled turns with no
n-best and hypotheses whose words are not in the vocabulary; its limit
is 0.

The control (``--control fp8``, never in a measured run) is the
reference computed in float8 (``MTNReference(precision="fp8")``) put in
the program's place: its scores of the same hypotheses stand for the
program's.

``checked_lengths`` (in the run's observations, on stderr) gives the
checked hypotheses' lengths in tokens: how far into the decoder's
positions the comparison reaches.
"""

from __future__ import annotations

from typing import List

import numpy as np


def as_checks(values: dict, limits: dict) -> List[dict]:
    return [{"name": k, "value": float(v), "limit": float(limits[k])}
            for k, v in values.items()]


def passed(checks: List[dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks)


def sample_turns(run, rng) -> list:
    """(pass index, turn id) pairs: random ones, then the longest."""
    spec = run.tr["check"]
    results = run.results
    ids = sorted(results[-1])
    picks = [(int(rng.integers(len(results))), int(t))
             for t in rng.choice(ids, min(spec["turns"], len(ids)),
                                 replace=False)]
    longest = sorted(ids, key=lambda t: -len(
        results[-1][t][0][0].split()) if results[-1][t] else 0)
    picks += [(len(results) - 1, t) for t in longest[:spec["longest"]]]
    return list(dict.fromkeys(picks))


def decode_scores(run, limits: dict, control: str = "") -> List[dict]:
    import torch
    from benchmark.reference.mtn_ref import MTNReference, turn_tokens
    from benchmark.drivers.decode import reference_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = run.dev
    ref = MTNReference(reference_config(run.cfg), run.weights)
    stand_in = MTNReference(reference_config(run.cfg), run.weights,
                            precision=control) if control == "fp8" else None
    penalty = run.tr["decode"]["penalty"]
    rng = np.random.default_rng([run.seed, 17])
    gap, unscored, tokens = 0.0, 0, 0
    gaps, hyp_gaps, lengths = [], [], []
    for p, qa_id in sample_turns(run, rng):
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
        t = lambda x: torch.tensor([x], dtype=torch.long, device=dev)
        fts = [torch.from_numpy(a)[None].to(dev)
               for a in run.corpus.features[dialog["image_id"]]]
        ref_scores = ref.hypothesis_scores(t(q), t(h), t(c), fts, hyps,
                                           penalty)
        if stand_in is not None:
            scores = stand_in.hypothesis_scores(t(q), t(h), t(c), fts, hyps,
                                                penalty)
        for hyp, mine, theirs in zip(hyps, scores, ref_scores):
            gap = max(gap, abs(mine - theirs) / (len(hyp) + 1))
            gaps.append((mine - theirs) / (len(hyp) + 1))
            hyp_gaps.append(mine - theirs)
            tokens += len(hyp) + 1
            lengths.append(len(hyp))
    run.obs["checked_tokens"] = tokens
    if lengths:
        q = np.quantile(lengths, [0.25, 0.5, 0.75])
        run.obs["checked_lengths"] = {
            "hypotheses": len(lengths), "q1": float(q[0]),
            "median": float(q[1]), "q3": float(q[2]),
            "max": int(max(lengths)),
            "from_5": int(sum(n >= 5 for n in lengths))}
    a, h = np.abs(gaps), np.asarray(hyp_gaps)
    run.obs["gap_stats"] = {
        "p50": float(np.median(a)), "p90": float(np.quantile(a, 0.9)),
        "mean_signed": float(np.mean(gaps)),
        "rms": float(np.sqrt(np.mean(np.square(gaps)))),
        "hyp_abs_max": float(np.abs(h).max()),
        "hyp_mean_signed": float(h.mean())} if gaps else {}
    return as_checks({"score_gap_per_token": gap, "unscored": unscored},
                     limits)
