"""Metric runner (reference utils/evaluate.py equivalent, SURVEY.md C14).

Prints ``Bleu_1..4, METEOR, ROUGE_L, CIDEr`` in the pycocoevalcap order
and format (``metric: %.3f``). SPICE is excluded exactly as the
reference's coco-caption.patch disables it (utils/coco-caption.patch:1-11).
METEOR is the pure-Python METEOR-1.5 ``en`` reimplementation (see
evalmetrics/meteor.py for the remaining resource-bound jar deltas).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

from mtn_tpu_torch.evalmetrics.bleu import corpus_bleu
from mtn_tpu_torch.evalmetrics.cider import cider
from mtn_tpu_torch.evalmetrics.convert import coco_to_corpora
from mtn_tpu_torch.evalmetrics.meteor import meteor
from mtn_tpu_torch.evalmetrics.rouge import rouge_l
from mtn_tpu_torch.evalmetrics.tokenizer import tokenize_corpus

METRIC_ORDER = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
                "CIDEr"]


def score_pairs(refs: Dict, hyps: Dict) -> Dict[str, float]:
    """refs/hyps: {img_id: [raw sentence, ...]} (hyps single-sentence)."""
    refs_t = tokenize_corpus(refs)
    hyps_t = tokenize_corpus(hyps)
    bleus = corpus_bleu(refs_t, hyps_t)
    out = {f"Bleu_{i + 1}": b for i, b in enumerate(bleus)}
    out["METEOR"] = meteor(refs_t, hyps_t)
    out["ROUGE_L"] = rouge_l(refs_t, hyps_t)
    out["CIDEr"] = cider(refs_t, hyps_t)
    return out


def score_files(reference_json: str, hypothesis_json: str,
                print_scores: bool = True) -> Dict[str, float]:
    with open(reference_json) as f:
        annotation = json.load(f)
    with open(hypothesis_json) as f:
        hypotheses = json.load(f)
    refs, hyps = coco_to_corpora(annotation, hypotheses)
    scores = score_pairs(refs, hyps)
    if print_scores:
        for m in METRIC_ORDER:
            print("%s: %.3f" % (m, scores[m]))
    return scores
