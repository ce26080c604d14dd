"""ROUGE-L F-measure (beta=1.2), COCO-caption semantics (pure Python 3):
per image, max precision and max recall over references via
longest-common-subsequence; F = (1+b²)PR / (R + b²P); mean over images.
"""

from __future__ import annotations

from typing import Dict, List

BETA = 1.2


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = cur[j - 1] if cur[j - 1] >= prev[j] else prev[j]
        prev = cur
    return prev[len(b)]


def rouge_l(refs: Dict[str, List[str]], hyps: Dict[str, List[str]]) -> float:
    scores = []
    for img_id, hyp_list in hyps.items():
        hyp = hyp_list[0].split()
        precs, recs = [], []
        for r in refs[img_id]:
            ref = r.split()
            lcs = _lcs_len(hyp, ref)
            precs.append(lcs / len(hyp) if hyp else 0.0)
            recs.append(lcs / len(ref) if ref else 0.0)
        p, r = max(precs), max(recs)
        if p != 0 and r != 0:
            scores.append(((1 + BETA ** 2) * p * r) / (r + BETA ** 2 * p))
        else:
            scores.append(0.0)
    return sum(scores) / len(scores) if scores else 0.0
