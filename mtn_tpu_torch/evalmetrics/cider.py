"""CIDEr (pure Python 3), COCO-caption semantics.

TF-IDF n-gram (n=1..4) cosine similarity with candidate-count clipping
and a Gaussian length penalty (sigma=6), document frequencies from the
evaluated reference corpus, final score = 10 × mean over n of the
ref-averaged similarity.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

N = 4
SIGMA = 6.0


def _counts(tokens: List[str]) -> List[Counter]:
    return [Counter(tuple(tokens[i:i + n])
                    for i in range(len(tokens) - n + 1))
            for n in range(1, N + 1)]


def _tfidf(counts: List[Counter], df: Dict[Tuple, float], log_n_images: float):
    vecs, norms, length = [], [], 0
    for n, cnt in enumerate(counts):
        vec = {}
        norm = 0.0
        for ng, c in cnt.items():
            idf = log_n_images - math.log(max(1.0, df.get(ng, 0.0)))
            vec[ng] = float(c) * idf
            norm += vec[ng] ** 2
            if n == 0:
                length += c
        vecs.append(vec)
        norms.append(math.sqrt(norm))
    return vecs, norms, length


def cider(refs: Dict[str, List[str]], hyps: Dict[str, List[str]]) -> float:
    # document frequency over reference corpus: one count per image whose
    # references contain the n-gram
    df: Dict[Tuple, float] = defaultdict(float)
    for img_id, ref_list in refs.items():
        seen = set()
        for r in ref_list:
            for cnt in _counts(r.split()):
                seen.update(cnt.keys())
        for ng in seen:
            df[ng] += 1.0
    log_n = math.log(max(len(refs), 1e-12))
    scores = []
    for img_id, hyp_list in hyps.items():
        h_vec, h_norm, h_len = _tfidf(_counts(hyp_list[0].split()), df, log_n)
        img_score = [0.0] * N
        for r in refs[img_id]:
            r_vec, r_norm, r_len = _tfidf(_counts(r.split()), df, log_n)
            delta = float(h_len - r_len)
            for n in range(N):
                val = 0.0
                for ng, hv in h_vec[n].items():
                    # candidate counts clipped to the reference's
                    val += min(hv, r_vec[n].get(ng, 0.0)) * r_vec[n].get(ng, 0.0)
                if h_norm[n] != 0 and r_norm[n] != 0:
                    val /= h_norm[n] * r_norm[n]
                val *= math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
                img_score[n] += val
        n_refs = len(refs[img_id])
        scores.append(10.0 * sum(s / n_refs for s in img_score) / N)
    return sum(scores) / len(scores) if scores else 0.0
