"""Corpus BLEU 1-4, COCO-caption semantics (pure Python 3).

Algorithm (matching pycocoevalcap's Bleu with option='closest'):
clipped n-gram counts summed over the corpus; cumulative geometric-mean
precisions with (+tiny)/(+small) guards; brevity penalty from the
per-sentence closest reference length.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

SMALL = 1e-9
TINY = 1e-15


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(refs: Dict[str, List[str]], hyps: Dict[str, List[str]],
                max_n: int = 4) -> List[float]:
    """refs/hyps: {img_id: [tokenized sentence string, ...]}; hyps have one
    sentence per image. Returns [Bleu_1..Bleu_max_n]."""
    import math
    guess = [0] * max_n
    correct = [0] * max_n
    testlen = 0
    reflen = 0
    for img_id, hyp_list in hyps.items():
        hyp = hyp_list[0].split()
        ref_lists = [r.split() for r in refs[img_id]]
        testlen += len(hyp)
        # closest reference length (ties -> shorter)
        reflen += min((len(r) for r in ref_lists),
                      key=lambda L: (abs(L - len(hyp)), L))
        for n in range(1, max_n + 1):
            hyp_ng = _ngrams(hyp, n)
            max_ref: Counter = Counter()
            for r in ref_lists:
                for ng, c in _ngrams(r, n).items():
                    if c > max_ref[ng]:
                        max_ref[ng] = c
            guess[n - 1] += max(0, len(hyp) - n + 1)
            correct[n - 1] += sum(min(c, max_ref[ng])
                                  for ng, c in hyp_ng.items())
    bleus = []
    prod = 1.0
    for n in range(max_n):
        prod *= (correct[n] + TINY) / (guess[n] + SMALL)
        bleus.append(prod ** (1.0 / (n + 1)))
    ratio = (testlen + TINY) / (reflen + SMALL)
    if ratio < 1.0:
        bp = math.exp(1.0 - 1.0 / ratio)
        bleus = [b * bp for b in bleus]
    return bleus
