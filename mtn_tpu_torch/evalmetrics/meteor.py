"""METEOR (pure Python, METEOR-1.5 English parameterization).

The reference scores METEOR via the Java METEOR-1.5 jar inside
coco-caption (SURVEY.md C14; the reference's run.sh:96-97 and
utils/evaluate.py:6-15 invoke it ``-l en -norm``); with no Java to
run, METEOR is reimplemented:

- **Aligner** (``_align``): candidate matches from the exact and
  Porter-stem stages (no WordNet synonym / paraphrase tables — those
  require external resources), resolved the way the jar's ``Aligner``
  resolves them — among all matchings it prefers, in order: more
  matched words, fewer chunks, higher total matcher weight, smaller
  total |hyp_pos - ref_pos| — searched with a beam over partial
  alignments (width 40, the jar's), exact at caption lengths.
- **Scoring** (default, ``meteor``): METEOR 1.5 English parameters
  alpha=0.85 beta=0.2 gamma=0.6 delta=0.75 (Denkowski & Lavie 2011
  §2 / 2014, the jar's ``-l en`` defaults), with delta weighting
  content vs function words on both sides of P and R. The jar's
  function-word list is frequency-derived from a large corpus
  (rel. freq > 1e-3); an embedded curated closed-class list stands in.
- **2005 mode** (``meteor_2005``): the classic Banerjee & Lavie 2005
  constants (alpha=0.9 beta=3 gamma=0.5, no content/function split),
  kept for comparison; it shares the chunk-minimizing aligner (the
  2005 paper, §2, also specifies "the fewest possible chunks").

Identity law (1.5 mode only): a segment whose hypothesis and reference
are fully matched in a single contiguous chunk contributes zero chunks,
so scoring a corpus against itself yields 1.0 — the fixed-exponent
beta=0.2 penalty would otherwise punish even perfect matches, which no
published METEOR self-score does. 2005 mode needs no such law (its
(1/m)^3 penalty already vanishes).

Remaining deltas vs the jar, all resource-bound (docs/PARITY.md C14):
the synonym/paraphrase stages, the exact contents of the
frequency-derived function-word list, and jar-internal tie-breaking on
equally-scored references.

Corpus aggregation follows the jar (and pycocoevalcap): per segment the
best-scoring reference's sufficient statistics are kept, the sums are
scored once (micro-average).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from mtn_tpu_torch.evalmetrics.stem import porter_stem


def normalize(text: str, lowercase: bool = True) -> str:
    """The jar's ``-norm`` input pass, applied before alignment.

    Meteor 1.5's Normalizer implements the NIST mteval-v11b/13a
    normalization (the jar README: "normalize punctuation and
    tokenize"): strip SGML artifacts, unescape the four SGML entities,
    space-tokenize punctuation (keeping decimal points/commas inside
    numbers together), split a dash after a digit, collapse whitespace,
    and lowercase. On the DSTC7 pipeline's input this is nearly a no-op
    (convert.py already PTB-tokenizes and lowercases), but it makes the
    scorer's contract match the reference invocation
    (utils/evaluate.py:6-15: ``-l en -norm``) for raw text too.
    ``scripts/check_meteor_vs_jar.py`` verifies the equivalence when a
    jar is available.
    """
    s = text.replace("<skipped>", "")
    s = s.replace("-\n", "").replace("\n", " ")
    s = (s.replace("&quot;", '"').replace("&amp;", "&")
         .replace("&lt;", "<").replace("&gt;", ">"))
    s = f" {s} "
    if lowercase:
        s = s.lower()
    # tokenize punctuation except [.,] (handled digit-aware below):
    # the mteval character classes {-~ [-` space-& (-+ :-@ /
    s = re.sub(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])", r" \1 ", s)
    s = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", s)   # . , not after a digit
    s = re.sub(r"([\.,])([^0-9])", r" \1 \2", s)   # . , not before a digit
    s = re.sub(r"([0-9])(-)", r"\1 \2 ", s)        # dash after a digit
    return re.sub(r"\s+", " ", s).strip()

# METEOR 1.5 English ("rank" task) parameters — the jar's `-l en` defaults
ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
# Banerjee & Lavie 2005 constants (meteor_2005)
ALPHA_2005, BETA_2005, GAMMA_2005 = 0.9, 3.0, 0.5
# matcher-stage weights (jar defaults: exact 1.0, stem 0.6)
W_EXACT, W_STEM = 1.0, 0.6
BEAM_SIZE = 40  # the jar Aligner's partial-alignment beam width

# Curated closed-class English function words (articles, pronouns,
# prepositions, conjunctions, auxiliaries, particles). The jar derives
# its list from corpus frequency; this stands in for it.
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every either neither no
another such both all half several many much few more most little less
least own same other what which whose
i me my mine myself we us our ours ourselves you your yours yourself
yourselves he him his himself she her hers herself it its itself they
them their theirs themselves who whom one something anything nothing
everything someone anyone everyone nobody somebody everybody anybody
of in to for with on at by from up about into over after under between
out against during without before around among within along across
behind beyond except near off above below down past toward towards upon
till until since via per onto beneath beside besides amid amongst atop
and or nor but so yet although because while if unless whereas whether
though than as once whenever wherever
be am is are was were been being have has had having do does did doing
will would shall should can could may might must ought
not n't never also just only then there here when where why how again
ever still too very quite rather almost already always often sometimes
soon now perhaps maybe even indeed
's 'm 're 've 'll 'd
""".split())


def _candidates(hyp: List[str], ref: List[str]):
    """Per hyp index, the matchable ref indices with the weight of the
    highest-priority stage that matches the pair (exact before stem)."""
    hstem = [porter_stem(t) for t in hyp]
    rstem = [porter_stem(t) for t in ref]
    cands: List[List[Tuple[int, float]]] = []
    for i, ht in enumerate(hyp):
        row = []
        for j, rt in enumerate(ref):
            if ht == rt:
                row.append((j, W_EXACT))
            elif hstem[i] == rstem[j]:
                row.append((j, W_STEM))
        cands.append(row)
    return cands


def _align(hyp: List[str], ref: List[str]) -> List[Tuple[int, int, float]]:
    """Resolve candidate matches to one alignment by the jar's cascade:
    max matched words, then min chunks, then max total matcher weight,
    then min total position distance. Beam search over hyp positions
    (each state = one consistent partial matching); width 40 makes it
    exact for caption-length inputs. Returns (hyp_idx, ref_idx, weight)
    sorted by hyp_idx."""
    cands = _candidates(hyp, ref)
    # state: (n_matches, chunks, wsum, dist, used_ref_mask, last_pair,
    #         pairs) — cascade key = (-n, chunks, -wsum, dist)
    start = (0, 0, 0.0, 0, 0, None, ())
    states = [start]
    for i in range(len(hyp)):
        nxt = {}

        def push(st):
            key = (st[4], st[5])
            cur = nxt.get(key)
            if cur is None or (-st[0], st[1], -st[2], st[3]) < \
                    (-cur[0], cur[1], -cur[2], cur[3]):
                nxt[key] = st

        for n, ch, ws, ds, used, last, pairs in states:
            # option: hyp word i stays unmatched
            push((n, ch, ws, ds, used, last, pairs))
            for j, w in cands[i]:
                if used >> j & 1:
                    continue
                adjacent = last is not None and last == (i - 1, j - 1)
                push((n + 1, ch + (0 if adjacent else 1), ws + w,
                      ds + abs(i - j), used | (1 << j), (i, j),
                      pairs + ((i, j, w),)))
        states = sorted(nxt.values(),
                        key=lambda s: (-s[0], s[1], -s[2], s[3]))[:BEAM_SIZE]
    best = states[0]
    return list(best[6])


def _chunks(matches: List[Tuple[int, int, float]]) -> int:
    if not matches:
        return 0
    ch = 1
    for (h0, r0, _), (h1, r1, _) in zip(matches, matches[1:]):
        if h1 != h0 + 1 or r1 != r0 + 1:
            ch += 1
    return ch


def _weight(tok: str) -> float:
    """1.5 content/function weighting of one token (delta / 1-delta)."""
    return (1.0 - DELTA) if tok in FUNCTION_WORDS else DELTA


def _stats(hyp: List[str], ref: List[str]) -> Dict[str, float]:
    """Sufficient statistics of one (hyp, ref) pair for BOTH modes."""
    m = _align(hyp, ref)
    ch = _chunks(m)
    # 1.5 identity law: fully matched, single contiguous chunk -> the
    # segment carries no fragmentation (chunks15 = 0)
    perfect = (len(m) == len(hyp) == len(ref) and ch <= 1)
    return {
        # 2005 statistics
        "mw": sum(w for _, _, w in m),
        "m": len(m),
        "chunks": ch,
        "hlen": len(hyp),
        "rlen": len(ref),
        # 1.5 statistics (content/function-weighted)
        "chunks15": 0 if perfect else ch,
        "p_num": sum(w * _weight(hyp[i]) for i, _, w in m),
        "r_num": sum(w * _weight(ref[j]) for _, j, w in m),
        "p_den": sum(_weight(t) for t in hyp),
        "r_den": sum(_weight(t) for t in ref),
    }


def _score_2005(st: Dict[str, float]) -> float:
    if st["mw"] == 0 or st["hlen"] == 0 or st["rlen"] == 0:
        return 0.0
    p = st["mw"] / st["hlen"]
    r = st["mw"] / st["rlen"]
    fmean = p * r / (ALPHA_2005 * p + (1 - ALPHA_2005) * r)
    frag = st["chunks"] / st["m"] if st["m"] else 0.0
    return fmean * (1.0 - GAMMA_2005 * frag ** BETA_2005)


def _score_15(st: Dict[str, float]) -> float:
    if st["p_num"] == 0 or st["r_num"] == 0 \
            or st["p_den"] == 0 or st["r_den"] == 0:
        return 0.0
    p = st["p_num"] / st["p_den"]
    r = st["r_num"] / st["r_den"]
    fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
    frag = st["chunks15"] / st["m"] if st["m"] else 0.0
    return fmean * (1.0 - GAMMA * frag ** BETA)


def _corpus(refs: Dict[str, List[str]], hyps: Dict[str, List[str]],
            score_fn, normalize_input: bool = True) -> float:
    """Best-reference segment stats aggregated, then scored once.

    ``normalize_input`` applies the 1.5 jar's ``-norm`` mteval pass
    (the reference invocation, utils/evaluate.py:6-15). The 2005 mode
    predates ``-norm`` and scores the text as given (ADVICE r4: the
    pass must not silently change meteor_2005 for raw-text callers —
    on PTB-tokenized pipeline text it is a near no-op either way).
    """
    prep = normalize if normalize_input else (lambda s: s)
    agg: Dict[str, float] = {}
    for img_id, hyp_list in hyps.items():
        hyp = prep(hyp_list[0]).split()
        best, best_score = None, -1.0
        for ref_s in refs[img_id]:
            st = _stats(hyp, prep(ref_s).split())
            sc = score_fn(st)
            if sc > best_score:
                best, best_score = st, sc
        if best is not None:
            for k, v in best.items():
                agg[k] = agg.get(k, 0) + v
    return score_fn(agg) if agg else 0.0


def meteor(refs: Dict[str, List[str]], hyps: Dict[str, List[str]]) -> float:
    """Corpus METEOR, 1.5 English parameterization (the jar's mode)."""
    return _corpus(refs, hyps, _score_15)


def meteor_2005(refs: Dict[str, List[str]],
                hyps: Dict[str, List[str]],
                normalize_input: bool = False) -> float:
    """Corpus METEOR with the classic 2005 constants (comparison mode).

    The 2005 scorer predates the jar's ``-norm`` pass, so input is
    scored as given by default (ADVICE r4); pass
    ``normalize_input=True`` to opt into the mteval normalization."""
    return _corpus(refs, hyps, _score_2005, normalize_input=normalize_input)
