"""PTB-style caption tokenizer (pure Python 3).

The reference pipeline shells out to the Stanford PTBTokenizer Java jar
inside the vendored coco-caption tool (reference run.sh:94-98 clones
tylin/coco-caption, whose pycocoevalcap/tokenizer/ptbtokenizer.py runs
``java -cp stanford-corenlp-3.4.1.jar edu.stanford.nlp.process.PTBTokenizer
-preserveLines -lowerCase`` and then drops tokens found in its
PUNCTUATIONS list). To run without Java, the two stages are
reimplemented:

1. PTB3 tokenization, lowercased: clitic splitting (don't -> do n't,
   man's -> man 's, can't -> ca n't), lexicon splits (cannot -> can not,
   gonna -> gon na, ...), bracket escapes (``(`` -> ``-lrb-``), straight
   double quotes -> `` / '' by position, currency symbols split from
   amounts ($5 -> $ 5), comma-grouped numbers and acronyms kept whole
   (1,000 / u.s.).
2. The COCO punctuation drop, with the list copied verbatim.

Jar-law quirk, reproduced deliberately: the jar's ``-lowerCase`` flag
lowercases the bracket escapes to ``-lrb-``/``-rrb-`` but the COCO
PUNCTUATIONS list spells them uppercase (``-LRB-``), so the filter never
matches them — brackets SURVIVE COCO tokenization as ``-lrb-`` tokens.
We emit lowercase escapes and keep the uppercase list entries inert,
exactly like the real pipeline. Behavior is pinned by recorded goldens
in tests/test_metric_goldens.py.

DSTC7 text is already lowercase and space-separated with punctuation as
standalone tokens, so on this data the approximation is exact for every
class it exercises.
"""

from __future__ import annotations

import re
from typing import Dict, List

# the punctuation tokens the COCO PTBTokenizer wrapper removes, verbatim
# (pycocoevalcap/tokenizer/ptbtokenizer.py). The -LRB- family is inert
# against our lowercase escapes — see the jar-law quirk in the module
# docstring.
PUNCTUATIONS = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"}

# PTB3 bracket escapes (applied token-wise, already lowercased)
_BRACKETS = {"(": "-lrb-", ")": "-rrb-", "[": "-lsb-", "]": "-rsb-",
             "{": "-lcb-", "}": "-rcb-"}

# PTBLexer lexicon splits (Stanford PTBTokenizer splits these by rule)
_LEX_SPLITS = {"cannot": "can not", "gonna": "gon na", "gotta": "got ta",
               "wanna": "wan na", "lemme": "lem me", "gimme": "gim me"}
_LEX = re.compile(r"\b(%s)\b" % "|".join(_LEX_SPLITS), re.IGNORECASE)

# opening double quote: at start of text or after whitespace/open bracket
_OPEN_QUOTE = re.compile(r'(^|[\s([{])"')

_CLITIC = re.compile(r"(\w+)(n't)\b|(\w+)('(?:s|m|re|ve|ll|d))\b",
                     re.IGNORECASE)
_TOKEN = re.compile(
    r"\.\.\.|--|''|``|n't|'(?:s|m|re|ve|ll|d)\b"
    r"|(?:[a-z]\.){2,}"            # acronyms stay whole: u.s.
    r"|\d+(?:[,.]\d+)*(?!\w)"      # grouped numbers stay whole: 1,000 5.50
    r"|\w+(?:[.-]\w+)*"            # words incl. hyphen compounds
    r"|\S", re.IGNORECASE)


def tokenize(text: str) -> List[str]:
    text = text.lower().strip()
    # straight double quotes -> PTB `` / '' (both then dropped by COCO)
    text = _OPEN_QUOTE.sub(r"\1``", text).replace('"', "''")
    text = _LEX.sub(lambda m: _LEX_SPLITS[m.group(1)], text)
    # split clitics the PTB way: don't -> do n't, man's -> man 's
    text = _CLITIC.sub(lambda m: " ".join(g for g in m.groups() if g), text)
    toks = [_BRACKETS.get(t, t) for t in _TOKEN.findall(text)]
    return [t for t in toks if t not in PUNCTUATIONS]


def tokenize_corpus(captions: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """{img_id: [sentence, ...]} -> {img_id: ['tok tok ...', ...]}."""
    return {k: [" ".join(tokenize(s)) for s in v]
            for k, v in captions.items()}
