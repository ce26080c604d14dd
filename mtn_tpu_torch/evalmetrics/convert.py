"""DSTC7 dialogue JSON ↔ COCO-caption format converters + stopword filter.

Format parity with the reference stage-4 tools (SURVEY.md C13):

- :func:`build_annotation` mirrors utils/get_annotation.py:36-67 — COCO
  dict with ``annotations: [{image_id, id, caption}]`` and
  ``images: [{name: '<vid>_<turn>', id}]``, sequential ids starting at 1;
- :func:`build_hypotheses` mirrors utils/get_hypotheses.py:26-40 — a flat
  ``[{image_id, caption}]`` list in the same turn order;
- :class:`StopwordFilter` mirrors utils/stopword_filter.py:4-35 — each
  line of the stopword file is either one regex (drop matching words) or
  ``regex replacement`` (rewrite), anchored ``^...$``, first match wins.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional


class StopwordFilter:
    def __init__(self, filename: Optional[str] = None):
        self.pats = []
        if filename and os.path.exists(filename):
            with open(filename) as f:
                for ln in f:
                    ww = ln.split()
                    if len(ww) == 1:
                        self.pats.append((re.compile(r"^" + ww[0] + r"$"), ""))
                    elif len(ww) == 2:
                        self.pats.append((re.compile(r"^" + ww[0] + r"$"),
                                          ww[1]))

    def __call__(self, sentence: str) -> str:
        out = []
        for w in sentence.split():
            target = w
            for pat, rep in self.pats:
                v = pat.sub(rep, w)
                if v != w:
                    target = v
                    break
            if target != "":
                out.append(target)
        return " ".join(out)


def build_annotation(dialog_data: dict, stopwords: Optional[str] = None,
                     last_only: bool = False) -> dict:
    swf = StopwordFilter(stopwords) if stopwords else None
    annos, images = [], []
    cap_id = 1
    for dialog in dialog_data["dialogs"]:
        vid = dialog["image_id"]
        n_turns = len(dialog["dialog"])
        for n, qa in enumerate(dialog["dialog"]):
            if last_only and n != n_turns - 1:
                continue
            sent = qa["answer"]
            if swf:
                sent = swf(sent)
            annos.append({"image_id": cap_id, "id": cap_id, "caption": sent})
            images.append({"name": f"{vid}_{n}", "id": cap_id})
            cap_id += 1
    return {"info": {}, "licenses": [], "type": "captions",
            "annotations": annos, "images": images}


def build_hypotheses(result_data: dict, stopwords: Optional[str] = None,
                     last_only: bool = False) -> List[dict]:
    swf = StopwordFilter(stopwords) if stopwords else None
    annos = []
    image_id = 1
    for dialog in result_data["dialogs"]:
        n_turns = len(dialog["dialog"])
        for n, qa in enumerate(dialog["dialog"]):
            if last_only and n != n_turns - 1:
                continue
            sent = qa["answer"]
            if swf:
                sent = swf(sent)
            annos.append({"image_id": image_id, "caption": sent})
            image_id += 1
    return annos


def coco_to_corpora(annotation: dict, hypotheses: List[dict]):
    """COCO-format pair -> ({id: [refs]}, {id: [hyp]}) keyed by image id."""
    refs: Dict[int, List[str]] = {}
    for a in annotation["annotations"]:
        refs.setdefault(a["image_id"], []).append(a["caption"])
    hyps: Dict[int, List[str]] = {}
    for h in hypotheses:
        hyps.setdefault(h["image_id"], []).append(h["caption"])
    hyps = {k: v for k, v in hyps.items() if k in refs}
    return refs, hyps
