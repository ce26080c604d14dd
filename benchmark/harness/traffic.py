"""Dialogues in DSTC7-AVSD's layout, drawn from a traffic file's
parameters (the length law of ``chip_smoke.traffic_dialogs``, frozen
here).

Each dialog has ``turns`` question-answer turns, a caption and a
summary; word counts are lognormal around a median with a spread
``sigma``, rounded and clipped to ``[min, max]``; each video stream's
frame count is uniform in its range. The traffic file's
``lengths_seed`` draws every dialog's lengths and frame counts once, so
every run seed sees the same set of sizes: ``--seed`` only orders them
over the dialogs and draws the words and the features. The words are
the configuration's vocabulary (``w0`` ... after the four specials),
drawn uniformly; the features are standard normal, drawn on the run's
device.

:func:`write_corpus` writes a test set as the port's data pipeline reads
it: a JSON file in DSTC7's format, whose last answer of each dialog is
``__UNDISCLOSED__`` when ``undisclosed_only`` holds, and one ``.npy``
file of float32 features per video and stream under
``<root>/<FeaType>/<ImageID>.npy``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

N_SPECIALS = 4
UNDISCLOSED = "__UNDISCLOSED__"


def vocabulary(size: int) -> Dict[str, int]:
    """The specials, then ``w0``, ``w1``, ... up to ``size`` entries."""
    vocab = {"<unk>": 0, "<blank>": 1, "<sos>": 2, "<eos>": 3}
    for i in range(size - N_SPECIALS):
        vocab[f"w{i}"] = N_SPECIALS + i
    return vocab


def _lengths(rng, law: dict, n) -> np.ndarray:
    x = np.round(rng.lognormal(np.log(law["median"]), law["sigma"], n))
    return np.clip(x, law["min"], law["max"]).astype(np.int64)


@dataclass
class Corpus:
    dialogs: List[dict]            # DSTC7 dialogs, as written
    features: Dict[str, List[np.ndarray]]   # video -> one array a stream
    fea_types: List[str]
    test_set: str = ""             # the written JSON
    fea_path: str = ""             # '<root>/<FeaType>/<ImageID>.npy'


def make_dialogs(traffic: dict, seed: int, vocab_size: int,
                 streams: Dict[str, int], device="cpu") -> Corpus:
    """The traffic's dialogs and features (``streams``: feature type ->
    width, in the configuration's order); the features are drawn on
    ``device`` by a generator seeded from ``seed``, one call a stream."""
    import torch
    n, turns = traffic["dialogs"], traffic["turns"]
    shape_rng = np.random.default_rng(traffic["lengths_seed"])
    q = _lengths(shape_rng, traffic["question"], (n, turns))
    a = _lengths(shape_rng, traffic["answer"], (n, turns))
    cap = _lengths(shape_rng, traffic["caption"], n)
    summ = _lengths(shape_rng, traffic["summary"], n)
    frames = {ft: shape_rng.integers(lo, hi + 1, n)
              for ft, (lo, hi) in traffic["frames"].items()}
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    words = [f"w{i}" for i in range(vocab_size - N_SPECIALS)]
    total = int(q.sum() + a.sum() + cap.sum() + summ.sum())
    drawn = [words[i] for i in rng.integers(0, len(words), total)]
    at = [0]

    def say(k):
        at[0] += int(k)
        return " ".join(drawn[at[0] - int(k):at[0]])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    blocks = []
    for ft, width in streams.items():
        n_frames = frames[ft][order]
        flat = torch.randn(int(n_frames.sum()), width, generator=gen,
                           device=device).cpu().numpy()
        blocks.append(np.split(flat, np.cumsum(n_frames)[:-1]))
    dialogs, features = [], {}
    for d in range(n):
        s = order[d]
        vid = f"v{d:05d}"
        # a trailing space keeps the caption and summary strings apart
        dialogs.append({
            "image_id": vid, "caption": say(cap[s]) + " ",
            "summary": say(summ[s]),
            "dialog": [{"question": say(q[s, t]), "answer": say(a[s, t])}
                       for t in range(turns)]})
        features[vid] = [b[d] for b in blocks]
    if traffic.get("undisclosed_only"):
        for dl in dialogs:
            dl["dialog"][-1]["answer"] = UNDISCLOSED
    return Corpus(dialogs=dialogs, features=features,
                  fea_types=list(streams))


def write_corpus(corpus: Corpus, root: str) -> Corpus:
    """Write the test set and its features under ``root``."""
    corpus.test_set = os.path.join(root, "test_set.json")
    with open(corpus.test_set, "w") as f:
        json.dump({"type": "test", "version": "0.1",
                   "dialogs": corpus.dialogs}, f)
    corpus.fea_path = os.path.join(root, "<FeaType>", "<ImageID>.npy")
    for j, ft in enumerate(corpus.fea_types):
        os.makedirs(os.path.join(root, ft))
        for vid, arrays in corpus.features.items():
            np.save(os.path.join(root, ft, vid + ".npy"), arrays[j])
    return corpus
