"""DSTC7-AVSD dialogue flattening (the port's own copy of
``mtn_tpu/data/dataset.py``, same laws):

- each dialog is flattened into per-turn examples
  ``[vid, qa_id, history, question, answer_in, answer_out, (caption)]``;
- the caption is ``words2ids`` of caption / summary / their raw-string
  concatenation, else a single ``<blank>`` token;
- history starts from the caption (or a lone ``<blank>`` when the caption
  is separate) followed by the flat concatenation of the prior QA pairs,
  optionally truncated to the last ``max_history_length`` turns;
- ``merge_source`` prepends ``caption + history`` onto the question;
- ``answer_in = answer[:-1]`` (keeps <sos>), ``answer_out = answer[1:]``;
- ``undisclosed_only`` keeps only the final turn and raises unless its
  answer is ``__UNDISCLOSED__``.

Video features are registered lazily (header-only reads) via
:class:`mtn_tpu_torch.data.features.FeatureRegistry`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from mtn_tpu_torch.data.features import FeatureRegistry
from mtn_tpu_torch.data.vocab import BLANK, words2ids

_CAPTION_MODES = ("caption", "summary", "caption,summary")


@dataclass
class Turn:
    vid: str
    qa_id: int
    history: np.ndarray
    question: np.ndarray
    answer_in: np.ndarray
    answer_out: np.ndarray
    caption: Optional[np.ndarray] = None  # only when separate_caption


@dataclass
class DialogueDataset:
    turns: List[Turn]
    vocab: Dict[str, int]
    features: Optional[FeatureRegistry]
    original: dict  # raw parsed JSON (the generate CLI copies its dialogs)

    def __len__(self) -> int:
        return len(self.turns)

    def feature_dims(self) -> List[int]:
        return self.features.feature_dims() if self.features else []


def load(fea_types: Optional[Sequence[str]], fea_path: str, dataset_file: str,
         vocab: Dict[str, int], include_caption: str = "none",
         separate_caption: bool = False, max_history_length: int = -1,
         merge_source: bool = False, undisclosed_only: bool = False
         ) -> DialogueDataset:
    with open(dataset_file) as f:
        dialog_data = json.load(f)
    blank = np.array([vocab[BLANK]], dtype=np.int32)
    turns: List[Turn] = []
    vid_set: List[str] = []
    seen = set()
    qa_id = 0
    for dialog in dialog_data["dialogs"]:
        if include_caption in ("caption", "summary"):
            caption = words2ids(dialog[include_caption], vocab)
        elif include_caption == "caption,summary":
            caption = words2ids(dialog["caption"] + dialog["summary"], vocab)
        else:
            caption = blank
        questions = [words2ids(d["question"], vocab) for d in dialog["dialog"]]
        answers = [words2ids(d["answer"], vocab) for d in dialog["dialog"]]
        qa_pairs = [np.concatenate((q, a)).astype(np.int32)
                    for q, a in zip(questions, answers)]
        vid = dialog["image_id"]
        if vid not in seen:
            seen.add(vid)
            vid_set.append(vid)
        turn_range = (range(len(questions) - 1, len(questions))
                      if undisclosed_only else range(len(questions)))
        for n in turn_range:
            if undisclosed_only and \
                    dialog["dialog"][n]["answer"] != "__UNDISCLOSED__":
                raise ValueError(f"{vid} turn {n}: answer is disclosed")
            head = blank if (include_caption in _CAPTION_MODES
                             and separate_caption) else caption
            start = max(0, n - max_history_length) if max_history_length > 0 else 0
            if start < n:
                history = np.concatenate([head] + qa_pairs[start:n]).astype(np.int32)
            else:
                history = head
            question = questions[n]
            if merge_source:
                question = np.concatenate((caption, history, question)).astype(np.int32)
            turns.append(Turn(
                vid=vid, qa_id=qa_id, history=history, question=question,
                answer_in=answers[n][:-1], answer_out=answers[n][1:],
                caption=caption if (include_caption in _CAPTION_MODES
                                    and separate_caption) else None,
            ))
            qa_id += 1
    registry = None
    if fea_types is not None and len(fea_types) > 0 and fea_types[0] != "none":
        registry = FeatureRegistry(fea_types, fea_path, vid_set)
    return DialogueDataset(turns=turns, vocab=vocab, features=registry,
                           original=dialog_data)
