"""Vocabulary construction for DSTC7-AVSD dialogue JSON (the port's own
copy of ``mtn_tpu/data/vocab.py``, same laws):

- specials are fixed at ``<unk>:0, <blank>:1, <sos>:2, <eos>:3``;
- word frequency is counted over every question/answer turn, plus the
  caption and/or summary when ``include_caption`` selects them;
- the reference loops cutoffs 1..5 and keeps the *last* table, so the
  effective rule is "keep words with freq > 5" (data_handler.py:67-73).
  Here the cutoff is an explicit parameter defaulting to 5;
- insertion order (and therefore id assignment) follows the iteration
  order of the frequency dict, which in Python 3.7+ is first-seen order —
  the same as the reference running under Python 3.
- ``words2ids`` wraps each sentence in ``<sos> ... <eos>`` and maps OOV
  words to ``<unk>`` (data_handler.py:76-86).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List

import numpy as np

UNK, BLANK, SOS, EOS = "<unk>", "<blank>", "<sos>", "<eos>"
SPECIALS: Dict[str, int] = {UNK: 0, BLANK: 1, SOS: 2, EOS: 3}

_CAPTION_MODES = ("caption", "summary", "caption,summary")


def _caption_text(dialog: dict, include_caption: str) -> str:
    if include_caption in ("caption", "summary"):
        return dialog[include_caption]
    if include_caption == "caption,summary":
        # reference concatenates the raw strings (data_handler.py:54,98)
        return dialog["caption"] + dialog["summary"]
    return ""


def count_word_freq(dialog_data: dict, include_caption: str = "none") -> Dict[str, int]:
    freq: Dict[str, int] = {}
    for dialog in dialog_data["dialogs"]:
        if include_caption in _CAPTION_MODES:
            for word in _caption_text(dialog, include_caption).split():
                freq[word] = freq.get(word, 0) + 1
        for key in ("question", "answer"):
            for turn in dialog["dialog"]:
                for word in turn[key].split():
                    freq[word] = freq.get(word, 0) + 1
    return freq


def build_vocab(word_freq: Dict[str, int], cutoff: int = 5) -> Dict[str, int]:
    """Words with ``freq > cutoff``, ids after the 4 specials."""
    vocab = dict(SPECIALS)
    for word, freq in word_freq.items():
        if freq > cutoff:
            vocab[word] = len(vocab)
    return vocab


def get_vocabulary(dataset_file: str, cutoff: int = 5,
                   include_caption: str = "none") -> Dict[str, int]:
    with open(dataset_file) as f:
        dialog_data = json.load(f)
    return build_vocab(count_word_freq(dialog_data, include_caption), cutoff)


def words2ids(text: str, vocab: Dict[str, int]) -> np.ndarray:
    words = text.split()
    out = np.empty(len(words) + 2, dtype=np.int32)
    out[0] = vocab[SOS]
    unk = vocab[UNK]
    for i, w in enumerate(words):
        out[i + 1] = vocab.get(w, unk)
    out[-1] = vocab[EOS]
    return out


def ids2words(ids: Iterable[int], vocab_list: List[str],
              stop_at_eos: bool = True, eos_id: int = SPECIALS[EOS]) -> str:
    words = []
    for i in ids:
        if stop_at_eos and int(i) == eos_id:
            break
        words.append(vocab_list[int(i)])
    return " ".join(words)


def vocab_list(vocab: Dict[str, int]) -> List[str]:
    """Id-sorted word list (generate.py:24 equivalent)."""
    return sorted(vocab.keys(), key=lambda w: vocab[w])
