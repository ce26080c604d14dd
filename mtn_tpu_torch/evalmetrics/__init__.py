"""Captioning metrics for stage-4 scoring: the port's own copy of
``mtn_tpu/evalmetrics`` (pure Python; the code differs only in its
imports)."""

from mtn_tpu_torch.evalmetrics.scorer import score_files, score_pairs
from mtn_tpu_torch.evalmetrics.convert import (build_annotation,
                                               build_hypotheses,
                                               StopwordFilter)

__all__ = ["score_files", "score_pairs", "build_annotation",
           "build_hypotheses", "StopwordFilter"]
