"""Training logs in the reference's CSV schema (the port's own copy of
``mtn_tpu/utils/logging.py``, same files and headers):

- ``<model>_train.csv``: ``epoch,step,loss,tokens_per_sec``;
- ``<model>_trace.csv``: ``epoch,split,avg_loss``;
- ``<model>_metrics.jsonl``: the same records as JSON lines;
- ``<model>_params.txt``: the flags, one ``name=value`` per line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any


class CSVLogger:
    def __init__(self, path: str, header: str, resume: bool = False):
        self.path = path
        if not (resume and os.path.exists(path)):
            with open(path, "w") as f:
                f.write(header + "\n")

    def append(self, *fields):
        with open(self.path, "a") as f:
            f.write(",".join(str(x) for x in fields) + "\n")


class TraceLogger:
    """The log files of one model prefix; ``resume=True`` appends to
    existing logs instead of starting them anew."""

    def __init__(self, model_prefix: str, resume: bool = False):
        self.train_csv = CSVLogger(model_prefix + "_train.csv",
                                   "epoch,step,loss,tokens_per_sec", resume)
        self.trace_csv = CSVLogger(model_prefix + "_trace.csv",
                                   "epoch,split,avg_loss", resume)
        self.jsonl_path = model_prefix + "_metrics.jsonl"
        if not (resume and os.path.exists(self.jsonl_path)):
            open(self.jsonl_path, "w").close()

    def train_step(self, epoch: int, step: int, loss: float,
                   tokens_per_sec: float):
        # the reference writes the loss in scientific notation
        self.train_csv.append(epoch, step, "%e" % loss, tokens_per_sec)
        self.metric({"kind": "train_step", "epoch": epoch, "step": step,
                     "loss": loss, "tokens_per_sec": tokens_per_sec})

    def epoch(self, epoch: int, split: str, avg_loss: float):
        self.trace_csv.append(epoch, split, "%e" % avg_loss)
        self.metric({"kind": "epoch", "epoch": epoch, "split": split,
                     "avg_loss": avg_loss})

    def metric(self, record: dict):
        record = dict(record, time=time.time())
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")


def dump_params_txt(path: str, *cfgs: Any):
    """Flag dump, one ``name=value`` per line."""
    with open(path, "w") as f:
        for cfg in cfgs:
            d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) \
                else dict(cfg)
            for k, v in d.items():
                f.write(f"{k}={v}\n")
