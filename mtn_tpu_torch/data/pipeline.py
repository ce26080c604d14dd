"""Host-side prefetching batch iterator and the epoch shuffle (the port's
own copy of ``mtn_tpu/data/pipeline.py``, same laws):

- batches are made in a producer thread, ahead of the consumer by at most
  ``cfg.prefetch`` (a bounded queue); a ``transform`` (e.g. the copy to the
  device) runs in that thread too; an error there is raised in the
  consumer;
- batch ``i`` draws its ``cut_a`` truncations from
  ``np.random.default_rng((*seed_key, start + i))``: a pure function of
  (seed, epoch, batch index), so a run resumed mid-epoch draws what an
  uninterrupted run draws;
- :func:`shuffled` permutes the plans with the generator it is given
  (``default_rng([rand_seed, epoch])`` in the train CLI): with numpy's
  draws the order equals ``mtn_tpu``'s for the same seed;
- features are read by the C++ loader unless ``cfg.use_native_loader`` is
  off, through ``feature_cache`` when one is given.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Sequence

import numpy as np

from mtn_tpu_torch.config import DataConfig
from mtn_tpu_torch.data.batching import BatchPlan, HostBatch, make_batch
from mtn_tpu_torch.data.dataset import DialogueDataset

_SENTINEL = object()


class BatchIterator:
    """Iterate the batches of ``plans``, made in a background thread."""

    def __init__(self, data: DialogueDataset, plans: Sequence[BatchPlan],
                 cfg: DataConfig, train: bool, transform=None,
                 seed_key: Sequence[int] = (), start: int = 0,
                 feature_cache=None):
        self.data = data
        self.plans = list(plans)
        self.cfg = cfg
        self.cut_a = cfg.cut_a and train
        self.transform = transform
        self.seed_key = tuple(seed_key)
        self.start = start
        self.feature_cache = feature_cache

    def _make(self, plan: BatchPlan, idx: int) -> HostBatch:
        cfg = self.cfg
        rng = (np.random.default_rng((*self.seed_key, self.start + idx))
               if self.cut_a else None)
        hb = make_batch(
            self.data, plan, separate_caption=cfg.separate_caption,
            skip=cfg.skip, cut_a=self.cut_a, cut_a_p=cfg.cut_a_p, rng=rng,
            length_bucket=cfg.length_bucket,
            feature_bucket=cfg.feature_bucket,
            pad_rows_to=(cfg.batch_size if cfg.pad_batch_to_full else 0),
            use_native_loader=cfg.use_native_loader,
            feature_cache=self.feature_cache)
        return self.transform(hb) if self.transform is not None else hb

    def __len__(self) -> int:
        return len(self.plans)

    def __iter__(self) -> Iterator[HostBatch]:
        if self.cfg.prefetch <= 0:
            for i, plan in enumerate(self.plans):
                yield self._make(plan, i)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.cfg.prefetch)
        err: List[BaseException] = []

        def producer():
            try:
                for i, plan in enumerate(self.plans):
                    q.put(self._make(plan, i))
            except BaseException as e:  # re-raised by the consumer below
                err.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        t.join()
        if err:
            raise err[0]


def shuffled(plans: Sequence[BatchPlan],
             rng: np.random.Generator) -> List[BatchPlan]:
    """The epoch shuffle of the batch plans."""
    order = rng.permutation(len(plans))
    return [plans[i] for i in order]
