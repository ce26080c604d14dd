"""Sharding rules and layouts (``mtn_tpu/parallel/sharding.py``).

Tensor-parallel layout, Megatron's column→row pairing, so that each
attention and FFN block needs one reduce over ``model``:

- attention q/k/v projections: output (head) axis sharded, each rank
  holding ``att_h / model`` heads; the output projection ``w_o`` is
  row-sharded and its partial products are summed;
- FFN ``w_1`` column-sharded, ``w_2`` row-sharded;
- embeddings vocab-sharded (a rank looks up the ids in its rows, the
  ranks' lookups are summed); the generator projection vocab-sharded on
  its output, its logits gathered before the log-softmax;
- the video projections column-sharded, their outputs gathered;
- everything else (norms, the biases of row-sharded layers) replicated.

Specs are tuples of axis names (``()`` replicated, ``(None, "model")``
the last axis sharded), the ``PartitionSpec``s of JAX's rules, matched
against the flax parameter path (``a/b/c``; a ``state_dict`` name
``a.b.c`` is the same path) and applied only where every sharded axis
divides. A layer applies the rules of its parameters when it can run
them: an attention whose heads do not divide over ``model`` stays
replicated (in JAX, GSPMD would move its activations instead).

Data parallelism: a batch's rows are cut over ``data`` in contiguous
slabs, rank ``d`` taking rows ``[d·B/n, (d+1)·B/n)`` (:meth:`Shardings.
put_host_batch` cuts on the host, so each rank uploads only its rows).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from mtn_tpu_torch.data.batching import HostBatch
from mtn_tpu_torch.data.feature_cache import BF16Feature, QuantFeature
from mtn_tpu_torch.parallel.collectives import Axis, all_gather

Spec = Tuple[Optional[str], ...]


def default_rules() -> List[Tuple[str, Spec]]:
    return [
        (r"lut/embedding$", ("model", None)),
        (r"generator.*proj/kernel$", (None, "model")),
        (r"generator.*proj/bias$", ("model",)),
        (r"(w_q|w_k|w_v)/kernel$", (None, "model")),
        (r"(w_q|w_k|w_v)/bias$", ("model",)),
        (r"w_o/kernel$", ("model", None)),
        (r"w_1/kernel$", (None, "model")),
        (r"w_1/bias$", ("model",)),
        (r"w_2/kernel$", ("model", None)),
        (r"vid_encoder.*proj/kernel$", (None, "model")),
        (r"vid_encoder.*proj/bias$", ("model",)),
        # weight-only int8 (utils/quantize.py): the int8 kernels match the
        # kernel rules above; their per-output-channel scales follow the
        # kernel's output axis, sharded for the column-parallel kernels,
        # replicated for the row-parallel w_o/w_2
        (r"generator.*proj/kernel_scale$", ("model",)),
        (r"(w_q|w_k|w_v)/kernel_scale$", ("model",)),
        (r"w_1/kernel_scale$", ("model",)),
        (r"vid_encoder.*proj/kernel_scale$", ("model",)),
    ]


def _axis(mesh, name: str) -> Optional[Axis]:
    """``mesh``'s axis ``name`` as this rank sees it; None at size 1."""
    size = mesh.size(mesh.mesh_dim_names.index(name))
    if size == 1:
        return None
    return Axis(size, mesh.get_local_rank(name), mesh.get_group(name))


def _slab(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * n, n).clone()


def _rows(a, sl: slice):
    """Rows ``sl`` of a host array or a feature-cache block."""
    if isinstance(a, QuantFeature):
        return QuantFeature(q=a.q[sl], scale=a.scale[sl])
    if isinstance(a, BF16Feature):
        return BF16Feature(bits=a.bits[sl])
    return np.asarray(a)[sl]


class Layout:
    """Which axis of each parameter a model holds sharded over ``model``
    (``dims[name]``, None for a replicated one): full tensors to this
    rank's slabs and back."""

    def __init__(self, axis: Axis, dims: Dict[str, Optional[int]]):
        self.axis = axis
        self.dims = dims

    def sharded(self, name: str) -> bool:
        return self.dims.get(name) is not None

    def shard(self, tensors: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """Full tensors by name -> this rank's slabs."""
        return {n: t if self.dims.get(n) is None
                else _slab(t, self.dims[n], self.axis)
                for n, t in tensors.items()}

    def gather(self, tensors: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """This rank's slabs by name -> full tensors (a collective: every
        rank of the model axis calls it, in the same order)."""
        return {n: t if self.dims.get(n) is None
                else all_gather(t, self.axis, self.dims[n])
                for n, t in tensors.items()}


class Shardings:
    """The rules and this rank's place on the mesh: ``data`` and
    ``model`` are its :class:`Axis` on each, None where the axis has one
    rank."""

    def __init__(self, mesh=None, rules: List[Tuple[str, Spec]] = None,
                 data: Optional[Axis] = None, model: Optional[Axis] = None):
        self.mesh = mesh
        self.rules = rules if rules is not None else default_rules()
        self._compiled = [(re.compile(pat), spec) for pat, spec in self.rules]
        if mesh is not None:
            data, model = _axis(mesh, "data"), _axis(mesh, "model")
        self.data = data
        self.model = model
        self.model_size = model.size if model is not None else 1

    # -- parameters -----------------------------------------------------------
    def spec_for(self, path_str: str, leaf) -> Spec:
        ndim = len(getattr(leaf, "shape", ()))
        if self.model_size > 1:
            for pat, spec in self._compiled:
                if not pat.search(path_str) or len(spec) > ndim:
                    continue
                # apply only when every sharded dim divides evenly
                if all(name is None or leaf.shape[axis] % self.model_size
                       == 0 for axis, name in enumerate(spec)):
                    return spec
        return ()

    def tree_specs(self, tree: Mapping[str, Any], prefix: str = ""
                   ) -> Dict[str, Any]:
        """The spec of every leaf: a flat ``{"a.b.c": tensor}`` gives
        ``{"a.b.c": spec}``, a nested flax-style tree the same nesting."""
        out = {}
        for name, sub in tree.items():
            path = prefix + name.replace(".", "/")
            out[name] = (self.tree_specs(sub, path + "/")
                         if isinstance(sub, Mapping)
                         else self.spec_for(path, sub))
        return out

    def shard_model(self, model: torch.nn.Module) -> Optional[Layout]:
        """Cut ``model``'s sharded parameters (and int8 buffers) to this
        rank's slabs in place and put its layers in their tensor-parallel
        mode; returns the :class:`Layout` (None without a ``model`` axis).
        Under a ``data`` axis its dropout layers (those with a
        ``data_axis``) draw this rank's rows of the whole batch's masks.
        Call it once, on a model holding full tensors (or none yet: a
        trainer's fresh model, whose state is loaded through the
        layout)."""
        if self.data is not None:
            for mod in model.modules():
                if hasattr(mod, "data_axis"):
                    mod.data_axis = self.data
        if self.model is None:
            return None
        from mtn_tpu_torch.models.layers import (Embed, MultiHeadAttention,
                                                 ParamLinear)
        skip = set()
        for name, mod in model.named_modules():
            if isinstance(mod, MultiHeadAttention) and \
                    mod.n_heads % self.model_size:
                skip.update(f"{name}.{lin}" for lin in
                            ("w_q", "w_k", "w_v", "w_o"))
        dims: Dict[str, Optional[int]] = {}
        for name, t in model.state_dict().items():
            spec = self.spec_for(name.replace(".", "/"), t)
            owner = name.rsplit(".", 1)[0]
            dims[name] = (spec.index("model") if "model" in spec
                          and owner not in skip else None)
        for name, mod in model.named_modules():
            prefix = name + "." if name else ""
            if isinstance(mod, ParamLinear):
                d = dims.get(prefix + "kernel")
                if d is not None:
                    mod.set_parallel("column" if d == 1 else "row",
                                     self.model)
            elif isinstance(mod, Embed) and \
                    dims.get(prefix + "embedding") is not None:
                mod.set_parallel(self.model)
            for leaf, t in list(mod.named_parameters(recurse=False)) + \
                    list(mod.named_buffers(recurse=False)):
                d = dims.get(prefix + leaf)
                if d is None:
                    continue
                with torch.no_grad():
                    slab = _slab(t, d, self.model)
                if isinstance(t, torch.nn.Parameter):
                    t.data = slab
                else:
                    setattr(mod, leaf, slab)
        return Layout(self.model, dims)

    # -- batches ------------------------------------------------------------
    def rows(self, n: int) -> slice:
        """This data rank's rows of an ``n``-row batch."""
        if self.data is None:
            return slice(0, n)
        if n % self.data.size:
            raise ValueError(f"a batch of {n} rows does not divide over "
                             f"{self.data.size} data ranks")
        per = n // self.data.size
        return slice(self.data.rank * per, (self.data.rank + 1) * per)

    def put_batch(self, db):
        """This data rank's rows of a device batch (``DeviceBatch``)."""
        import dataclasses
        sl = self.rows(db.query.shape[0])
        cut = lambda t: t[sl]
        return dataclasses.replace(
            db, query=cut(db.query), his=cut(db.his), cap=cut(db.cap),
            answer_in=cut(db.answer_in), answer_out=cut(db.answer_out),
            fts=tuple(map(cut, db.fts)), fts_len=tuple(map(cut, db.fts_len)),
            valid=cut(db.valid))

    def put_host_batch(self, hb: HostBatch, device,
                       feature_dtype: str = "float32"):
        """This data rank's rows of a host batch, cut on the host and
        uploaded alone. The int8 transfer quantizes the whole block on
        the host first, then cuts (per-frame scales: the rows' bits do not
        depend on the cut)."""
        from mtn_tpu_torch.train.batch import device_batch, host_quant_int8
        sl = self.rows(hb.query.shape[0])
        fts = hb.fts
        if feature_dtype == "int8":
            fts = [f if isinstance(f, QuantFeature)
                   else QuantFeature(*host_quant_int8(
                       np.asarray(f, np.float32))) for f in fts]
        cap = hb.cap
        if cap is None:  # device_batch's all-<blank> caption law
            cap = np.ones((hb.query.shape[0], 1), dtype=np.int32)
        local = HostBatch(
            query=hb.query[sl], his=hb.his[sl], answer_in=hb.answer_in[sl],
            answer_out=hb.answer_out[sl], cap=cap[sl],
            fts=[_rows(f, sl) for f in fts],
            fts_len=[np.asarray(l)[sl] for l in hb.fts_len],
            valid=np.asarray(hb.valid)[sl], qa_ids=hb.qa_ids)
        return device_batch(local, device, feature_dtype)
