"""Ahead-of-time decode export (``mtn_tpu/utils/aot.py``): a hermetic
serving artifact made with ``torch.export``.

The live session (:mod:`mtn_tpu_torch.serve`) reads a checkpoint, builds
``MTN`` and runs the decode loops in Python model code. This module
exports the decode once into an artifact directory, and
:class:`AotSession` serves it:

- **hermetic**: the directory holds the exported programs
  (``torch.export.save``), one weights file, the vocabulary and the
  config sidecars. Loading reads nothing else, never opens the
  checkpoint and never constructs ``MTN`` or imports the model code; it
  needs only the three ops that the programs call, registered by
  :mod:`mtn_tpu_torch.ops.attention_kernel`,
  :mod:`mtn_tpu_torch.ops.ffn_kernel` and
  :mod:`mtn_tpu_torch.ops.norm_kernel`, so on the card an artifact
  decodes through the hand-written kernels.
- **one device**: the programs are traced for the device they were
  exported on (``meta.json``'s ``device``); a session on another device
  raises.
- **shape-frozen**: row buckets and every sequence and feature length
  are fixed at export (``meta.json``); the session pads requests to
  them, chunks larger bursts over the buckets, refuses too-long token
  sequences and truncates frames.

Where ``jax.export`` froze the whole beam loop (a ``lax.while_loop``),
the artifact holds two programs for it: a **prefix** (encoder,
auto-encoder chain and every cross-attention K/V of B turns, where the
attention kernel runs) and a **step** (one decode position, where the
FFN kernel runs). The step is the function the live loop calls
(:mod:`mtn_tpu_torch.decode.steps`), at a 0-d tensor position, with the
decode state and the KV caches flattened to plain tensors at the
program boundary. The session wraps them in the live decode's program
sets (:mod:`mtn_tpu_torch.decode.graphs`), one for each row bucket and
the rank shape, built at :meth:`AotSession.warmup` (the artifact's
shapes are frozen, the role of JAX compiling the artifact at load): the
prefix program tiles the state over the beam or the candidates and
zeroes the caches, and the loop runs the step under the live loop's
early-stop test. On the card each decode is then one graph launch, the
exit test on the device, as JAX's exported loop is one program; on the
CPU the same sets run their loop on the host. So an artifact's answers
are the live session's at the same frozen shapes, bit for bit. The
sample step takes its uniforms as an input, drawn by the live law
(``draw_seed(seed, fold, position)`` on the session's device). A stream
runs the one-row prefix and the exported stream step in a
:class:`~mtn_tpu_torch.decode.graphs.StreamPrograms` set, the prefix
replayed once and the step once a token, as JAX's artifact runs its
``stream_prefix`` and ``stream_step`` programs. Every program takes the
model's tensors as its leading inputs, so an artifact stores its
weights once (``weights.pt``), whatever its number of programs.

Programs: ``decode_b{B}_prefix.pt2`` for each row count used, and
``decode_b{B}_step.pt2`` for each row bucket (beam, greedy or sample, by
``--decode-style``); ``rank_step.pt2`` with ``--rank N,L`` (one turn's
state tiled over N candidates of L tokens, the teacher-forced step, as
the live ``_rank``);
``stream_step_{greedy,sample}.pt2`` (one row) unless ``--stream 0``.
Rank and stream take the one-row prefix. ``meta.json`` is written last
with a fresh ``export_id``, which the serving watcher polls.

Usage::

    python -m mtn_tpu_torch.utils.aot export --model exps/x/mtn_best \\
        --out exps/x/aot --batches 1,16 --frames 64,32 --rank 100,24
    python -m mtn_tpu_torch.utils.aot info exps/x/aot
    python -m mtn_tpu_torch.utils.aot run exps/x/aot \\
        --question "what is he doing ?"
    python -m mtn_tpu_torch.serve_http --aot exps/x/aot

Each runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the ops the exported programs call: importing registers them
from mtn_tpu_torch.ops import (attention_kernel, ffn_kernel,  # noqa: F401
                               norm_kernel)
from mtn_tpu_torch.config import DecodeConfig, _to_jsonable, config_from_dict
from mtn_tpu_torch.data.vocab import vocab_list, words2ids
from mtn_tpu_torch.decode.graphs import (BeamPrograms, ProgramSet,
                                         RankPrograms, StreamPrograms,
                                         TokenPrograms, eager_stream)
from mtn_tpu_torch.decode.steps import (beam_init, beam_step,
                                        completions_to_results, cut_rows,
                                        detokenize, draw_seed,
                                        gumbel_uniforms, rank_inputs,
                                        rank_step, token_step)
from mtn_tpu_torch.evalmetrics.retrieval import rank_of
from mtn_tpu_torch.serve import DecodeResult, Request, encode_requests

log = logging.getLogger(__name__)

META = "meta.json"
VOCAB = "vocab.json"
CONF = "conf.json"
WEIGHTS = "weights.pt"
RANK_STEP = "rank_step.pt2"
STREAM_STYLES = ("greedy", "sample")
BEAM_CARRY = 5   # tok_buf, scores, comp_scores, comp_buf, comp_len


def prefix_blob(B: int) -> str:
    return f"decode_b{B}_prefix.pt2"


def step_blob(B: int) -> str:
    return f"decode_b{B}_step.pt2"


def stream_step_blob(style: str) -> str:
    return f"stream_step_{style}.pt2"


# -- host-side shape fitting (export and session) -----------------------------
def fit_tokens(arr: np.ndarray, L: int, what: str, pad: int) -> np.ndarray:
    """(B, l) tokens padded to the exported length ``L``; longer raises."""
    if arr.shape[1] > L:
        raise ValueError(
            f"{what} length {arr.shape[1]} exceeds the exported {what}_len "
            f"{L}; re-export with a larger --{what}-len")
    out = np.full((arr.shape[0], L), pad, np.int64)
    out[:, :arr.shape[1]] = arr
    return out


def fit_features(arr: np.ndarray, ln: np.ndarray,
                 T: int) -> Tuple[np.ndarray, np.ndarray]:
    """(B, t, D) frames cut or zero-padded to the exported ``T``."""
    B, t, D = arr.shape
    out = np.zeros((B, T, D), np.float32)
    out[:, :min(t, T)] = arr[:, :T]
    return out, np.minimum(ln, T).astype(np.int64)


def batch_inputs(hb, meta: dict, pad: int, device,
                 feature_dtype: torch.dtype) -> List[torch.Tensor]:
    """A host batch as a prefix program's inputs: ``(query, his, cap,
    *fts, *fts_len)`` at the frozen shapes; features travel in the
    session's feature dtype, as the live session sends them."""
    toks = [fit_tokens(hb.query, meta["query_len"], "query", pad),
            fit_tokens(hb.his, meta["his_len"], "his", pad),
            fit_tokens(hb.cap, meta["cap_len"], "cap", pad)]
    fts, lens = [], []
    for f, ln, T in zip(hb.fts, hb.fts_len, meta["frames"]):
        ft, n = fit_features(f, ln, T)
        fts.append(torch.from_numpy(ft).to(device=device,
                                           dtype=feature_dtype))
        lens.append(torch.from_numpy(n).to(device))
    return [torch.from_numpy(t).to(device) for t in toks] + fts + lens


# -- export ---------------------------------------------------------------------
class _Bound(torch.nn.Module):
    """``fn(*inputs)`` where ``fn`` reads ``model`` (a submodule, so that
    ``functional_call`` can swap in the tensors given as inputs)."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(*inputs)


class _Program(torch.nn.Module):
    """An exportable program whose leading inputs are the model's
    tensors, in the order of ``names``: its graph holds no weight."""

    def __init__(self, model: torch.nn.Module, names: Sequence[str], fn):
        super().__init__()
        # not registered as a submodule: its tensors are inputs here
        object.__setattr__(self, "bound", _Bound(model, fn))
        self.names = list(names)

    def forward(self, *args):
        n = len(self.names)
        tensors = {"model." + k: t for k, t in zip(self.names, args[:n])}
        return torch.func.functional_call(self.bound, tensors,
                                          tuple(args[n:]))


def model_tensors(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``model`` by name (the positional
    tables too): the weights file of an artifact."""
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return {k: v.detach() for k, v in out.items()}


def _state_leaves(state) -> List[torch.Tensor]:
    leaves: List[torch.Tensor] = []
    state.map(lambda t: leaves.append(t) or t)
    return leaves


def _state_from(template, leaves):
    it = iter(leaves)
    return template.map(lambda _: next(it))


def _kv_leaves(self_kv) -> List[torch.Tensor]:
    return [t for kv in self_kv for t in kv]


def _kv_from(leaves) -> tuple:
    return tuple(zip(leaves[0::2], leaves[1::2]))


def export_decode(model_arg: str, out_dir: str, *, batch: int = 8,
                  query_len: int = 32, his_len: int = 128, cap_len: int = 64,
                  frames: Optional[Sequence[int]] = None,
                  decode_cfg: Optional[DecodeConfig] = None,
                  device: str = "cuda",
                  model_overrides: Optional[Dict] = None,
                  batches: Optional[Sequence[int]] = None,
                  rank: Optional[Tuple[int, int]] = None,
                  weights_quant: str = "", stream: bool = True) -> dict:
    """Export the decode programs of ``model_arg`` (a checkpoint prefix,
    as the live session takes it) into ``out_dir``; returns the meta dict
    written to ``meta.json``.

    ``frames``: the frozen frame count of each feature stream (64 each by
    default). ``batches``: the frozen row buckets (default ``[batch]``).
    ``decode_cfg.decode_style`` selects beam, greedy or sample programs.
    ``rank=(N, L)`` adds the rank step (one turn, N candidates of padded
    length L). ``weights_quant`` ("int8", "int8-fp-head"): the
    live session's weight-only int8 weights (the FFN kernel is skipped,
    as live). ``stream`` adds the one-row stream steps.
    ``model_overrides``: ModelConfig fields over the checkpoint's, as for
    ``ServingSession.from_checkpoint`` (dtype, the kernel flags)."""
    from mtn_tpu_torch.serve import ServingSession
    from mtn_tpu_torch.train.batch import DeviceBatch

    dcfg = decode_cfg or DecodeConfig()
    style = dcfg.decode_style
    if style not in ("beam_search", "greedy", "sample"):
        raise ValueError(f"decode_style {style!r} cannot be exported")
    session = ServingSession.from_checkpoint(
        model_arg, dcfg, model_overrides=model_overrides,
        weights_quant=weights_quant, device=device)
    mcfg, datacfg = session.model_cfg, session.data_cfg
    S = len(mcfg.ft_sizes)
    frames = list(frames) if frames else [64] * S
    if len(frames) != S:
        raise ValueError(f"--frames needs {S} entries (streams "
                         f"{datacfg.fea_type}), got {len(frames)}")
    buckets = sorted(set(int(b) for b in (batches or [batch])))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"batches must be positive, got {buckets}")
    decoder, model = session.decoder, session.model
    dev = session.device
    pad = decoder.pad
    tensors = model_tensors(model)
    names = list(tensors)
    weights = [tensors[k] for k in names]
    fdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        session.feature_dtype]
    meta = {"query_len": query_len, "his_len": his_len, "cap_len": cap_len,
            "frames": frames}

    def example(B: int) -> List[torch.Tensor]:
        hb = encode_requests([Request(question="")], mcfg, datacfg,
                             session.vocab, pad_rows_to=B)
        return batch_inputs(hb, meta, pad, dev, fdt)

    def batch_of(query, his, cap, *ftl):
        B = query.shape[0]
        dummy = torch.full((B, 1), pad, dtype=torch.int64,
                           device=query.device)
        return DeviceBatch(query=query, his=his, cap=cap, answer_in=dummy,
                           answer_out=dummy, fts=tuple(ftl[:S]),
                           fts_len=tuple(ftl[S:]),
                           valid=torch.ones(B, dtype=torch.bool,
                                            device=query.device))

    os.makedirs(out_dir, exist_ok=True)
    blob_bytes: Dict[str, int] = {}
    export_s: Dict[str, float] = {}

    def export(name: str, fn, args) -> None:
        # one example tensor per input: inputs that alias one another (a
        # state's ae_mask is its query mask) would be traced as one
        args = [a.clone() for a in args]
        t0 = time.perf_counter()
        with torch.no_grad():
            ep = torch.export.export(_Program(model, names, fn),
                                     (*weights, *args), strict=False)
        # the example inputs hold the weights: keep them out of the file
        ep.example_inputs = None
        path = os.path.join(out_dir, name)
        torch.export.save(ep, path)
        export_s[name] = time.perf_counter() - t0
        blob_bytes[name] = os.path.getsize(path)

    def prefix_fn(*inputs):
        return tuple(_state_leaves(decoder._decode_state(batch_of(*inputs))))

    def token_step_fn(sample: bool):
        def fn(l, cur, *rest):
            u = rest[0] if sample else None
            rest = rest[1:] if sample else rest
            state = _state_from(tmpl, rest[:ns])
            return token_step(decoder._stepper(state), l, cur,
                              _kv_from(rest[ns:]), u, dcfg)
        return fn

    def beam_step_fn(l, *rest):
        state = _state_from(tmpl, rest[:ns])
        carry = rest[ns:ns + BEAM_CARRY]
        kv = _kv_from(rest[ns + BEAM_CARRY:])
        *carry, kv = beam_step(decoder._stepper(state), l, *carry, kv, dcfg,
                               decoder.eos, decoder.unk)
        return (*carry, *_kv_leaves(kv))

    def rank_step_fn(l, rows, inputs, lens, total, *rest):
        state = _state_from(tmpl, rest[:ns])
        return rank_step(decoder._stepper(state), l, rows, inputs, lens,
                         total, _kv_from(rest[ns:]))

    # one prefix program per row count: the decode state of B turns,
    # which the session tiles over the beam (beam steps) or the
    # candidates (rank steps), as the live loops tile it
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    kv = lambda rows, length: _kv_leaves(model.init_self_kv(rows, length,
                                                            dev))
    tile = lambda leaves, n: [t.repeat_interleave(n, dim=0) for t in leaves]
    prefix_rows = sorted(set(buckets) | ({1} if rank or stream else set()))
    states = {}
    for B in prefix_rows:
        args = example(B)
        with torch.no_grad():
            tmpl = decoder._decode_state(batch_of(*args))
        states[B] = _state_leaves(tmpl)
        export(prefix_blob(B), prefix_fn, args)
    ns = len(states[1] if 1 in states else states[buckets[0]])
    V = mcfg.vocab_size
    for B in buckets:
        if style == "beam_search":
            carry = beam_init(B, dcfg, dev, pad, decoder.sos)
            export(step_blob(B), beam_step_fn,
                   [zero, *tile(states[B], dcfg.beam), *carry,
                    *kv(B * dcfg.beam, dcfg.maxlen)])
        else:
            cur = torch.full((B,), decoder.sos, dtype=torch.int64,
                             device=dev)
            u = [torch.zeros((B, V), device=dev)] if style == "sample" else []
            export(step_blob(B), token_step_fn(style == "sample"),
                   [zero, cur, *u, *states[B], *kv(B, dcfg.maxlen)])

    rank_meta = None
    if rank is not None:
        N, L = int(rank[0]), int(rank[1])
        rows = torch.full((N, L), pad, dtype=torch.int64, device=dev)
        export(RANK_STEP, rank_step_fn, [
            zero, rows, rows, torch.zeros(N, dtype=torch.int64, device=dev),
            torch.zeros(N, device=dev), *tile(states[1], N), *kv(N, L)])
        rank_meta = {"n": N, "len": L, "batch": 1}

    stream_meta = None
    if stream:
        cur = torch.full((1,), decoder.sos, dtype=torch.int64, device=dev)
        for sty in STREAM_STYLES:
            u = [torch.zeros((1, V), device=dev)] if sty == "sample" else []
            export(stream_step_blob(sty), token_step_fn(sty == "sample"),
                   [zero, cur, *u, *states[1], *kv(1, dcfg.maxlen)])
        stream_meta = {"maxlen": dcfg.maxlen, "styles": list(STREAM_STYLES),
                       "batch": 1}

    t0 = time.perf_counter()
    torch.save(dict(zip(names, (w.cpu() for w in weights))),
               os.path.join(out_dir, WEIGHTS))
    export_s[WEIGHTS] = time.perf_counter() - t0
    blob_bytes[WEIGHTS] = os.path.getsize(os.path.join(out_dir, WEIGHTS))
    meta.update({
        "model_arg": model_arg,
        "epoch": session.epoch,
        "batch": max(buckets),          # the serving launch size
        "batches": buckets,
        "style": style,
        "streams": list(datacfg.fea_type),
        "ft_sizes": list(mcfg.ft_sizes),
        "feature_dtype": session.feature_dtype,
        "device": dev.type,
        "torch_version": torch.__version__,
        "decode": _to_jsonable(dcfg),
        "weights_quant": weights_quant,
        "weights": names,
        "prefixes": prefix_rows,
        "n_state_leaves": ns,
        "kv": {"layers": mcfg.nb_blocks, "heads": mcfg.att_h,
               "d_k": mcfg.d_model // mcfg.att_h, "dtype": mcfg.dtype},
        "rank": rank_meta,
        "stream": stream_meta,
        # meta.json is written last: a new export_id means every file
        # beside it is complete (the serving watcher relies on it)
        "export_id": uuid.uuid4().hex,
        "blob_bytes": sum(blob_bytes.values()),
        "blobs": blob_bytes,
        "export_s": export_s,
    })
    with open(os.path.join(out_dir, VOCAB), "w") as f:
        json.dump(session.vocab, f)
    with open(os.path.join(out_dir, CONF), "w") as f:
        json.dump({"model": _to_jsonable(mcfg), "data": _to_jsonable(datacfg)},
                  f, indent=2, sort_keys=True)
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    log.info("exported %s -> %s (%d programs, %.1f MB, device %s)",
             model_arg, out_dir, len(blob_bytes) - 1,
             meta["blob_bytes"] / 1e6, dev.type)
    return meta


# -- load and serve ---------------------------------------------------------------
class _Source:
    """An artifact's programs at row bucket ``B`` as the one-step
    functions and prefixes that :mod:`mtn_tpu_torch.decode.graphs`'s
    program sets take from a live decoder: the state is the prefix
    program's leaves, the KV caches a flat list of tensors. With
    ``stream`` (a style), ``token_next`` is that style's one-row stream
    step."""

    def __init__(self, session: "AotSession", B: int,
                 stream: Optional[str] = None):
        self.s, self.B = session, B
        self.step = step_blob(B) if stream is None else stream_step_blob(
            stream)
        self.cfg = session.decode_cfg
        self.vocab_size = session.model_cfg.vocab_size
        self.pad, self.sos = session._pad, session._sos
        self.eos, self.unk = session._eos, session.vocab["<unk>"]

    def beam_prefix(self, inputs):
        cfg = self.cfg
        state = self.s._tile(self.s._state(self.B, inputs), cfg.beam)
        carry = beam_init(self.B, cfg, self.s.device, self.pad, self.sos)
        return state, (*carry, self.s._kv(self.B * cfg.beam, cfg.maxlen))

    def beam_advance(self, state, l, *carry):
        *carry, kv = carry
        out = self.s._call(step_blob(self.B), l, *state, *carry, *kv)
        return (*out[:BEAM_CARRY], list(out[BEAM_CARRY:]))

    def token_prefix(self, inputs):
        return (self.s._state(self.B, inputs),
                self.s._kv(self.B, self.cfg.maxlen))

    def token_next(self, state, l, cur, kv, u):
        u = [] if u is None else [u]
        return self.s._call(self.step, l, cur, *u, *state, *kv)

    def rank_prefix(self, inputs, cand, cand_len):
        _, N, L = cand.shape
        rows, feed = rank_inputs(cand, self.sos)
        return (self.s._tile(self.s._state(1, inputs), N),
                self.s._kv(N, L), rows, feed, cand_len.reshape(-1),
                torch.zeros(rows.shape[0], dtype=torch.float32,
                            device=self.s.device))

    def rank_advance(self, state, l, rows, inputs, lens, total, kv):
        return self.s._call(RANK_STEP, l, rows, inputs, lens, total, *state,
                            *kv)


class AotSession:
    """Serve an exported artifact.

    Mirrors ``ServingSession``'s ``respond``/``respond_batch`` (the same
    ``Request`` objects, the history and caption law of
    ``encode_requests``, ``DecodeResult`` rows) but runs the exported
    programs: no checkpoint, no ``MTN``, no model code. Bursts beyond the
    largest row bucket are chunked, each chunk taking the smallest bucket
    that fits; token sequences longer than the exported lengths raise and
    frames are truncated. Artifacts exported with ``rank=(N, L)`` also
    :meth:`rank`, those with stream programs :meth:`stream`; a front end
    routes by ``hasattr`` and answers 501 for what the artifact lacks.
    :meth:`reload` swaps in a re-exported artifact.

    Each decode, each rank and each stream runs through a program set of
    :mod:`mtn_tpu_torch.decode.graphs` over the artifact's programs (one
    per row bucket, the rank shape and each stream style): captured on
    CUDA, a decode and a rank launched as one graph and a stream as one
    replay a token; run as they are on the CPU. :meth:`warmup` builds
    every set; a set not built yet is built at its first use. A stream
    opened while another of its style is open runs eagerly (counted in
    ``eager_streams``)."""

    #: serving front ends serialize an artifact behind one lock
    is_aot = True

    def __init__(self, art_dir: str, device: str = "cuda"):
        from mtn_tpu_torch.cli.common import resolve_device
        self.device = resolve_device(device)
        with open(os.path.join(art_dir, META)) as f:
            self.meta = json.load(f)
        if self.meta["device"] != self.device.type:
            raise ValueError(
                f"{art_dir} was exported for device {self.meta['device']!r} "
                f"and cannot run on {self.device}; re-export it with "
                f"--device {self.device.type}")
        with open(os.path.join(art_dir, VOCAB)) as f:
            self.vocab = {k: int(v) for k, v in json.load(f).items()}
        with open(os.path.join(art_dir, CONF)) as f:
            conf = json.load(f)
        self.model_cfg = config_from_dict("model", conf["model"])
        self.data_cfg = config_from_dict("data", conf["data"])
        # the frozen decode config; turn_batch is the largest bucket
        self.decode_cfg = dataclasses.replace(
            config_from_dict("decode", self.meta["decode"]),
            turn_batch=int(self.meta["batch"]))
        self.style = self.meta["style"]
        self.model_arg = self.meta.get("model_arg")
        self.epoch = self.meta.get("epoch")
        self.weights_quant = self.meta.get("weights_quant", "")
        self.vlist = vocab_list(self.vocab)
        self.buckets = sorted(int(b) for b in self.meta["batches"])
        self.art_dir = art_dir
        loaded = torch.load(os.path.join(art_dir, WEIGHTS),
                            map_location=self.device, weights_only=True)
        self.weights = [loaded[k] for k in self.meta["weights"]]
        self._programs: Dict[str, torch.nn.Module] = {}
        self._fdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.meta["feature_dtype"]]
        self._pad = self.vocab["<blank>"]
        self._sos = self.vocab["<sos>"]
        self._eos = self.vocab["<eos>"]
        self._sample_calls = 0
        self.capture = self.device.type == "cuda"
        self.sets: Dict[Tuple[str, int], ProgramSet] = {}
        self.eager_streams = 0
        if self.meta.get("rank"):
            self.rank = self._rank
        if self.meta.get("stream"):
            self.stream = self._stream

    def _program(self, name: str):
        """The exported program ``name`` of the artifact (loaded once)."""
        if name not in self._programs:
            ep = torch.export.load(os.path.join(self.art_dir, name))
            self._programs[name] = ep.module()
        return self._programs[name]

    def _call(self, name: str, *args):
        return self._program(name)(*self.weights, *args)

    # -- host-side shape fitting ---------------------------------------------
    def _fit_tokens(self, arr: np.ndarray, L: int, what: str) -> np.ndarray:
        return fit_tokens(arr, L, what, self._pad)

    def _fit_features(self, arr, ln, T):
        return fit_features(arr, ln, T)

    def _inputs(self, requests: Sequence[Request], rows: int):
        hb = encode_requests(requests, self.model_cfg, self.data_cfg,
                             self.vocab, pad_rows_to=rows)
        return hb, batch_inputs(hb, self.meta, self._pad, self.device,
                                self._fdt)

    def _chunk_sizes(self, n: int) -> List[int]:
        """Greedy bucket plan for n requests: drain with the largest
        bucket, then the smallest bucket that fits the remainder."""
        sizes, biggest = [], self.buckets[-1]
        while n > 0:
            if n >= biggest:
                sizes.append(biggest)
                n -= biggest
            else:
                sizes.append(next(b for b in self.buckets if b >= n))
                n = 0
        return sizes

    # -- decode: the program sets over the artifact's programs ----------------
    def _state(self, B: int, inputs) -> List[torch.Tensor]:
        """The decode state of B turns (the prefix program's leaves)."""
        return list(self._call(prefix_blob(B), *inputs))

    def _kv(self, rows: int, length: int) -> List[torch.Tensor]:
        """Zeroed self-attention KV caches, as ``MTN.init_self_kv``."""
        kv = self.meta["kv"]
        shape = (rows, kv["heads"], length, kv["d_k"])
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            kv["dtype"]]
        return [torch.zeros(shape, dtype=dtype, device=self.device)
                for _ in range(2 * kv["layers"])]

    @staticmethod
    def _tile(leaves, n: int) -> List[torch.Tensor]:
        """Row b*n+k is turn b, as the live loops tile the state."""
        return [t.repeat_interleave(n, dim=0) for t in leaves]

    def _uniforms(self, sample: bool, fold: int, B: int):
        if not sample:
            return lambda l: None
        seed, V = self.decode_cfg.sample_seed, self.model_cfg.vocab_size
        return lambda l: gumbel_uniforms((B, V), draw_seed(seed, fold, l),
                                         self.device)

    def _sampled(self) -> bool:
        return self.style == "sample" and self.decode_cfg.temperature > 0.0

    @torch.inference_mode()
    def program_set(self, kind: str, B: int) -> ProgramSet:
        """The program set of ``kind`` ("beam", "tokens", "rank",
        "stream_greedy" or "stream_sample") at row bucket ``B``, built at
        its first use (a blank request's inputs as its static
        inputs)."""
        key = (kind, B)
        if key not in self.sets:
            style = kind[len("stream_"):] if kind.startswith("stream_") \
                else None
            src = _Source(self, B, style)
            _, example = self._inputs([Request(question="")], B)
            if kind == "beam":
                ps = BeamPrograms(src, example, self.capture)
            elif kind == "tokens":
                ps = TokenPrograms(src, example, self._sampled(),
                                   self.capture)
            elif style is not None:
                ps = StreamPrograms(src, example, style == "sample",
                                    self.capture)
            else:
                cand, clen = self.rank_tensors([], True)
                ps = RankPrograms(src, example, cand, clen, self.capture)
            self.sets[key] = ps
        return self.sets[key]

    def build_programs(self) -> List[Tuple[str, int]]:
        """Build the program set of every row bucket (and the rank
        shape's); returns their keys."""
        kind = "beam" if self.style == "beam_search" else "tokens"
        for B in self.buckets:
            self.program_set(kind, B)
        if self.meta.get("rank"):
            self.program_set("rank", 1)
        return list(self.sets)

    @torch.inference_mode()
    def respond_batch(self, requests: Sequence[Request]
                      ) -> List[DecodeResult]:
        out: List[DecodeResult] = []
        at = 0
        for rows in self._chunk_sizes(len(requests)):
            chunk = list(requests[at:at + rows])
            at += rows
            hb, inputs = self._inputs(chunk, rows)
            if self.style == "beam_search":
                pool, _ = self.program_set("beam", rows).run(inputs)
                comp = [t.cpu().numpy() for t in pool]
                out.extend(DecodeResult(r.texts(self.vlist, self._eos))
                           for r in completions_to_results(*comp, hb.valid))
                continue
            fold = 0
            if self.style == "sample":
                fold = self._sample_calls
                self._sample_calls += 1
            toks = self.program_set("tokens", rows).run(
                inputs, self._uniforms(self._sampled(), fold, rows))
            out.extend(DecodeResult([(detokenize(r, self.vlist, self._eos),
                                      0.0)])
                       for r in cut_rows(toks, hb.valid, self._eos))
        return out

    def respond(self, question: str, history=(), caption: str = "",
                features: Optional[Dict[str, np.ndarray]] = None) -> str:
        req = Request(question=question, history=list(history),
                      caption=caption, features=features or {})
        return self.respond_batch([req])[0][0]

    # -- ranking (exported with rank=(N, L)) ------------------------------------
    def rank_tensors(self, candidates: Sequence[str], include_eos: bool):
        """The (1, N, L) candidate tokens and (1, N) lengths at the frozen
        rank shape; too many or too long candidates raise."""
        rmeta = self.meta["rank"]
        N, L = int(rmeta["n"]), int(rmeta["len"])
        if len(candidates) > N:
            raise ValueError(
                f"{len(candidates)} candidates exceed the exported rank "
                f"capacity {N}; re-export with a larger --rank")
        cand = np.full((1, N, L), self._pad, np.int64)
        clen = np.zeros((1, N), np.int64)
        for i, c in enumerate(candidates):
            # ServingSession.cand_ids: without words2ids' <sos>/<eos>
            toks = words2ids(c, self.vocab)[1:-1].tolist()
            toks += [self._eos] if include_eos else []
            if len(toks) > L:
                raise ValueError(
                    f"candidate {i} needs {len(toks)} tokens, exported "
                    f"rank length is {L}; re-export with a larger --rank")
            cand[0, i, :len(toks)] = toks
            clen[0, i] = len(toks)
        return (torch.from_numpy(cand).to(self.device),
                torch.from_numpy(clen).to(self.device))

    @torch.inference_mode()
    def _rank(self, request: Request, candidates: Sequence[str],
              include_eos: bool = True):
        """``ServingSession.rank`` through the rank programs:
        ``[(candidate, logp, rank), ...]`` in input order."""
        if not candidates:
            raise ValueError("no candidates to rank")
        cand, clen = self.rank_tensors(candidates, include_eos)
        _, inputs = self._inputs([request], 1)
        total = self.program_set("rank", 1).run(inputs, cand, clen)
        scores = [float(s) for s in total[0].cpu()[:len(candidates)]]
        return [(c, s, rank_of(scores, i))
                for i, (c, s) in enumerate(zip(candidates, scores))]

    # -- streaming (exported with stream=True) ----------------------------------
    def _stream_kind(self, style: str) -> str:
        """The stream set a style runs on: a sample at temperature <= 0
        is greedy's argmax, as live."""
        sample = style == "sample" and self.decode_cfg.temperature > 0.0
        return "stream_sample" if sample else "stream_greedy"

    def _stream(self, request: Request, style: Optional[str] = None):
        """Generator of answer words for ONE request as they are decoded
        (``ServingSession.stream``'s style default and fold law), through
        the one-row stream programs' set."""
        smeta = self.meta["stream"]
        if style is None:
            style = "greedy" if self.style == "beam_search" else self.style
        if style not in smeta["styles"]:
            raise ValueError(f"style {style!r} not exported (artifact has "
                             f"{smeta['styles']})")
        fold = 0
        if style == "sample":
            fold = self._sample_calls
            self._sample_calls += 1
        kind = self._stream_kind(style)
        uniforms = self._uniforms(kind == "stream_sample", fold, 1)
        with torch.inference_mode():
            _, inputs = self._inputs([request], 1)
        ps = self.program_set(kind, 1)
        if ps.held:   # another stream of this style is open
            self.eager_streams += 1
            steps = eager_stream(_Source(self, 1, kind[len("stream_"):]),
                                 inputs, uniforms)
        else:
            ps.held = True
            steps = ps.stream(inputs, uniforms)
        with contextlib.closing(steps):
            for host in steps:
                t = int(host[0])
                if t == self._eos:
                    return
                yield self.vlist[t]

    # -- operations --------------------------------------------------------------
    def reload(self, art_dir: Optional[str] = None):
        """Swap in a (re-)exported artifact from ``art_dir`` (default:
        this session's directory) on the same device; returns its
        checkpoint epoch. Not synchronized: a front end serving
        concurrently holds its session lock across the call."""
        fresh = AotSession(art_dir or self.art_dir, device=str(self.device))
        self.__dict__.clear()
        self.__dict__.update(fresh.__dict__)
        # the optional routes follow the new artifact, bound to self
        if "rank" in self.__dict__:
            self.rank = self._rank
        if "stream" in self.__dict__:
            self.stream = self._stream
        return self.epoch

    @property
    def export_id(self) -> Optional[str]:
        """The unique id written at export."""
        return self.meta.get("export_id")

    def warmup(self, stream: bool = False) -> float:
        """Build the program set of every row bucket and the rank shape
        (:meth:`build_programs`), run the decode on one blank request
        (with ``stream=True`` also build the stream sets the session's
        styles run on, and stream the request); returns seconds
        spent."""
        t0 = time.monotonic()
        self.build_programs()
        self.respond_batch([Request(question="")])
        if stream and self.meta.get("stream"):
            for style in self.meta["stream"]["styles"]:
                self.program_set(self._stream_kind(style), 1)
            for _ in self._stream(Request(question="")):
                pass
        return time.monotonic() - t0


# -- CLI -------------------------------------------------------------------------
def main(argv: Optional[Sequence[str]] = None) -> int:
    from mtn_tpu_torch.cli.common import add_logging_args, setup_logging
    p = argparse.ArgumentParser(prog="python -m mtn_tpu_torch.utils.aot",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="export a decode artifact")
    pe.add_argument("--model", required=True)
    pe.add_argument("--out", required=True)
    pe.add_argument("--batch", type=int, default=8)
    pe.add_argument("--batches", default="",
                    help="comma list of frozen row buckets (e.g. 1,4,16), "
                         "one prefix and step program each; default: "
                         "--batch")
    pe.add_argument("--query-len", type=int, default=32)
    pe.add_argument("--his-len", type=int, default=128)
    pe.add_argument("--cap-len", type=int, default=64)
    pe.add_argument("--frames", default="",
                    help="comma list, one per feature stream (default 64)")
    pe.add_argument("--device", default="cuda",
                    help="the device the programs are traced for and run "
                         "on ('cpu': the kernels' plain versions)")
    pe.add_argument("--decode-style", default="beam_search",
                    choices=["beam_search", "greedy", "sample"])
    for flag, kind in (("--temperature", float), ("--top-k", int),
                       ("--top-p", float), ("--sample-seed", int),
                       ("--beam", int), ("--nbest", int), ("--maxlen", int),
                       ("--penalty", float), ("--min-len", int)):
        pe.add_argument(flag, type=kind, default=None)
    pe.add_argument("--rank", default="",
                    help="N,L: also export the rank programs, N candidates "
                         "of padded length L (serves /v1/rank)")
    pe.add_argument("--stream", default=1, type=int,
                    help="export the one-row stream programs (serves "
                         "/v1/stream); 0 leaves them out")
    pe.add_argument("--weights-quant", default="",
                    choices=["", "int8", "int8-fp-head"],
                    help="weight-only int8 weights, as the live session's "
                         "(int8-fp-head keeps the vocabulary head in full "
                         "precision)")
    pe.add_argument("--use-pallas-attention", default=0, type=int,
                    help="use the hand-written fused attention kernel "
                         "(csrc/attention.cu)")
    pe.add_argument("--use-pallas-ffn", default=0, type=int,
                    help="use the hand-written fused FFN kernel "
                         "(csrc/ffn.cu)")
    add_logging_args(pe)

    pi = sub.add_parser("info", help="print the artifact's metadata")
    pi.add_argument("artifact")

    pr = sub.add_parser("run", help="answer one question with the artifact")
    pr.add_argument("artifact")
    pr.add_argument("--question", required=True)
    pr.add_argument("--caption", default="")
    pr.add_argument("--feature", action="append", default=[],
                    metavar="NAME=PATH.npy")
    pr.add_argument("--device", default="cuda")

    args = p.parse_args(argv)
    if args.cmd == "export":
        setup_logging(args.verbose)
        dcfg = DecodeConfig(decode_style=args.decode_style)
        for field in ("beam", "nbest", "maxlen", "penalty", "min_len",
                      "temperature", "top_k", "top_p", "sample_seed"):
            v = getattr(args, field)
            if v is not None:
                setattr(dcfg, field, v)
        frames = ([int(x) for x in args.frames.split(",") if x]
                  if args.frames else None)
        batches = ([int(x) for x in args.batches.split(",") if x]
                   if args.batches else None)
        rank = None
        if args.rank:
            parts = [int(x) for x in args.rank.split(",")]
            if len(parts) != 2:
                p.error("--rank needs N,L (e.g. 100,24)")
            rank = (parts[0], parts[1])
        meta = export_decode(
            args.model, args.out, batch=args.batch, query_len=args.query_len,
            his_len=args.his_len, cap_len=args.cap_len, frames=frames,
            decode_cfg=dcfg, device=args.device, batches=batches, rank=rank,
            weights_quant=args.weights_quant, stream=bool(args.stream),
            model_overrides={
                "use_pallas_attention": bool(args.use_pallas_attention),
                "use_pallas_ffn": bool(args.use_pallas_ffn)})
        print(json.dumps({k: meta[k] for k in (
            "blob_bytes", "batches", "style", "rank", "weights_quant",
            "device")} | {"out": args.out}))
        return 0
    if args.cmd == "info":
        with open(os.path.join(args.artifact, META)) as f:
            print(json.dumps(json.load(f), indent=2, sort_keys=True))
        return 0
    feats = {}
    for spec in args.feature:
        name, _, path = spec.partition("=")
        feats[name] = np.load(path)
    session = AotSession(args.artifact, device=args.device)
    req = Request(question=args.question, caption=args.caption,
                  features=feats)
    for text, score in session.respond_batch([req])[0].nbest:
        print(json.dumps({"answer": text, "score": score}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
