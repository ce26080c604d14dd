"""Shared helpers of the ``test_torch_*`` parity tests: one numpy batch and
one flax parameter tree go into both ``mtn_tpu`` (JAX, the reference) and
``mtn_tpu_torch`` (the port), on the CPU."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

PAD, SOS, EOS, UNK = 1, 2, 3, 0


@pytest.fixture(scope="module", autouse=False)
def one_thread():
    """Keep torch to one thread per test worker."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def host_fields(rng, B=2, Lq=5, Lh=7, Lc=6, La=4, ft_dims=(12, 8),
                T=(5, 4), vocab=30, lengths=None):
    """The fields of one HostBatch, made with numpy from ``rng``."""
    def toks(L):
        arr = rng.integers(4, vocab, size=(B, L)).astype(np.int32)
        arr[:, 0] = SOS
        return arr
    return dict(
        query=toks(Lq), his=toks(Lh), answer_in=toks(La),
        answer_out=np.concatenate(
            [toks(La)[:, 1:], np.full((B, 1), EOS, np.int32)], axis=1),
        cap=toks(Lc),
        fts=[rng.standard_normal((B, t, d)).astype(np.float32)
             for t, d in zip(T, ft_dims)],
        fts_len=[np.asarray(lengths[i], np.int32) if lengths else
                 np.full((B,), t, np.int32) for i, t in enumerate(T)],
        valid=np.ones((B,), bool), qa_ids=list(range(B)))


def both_batches(fields):
    """(JAX DeviceBatch, port DeviceBatch on the CPU) of one batch."""
    from mtn_tpu.data.batching import HostBatch as JHostBatch
    from mtn_tpu.train.batch import device_batch as jax_device_batch
    from mtn_tpu_torch.data.batching import HostBatch as THostBatch
    from mtn_tpu_torch.train.batch import device_batch as torch_device_batch
    return (jax_device_batch(JHostBatch(**fields)),
            torch_device_batch(THostBatch(**fields), "cpu"))


def port_cfg(jax_cfg):
    from mtn_tpu_torch.config import config_from_dict
    return config_from_dict("model", dataclasses.asdict(jax_cfg))


def jax_init_params(jax_cfg, jdb, seed=0):
    """Flax's own init of ``MTN(jax_cfg)`` on ``jdb`` (the parameter
    names and shapes the port must carry)."""
    from mtn_tpu.models.mtn import MTN
    from mtn_tpu.train.batch import batch_masks
    model = MTN(jax_cfg)
    masks, tgt_mask = batch_masks(jdb, PAD)
    params = jax.jit(lambda key: model.init(
        {"params": key}, jdb.query, jdb.his, jdb.cap, jdb.fts, masks,
        jdb.answer_in, tgt_mask, method=MTN.init_all)["params"])(
            jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def seeded_params(jax_cfg, seed=0, gen_scale=1.0):
    """A flax parameter tree for ``MTN(jax_cfg)`` made with numpy from
    ``seed`` (no JAX init to compile): xavier-uniform kernels and
    embeddings, and biases and norm parameters away from 0 and 1 so that
    a dropped bias or scale shows. ``gen_scale`` sharpens the vocabulary
    head so beam margins are robust."""
    from mtn_tpu_torch.weights import param_shapes
    rng = np.random.default_rng(seed)
    tree = {}
    for key, shape in param_shapes(port_cfg(jax_cfg)).items():
        *path, leaf = key.split(".")
        if leaf in ("kernel", "embedding"):
            limit = np.sqrt(6.0 / (shape[-2] + shape[-1]))
            a = rng.uniform(-limit, limit, shape)
            if key == "generator.proj.kernel":
                a = a * gen_scale
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a.astype(np.float32)
    return tree


def port_model(jax_cfg, params, **overrides):
    """The port's MTN on the CPU with the flax params bridged in."""
    from mtn_tpu_torch.weights import from_flax, load_model
    cfg = port_cfg(jax_cfg)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return load_model(cfg, from_flax(params), "cpu")


def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU,
    as tests/test_pallas.py does."""
    from mtn_tpu.ops import pallas_attention as pa
    from mtn_tpu.ops import pallas_ffn as pf
    import mtn_tpu.ops.attention as attn_mod
    monkeypatch.setattr(pa, "_INTERPRET", True)
    monkeypatch.setattr(pf, "_INTERPRET", True)
    monkeypatch.setattr(attn_mod.jax, "default_backend", lambda: "tpu")


def train_argv(c, prefix, *extra):
    """Flags of ``mtn_tpu_torch.cli.train`` on the tiny corpus ``c`` (a
    one-block width-16 model on the CPU), then ``extra``."""
    return ["--device", "cpu", "--dtype", "float32",
            "--fea-type", *c.fea_types, "--train-path", c.fea_path,
            "--train-set", c.train_set, "--valid-path", c.fea_path,
            "--valid-set", c.valid_set, "--include-caption",
            "caption,summary", "--separate-caption", "1", "--batch-size",
            "4", "--max-length", "64", "--model", prefix, "--nb-blocks",
            "1", "--d-model", "16", "--d-ff", "32", "--att-h", "2",
            "--warmup-steps", "20", "--diff-encoder", "1",
            "--auto-encoder-ft", "query", "--vocab-cutoff", "0",
            "--length-bucket", "8", "--feature-bucket", "4",
            "--report-interval", "1", *extra]
