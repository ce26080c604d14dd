"""The port's feature data path against ``mtn_tpu``'s: the C++ ``.npy``
loader (built with g++ from ``mtn_tpu_torch/csrc/npy_loader.cc``),
``.pkl`` features, and the write-once feature cache, all bitwise (CPU)."""

import json
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from mtn_tpu.config import DataConfig as JDataConfig
from mtn_tpu.data import get_vocabulary as jax_vocab
from mtn_tpu.data import load as jax_load
from mtn_tpu.data.batching import make_batch_indices as jax_indices
from mtn_tpu.data.feature_cache import FeatureCache as JFeatureCache
from mtn_tpu.data.features import FeatureRegistry as JFeatureRegistry
from mtn_tpu.data.features import load_features as jax_load_features
from mtn_tpu.data.pipeline import BatchIterator as JBatchIterator
from mtn_tpu.train.batch import device_batch as jax_device_batch
from mtn_tpu_torch.cli import train as train_cli
from mtn_tpu_torch.config import DataConfig
from mtn_tpu_torch.data import features, native_loader
from mtn_tpu_torch.data.batching import make_batch, make_batch_indices
from mtn_tpu_torch.data.dataset import load
from mtn_tpu_torch.data.feature_cache import (BF16Feature, FeatureCache,
                                              QuantFeature, bf16_bits)
from mtn_tpu_torch.data.features import FeatureRegistry, load_features
from mtn_tpu_torch.data.pipeline import BatchIterator
from mtn_tpu_torch.data.vocab import get_vocabulary
from mtn_tpu_torch.ops import _build
from mtn_tpu_torch.train.batch import device_batch
from tests.torch_parity import one_thread, train_argv  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TRANSFERS = ["float32", "bfloat16", "int8"]


def _counting_native(monkeypatch):
    """Count the C++ loader's batch calls (and its refusals)."""
    seen = {"calls": 0, "refused": 0}
    real = native_loader.load_batch

    def load_batch(*args, **kw):
        seen["calls"] += 1
        try:
            return real(*args, **kw)
        except IOError:
            seen["refused"] += 1
            raise
    monkeypatch.setattr(native_loader, "load_batch", load_batch)
    return seen


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Per-video files of one 2-D stream (f32 and f64, 7-12 frames) and
    one 3-D stream (T, R, D), and an f16 file, under one template."""
    root = tmp_path_factory.mktemp("feats")
    rng = np.random.default_rng(11)
    vids = [f"v{i}" for i in range(5)]
    for ft, shape, dtypes in (("flat", (None, 6), (np.float32, np.float64)),
                              ("regions", (None, 3, 4), (np.float32,))):
        os.makedirs(root / ft)
        for i, v in enumerate(vids):
            T = 7 + i
            a = rng.standard_normal((T,) + shape[1:]).astype(
                dtypes[i % len(dtypes)])
            np.save(root / ft / f"{v}.npy", a)
            with open(root / ft / f"{v}.pkl", "wb") as f:
                pickle.dump(a, f)
    os.makedirs(root / "half")
    for i, v in enumerate(vids):
        np.save(root / "half" / f"{v}.npy",
                rng.standard_normal((6 + i, 5)).astype(np.float16))
    return root, vids


def _both(root, vids, streams, ext="npy"):
    tpl = str(root / "<FeaType>" / f"<ImageID>.{ext}")
    return (FeatureRegistry(streams, tpl, vids),
            JFeatureRegistry(streams, tpl, vids))


def test_the_loader_is_built_from_the_port_source():
    assert features.native_in_use()
    path = native_loader.LIBRARY.library_path()
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert native_loader.LIBRARY.source.name == "npy_loader.cc"
    assert native_loader.LIBRARY.source.parent == _build.CSRC_DIR


@pytest.mark.parametrize("skip", [1, 2, 3])
@pytest.mark.parametrize("stream", ["flat", "regions"])
def test_native_loader_equals_numpy_and_jax(monkeypatch, videos, stream,
                                            skip):
    """2-D and 3-D streams (a frame cap that cuts mid-frame), frame skips
    1-3 and repeated videos: the C++ reader, numpy and JAX's
    ``load_features`` agree bitwise."""
    root, vids = videos
    reg, jreg = _both(root, vids, [stream])
    batch = [vids[3], vids[0], vids[3], vids[4], vids[0]]   # repeats
    cap = [10]
    seen = _counting_native(monkeypatch)
    nat, nat_len = load_features(reg, batch, cap, [skip])
    assert seen == {"calls": 1, "refused": 0}
    py, py_len = load_features(reg, batch, cap, [skip], use_native=False)
    assert seen["calls"] == 1
    jx, jx_len = jax_load_features(jreg, batch, cap, [skip])
    for got in (nat[0], jx[0]):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, py[0])
    for got in (nat_len[0], jx_len[0]):
        np.testing.assert_array_equal(got, py_len[0])
    assert native_loader.npy_shape(reg.path(0, vids[1])) == \
        tuple(np.load(reg.path(0, vids[1])).shape)


def test_an_f16_file_falls_to_numpy(monkeypatch, videos):
    root, vids = videos
    reg, jreg = _both(root, vids, ["half"])
    seen = _counting_native(monkeypatch)
    got, got_len = load_features(reg, vids, [8], [2])
    assert seen == {"calls": 1, "refused": 1}
    want, want_len = jax_load_features(jreg, vids, [8], [2],
                                       use_native=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got_len[0], want_len[0])


def test_pkl_features_load(monkeypatch, videos):
    """``.pkl`` registries (header and frames from the pickled arrays)
    give the ``.npy`` batches, through numpy, as JAX's do."""
    root, vids = videos
    streams = ["flat", "regions"]
    reg, jreg = _both(root, vids, streams, ext="pkl")
    npy, _ = _both(root, vids, streams)
    assert reg.feature_dims() == npy.feature_dims() == [6, 4]
    assert [reg.n_frames(1, v) for v in vids] == \
        [npy.n_frames(1, v) for v in vids]
    seen = _counting_native(monkeypatch)
    got, got_len = load_features(reg, vids, [12, 30], [2, 1])
    assert seen["calls"] == 0
    want, want_len = load_features(npy, vids, [12, 30], [2, 1])
    jx, _ = jax_load_features(jreg, vids, [12, 30], [2, 1])
    for g, w, j in zip(got, want, jx):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(j, w)
    for g, w in zip(got_len, want_len):
        np.testing.assert_array_equal(g, w)


def test_an_unbuildable_loader_warns_once_and_reads_with_numpy(
        monkeypatch, caplog, videos):
    root, vids = videos
    broken = _build.host_library("no_such_source", lambda lib: None)
    monkeypatch.setattr(native_loader, "LIBRARY", broken)
    monkeypatch.setattr(native_loader, "_error", None)
    reg, _ = _both(root, vids, ["flat"])
    with caplog.at_level(logging.WARNING):
        got, _ = load_features(reg, vids, [9], [1])
        assert not features.native_in_use()
    warned = [r for r in caplog.records if "native .npy loader" in
              r.getMessage()]
    assert len(warned) == 1 and "no_such_source" in warned[0].getMessage()
    want, _ = load_features(reg, vids, [9], [1], use_native=False)
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(RuntimeError, match="unavailable"):
        native_loader.load_batch([reg.path(0, vids[0])], 9)


# -- the feature cache --------------------------------------------------------
@pytest.fixture(scope="module")
def datasets(tiny_corpus):
    """The tiny corpus as the port's and JAX's datasets."""
    kw = dict(include_caption="caption,summary", separate_caption=True)
    c = tiny_corpus
    vocab = get_vocabulary(c.train_set, cutoff=0,
                           include_caption="caption,summary")
    assert vocab == jax_vocab(c.train_set, cutoff=0,
                              include_caption="caption,summary")
    return (load(c.fea_types, c.fea_path, c.train_set, vocab, **kw),
            jax_load(c.fea_types, c.fea_path, c.train_set, vocab, **kw))


def _cfgs(**kw):
    d = dict(batch_size=4, separate_caption=True, length_bucket=8,
             feature_bucket=4, prefetch=0, cut_a=False)
    d.update(kw)
    return DataConfig(**d), JDataConfig(**d)


def _device_fts(hb, transfer):
    """The port batch's features on the CPU device, as numpy bits."""
    return [f.view(torch.int16).numpy() if f.dtype == torch.bfloat16
            else f.numpy() for f in device_batch(hb, "cpu", transfer).fts]


def _jax_fts(hb, transfer):
    return [np.asarray(f).view(np.int16) if transfer == "bfloat16"
            else np.asarray(f) for f in jax_device_batch(hb, transfer).fts]


@pytest.mark.parametrize("transfer", TRANSFERS)
def test_cached_batches_equal_uncached_and_jax(datasets, tmp_path,
                                               transfer):
    """Epoch 1 (fill) and epoch 2 (mmap hits) put the uncached bits on the
    device, and JAX's make_batch with its own FeatureCache the same."""
    ds, jds = datasets
    plans, _ = make_batch_indices(ds, 4, 64, separate_caption=True)
    jplans, _ = jax_indices(jds, 4, 64, separate_caption=True)
    cache = FeatureCache(str(tmp_path / "fc"), transfer=transfer)
    jcache = JFeatureCache(str(tmp_path / "jfc"), transfer=transfer)
    cfg, jcfg = _cfgs()
    plain = list(BatchIterator(ds, plans, cfg, train=False))
    fill = list(BatchIterator(ds, plans, cfg, train=False,
                              feature_cache=cache))
    served = list(BatchIterator(ds, plans, cfg, train=False,
                                feature_cache=cache))
    jserved = [list(JBatchIterator(jds, jplans, jcfg, train=False,
                                   feature_cache=jcache))
               for _ in range(2)][1]
    n = len(plans) * len(ds.features)
    assert cache.misses == cache.hits == n
    assert jcache.misses == jcache.hits == n
    kinds = {"float32": np.ndarray, "bfloat16": BF16Feature,
             "int8": QuantFeature}
    for a, b, c, j in zip(plain, fill, served, jserved):
        assert all(isinstance(f, kinds[transfer]) for f in c.fts)
        np.testing.assert_array_equal(a.query, j.query)
        want = _device_fts(a, transfer)
        for got in (_device_fts(b, transfer), _device_fts(c, transfer),
                    _jax_fts(j, transfer)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        for la, lc in zip(a.fts_len, c.fts_len):
            np.testing.assert_array_equal(la, lc)


@pytest.mark.parametrize("transfer", TRANSFERS)
def test_a_jax_written_cache_is_read_by_the_port(datasets, tmp_path,
                                                 transfer):
    ds, jds = datasets
    jplans, _ = jax_indices(jds, 4, 64, separate_caption=True)
    plans, _ = make_batch_indices(ds, 4, 64, separate_caption=True)
    d = str(tmp_path / "fc")
    cfg, jcfg = _cfgs()
    jcache = JFeatureCache(d, transfer=transfer)
    jfill = list(JBatchIterator(jds, jplans, jcfg, train=False,
                                feature_cache=jcache))
    cache = FeatureCache(d, transfer=transfer)
    got = list(BatchIterator(ds, plans, cfg, train=False,
                             feature_cache=cache))
    assert cache.misses == 0 and cache.hits == jcache.misses
    for g, j in zip(got, jfill):
        for fg, fj in zip(g.fts, j.fts):
            if transfer == "int8":
                np.testing.assert_array_equal(fg.q, fj.q)
                np.testing.assert_array_equal(fg.scale, fj.scale)
            elif transfer == "bfloat16":
                np.testing.assert_array_equal(fg.bits,
                                              np.asarray(fj).view(np.uint16))
            else:
                np.testing.assert_array_equal(fg, fj)


def test_bf16_bits_round_as_ml_dtypes():
    import ml_dtypes
    a = np.random.default_rng(0).standard_normal((3, 50)).astype(np.float32)
    a[0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0, 65504.0]   # ties
    np.testing.assert_array_equal(
        bf16_bits(a), a.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_cache_entries_are_write_once(datasets, tmp_path):
    ds, _ = datasets
    plans, _ = make_batch_indices(ds, 4, 64, separate_caption=True)
    cache = FeatureCache(str(tmp_path / "fc"))
    cfg, _ = _cfgs()
    list(BatchIterator(ds, plans, cfg, train=False, feature_cache=cache))
    files = sorted(os.listdir(cache.dir))
    assert files and not any(".tmp" in f for f in files)
    stamps = {f: os.stat(os.path.join(cache.dir, f)).st_mtime_ns
              for f in files}
    list(BatchIterator(ds, plans, cfg, train=False, feature_cache=cache))
    assert sorted(os.listdir(cache.dir)) == files
    assert all(os.stat(os.path.join(cache.dir, f)).st_mtime_ns == m
               for f, m in stamps.items())


def test_cache_invalidates_on_a_source_change(tiny_corpus, tmp_path):
    """A rewritten feature file misses its old entries and serves its new
    bytes (a private copy of the corpus's features)."""
    c = tiny_corpus
    vocab = get_vocabulary(c.train_set, cutoff=0)
    feats = tmp_path / "feats"
    for ft in c.fea_types:
        os.makedirs(feats / ft)
        for p in (c.root / ft).glob("*.npy"):
            np.save(feats / ft / p.name, np.load(p))
    tpl = str(feats / "<FeaType>" / "<ImageID>.npy")
    ds = load(c.fea_types, tpl, c.train_set, vocab)
    plans, _ = make_batch_indices(ds, 4, 64)
    cache = FeatureCache(str(tmp_path / "fc"))
    cfg, _ = _cfgs(separate_caption=False)
    list(BatchIterator(ds, plans, cfg, train=False, feature_cache=cache))
    n_entries = len(os.listdir(cache.dir))
    path = ds.features.path(0, plans[0].vids[0])
    np.save(path, np.load(path) + 1.0)
    fresh = list(BatchIterator(ds, plans, cfg, train=False,
                               feature_cache=cache))
    plain = list(BatchIterator(ds, plans, cfg, train=False))
    for a, b in zip(plain, fresh):
        for fa, fb in zip(a.fts, b.fts):
            np.testing.assert_array_equal(fa, fb)
    assert len(os.listdir(cache.dir)) > n_entries


def test_pad_rows_of_cached_blocks():
    qf = QuantFeature(q=np.full((2, 3, 4), 7, np.int8),
                      scale=np.ones((2, 3, 1), np.float32))
    assert qf.pad_rows(2) is qf
    padded = qf.pad_rows(5)
    assert padded.shape == (5, 3, 4) and padded.scale.shape == (5, 3, 1)
    assert (padded.q[2:] == 0).all() and (padded.scale[2:] == 0).all()
    np.testing.assert_array_equal(padded.q[:2], qf.q)
    bf = BF16Feature(bits=bf16_bits(np.ones((2, 3, 4), np.float32)))
    assert bf.pad_rows(1) is bf
    padded = bf.pad_rows(4)
    assert padded.shape == (4, 3, 4)
    assert (padded.tensor()[2:] == 0).all()
    assert (padded.tensor()[:2] == 1).all()


@pytest.mark.parametrize("transfer", ["bfloat16", "int8"])
def test_cache_with_padded_rows_matches(datasets, tmp_path, transfer):
    """``pad_rows_to`` composes with the cache: padded rows of a cached
    block reach the device as the uncached zero rows."""
    ds, _ = datasets
    plans, _ = make_batch_indices(ds, 4, 64, separate_caption=True)
    cache = FeatureCache(str(tmp_path / "fc"), transfer=transfer)
    kw = dict(separate_caption=True, pad_rows_to=6)
    a = make_batch(ds, plans[0], **kw)
    b = make_batch(ds, plans[0], feature_cache=cache, **kw)   # fill
    c = make_batch(ds, plans[0], feature_cache=cache, **kw)   # serve
    for fa, fb, fc in zip(_device_fts(a, transfer),
                          _device_fts(b, transfer),
                          _device_fts(c, transfer)):
        assert fa.shape[0] == 6
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(fa, fc)


def test_an_int8_block_under_another_transfer_raises(datasets, tmp_path):
    ds, _ = datasets
    plans, _ = make_batch_indices(ds, 4, 64, separate_caption=True)
    cache = FeatureCache(str(tmp_path / "fc"), transfer="int8")
    hb = make_batch(ds, plans[0], separate_caption=True,
                    feature_cache=cache)
    with pytest.raises(ValueError, match="int8 feature-cache block"):
        device_batch(hb, "cpu", "float32")


@pytest.mark.parametrize("transfer", ["", "int8"])
def test_cli_train_with_feature_cache_gives_the_same_checkpoint(
        tiny_corpus, tmp_path, transfer):
    """Two epochs (the second served from the cache) train to the
    uncached run's checkpoint, bit for bit (f32 and int8 transfer)."""
    cache_dir = str(tmp_path / "cache")
    runs = {}
    for tag, extra in (("plain", []), ("cached",
                                       ["--feature-cache", cache_dir])):
        prefix = str(tmp_path / tag / "mtn")
        assert train_cli.main(train_argv(
            tiny_corpus, prefix, "--num-epochs", "2",
            "--feature-transfer", transfer, *extra)) == 0
        runs[tag] = prefix + "_torch"
    assert os.listdir(cache_dir)
    load = lambda tag, name: torch.load(os.path.join(runs[tag], name),
                                        weights_only=True)
    plain, cached = load("plain", "epoch_2.pt"), load("cached", "epoch_2.pt")
    assert plain.keys() == cached.keys()
    assert all(torch.equal(plain[k], cached[k]) for k in plain)
    plain, cached = (load("plain", "epoch_2.opt.pt"),
                     load("cached", "epoch_2.opt.pt"))
    for part in ("mu", "nu"):
        assert all(torch.equal(plain[part][k], cached[part][k])
                   for k in plain[part])
    meta = [json.load(open(os.path.join(runs[t], "meta.json")))
            for t in runs]
    assert meta[0] == meta[1]
