"""``mtn_tpu_torch.utils.migrate`` against ``mtn_tpu.utils.migrate`` on a
stand-in for the reference's ``EncoderDecoder``: modules that hold the
reference's attributes (``linears``, ``a_2``/``b_2``, ``sublayer``, ...)
filled from seeded numpy. The stand-in's classes live in this module, so
``torch.load`` of its whole-module pickle finds them. The export to the
reference's own classes needs the reference repository and skips without
it, as ``tests/test_migrate.py`` does.
"""

import argparse
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
from torch import nn

from mtn_tpu_torch.config import config_from_dict
from mtn_tpu_torch.data.batching import HostBatch
from mtn_tpu_torch.train.batch import batch_masks, device_batch
from mtn_tpu_torch.utils.migrate import (export_to_reference,
                                         load_params_into_reference,
                                         main as migrate_main,
                                         migrate_checkpoint,
                                         params_from_reference)
from mtn_tpu_torch.weights import (from_flax, load_checkpoint, load_conf,
                                   load_model, to_flax)
from tests.torch_parity import PAD, host_fields

V, D, FF, H, N_LAYERS, FT_SIZES = 24, 16, 32, 2, 2, [12, 8]


class Norm(nn.Module):
    def __init__(self):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(D))
        self.b_2 = nn.Parameter(torch.zeros(D))


class Lut(nn.Module):
    def __init__(self):
        super().__init__()
        self.lut = nn.Embedding(V, D)


class Attn(nn.Module):
    def __init__(self):
        super().__init__()
        self.h = H
        self.linears = nn.ModuleList([nn.Linear(D, D) for _ in range(4)])


class FeedForward(nn.Module):
    def __init__(self):
        super().__init__()
        self.w_1, self.w_2 = nn.Linear(D, FF), nn.Linear(FF, D)


class Sublayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = Norm()


class Layer(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.self_attn, self.his_attn = Attn(), Attn()
        self.cap_attn, self.src_attn = Attn(), Attn()
        self.feed_forward = FeedForward()
        self.auto_encoder_self_attn = nn.ModuleList(Attn() for _ in range(n))
        self.auto_encoder_vid_attn = nn.ModuleList(Attn() for _ in range(n))
        self.auto_encoder_attn = nn.ModuleList(Attn() for _ in range(n))
        self.auto_encoder_feed_forward = nn.ModuleList(
            FeedForward() for _ in range(n))
        self.sublayer = nn.ModuleList(Sublayer() for _ in range(5 + 4 * n))


class Decoder(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.layers = nn.ModuleList(Layer(n) for _ in range(N_LAYERS))
        self.norm = Norm()
        self.ae_norm = nn.ModuleList(Norm() for _ in range(n))


class Generator(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(D, V)


class Encoder(nn.Module):
    def __init__(self, n_norms):
        super().__init__()
        self.norm = nn.ModuleList(Norm() for _ in range(n_norms))


class EncoderDecoder(nn.Module):
    """The attributes of the reference's model that the migration reads,
    in the configuration space it maps."""

    def __init__(self, ae_ft="query", separate=True, diff=True):
        super().__init__()
        n = len(FT_SIZES)
        seq = lambda: nn.Sequential(Lut())
        self.query_embed, self.tgt_embed = seq(), seq()
        self.his_embed = seq() if separate else None
        self.cap_embed = seq() if separate else None
        self.auto_encoder_embed = nn.ModuleList(
            seq() for _ in range(n)) if diff else None
        self.vid_encoder = nn.ModuleList(
            nn.Sequential(nn.Linear(f, D), nn.ReLU()) for f in FT_SIZES)
        self.diff_encoder = diff
        self.auto_encoder_ft = ae_ft
        self.query_encoder = Encoder(3 + n + (n if diff else 0))
        self.decoder = Decoder(n)
        self.generator = Generator()
        self.auto_encoder_generator = nn.ModuleList(
            Generator() for _ in range(n)) if diff else None


def stand_in(seed, **kw):
    model = EncoderDecoder(**kw)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                0.3 * rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    return model.eval()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


CONFIGS = [dict(ae_ft="query", separate=True, diff=True),
           dict(ae_ft="caption", separate=False, diff=False)]


@pytest.mark.parametrize("kw", CONFIGS, ids=["query", "caption"])
def test_tree_and_config_equal_jax_params_from_reference(kw):
    from mtn_tpu.utils.migrate import params_from_reference as jax_migrate
    ref = stand_in(0, **kw)
    tree, cfg = params_from_reference(ref)
    jtree, jcfg = jax_migrate(ref)
    got, want = _flat(tree), _flat(jtree)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k
    # the JAX package's fields alike; the port's own (the architecture)
    # at their defaults
    port, jax_cfg = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert {k: port.pop(k) for k in jax_cfg} == jax_cfg
    assert port == {"architecture": "mtn", "lm": {}}
    # every parameter of the port's model, and nothing else
    from mtn_tpu_torch.weights import param_shapes
    shapes = param_shapes(cfg)
    flat = from_flax(tree)
    assert {k: tuple(v.shape) for k, v in flat.items()} == shapes


def _reference_files(tmp_path, model):
    model_path = str(tmp_path / "mtn_1.pth.tar")
    conf_path = str(tmp_path / "mtn.conf")
    torch.save(model, model_path)
    vocab = {"<unk>": 0, "<blank>": 1, "<sos>": 2, "<eos>": 3}
    while len(vocab) < V:
        vocab[f"w{len(vocab)}"] = len(vocab)
    train_args = argparse.Namespace(
        fea_type=["a", "b"], include_caption="caption,summary",
        separate_caption=True, max_history_length=-1, merge_source=False,
        batch_size=32, max_length=256, cut_a=True, warmup_steps=1234,
        loss_l=1.0)
    with open(conf_path, "wb") as f:
        pickle.dump((vocab, train_args), f)
    return model_path, conf_path, vocab


def test_migrated_checkpoint_forward_equals_the_stand_in(tmp_path):
    """``migrate_checkpoint`` on the pickles: the sidecars, a checkpoint
    of the epoch with fresh optimizer state, and a forward bitwise the
    stand-in's parameters loaded through ``from_flax``."""
    ref = stand_in(1)
    model_path, conf_path, vocab = _reference_files(tmp_path, ref)
    out = str(tmp_path / "migrated" / "mtn")
    os.makedirs(os.path.dirname(out))
    tree, cfg, vocab2 = migrate_checkpoint(model_path, conf_path, out,
                                           epoch=7)
    assert vocab2 == vocab
    v3, conf = load_conf(out)
    assert v3 == vocab
    assert conf["train"]["warmup_steps"] == 1234
    assert conf["data"]["include_caption"] == "caption,summary"
    assert config_from_dict("model", conf["model"]) == cfg
    sd, epoch = load_checkpoint(out, "latest")
    assert epoch == 7
    opt = torch.load(os.path.join(out + "_torch", "epoch_7.opt.pt"),
                     weights_only=False)
    assert opt["step"] == 0 and opt["count"] == 0
    assert all(not t.any() for t in opt["mu"].values())

    fields = host_fields(np.random.default_rng(2), B=2, ft_dims=FT_SIZES,
                         vocab=V)
    db = device_batch(HostBatch(**fields), "cpu")
    masks, tgt_mask = batch_masks(db, PAD)
    outs = []
    for state_dict in (sd, from_flax(params_from_reference(ref)[0])):
        model = load_model(cfg, state_dict, "cpu")
        with torch.no_grad():
            outs.append(model(db.query, db.his, db.cap, db.fts, masks,
                              db.answer_in, tgt_mask)[0])
    assert torch.equal(outs[0], outs[1])
    assert torch.isfinite(outs[0]).all()


@pytest.mark.parametrize("kw", CONFIGS, ids=["query", "caption"])
def test_load_params_into_reference_round_trips_exactly(kw):
    tree, _ = params_from_reference(stand_in(2, **kw))
    other = stand_in(3, **kw)
    load_params_into_reference(other, tree)
    back, _ = params_from_reference(other)
    got, want = _flat(back), _flat(tree)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    # through the port's state dict, as export_to_reference passes it
    third = stand_in(4, **kw)
    load_params_into_reference(third, to_flax(from_flax(tree)))
    assert all(np.array_equal(a, want[k]) for k, a in
               _flat(params_from_reference(third)[0]).items())


def test_cli_import_and_export_needs_the_reference(tmp_path, capsys):
    model_path, conf_path, _ = _reference_files(tmp_path, stand_in(5))
    out = str(tmp_path / "cli" / "mtn")
    os.makedirs(os.path.dirname(out))
    assert migrate_main(["import", model_path, conf_path, out,
                         "--epoch", "3"]) == 0
    assert load_checkpoint(out, 3)[1] == 3
    with pytest.raises(SystemExit) as ei:
        migrate_main(["export", out + "_3", "a.pth.tar", "a.conf"])
    assert ei.value.code == 2
    assert "--reference-path" in capsys.readouterr().err


def test_export_round_trip_through_the_reference(tmp_path):
    """A checkpoint of the port exported into the reference's own classes
    and read back by the import mapping: every parameter bitwise."""
    from tests.test_reference_parity import REF
    if not os.path.isdir(REF):
        pytest.skip("the reference repository is not on disk")
    model_path, conf_path, vocab = _reference_files(tmp_path, stand_in(6))
    prefix = str(tmp_path / "exp" / "mtn")
    os.makedirs(os.path.dirname(prefix))
    tree, cfg, _ = migrate_checkpoint(model_path, conf_path, prefix, epoch=1)
    out_model, out_conf = (str(tmp_path / "x.pth.tar"),
                           str(tmp_path / "x.conf"))
    ref, epoch = export_to_reference(prefix, out_model, out_conf, REF,
                                     epoch=1)
    assert epoch == 1
    back, cfg2 = params_from_reference(torch.load(out_model,
                                                  weights_only=False))
    assert cfg2 == cfg
    assert all(np.array_equal(a, _flat(tree)[k])
               for k, a in _flat(back).items())
    with open(out_conf, "rb") as f:
        v2, args = pickle.load(f)
    assert v2 == vocab and args.fea_type == ["a", "b"]
