"""Migrate MTN checkpoints between the reference (PyTorch) format and the
port's, in both directions (``mtn_tpu/utils/migrate.py``).

Import (:func:`migrate_checkpoint`): the reference writes per-epoch
whole-module pickles (``torch.save(model, ...)``, reference
train.py:217) and a pickled ``(vocab, args)`` sidecar (train.py:166-168).
Both become the port's artifacts: the conf and vocab sidecars that
``cli.generate --model`` reads, and a training checkpoint
(``utils/checkpoint.py``) with fresh optimizer state.

Export (:func:`export_to_reference`): the inverse. A checkpoint of the
port is written back as a reference-format whole-module pickle and
``.conf``, loadable by the reference's own ``generate.py:130-133``.
Exporting needs the reference repository on disk (its classes define the
pickle): ``--reference-path``.

The parameter mapping reads and writes attributes only (``.weight``,
``.bias``, ``.a_2``, ``.b_2``, ``.h``, ``in_features``): the flax tree it
builds is the one of ``mtn_tpu``, which the port's ``state_dict`` names
follow (``weights.from_flax``).

CLI::

    python -m mtn_tpu_torch.utils.migrate import <model.pth.tar> \\
        <model.conf> <out_prefix>
    python -m mtn_tpu_torch.utils.migrate export exps/x/mtn_best \\
        <out.pth.tar> <out.conf> --reference-path <reference repository>
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Tuple

import numpy as np

from mtn_tpu_torch.config import DataConfig, ModelConfig, TrainConfig


def _linear(torch_lin) -> Dict[str, np.ndarray]:
    return {"kernel": torch_lin.weight.detach().numpy().T.copy(),
            "bias": torch_lin.bias.detach().numpy().copy()}


def _norm(torch_norm) -> Dict[str, np.ndarray]:
    return {"scale": torch_norm.a_2.detach().numpy().copy(),
            "bias": torch_norm.b_2.detach().numpy().copy()}


def _mha(torch_mha) -> Dict[str, Any]:
    return {name: _linear(torch_mha.linears[i])
            for i, name in enumerate(("w_q", "w_k", "w_v", "w_o"))}


def _ff(torch_ff) -> Dict[str, Any]:
    return {"w_1": _linear(torch_ff.w_1), "w_2": _linear(torch_ff.w_2)}


def _embed(torch_seq) -> Dict[str, Any]:
    return {"lut": {"embedding":
                    torch_seq[0].lut.weight.detach().numpy().copy()}}


def _sublayer_order(ae_ft, n_streams: int):
    """The decoder layer's sublayer names in the reference's count order
    (mtn.py:181-218)."""
    if ae_ft in ("caption", "summary"):
        order = ["sl_self", "sl_his", "sl_src", "sl_cap"]
    else:
        order = ["sl_self", "sl_his", "sl_cap", "sl_src"]
    for i in range(n_streams):
        order += [f"sl_ae_self_{i}", f"sl_ae_vid_{i}", f"sl_ae_ff_{i}",
                  f"sl_x_ae_{i}"]
    return order + ["sl_ff"]


def params_from_reference(ref_model) -> Tuple[dict, ModelConfig]:
    """Reference EncoderDecoder module -> (flax-shaped numpy tree,
    ModelConfig)."""
    n_streams = len(ref_model.vid_encoder)
    d_model = ref_model.generator.proj.in_features
    vocab_size = ref_model.generator.proj.out_features
    diff_encoder = bool(ref_model.diff_encoder)
    ae_ft = ref_model.auto_encoder_ft
    diff_embed = ref_model.auto_encoder_embed is not None
    diff_gen = ref_model.auto_encoder_generator is not None

    params: Dict[str, Any] = {"embed_src": _embed(ref_model.query_embed),
                              "embed_tgt": _embed(ref_model.tgt_embed)}
    if ref_model.his_embed is not None:
        params["embed_his"] = _embed(ref_model.his_embed)
    if ref_model.cap_embed is not None:
        params["embed_cap"] = _embed(ref_model.cap_embed)
    if diff_embed:
        for i in range(n_streams):
            params[f"ae_embed_{i}"] = _embed(ref_model.auto_encoder_embed[i])
    for i in range(n_streams):
        params[f"vid_encoder_{i}"] = {
            "proj": _linear(ref_model.vid_encoder[i][0])}
    # encoder norms in the reference walk order (mtn.py:83-101)
    norms = ref_model.query_encoder.norm
    enc: Dict[str, Any] = {"norm_query": _norm(norms[0])}
    for i in range(n_streams):
        enc[f"norm_vid_{i}"] = _norm(norms[1 + i])
    enc["norm_cap"] = _norm(norms[1 + n_streams])
    enc["norm_his"] = _norm(norms[2 + n_streams])
    if diff_encoder:
        for i in range(n_streams):
            enc[f"norm_ae_{i}"] = _norm(norms[3 + n_streams + i])
    params["encoder"] = enc

    decoder: Dict[str, Any] = {}
    for li, layer in enumerate(ref_model.decoder.layers):
        lp: Dict[str, Any] = {
            "self_attn": _mha(layer.self_attn),
            "his_attn": _mha(layer.his_attn),
            "cap_attn": _mha(layer.cap_attn),
            "src_attn": _mha(layer.src_attn),
            "ff": _ff(layer.feed_forward),
        }
        for i in range(n_streams):
            lp[f"ae_self_attn_{i}"] = _mha(layer.auto_encoder_self_attn[i])
            lp[f"ae_vid_attn_{i}"] = _mha(layer.auto_encoder_vid_attn[i])
            lp[f"ae_attn_{i}"] = _mha(layer.auto_encoder_attn[i])
            lp[f"ae_ff_{i}"] = _ff(layer.auto_encoder_feed_forward[i])
        for idx, name in enumerate(_sublayer_order(ae_ft, n_streams)):
            lp[name] = {"norm": _norm(layer.sublayer[idx].norm)}
        decoder[f"layer_{li}"] = lp
    decoder["norm"] = _norm(ref_model.decoder.norm)
    for i in range(n_streams):
        decoder[f"ae_norm_{i}"] = _norm(ref_model.decoder.ae_norm[i])
    params["decoder"] = decoder
    params["generator"] = {"proj": _linear(ref_model.generator.proj)}
    if diff_gen:
        for i in range(n_streams):
            params[f"ae_generator_{i}"] = {
                "proj": _linear(ref_model.auto_encoder_generator[i].proj)}

    layer0 = ref_model.decoder.layers[0]
    cfg = ModelConfig(
        vocab_size=vocab_size, nb_blocks=len(ref_model.decoder.layers),
        d_model=d_model, d_ff=layer0.feed_forward.w_1.out_features,
        att_h=layer0.self_attn.h,
        ft_sizes=[v[0].in_features for v in ref_model.vid_encoder],
        separate_his_embed=ref_model.his_embed is not None,
        separate_cap_embed=ref_model.cap_embed is not None,
        diff_encoder=diff_encoder, diff_embed=diff_embed,
        diff_gen=diff_gen, auto_encoder_ft=ae_ft)
    return params, cfg


def migrate_checkpoint(model_path: str, conf_path: str, out_prefix: str,
                       epoch: int = 1) -> Tuple[dict, ModelConfig, dict]:
    """Reference ``<model>.pth.tar`` + ``<model>.conf`` -> the port's
    artifacts under ``out_prefix`` (conf/vocab sidecars and a training
    checkpoint of ``epoch`` with fresh optimizer state). Returns (the
    flax-shaped numpy tree, the ModelConfig, the vocabulary)."""
    import torch

    from mtn_tpu_torch.train.trainer import Trainer
    from mtn_tpu_torch.utils.checkpoint import CheckpointManager
    from mtn_tpu_torch.weights import from_flax

    with open(conf_path, "rb") as f:
        vocab, train_args = pickle.load(f)
    ref_model = torch.load(model_path, map_location="cpu",
                           weights_only=False)
    params, model_cfg = params_from_reference(ref_model)

    data_cfg = DataConfig(
        fea_type=list(getattr(train_args, "fea_type", []) or []),
        include_caption=getattr(train_args, "include_caption", "none"),
        separate_caption=bool(getattr(train_args, "separate_caption", False)),
        max_history_length=getattr(train_args, "max_history_length", -1),
        merge_source=bool(getattr(train_args, "merge_source", False)),
        batch_size=getattr(train_args, "batch_size", 32),
        max_length=getattr(train_args, "max_length", 256),
        cut_a=bool(getattr(train_args, "cut_a", False)))
    train_cfg = TrainConfig(
        warmup_steps=getattr(train_args, "warmup_steps", 4000),
        loss_l=getattr(train_args, "loss_l", 1.0))

    ckpt = CheckpointManager(out_prefix)
    ckpt.save_conf(vocab, model=model_cfg, data=data_cfg, train=train_cfg)
    trainer = Trainer(model_cfg, train_cfg, "cpu")
    ckpt.save(epoch, trainer.state_from(from_flax(params)))
    ckpt.flush()
    return params, model_cfg, vocab


# ---------------------------------------------------------------------------
# Export: the port -> reference torch format
# ---------------------------------------------------------------------------

def _set_linear(torch, lin, p):
    lin.weight.copy_(torch.tensor(np.asarray(p["kernel"], np.float32).T))
    lin.bias.copy_(torch.tensor(np.asarray(p["bias"], np.float32)))


def _set_norm(torch, norm, p):
    norm.a_2.copy_(torch.tensor(np.asarray(p["scale"], np.float32)))
    norm.b_2.copy_(torch.tensor(np.asarray(p["bias"], np.float32)))


def _set_mha(torch, mha, p):
    for i, name in enumerate(("w_q", "w_k", "w_v", "w_o")):
        _set_linear(torch, mha.linears[i], p[name])


def _set_ff(torch, ff, p):
    _set_linear(torch, ff.w_1, p["w_1"])
    _set_linear(torch, ff.w_2, p["w_2"])


def _set_embed(torch, seq, p):
    seq[0].lut.weight.copy_(torch.tensor(
        np.asarray(p["lut"]["embedding"], np.float32)))


def load_params_into_reference(ref_model, params) -> None:
    """Copy a flax-shaped tree (``weights.to_flax`` of a state dict) into
    a reference torch EncoderDecoder: the exact inverse of
    :func:`params_from_reference` (separate embeds, diff_embed/diff_gen,
    both sublayer orders)."""
    import torch

    n_streams = len(ref_model.vid_encoder or [])
    with torch.no_grad():
        _set_embed(torch, ref_model.query_embed, params["embed_src"])
        _set_embed(torch, ref_model.tgt_embed, params["embed_tgt"])
        if ref_model.his_embed is not None:
            _set_embed(torch, ref_model.his_embed, params["embed_his"])
        if ref_model.cap_embed is not None:
            _set_embed(torch, ref_model.cap_embed, params["embed_cap"])
        if ref_model.auto_encoder_embed is not None:
            for i in range(n_streams):
                _set_embed(torch, ref_model.auto_encoder_embed[i],
                           params[f"ae_embed_{i}"])
        for i in range(n_streams):
            _set_linear(torch, ref_model.vid_encoder[i][0],
                        params[f"vid_encoder_{i}"]["proj"])
        # encoder norms, reference walk order (mtn.py:83-101)
        enc = params["encoder"]
        norms = ref_model.query_encoder.norm
        _set_norm(torch, norms[0], enc["norm_query"])
        for i in range(n_streams):
            _set_norm(torch, norms[1 + i], enc[f"norm_vid_{i}"])
        _set_norm(torch, norms[1 + n_streams], enc["norm_cap"])
        _set_norm(torch, norms[2 + n_streams], enc["norm_his"])
        if ref_model.diff_encoder:
            for i in range(n_streams):
                _set_norm(torch, norms[3 + n_streams + i],
                          enc[f"norm_ae_{i}"])
        order = _sublayer_order(ref_model.auto_encoder_ft, n_streams)
        for li, layer in enumerate(ref_model.decoder.layers):
            lp = params["decoder"][f"layer_{li}"]
            _set_mha(torch, layer.self_attn, lp["self_attn"])
            _set_mha(torch, layer.his_attn, lp["his_attn"])
            _set_mha(torch, layer.cap_attn, lp["cap_attn"])
            _set_mha(torch, layer.src_attn, lp["src_attn"])
            _set_ff(torch, layer.feed_forward, lp["ff"])
            for i in range(n_streams):
                _set_mha(torch, layer.auto_encoder_self_attn[i],
                         lp[f"ae_self_attn_{i}"])
                _set_mha(torch, layer.auto_encoder_vid_attn[i],
                         lp[f"ae_vid_attn_{i}"])
                _set_mha(torch, layer.auto_encoder_attn[i],
                         lp[f"ae_attn_{i}"])
                _set_ff(torch, layer.auto_encoder_feed_forward[i],
                        lp[f"ae_ff_{i}"])
            for idx, name in enumerate(order):
                _set_norm(torch, layer.sublayer[idx].norm,
                          lp[name]["norm"])
        _set_norm(torch, ref_model.decoder.norm, params["decoder"]["norm"])
        for i in range(n_streams):
            _set_norm(torch, ref_model.decoder.ae_norm[i],
                      params["decoder"][f"ae_norm_{i}"])
        _set_linear(torch, ref_model.generator.proj,
                    params["generator"]["proj"])
        if ref_model.auto_encoder_generator is not None:
            for i in range(n_streams):
                _set_linear(torch, ref_model.auto_encoder_generator[i].proj,
                            params[f"ae_generator_{i}"]["proj"])


def _import_reference(reference_path: str):
    """Import the reference's mtn module (stubbing vestigial torchtext)."""
    import sys
    import types
    if "torchtext" not in sys.modules:
        tt = types.ModuleType("torchtext")
        tt.data = types.SimpleNamespace(Iterator=object, batch=None)
        tt.datasets = types.SimpleNamespace()
        sys.modules["torchtext"] = tt
    sys.path.insert(0, reference_path)
    try:
        import mtn as ref_mtn  # noqa
    finally:
        sys.path.remove(reference_path)
    return ref_mtn


def build_reference_model(model_cfg: ModelConfig, reference_path: str):
    """Construct a reference torch model matching a ModelConfig."""
    ref_mtn = _import_reference(reference_path)
    return ref_mtn.make_model(
        model_cfg.vocab_size, model_cfg.vocab_size,
        N=model_cfg.nb_blocks, d_model=model_cfg.d_model,
        d_ff=model_cfg.d_ff, h=model_cfg.att_h, dropout=model_cfg.dropout,
        separate_his_embed=model_cfg.separate_his_embed,
        separate_cap_embed=model_cfg.separate_cap_embed,
        ft_sizes=list(model_cfg.ft_sizes) or None,
        diff_encoder=model_cfg.diff_encoder,
        diff_embed=model_cfg.diff_embed, diff_gen=model_cfg.diff_gen,
        auto_encoder_ft=model_cfg.auto_encoder_ft)


def export_to_reference(prefix: str, out_model: str, out_conf: str,
                        reference_path: str, epoch="best"):
    """A checkpoint of the port -> reference-format artifacts.

    Writes ``out_model`` (whole-module ``torch.save`` pickle, the
    reference train.py:217 format) and ``out_conf`` (pickled ``(vocab,
    args)``, train.py:166-168) so the reference's own ``generate.py`` can
    load them. Returns (the transplanted torch model, the epoch)."""
    import argparse

    import torch

    from mtn_tpu_torch.config import config_from_dict
    from mtn_tpu_torch.weights import load_checkpoint, load_conf, to_flax

    vocab, conf = load_conf(prefix)
    model_cfg = config_from_dict("model", conf["model"])
    data_cfg = config_from_dict("data", conf.get("data", {}))
    state_dict, used_epoch = load_checkpoint(prefix, epoch)

    ref_model = build_reference_model(model_cfg, reference_path)
    ref_model.eval()
    load_params_into_reference(ref_model, to_flax(state_dict))
    torch.save(ref_model, out_model)

    # (vocab, args) sidecar with the argparse-namespace shape the
    # reference pickles (generate.py reads attributes off it)
    args = argparse.Namespace(
        fea_type=list(data_cfg.fea_type),
        include_caption=data_cfg.include_caption,
        separate_caption=int(data_cfg.separate_caption),
        max_history_length=data_cfg.max_history_length,
        merge_source=int(data_cfg.merge_source),
        batch_size=data_cfg.batch_size, max_length=data_cfg.max_length,
        cut_a=int(data_cfg.cut_a),
        nb_blocks=model_cfg.nb_blocks, d_model=model_cfg.d_model,
        d_ff=model_cfg.d_ff, att_h=model_cfg.att_h,
        dropout=model_cfg.dropout,
        separate_his_embed=int(model_cfg.separate_his_embed),
        separate_cap_embed=int(model_cfg.separate_cap_embed),
        diff_encoder=int(model_cfg.diff_encoder),
        diff_embed=int(model_cfg.diff_embed),
        diff_gen=int(model_cfg.diff_gen),
        auto_encoder_ft=model_cfg.auto_encoder_ft)
    with open(out_conf, "wb") as f:
        pickle.dump((vocab, args), f)
    return ref_model, used_epoch


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="Migrate checkpoints between the reference torch "
                    "format and mtn_tpu_torch (both directions)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_imp = sub.add_parser("import", help="reference -> mtn_tpu_torch")
    p_imp.add_argument("model_path")
    p_imp.add_argument("conf_path")
    p_imp.add_argument("out_prefix")
    p_imp.add_argument("--epoch", type=int, default=1)
    p_exp = sub.add_parser("export", help="mtn_tpu_torch -> reference")
    p_exp.add_argument("prefix",
                       help="checkpoint prefix, optionally suffixed like "
                            "the generate CLI's --model: 'exps/x/mtn_best', "
                            "'exps/x/mtn_latest', 'exps/x/mtn_7'")
    p_exp.add_argument("out_model")
    p_exp.add_argument("out_conf")
    p_exp.add_argument("--reference-path", required=True,
                       help="the reference repository (its mtn.py "
                            "defines the exported pickle's classes)")
    args = parser.parse_args(argv)
    if args.cmd == "import":
        migrate_checkpoint(args.model_path, args.conf_path, args.out_prefix,
                           epoch=args.epoch)
    else:
        from mtn_tpu_torch.cli.generate import _split_model_arg
        prefix, epoch = _split_model_arg(args.prefix)
        export_to_reference(prefix, args.out_model, args.out_conf,
                            args.reference_path, epoch=epoch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
