"""Discriminative (VisDial-style) evaluation entry point
(``mtn_tpu/cli/rank.py``): each scored turn's answer options ranked by
generative log-likelihood.

    python scripts/make_rank_candidates.py lbl_test.json cands.json --last
    python -m mtn_tpu_torch.cli.rank --model exps/x/mtn_best \\
        --test-path 'data/<FeaType>/<ImageID>.npy' --test-set test.json \\
        --candidates cands.json --undisclosed-only 1 --output ranks.json

The candidates JSON mirrors the test set's dialogs, one entry per scored
turn (the last turn only under ``--undisclosed-only 1``)::

    {"dialogs": [{"image_id": "...", "dialog": [
        {"answer_options": ["a cat", ...], "gt_index": 3}, ...]}, ...]}

``gt_index`` is optional per turn; when every scored turn has one, the
retrieval block (R@1/5/10, mean rank, MRR) is printed as ``r@1: ...``
lines and written into the output JSON, beside each turn's ``scores``
(one log-likelihood per option, input order) and ``gt_rank``. Turns go in
length-sorted uniform-shape batches through ``BeamDecoder.rank_batch``,
with the (N, L) candidate buckets at the global maxima, as in JAX. The
checkpoint is the port's format (``mtn_tpu_torch/weights.py``). Under
``--multihost`` the turn batches are cut over the data ranks and the
model over the model ranks, as in ``cli.generate``; rank 0 writes.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import time

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    from mtn_tpu_torch.cli.common import add_device_args, add_logging_args
    parser = argparse.ArgumentParser(
        description="Rank answer candidates by generative log-likelihood")
    parser.add_argument("--test-path", default="", type=str)
    parser.add_argument("--test-set", default="", type=str)
    parser.add_argument("--model", "-m", default="", type=str,
                        help="model prefix, optionally with _<epoch|best|"
                             "latest> suffix")
    parser.add_argument("--candidates", default="", type=str, required=True,
                        help="candidates JSON (see the module docstring; "
                             "build one with scripts/make_rank_candidates.py)")
    parser.add_argument("--output", "-o", default="", type=str,
                        help="write scores/ranks/metrics JSON here")
    parser.add_argument("--undisclosed-only", default=0, type=int)
    parser.add_argument("--turn-batch", default=4, type=int,
                        help="dialogue turns scored per device batch (each "
                             "turn is tiled over its options, so a decode "
                             "step has turn_batch x n_options rows)")
    parser.add_argument("--include-eos", default=1, type=int,
                        help="score the answer+<eos> event the generative "
                             "loss trains (0: bare token sequence)")
    parser.add_argument("--multihost", default="", type=str,
                        help="'auto' (torchrun's environment) or "
                             "'host:port,nprocs,procid': join a multi-"
                             "process run; turn batches shard over the "
                             "data ranks, scores are gathered, rank 0 "
                             "writes (mtn_tpu_torch/parallel/multihost.py)")
    add_device_args(parser)
    add_logging_args(parser)
    return parser


def _align_candidates(dataset, cand_data, undisclosed: bool):
    """The candidates entry of every scored turn, in qa_id order,
    validating that the file mirrors the test set's dialogs and turns."""
    dialogs = dataset.original["dialogs"]
    cdialogs = cand_data.get("dialogs")
    if not isinstance(cdialogs, list) or len(cdialogs) != len(dialogs):
        raise ValueError(
            f"candidates file has {len(cdialogs or [])} dialogs, "
            f"test set has {len(dialogs)}")
    turn_cands = []
    for idx, (dlg, cdlg) in enumerate(zip(dialogs, cdialogs)):
        if cdlg.get("image_id") != dlg["image_id"]:
            raise ValueError(
                f"dialog {idx}: candidates image_id {cdlg.get('image_id')!r}"
                f" != test set {dlg['image_id']!r}")
        scored = dlg["dialog"][-1:] if undisclosed else dlg["dialog"]
        cturns = cdlg.get("dialog", [])
        if len(cturns) != len(scored):
            raise ValueError(
                f"dialog {idx} ({dlg['image_id']}): candidates has "
                f"{len(cturns)} turns, {len(scored)} are scored")
        for t, ct in enumerate(cturns):
            opts = ct.get("answer_options")
            if not isinstance(opts, list) or not opts or \
                    not all(isinstance(o, str) and o.strip() for o in opts):
                raise ValueError(
                    f"dialog {idx} turn {t}: 'answer_options' must be a "
                    "non-empty list of non-empty strings")
            gt = ct.get("gt_index")
            if gt is not None and not (isinstance(gt, int)
                                       and 0 <= gt < len(opts)):
                raise ValueError(
                    f"dialog {idx} turn {t}: gt_index {gt!r} out of "
                    f"{len(opts)} options")
            turn_cands.append(ct)
    if len(turn_cands) != len(dataset):
        raise ValueError(
            f"{len(turn_cands)} candidate turns vs {len(dataset)} scored "
            "turns — does --undisclosed-only match the candidates file?")
    return turn_cands


def rank_dataset(model, dataset, turn_cands, data_cfg, vocab, device,
                 turn_batch: int = 4, include_eos: bool = True,
                 feature_dtype: str = "float32", shardings=None):
    """Score every turn's options; returns (scores per qa_id, wall, n):
    one ``[logp, ...]`` per qa_id, in option order. With ``shardings``
    each rank scores its rows of every batch and every rank gets every
    score."""
    from mtn_tpu_torch.config import DecodeConfig
    from mtn_tpu_torch.data.batching import (make_batch, make_batch_indices,
                                             uniform_plans)
    from mtn_tpu_torch.data.vocab import words2ids
    from mtn_tpu_torch.decode.beam import BeamDecoder
    from mtn_tpu_torch.train.batch import to_device_fn

    # words2ids wraps with <sos>/<eos>; rank_batch supplies its own <sos>
    # input and <eos> target, so strip both
    tok = [[words2ids(o, vocab)[1:-1].tolist()
            for o in ct["answer_options"]] for ct in turn_cands]
    n_opts = max(len(t) for t in tok)
    max_len = max((len(o) for t in tok for o in t), default=0) \
        + (1 if include_eos else 0)
    decoder = BeamDecoder(model, DecodeConfig(turn_batch=turn_batch),
                          shardings=shardings)
    to_device = to_device_fn(feature_dtype, shardings, device)
    plans, n = make_batch_indices(dataset, batchsize=turn_batch,
                                  max_length=10 ** 9,
                                  separate_caption=data_cfg.separate_caption)
    # uniform context shapes and global (N, L) buckets: one set of shapes
    plans = uniform_plans(plans)
    scores = {}
    t0 = time.time()
    for plan in plans:
        hb = make_batch(dataset, plan,
                        separate_caption=data_cfg.separate_caption,
                        skip=data_cfg.skip,
                        length_bucket=data_cfg.length_bucket,
                        feature_bucket=data_cfg.feature_bucket,
                        pad_rows_to=turn_batch)
        db = to_device(hb)
        # a candidate row for every row of the whole batch
        cands = [tok[plan.qa_ids[b]] if b < len(plan.qa_ids) else []
                 for b in range(hb.query.shape[0])]
        out = decoder.rank_batch(db, cands, include_eos=include_eos,
                                 len_bucket=max(max_len, 1),
                                 cand_bucket=max(n_opts, 1))
        for qa_id, row in zip(plan.qa_ids, out):
            scores[qa_id] = row
    wall = time.time() - t0
    return [scores[i] for i in range(len(turn_cands))], wall, n


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mtn_tpu_torch.cli.common import (init_parallel, print_args,
                                          setup_logging)
    setup_logging(args.verbose)
    print_args(args)
    device, shardings = init_parallel(args, args.turn_batch)
    import torch
    from mtn_tpu_torch.cli.generate import _split_model_arg
    from mtn_tpu_torch.config import config_from_dict
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.evalmetrics.retrieval import rank_of, retrieval_metrics
    from mtn_tpu_torch.weights import load_checkpoint, load_conf, load_model

    if args.dtype == "float32":
        # full f32 products (no TF32), as the JAX CLI asks for "highest"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    prefix, epoch = _split_model_arg(args.model)
    log.info("Loading model params from %s (epoch=%s)", prefix, epoch)
    vocab, conf = load_conf(prefix)
    model_cfg = config_from_dict("model", conf["model"])
    data_cfg = config_from_dict("data", conf["data"])
    model_cfg.dtype = args.dtype
    model_cfg.use_pallas_attention = bool(args.use_pallas_attention)
    model_cfg.use_pallas_ffn = bool(args.use_pallas_ffn)
    model_cfg.fused_decode_qkv = bool(args.fused_decode_qkv)

    fea_type = data_cfg.fea_type if data_cfg.fea_type and \
        data_cfg.fea_type[0] != "none" else None
    test_data = load(fea_type, args.test_path, args.test_set, vocab,
                     include_caption=data_cfg.include_caption,
                     separate_caption=data_cfg.separate_caption,
                     max_history_length=data_cfg.max_history_length,
                     merge_source=data_cfg.merge_source,
                     undisclosed_only=bool(args.undisclosed_only))
    log.info("#test sample = %d", len(test_data))
    with open(args.candidates) as f:
        cand_data = json.load(f)
    turn_cands = _align_candidates(test_data, cand_data,
                                   bool(args.undisclosed_only))

    state_dict, used_epoch = load_checkpoint(prefix, epoch)
    model = load_model(model_cfg, state_dict, device)
    log.info("Restored checkpoint epoch %s on %s", used_epoch, device)
    if shardings is not None:
        shardings.shard_model(model)
    log.info("--------------------rank--------------------")
    all_scores, wall, n = rank_dataset(
        model, test_data, turn_cands, data_cfg, vocab, device,
        turn_batch=args.turn_batch, include_eos=bool(args.include_eos),
        feature_dtype=args.feature_transfer or model_cfg.dtype,
        shardings=shardings)
    n_scored = sum(len(s) for s in all_scores)
    log.info("scored %d options over %d turns in %.2fs (%.1f options/sec)",
             n_scored, n, wall, n_scored / max(wall, 1e-9))

    out_dialogs = copy.deepcopy(cand_data["dialogs"])
    gt_ranks = []
    qa_id = 0
    for dlg in out_dialogs:
        for turn in dlg["dialog"]:
            turn["scores"] = all_scores[qa_id]
            gt = turn.get("gt_index")
            if gt is not None:
                turn["gt_rank"] = rank_of(all_scores[qa_id], gt)
                gt_ranks.append(turn["gt_rank"])
            qa_id += 1
    result = {"dialogs": out_dialogs}
    if len(gt_ranks) == len(turn_cands):
        result["metrics"] = retrieval_metrics(gt_ranks)
        for k, v in result["metrics"].items():
            print(f"{k}: {v:.4f}")
    elif gt_ranks:
        log.warning("gt_index present on %d/%d turns — retrieval metrics "
                    "need all of them; emitting per-turn gt_rank only",
                    len(gt_ranks), len(turn_cands))
    from mtn_tpu_torch.parallel.multihost import is_primary, shutdown
    # every rank holds every score; rank 0 writes them
    if args.output and is_primary():
        log.info("writing ranks to %s", args.output)
        with open(args.output, "w") as f:
            json.dump(result, f, indent=4)
    log.info("done")
    shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
