"""Generation entry point (``mtn_tpu/cli/generate.py``; run.sh stage 3).

    python -m mtn_tpu_torch.cli.generate --model exps/x/mtn_best \\
        --test-path 'data/<FeaType>/<ImageID>.npy' --test-set test.json \\
        --decode-style beam_search --beam 5 --turn-batch 32 \\
        --use-pallas-attention 1 --use-pallas-ffn 1 --output result.json

Turns are grouped into length-sorted batches and beam-decoded (or greedy)
on one device; the result JSON has the format of ``mtn_tpu.cli.generate``
and is scored by ``python -m mtn_tpu.cli.evaluate``. The checkpoint is the
port's format (``mtn_tpu_torch/weights.py``). A producer thread builds and
uploads the next batches while the device decodes.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import queue
import threading
import time

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    from mtn_tpu_torch.cli.common import add_device_args, add_logging_args
    parser = argparse.ArgumentParser(description="Generate responses")
    parser.add_argument("--gpu", "-g", default=0, type=int,
                        help="accepted for run.sh parity; see --device")
    parser.add_argument("--test-path", default="", type=str)
    parser.add_argument("--test-set", default="", type=str)
    parser.add_argument("--model-conf", default="", type=str,
                        help="accepted for parity; config is read from "
                             "<model prefix>.conf.json")
    parser.add_argument("--model", "-m", default="", type=str,
                        help="model prefix, optionally with _<epoch|best|"
                             "latest> suffix")
    parser.add_argument("--maxlen", default=30, type=int)
    parser.add_argument("--beam", default=3, type=int)
    parser.add_argument("--penalty", default=2.0, type=float)
    parser.add_argument("--nbest", default=5, type=int)
    parser.add_argument("--output", "-o", default="", type=str)
    parser.add_argument("--decode-style", default="greedy", type=str,
                        choices=["greedy", "beam_search", "sample"])
    parser.add_argument("--temperature", default=1.0, type=float)
    parser.add_argument("--top-k", default=0, type=int)
    parser.add_argument("--top-p", default=0.0, type=float)
    parser.add_argument("--sample-seed", default=1, type=int)
    parser.add_argument("--undisclosed-only", default=0, type=int)
    parser.add_argument("--labeled-test", default=None, type=str)
    parser.add_argument("--turn-batch", default=16, type=int,
                        help="dialogue turns decoded per device batch")
    parser.add_argument("--uniform-shapes", default=1, type=int,
                        help="pad all decode batches to global maxima")
    parser.add_argument("--early-stop", default=1, type=int,
                        help="stop the beam loop as soon as no active "
                             "hypothesis can still enter any n-best "
                             "(output-identical; 0 runs all maxlen steps)")
    parser.add_argument("--weights-quant", default="", type=str,
                        choices=["", "int8", "int8-fp-head"],
                        help="not ported")
    parser.add_argument("--multihost", default="", type=str,
                        help="not ported")
    parser.add_argument("--stats-output", default="", type=str,
                        help="write decode statistics (turns, seconds, "
                             "responses/sec, mean beam exit step) as JSON")
    add_device_args(parser)
    add_logging_args(parser)
    return parser


def _split_model_arg(model: str):
    """'exps/x/mtn_best' -> ('exps/x/mtn', 'best'); '..._7' -> (.., 7)."""
    if "_" in model:
        prefix, suffix = model.rsplit("_", 1)
        if suffix in ("best", "latest"):
            return prefix, suffix
        if suffix.isdigit():
            return prefix, int(suffix)
    return model, "best"


def generate_responses(model, dataset, decode_cfg, data_cfg, vocab, device,
                       feature_dtype="float32", ref_data=None,
                       log_hyps=True):
    """Decode every turn; returns ``(result, stats)``: the reference-format
    result dict (deep-copied dialogs with the 1-best hypothesis in place of
    each answer) and a dict of decode statistics."""
    from mtn_tpu_torch.data.batching import (make_batch, make_batch_indices,
                                             uniform_plans)
    from mtn_tpu_torch.data.vocab import vocab_list
    from mtn_tpu_torch.decode.beam import BeamDecoder, detokenize
    from mtn_tpu_torch.train.batch import device_batch

    vlist = vocab_list(vocab)
    decoder = BeamDecoder(model, decode_cfg)
    plans, n = make_batch_indices(dataset, batchsize=decode_cfg.turn_batch,
                                  max_length=10 ** 9,
                                  separate_caption=data_cfg.separate_caption)
    if decode_cfg.uniform_shapes and plans:
        plans = uniform_plans(plans)
    answers, scores, nbest = {}, {}, {}
    steps = []
    q: "queue.Queue" = queue.Queue(maxsize=3)
    err = []

    def produce():
        try:
            for plan in plans:
                hb = make_batch(dataset, plan,
                                separate_caption=data_cfg.separate_caption,
                                skip=data_cfg.skip,
                                length_bucket=data_cfg.length_bucket,
                                feature_bucket=data_cfg.feature_bucket,
                                pad_rows_to=decode_cfg.turn_batch)
                q.put((plan, device_batch(hb, device, feature_dtype)))
        except BaseException as e:  # re-raised by the consumer below
            err.append(e)
        finally:
            q.put(None)

    t0 = time.time()
    t_first = None
    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    while True:
        item = q.get()
        if item is None:
            break
        plan, db = item
        if decode_cfg.decode_style == "beam_search":
            raw = decoder.beam_batch_raw(db)
            steps.append(raw.n_steps)
            for qa_id, res in zip(plan.qa_ids,
                                  decoder.beam_results(raw, db.valid)):
                nbest[qa_id] = res.texts(vlist, vocab["<eos>"])
                answers[qa_id] = detokenize(res.tokens[0], vlist,
                                            vocab["<eos>"])
                scores[qa_id] = res.scores[0]
        else:
            for qa_id, row in zip(plan.qa_ids, decoder.greedy_batch(db)):
                answers[qa_id] = " ".join(vlist[t] for t in row)
                scores[qa_id] = 0.0
        if t_first is None:
            t_first = time.time()
    producer.join()
    if err:
        raise err[0]
    wall = time.time() - t0

    result_dialogs = []
    qa_id = 0
    undisclosed = decode_cfg.undisclosed_only
    for idx, dialog in enumerate(dataset.original["dialogs"]):
        vid = dialog["image_id"]
        out_dialog = dialog["dialog"][-1:] if undisclosed \
            else dialog["dialog"]
        if undisclosed and ref_data is not None and \
                ref_data["dialogs"][idx]["image_id"] != vid:
            raise ValueError(f"labeled test set disagrees at dialog {idx}")
        pred = {"image_id": vid, "dialog": copy.deepcopy(out_dialog)}
        result_dialogs.append(pred)
        for t, qa in enumerate(out_dialog):
            if undisclosed and qa["answer"] != "__UNDISCLOSED__":
                raise ValueError(f"{vid} turn {t}: answer is disclosed")
            if log_hyps:
                log.info("%d %s_%d", qa_id, vid, t)
                log.info("QS: %s", qa["question"])
                for ni, (hyp, sc) in enumerate(
                        nbest.get(qa_id, [(answers[qa_id], scores[qa_id])])):
                    log.info("HYP[%d]: %s  ( %f )", ni + 1, hyp, sc)
            pred["dialog"][t]["answer"] = answers[qa_id]
            qa_id += 1
    stats = {
        "turns": n, "batches": len(plans), "seconds": wall,
        "responses_per_sec": n / max(wall, 1e-9),
        "first_batch_seconds": (t_first - t0) if t_first else None,
        "mean_exit_step": (sum(steps) / len(steps)) if steps else None,
        "device": str(device),
    }
    log.info("decoded %d turns in %.2fs (%.2f responses/sec); mean beam "
             "exit step %s", n, wall, stats["responses_per_sec"],
             stats["mean_exit_step"])
    return {"dialogs": result_dialogs}, stats


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mtn_tpu_torch.cli.common import (check_unported, print_args,
                                          resolve_device, setup_logging)
    setup_logging(args.verbose)
    print_args(args)
    device = resolve_device(args.device)
    check_unported(args)
    import torch
    from mtn_tpu_torch.config import DecodeConfig, config_from_dict
    from mtn_tpu_torch.data.dataset import load
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
    log.info("#vocab = %d", len(vocab))

    log.info("Loading test data from %s", args.test_set)
    fea_type = data_cfg.fea_type if data_cfg.fea_type and \
        data_cfg.fea_type[0] != "none" else None
    test_data = load(fea_type, args.test_path, args.test_set, vocab,
                     include_caption=data_cfg.include_caption,
                     separate_caption=data_cfg.separate_caption,
                     max_history_length=data_cfg.max_history_length,
                     merge_source=data_cfg.merge_source,
                     undisclosed_only=bool(args.undisclosed_only))
    log.info("#test sample = %d", len(test_data))

    state_dict, used_epoch = load_checkpoint(prefix, epoch)
    model = load_model(model_cfg, state_dict, device)
    log.info("Restored checkpoint epoch %s on %s", used_epoch, device)

    decode_cfg = DecodeConfig(
        maxlen=args.maxlen, beam=args.beam, penalty=args.penalty,
        nbest=args.nbest, decode_style=args.decode_style,
        undisclosed_only=bool(args.undisclosed_only),
        labeled_test=args.labeled_test, turn_batch=args.turn_batch,
        uniform_shapes=bool(args.uniform_shapes),
        feature_transfer=args.feature_transfer,
        early_stop=bool(args.early_stop),
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        sample_seed=args.sample_seed)
    ref_data = None
    if args.undisclosed_only and args.labeled_test:
        with open(args.labeled_test) as f:
            ref_data = json.load(f)
    log.info("--------------------generate--------------------")
    result, stats = generate_responses(
        model, test_data, decode_cfg, data_cfg, vocab, device,
        feature_dtype=args.feature_transfer or model_cfg.dtype,
        ref_data=ref_data, log_hyps=args.verbose >= 1)
    if args.output:
        log.info("writing results to %s", args.output)
        with open(args.output, "w") as f:
            json.dump(result, f, indent=4)
    if args.stats_output:
        with open(args.stats_output, "w") as f:
            json.dump(stats, f, indent=2)
    log.info("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
