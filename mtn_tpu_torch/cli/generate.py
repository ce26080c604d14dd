"""Generation entry point (``mtn_tpu/cli/generate.py``; run.sh stage 3).

    python -m mtn_tpu_torch.cli.generate --model exps/x/mtn_best \\
        --test-path 'data/<FeaType>/<ImageID>.npy' --test-set test.json \\
        --decode-style beam_search --beam 5 --turn-batch 32 \\
        --use-pallas-attention 1 --use-pallas-ffn 1 --output result.json

Turns are grouped into length-sorted batches and beam-decoded (or greedy,
or sampled: ``--decode-style sample`` with ``--temperature``, ``--top-k``,
``--top-p`` and ``--sample-seed``) on one device, with full-precision or
(``--weights-quant``) int8 weights; the result JSON has the
format of ``mtn_tpu.cli.generate`` and is scored by ``python -m
mtn_tpu_torch.cli.evaluate`` (run.sh stage 4). The checkpoint is the
port's format (``mtn_tpu_torch/weights.py``; a JAX checkpoint enters it
through ``mtn_tpu_torch.utils.import_flax``). A producer thread builds and
uploads the next batches while the device decodes. In beam mode up to
``MAX_IN_FLIGHT`` batches are launched before the oldest is fetched, as
in JAX: a graphed batch is one launch that reads nothing on the host, so
the device decodes the queued batches back to back while the host
converts the finished ones; greedy and sample batches run one at a time.
The run logs the hand-written kernels' launches (0 on the CPU). A
checkpoint whose config names ``architecture: kimi_vl`` decodes the same
way (Kimi-VL-A3B's language model, :mod:`mtn_tpu_torch.models.kimi_lm`),
on one device and with full-precision weights. With
``--profile-dir DIR`` it records the pass's spans
(:func:`mtn_tpu_torch.utils.profiling.recording`) and writes them, with
the device spans on a ``cuda:0`` track, as the Chrome trace
``DIR/decode_spans_<pid>.json``.

Under ``--multihost`` (``auto`` for ``torchrun``, or
``host:port,nprocs,procid``) every rank runs this command: the turn
batches are cut over the ``data`` ranks (``--mesh-data``), the model over
the ``model`` ranks (``--mesh-model``), the results are gathered, and
rank 0 writes the output.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import logging
import queue
import threading
import time

from mtn_tpu_torch.utils import profiling

log = logging.getLogger(__name__)

MAX_IN_FLIGHT = 8   # beam batches launched before the oldest is fetched


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
                        help="'int8': decode with weight-only int8 kernels "
                             "(per-channel scales, mtn_tpu_torch/utils/"
                             "quantize.py); 'int8-fp-head' keeps the vocab "
                             "head full precision; default full precision")
    parser.add_argument("--multihost", default="", type=str,
                        help="'auto' (torchrun's environment) or "
                             "'host:port,nprocs,procid': join a multi-"
                             "process run; turn batches shard over the "
                             "data ranks, results are gathered, rank 0 "
                             "writes (mtn_tpu_torch/parallel/multihost.py)")
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
                       log_hyps=True, shardings=None):
    """Decode every turn; returns ``(result, stats)``: the reference-format
    result dict (deep-copied dialogs with the 1-best hypothesis in place of
    each answer) and a dict of decode statistics. With ``shardings`` each
    rank decodes its rows of every batch and every rank gets the whole
    result. Up to ``MAX_IN_FLIGHT`` beam batches are launched before the
    oldest is fetched; the result does not depend on it.

    Under :func:`mtn_tpu_torch.utils.profiling.recording` the pass records
    its spans (``decode.pass``, whose counters are the pass's; ``.plan``,
    the producer's ``.make_batch`` and ``.upload``, ``.queue_wait``,
    ``.launch``, ``.fetch``, ``.results``; the decoder's below them) and
    device spans, each batch's under its index, and resolves the device
    spans once every batch has been fetched (the root's last child,
    ``profiler.resolve``). A model with routed experts adds its routing
    counters to the root's (:func:`routing_counters`), read once a
    pass."""
    rec = profiling.active()
    with profiling.span("decode.pass") as root:
        if rec is not None:
            rec.anchor(device)
            before = _pass_counters()
            rows = _expert_rows(model)
        result, stats, steps, graphs = _decode_pass(
            root, model, dataset, decode_cfg, data_cfg, vocab, device,
            feature_dtype, ref_data, log_hyps, shardings)
        if rec is not None:
            after = _pass_counters()
            root.count(turns=stats["turns"], batches=stats["batches"],
                       eager_batches=graphs.eager, captures=graphs.captures,
                       evictions=graphs.evictions, exit_steps=steps,
                       **{k: after[k] - before[k] for k in after})
            if rows is not None:
                root.count(**routing_counters(_expert_rows(model) - rows,
                                              model.lm.num_experts_per_tok))
            with profiling.span("profiler.resolve"):
                rec.resolve()
    return result, stats


def _expert_rows(model):
    """A routed model's (layers, E) rows taken by each expert so far, on
    the host (None for a model without experts)."""
    rows = getattr(model, "expert_rows", None)
    return None if rows is None else rows.to("cpu", copy=True)


def routing_counters(rows, top_k: int) -> dict:
    """A pass's routing counters from its (layers, E) expert rows:
    ``moe_tokens``, the real tokens dispatched, summed over the MoE
    layers (each token takes ``top_k`` rows of a layer), and
    ``moe_expert_rows_max_over_mean``, the busiest expert's rows over the
    mean expert's, averaged over the layers (1 is even routing)."""
    total = rows.sum(1).double()
    if not float(total.sum()):
        return {"moe_tokens": 0}
    imbalance = rows.max(1).values.double() / (total / rows.shape[1])
    return {"moe_tokens": int(total.sum()) // top_k,
            "moe_expert_rows_max_over_mean": float(imbalance.mean())}


def _pass_counters() -> dict:
    """The process's graph launches and hand-written kernel launches."""
    from mtn_tpu_torch.cli.common import kernel_launches
    from mtn_tpu_torch.ops import graph_loop
    return {"graph_launches": graph_loop.LAUNCHES,
            "kernel_launches": sum(kernel_launches().values())}


def _decode_pass(root, model, dataset, decode_cfg, data_cfg, vocab, device,
                 feature_dtype, ref_data, log_hyps, shardings):
    """:func:`generate_responses`' pass: (result, stats, each batch's exit
    step, the decoder's program cache)."""
    from mtn_tpu_torch.data.batching import (make_batch, make_batch_indices,
                                             uniform_plans)
    from mtn_tpu_torch.data.vocab import vocab_list
    from mtn_tpu_torch.decode.beam import BeamDecoder, detokenize
    from mtn_tpu_torch.train.batch import to_device_fn

    span = profiling.span
    vlist = vocab_list(vocab)
    decoder = BeamDecoder(model, decode_cfg, shardings=shardings)
    to_device = to_device_fn(feature_dtype, shardings, device)
    with span("decode.plan"):
        plans, n = make_batch_indices(
            dataset, batchsize=decode_cfg.turn_batch, max_length=10 ** 9,
            separate_caption=data_cfg.separate_caption)
        if decode_cfg.uniform_shapes and plans:
            plans = uniform_plans(plans)
    answers, scores, nbest = {}, {}, {}
    steps = []
    q: "queue.Queue" = queue.Queue(maxsize=3)
    err = []

    def produce():
        try:
            for bi, plan in enumerate(plans):
                with span("decode.make_batch", bi, root):
                    hb = make_batch(
                        dataset, plan,
                        separate_caption=data_cfg.separate_caption,
                        skip=data_cfg.skip,
                        length_bucket=data_cfg.length_bucket,
                        feature_bucket=data_cfg.feature_bucket,
                        pad_rows_to=decode_cfg.turn_batch)
                with span("decode.upload", bi, root):
                    db = to_device(hb)
                q.put((plan, db))
        except BaseException as e:  # re-raised by the consumer below
            err.append(e)
        finally:
            q.put(None)

    t0 = time.perf_counter()
    t_first = None
    in_flight: list = []

    def drain_one():
        nonlocal t_first
        bi, plan, raw, valid = in_flight.pop(0)
        with span("decode.fetch", bi):
            results = decoder.beam_results(raw, valid)  # waits for it
        steps.append(raw.n_steps)
        if t_first is None:
            t_first = time.perf_counter()
        for qa_id, res in zip(plan.qa_ids, results):
            nbest[qa_id] = res.texts(vlist, vocab["<eos>"])
            answers[qa_id] = detokenize(res.tokens[0], vlist,
                                        vocab["<eos>"])
            scores[qa_id] = res.scores[0]

    producer = threading.Thread(target=produce, name="decode-producer",
                                daemon=True)
    producer.start()
    bi = 0
    while True:
        with span("decode.queue_wait", bi):
            item = q.get()
        if item is None:
            break
        plan, db = item
        if decode_cfg.decode_style == "beam_search":
            with span("decode.launch", bi):
                in_flight.append((bi, plan, decoder.beam_batch_raw(db),
                                  decoder.gather_rows(db.valid)))
            if len(in_flight) >= MAX_IN_FLIGHT:
                drain_one()
            bi += 1
            continue
        # the plan index folds into the sampler's noise, as in JAX
        with span("decode.launch", bi):
            rows = (decoder.sample_batch(db, fold=bi)
                    if decode_cfg.decode_style == "sample"
                    else decoder.greedy_batch(db))
        for qa_id, row in zip(plan.qa_ids, rows):
            answers[qa_id] = " ".join(vlist[t] for t in row)
            scores[qa_id] = 0.0
        if t_first is None:
            t_first = time.perf_counter()
        bi += 1
    while in_flight:
        drain_one()
    producer.join()
    if err:
        raise err[0]
    wall = time.perf_counter() - t0
    if decode_cfg.decode_style == "beam_search" and t_first is not None:
        steady = time.perf_counter() - t_first
        log.info("first batch (run eagerly) after %.1fs; steady-state "
                 "%.2f responses/sec", t_first - t0,
                 max(n - decode_cfg.turn_batch, 0) / max(steady, 1e-9))

    result_dialogs = []
    qa_id = 0
    undisclosed = decode_cfg.undisclosed_only
    with span("decode.results"):
        for idx, dialog in enumerate(dataset.original["dialogs"]):
            vid = dialog["image_id"]
            out_dialog = dialog["dialog"][-1:] if undisclosed \
                else dialog["dialog"]
            if undisclosed and ref_data is not None and \
                    ref_data["dialogs"][idx]["image_id"] != vid:
                raise ValueError(
                    f"labeled test set disagrees at dialog {idx}")
            pred = {"image_id": vid, "dialog": copy.deepcopy(out_dialog)}
            result_dialogs.append(pred)
            for t, qa in enumerate(out_dialog):
                if undisclosed and qa["answer"] != "__UNDISCLOSED__":
                    raise ValueError(f"{vid} turn {t}: answer is disclosed")
                if log_hyps:
                    log.info("%d %s_%d", qa_id, vid, t)
                    log.info("QS: %s", qa["question"])
                    for ni, (hyp, sc) in enumerate(nbest.get(
                            qa_id, [(answers[qa_id], scores[qa_id])])):
                        log.info("HYP[%d]: %s  ( %f )", ni + 1, hyp, sc)
                pred["dialog"][t]["answer"] = answers[qa_id]
                qa_id += 1
    graphs = decoder.graphs
    stats = {
        "turns": n, "batches": len(plans), "seconds": wall,
        "responses_per_sec": n / max(wall, 1e-9),
        "first_batch_seconds": (t_first - t0) if t_first else None,
        "mean_exit_step": (sum(steps) / len(steps)) if steps else None,
        "captures": graphs.captures, "eager_batches": graphs.eager,
        "device": str(device),
    }
    log.info("decoded %d turns in %.2fs (%.2f responses/sec); mean beam "
             "exit step %s", n, wall, stats["responses_per_sec"],
             stats["mean_exit_step"])
    return {"dialogs": result_dialogs}, stats, steps, graphs


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mtn_tpu_torch.cli.common import (init_parallel, kernel_launches,
                                          print_args, setup_logging)
    setup_logging(args.verbose)
    print_args(args)
    device, shardings = init_parallel(args, args.turn_batch)
    import torch
    from mtn_tpu_torch.config import (DecodeConfig, config_from_dict,
                                      require_mtn)
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

    # before the weights load: int8 and meshes run MTN alone
    if args.weights_quant:
        require_mtn(model_cfg, "--weights-quant (int8 weights)")
    if shardings is not None:
        require_mtn(model_cfg, "a mesh (--multihost, --mesh-*)")
    state_dict, used_epoch = load_checkpoint(prefix, epoch)
    model = load_model(model_cfg, state_dict, device)
    log.info("Restored checkpoint epoch %s on %s", used_epoch, device)
    if args.weights_quant:
        from mtn_tpu_torch.utils.quantize import quantize_model
        log.info("quantizing decode weights: %s", args.weights_quant)
        quantize_model(model, state_dict,
                       skip_generator=args.weights_quant == "int8-fp-head")
    if shardings is not None:
        # each rank keeps its slabs (replicated under pure data
        # parallelism); int8 scales follow their kernels' output axis
        shardings.shard_model(model)

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
    with (profiling.recording() if args.profile_dir
          else contextlib.nullcontext()) as rec:
        result, stats = generate_responses(
            model, test_data, decode_cfg, data_cfg, vocab, device,
            feature_dtype=args.feature_transfer or model_cfg.dtype,
            ref_data=ref_data, log_hyps=args.verbose >= 1,
            shardings=shardings)
    if rec is not None:
        log.info("decode spans written to %s", rec.write_chrome_trace(
            args.profile_dir, "decode_spans"))
    log.info("kernel launches: %s", json.dumps(kernel_launches()))
    from mtn_tpu_torch.parallel.multihost import is_primary, shutdown
    # every rank holds the whole (gathered) result; rank 0 writes it
    if args.output and is_primary():
        log.info("writing results to %s", args.output)
        with open(args.output, "w") as f:
            json.dump(result, f, indent=4)
    if args.stats_output and is_primary():
        with open(args.stats_output, "w") as f:
            json.dump(stats, f, indent=2)
    log.info("done")
    shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
