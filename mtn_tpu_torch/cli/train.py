"""Training entry point (``mtn_tpu/cli/train.py``; run.sh stage 2).

    python -m mtn_tpu_torch.cli.train --fea-type i3d_rgb vggish \\
        --train-path 'data/<FeaType>/<ImageID>.npy' --train-set train.json \\
        --valid-path 'data/<FeaType>/<ImageID>.npy' --valid-set valid.json \\
        --include-caption caption,summary --separate-caption 1 \\
        --model exps/x/mtn --num-epochs 20 --warmup-steps 9660 \\
        --use-pallas-attention 1 --use-pallas-ffn 1

Same flags as the JAX CLI, plus ``--device`` (default ``cuda``; without a
GPU it raises unless ``--device cpu`` is given). Each epoch trains over
the shuffled batches, validates, and saves a checkpoint that
``python -m mtn_tpu_torch.cli.generate`` decodes; the logs are the JAX
CLI's CSV files and lines. ``--feature-cache DIR`` serves each batch's
feature blocks from a write-once cache after their first read,
``--async-save 1`` writes checkpoints on a background thread,
``--profile-dir DIR`` writes a ``torch.profiler`` trace of the run and
``--nan-checks 1`` raises at the first step whose loss or gradients are
not finite. Under ``--multihost`` every rank runs this command: each
batch's rows are cut over the ``data`` ranks, the model over the
``model`` ranks, and rank 0 alone writes the logs, the sidecars and the
checkpoints (full tensors, loadable on one device).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    from mtn_tpu_torch.cli.common import add_device_args, add_logging_args
    parser = argparse.ArgumentParser(description="Train MTN")
    parser.add_argument("--gpu", "-g", default=0, type=int,
                        help="accepted for run.sh parity; see --device")
    parser.add_argument("--fea-type", nargs="+", type=str,
                        help="feature stream names (or 'none')")
    parser.add_argument("--train-path", default="", type=str)
    parser.add_argument("--train-set", default="", type=str)
    parser.add_argument("--valid-path", default="", type=str)
    parser.add_argument("--valid-set", default="", type=str)
    parser.add_argument("--include-caption", default="none", type=str)
    parser.add_argument("--separate-caption", default=0, type=int)
    parser.add_argument("--cut-a", default=0, type=int)
    parser.add_argument("--merge-source", default=0, type=int)
    parser.add_argument("--exclude-video", action="store_true")
    parser.add_argument("--fixed-word-emb", default=0, type=int,
                        help="accepted for parity; unused (as in reference)")
    parser.add_argument("--model", default=None, type=str,
                        help="output prefix for checkpoints/logs")
    parser.add_argument("--nb-blocks", default=6, type=int)
    parser.add_argument("--d-model", default=512, type=int)
    parser.add_argument("--d-ff", default=2048, type=int)
    parser.add_argument("--att-h", default=8, type=int)
    parser.add_argument("--dropout", default=0.1, type=float)
    parser.add_argument("--attn-dropout", default=0.1, type=float,
                        help="attention-probability dropout, independent "
                             "of --dropout")
    parser.add_argument("--separate-his-embed", default=0, type=int)
    parser.add_argument("--separate-cap-embed", default=0, type=int)
    parser.add_argument("--diff-encoder", default=0, type=int)
    parser.add_argument("--diff-embed", default=0, type=int)
    parser.add_argument("--diff-gen", default=0, type=int)
    parser.add_argument("--auto-encoder-ft", default=None, type=str)
    parser.add_argument("--num-epochs", "-e", default=15, type=int)
    parser.add_argument("--rand-seed", "-s", default=1, type=int)
    parser.add_argument("--batch-size", "-b", default=32, type=int)
    parser.add_argument("--max-length", default=20, type=int)
    parser.add_argument("--max-history-length", default=-1, type=int)
    parser.add_argument("--report-interval", default=100, type=int)
    parser.add_argument("--warmup-steps", default=4000, type=int)
    parser.add_argument("--loss-l", default=1.0, type=float)
    parser.add_argument("--vocab-cutoff", default=5, type=int,
                        help="keep words with freq > cutoff")
    parser.add_argument("--resume", default=None, type=str,
                        help="resume from checkpoint: 'latest'|'best'|epoch|"
                             "'auto' (latest if one exists, else fresh)|"
                             "'step' (the mid-epoch slot)")
    parser.add_argument("--keep-checkpoints", default=0, type=int)
    parser.add_argument("--checkpoint-every-steps", default=0, type=int,
                        help="also save a rotating step checkpoint every N "
                             "train steps (resume with --resume step)")
    parser.add_argument("--feature-cache", default="", type=str,
                        help="directory of a write-once cache of padded "
                             "feature blocks in the transfer dtype "
                             "(epoch 1 fills it, later epochs read it)")
    parser.add_argument("--async-save", default=0, type=int,
                        help="write checkpoints on a background thread; "
                             "the meta commit waits for the next "
                             "checkpoint operation or the end of the run")
    parser.add_argument("--remat", default=0, type=int,
                        help="recompute decoder layers in the backward "
                             "(torch.utils.checkpoint)")
    parser.add_argument("--batched-ae", default=0, type=int,
                        help="run the per-stream AE chains as one stacked "
                             "chain (same parameters and checkpoints)")
    parser.add_argument("--accum-steps", default=1, type=int,
                        help="gradient accumulation: one optimizer update "
                             "per N batches (requires --uniform-shapes 1)")
    parser.add_argument("--grad-clip", default=0.0, type=float,
                        help="> 0: clip gradients to this global L2 norm "
                             "before Adam")
    parser.add_argument("--patience", default=0, type=int,
                        help="> 0: stop after this many epochs without a "
                             "new best validation loss")
    parser.add_argument("--uniform-shapes", default=0, type=int,
                        help="pad every batch to the dataset's global "
                             "maxima")
    parser.add_argument("--multihost", default="", type=str,
                        help="'auto' (torchrun's environment) or "
                             "'host:port,nprocs,procid': join a multi-"
                             "process run; each rank uploads its data-"
                             "parallel rows of every batch "
                             "(mtn_tpu_torch/parallel/multihost.py)")
    add_device_args(parser)
    add_logging_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mtn_tpu_torch.cli.common import (init_parallel, print_args,
                                          setup_logging)
    setup_logging(args.verbose)
    print_args(args)
    device, shardings = init_parallel(args, args.batch_size)
    import torch
    from mtn_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from mtn_tpu_torch.data.batching import make_batch_indices, uniform_plans
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.data.pipeline import BatchIterator, shuffled
    from mtn_tpu_torch.data.vocab import get_vocabulary
    from mtn_tpu_torch.parallel.multihost import is_primary, shutdown
    from mtn_tpu_torch.train.batch import accumulated, to_device_fn
    from mtn_tpu_torch.train.trainer import EarlyStopper, Trainer
    from mtn_tpu_torch.utils import profiling
    from mtn_tpu_torch.utils.checkpoint import CheckpointManager
    from mtn_tpu_torch.utils.logging import TraceLogger, dump_params_txt

    if args.dtype == "float32":
        # full f32 products (no TF32), as the JAX CLI asks for "highest"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    log.info("Extracting words from %s", args.train_set)
    vocab = get_vocabulary(args.train_set, cutoff=args.vocab_cutoff,
                           include_caption=args.include_caption)
    log.info("#vocab = %d", len(vocab))
    fea_type = None if (args.exclude_video or not args.fea_type) \
        else args.fea_type
    common = dict(include_caption=args.include_caption,
                  separate_caption=bool(args.separate_caption),
                  max_history_length=args.max_history_length,
                  merge_source=bool(args.merge_source))
    log.info("Loading training data from %s", args.train_set)
    train_data = load(fea_type, args.train_path, args.train_set, vocab,
                      **common)
    log.info("Loading validation data from %s", args.valid_set)
    valid_data = load(fea_type, args.valid_path, args.valid_set, vocab,
                      **common)
    feature_dims = train_data.feature_dims()
    log.info("Detected feature dims: %s", feature_dims)
    train_plans, n_train = make_batch_indices(
        train_data, args.batch_size, max_length=args.max_length,
        separate_caption=bool(args.separate_caption))
    valid_plans, n_valid = make_batch_indices(
        valid_data, args.batch_size, max_length=args.max_length,
        separate_caption=bool(args.separate_caption))
    log.info("#train sample = %d  #train batch = %d", n_train,
             len(train_plans))
    log.info("#validation sample = %d  #validation batch = %d", n_valid,
             len(valid_plans))
    if args.uniform_shapes:
        both = uniform_plans(train_plans + valid_plans)
        train_plans, valid_plans = (both[:len(train_plans)],
                                    both[len(train_plans):])
        p = both[0]
        log.info("uniform shapes: h=%d q=%d a=%d c=%d x=%s", p.h_len,
                 p.q_len, p.a_len, p.c_len, p.x_len)

    model_cfg = ModelConfig(
        vocab_size=len(vocab), nb_blocks=args.nb_blocks,
        d_model=args.d_model, d_ff=args.d_ff, att_h=args.att_h,
        dropout=args.dropout, ft_sizes=feature_dims,
        separate_his_embed=bool(args.separate_his_embed),
        separate_cap_embed=bool(args.separate_cap_embed),
        diff_encoder=bool(args.diff_encoder),
        diff_embed=bool(args.diff_embed), diff_gen=bool(args.diff_gen),
        auto_encoder_ft=args.auto_encoder_ft, dtype=args.dtype,
        use_pallas_attention=bool(args.use_pallas_attention),
        use_pallas_ffn=bool(args.use_pallas_ffn),
        remat=bool(args.remat), attn_dropout=args.attn_dropout,
        batched_ae=bool(args.batched_ae))
    data_cfg = DataConfig(
        fea_type=(list(fea_type) if fea_type else []),
        train_path=args.train_path,
        train_set=args.train_set, valid_path=args.valid_path,
        valid_set=args.valid_set, include_caption=args.include_caption,
        separate_caption=bool(args.separate_caption),
        max_history_length=args.max_history_length,
        merge_source=bool(args.merge_source), batch_size=args.batch_size,
        max_length=args.max_length, cut_a=bool(args.cut_a),
        vocab_cutoff=args.vocab_cutoff, length_bucket=args.length_bucket,
        feature_bucket=args.feature_bucket, prefetch=args.prefetch,
        feature_dtype=args.feature_transfer or args.dtype)
    feature_cache = None
    if args.feature_cache:
        from mtn_tpu_torch.data.feature_cache import FeatureCache
        feature_cache = FeatureCache(args.feature_cache,
                                     transfer=data_cfg.feature_dtype)
        log.info("feature cache: %s (transfer %s)", args.feature_cache,
                 data_cfg.feature_dtype)
    if args.accum_steps > 1 and not args.uniform_shapes:
        raise SystemExit("--accum-steps > 1 requires --uniform-shapes 1 "
                         "(as in mtn_tpu, whose accumulation groups stack "
                         "equal-shape batches)")
    # run_epoch counts updates under accumulation: the batch-unit cadences
    # are divided by accum so they keep firing at about the same batches
    report_every = max(1, args.report_interval // args.accum_steps)
    ckpt_every = (max(1, args.checkpoint_every_steps // args.accum_steps)
                  if args.checkpoint_every_steps > 0 else 0)
    train_cfg = TrainConfig(
        num_epochs=args.num_epochs, batch_size=args.batch_size,
        warmup_steps=args.warmup_steps, loss_l=args.loss_l,
        rand_seed=args.rand_seed, report_interval=report_every,
        model=args.model, keep_checkpoints=args.keep_checkpoints,
        accum_steps=args.accum_steps, grad_clip=args.grad_clip,
        patience=args.patience)

    trainer = Trainer(model_cfg, train_cfg, device,
                      nan_checks=bool(args.nan_checks), shardings=shardings)
    primary = is_primary()
    os.makedirs(os.path.dirname(args.model) or ".", exist_ok=True)
    ckpt = CheckpointManager(args.model, async_save=bool(args.async_save),
                             layout=trainer.layout)
    ckpt.save_conf(vocab, model=model_cfg, data=data_cfg, train=train_cfg)
    if primary:
        dump_params_txt(args.model + "_params.txt", vars(args))
    logs = TraceLogger(args.model, resume=bool(args.resume),
                       primary=primary)
    log.info("Saving training results to %s", logs.train_csv.path)

    state = trainer.init_state(args.rand_seed)
    start_epoch = 0
    resume = args.resume
    if resume == "auto":
        resume = "latest" if ckpt.latest_epoch() is not None else None
    resume_batch = 0
    if resume == "step":
        state, ep, resume_batch = ckpt.restore_step(state)
        start_epoch = int(ep)
        log.info("Resumed step checkpoint (step %d): continuing epoch %d at "
                 "batch %d", state.step, start_epoch + 1, resume_batch)
    elif resume:
        state, ep = ckpt.restore(state, resume)
        start_epoch = int(ep)
        log.info("Resumed from epoch %d (step %d)", start_epoch, state.step)

    to_device = to_device_fn(data_cfg.feature_dtype, shardings, device)
    log.info("----------------")
    log.info("Start training")
    log.info("----------------")
    min_valid_loss = float("inf")
    bestmodel_num = 0
    stopper = EarlyStopper(args.patience)
    if resume:
        # carry best/patience across the restart (meta.json is the truth)
        stopper.seed_from_meta(ckpt.meta(), start_epoch)
        if stopper.best < min_valid_loss:
            min_valid_loss = stopper.best
            bestmodel_num = int(ckpt.meta().get("best_epoch") or 0)
    base_seed = args.rand_seed + 1
    with profiling.trace(args.profile_dir):
        for epoch in range(start_epoch, args.num_epochs):
            # the shuffle and the cut_a draws are keyed by (seed, epoch[,
            # batch]), so a --resume step run skips the consumed prefix and
            # repeats an uninterrupted run
            plans_ep = shuffled(train_plans,
                                np.random.default_rng([args.rand_seed, epoch]))
            start_b = resume_batch if epoch == start_epoch else 0
            it = BatchIterator(train_data, plans_ep[start_b:], data_cfg,
                               train=True, seed_key=(args.rand_seed, epoch),
                               start=start_b, transform=to_device,
                               feature_cache=feature_cache)
            accum = args.accum_steps
            if accum > 1:
                it = accumulated(it, accum, pad=trainer.pad)
            # logged step/batch indices stay in batch units under accumulation
            state, train_loss = trainer.run_epoch(
                state, it, base_seed, train=True,
                report_fn=lambda step, loss, tps, s0=start_b, a=accum: (
                    print("Epoch: %d Step: %d Loss: %f Tokens per Sec: %f"
                          % (epoch + 1, s0 + step * a, loss, tps)),
                    logs.train_step(epoch + 1, s0 + step * a, loss, tps)),
                step_callback=(lambda st, j, e=epoch, s0=start_b, a=accum:
                               ckpt.save_step(st, e, s0 + j * a)),
                step_callback_every=ckpt_every)
            log.info("epoch: %d  train loss: %f", epoch + 1, train_loss)
            log.info("-------validation--------")
            vit = BatchIterator(valid_data, valid_plans, data_cfg,
                                train=False, transform=to_device,
                                feature_cache=feature_cache)
            _, valid_loss = trainer.run_epoch(state, vit, train=False)
            log.info("epoch: %d validation loss: %f", epoch + 1, valid_loss)
            logs.epoch(epoch + 1, "train", train_loss)
            logs.epoch(epoch + 1, "val", valid_loss)
            ckpt.save(epoch + 1, state, val_loss=valid_loss,
                      keep=args.keep_checkpoints)
            if valid_loss < min_valid_loss:
                log.info("validation loss reduced %.4f -> %.4f",
                         min_valid_loss, valid_loss)
                min_valid_loss = valid_loss
                bestmodel_num = epoch + 1
            if stopper.update(valid_loss):
                log.info("early stopping: no validation improvement in %d "
                         "epochs (best %.4f at epoch %d)", args.patience,
                         min_valid_loss, bestmodel_num)
                log.info("----------------")
                break
            log.info("----------------")
    ckpt.flush()   # async: the last save durable and in meta.json
    log.info("the best model is epoch %d.", bestmodel_num)
    shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
