#!/bin/bash
# run.sh's stage driver on the PyTorch/CUDA port (mtn_tpu_torch):
#   run_torch.sh <stage> <fea_type> <fea_names> <num_epochs> <warmup_steps> <dropout>
# stages: <=1 preparation, <=2 training, <=3 generating, <=4 evaluating.
# The same positionals, variables, defaults and stage logic as run.sh;
# each stage runs the port's CLI (python -m mtn_tpu_torch.cli.train,
# .generate, .evaluate) with the flags run.sh passes to train.py,
# generate.py and mtn_tpu.cli.evaluate, plus --device to train and
# generate. Any variable below can be overridden Kaldi-style: --var value
# (utils/parse_options.sh semantics), options after the positionals.
# Run it from the repo root, as run.sh: utils/parse_options.sh, the
# package and stage 4's stopword file data/stopwords.txt (optional) are
# found relative to the working directory. On a machine without a GPU
# pass --device cpu.

stage=$1        # <=1: preparation <=2: training <=3: generating <=4: evaluating
fea_type=$2     # "vggish" OR "i3d_flow" OR "vggish i3d_flow" OR "none"
fea_names=$3    # vggish OR i3dflow OR vggish+i3dflow
num_epochs=$4   # e.g. 20
warmup_steps=$5 # e.g. 9660
dropout=$6      # e.g. 0.2

# data setting
batch_size=32
max_length=256
include_caption=caption,summary
sep_caption=1
max_his_len=-1
merge_source=0
decode_data=off
undisclosed_only=1
data_root=data
fea_dir=$data_root
fea_file="<FeaType>/<ImageID>.npy"

# model setting
sep_his_embed=0
sep_cap_embed=0
nb_blocks=6
d_model=512
d_ff=$(( d_model*4 ))
att_h=8
# auto-encoder setting
diff_encoder=1
diff_embed=0
diff_gen=0
auto_encoder_ft=query

# training setting
decode_style=beam_search
cut_a=1
loss_l=1
seed=1
model_prefix=mtn
expid=${fea_names}_warmup${warmup_steps}_epochs${num_epochs}_dropout${dropout}
expdir=exps/${expid}

# generation setting
beam=5
penalty=1.0
nbest=5
model_epoch=best
report_interval=100

# run.sh's accelerator settings, with the same names and defaults
dtype=bfloat16
mesh_data=-1
mesh_model=1
turn_batch=32
length_bucket=32
feature_bucket=32
use_pallas_attention=0  # 1: the hand-written attention kernel
                        # (mtn_tpu_torch/csrc/attention.cu)
use_pallas_ffn=0        # 1: the hand-written FFN kernel (csrc/ffn.cu)
feature_transfer=""     # ''|bfloat16|int8: host->device feature precision
feature_cache=""        # dir: write-once padded-feature-block disk cache
uniform_shapes_train=0  # 1: pad every train batch to the data's maxima
accum_steps=1           # >1: gradient accumulation (one optimizer update
                        # per N batches; requires uniform_shapes_train=1)
remat=1                 # 1: recompute decoder layers in the backward
batched_ae=0            # 1: per-stream QAE chains as one stacked chain
grad_clip=0.0           # >0: clip gradients to this global L2 norm
patience=0              # >0: early-stop after N epochs without a new
                        # best validation loss
async_save=0            # 1: checkpoint writes on a background thread
uniform_shapes_decode=1 # 1: pad decode batches to the test set's maxima
early_stop=1            # beam loop exits once n-bests provably fixed
temperature=1.0         # --decode_style sample knobs (sampling decoder)
top_k=0
top_p=0.0
sample_seed=1

# the port's device: the entry points run on the GPU unless told "cpu"
device=cuda

echo Stage $stage Exp ID $expid

workdir=`pwd`
train_set=$data_root/train_set4DSTC7-AVSD.json
valid_set=$data_root/valid_set4DSTC7-AVSD.json
test_set=$data_root/test_set.json
labeled_test=$data_root/test_set.json
eval_set=${labeled_test}
if [ "$decode_data" = "off" ]; then
  test_set=$data_root/test_set4DSTC7-AVSD.json
  labeled_test=$data_root/lbl_test_set4DSTC7-AVSD.json
  eval_set=${labeled_test}
  if [ $undisclosed_only -eq 1 ]; then
    eval_set=$data_root/lbl_undisclosedonly_test_set4DSTC7-AVSD.json
  fi
fi
echo Exp Directory $expdir

. utils/parse_options.sh || exit 1;

set -e
set -u
set -o pipefail

# preparation
if [ $stage -le 1 ]; then
    echo -------------------------
    echo stage 1: preparation
    echo -------------------------
    # the coco-caption metrics are built into mtn_tpu_torch.evalmetrics
    # (pure Python 3, no Java) — nothing to clone or patch.
    echo evaluation metrics: built-in \(mtn_tpu_torch.evalmetrics\)
    for f in $train_set $valid_set; do
        if [ ! -f "$f" ]; then
            echo "WARNING: missing data file $f (download DSTC7-AVSD data)"
        fi
    done
fi

# training phase
mkdir -p $expdir
if [ $stage -le 2 ]; then
    echo -------------------------
    echo stage 2: model training
    echo -------------------------
    python -m mtn_tpu_torch.cli.train \
      --fea-type $fea_type \
      --train-path "$fea_dir/$fea_file" \
      --train-set $train_set \
      --valid-path "$fea_dir/$fea_file" \
      --valid-set $valid_set \
      --num-epochs $num_epochs \
      --batch-size $batch_size \
      --max-length $max_length \
      --model $expdir/$model_prefix \
      --rand-seed $seed \
      --report-interval $report_interval \
      --nb-blocks $nb_blocks \
      --include-caption $include_caption \
      --max-history-length $max_his_len \
      --separate-his-embed $sep_his_embed \
      --separate-caption $sep_caption \
      --merge-source $merge_source \
      --separate-cap-embed $sep_cap_embed \
      --warmup-steps $warmup_steps \
      --d-model $d_model \
      --d-ff $d_ff \
      --att-h $att_h \
      --dropout $dropout \
      --cut-a $cut_a \
      --loss-l ${loss_l} \
      --diff-encoder ${diff_encoder} \
      --diff-embed ${diff_embed} \
      --auto-encoder-ft ${auto_encoder_ft} \
      --diff-gen ${diff_gen} \
      --dtype ${dtype} \
      --mesh-data ${mesh_data} \
      --mesh-model ${mesh_model} \
      --length-bucket ${length_bucket} \
      --feature-bucket ${feature_bucket} \
      --use-pallas-attention ${use_pallas_attention} \
      --use-pallas-ffn ${use_pallas_ffn} \
      --feature-transfer "${feature_transfer}" \
      --uniform-shapes ${uniform_shapes_train} \
      --accum-steps ${accum_steps} \
      --remat ${remat} \
      --batched-ae ${batched_ae} \
      --grad-clip ${grad_clip} \
      --patience ${patience} \
      --async-save ${async_save} \
      --feature-cache "${feature_cache}" \
      --device ${device}
fi

# testing phase
if [ $stage -le 3 ]; then
    echo -----------------------------
    echo stage 3: generate responses
    echo -----------------------------
    if [ "$decode_data" = "off" ]; then
        fea_file="<FeaType>_testset/<ImageID>.npy"
    fi
    for data_set in $test_set; do
        echo start response generation for $data_set
        target=$(basename ${data_set%.*})
        result=${expdir}/result_${target}_b${beam}_p${penalty}_${decode_style}_undisclosed${undisclosed_only}.json
        python -m mtn_tpu_torch.cli.generate \
          --test-path "$fea_dir/$fea_file" \
          --test-set $data_set \
          --model-conf $expdir/${model_prefix}.conf.json \
          --model $expdir/${model_prefix}_${model_epoch} \
          --beam $beam \
          --penalty $penalty \
          --nbest $nbest \
          --output $result \
          --decode-style ${decode_style} \
          --undisclosed-only ${undisclosed_only} \
          --labeled-test ${labeled_test} \
          --turn-batch ${turn_batch} \
          --dtype ${dtype} \
          --mesh-data ${mesh_data} \
          --mesh-model ${mesh_model} \
          --use-pallas-attention ${use_pallas_attention} \
          --use-pallas-ffn ${use_pallas_ffn} \
          --feature-transfer "${feature_transfer}" \
          --uniform-shapes ${uniform_shapes_decode} \
          --early-stop ${early_stop} \
          --temperature ${temperature} \
          --top-k ${top_k} \
          --top-p ${top_p} \
          --sample-seed ${sample_seed} \
          --device ${device}
    done
fi

# scoring
if [ $stage -le 4 ]; then
    echo --------------------------
    echo stage 4: score results
    echo --------------------------
    # The real DSTC7-AVSD download ships the undisclosed eval file under
    # the spelling "lbl_undiscloseonly_...", while the variables above
    # say "lbl_undisclosedonly_...": accept either, as run.sh does.
    if [ ! -f "$eval_set" ]; then
        alt_eval_set=${eval_set/lbl_undisclosedonly_/lbl_undiscloseonly_}
        if [ -f "$alt_eval_set" ]; then
            echo "eval set $eval_set not found; using shipped spelling $alt_eval_set"
            eval_set=$alt_eval_set
        fi
    fi
    for data_set in $eval_set; do
        echo start evaluation for $data_set
        save_target=$(basename ${test_set%.*})
        target=$(basename ${data_set%.*})
        result=${expdir}/result_${save_target}_b${beam}_p${penalty}_${decode_style}_undisclosed${undisclosed_only}.json
        reference=${result%.*}_ref.json
        hypothesis=${result%.*}_hyp.json
        result_eval=${result%.*}.eval
        echo Evaluating: $result
        python -m mtn_tpu_torch.cli.evaluate annotation -s data/stopwords.txt $data_set $reference
        python -m mtn_tpu_torch.cli.evaluate hypotheses -s data/stopwords.txt $result $hypothesis
        python -m mtn_tpu_torch.cli.evaluate score --json ${result_eval}.json \
            $reference $hypothesis > $result_eval
        echo Wrote details in $result_eval "(+ ${result_eval}.json)"
        echo "--- summary ---"
        awk '/^(Bleu_[1-4]|METEOR|ROUGE_L|CIDEr):/{print $0; if($1=="CIDEr:"){exit}}' \
            $result_eval
        echo "---------------"
    done
fi
