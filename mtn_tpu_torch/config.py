"""Configuration dataclasses: the port's own copy of ``mtn_tpu/config.py``.

Same sections, field names, defaults and JSON schema as the JAX package,
so a ``<prefix>.conf.json`` written by ``mtn_tpu`` training loads here
unchanged and one config drives both packages. ``use_pallas_attention``
and ``use_pallas_ffn`` keep their names: in this package they select the
hand-written Hopper kernels (``mtn_tpu_torch/csrc``). ``scan_unroll``
has no meaning in eager PyTorch and is kept for the schema.

``ModelConfig.architecture`` names the model a config builds: ``"mtn"``
(the default, so every config written before it loads as MTN) or
``"kimi_vl"``, Kimi-VL-A3B's language model as a video-grounded answer
decoder (:mod:`mtn_tpu_torch.models.kimi_lm`), whose published keys live
in ``ModelConfig.lm`` under their ``config.json`` names
(:class:`LMConfig`). That architecture decodes through
``cli.generate`` on one device; the other paths refuse it
(:func:`require_mtn`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

ARCHITECTURES = ("mtn", "kimi_vl")


@dataclass
class ModelConfig:
    """Architecture of the MTN encoder-decoder."""

    vocab_size: int = 0
    nb_blocks: int = 6            # N transformer decoder blocks
    d_model: int = 512
    d_ff: int = 2048
    att_h: int = 8
    dropout: float = 0.1
    attn_dropout: float = 0.1     # attention-probability dropout
    ft_sizes: List[int] = field(default_factory=list)  # per-stream feature dims
    separate_his_embed: bool = False
    separate_cap_embed: bool = False
    diff_encoder: bool = False    # per-stream AE norms in the text encoder
    diff_embed: bool = False      # per-stream AE embeddings
    diff_gen: bool = False        # per-stream AE generators
    auto_encoder_ft: Optional[str] = None  # 'query' | 'caption' | 'summary'
    dtype: str = "float32"        # compute dtype: 'float32' | 'bfloat16'
    param_dtype: str = "float32"
    max_len: int = 5000           # positional-encoding table length
    # the fused attention and FFN kernels (off by default, as in mtn_tpu)
    use_pallas_attention: bool = False
    use_pallas_ffn: bool = False
    # decode-time self-attention q/k/v as one (D, 3D) product
    fused_decode_qkv: bool = False
    batched_ae: bool = False      # the S AE chains as one stacked chain
    remat: bool = False           # recompute decoder layers in backward
    architecture: str = "mtn"     # one of ARCHITECTURES
    # "kimi_vl": the language model's keys by their config.json names
    # (LMConfig's fields); ft_sizes are its feature projectors' inputs
    lm: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_streams(self) -> int:
        return len(self.ft_sizes)


@dataclass
class LMConfig:
    """The language model of ``ModelConfig.architecture == "kimi_vl"``,
    each key named as in Kimi-VL-A3B-Instruct's ``config.json``
    (``text_config``, a DeepSeek-V3 decoder); the defaults are its
    published values. ``projector_hidden_size`` is the feature
    projectors' inner width (``Linear(ft, p) -> GELU -> Linear(p,
    hidden_size)``); the published projector reads MoonViT's output,
    which DSTC7-AVSD does not ship."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    rope_scaling: Optional[dict] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    projector_hidden_size: int = 2048

    @classmethod
    def of(cls, cfg: ModelConfig) -> "LMConfig":
        """The ``lm`` section of ``cfg``; keys this port does not build
        with (``max_position_embeddings``, ``ep_size``, ...) are kept in
        the config file and ignored here, and what it cannot build
        raises."""
        names = {f.name for f in dataclasses.fields(cls)}
        lm = cls(**{k: v for k, v in cfg.lm.items() if k in names})
        fixed = dict(q_lora_rank=None, topk_method="noaux_tc",
                     scoring_func="sigmoid", hidden_act="silu",
                     rope_scaling=None, attention_bias=False,
                     tie_word_embeddings=False, moe_layer_freq=1)
        for k, v in fixed.items():
            if getattr(lm, k) != v:
                raise NotImplementedError(f"lm.{k}={getattr(lm, k)!r}: "
                                          f"this port builds {v!r} only")
        if lm.n_group != 1 or lm.topk_group != 1:
            raise NotImplementedError("lm.n_group / lm.topk_group: "
                                      "grouped routing is not built")
        return lm


def architecture(cfg) -> str:
    """The architecture ``cfg`` names; a config without the field (the
    JAX package's ``ModelConfig``) is MTN's."""
    return getattr(cfg, "architecture", "mtn")


def require_mtn(cfg, what: str) -> None:
    """Raise for a path that runs MTN alone (training, serving, AOT,
    meshes, int8, rank) when ``cfg`` names another architecture."""
    if architecture(cfg) != "mtn":
        raise NotImplementedError(
            f"{what} runs the MTN architecture only; {architecture(cfg)!r} "
            "decodes on one device through mtn_tpu_torch.cli.generate")


@dataclass
class DataConfig:
    """Input pipeline."""

    fea_type: List[str] = field(default_factory=list)  # e.g. ['vggish','i3d_flow']
    train_path: str = ""          # '<FeaType>/<ImageID>.npy' template
    train_set: str = ""
    valid_path: str = ""
    valid_set: str = ""
    include_caption: str = "none"  # 'none'|'caption'|'summary'|'caption,summary'
    separate_caption: bool = False
    max_history_length: int = -1
    merge_source: bool = False
    batch_size: int = 32
    max_length: int = 256          # batch-size shrink gate
    cut_a: bool = False            # random answer truncation
    cut_a_p: float = 0.5
    skip: List[int] = field(default_factory=lambda: [1, 1, 1])  # frame skip per stream
    vocab_cutoff: int = 5
    length_bucket: int = 32        # round text lengths up to multiples of this
    feature_bucket: int = 32       # round video-frame counts up to multiples
    pad_batch_to_full: bool = True # pad batch dim to `batch_size` with masked rows
    prefetch: int = 2
    use_native_loader: bool = True # C++ .npy reader (csrc/npy_loader.cc)
    feature_dtype: str = "float32"


@dataclass
class TrainConfig:
    """Optimization."""

    num_epochs: int = 15
    batch_size: int = 32
    warmup_steps: int = 4000
    loss_l: float = 1.0
    rand_seed: int = 1
    report_interval: int = 100
    label_smoothing: float = 0.1
    model: str = ""
    save_optimizer_state: bool = True
    keep_checkpoints: int = 0
    accum_steps: int = 1
    grad_clip: float = 0.0
    patience: int = 0


@dataclass
class DecodeConfig:
    """Generation."""

    maxlen: int = 30
    beam: int = 5
    penalty: float = 1.0
    nbest: int = 5
    min_len: int = 1
    decode_style: str = "beam_search"  # 'beam_search'|'greedy'|'sample'
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    sample_seed: int = 1
    undisclosed_only: bool = False
    labeled_test: Optional[str] = None
    turn_batch: int = 16          # dialogue turns per device batch
    # pad every decode batch to the test set's (bucket-rounded) maxima
    uniform_shapes: bool = True
    feature_transfer: str = ""    # '' (compute dtype) | 'bfloat16' | 'int8'
    scan_unroll: int = 1          # no meaning in eager PyTorch; schema only
    # stop the beam loop once no live hypothesis can enter any n-best
    # (output-identical to the full maxlen loop)
    early_stop: bool = True


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    return obj


def dump_config(path: str, **sections: Any) -> None:
    """Write named config sections (+ arbitrary metadata) as JSON."""
    payload = {name: _to_jsonable(cfg) for name, cfg in sections.items()}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


_SECTION_TYPES = {
    "model": ModelConfig,
    "data": DataConfig,
    "train": TrainConfig,
    "decode": DecodeConfig,
}


def config_from_dict(section: str, d: dict):
    cls = _SECTION_TYPES[section]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})
