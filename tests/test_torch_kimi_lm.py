"""Kimi-VL-A3B's language model (``architecture: kimi_vl``) at a tiny size
on the CPU, on seeded random weights, against the plain reference
(``benchmark/reference/kimi_vl_lm_ref.py``): the prefill, every position
decoded through the latent cache, the absorbed step against the
decompressed form, the routed experts against a loop, the selection
bias, the beam's n-best scores; stage 3's CLI on a checkpoint of the
architecture, the paths that refuse it, and one benchmark run of the
language-model driver.

Tolerances. Program and reference both compute in float32 here, in
other orders (the step's absorbed products against the decompressed
ones, grouped rows against a loop, cached positions against one
sequence), so log-probabilities agree to float32's rounding of sums of
a few hundred terms through four layers: 1e-4 absolute (a product
computed in bfloat16 would be off by ~1e-2). Where the arithmetic is the
same, the comparison is bitwise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.reference.kimi_vl_lm_ref import KimiVLLMReference, param_spec
from mtn_tpu_torch.config import (DataConfig, DecodeConfig, LMConfig,
                                  ModelConfig, TrainConfig)
from mtn_tpu_torch.decode.beam import BeamDecoder
from mtn_tpu_torch.models.kimi_lm import rope
from mtn_tpu_torch.ops import moe
from mtn_tpu_torch.train.batch import DeviceBatch, batch_masks
from mtn_tpu_torch.weights import init_params, load_model, param_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
LM = dict(vocab_size=40, hidden_size=64, intermediate_size=96,
          moe_intermediate_size=32, num_hidden_layers=4,
          num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
          kv_lora_rank=32, qk_rope_head_dim=16, v_head_dim=16,
          qk_nope_head_dim=16, num_experts_per_tok=2,
          first_k_dense_replace=1, projector_hidden_size=48)
FT = [12, 8]
BLANK, SOS, EOS = 1, 2, 3


def model_cfg(vocab_size=LM["vocab_size"], ft=FT, **lm):
    return ModelConfig(vocab_size=vocab_size, ft_sizes=list(ft),
                       architecture="kimi_vl", dtype="float32",
                       lm=dict(LM, vocab_size=vocab_size, **lm))


def ref_cfg(cfg: ModelConfig) -> dict:
    return dict(vars(LMConfig.of(cfg)), ft_sizes=list(cfg.ft_sizes))


def seeded(cfg: ModelConfig, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, s in param_shapes(cfg).items():
        u = torch.rand(s, generator=g) * 2 - 1
        if k.endswith("norm.weight"):
            sd[k] = 1 + 0.1 * u
        elif k.endswith("e_score_correction_bias"):
            sd[k] = 0.1 * u
        else:
            sd[k] = 0.35 * u
    return sd


@pytest.fixture(scope="module")
def tiny():
    cfg = model_cfg()
    sd = seeded(cfg)
    model = load_model(cfg, dict(sd), "cpu")
    return cfg, sd, model, KimiVLLMReference(ref_cfg(cfg), sd)


def turn_batch():
    """Three turns padded to one shape (the second with an empty history,
    the third a row of no turn), features and their lengths."""
    g = torch.Generator().manual_seed(5)
    q = torch.tensor([[SOS, 10, 11, EOS, BLANK], [SOS, 12, EOS, BLANK, BLANK],
                      [BLANK] * 5])
    h = torch.tensor([[BLANK, SOS, 20, EOS, SOS, 21, 22, EOS],
                      [BLANK] * 8, [BLANK] * 8])
    c = torch.tensor([[SOS, 30, 31, 32, EOS, BLANK], [SOS, 33, EOS] + [BLANK] * 3,
                      [BLANK] * 6])
    fts = (torch.randn(3, 5, FT[0], generator=g),
           torch.randn(3, 4, FT[1], generator=g))
    lens = (torch.tensor([5, 3, 0]), torch.tensor([2, 4, 0]))
    z = torch.zeros(3, 1, dtype=torch.long)
    return DeviceBatch(query=q, his=h, cap=c, answer_in=z, answer_out=z,
                       fts=fts, fts_len=lens,
                       valid=torch.tensor([True, True, False]))


def ref_turn(db: DeviceBatch, b: int):
    """The reference's inputs of row ``b`` as ``logprobs_many`` takes
    them: exact frames, then the caption, history and question tokens."""
    fts = [f[b, :n[b]] for f, n in zip(db.fts, db.fts_len)]
    return fts, db.cap[b].tolist(), db.his[b].tolist(), db.query[b].tolist()


def state_of(model, db):
    masks, _ = batch_masks(db, BLANK)
    return model.init_decode_state(db.query, db.his, db.cap, db.fts, masks)


def test_the_model_names_the_reference_parameters_and_the_published_size():
    cfg = model_cfg()
    assert param_shapes(cfg) == param_spec(ref_cfg(cfg))
    fresh = init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == param_shapes(cfg)
    assert fresh["norm.weight"].eq(1).all()
    assert fresh["layers.1.mlp.gate.e_score_correction_bias"].eq(0).all()
    # the published language model builds on the meta device: 15.96 B
    big = ModelConfig(vocab_size=163840, ft_sizes=[2048, 128],
                      architecture="kimi_vl")
    shapes = param_shapes(big)
    lm = sum(np.prod(s) for k, s in shapes.items()
             if not k.startswith("projector_"))
    assert 15.95e9 < lm < 15.97e9
    assert shapes["layers.1.mlp.experts.gate_up_proj"] == (64, 2816, 2048)


def test_load_model_takes_the_given_tensors_in_place(tiny):
    cfg, sd, _, _ = tiny
    given = seeded(cfg, 1)
    model = load_model(cfg, given, "cpu")
    assert model.embed_tokens.weight.data_ptr() == \
        given["embed_tokens.weight"].data_ptr()
    assert model.inv_freq.device.type == "cpu"
    assert model.expert_rows.shape == (3, 8)


def test_the_config_refuses_what_the_port_does_not_build():
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        LMConfig.of(model_cfg(q_lora_rank=1536))
    with pytest.raises(NotImplementedError, match="n_group"):
        LMConfig.of(model_cfg(n_group=8))


def test_prefill_logits_match_the_reference(tiny):
    """Step 0's log-probs (after ``<sos>``) of each padded row against the
    reference's full forward over the row's exact prompt."""
    _, _, model, ref = tiny
    db = turn_batch()
    with torch.no_grad():
        state = state_of(model, db)
        kv = model.init_self_kv(3, 4)
        logp, _ = model.decode_step(state, torch.full((3,), SOS),
                                    torch.tensor(0), kv)
    assert state.base.tolist() == [5 + 2 + 5 + 7 + 4, 3 + 4 + 3 + 3, 0]
    for b in range(2):
        want = ref.logprobs_many([(*ref_turn(db, b), [[]])])[0][0][0]
        torch.testing.assert_close(logp[b], want, atol=ATOL, rtol=0)


def test_every_position_through_the_latent_cache_matches_full_forward(tiny):
    _, _, model, ref = tiny
    db = turn_batch()
    hyp = [[5, 6, 7, 8, 9], [12, 13, 14, 15, 16]]
    with torch.no_grad():
        state = state_of(model, db)
        kv = model.init_self_kv(3, 6)
        got = []
        for l, toks in enumerate(zip(*([[SOS] + h for h in hyp]
                                       + [[SOS] * 6]))):
            logp, kv = model.decode_step(state, torch.tensor(toks),
                                         torch.tensor(l), kv)
            got.append(logp)
    got = torch.stack(got, 1)
    for b in range(2):
        want = ref.logprobs_many([(*ref_turn(db, b), [hyp[b]])])[0][0]
        torch.testing.assert_close(got[b], want, atol=ATOL, rtol=0)


def test_the_absorbed_step_equals_the_decompressed_form(tiny):
    """One layer's attention at a sequence's last position: the step over
    the first S latents and its own against the prefill's causal form."""
    _, _, model, _ = tiny
    attn = model.layers[1].self_attn
    g = torch.Generator().manual_seed(2)
    R, S = 3, 7
    y = torch.randn(R, S + 1, LM["hidden_size"], generator=g)
    pos = torch.arange(S + 1).expand(R, S + 1)
    with torch.no_grad():
        c, k_pe = attn.latents(y, pos, model.inv_freq)
        attend = torch.ones(R, S + 1, S + 1, dtype=torch.bool).tril()
        full = attn.prefill(y, pos, attend, c, k_pe, model.inv_freq)[:, -1]
        cache = (torch.zeros(R, 4, 32), torch.zeros(R, 4, 16))
        step = attn.step(y[:, -1], pos[:, -1], torch.tensor(0),
                         (c[:, :S], k_pe[:, :S]),
                         torch.ones(R, S, dtype=torch.bool), cache,
                         model.inv_freq)
    torch.testing.assert_close(step, full, atol=1e-5, rtol=0)
    torch.testing.assert_close(cache[0][:, 0], c[:, -1], atol=0, rtol=0)


def test_rope_rotates_pairs_into_the_half_layout():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    inv = torch.tensor([1.0, 0.5])
    out = rope(x, torch.tensor([2]), inv)
    a, b = np.cos(2.0), np.sin(2.0)
    c, d = np.cos(1.0), np.sin(1.0)
    want = [1 * a - 2 * b, 3 * c - 4 * d, 2 * a + 1 * b, 4 * c + 3 * d]
    np.testing.assert_allclose(out[0].numpy(), want, rtol=1e-6)


def naive_experts(x, w, idx, real, gate_up, down):
    F = down.shape[2]
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        if real is not None and not real[t]:
            continue
        for s in range(idx.shape[1]):
            h = x[t] @ gate_up[idx[t, s]].t()
            a = torch.nn.functional.silu(h[:F]) * h[F:]
            out[t] += (a @ down[idx[t, s]].t()) * w[t, s]
    return out


@pytest.mark.parametrize("case", ["random", "an_empty_expert",
                                  "every_row_on_one_expert", "pad_tokens"])
def test_grouped_experts_match_a_loop(case):
    g = torch.Generator().manual_seed(3)
    T, D, F, E, k = 11, 16, 8, 5, 2
    x = torch.randn(T, D, generator=g)
    gate_up = torch.randn(E, 2 * F, D, generator=g)
    down = torch.randn(E, D, F, generator=g)
    w = torch.rand(T, k, generator=g)
    idx = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)])
    real = None
    if case == "an_empty_expert":
        idx = torch.stack([torch.randperm(E - 1, generator=g)[:k]
                           for _ in range(T)])   # expert E-1 takes none
    elif case == "every_row_on_one_expert":
        idx = torch.stack([torch.tensor([3, 1])] * T)
    elif case == "pad_tokens":
        real = torch.arange(T) % 3 != 0
    rows = torch.zeros(E, dtype=torch.int64)
    got = moe.routed_experts(x, w, idx, real, gate_up, down, rows)
    torch.testing.assert_close(
        got, naive_experts(x, w, idx, real, gate_up, down),
        atol=1e-5, rtol=1e-5)
    keep = torch.ones(T, dtype=torch.bool) if real is None else real
    assert rows.tolist() == torch.bincount(idx[keep].reshape(-1),
                                           minlength=E).tolist()


def test_the_selection_bias_moves_the_choice_but_not_the_weights():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(64, 16, generator=g)
    gate = torch.randn(8, 16, generator=g)
    none = torch.zeros(8)
    bias = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.6])
    w0, i0 = moe.route(x, gate, none, 2, 2.446, True)
    w1, i1 = moe.route(x, gate, bias, 2, 2.446, True)
    moved = (i0 != i1).any(1)
    assert moved.any() and (i1 == 7).any(1).all() | ~moved.all()
    scores = torch.sigmoid(x @ gate.t())
    for w, i in ((w0, i0), (w1, i1)):
        picked = scores.gather(1, i)
        torch.testing.assert_close(
            w, picked / picked.sum(1, keepdim=True) * 2.446, atol=1e-6,
            rtol=0)
        torch.testing.assert_close(w.sum(1), torch.full((64,), 2.446),
                                   atol=1e-5, rtol=0)


def test_beam_nbest_scores_match_the_reference_teacher_forced(tiny):
    _, _, model, ref = tiny
    db = turn_batch()
    cfg = DecodeConfig(maxlen=6, beam=3, nbest=3, penalty=1.0,
                       early_stop=True)
    results = BeamDecoder(model, cfg).beam_batch(db)
    assert len(results) == 2
    for b, res in enumerate(results):
        # MTNReference's argument order: query, history, caption, features
        fts, cap, his, query = ref_turn(db, b)
        want = ref.hypothesis_scores(db.query[b:b + 1], his, cap,
                                     [f[None] for f in fts], res.tokens, 1.0)
        for toks, got, w in zip(res.tokens, res.scores, want):
            assert abs(got - w) <= ATOL * (len(toks) + 1)


def test_the_programs_on_the_host_loop_are_the_eager_loop_bitwise(tiny):
    from mtn_tpu_torch.decode.graphs import BeamPrograms
    _, _, model, _ = tiny
    db = turn_batch()
    cfg = DecodeConfig(maxlen=6, beam=3, nbest=3, penalty=1.0)
    dec = BeamDecoder(model, cfg)
    with torch.inference_mode():
        pool, n = BeamPrograms(dec, db, capture=False).run(db)
        raw = dec.beam_eager(db)
    assert int(n) == raw.n_steps
    for a, b in zip(pool, (raw.comp_scores, raw.comp_buf, raw.comp_len)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def checkpoint(tiny_corpus, tmp_path_factory):
    """A tiny checkpoint of the architecture on the corpus' vocabulary."""
    from mtn_tpu_torch.data.vocab import get_vocabulary
    from mtn_tpu_torch.weights import save_checkpoint, save_conf
    c = tiny_corpus
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    cfg = model_cfg(vocab_size=len(vocab), ft=c.ft_dims)
    prefix = str(tmp_path_factory.mktemp("kimi") / "lm")
    data = DataConfig(fea_type=list(c.fea_types),
                      include_caption="caption,summary",
                      separate_caption=True, length_bucket=8,
                      feature_bucket=4)
    save_conf(prefix, vocab, model=cfg, data=data)
    save_checkpoint(prefix, 1, seeded(cfg, 7))
    return c, prefix, cfg, vocab, data


def test_cli_generate_decodes_a_checkpoint_of_the_architecture(checkpoint,
                                                              tmp_path):
    from mtn_tpu_torch.cli.generate import main
    c, prefix, *_ = checkpoint
    out, stats = tmp_path / "result.json", tmp_path / "stats.json"
    assert main(["--model", prefix + "_best", "--device", "cpu",
                 "--dtype", "float32", "--test-path", c.fea_path,
                 "--test-set", c.test_set, "--decode-style", "beam_search",
                 "--beam", "3", "--nbest", "3", "--penalty", "1.0",
                 "--maxlen", "8", "--turn-batch", "4",
                 "--undisclosed-only", "1", "--output", str(out),
                 "--stats-output", str(stats)]) == 0
    result = json.loads(out.read_text())
    answers = [qa["answer"] for d in result["dialogs"] for qa in d["dialog"]]
    assert answers and "__UNDISCLOSED__" not in answers
    assert json.loads(stats.read_text())["turns"] == len(answers)


def test_a_recorded_pass_carries_the_prefill_span_and_routing_counters(
        checkpoint):
    from mtn_tpu_torch.cli.generate import generate_responses
    from mtn_tpu_torch.data.dataset import load
    from mtn_tpu_torch.utils import profiling
    from mtn_tpu_torch.weights import load_checkpoint
    c, prefix, cfg, vocab, data = checkpoint
    model = load_model(cfg, load_checkpoint(prefix)[0], "cpu")
    ds = load(c.fea_types, c.fea_path, c.test_set, vocab,
              include_caption="caption,summary", separate_caption=True,
              undisclosed_only=True)
    with profiling.recording() as rec:
        generate_responses(model, ds, DecodeConfig(
            maxlen=4, beam=2, nbest=2, turn_batch=4, undisclosed_only=True),
            data, vocab, "cpu", log_hyps=False)
    host = rec.records()["host"]
    root = next(s for s in host if s["name"] == "decode.pass")
    assert any(s["name"] == "lm.prefill" for s in host)
    counters = root["counters"]
    rows = model.expert_rows.sum().item()
    assert counters["moe_tokens"] == rows // 2 > 0
    assert counters["moe_expert_rows_max_over_mean"] >= 1.0


def refuse_train(cfg, **_):
    from mtn_tpu_torch.train.trainer import Trainer
    Trainer(cfg, TrainConfig(), "cpu")


def refuse_serve(cfg, sd, vocab, data):
    from mtn_tpu_torch.serve import ServingSession
    ServingSession(sd, cfg, data, vocab, device="cpu")


def refuse_int8(cfg, sd, **_):
    from mtn_tpu_torch.utils.quantize import quantize_model
    quantize_model(load_model(cfg, sd, "cpu"), sd)


def refuse_mesh(cfg, sd, **_):
    from mtn_tpu_torch.parallel.sharding import Shardings
    Shardings.shard_model(None, load_model(cfg, sd, "cpu"))


@pytest.mark.parametrize("path,match", [
    (refuse_train, "training"), (refuse_serve, "serving"),
    (refuse_int8, "int8"), (refuse_mesh, "mesh")])
def test_the_mtn_only_paths_refuse_the_architecture(checkpoint, path, match):
    _, prefix, cfg, vocab, data = checkpoint
    sd = seeded(cfg, 7)
    with pytest.raises(NotImplementedError, match=match):
        path(cfg, sd=sd, vocab=vocab, data=data)


def test_cli_generate_refuses_int8_for_the_architecture(checkpoint):
    from mtn_tpu_torch.cli.generate import main
    c, prefix, *_ = checkpoint
    with pytest.raises(NotImplementedError, match="int8"):
        main(["--model", prefix + "_best", "--device", "cpu",
              "--test-path", c.fea_path, "--test-set", c.test_set,
              "--weights-quant", "int8"])


def test_cli_rank_and_aot_refuse_the_architecture(checkpoint, tmp_path):
    from mtn_tpu_torch.cli.rank import main as rank_main
    from mtn_tpu_torch.utils.aot import export_decode
    c, prefix, *_ = checkpoint
    with pytest.raises(NotImplementedError, match="ranking"):
        rank_main(["--model", prefix + "_best", "--device", "cpu",
                   "--test-path", c.fea_path, "--test-set", c.test_set,
                   "--candidates", str(tmp_path / "none.json")])
    # AOT export builds a ServingSession, whose refusal stands for both
    with pytest.raises(NotImplementedError, match="ServingSession"):
        export_decode(prefix + "_best", str(tmp_path / "aot"), device="cpu")


@pytest.mark.parametrize("trace", ["0", "1"])
def test_the_benchmark_runs_the_language_model_driver_correct(trace):
    bench = os.path.join(ROOT, "benchmark", "tests", "tiny_lm",
                         "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "tiny-lm-decode", "--seed", "3000000321",
         "--seconds", "0.3", "--trace", trace, "--device", "cpu",
         "--bench", bench], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["unscored"]["value"] == 0
    assert {"score_gap_per_token", "score_gap_rms",
            "probe_gap_rms"} <= set(line["checks"])
    want = ({"setup_s", "decode_responses_per_s"} if trace == "0" else
            {"host_batch_ms.decode", "decode_first_batch_s",
             "decode_exit_steps", "mfu.decode"})
    assert set(line["metrics"]) == want


def test_the_reference_mlp_by_row_blocks_equals_one_block(tiny,
                                                           monkeypatch):
    """The reference's gated MLP, taken ``ROWS`` tokens at a time so that
    the check fits on the card beside the program, gives each token what
    one block gives (float32 products of the same rows; 1e-6 covers a
    product's kernel chosen by its row count)."""
    from benchmark.reference import kimi_vl_lm_ref
    _, _, _, ref = tiny
    x = torch.randn(37, LM["hidden_size"], generator=torch.Generator()
                    .manual_seed(3))
    whole = ref.swiglu("layers.0.mlp", x)
    monkeypatch.setattr(kimi_vl_lm_ref, "ROWS", 8)
    torch.testing.assert_close(ref.swiglu("layers.0.mlp", x), whole,
                               atol=1e-6, rtol=0)


def test_the_probe_statistic_counts_hypotheses_from_min_tokens():
    """``probe_gap_rms`` is the rms of the gap per event of the
    hypotheses of at least ``min_tokens`` tokens, 0 where there is
    none."""
    from benchmark.drivers.decode_lm import rms_per_token
    gaps = [(1, 1.0), (9, 2.0), (19, 4.0)]  # per event 0.5, 0.2, 0.2
    assert rms_per_token(gaps) == pytest.approx(np.sqrt((0.25 + 0.08) / 3))
    assert rms_per_token(gaps, 9) == pytest.approx(0.2)
    assert rms_per_token(gaps, 20) == 0.0
