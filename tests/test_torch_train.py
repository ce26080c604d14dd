"""The port's training against mtn_tpu's on the CPU: the kernels' autograd
wrappers, one step's loss and gradients, a JAX TrainState carried into the
port, accumulation, remat, the batch order and cut_a draws, and the train
CLI end to end (f32, tiny configs, numpy-seeded params)."""

import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from mtn_tpu.config import DataConfig as JDataConfig
from mtn_tpu.config import TrainConfig as JTrainConfig
from mtn_tpu.data import get_vocabulary
from mtn_tpu.data import load as jax_load
from mtn_tpu.data.batching import make_batch_indices as jax_indices
from mtn_tpu.data.pipeline import BatchIterator as JBatchIterator
from mtn_tpu.data.pipeline import shuffled as jax_shuffled
from mtn_tpu.train.trainer import Trainer as JTrainer
from mtn_tpu.train.trainer import TrainState as JTrainState
from mtn_tpu_torch.cli import train as train_cli
from mtn_tpu_torch.config import DataConfig, TrainConfig
from mtn_tpu_torch.data.batching import make_batch_indices
from mtn_tpu_torch.data.dataset import load
from mtn_tpu_torch.data.pipeline import BatchIterator, shuffled
from mtn_tpu_torch.ops import attention_kernel as ak
from mtn_tpu_torch.ops import ffn_kernel as fk
from mtn_tpu_torch.parallel.collectives import drawing
from mtn_tpu_torch.train.batch import accumulated, blank_like
from mtn_tpu_torch.train.trainer import Trainer
from mtn_tpu_torch.weights import (from_flax, load_checkpoint,
                                   opt_state_from_optax, optax_adam_fields)
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import (both_batches, host_fields, interpret_pallas,
                                one_thread, port_cfg, seeded_params,
                                train_argv)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 5e-5   # the whole-model tolerance of tests/test_pallas.py


def _cfg(**kw):
    """Dropout 0 and both kernels on; d_ff 256 and every sequence 16 long,
    so both kernels' gates take every call."""
    base = dict(dropout=0.0, attn_dropout=0.0, use_pallas_attention=True,
                use_pallas_ffn=True, d_ff=256)
    base.update(kw)
    return tiny_model_cfg(30, (12, 8), **base)


def _fields(seed=0, B=2):
    rng = np.random.default_rng(seed)
    f = host_fields(rng, B=B, Lq=16, Lh=16, Lc=16, La=16,
                    lengths=[[5, 3, 4, 2][:B], [2, 4, 1, 3][:B]])
    f["query"][1, 11:] = 1      # padded keys
    f["answer_in"][0, 12:] = 1
    f["answer_out"][0, 11:] = 1
    return f


def _port_trainer(cfg, warmup=10, grad_clip=0.0, **overrides):
    c = port_cfg(cfg)
    for k, v in overrides.items():
        setattr(c, k, v)
    return Trainer(c, TrainConfig(warmup_steps=warmup, grad_clip=grad_clip),
                   "cpu")


def _named(trainer, grads):
    return dict(zip(trainer.names, grads))


# -- the kernels' autograd wrappers ------------------------------------------
def _attn_inputs(gen, B=2, H=2, Lq=16, Lk=20, D=8):
    q, k, v = (torch.randn(B, H, L, D, generator=gen) for L in (Lq, Lk, Lk))
    mask = torch.rand(B, 1, 1, Lk, generator=gen) > 0.3
    mask[..., 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("needs", ["qkv", "q"])
def test_attention_function_backward_is_the_plain_math(monkeypatch, needs):
    """AttentionFunction (the launch replaced by the plain version, since
    the kernel runs only on the card) gives the plain version's
    gradients, a grad_fn, and no gradient for inputs that need none."""
    monkeypatch.setattr(ak, "launch", ak.attention_plain)
    gen = torch.Generator().manual_seed(0)
    q, k, v, mask = _attn_inputs(gen)
    w = torch.randn(2, 2, 16, 8, generator=gen)
    a = [t.clone().requires_grad_(n in needs) for t, n in zip((q, k, v),
                                                               "qkv")]
    b = [t.clone().requires_grad_(n in needs) for t, n in zip((q, k, v),
                                                               "qkv")]
    out = ak.AttentionFunction.apply(*a, mask)
    assert type(out.grad_fn).__name__ == "AttentionFunctionBackward"
    (out * w + out ** 2).sum().backward()
    want = ak.attention_plain(*b, mask)
    (want * w + want ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=1e-6)
    for x, y, n in zip(a, b, "qkv"):
        if n in needs:
            np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                       atol=2e-5, err_msg=n)
        else:
            assert x.grad is None


def test_ffn_function_backward_is_the_plain_math(monkeypatch):
    monkeypatch.setattr(fk, "launch", fk.ffn_plain)
    gen = torch.Generator().manual_seed(1)
    shapes = [(24, 16), (16, 256), (256,), (256, 16), (16,)]
    args = [torch.randn(*s, generator=gen) * 0.3 for s in shapes]
    a = [t.clone().requires_grad_() for t in args]
    b = [t.clone().requires_grad_() for t in args]
    out = fk.FFNFunction.apply(*a)
    assert type(out.grad_fn).__name__ == "FFNFunctionBackward"
    (out ** 2).sum().backward()
    (fk.ffn_plain(*b) ** 2).sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_wrappers_raise_for_a_grad_input_off_the_cpu():
    """A tensor that requires grad on a device without the kernel goes
    through the autograd wrapper to the launch, which raises: no quiet
    fallback to the plain version."""
    meta = lambda *s: torch.empty(*s, device="meta", requires_grad=True)
    launches = (ak.KERNEL.launches, fk.KERNEL.launches)
    with pytest.raises(ValueError, match="device"):
        ak.attention(meta(2, 8, 16, 64), meta(2, 8, 16, 64),
                     meta(2, 8, 16, 64))
    with pytest.raises(ValueError, match="device"):
        fk.ffn(meta(16, 512), meta(512, 2048), meta(2048), meta(2048, 512),
               meta(512))
    assert (ak.KERNEL.launches, fk.KERNEL.launches) == launches


# -- one step against JAX ---------------------------------------------------
@pytest.fixture(scope="module")
def jax_step():
    """Loss and gradients of one JAX step (Pallas in interpret mode), and
    two JAX train steps with clipping, from numpy-seeded params."""
    cfg = _cfg()
    params = seeded_params(cfg, seed=4)
    jdb, tdb = both_batches(_fields())
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        jt = JTrainer(cfg, JTrainConfig(warmup_steps=10, grad_clip=1.0))
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jt._loss_fn(p, jdb, jax.random.PRNGKey(0), False),
            has_aux=True))(params)
        st = JTrainState(params=params, opt_state=jt.optimizer.init(params),
                         step=jax.numpy.zeros((), jax.numpy.int32))
        rng = jax.random.PRNGKey(1)
        states = []
        for _ in range(3):
            st, _ = jt.train_step(st, jdb, rng)
            states.append(jax.tree.map(np.asarray, st))
    return dict(cfg=cfg, params=params, tdb=tdb, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=from_flax(jax.tree.map(np.asarray, grads)),
                states=states)


def test_one_step_loss_and_gradients_match_jax(jax_step):
    tr = _port_trainer(jax_step["cfg"])
    tr.state_from(from_flax(jax_step["params"]))
    loss, metrics, grads = tr.loss_and_grads(jax_step["tdb"], (0, 0))
    np.testing.assert_allclose(float(loss), jax_step["loss"], atol=ATOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), jax_step["metrics"][k],
                                   atol=ATOL, err_msg=k)
    got = _named(tr, grads)
    assert got.keys() == jax_step["grads"].keys()
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), jax_step["grads"][n].numpy(),
                                   atol=ATOL, err_msg=n)


def test_jax_train_state_resumes_in_the_port(jax_step):
    """Two JAX steps (clipping on: the optax chain's state), carried into
    the port by from_flax + opt_state_from_optax; one more step on both
    sides gives the same params.

    Except the K projections' biases: adding one vector to every key adds
    one number to a row's scores, which the softmax ignores, so their true
    gradient is 0 and Adam turns each side's rounding noise into steps of
    about the rate. The test checks that their gradient is noise and
    leaves them out."""
    st2, st3 = jax_step["states"][1], jax_step["states"][2]
    carry = lambda: tr.state_from(from_flax(st2.params),
                                  opt_state_from_optax(*optax_adam_fields(
                                      st2.opt_state)), step=int(st2.step))
    tr = _port_trainer(jax_step["cfg"], grad_clip=1.0)
    carry()
    grads = _named(tr, [g.clone() for g in
                        tr.loss_and_grads(jax_step["tdb"], (0,))[2]])
    state = carry()
    assert state.opt_state.count == 2 and state.step == 2
    state, _ = tr.train_step(state, jax_step["tdb"], 0)
    assert state.step == 3
    want = from_flax(st3.params)
    for n, t in state.params.items():
        if n.endswith(".w_k.bias"):
            assert float(grads[n].abs().max()) < 1e-6, n
            continue
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), atol=1e-5,
                                   err_msg=n)


# -- accumulation and remat -------------------------------------------------
def test_accumulation_equals_one_big_batch():
    """Two microbatches plus a blank filler give the one-big-batch loss
    and gradients (macro-batch normalisers), and a blank tail changes
    nothing in a full update."""
    cfg = _cfg()
    sd = from_flax(seeded_params(cfg, seed=5))
    tr = _port_trainer(cfg)
    big = both_batches(_fields(seed=1, B=4))[1]
    half = lambda s: dataclasses.replace(
        big, **{f.name: (tuple(t[s] for t in getattr(big, f.name))
                         if isinstance(getattr(big, f.name), tuple)
                         else getattr(big, f.name)[s])
                for f in dataclasses.fields(big)})
    lo, hi = half(slice(0, 2)), half(slice(2, 4))

    state = tr.state_from(sd)
    _, m_big = tr.train_step(state, big, 3)
    p_big = {n: t.clone() for n, t in state.params.items()}
    state = tr.state_from(sd)
    group, = accumulated([lo, hi], 3)
    _, m_acc = tr.train_step_accum(state, group, 3)
    assert float(m_acc["ntokens"]) == float(m_big["ntokens"])
    np.testing.assert_allclose(float(m_acc["loss"]), float(m_big["loss"]),
                               rtol=1e-5)

    ntok = torch.clamp((big.answer_out != 1).sum().float(), min=1.0)
    ae_ntok = torch.clamp((big.query != 1).sum().float(), min=1.0)
    tr.state_from(sd)
    grads = lambda b, acc=False: [g.clone() for g in tr.loss_and_grads(
        b, (0,), norm=(ntok, ae_ntok), accumulate=acc)[2]]
    g_big = grads(big)
    g_sum = [a + b + c for a, b, c in zip(grads(lo), grads(hi),
                                          grads(blank_like(lo)))]
    grads(lo)
    grads(hi, True)
    g_acc = grads(blank_like(lo), True)
    for n, a, b in zip(tr.names, g_sum, g_acc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    for n, a, b in zip(tr.names, g_big, g_acc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=1e-5, err_msg=n)

    state = tr.state_from(sd)
    tr.train_step_accum(state, [big, blank_like(big)], 3)
    for n, t in state.params.items():
        np.testing.assert_allclose(t.numpy(), p_big[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_bf16_gradients_land_in_the_f32_buffers():
    """A bf16 model (its norms stay f32): each call's gradients are the
    model's own, widened into the trainer's f32 buffers; the next call
    overwrites them and ``accumulate`` adds to them."""
    cfg = _cfg(dtype="bfloat16")
    tr = _port_trainer(cfg)
    tr.state_from(from_flax(seeded_params(cfg, seed=7)))
    tdb = both_batches(_fields(seed=3))[1]
    assert {p.dtype for p in tr.params} == {torch.bfloat16, torch.float32}
    tr.model.train()
    tr._seed([(0,)])
    with drawing(tr.draws(0)):
        tr.loss_fn(tdb)[0].backward()
    want = [p.grad.float() for p in tr.params]
    for p in tr.params:
        p.grad = None
    tr.loss_and_grads(tdb, (1,))
    one = [g.clone() for g in tr.loss_and_grads(tdb, (0,))[2]]
    two = tr.loss_and_grads(tdb, (0,), accumulate=True)[2]
    for n, w, a, b in zip(tr.names, want, one, two):
        assert a.dtype == torch.float32, n
        torch.testing.assert_close(a, w, rtol=0, atol=0, msg=n)
        torch.testing.assert_close(b, 2 * w, rtol=0, atol=0, msg=n)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_gives_the_same_loss_and_gradients(dropout):
    """Remat recomputes each decoder layer in the backward with the
    forward's RNG state, so even with dropout on it gives the same loss
    and gradients as the stored-activation step for the same seed."""
    cfg = _cfg(dropout=dropout, attn_dropout=dropout)
    sd = from_flax(seeded_params(cfg, seed=6))
    tdb = both_batches(_fields(seed=2))[1]
    out = []
    for remat in (False, True):
        tr = _port_trainer(cfg, remat=remat)
        tr.state_from(sd)
        loss, _, grads = tr.loss_and_grads(tdb, (7, 3))
        out.append((float(loss), grads))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_dropout_draws_are_keyed_by_seed_and_step():
    cfg = _cfg(dropout=0.1, attn_dropout=0.1)
    sd = from_flax(seeded_params(cfg, seed=6))
    tdb = both_batches(_fields(seed=2))[1]
    tr = _port_trainer(cfg)
    tr.state_from(sd)
    loss = lambda *key: float(tr.loss_and_grads(tdb, key)[0])
    torch.manual_seed(123)          # the global RNG plays no part
    a = loss(1, 5)
    torch.manual_seed(321)
    assert loss(1, 5) == a and loss(1, 6) != a


# -- data order -------------------------------------------------------------
def test_batch_order_and_cut_a_draws_match_jax(tiny_corpus):
    c = tiny_corpus
    vocab = get_vocabulary(c.train_set, 0, "caption,summary")
    kw = dict(include_caption="caption,summary", separate_caption=True)
    jdata = jax_load(c.fea_types, c.fea_path, c.train_set, vocab, **kw)
    tdata = load(c.fea_types, c.fea_path, c.train_set, vocab, **kw)
    jplans, _ = jax_indices(jdata, 4, 64, separate_caption=True)
    tplans, _ = make_batch_indices(tdata, 4, 64, separate_caption=True)
    assert [p.qa_ids for p in jplans] == [p.qa_ids for p in tplans]
    dkw = dict(separate_caption=True, batch_size=4, cut_a=True,
               length_bucket=8, feature_bucket=4, prefetch=2)
    for epoch in range(3):
        key = [1, epoch]
        jp = jax_shuffled(jplans, np.random.default_rng(key))
        tp = shuffled(tplans, np.random.default_rng(key))
        assert [p.qa_ids for p in jp] == [p.qa_ids for p in tp]
        jit_ = JBatchIterator(jdata, jp[1:], JDataConfig(
            use_native_loader=False, **dkw), train=True, seed_key=key,
            start=1)
        tit = BatchIterator(tdata, tp[1:], DataConfig(**dkw), train=True,
                            seed_key=key, start=1)
        n = 0
        for jb, tb in zip(jit_, tit):
            for f in ("answer_in", "answer_out", "query", "his"):
                np.testing.assert_array_equal(getattr(jb, f),
                                              getattr(tb, f), err_msg=f)
            n += 1
        assert n == len(tp) - 1


# -- the CLI ----------------------------------------------------------------
def test_cli_train_then_generate(tiny_corpus, tmp_path, capsys):
    from mtn_tpu_torch.cli.generate import main as generate
    c = tiny_corpus
    prefix = str(tmp_path / "exp" / "mtn")
    assert train_cli.main(train_argv(
        c, prefix, "--num-epochs", "2", "--use-pallas-attention", "1",
        "--use-pallas-ffn", "1", "--remat", "1", "--cut-a", "1")) == 0
    steps = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Epoch: ")]
    assert steps and "Tokens per Sec: " in steps[0]
    lines = open(prefix + "_train.csv").read().splitlines()
    assert lines[0] == "epoch,step,loss,tokens_per_sec"
    assert len(lines) == 1 + len(steps)
    assert open(prefix + "_trace.csv").read().startswith(
        "epoch,split,avg_loss")
    meta = json.load(open(prefix + "_torch/meta.json"))
    assert meta["epochs"] == [1, 2] and meta["best_epoch"] in (1, 2)
    conf = json.load(open(prefix + ".conf.json"))
    assert conf["model"]["remat"] and conf["data"]["cut_a"]
    sd, epoch = load_checkpoint(prefix, "best")
    assert epoch == meta["best_epoch"]
    assert all(t.dtype == torch.float32 for t in sd.values())
    out = tmp_path / "result.json"
    assert generate(["--model", prefix + "_best", "--device", "cpu",
                     "--dtype", "float32", "--test-path", c.fea_path,
                     "--test-set", c.test_set, "--decode-style",
                     "beam_search", "--beam", "3", "--maxlen", "8",
                     "--turn-batch", "4", "--undisclosed-only", "1",
                     "--output", str(out)]) == 0
    answers = [qa["answer"] for d in json.loads(out.read_text())["dialogs"]
               for qa in d["dialog"]]
    assert answers and "__UNDISCLOSED__" not in answers


def test_cli_train_accumulation_and_clipping(tiny_corpus, tmp_path):
    prefix = str(tmp_path / "mtn")
    assert train_cli.main(train_argv(
        tiny_corpus, prefix, "--num-epochs", "1", "--accum-steps", "2",
        "--uniform-shapes", "1", "--grad-clip", "0.5",
        "--patience", "1")) == 0
    assert json.load(open(prefix + "_torch/meta.json"))["epochs"] == [1]
    with pytest.raises(SystemExit, match="uniform-shapes"):
        train_cli.main(train_argv(tiny_corpus, prefix, "--accum-steps",
                                  "2"))


def test_cli_train_int8_feature_transfer(tiny_corpus, tmp_path):
    """--feature-transfer int8 trains on int8-transferred features and
    records the transfer in the config sidecar."""
    prefix = str(tmp_path / "mtn")
    assert train_cli.main(train_argv(
        tiny_corpus, prefix, "--num-epochs", "1",
        "--feature-transfer", "int8")) == 0
    assert json.load(open(prefix + "_torch/meta.json"))["epochs"] == [1]
    conf = json.load(open(prefix + ".conf.json"))
    assert conf["data"]["feature_dtype"] == "int8"


def test_cli_train_has_the_jax_flags():
    """Every flag of mtn_tpu.cli.train, with its default, plus --device."""
    from mtn_tpu.cli.train import build_parser as jax_parser
    flags = lambda p: {a.dest: (tuple(a.option_strings), a.default)
                       for a in p._actions if a.dest != "help"}
    got, want = flags(train_cli.build_parser()), flags(jax_parser())
    assert got.pop("device") == (("--device",), "cuda")
    assert got == want


@pytest.mark.parametrize("flag,error,match", [
    (["--multihost", "h:1,2"], ValueError,
     "--multihost expects 'auto' or 'host:port,nprocs,procid'"),
    (["--mesh-data", "2", "--mesh-model", "2"], AssertionError,
     "mesh 2x2 > 1 devices"),
    (["--mesh-model", "2"], AssertionError,
     "1 devices not divisible by model=2")])
def test_cli_train_refuses_unported_flags(flag, error, match):
    """The parallel flags are ported (``tests/test_torch_distributed.py``);
    a mesh larger than the world raises as JAX's ``make_mesh`` asserts, a
    bad ``--multihost`` spec with JAX's message."""
    with pytest.raises(error, match=re.escape(match)):
        train_cli.main(["--device", "cpu", *flag])


def test_cli_train_needs_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--model", "x"])
