"""The port's sharding rules and batch layout (``mtn_tpu_torch/parallel``)
against ``mtn_tpu.parallel`` on JAX's 8 virtual CPU devices, and the
mesh and ``--multihost`` set-up on a world of one (CPU, no process
group)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mtn_tpu.data.batching import HostBatch as JHostBatch
from mtn_tpu.parallel import Shardings as JShardings
from mtn_tpu.parallel import make_mesh as jax_make_mesh
from mtn_tpu.parallel.multihost import initialize_from_flag as jax_flag
from mtn_tpu.utils.quantize import quantize_params
from mtn_tpu_torch.data.batching import HostBatch
from mtn_tpu_torch.models.mtn import MTN
from mtn_tpu_torch.parallel import Shardings, make_mesh, multihost
from mtn_tpu_torch.parallel.collectives import Axis
from mtn_tpu_torch.train.batch import device_batch
from mtn_tpu_torch.utils.quantize import quantize_model
from mtn_tpu_torch.weights import from_flax
from tests.fixtures import tiny_model_cfg
from tests.torch_parity import host_fields, port_cfg, seeded_params


def _flat(tree, prefix=""):
    """A nested tree of specs -> {"a.b.c": tuple(spec)}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v)
    return out


@pytest.mark.parametrize("vocab,int8", [(32, False), (32, True),
                                        (31, False)])
def test_param_specs_equal_jax(vocab, int8):
    """Every parameter's spec (int8 kernels and scales too; a vocabulary
    that does not divide stays replicated) equals JAX's on a 4x2 mesh,
    and ``shard_model`` cuts exactly the axes the specs name."""
    jcfg = tiny_model_cfg(vocab, (16, 8), dropout=0.0, d_model=8, d_ff=16)
    tree = seeded_params(jcfg, seed=0)
    model = MTN(port_cfg(jcfg))
    model.load_state_dict(from_flax(tree))
    if int8:
        tree = quantize_params(tree)
        quantize_model(model, from_flax(seeded_params(jcfg, seed=0)))
    specs = JShardings(jax_make_mesh(data=4, model=2)).tree_specs(tree)
    want = (dict(_flat(specs.params), **_flat(specs.qscales)) if int8
            else _flat(specs))
    full = {n: t.clone() for n, t in model.state_dict().items()}
    sh = Shardings(data=Axis(4, 1), model=Axis(2, 1))
    got = sh.tree_specs(full)
    assert got == want
    assert any("model" in s for s in got.values())
    layout = sh.shard_model(model)
    for n, t in model.state_dict().items():
        spec = got[n]
        d = spec.index("model") if "model" in spec else None
        assert layout.dims[n] == d, n
        want_t = full[n] if d is None else \
            full[n].chunk(2, d)[1]
        assert torch.equal(t, want_t), n
    assert torch.equal(layout.shard(full)["generator.proj.kernel"],
                       model.generator.proj.kernel)


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "int8"])
def test_put_host_batch_rows_equal_jax_shards(dt):
    """Each data rank's rows of a host batch are, bit for bit, the
    addressable shard of JAX's ``put_host_batch`` that its data index
    owns (f32, bf16, the int8 transfer quantized on the host), and the
    rows ``put_batch`` cuts from the whole device batch."""
    fields = host_fields(np.random.default_rng(3), B=8, ft_dims=(16, 8),
                         vocab=30)
    fields["cap"] = None
    jb = JShardings(jax_make_mesh(data=4, model=2)).put_host_batch(
        JHostBatch(**fields), dt)
    names = ["query", "his", "cap", "answer_in", "answer_out"]
    for d in range(4):
        sh = Shardings(data=Axis(4, d), model=Axis(2, 0))
        tb = sh.put_host_batch(HostBatch(**fields), "cpu", dt)
        cut = sh.put_batch(device_batch(HostBatch(**fields), "cpu", dt))
        for a, b in zip(dataclasses.astuple(tb), dataclasses.astuple(cut)):
            for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
                assert torch.equal(x, y)
        pairs = [(getattr(jb, n), getattr(tb, n)) for n in names]
        pairs += list(zip(jb.fts, tb.fts)) + list(zip(jb.fts_len,
                                                      tb.fts_len))
        pairs += [(jb.valid, tb.valid)]
        for jx, tx in pairs:
            shard = [s for s in jx.addressable_shards
                     if (s.index[0].start or 0) == 2 * d][0]
            want = np.asarray(shard.data)
            if tx.dtype == torch.bfloat16:
                got = tx.view(torch.int16).numpy().view(np.uint16)
                want = want.view(np.uint16)
            else:
                got = tx.numpy()
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want.astype(got.dtype))
        assert tb.fts[0].dtype == (torch.bfloat16 if dt == "bfloat16"
                                   else torch.float32)


def test_mesh_over_a_world_of_one():
    """No process group: the single-device case (None); a mesh larger
    than the world raises JAX's assertion."""
    assert make_mesh() is None and make_mesh(data=1, model=1) is None
    one = jax.devices()[:1]
    for kw in (dict(data=-1, model=2), dict(data=2, model=1),
               dict(data=1, model=2)):
        with pytest.raises(AssertionError) as want:
            jax_make_mesh(devices=one, **kw)
        with pytest.raises(AssertionError) as got:
            make_mesh(**kw)
        assert str(got.value) == str(want.value)
    assert multihost.is_primary()


@pytest.mark.parametrize("spec", ["h:1,two,0", "h:1,2", "auto-ish"])
def test_multihost_flag_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_flag(spec)
    with pytest.raises(ValueError) as got:
        multihost.initialize_from_flag(spec, device="cpu")
    assert str(got.value) == str(want.value)


def test_rows_of_a_batch_per_data_rank():
    sh = [Shardings(data=Axis(4, d)) for d in range(4)]
    assert [s.rows(8) for s in sh] == [slice(0, 2), slice(2, 4),
                                       slice(4, 6), slice(6, 8)]
    assert Shardings().rows(5) == slice(0, 5)
    with pytest.raises(ValueError, match="does not divide"):
        sh[0].rows(6)


@pytest.mark.parametrize("rows,data", [(256, 1), (256, 2), (128, 2),
                                       (160, 1), (40, 4)])
def test_ffn_gate_sees_the_whole_batchs_rows(monkeypatch, rows, data):
    """Under a data axis the FFN kernel's gate takes the whole batch's
    rows, the global shape JAX's gate sees under GSPMD: a data rank's 256
    rows of a 512-row batch stay plain, as in JAX."""
    from mtn_tpu.ops.pallas_ffn import supports as jax_supports
    from mtn_tpu_torch.models.layers import FeedForward
    from mtn_tpu_torch.ops import ffn_kernel
    launched = []
    kernel = ffn_kernel.ffn
    monkeypatch.setattr(ffn_kernel, "ffn", lambda *a: launched.append(
        1) or kernel(*a))
    D, F = 64, 512
    ff = FeedForward(D, F, 0.0, torch.bfloat16, use_kernel=True).eval()
    if data > 1:
        ff.data_axis = Axis(data, 0)
    ff(torch.zeros(rows // 8, 8, D))
    assert bool(launched) == jax_supports(rows * data, D, F, 2) == (
        rows * data <= 256)
