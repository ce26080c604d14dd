"""The port's loss, Noam schedule and Adam against mtn_tpu's (optax) on the
CPU: the same numpy inputs into both."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mtn_tpu.train import loss as jloss
from mtn_tpu.train.schedule import make_optimizer, noam_schedule as jnoam
from mtn_tpu_torch.train.loss import label_smoothed_kl, mtn_loss
from mtn_tpu_torch.train.schedule import NoamAdam, noam_rate
from mtn_tpu_torch.weights import (from_flax, opt_state_from_optax,
                                   opt_state_to_optax, optax_adam_fields)
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

PAD = 1
V = 37


def _logp(rng, *shape):
    x = rng.standard_normal(shape + (V,)).astype(np.float32) * 3
    return np.array(jax.nn.log_softmax(x, axis=-1))


def _targets(rng, *shape, all_pad=False):
    t = rng.integers(0, V, size=shape).astype(np.int32)
    t[..., -2:] = PAD
    if all_pad:
        t[:] = PAD
    return t


@pytest.mark.parametrize("smoothing", [0.1, 0.0, 0.3])
@pytest.mark.parametrize("all_pad", [False, True])
def test_label_smoothed_kl_matches_jax(smoothing, all_pad):
    rng = np.random.default_rng(0)
    logp, tgt = _logp(rng, 3, 9), _targets(rng, 3, 9, all_pad=all_pad)
    want = float(jloss.label_smoothed_kl(jnp.asarray(logp), jnp.asarray(tgt),
                                         PAD, smoothing))
    got = label_smoothed_kl(torch.from_numpy(logp), torch.from_numpy(tgt),
                            PAD, smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-5)
    if all_pad:
        assert float(got) == 0.0


def test_label_smoothed_kl_gradient_matches_jax():
    rng = np.random.default_rng(1)
    logp, tgt = _logp(rng, 4, 7), _targets(rng, 4, 7)
    want = np.asarray(jax.grad(lambda lp: jloss.label_smoothed_kl(
        lp, jnp.asarray(tgt), PAD, 0.1))(jnp.asarray(logp)))
    lp = torch.from_numpy(logp).requires_grad_()
    label_smoothed_kl(lp, torch.from_numpy(tgt), PAD, 0.1).backward()
    np.testing.assert_allclose(lp.grad.numpy(), want, atol=1e-7)


@pytest.mark.parametrize("case", ["plain", "norm", "all_pad"])
def test_mtn_loss_matches_jax(case):
    rng = np.random.default_rng(2)
    all_pad = case == "all_pad"
    resp, ans = _logp(rng, 2, 6), _targets(rng, 2, 6, all_pad=all_pad)
    aes = [_logp(rng, 2, 5) for _ in range(2)]
    src = _targets(rng, 2, 5, all_pad=all_pad)
    norm = (np.float32(17.0), np.float32(9.0)) if case == "norm" else None
    wl, wm = jloss.mtn_loss(jnp.asarray(resp), jnp.asarray(ans),
                            [jnp.asarray(a) for a in aes], jnp.asarray(src),
                            PAD, 0.1, 0.7,
                            norm=None if norm is None else
                            tuple(jnp.asarray(n) for n in norm))
    gl, gm = mtn_loss(torch.from_numpy(resp), torch.from_numpy(ans),
                      [torch.from_numpy(a) for a in aes],
                      torch.from_numpy(src), PAD, 0.1, 0.7,
                      norm=None if norm is None else
                      tuple(torch.tensor(n) for n in norm))
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
    for k in ("ntokens", "loss", "loss_x_ntok"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5,
                                   err_msg=k)
    if all_pad:
        assert float(gm["ntokens"]) == 1.0 and float(gl) == 0.0


@pytest.mark.parametrize("count", [0, 1, 99, 100, 999, 1000, 5000])
def test_noam_rate_matches_optax(count):
    """Update number ``count`` (from 0) takes reference step count + 1:
    steps 1 and 2, the warmup step, 10 × warmup, and past it."""
    want = float(jnoam(512, 100)(count))
    got = float(noam_rate(torch.tensor(count + 1.0), 512, 100))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _tree(rng, scale):
    return {"dec": {"w": (rng.standard_normal((4, 3)) * scale).astype(
        np.float32), "b": (rng.standard_normal(3) * scale).astype(
            np.float32)}, "emb": (rng.standard_normal((5, 2)) * scale
                                  ).astype(np.float32)}


@pytest.mark.parametrize("clip", [0.0, 0.5, 1e3])
def test_adam_matches_optax_for_five_steps(clip):
    """No clipping; a limit below the gradients' norm (clipped every step);
    a limit above it (never clipped)."""
    rng = np.random.default_rng(3)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, 2.0) for _ in range(5)]
    opt = make_optimizer(16, 4, grad_clip=clip)
    jstate = opt.init(params)
    jp = params
    for g in grads:
        upd, jstate = opt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    sd = from_flax(params)
    names = list(sd)
    tp = [sd[n].clone() for n in names]
    adam = NoamAdam(16, 4, grad_clip=clip)
    st = adam.init(tp)
    for g in grads:
        gd = from_flax(g)
        adam.prepare(st)
        adam.apply(tp, [gd[n].clone() for n in names], st)
        st.count += 1
    want = from_flax(jax.tree.map(np.asarray, jp))
    for n, t in zip(names, tp):
        np.testing.assert_allclose(t.numpy(), want[n].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    # the moments and count, through the optax bridge
    mu, nu, count = optax_adam_fields(jax.tree.map(np.asarray, jstate))
    carried = opt_state_from_optax(mu, nu, count)
    assert carried["count"] == st.count == 5
    for n, m, v in zip(names, st.mu, st.nu):
        np.testing.assert_allclose(m.numpy(), carried["mu"][n].numpy(),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(v.numpy(), carried["nu"][n].numpy(),
                                   rtol=1e-6, atol=1e-8)
    back_mu, back_nu, back_count = opt_state_to_optax(carried)
    assert int(back_count) == 5
    np.testing.assert_array_equal(back_mu["dec"]["w"],
                                  np.asarray(mu["dec"]["w"]))
    np.testing.assert_array_equal(back_nu["emb"], np.asarray(nu["emb"]))


def test_clip_is_not_clip_grad_norm():
    """Above the limit the result is g / norm · limit, not torch's
    g · limit / (norm + 1e-6)."""
    g = [torch.tensor([3.0, 4.0])]
    NoamAdam(16, 4, grad_clip=1.0).clip(g)
    np.testing.assert_array_equal(g[0].numpy(),
                                  np.float32([3.0, 4.0]) / np.float32(5.0))
