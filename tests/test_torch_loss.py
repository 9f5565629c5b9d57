"""The port's training loss (``ops/loss.py``) against the JAX package's, on
the same numpy-seeded detections and targets."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_yolov3_tpu.ops import loss as jl

from bayesian_yolov3_torch.ops import loss as tl

import torch_parity as tp

RTOL = 1e-6  # float32 sums of a few hundred terms in two orders


def _det_gt(rng, b=2, h=3, w=4, B=3, C=2):
    det = {
        "loc": rng.standard_normal((b, h, w, B, 4)).astype(np.float32),
        "obj": (rng.standard_normal((b, h, w, B)) * 3).astype(np.float32),
        "cls": rng.standard_normal((b, h, w, B, C)).astype(np.float32),
        "log_loc_var": (rng.standard_normal((b, h, w, B, 4)) * 30).astype(np.float32),
        "log_obj_stddev": rng.standard_normal((b, h, w, B)).astype(np.float32),
        "log_cls_stddev": rng.standard_normal((b, h, w, B, C)).astype(np.float32),
    }
    gt = {
        "loc": rng.standard_normal((b, h, w, B, 4)).astype(np.float32),
        "obj": (rng.uniform(0, 1, (b, h, w, B)) < 0.3).astype(np.float32),
        "cls": rng.integers(0, C, (b, h, w, B)).astype(np.int32),
        "ign": (rng.uniform(0, 1, (b, h, w, B)) < 0.9).astype(np.float32),
    }
    return det, gt


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("aleatoric", [False, True])
def test_detection_layer_loss_matches_jax(rng, aleatoric):
    det, gt = _det_gt(rng)
    want = jl.detection_layer_loss(_j(det), _j(gt), aleatoric_loss=aleatoric)
    got = tl.detection_layer_loss(_t(det), _t(gt), aleatoric_loss=aleatoric)
    for k in ("loc", "obj", "cls"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)


def test_bce_and_softmax_ce_match_jax(rng):
    logits = (rng.standard_normal(200) * 20).astype(np.float32)
    logits[:3] = [0.0, 90.0, -90.0]
    labels = (rng.uniform(0, 1, 200) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tl.sigmoid_bce_with_logits(torch.from_numpy(labels), torch.from_numpy(logits)).numpy(),
        np.asarray(jl.sigmoid_bce_with_logits(jnp.asarray(labels), jnp.asarray(logits))),
        rtol=RTOL, atol=1e-7)
    cl = (rng.standard_normal((50, 4)) * 5).astype(np.float32)
    ci = rng.integers(-1, 5, 50).astype(np.int32)  # out-of-range labels give 0
    np.testing.assert_allclose(
        tl.sparse_softmax_ce_with_logits(torch.from_numpy(ci), torch.from_numpy(cl)).numpy(),
        np.asarray(jl.sparse_softmax_ce_with_logits(jnp.asarray(ci), jnp.asarray(cl))),
        rtol=RTOL, atol=1e-7)


def test_bce_gradient_at_zero():
    """softplus(x) - x*z has the gradient sigmoid(x) - z at x == 0 (TF's
    max/abs form has a zero subgradient there)."""
    x = torch.zeros(3, requires_grad=True)
    tl.sigmoid_bce_with_logits(torch.zeros(3), x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 0.5, rtol=1e-6)
    x = torch.zeros(3, requires_grad=True)
    tl.sigmoid_bce_with_logits(torch.ones(3), x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), -0.5, rtol=1e-6)


def test_l2_regularization_scope_and_total_loss(rng):
    """L2 over every conv kernel (the frozen backbone's too) and the det
    biases, not BN: the bayesian model's numpy weights in both packages;
    then ``total_loss`` over three scales, its six metrics."""
    params_np, stats_np = tp.numpy_weights(seed=3)
    tparams, _ = tp.to_torch(params_np, stats_np)
    jparams = tp.to_jax(params_np)
    want = float(jax.jit(jl.l2_regularization)(jparams))
    np.testing.assert_allclose(float(tl.l2_regularization(tparams)), want, rtol=RTOL)
    # BN gamma / beta do not enter
    tparams["head1_conv0"]["gamma"] = tparams["head1_conv0"]["gamma"] * 100.0
    np.testing.assert_allclose(float(tl.l2_regularization(tparams)), want, rtol=RTOL)

    scales = [_det_gt(rng, h=h, w=w) for h, w in ((2, 3), (4, 6), (8, 12))]
    jtotal = jax.jit(jl.total_loss, static_argnums=3)
    for aleatoric in (False, True):
        jt, jm = jtotal([_j(d) for d, _ in scales], [_j(g) for _, g in scales], jparams,
                        aleatoric)
        tt, tm = tl.total_loss([_t(d) for d, _ in scales], [_t(g) for _, g in scales],
                               tparams, aleatoric)
        assert set(tm) == set(jm) == {"loc", "obj", "cls", "detection", "l2_weight_reg",
                                      "total"}
        np.testing.assert_allclose(float(tt), float(jt), rtol=RTOL)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL, err_msg=k)


def test_kendall_losses_under_injected_normals(rng):
    """The disabled logit-sampling losses, fed JAX's own normal draws."""
    det, gt = _det_gt(rng, b=1, h=2, w=2)
    T = 8
    ko, kc = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    eps_o = np.asarray(jax.random.normal(ko, (T, *det["obj"].shape)))
    eps_c = np.asarray(jax.random.normal(kc, (T, *det["cls"].shape)))
    want_o = jl.aleatoric_obj_loss(_j(det), _j(gt), ko, T=T)
    want_c = jl.aleatoric_cls_loss(_j(det), _j(gt), kc, T=T)
    got_o = tl.aleatoric_obj_loss(_t(det), _t(gt), torch.from_numpy(np.array(eps_o)))
    got_c = tl.aleatoric_cls_loss(_t(det), _t(gt), torch.from_numpy(np.array(eps_c)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-6)
