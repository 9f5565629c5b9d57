"""Epistemic decode of the PyTorch port (the plain version that the CUDA
kernel is held against on the card) against the JAX package: the Pallas
kernel in interpret mode and the unfused ``decode_*`` path.

Tolerances, from the JAX package's own kernel test (tests/test_pallas.py):
float32 sums over T run in another order, so columns are held to rtol 1e-4
(atol 1e-5 box/variance columns, 2e-4 entropy columns, whose x*log(x) terms
cancel); the covariance determinant (column 12) is a difference of
products of near-equal numbers and gets rtol 1e-3, atol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayesian_yolov3_tpu.core.blueprint import Variant, VariantSpec
from bayesian_yolov3_tpu.ops import decode as jdecode
from bayesian_yolov3_tpu.ops.pallas_epistemic import (
    fused_epistemic_decode_cf as j_decode_cf,
    fused_epistemic_decode_cf_batched as j_decode_cf_batched,
)
from bayesian_yolov3_torch.ops import cuda_epistemic as tce
from bayesian_yolov3_torch.ops import decode as tdecode

C = 2
PRIORS = np.array([[0.3, 0.1], [0.15, 0.05], [0.08, 0.02]], np.float32)
SPEC = VariantSpec(Variant.BAYESIAN, C)


def _assert_rows_close(got, want):
    np.testing.assert_allclose(got[..., :12], want[..., :12], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[..., 12], want[..., 12], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got[..., 13:], want[..., 13:], rtol=1e-4, atol=2e-4)


def _raw_cf(rng, T, nb, h, w, scale=1.0):
    return (rng.standard_normal((3 * 2 * (5 + C), T, nb * h * w)) * scale).astype(np.float32)


@pytest.mark.parametrize("nb,h,w,T", [(1, 2, 3, 4), (2, 4, 8, 7), (1, 5, 7, 6)])
def test_plain_decode_matches_pallas_interpret(rng, nb, h, w, T):
    raw_cf = _raw_cf(rng, T, nb, h, w)
    want = np.asarray(j_decode_cf_batched(
        jnp.asarray(raw_cf), jnp.asarray(PRIORS), n_imgs=nb, h=h, w=w,
        cls_cnt=C, layer_id=2, interpret=True))
    got = tce.fused_epistemic_decode_cf_batched(
        torch.from_numpy(raw_cf), torch.from_numpy(PRIORS), n_imgs=nb, h=h, w=w,
        cls_cnt=C, layer_id=2)
    assert got.shape == want.shape == (nb, 3 * h * w, 21 + C)
    _assert_rows_close(got.numpy(), want)
    # ids are exact: layer id, then prior id in prior-major row order
    np.testing.assert_array_equal(got.numpy()[..., 21], 2.0)
    np.testing.assert_array_equal(got.numpy()[0, :, 22], np.repeat([0.0, 1.0, 2.0], h * w))


@pytest.mark.parametrize("nb", [1, 2])
def test_plain_decode_matches_jax_unfused_path(rng, nb):
    """Against split_detection -> decode_epistemic_stats ->
    decode_bbox_epistemic -> concat of the JAX package, per image."""
    T, h, w = 5, 4, 6
    raw_cf = _raw_cf(rng, T, nb, h, w)
    got = tce.epistemic_decode_plain(
        torch.from_numpy(raw_cf), torch.from_numpy(PRIORS), n_imgs=nb, h=h, w=w,
        cls_cnt=C, layer_id=1).numpy()
    raw = raw_cf.reshape(-1, T, nb, h, w).transpose(1, 2, 3, 4, 0)  # (T,NB,h,w,ch)
    for b in range(nb):
        det = jdecode.split_detection(jnp.asarray(raw[:, b]), SPEC)
        stats = jdecode.decode_epistemic_stats(det)
        rows = jdecode.decode_bbox_epistemic(stats, jnp.asarray(PRIORS), layer_id=1)
        _assert_rows_close(got[b], np.asarray(jdecode.concat_all_scales([rows])))


def test_single_image_wrapper_layout(rng):
    T, h, w = 6, 4, 5  # T >= 5: with fewer the 4x4 covariance is singular
    raw_cf = _raw_cf(rng, T, 1, h, w)
    want = np.asarray(j_decode_cf(jnp.asarray(raw_cf), jnp.asarray(PRIORS), h=h, w=w,
                                  cls_cnt=C, layer_id=0, interpret=True))
    got = tce.fused_epistemic_decode_cf(torch.from_numpy(raw_cf), torch.from_numpy(PRIORS),
                                        h=h, w=w, cls_cnt=C, layer_id=0)
    assert got.shape == want.shape == (h, w, 3, 21 + C)
    _assert_rows_close(got.numpy(), want)


def test_saturated_logits_give_finite_entropies(rng):
    """Logits of +-100 saturate sigmoid/softmax to exactly 0/1 in float32;
    x*log(x) must be exactly 0 there, not NaN."""
    T, h, w = 4, 2, 3
    raw_cf = _raw_cf(rng, T, 1, h, w)
    x = raw_cf.reshape(3, 14, T, h * w)
    x[:, 8] = np.where(rng.random((3, T, h * w)) < 0.5, -100.0, 100.0)  # obj
    x[:, 10] = 100.0  # cls 0
    x[:, 11] = -100.0  # cls 1
    got = tce.fused_epistemic_decode_cf_batched(
        torch.from_numpy(raw_cf), torch.from_numpy(PRIORS), n_imgs=1, h=h, w=w,
        cls_cnt=C, layer_id=0).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[..., 17], 1.0)  # cls mean
    np.testing.assert_array_equal(got[..., 19:21], 0.0)  # cls MI, cls entropy
    want = np.asarray(j_decode_cf_batched(
        jnp.asarray(raw_cf), jnp.asarray(PRIORS), n_imgs=1, h=h, w=w,
        cls_cnt=C, layer_id=0, interpret=True))
    _assert_rows_close(got, want)


def test_xlogx_and_entropies_match_jax(rng):
    p = np.concatenate([[0.0, 1.0, 1e-30, 0.5], rng.random(20)]).astype(np.float32)
    np.testing.assert_array_equal(tdecode._xlogx(torch.tensor([0.0])).numpy(), [0.0])
    np.testing.assert_allclose(tdecode.logistic_entropy(torch.from_numpy(p)).numpy(),
                               np.asarray(jdecode.logistic_entropy(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-7)
    q = rng.random((6, 3)).astype(np.float32)
    q /= q.sum(-1, keepdims=True)
    np.testing.assert_allclose(tdecode.softmax_entropy(torch.from_numpy(q)).numpy(),
                               np.asarray(jdecode.softmax_entropy(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("variant", [Variant.STANDARD, Variant.ALEATORIC])
def test_per_sample_decoders_match_jax(rng, variant):
    """The standard / aleatoric decoders came along with ops/decode.py."""
    spec = VariantSpec(variant, C)
    raw = rng.standard_normal((2, 4, 5, 3 * spec.head_channels_per_prior)).astype(np.float32)
    jd = jdecode.split_detection(jnp.asarray(raw), spec)
    td = tdecode.split_detection(torch.from_numpy(raw), spec)
    if variant == Variant.STANDARD:
        want = jdecode.decode_bbox_standard(jd, jnp.asarray(PRIORS), layer_id=1)
        got = tdecode.decode_bbox_standard(td, torch.from_numpy(PRIORS), layer_id=1)
    else:
        want = jdecode.decode_bbox_aleatoric(jd, jnp.asarray(PRIORS), layer_id=1)
        got = tdecode.decode_bbox_aleatoric(td, torch.from_numpy(PRIORS), layer_id=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tdecode.concat_all_scales_batched([got]).numpy(),
        np.asarray(jdecode.concat_all_scales_batched([want])), rtol=1e-5, atol=1e-6)


def test_wrapper_refuses_what_the_kernel_does_not_take(rng):
    raw = torch.from_numpy(_raw_cf(rng, 2, 1, 2, 2))
    pri = torch.from_numpy(PRIORS)
    kw = dict(n_imgs=1, h=2, w=2, layer_id=0)
    with pytest.raises(TypeError):
        tce.fused_epistemic_decode_cf_batched(raw.double(), pri, cls_cnt=C, **kw)
    with pytest.raises(ValueError, match="channels"):
        tce.fused_epistemic_decode_cf_batched(raw, pri, cls_cnt=3, **kw)
    with pytest.raises(ValueError, match="anchor axis"):
        tce.fused_epistemic_decode_cf_batched(raw, pri, cls_cnt=C, n_imgs=2, h=2, w=2, layer_id=0)
    big = torch.zeros(3 * 2 * (5 + 9), 2, 4)
    with pytest.raises(ValueError, match="outside"):
        tce.fused_epistemic_decode_cf_batched(big, pri, cls_cnt=9, **kw)
    before = tce.launch_count
    tce.fused_epistemic_decode_cf_batched(raw, pri, cls_cnt=C, **kw)
    assert tce.launch_count == before  # a CPU tensor launches no kernel
