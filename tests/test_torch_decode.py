"""The port's per-sample box decode (``ops/cuda_decode.py``) and batched
channels-first forward (``models.yolov3.forward_cf``) against the JAX
package, on the CPU.

The box decode's plain version is held against the JAX package's Pallas
kernel in interpret mode (as tests/test_pallas.py runs it): elementwise
float32 math with sigmoid / exp / softmax / x·log(x) computed by two
libraries, and a division by the grid size where the Pallas kernel
multiplies by its reciprocal — a few ulp apart, so rtol 1e-5 / atol 1e-6;
the layer and prior id columns exactly.  ``forward_cf`` is held to the
tolerance of the float32 cases of test_torch_models.py (rtol / atol 1e-4:
75 stacked float32 convolutions summed in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant
from bayesian_yolov3_tpu.core.blueprint import VariantSpec as JSpec
from bayesian_yolov3_tpu.models import darknet as jdark
from bayesian_yolov3_tpu.models import yolov3 as jyolo
from bayesian_yolov3_tpu.ops import common as jcommon
from bayesian_yolov3_tpu.ops import pallas_decode

from bayesian_yolov3_torch.core.blueprint import Variant, VariantSpec
from bayesian_yolov3_torch.models import yolov3 as tyolo
from bayesian_yolov3_torch.ops import cuda_decode

import torch_parity as tp

DEC_TOL = dict(rtol=1e-5, atol=1e-6)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)


def _raws(seed, C, aleatoric, nb, hw, scale=2.0):
    r = np.random.default_rng(seed)
    chpp = 2 * (5 + C) if aleatoric else 5 + C
    raw = (r.standard_normal((3 * chpp, nb, hw)) * scale).astype(np.float32)
    priors = r.uniform(0.02, 0.5, (3, 2)).astype(np.float32)
    return raw, priors


def _assert_rows_match(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., -2:], want[..., -2:])  # layer, prior ids
    np.testing.assert_allclose(got[..., :-2], want[..., :-2], **DEC_TOL)


@pytest.mark.parametrize("shape", [(1, 2, 3), (3, 4, 8)], ids=["1x2x3", "3x4x8"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("aleatoric", [False, True], ids=["standard", "aleatoric"])
def test_box_decode_plain_matches_pallas(aleatoric, C, shape):
    nb, h, w = shape
    raw, priors = _raws(10 * C + nb, C, aleatoric, nb, h * w)
    want = np.asarray(pallas_decode.fused_box_decode_cf(
        jnp.asarray(raw), jnp.asarray(priors), h=h, w=w, cls_cnt=C, layer_id=2,
        aleatoric=aleatoric, interpret=True))
    got = cuda_decode.fused_box_decode_cf(
        torch.from_numpy(raw), torch.from_numpy(priors), h=h, w=w, cls_cnt=C,
        layer_id=2, aleatoric=aleatoric)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (nb, 3 * h * w, (14 if aleatoric else 7) + C)
    _assert_rows_match(got.numpy(), want)


@pytest.mark.parametrize("aleatoric", [False, True], ids=["standard", "aleatoric"])
def test_all_scales_matches_pallas(aleatoric):
    """Three scales of a 64x96 batch of 2: layer ids 0/1/2, priors by stride,
    rows concatenated layer-major."""
    C = 2
    jspec = JSpec(JVariant.ALEATORIC if aleatoric else JVariant.STANDARD, C)
    tspec = VariantSpec(Variant.ALEATORIC if aleatoric else Variant.STANDARD, C)
    outs_np, pri_np = [], {}
    for i, (stride, (h, w)) in enumerate(zip((32, 16, 8), ((2, 3), (4, 6), (8, 12)))):
        raw, pri_np[stride] = _raws(40 + i, C, aleatoric, 2, h * w)
        outs_np.append((raw, (h, w)))
    want = np.asarray(pallas_decode.fused_box_decode_all_scales(
        [(jnp.asarray(r), hw) for r, hw in outs_np], pri_np, spec=jspec, interpret=True))
    got = cuda_decode.fused_box_decode_all_scales(
        [(torch.from_numpy(r), hw) for r, hw in outs_np],
        {s: torch.from_numpy(p) for s, p in pri_np.items()}, spec=tspec).numpy()
    assert got.shape == (2, 3 * (6 + 24 + 96), tspec.decoded_width())
    _assert_rows_match(got, want)
    np.testing.assert_array_equal(np.unique(got[0, :, -2]), [0.0, 1.0, 2.0])


@pytest.mark.parametrize("C", [1, 2])
def test_saturated_logits_give_finite_entropies(C):
    """Objectness logits at +80 and one class logit at +80 against the
    others at -80 saturate the probabilities to exactly 1 and 0 in float32:
    both packages give objectness and class entropies of exactly 0 (no NaN
    from 0·log 0).  Objectness at -80 stays a normal float (1.8e-35) with an
    entropy of 1.4e-33, the same in both."""
    h, w, nb = 2, 3, 2
    raw, priors = _raws(7, C, True, nb, h * w, scale=1.0)
    chpp = 2 * (5 + C)
    r = np.random.default_rng(8)
    for b in range(3):
        raw[b * chpp + 8] = 80.0  # objectness
        winner = r.integers(0, C, (nb, h * w))
        for c in range(C):
            raw[b * chpp + 10 + c] = np.where(winner == c, 80.0, -80.0)
    raw[8, 1] = -80.0  # prior 0, image 1: objectness saturated to ~0
    want = np.asarray(pallas_decode.fused_box_decode_cf(
        jnp.asarray(raw), jnp.asarray(priors), h=h, w=w, cls_cnt=C, layer_id=0,
        aleatoric=True, interpret=True))
    got = cuda_decode.fused_box_decode_cf(
        torch.from_numpy(raw), torch.from_numpy(priors), h=h, w=w, cls_cnt=C,
        layer_id=0, aleatoric=True).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    _assert_rows_match(got, want)
    obj_ent, cls_ent = got[..., 10], got[..., 11 + C]
    assert (cls_ent == 0).all() and (want[..., 11 + C] == 0).all()
    assert (obj_ent[0] == 0).all() and (obj_ent[1, h * w:] == 0).all()
    assert (obj_ent[1, :h * w] > 0).all() and (obj_ent[1, :h * w] < 1e-30).all()
    np.testing.assert_array_equal(obj_ent, want[..., 10])


@pytest.mark.parametrize("case", ["wrong_chpp", "too_many_classes", "float64",
                                  "priors_elsewhere"])
def test_wrapper_refuses(case):
    raw, priors = _raws(3, 2, True, 1, 6)
    raw_t, pri_t = torch.from_numpy(raw), torch.from_numpy(priors)
    kw = dict(h=2, w=3, cls_cnt=2, layer_id=0, aleatoric=True)
    exc, match = ValueError, None
    if case == "wrong_chpp":
        kw["aleatoric"], match = False, "channels"
    elif case == "too_many_classes":
        raw_t = torch.zeros((3 * 2 * (5 + 9), 1, 6))
        kw["cls_cnt"], match = 9, "cls_cnt"
    elif case == "float64":
        raw_t, exc, match = raw_t.double(), TypeError, "float32"
    else:
        pri_t, match = pri_t.to("meta"), "different devices"
    with pytest.raises(exc, match=match):
        cuda_decode.fused_box_decode_cf(raw_t, pri_t, **kw)


# ---- forward_cf --------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """variant -> (jax params, jax stats, torch params, torch stats)."""
    out = {}
    for name in ("standard", "bayesian"):
        params_np, stats_np = tp.numpy_weights(seed=0, spec=JSpec(JVariant(name), 2))
        out[name] = (tp.to_jax(params_np), tp.to_jax(stats_np),
                     *tp.to_torch(params_np, stats_np))
    out["aleatoric"] = out["bayesian"]  # same head widths
    return out


@pytest.fixture(scope="module")
def imgs():
    return tp.image_u8(seed=2, nb=2).astype(np.float32) / 255.0


def _check_raws(got, want, nb=2):
    for (g, hw), w, stride in zip(got, want, (32, 16, 8)):
        assert hw == (64 // stride, 96 // stride)
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert tuple(g.shape) == w.shape == (w.shape[0], nb, hw[0] * hw[1])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


@pytest.mark.parametrize("variant,std_dropout", [
    ("standard", False), ("aleatoric", False), ("bayesian", True)])
def test_forward_cf_matches_jax(weights, imgs, variant, std_dropout):
    jparams, jstats, tparams, tstats = weights[variant]
    jspec, tspec = JSpec(JVariant(variant), 2), VariantSpec(Variant(variant), 2)
    want = jax.jit(lambda p, s, x: [r for r, _ in jyolo.forward_cf(
        p, s, x, spec=jspec, standard_test_dropout=std_dropout, fused_early=False)])(
            jparams, jstats, jnp.asarray(imgs))
    with torch.no_grad():
        got = tyolo.forward_cf(tparams, tstats, torch.from_numpy(imgs), spec=tspec,
                               standard_test_dropout=std_dropout)
    assert want[0].shape[0] == 3 * tspec.head_channels_per_prior
    _check_raws(got, want)


def test_forward_cf_bayesian_dropout_matches_jax(weights, imgs):
    """Dropout active (bayesian, no standard_test_dropout): one (1, 15) key
    table K drives the port's forward_cf and the JAX package's heads with
    ``fixed_site_keys=K[0]``, so the masks are bit-identical."""
    jparams, jstats, tparams, tstats = weights["bayesian"]
    jspec, tspec = JSpec(JVariant.BAYESIAN, 2), VariantSpec(Variant.BAYESIAN, 2)
    keys = tyolo._fixed_key_table(5, 1)

    def jax_fwd(p, s, x, k):
        out32, skip16, skip8, _ = jdark.darknet53(p["backbone"], s["backbone"], x,
                                                  fused_early=False)
        feats, _ = jyolo._heads(p, s, out32, skip16, skip8, spec=jspec, training=False,
                                dropout_active=True, fixed_site_keys=k,
                                return_features=True)
        return [jcommon.detection_conv_cf(p[f"det{i}"], f) for i, f in enumerate(feats, 1)]

    want = jax.jit(jax_fwd)(jparams, jstats, jnp.asarray(imgs), jnp.asarray(keys[0]))
    with torch.no_grad():
        got = tyolo.forward_cf(tparams, tstats, torch.from_numpy(imgs), spec=tspec, rng=keys)
        off = tyolo.forward_cf(tparams, tstats, torch.from_numpy(imgs), spec=tspec,
                               standard_test_dropout=True)
    _check_raws(got, want)
    assert not np.allclose(got[2][0].numpy(), off[2][0].numpy(), atol=1e-3)  # masks bite
    with pytest.raises(ValueError, match="Generator"):  # dropout needs keys
        tyolo.forward_cf(tparams, tstats, torch.from_numpy(imgs), spec=tspec)
