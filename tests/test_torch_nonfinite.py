"""Overflowing raws through the port and the JAX package, on the CPU.

A trained head can emit box-size logits and log-variances far past what
``exp`` keeps finite in float32 (88.7): the decoded box is then infinitely
wide and its aleatoric variance infinite, and a very negative height logit
gives a zero-height box.  Such rows reach NMS (where the IoU of a zero-area
or infinite box is NaN or 0) and the mAP.  Here seeded 64x96 raws with a
quarter of the anchors at size logits and log-variances of 80-120 (a few of
them with the height logit at -300..-150) go through both packages:

* the epistemic decode (T=8): the port's ``decode_epistemic_stats`` ->
  ``decode_bbox_epistemic`` against the JAX package's, and the plain
  versions of ``ops/cuda_epistemic.py`` and ``ops/cuda_moments.py``
  against the Pallas kernels in interpret mode (as tests/test_pallas.py
  runs them);
* the aleatoric box decode: the plain ``box_decode`` against
  ``pallas_decode.fused_box_decode_cf`` in interpret mode;
* ``nms_select`` and ``nms_select_batch`` at pre_top_k 0, 8192 and 40,
  with the certificate (whether the runner would retry);
* ``eval/parity.py:score`` and ``evaluate_detections`` on the selections,
  against the same ground truth.

Held: the masks of NaN, +inf and -inf equal; the finite values at the
decode tests' tolerances (tests/test_torch_epistemic.py,
tests/test_torch_decode.py); the NMS picks, valid flags, counts and
certificates equal; the mAP equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant
from bayesian_yolov3_tpu.core.blueprint import VariantSpec as JSpec
from bayesian_yolov3_tpu.eval.detection_metrics import evaluate_detections as j_evaluate
from bayesian_yolov3_tpu.ops import decode as jdecode
from bayesian_yolov3_tpu.ops import nms as jnms
from bayesian_yolov3_tpu.ops import pallas_decode
from bayesian_yolov3_tpu.ops.pallas_epistemic import (
    epistemic_finalize as j_finalize,
    epistemic_moments_cf as j_moments,
    fused_epistemic_decode_cf_batched as j_decode_cf_batched,
)

from bayesian_yolov3_torch.core.blueprint import Variant, VariantSpec
from bayesian_yolov3_torch.eval import parity
from bayesian_yolov3_torch.eval.detection_metrics import evaluate_detections
from bayesian_yolov3_torch.ops import cuda_decode, cuda_epistemic, cuda_moments, cuda_nms
from bayesian_yolov3_torch.ops import decode as tdecode
from bayesian_yolov3_torch.ops import nms as tnms

from test_accuracy_parity import _score as j_score

C = 2
T = 8  # >= 5: with fewer samples the 4x4 covariance is singular
NB = 2
HWS = ((2, 3), (4, 6), (8, 12))  # strides 32, 16, 8 of 64x96
SPEC = VariantSpec(Variant.BAYESIAN, C)
JSPEC = JSpec(JVariant.BAYESIAN, C)
OBJ = SPEC.obj_idx(epistemic=True)
MAX_OUT = 64
# the epistemic decode's columns (tests/test_torch_epistemic.py) and the box
# decode's (tests/test_torch_decode.py)
EPI_TOL = (((0, 12), 1e-4, 1e-5), ((12, 13), 1e-3, 1e-6), ((13, 21 + C), 1e-4, 2e-4))
BOX_TOL = (((0, 14 + C), 1e-5, 1e-6),)


def _overflowing(rng, raw, chpp, n_anchors, nan_cls=False):
    """On a seeded quarter of the (prior, anchor) pairs of ``raw`` (3*chpp,
    S, n_anchors), tw, th and the four log-variances at 80-120 in every
    sample; on a tenth of those th at -300..-150 (zero height).  Whole
    numbers: their squares and sums over 8 samples are exact in float32, so
    the covariance E[x x^T] - E[x] E[x]^T of logits near 100 carries no
    rounding that depends on the order of the sums (with fractional logits
    it keeps ~1e-3 of it, more than the decode tolerance of a small
    variance, in either package), and the columns compare at the decode
    tests' tolerances."""
    big = rng.random((3, n_anchors)) < 0.25
    flat = rng.random((3, n_anchors)) < 0.1
    x = raw.reshape(3, chpp, raw.shape[1], n_anchors)
    for b, a in zip(*np.nonzero(big)):
        x[b, 2:8, :, a] = rng.integers(80, 121, (6, raw.shape[1]))
        if flat[b, a]:
            x[b, 3, :, a] = rng.integers(-300, -149, raw.shape[1])
    # NaN in one sample's tx (NaN corners) of a few anchors and, with
    # ``nan_cls``, in one sample's first class logit (NaN class probabilities
    # and entropies) of a few others; the objectness stays finite
    for ch in (0, 10) if nan_cls else (0,):
        b, a = np.nonzero(rng.random((3, n_anchors)) < 0.03)
        x[b, ch, rng.integers(0, raw.shape[1], len(b)), a] = np.nan
    return raw


def _epistemic_raws(seed, nan_cls=False):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in HWS:
        raw = (rng.standard_normal((3 * 2 * (5 + C), T, NB * h * w)) * 2).astype(np.float32)
        out.append(_overflowing(rng, raw, 2 * (5 + C), NB * h * w, nan_cls))
    priors = [rng.uniform(0.02, 0.5, (3, 2)).astype(np.float32) for _ in HWS]
    return out, priors


def _assert_same(got, want, tol):
    """Equal NaN / +inf / -inf masks; finite values within ``tol``."""
    assert got.shape == want.shape
    for f in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(f(got), f(want), err_msg=f.__name__)
    fin = np.isfinite(want)
    for (lo, hi), rtol, atol in tol:
        m = fin[..., lo:hi]
        np.testing.assert_allclose(got[..., lo:hi][m], want[..., lo:hi][m], rtol=rtol, atol=atol,
                                   err_msg=f"columns {lo}:{hi}")


@pytest.fixture(scope="module")
def epistemic():
    """Both packages' epistemic rows of the three scales, concatenated:
    (NB, 378, 23) each, with the raws and priors."""
    raws, priors = _epistemic_raws(5)
    kw = dict(n_imgs=NB, cls_cnt=C)
    port = torch.cat([cuda_epistemic.fused_epistemic_decode_cf_batched(
        torch.from_numpy(r), torch.from_numpy(p), h=h, w=w, layer_id=i, **kw)
        for i, (r, p, (h, w)) in enumerate(zip(raws, priors, HWS))], dim=1).numpy()
    jax_rows = np.concatenate([np.asarray(j_decode_cf_batched(
        jnp.asarray(r), jnp.asarray(p), h=h, w=w, layer_id=i, interpret=True, **kw))
        for i, (r, p, (h, w)) in enumerate(zip(raws, priors, HWS))], axis=1)
    return {"raws": raws, "priors": priors, "port": port, "jax": jax_rows}


def test_epistemic_raws_overflow(epistemic):
    """The inputs do what they are for: infinite widths and aleatoric
    variances, zero heights, on both sides."""
    rows = epistemic["jax"]
    assert np.isposinf(rows[..., 3]).sum() > 20 and np.isposinf(rows[..., 8:12]).any()
    assert ((rows[..., 2] == rows[..., 0]) & np.isinf(rows[..., 3])).any()
    assert np.isfinite(rows[..., OBJ]).all()


def test_epistemic_decode_plain_matches_pallas(epistemic):
    _assert_same(epistemic["port"], epistemic["jax"], EPI_TOL)


def _jax_unfused(raw, priors, layer_id):
    """The JAX package's unfused epistemic decode of (T, NB, h, w, ch) raws."""
    det = jdecode.split_detection(raw, JSPEC)
    rows = jdecode.decode_bbox_epistemic(jdecode.decode_epistemic_stats(det), priors, layer_id)
    return jdecode.concat_all_scales_batched([rows])


def test_epistemic_stats_match_jax_unfused():
    """split_detection -> decode_epistemic_stats -> decode_bbox_epistemic of
    both packages, per scale, over the batch; here also with NaN class
    logits, whose probabilities give NaN entropies through ``xlogy`` in both
    packages' plain paths.  (The JAX package's Pallas decode, moments and
    box decode kernels take x log x as 0 wherever p > 0 fails, so NaN
    entropies become 0 there: the Pallas comparisons above feed no NaN class
    logit.)"""
    raws, priors = _epistemic_raws(7, nan_cls=True)
    for i, (raw_cf, pri, (h, w)) in enumerate(zip(raws, priors, HWS)):
        raw = np.ascontiguousarray(raw_cf.reshape(-1, T, NB, h, w).transpose(1, 2, 3, 4, 0))
        want = np.asarray(jax.jit(_jax_unfused, static_argnums=2)(jnp.asarray(raw),
                                                                   jnp.asarray(pri), i))
        det = tdecode.split_detection(torch.from_numpy(raw), SPEC)
        got = tdecode.decode_bbox_epistemic(tdecode.decode_epistemic_stats(det),
                                            torch.from_numpy(pri), layer_id=i)
        assert np.isnan(want[..., 19]).any()  # a NaN class entropy
        _assert_same(tdecode.concat_all_scales_batched([got]).numpy(), want, EPI_TOL)


def test_moments_and_finalize_plain_match_pallas(epistemic):
    """The mc path's pair: partial sums over T, then the finalize."""
    for i, (raw_cf, pri, (h, w)) in enumerate(zip(epistemic["raws"], epistemic["priors"], HWS)):
        sums_t = cuda_moments.epistemic_moments_cf(torch.from_numpy(raw_cf), cls_cnt=C)
        sums_j = np.asarray(j_moments(jnp.asarray(raw_cf), cls_cnt=C, interpret=True))
        _assert_same(sums_t.numpy(), sums_j, (((0, 21 + C), 1e-5, 1e-4),))
        kw = dict(T=T, h=h, w=w, cls_cnt=C, layer_id=i, n_imgs=NB)
        got = cuda_moments.epistemic_finalize(sums_t, torch.from_numpy(pri), **kw).numpy()
        want = np.asarray(j_finalize(jnp.asarray(sums_j), jnp.asarray(pri), interpret=True,
                                     **kw))
        _assert_same(got, want, EPI_TOL)


def test_aleatoric_box_decode_plain_matches_pallas():
    rng = np.random.default_rng(6)
    chpp = 2 * (5 + C)
    for i, (h, w) in enumerate(HWS):
        raw = (rng.standard_normal((3 * chpp, NB, h * w)) * 2).astype(np.float32)
        raw = _overflowing(rng, raw.reshape(3 * chpp, 1, NB * h * w), chpp, NB * h * w)
        raw = raw.reshape(3 * chpp, NB, h * w)
        pri = rng.uniform(0.02, 0.5, (3, 2)).astype(np.float32)
        kw = dict(h=h, w=w, cls_cnt=C, layer_id=i, aleatoric=True)
        want = np.asarray(pallas_decode.fused_box_decode_cf(
            jnp.asarray(raw), jnp.asarray(pri), interpret=True, **kw))
        got = cuda_decode.fused_box_decode_cf(torch.from_numpy(raw), torch.from_numpy(pri),
                                              **kw).numpy()
        assert np.isposinf(want[..., 4:9]).any() and np.isposinf(want[..., 3]).any()
        _assert_same(got, want, BOX_TOL)


def _with_nan(rows, column, share, seed):
    """A copy of ``rows`` with ``column`` NaN in a seeded ``share`` of the
    rows of image 0: a NaN corner makes every IoU with its box NaN, which
    suppresses nothing; a NaN score leaves its image no pick (the JAX
    package's argmax lands on it, and its step picks nothing)."""
    rows = rows.copy()
    nan = np.random.default_rng(seed).random(rows.shape[1]) < share
    rows[0, nan, column] = np.nan
    return rows


def _select(rows, pre_top_k, batch):
    """Both packages' certified NMS of the same rows: (port, jax), each
    (rows, valid, count, cert) as numpy."""
    kw = dict(max_out=MAX_OUT, pre_top_k=pre_top_k, with_certificate=True)
    if batch:
        t = tnms.nms_select_batch(torch.from_numpy(rows), OBJ, **kw)
        j = jnms.nms_select_batch(jnp.asarray(rows), OBJ, **kw)
    else:
        t = tnms.nms_select(torch.from_numpy(rows[0]), OBJ, **kw)
        j = jnms.nms_select(jnp.asarray(rows[0]), OBJ, **kw)
    return [x.numpy() for x in t], [np.asarray(x) for x in j]


def _assert_same_selection(got, want):
    rows_t, valid_t, count_t, cert_t = got
    rows_j, valid_j, count_j, cert_j = want
    np.testing.assert_array_equal(valid_t, valid_j)
    np.testing.assert_array_equal(count_t, count_j)
    np.testing.assert_array_equal(cert_t, cert_j)
    # the same picks: the selected rows are the same rows of the input, bit for bit
    np.testing.assert_array_equal(rows_t, rows_j)


@pytest.mark.parametrize("batch", [False, True], ids=["nms_select", "nms_select_batch"])
@pytest.mark.parametrize("pre_top_k", [0, 8192, 40])
@pytest.mark.parametrize("case", ["overflow", "nan_y0", "nan_score"])
def test_nms_same_picks_on_overflowing_rows(epistemic, pre_top_k, batch, case):
    """Both NMS on the same rows (the port's decode): infinite and
    zero-height boxes, NaN corners of the NaN tx logits, and more NaN y0
    corners or a few NaN scores in image 0."""
    rows = epistemic["port"]
    if case == "nan_y0":
        rows = _with_nan(rows, 0, 0.25, 3)
    elif case == "nan_score":
        rows = _with_nan(rows, OBJ, 0.02, 4)
    got, want = _select(rows, pre_top_k, batch)
    _assert_same_selection(got, want)
    picked = got[0][got[1]]
    if case == "nan_score":  # image 0 picks nothing
        assert np.atleast_1d(got[2])[0] == 0 and got[2].sum() == got[1].sum()
    else:
        assert np.isinf(picked[:, :4]).any()
        assert case != "nan_y0" or np.isnan(picked[:, 0]).any()
    if pre_top_k == 40:  # fewer candidates than max_out: no certificate, a retry
        assert not np.asarray(got[3]).any()


@pytest.mark.parametrize("case", ["overflow", "nan_y0", "nan_score"])
def test_kernel_algorithm_same_picks(epistemic, case):
    """``greedy_nms_chunked`` (the CUDA kernels' sorted chunked scan in plain
    PyTorch) at a chunk of 64, so picks cross chunks, against the greedy
    loop on the same rows: the selection rules hold on these rows too."""
    rows = epistemic["port"]
    if case == "nan_y0":
        rows = _with_nan(rows, 0, 0.25, 3)
    elif case == "nan_score":
        rows = _with_nan(rows, OBJ, 0.02, 4)
    boxes = torch.from_numpy(np.ascontiguousarray(rows[..., :4]))
    scores = torch.from_numpy(np.ascontiguousarray(rows[..., OBJ]))
    want = cuda_nms.greedy_nms_plain(boxes, scores, MAX_OUT)
    got = cuda_nms.greedy_nms_chunked(boxes, scores, MAX_OUT, chunk=64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _ground_truth(rows, valid):
    """Per image: two finite selected boxes of the port's selection (labels
    1 and 2) and one box away from them."""
    gt = {}
    for b in range(rows.shape[0]):
        r = rows[b][valid[b]]
        fin = r[np.isfinite(r[:, :4]).all(axis=1)]
        boxes = np.concatenate([fin[:2, :4], [[0.1, 0.1, 0.3, 0.2]]]).astype(np.float32)
        gt[b] = (boxes, np.array([1, 2, 1]))
    return gt


def test_pipeline_mAP_matches_jax(epistemic):
    """Each package's decoded rows through its own certified NMS (batch,
    pre_top_k 40, so the certificate fails and the exact retry runs), then its
    ``score`` and ``evaluate_detections`` against one ground truth: equal
    picks, equal mAP and LAMR."""
    sel = {}
    for name, rows, mod, as_array in (("port", epistemic["port"], tnms, torch.from_numpy),
                                      ("jax", epistemic["jax"], jnms, jnp.asarray)):
        out = mod.nms_select_batch(as_array(rows), OBJ, max_out=MAX_OUT, pre_top_k=40,
                                   with_certificate=True)
        if not bool(np.asarray(out[3]).all()):
            out = mod.nms_select_batch(as_array(rows), OBJ, max_out=MAX_OUT)
        sel[name] = [np.asarray(x) for x in out[:2]]
    np.testing.assert_array_equal(sel["port"][1], sel["jax"][1])
    _assert_same(sel["port"][0], sel["jax"][0], EPI_TOL)
    gt = _ground_truth(*sel["port"])
    by_img = {name: {b: (s[0][b], s[1][b]) for b in range(NB)} for name, s in sel.items()}
    preds_t, var_t = parity.score(by_img["port"], SPEC)
    preds_j, var_j = j_score(by_img["jax"], JSPEC)
    for b in range(NB):
        assert np.isinf(preds_t[b][0]).any()  # infinite boxes are scored
        np.testing.assert_array_equal(preds_t[b][2], preds_j[b][2])
        _assert_same(np.asarray(var_t[b]), np.asarray(var_j[b]), (((0, 10), 1e-4, 1e-5),))
    m_t = evaluate_detections(preds_t, gt, [1, 2])
    m_j = j_evaluate(preds_j, gt, [1, 2])
    assert m_t["mAP"] == m_j["mAP"] and 0.0 < m_t["mAP"] < 1.0
    for c in (1, 2):
        assert m_t["per_class"][c] == m_j["per_class"][c]
