"""The port's accuracy-parity harness (``eval/parity.py``) against the JAX
package's (tests/test_accuracy_parity.py), on the CPU.

The end-to-end case trains the bayesian variant in the port on JAX's
recipe (64x96, 2 images, 3 boxes, unfrozen float32 steps at lr 3e-3), then
runs the same weights, images and masks through the port's bf16
``InferenceRunner.predict`` (the kernels' plain versions) and the port's
f32 reference-strategy twin, and through the JAX package's bf16
``InferenceRunner.predict`` (its XLA path) and its f32 twin
(``convert.params_to_jax``).  The masks are equal by construction: every
pipeline takes the constant key table of ``fixed_mc_masks`` (numpy Philox,
the same table in both packages).  Held: a non-vacuous twin (mAP > 0.05, a
confident detection in each image); |dmAP| <= 1e-3 between the port's two
pipelines (the contract) and between the port's and JAX's production
pipelines; LAMR within 1e-2; the twins' rows at tests/test_torch_runner.py's
float32 bounds; the two bf16 pipelines' rows at its bf16 bounds and their
confident matches' variance columns within 0.35.  The variance columns of
bf16 against f32 are held within twice JAX's own delta on the same weights:
exp(log variance) amplifies each sample's bf16 rounding, and on these
weights JAX's own bf16 pipeline moves a confident detection's aleatoric
variance by more than the 0.35 of its test.

Steps: 300, where JAX's recipe takes 150.  The port's training step is
JAX's: in float64 the two agree step after step on this recipe's training
(tests/test_torch_train.py::test_unfrozen_adam_steps_match_jax_in_float64:
four unfrozen Adam steps at lr 3e-3 with dropout and carried statistics,
every leaf within 3.3e-11).  What a run reaches is then set by its draws
(init, flips, dropout keys), which the packages make from different
generators, and by float32 rounding.  Over training seeds 0-7
(tests/parity_seed_study.py; seed 0 run twice in each package, bit-equal)
the twin is non-vacuous after 150 steps for 5 of 8 JAX runs and 2 of 8
port runs, seed 0's port run not among them, and after 300 steps for 2 of
8 JAX runs and 7 of 8 port runs.  Neither count serves both packages; this
test needs non-vacuous port weights, and holds JAX's pipelines to the port's
on those same weights.  Why the two packages' outcomes move apart with the
step count is an open question (PERF.md section 7).

One CPU training step of the full-width model takes about 1.7 s on the
suite's two torch threads (the 62 M-parameter Adam update and the weight
gradients of the deep 3x3 convs dominate at 64x96), so the 300 steps take
about 9 min: that case is marked slow.  The harness's parts are held
against the JAX package's here unmarked."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_yolov3_tpu.config import Config as JConfig
from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant
from bayesian_yolov3_tpu.core.blueprint import VariantSpec as JVariantSpec
from bayesian_yolov3_tpu.core.priors import priors_as_array as jpriors_as_array
from bayesian_yolov3_tpu.eval.detection_metrics import evaluate_detections as j_evaluate
from bayesian_yolov3_tpu.infer.runner import InferenceRunner as JRunner
from bayesian_yolov3_tpu.models.yolov3 import YoloV3 as JYoloV3
from bayesian_yolov3_tpu.ops import decode as jdecode
from bayesian_yolov3_tpu.ops import nms as jnms

from bayesian_yolov3_torch import convert
from bayesian_yolov3_torch.config import Config
from bayesian_yolov3_torch.eval import parity
from bayesian_yolov3_torch.infer import InferenceRunner
from bayesian_yolov3_torch.models.yolov3 import YoloV3, _fixed_key_table, init_yolov3

import parity_fullres_torch
import torch_parity as tp
from test_accuracy_parity import _score as j_score
from test_torch_runner import _assert_rows_close, _match_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = (64, 96, 3)
T = 8
STEPS = 300  # JAX's recipe takes 150: see the module's docstring
N_IMAGES = 2
N_BOXES = 3
MASKS = 99  # the fixed_mc_masks seed of every pipeline here
SPEC = tp.SPEC


def _overfit_batch(rng):
    """JAX's inputs for the recipe (tests/test_accuracy_parity.py:66-78):
    uniform images, boxes of 0.2-0.45 at 0.05-0.5, labels 0/1."""
    imgs = rng.uniform(0, 1, (N_IMAGES, *IMG)).astype(np.float32)
    yx = rng.uniform(0.05, 0.5, (N_IMAGES, N_BOXES, 2)).astype(np.float32)
    hw = rng.uniform(0.2, 0.45, (N_IMAGES, N_BOXES, 2)).astype(np.float32)
    bbox = np.concatenate([yx, np.minimum(yx + hw, 0.98)], axis=2)
    label = rng.integers(0, 2, (N_IMAGES, N_BOXES)).astype(np.int32)
    return {"image": (imgs * 255).astype(np.uint8), "bbox": bbox, "label": label,
            "valid": np.ones((N_IMAGES, N_BOXES), bool)}


def _infer_kw(dtype):
    return dict(model="bayesian", full_img_size=IMG, T=T, inference_mode=True,
                compute_dtype=dtype, darknet53_weights="", nms_max_boxes=parity.MAX_OUT,
                fixed_mc_masks=MASKS)


def _random_rows(rng, n=40):
    rows = rng.uniform(0, 1, (n, 23)).astype(np.float32)
    rows[:, 2:4] = rows[:, 0:2] + rng.uniform(0.05, 0.3, (n, 2)).astype(np.float32)
    return rows, rng.uniform(size=n) < 0.7


def test_score_matches_jax(rng):
    rows_by_img = {b: _random_rows(rng) for b in range(3)}
    got_p, got_v = parity.score(rows_by_img, SPEC)
    want_p, want_v = j_score(rows_by_img, JVariantSpec(JVariant.BAYESIAN, 2))
    for b in rows_by_img:
        for g, w in zip(got_p[b], want_p[b]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got_v[b], want_v[b])


def test_batch_statistics_is_the_algebraic_recovery(rng):
    """b = (s' - 0.99 s) / 0.01 on every leaf, var clamped at 1e-8 — on the
    model's statistics tree, with some variances recovered negative."""
    _, stats = init_yolov3(torch.Generator().manual_seed(0), SPEC)
    before_np = {n: {k: rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                     for k, v in leaf.items()} for n, leaf in _flat_stats(stats).items()}
    after_np = {n: {k: v * np.float32(0.99) + rng.normal(0, 0.02, v.shape).astype(np.float32)
                    for k, v in leaf.items()} for n, leaf in before_np.items()}
    got = parity.batch_statistics(_tensors(before_np), _tensors(after_np))
    n_clamped = 0
    for n, leaf in before_np.items():
        for k, old in leaf.items():
            want = (after_np[n][k] - np.float32(0.99) * old) / np.float32(0.01)
            if k == "var":
                n_clamped += int((want < 1e-8).sum())
                want = np.maximum(want, np.float32(1e-8))
            np.testing.assert_allclose(got[n][k].numpy(), want, rtol=1e-6, atol=1e-6)
    assert n_clamped > 0  # the clamp was exercised


def _flat_stats(stats, prefix=""):
    out = {}
    for k, v in stats.items():
        if "mean" in v:
            out[prefix + k] = v
        else:
            out.update(_flat_stats(v, f"{prefix}{k}/"))
    return out


def _tensors(tree):
    return {n: {k: torch.from_numpy(v) for k, v in leaf.items()} for n, leaf in tree.items()}


@functools.lru_cache(maxsize=None)
def _jax_twin_fn():
    """JAX's f32 reference-strategy twin (tests/test_accuracy_parity.py:
    160-173) under the fixed masks of MASKS, jitted."""
    jmodel = JYoloV3.from_config(JConfig(**dict(_infer_kw("float32"), fixed_mc_masks=None)))
    pri = jpriors_as_array(jmodel.priors)

    def twin(p, s, x):
        raws = jmodel.mc_forward(p, s, x, T=T, rng=None, fixed_masks=MASKS)
        per_scale = [jdecode.decode_bbox_epistemic(
            jdecode.decode_epistemic_stats(jdecode.split_detection(raw, jmodel.spec)),
            jnp.asarray(pri[stride]), layer_id=i)
            for i, (raw, stride) in enumerate(zip(raws, (32, 16, 8)))]
        return jnms.nms_select(jdecode.concat_all_scales(per_scale),
                               jmodel.spec.obj_idx(epistemic=True), max_out=parity.MAX_OUT)[:2]

    return jax.jit(twin)


def _jax_twin(params_np, stats_np, img_u8):
    rows, valid = _jax_twin_fn()(tp.to_jax(params_np), tp.to_jax(stats_np),
                                 jnp.asarray(img_u8).astype(jnp.float32) / 255.0)
    return np.asarray(rows), np.asarray(valid)


def test_reference_twin_matches_jax_twin():
    """The twin against JAX's on the runner tests' seeded weights and the
    same fixed masks, float32: the rows at tests/test_torch_runner.py's
    float32 bounds, ``valid`` exact."""
    params_np, stats_np = tp.numpy_weights(seed=3)
    for i in (1, 2, 3):  # raw logits of a few units, not tens
        params_np[f"det{i}"]["w"] *= np.float32(0.2)
    img = tp.image_u8(seed=4)
    want_rows, want_valid = _jax_twin(params_np, stats_np, img)
    params, stats = tp.to_torch(params_np, stats_np)
    got_rows, got_valid = parity.reference_twin(params, stats, img, _fixed_key_table(MASKS, T),
                                                "cpu")
    assert got_rows.shape == want_rows.shape == (parity.MAX_OUT, 23)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert got_valid.sum() > 10
    _assert_rows_close(got_rows, want_rows)


def test_compare_gives_the_full_res_artifact_keys(rng):
    """``compare`` returns every key of the JAX package's PARITY_FULLRES.json;
    a pipeline compared with itself has dmAP 0, its matches' variances
    delta 0, and its mAP is JAX's evaluator's."""
    rows_by_img = {}
    gt = {}
    for b in range(2):
        rows, valid = _random_rows(rng)
        rows[:, 14] = 0.9  # confident objectness
        rows_by_img[b] = (rows, valid)
        gt[b] = (rows[valid][:3, :4], np.array([1, 2, 1]))
    out = parity.compare(rows_by_img, rows_by_img, gt, SPEC, geometry=IMG, T=T, train_steps=0)
    with open(os.path.join(REPO, "PARITY_FULLRES.json")) as f:
        assert set(json.load(f)) <= set(out)
    assert out["abs_dmAP"] == 0.0 and out["pass"]
    assert out["matched_confident_detections"] > 0
    assert out["worst_matched_variance_rel_delta"] == 0.0
    want = j_evaluate(j_score(rows_by_img, JVariantSpec(JVariant.BAYESIAN, 2))[0], gt, [1, 2])
    assert out["mAP_reference_f32"] == want["mAP"]
    json.dumps(out)  # the artifact is JSON as it stands


def test_overfit_two_steps_moves_every_leaf():
    """Two harness steps: the whole model trains (every backbone leaf moved
    from the seeded init), the loss is finite, and the recovered batch
    statistics are finite with positive variances."""
    batch = _overfit_batch(np.random.default_rng(0))
    cfg = parity.overfit_config(IMG, N_IMAGES, N_BOXES)
    params, stats, metrics = parity.overfit(cfg, batch, 2, "cpu", seed=0)
    assert np.isfinite(float(metrics["total"]))
    init, _ = YoloV3.from_config(cfg).init(torch.Generator().manual_seed(0))
    for name, p in params["backbone"].items():
        for k, v in p.items():
            assert not torch.equal(v, init["backbone"][name][k]), (name, k)
            assert not v.requires_grad
    for leaf in _flat_stats(stats).values():
        assert torch.isfinite(leaf["mean"]).all() and (leaf["var"] > 0).all()


def test_plain_kernels_swaps_every_kernel_of_the_predict():
    """parity_fullres_torch.py's second witness: inside ``plain_kernels`` the
    names through which the bf16 predict reaches its five kernels are their
    plain versions (the downsample through ``fused_downsample_packed``), and
    they are restored after."""
    from bayesian_yolov3_torch.infer import runner as runner_module
    from bayesian_yolov3_torch.ops import cuda_conv, cuda_epistemic, cuda_nms
    from bayesian_yolov3_torch.ops import nms as nms_module

    names = [(cuda_conv, "fused_stem", cuda_conv.fused_stem_plain),
             (cuda_conv, "fused_res_block", cuda_conv.fused_res_block_plain),
             (cuda_conv, "fused_downsample", cuda_conv.fused_downsample_plain),
             (runner_module, "fused_epistemic_decode_cf_batched",
              cuda_epistemic.epistemic_decode_plain),
             (nms_module, "greedy_nms_cuda", cuda_nms.greedy_nms_plain)]
    before = [getattr(m, n) for m, n, _ in names]
    assert all(b is not p for b, (_, _, p) in zip(before, names))
    with parity_fullres_torch.plain_kernels():
        for m, n, plain in names:
            assert getattr(m, n) is plain, n
        x = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16)
        w = torch.zeros((128, 64, 3, 3))
        bn = (torch.ones(128), torch.zeros(128))
        assert torch.equal(cuda_conv.fused_downsample_packed(x, w, bn),
                           cuda_conv.fused_downsample_plain(x, w, bn))
    assert [getattr(m, n) for m, n, _ in names] == before


def test_witness_pairs_rows_by_anchor(rng):
    """A pipeline against itself: dmAP 0 and no anchor differs; one anchor's
    score moved by 0.25 shows as the anchor score delta."""
    spec = SPEC
    decoded = rng.uniform(0, 1, (300, 23)).astype(np.float32)
    decoded[:, 2:4] = decoded[:, 0:2] + 0.1
    rows, valid = _random_rows(rng)
    gt = {0: (rows[valid][:2, :4], np.array([1, 2]))}
    same = parity_fullres_torch.witness((rows, valid, decoded), (rows, valid, decoded), gt, spec)
    assert same["abs_dmAP"] == 0.0 and same["anchor_max_abs_score_delta"] == 0.0
    assert same["anchors_scored"] > 0 and same["anchor_max_abs_box_delta_scored"] == 0.0
    moved = decoded.copy()
    obj = spec.obj_idx(epistemic=True)
    cls0 = spec.cls_start_idx(epistemic=True)
    moved[7, obj] = decoded[7, obj] + 0.25 / decoded[7, cls0:cls0 + 2].max()
    got = parity_fullres_torch.witness((rows, valid, moved), (rows, valid, decoded), gt, spec)
    np.testing.assert_allclose(got["anchor_max_abs_score_delta"], 0.25, rtol=1e-5)


@pytest.fixture(scope="module")
def trained():
    """The port's overfit on JAX's recipe and inputs."""
    batch = _overfit_batch(np.random.default_rng(0))
    cfg = parity.overfit_config(IMG, N_IMAGES, N_BOXES)
    params, stats, metrics = parity.overfit(cfg, batch, STEPS, "cpu", seed=0)
    assert np.isfinite(float(metrics["total"]))
    gt = {b: (batch["bbox"][b], batch["label"][b] + 1) for b in range(N_IMAGES)}
    return params, stats, batch["image"], gt


@pytest.mark.slow
def test_trained_model_metric_parity_bf16_vs_f32_and_jax(trained):
    params, stats, imgs_u8, gt = trained
    runner = InferenceRunner(Config(**_infer_kw("bfloat16")), device="cpu")
    keys = runner.draw_keys()
    np.testing.assert_array_equal(keys, _fixed_key_table(MASKS, T))
    prod, ref = {}, {}
    for b in range(N_IMAGES):
        rows, valid = runner.predict(params, stats, imgs_u8[b:b + 1], keys)
        prod[b] = (rows[0], valid[0])
        ref[b] = parity.reference_twin(params, stats, imgs_u8[b:b + 1], keys, "cpu")
    out = parity.compare(prod, ref, gt, runner.spec, geometry=IMG, T=T, train_steps=STEPS)
    # non-vacuous: the twin detects, with a confident detection in each image
    assert out["nonvacuous"], out
    for b in range(N_IMAGES):
        assert out["ref_top_score_per_image"][str(b)] > 0.5, out
    assert out["matched_confident_detections"] >= N_IMAGES, out
    # the contract: same weights, bf16 production vs f32 twin, same mAP
    assert out["abs_dmAP"] <= 1e-3 and out["pass"], out
    for c in ("1", "2"):
        lp, lr_ = out["lamr_production_bf16"][c], out["lamr_reference_f32"][c]
        assert (np.isnan(lp) and np.isnan(lr_)) or abs(lp - lr_) <= 1e-2, (c, lp, lr_)

    # JAX's own pipelines on the same weights, images and masks: its bf16
    # production predict (the XLA path) and its f32 twin
    jr = JRunner(JConfig(**_infer_kw("bfloat16")))
    params_np, stats_np = convert.params_to_jax(params, stats)
    jax_prod, jax_ref = {}, {}
    for b in range(N_IMAGES):
        rows, valid = jr.predict(tp.to_jax(params_np), tp.to_jax(stats_np), imgs_u8[b:b + 1],
                                 jax.random.PRNGKey(b))
        jax_prod[b] = (np.asarray(rows)[0], np.asarray(valid)[0])
        jax_ref[b] = _jax_twin(params_np, stats_np, imgs_u8[b:b + 1])
    out_jax = parity.compare(jax_prod, jax_ref, gt, runner.spec, geometry=IMG, T=T,
                             train_steps=STEPS)
    # the witness: the port's production mAP is JAX's
    assert abs(out["mAP_production_bf16"] - out_jax["mAP_production_bf16"]) <= 1e-3, (out,
                                                                                      out_jax)
    # the twins agree as float32 pipelines do (the same picks)
    for b in range(N_IMAGES):
        np.testing.assert_array_equal(ref[b][1], jax_ref[b][1])
        _assert_rows_close(ref[b][0], jax_ref[b][0])
    # bf16 moves the confident detections' variances as far in the port as in
    # JAX, within 2x: exp(log variance) amplifies each sample's bf16 rounding,
    # and JAX's own pair exceeds its test's 0.35 on these weights
    assert out_jax["matched_confident_detections"] >= N_IMAGES, out_jax
    assert (out["worst_matched_variance_rel_delta"]
            <= 2 * out_jax["worst_matched_variance_rel_delta"]), (out, out_jax)
    # the two bf16 pipelines' rows, paired by anchor: corners and scores at
    # tests/test_torch_runner.py's bf16 bounds; the confident matches'
    # variances within the 0.35 jitter bound
    cross = parity.compare(prod, jax_prod, gt, runner.spec, geometry=IMG, T=T, train_steps=STEPS)
    assert cross["matched_confident_detections"] >= N_IMAGES, cross
    assert cross["worst_matched_variance_rel_delta"] <= 0.35, cross
    for b in range(N_IMAGES):
        pairs = _match_rows(prod[b][0], prod[b][1], *jax_prod[b])
        assert len(pairs) >= 0.6 * max(prod[b][1].sum(), jax_prod[b][1].sum()), b
        g, w = (np.stack(x) for x in zip(*pairs))
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=0.01, rtol=0)
        np.testing.assert_allclose(g[:, 14:21], w[:, 14:21], atol=0.05, rtol=0)
