"""The port's GT encoder (``data/encode.py``, batched) against the JAX
package's: ``obj``, ``ign`` and ``cls`` equal, ``loc`` at float32 rounding
(the logit and log of two libraries)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_yolov3_tpu.core.blueprint import ModelBlueprint as JBlueprint
from bayesian_yolov3_tpu.core.priors import ECP_9_PRIORS as J_PRIORS
from bayesian_yolov3_tpu.data import encode as je

from bayesian_yolov3_torch.core.blueprint import ModelBlueprint as TBlueprint
from bayesian_yolov3_torch.core.priors import ECP_9_PRIORS as T_PRIORS
from bayesian_yolov3_torch.data import encode as te

IMG = (64, 96, 3)
J_TABLES = je.build_prior_tables(JBlueprint.build(IMG, J_PRIORS, cls_cnt=2))
T_TABLES = te.build_prior_tables(TBlueprint.build(IMG, T_PRIORS, cls_cnt=2))
LOC_TOL = dict(rtol=1e-6, atol=1e-6)
M = 20  # padded boxes per example


def _boxes(rng, n):
    yx = rng.uniform(0.05, 0.7, (n, 2))
    hw = rng.uniform(0.02, 0.35, (n, 2))
    return np.concatenate([yx, np.minimum(yx + hw, 0.999)], axis=1).astype(np.float32)


def _example(rng, n):
    boxes = np.zeros((M, 4), np.float32)
    labels = np.zeros(M, np.int32)
    valid = np.zeros(M, bool)
    boxes[:n] = _boxes(rng, n)
    labels[:n] = rng.integers(0, 2, n)
    valid[:n] = True
    if n >= 5:
        boxes[n - 1] = boxes[0]  # the same box again, another label: it overwrites
        labels[n - 1] = 1 - labels[0]
        boxes[n - 2] = boxes[1] + np.float32(0.01)  # overlapping, shifted
    return boxes, labels, valid


_jax_encode = jax.jit(jax.vmap(lambda b, l, v: je.encode_boxes(b, l, v, J_TABLES)))


def test_prior_tables_equal():
    for k in ("bboxes", "areas", "cx", "cy", "pw", "ph", "lw", "lh"):
        np.testing.assert_array_equal(getattr(T_TABLES, k), getattr(J_TABLES, k), err_msg=k)
    assert T_TABLES.layer_sizes == J_TABLES.layer_sizes
    assert T_TABLES.layer_shapes == J_TABLES.layer_shapes


@pytest.mark.parametrize("n_boxes", [1, 5, 17])
def test_encode_boxes_matches_jax(rng, n_boxes):
    """A batch of two examples (n_boxes and n_boxes // 2 + 1 valid boxes),
    with a repeated box of another label (the later one wins) and an
    overlapping pair."""
    exs = [_example(rng, n_boxes), _example(rng, n_boxes // 2 + 1)]
    b, l, v = (np.stack(x) for x in zip(*exs))
    want = _jax_encode(jnp.asarray(b), jnp.asarray(l), jnp.asarray(v))
    got = te.encode_boxes(torch.from_numpy(b), torch.from_numpy(l), torch.from_numpy(v),
                          T_TABLES)
    assert sum(int(g["obj"].sum()) for g in got) > 0
    for s, (g, w) in enumerate(zip(got, want)):
        assert g["cls"].dtype == torch.int32
        for k in ("obj", "ign", "cls"):
            assert torch.equal(g[k], torch.from_numpy(np.asarray(w[k]))), (s, k)
        np.testing.assert_allclose(g["loc"].numpy(), np.asarray(w["loc"]), **LOC_TOL)


def test_encode_at_full_resolution_matches_jax():
    """The accuracy-parity recipe's pedestrian-shaped boxes on the ECP
    geometry (1024x1920: 32x60, 64x120 and 128x240 cells), where the 64x96
    tables above have 2x3 cells at the coarsest scale."""
    import parity_fullres_torch

    full = parity_fullres_torch.FULL
    jt = je.build_prior_tables(JBlueprint.build(full, J_PRIORS, cls_cnt=2))
    tt = te.build_prior_tables(TBlueprint.build(full, T_PRIORS, cls_cnt=2))
    batch, _ = parity_fullres_torch.inputs(np.random.default_rng(0))
    b, l, v = (batch[k] for k in ("bbox", "label", "valid"))
    want = jax.vmap(lambda b, l, v: je.encode_boxes(b, l, v, jt))(
        jnp.asarray(b), jnp.asarray(l), jnp.asarray(v))
    got = te.encode_boxes(torch.from_numpy(b), torch.from_numpy(l), torch.from_numpy(v), tt)
    assert sum(int(g["obj"].sum()) for g in got) == 3
    for s, (g, w) in enumerate(zip(got, want)):
        for k in ("obj", "ign", "cls"):
            assert torch.equal(g[k], torch.from_numpy(np.asarray(w[k]))), (s, k)
        np.testing.assert_allclose(g["loc"].numpy(), np.asarray(w["loc"]), **LOC_TOL)


def test_later_box_overwrites_earlier():
    box = np.asarray([0.3, 0.3, 0.6, 0.5], np.float32)
    b = np.zeros((1, M, 4), np.float32)
    b[0, 0] = b[0, 1] = box
    l = np.zeros((1, M), np.int32)
    l[0, 1] = 1
    v = np.zeros((1, M), bool)
    v[0, :2] = True
    got = te.encode_boxes(torch.from_numpy(b), torch.from_numpy(l), torch.from_numpy(v),
                          T_TABLES)
    objs = torch.cat([g["obj"].reshape(-1) for g in got])
    clss = torch.cat([g["cls"].reshape(-1) for g in got])
    assert int(objs.sum()) >= 1 and bool((clss[objs > 0] == 1).all())


def test_pad_boxes_matches_jax(rng):
    boxes = _boxes(rng, 7)
    labels = rng.integers(0, 2, 7).astype(np.int32)
    for m in (3, 7, 10):
        for got, want in zip(te.pad_boxes(boxes, labels, m), je.pad_boxes(boxes, labels, m)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
