"""The port's augmentation and crops (``data/augment.py``) against the JAX
package's under JAX's own draws: the port's functions take the values that
the JAX functions draw from their keys, computed here from the same keys.
Images at rtol 1e-5 / atol 1e-6 (float32 products in two libraries),
boxes and validity exactly equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_yolov3_tpu.data import augment as ja

from bayesian_yolov3_torch.data import augment as ta

IMG_TOL = dict(rtol=1e-5, atol=1e-6)
FULL, CROP = (96, 144, 3), (64, 96, 3)
J_CROPPER = ja.ImageCropper(FULL, CROP)
T_CROPPER = ta.ImageCropper(FULL, CROP)
M = 12


@pytest.fixture(scope="module")
def example():
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, FULL).astype(np.float32)
    yx = rng.uniform(0.0, 0.8, (M, 2))
    hw = rng.uniform(0.02, 0.5, (M, 2))
    bbox = np.concatenate([yx, np.minimum(yx + hw, 1.0)], axis=1).astype(np.float32)
    bbox[3] = bbox[2]  # a zero-area box stays invalid
    bbox[3, 2] = bbox[3, 0]
    valid = np.ones(M, bool)
    valid[-2:] = False
    label = rng.integers(0, 2, M).astype(np.int32)
    return img, bbox, valid, label


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IMG_TOL)


def _equal(got, want):
    assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_hsv_round_trip_matches_jax(example):
    img = example[0]
    hsv = ja.rgb_to_hsv(jnp.asarray(img))
    _close(ta.rgb_to_hsv(*_t(img)), hsv)
    _close(ta.hsv_to_rgb(*_t(np.asarray(hsv))), ja.hsv_to_rgb(hsv))


@pytest.mark.parametrize("k", [2, 3])
def test_flip_and_blur_match_jax(example, k):
    img, bbox = example[:2]
    ji, jb = ja.flip_lr(jnp.asarray(img), jnp.asarray(bbox))
    ti, tb = ta.flip_lr(*_t(img, bbox))
    _equal(ti, ji)
    _equal(tb, jb)
    _close(ta._box_blur(*_t(img), k), ja._box_blur(jnp.asarray(img), k))


def _key_with(pred, start=0):
    """The first PRNGKey(i), i >= start, whose draws satisfy ``pred``."""
    i = start
    while not pred(jax.random.PRNGKey(i)):
        i += 1
    return jax.random.PRNGKey(i)


def _color_draws(key):
    kc, ks, kb, kh = jax.random.split(key, 4)
    choice = int(jax.random.randint(kc, (), 0, 3))
    value = {0: jax.random.uniform(ks, (), minval=0.5, maxval=1.5),
             1: jax.random.uniform(kb, (), minval=-0.2, maxval=0.2),
             2: jax.random.uniform(kh, (), minval=-0.2, maxval=0.2)}[choice]
    return choice, float(value)


def _noise_draws(key, shape):
    kc, k1, k2, k3, k4 = jax.random.split(key, 5)
    choice = int(jax.random.randint(kc, (), 0, 3))
    if choice == 2:
        value = jax.random.uniform(k3, (), minval=0.001, maxval=0.05)
        fields = (jax.random.normal(k4, shape, jnp.float32),)
    else:
        value = jax.random.uniform(k3, (), minval=0.0005, maxval=0.008)
        hw = shape if choice == 0 else shape[:2]
        fields = (jax.random.uniform(k1, hw), jax.random.uniform(k2, hw))
    return choice, float(value), tuple(torch.from_numpy(np.array(f)) for f in fields)


@pytest.mark.parametrize("choice", [0, 1, 2])
def test_color_augment_matches_jax(example, choice):
    img = example[0]
    key = _key_with(lambda k: _color_draws(k)[0] == choice)
    c, value = _color_draws(key)
    _close(ta.color_augment(*_t(img), c, value), ja.color_augment(jnp.asarray(img), key))


@pytest.mark.parametrize("choice", [0, 1, 2])
def test_noise_augment_matches_jax(example, choice):
    img = example[0]
    key = _key_with(lambda k: int(jax.random.randint(jax.random.split(k, 5)[0], (), 0, 3))
                    == choice)
    c, value, fields = _noise_draws(key, img.shape)
    _close(ta.noise_augment(*_t(img), c, value, fields), ja.noise_augment(jnp.asarray(img), key))


def _augment_draws(key, shape):
    kf, kfb, kb, kbb, kcp, kc, knp, _ = jax.random.split(key, 8)
    u = lambda k: float(jax.random.uniform(k))  # noqa: E731
    return {
        "flip": u(kf) < 0.5,
        "blur": int(jax.random.randint(kb, (), 2, 4)) if u(kfb) < 0.05 else None,
        "color": _color_draws(kcp) if u(kbb) < 0.05 else None,
        "noise": _noise_draws(knp, shape) if u(kc) < 0.05 else None,
    }


@pytest.fixture(scope="module")
def augment_keys():
    """Keys whose draws flip or not, and blur (k 2 and 3), color and noise
    (each choice), found by a vectorized search over the gates."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4000))
    sub = jax.vmap(lambda k: jax.random.split(k, 8))(keys)
    gates = np.stack([np.asarray(jax.vmap(jax.random.uniform)(sub[:, j])) for j in (0, 1, 3, 5)],
                     axis=1)
    picks = [0, 1]
    for j in (1, 2, 3):  # blur, color, noise
        picks += [int(i) for i in np.flatnonzero(gates[:, j] < 0.05)[:4]]
    return [keys[i] for i in sorted(set(picks))]


def test_augment_matches_jax(example, augment_keys):
    img, bbox, _, label = example
    seen = set()
    aug = jax.jit(ja.augment)
    for key in augment_keys:
        d = _augment_draws(key, img.shape)
        seen |= {name for name in ("blur", "color", "noise") if d[name] is not None}
        ji, jb, jl = aug(jnp.asarray(img), jnp.asarray(bbox), jnp.asarray(label), key)
        ti, tb, tl = ta.augment(*_t(img, bbox, label), d)
        _close(ti, ji)
        _equal(tb, jb)
        _equal(tl, jl)
    assert seen == {"blur", "color", "noise"}


def _crop_boxes_equal(got, want):
    _equal(got[1], want[1])
    _equal(got[2], want[2])


def test_random_crop_matches_jax(example):
    img, bbox, valid, _ = example
    for i in range(6):
        key = jax.random.PRNGKey(100 + i)
        y, x = J_CROPPER._window_random(key, jnp.asarray(CROP[0]), jnp.asarray(CROP[1]))
        want = J_CROPPER.random_crop(*map(jnp.asarray, (img, bbox, valid)), key)
        got = T_CROPPER.random_crop(*_t(img, bbox, valid), int(y), int(x))
        _equal(got[0], want[0])
        _crop_boxes_equal(got, want)


def _rescale_window(key):
    ks, kw = jax.random.split(key)
    scale = jnp.clip(jax.random.normal(ks) * 0.5, -0.7, 0.7)
    crop_h = jnp.minimum((1.0 + scale) * CROP[0], FULL[0]).astype(jnp.int32)
    crop_w = jnp.minimum((1.0 + scale) * CROP[1], FULL[1]).astype(jnp.int32)
    y, x = J_CROPPER._window_random(kw, crop_h, crop_w)
    return int(y), int(x), int(crop_h), int(crop_w)


def test_random_crop_with_rescale_matches_jax(example):
    img, bbox, valid, _ = example
    sizes = set()
    for i in range(8):
        key = jax.random.PRNGKey(200 + i)
        y, x, h, w = _rescale_window(key)
        sizes.add(h > CROP[0])
        want = J_CROPPER.random_crop_with_rescale(*map(jnp.asarray, (img, bbox, valid)), key)
        got = T_CROPPER.random_crop_with_rescale(*_t(img, bbox, valid), y, x, h, w)
        _close(got[0], want[0])
        _crop_boxes_equal(got, want)
    assert sizes == {True, False}  # windows larger and smaller than the crop


def test_sometimes_rescale_and_window_match_jax(example):
    """The 33% branch, and ``ImageCropper.window``'s float32 arithmetic fed
    JAX's normals: the same window sizes and rows as JAX derives.  The
    image is held against JAX's branch function run op by op: compiled as
    one program (under ``lax.cond`` or ``jit``), XLA rounds the resample's
    source coordinates differently, and JAX's compiled resample leaves its
    own op-by-op result by more than this tolerance."""
    img, bbox, valid, _ = example
    branches = set()
    for i in range(12):
        key = jax.random.PRNGKey(300 + i)
        kc, kk = jax.random.split(key)
        rescale = float(jax.random.uniform(kc)) < 0.33
        branches.add(rescale)
        if rescale:
            y, x, h, w = _rescale_window(kk)
            ks, kw = jax.random.split(kk)
            z_scale = float(jax.random.normal(ks))
        else:
            y, x = (int(v) for v in J_CROPPER._window_random(
                kk, jnp.asarray(CROP[0]), jnp.asarray(CROP[1])))
            h, w, kw, z_scale = CROP[0], CROP[1], kk, 0.0
        z_y = float(jax.random.normal(jax.random.split(kw)[0]))
        win = T_CROPPER.window(rescale, z_scale, z_y, 0.5)
        assert (win["rescale"], win["y"], win["h"], win["w"]) == (rescale, y, h, w)
        win["x"] = x
        branch = J_CROPPER.random_crop_with_rescale if rescale else J_CROPPER.random_crop
        want = branch(*map(jnp.asarray, (img, bbox, valid)), kk)
        got = T_CROPPER.random_crop_and_sometimes_rescale(*_t(img, bbox, valid), win)
        _close(got[0], want[0])
        _crop_boxes_equal(got, want)
    assert branches == {True, False}


def test_center_crop_and_resample_match_jax(example):
    img, bbox, valid, _ = example
    want = J_CROPPER.center_crop(*map(jnp.asarray, (img, bbox, valid)))
    got = T_CROPPER.center_crop(*_t(img, bbox, valid))
    _equal(got[0], want[0])
    _crop_boxes_equal(got, want)
    for y0, x0, h, w in ((0, 0, FULL[0], FULL[1]), (5, 9, 40, 60), (30, 40, 66, 104)):
        want = ja._bilinear_window_resample(jnp.asarray(img), jnp.int32(y0), jnp.int32(x0),
                                            jnp.int32(h), jnp.int32(w), CROP[:2])
        _close(ta._bilinear_window_resample(*_t(img), y0, x0, h, w, CROP[:2]), want)


def test_draw_batch_is_seeded_and_fixed_length():
    """Same seed, same draws; the generator advances by the same amount
    whatever the draws choose; the gates fire at their rates."""
    def draws(seed, n, augment_on=True):
        gen = torch.Generator().manual_seed(seed)
        out = ta.draw_batch(gen, n, T_CROPPER, augment_on)
        return out, torch.rand(1, generator=gen).item()

    a, after_a = draws(3, 2000)
    b, after_b = draws(3, 2000, augment_on=False)
    assert after_a == after_b and [d["crop"] for d in a] == [d["crop"] for d in b]
    assert a == draws(3, 2000)[0]
    rate = lambda f: np.mean([f(d) for d in a])  # noqa: E731
    assert 0.45 < rate(lambda d: d["augment"]["flip"]) < 0.55
    for name in ("blur", "color", "noise"):
        assert 0.03 < rate(lambda d: d["augment"][name] is not None) < 0.07, name
    assert 0.29 < rate(lambda d: d["crop"]["rescale"]) < 0.37
    for d in a:
        c = d["crop"]
        assert 0 <= c["y"] <= FULL[0] - c["h"] and 0 <= c["x"] <= FULL[1] - c["w"]
        assert c["h"] * CROP[1] // CROP[0] in (c["w"] - 1, c["w"], c["w"] + 1)
