"""ops/common.py of the PyTorch port against the JAX package: the same
numpy inputs through both, float32 on the CPU.

Tolerances: a float32 convolution sums k*k*cin products in another order
in the two frameworks, so values are held to rtol 1e-5 (atol 1e-5 for
sums near zero); the dropout masks are integer arithmetic and must be
BIT-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayesian_yolov3_tpu.ops import common as jc
from bayesian_yolov3_torch.ops import common as tc

RTOL, ATOL = 1e-5, 1e-5


def _hwio_to_oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("key", [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 2654435761])
def test_hash_keep_bit_equal(key):
    n = 1 << 16
    # low indices, and indices around 2**32 - 1 where the uint32 wrap bites
    idx = np.concatenate([np.arange(n, dtype=np.uint32),
                          np.arange(2**32 - n, 2**32, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(jc.hash_keep(jnp.asarray(idx), jnp.uint32(key),
                                   jnp.uint32(jc.KEEP_THRESH_16)))
    got = tc.hash_keep(torch.from_numpy(idx.astype(np.int64)), key, tc.KEEP_THRESH_16)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.88 < want.mean() < 0.92


@pytest.mark.parametrize("nb", [1, 2])
def test_dropout_masks_bit_equal_per_sample(rng, nb):
    """S samples stacked on the batch axis draw, sample by sample, exactly
    the mask the JAX package draws for the per-sample (NB, h, w, c) tensor
    with the same key — the sample axis never enters the index."""
    keys = [7, 0xDEADBEEF, 123456789]
    x = rng.standard_normal((len(keys) * nb, 5, 6, 8)).astype(np.float32) + 3.0
    got = tc.dropout(torch.from_numpy(x.copy()), 0.1, keys).numpy()
    for s, key in enumerate(keys):
        xs = x[s * nb:(s + 1) * nb]
        want = np.asarray(jc.dropout(jnp.asarray(xs), 0.1, None, key_u32=key))
        np.testing.assert_array_equal(got[s * nb:(s + 1) * nb] == 0.0, want == 0.0)
        np.testing.assert_allclose(got[s * nb:(s + 1) * nb], want, rtol=1e-6)


def test_dropout_mask_ignores_memory_layout(rng):
    """A tensor that is NCHW in memory but NHWC in shape draws the same
    mask as its contiguous copy."""
    x = rng.standard_normal((2, 4, 6, 8)).astype(np.float32) + 3.0
    strided = torch.from_numpy(x.copy()).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not strided.is_contiguous()
    a = tc.dropout(strided, 0.1, 99).numpy()
    b = tc.dropout(torch.from_numpy(x.copy()), 0.1, 99).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,stride,hw", [(3, 1, (8, 10)), (1, 1, (8, 10)),
                                         (3, 2, (8, 10)), (3, 2, (7, 9))])
def test_conv2d_matches_jax(rng, k, stride, hw):
    """Stride-2 is the darknet (1,1)x(1,1) pad then VALID, on even and odd
    inputs — not TF SAME."""
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 7)).astype(np.float32)
    want = np.asarray(jc.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride))
    got = tc.conv2d(torch.from_numpy(x), _hwio_to_oihw(w), stride=stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_conv2d_explicit_asymmetric_padding(rng):
    x = rng.standard_normal((1, 6, 8, 4)).astype(np.float32)
    w = rng.standard_normal((2, 2, 4, 3)).astype(np.float32)
    pad = ((1, 0), (1, 0))
    want = np.asarray(jc.conv2d(jnp.asarray(x), jnp.asarray(w), padding=pad))
    got = tc.conv2d(torch.from_numpy(x), _hwio_to_oihw(w), padding=pad).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("drop", [False, True])
def test_conv_block_matches_jax(rng, drop):
    """conv -> dropout -> BN -> leaky, dropout BEFORE BN."""
    cin, cout = 6, 8
    x = rng.standard_normal((2, 6, 8, cin)).astype(np.float32)
    p = {"w": rng.standard_normal((3, 3, cin, cout)).astype(np.float32),
         "gamma": rng.uniform(0.5, 1.5, cout).astype(np.float32),
         "beta": rng.standard_normal(cout).astype(np.float32)}
    s = {"mean": rng.standard_normal(cout).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
    kw = dict(drop_rate=0.1, drop_key_u32=4242) if drop else {}
    want, _ = jc.conv_block({k: jnp.asarray(v) for k, v in p.items()},
                            {k: jnp.asarray(v) for k, v in s.items()},
                            jnp.asarray(x), **kw)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tp["w"] = _hwio_to_oihw(p["w"])
    kw = dict(drop_rate=0.1, drop_keys=[4242]) if drop else {}
    got = tc.conv_block(tp, {k: torch.from_numpy(v) for k, v in s.items()},
                        torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_conv_block_training_mode_is_refused(rng):
    """The in-place inference block refuses batch statistics and names the
    training block."""
    p = {"w": torch.zeros(4, 3, 1, 1), "gamma": torch.ones(4), "beta": torch.zeros(4)}
    s = {"mean": torch.zeros(4), "var": torch.ones(4)}
    with pytest.raises(ValueError, match="conv_block_train"):
        tc.conv_block(p, s, torch.zeros(1, 2, 2, 3), training=True)


@pytest.mark.parametrize("drop,stride", [(False, 1), (True, 1), (True, 2)])
def test_conv_block_train_matches_jax(rng, drop, stride):
    """Batch-statistics BN: the output, the new moving statistics (biased
    variance, momentum 0.99) and, through autograd, the gradients of the
    kernel, gamma, beta and the input against ``jax.grad``; dropout with
    one key over the whole batch (JAX's training dropout with its
    ``bits(key)``)."""
    import jax

    cin, cout = 6, 8
    x = rng.standard_normal((2, 6, 8, cin)).astype(np.float32)
    p = {"w": rng.standard_normal((3, 3, cin, cout)).astype(np.float32),
         "gamma": rng.uniform(0.5, 1.5, cout).astype(np.float32),
         "beta": rng.standard_normal(cout).astype(np.float32)}
    s = {"mean": rng.standard_normal(cout).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
    gy = rng.standard_normal((2, 6 // stride, 8 // stride, cout)).astype(np.float32)
    jkey = jax.random.PRNGKey(9)
    kw = dict(drop_rate=0.1, rng=jkey) if drop else {}

    def jloss(pj, xj):
        y, ns = jc.conv_block(pj, {k: jnp.asarray(v) for k, v in s.items()}, xj,
                              stride=stride, training=True, **kw)
        return jnp.sum(y * jnp.asarray(gy)), (y, ns)

    (jgp, jgx), (want, want_stats) = jax.grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp_ = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tp_["w"] = _hwio_to_oihw(p["w"]).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    key = int(jax.random.bits(jkey, (), jnp.uint32))
    got, got_stats = tc.conv_block_train(
        tp_, {k: torch.from_numpy(v) for k, v in s.items()}, tx, stride=stride,
        **(dict(drop_rate=0.1, drop_key=key) if drop else {}))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for k in ("mean", "var"):
        assert not got_stats[k].requires_grad
        np.testing.assert_allclose(got_stats[k].numpy(), np.asarray(want_stats[k]), rtol=RTOL,
                                   atol=1e-7)
    # gradients: float32 sums over the batch and the BN reductions, rtol/atol 1e-4
    gw, gg, gb, gx = torch.autograd.grad((got * torch.from_numpy(gy)).sum(),
                                         (tp_["w"], tp_["gamma"], tp_["beta"], tx))
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgp["w"]).transpose(3, 2, 0, 1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gg.numpy(), np.asarray(jgp["gamma"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgp["beta"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)


def test_detection_conv_cf_layout(rng):
    """(T, NB, h, w, cin) -> (ch, T, NB*h*w): anchors on the minor axis,
    image batch folded onto it."""
    T, nb, h, w, cin, ch = 3, 2, 4, 5, 6, 42
    f = rng.standard_normal((T, nb, h, w, cin)).astype(np.float32)
    p = {"w": rng.standard_normal((1, 1, cin, ch)).astype(np.float32),
         "b": rng.standard_normal(ch).astype(np.float32)}
    want = np.asarray(jc.detection_conv_cf(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(f)))
    tp = {"w": _hwio_to_oihw(p["w"]), "b": torch.from_numpy(p["b"])}
    got = tc.detection_conv_cf(tp, torch.from_numpy(f))
    assert got.shape == (ch, T, nb * h * w) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    nhwc = tc.detection_conv(tp, torch.from_numpy(f[0])).numpy()
    np.testing.assert_allclose(
        got.numpy()[:, 0].reshape(ch, nb, h, w).transpose(1, 2, 3, 0), nhwc,
        rtol=RTOL, atol=ATOL)


def test_upsample2x_and_leaky(rng):
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(tc.upsample2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jc.upsample2x(jnp.asarray(x))))
    np.testing.assert_array_equal(tc.leaky_relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jc.leaky_relu(jnp.asarray(x))))


def test_glorot_init_is_seeded_and_bounded():
    g = torch.Generator().manual_seed(3)
    p, s = tc.init_conv_block(g, 3, 16, 32)
    p2, _ = tc.init_conv_block(torch.Generator().manual_seed(3), 3, 16, 32)
    assert p["w"].shape == (32, 16, 3, 3)
    assert torch.equal(p["w"], p2["w"])
    limit = (6.0 / (9 * 16 + 9 * 32)) ** 0.5
    assert p["w"].abs().max() <= limit and p["w"].std() > 0.4 * limit
    assert torch.equal(s["var"], torch.ones(32))
    d = tc.init_detection_conv(g, 16, 42)
    assert d["w"].shape == (42, 16, 1, 1) and torch.equal(d["b"], torch.zeros(42))
