"""Backbone and heads of the PyTorch port against the JAX package: the same
seeded numpy weights and image through both, float32 on the CPU.

Tolerance: 52 (backbone) to 75 stacked float32 convolutions whose sums run
in another order in the two frameworks; activations are O(1), and the raw
head outputs are held to rtol/atol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_yolov3_tpu.models import darknet as jdark
from bayesian_yolov3_tpu.models import yolov3 as jyolo
from bayesian_yolov3_torch import convert
from bayesian_yolov3_torch.models import darknet as tdark
from bayesian_yolov3_torch.models import yolov3 as tyolo

import torch_parity as tp

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    params_np, stats_np = tp.numpy_weights(seed=0)
    return (params_np, stats_np, tp.to_jax(params_np), tp.to_jax(stats_np),
            *tp.to_torch(params_np, stats_np))


@pytest.fixture(scope="module")
def img():
    return tp.image_u8(seed=1).astype(np.float32) / 255.0


def test_params_round_trip(weights):
    params_np, stats_np, _, _, tparams, tstats = weights
    assert tparams["backbone"]["conv_01"]["w"].shape == (64, 32, 3, 3)  # OIHW
    assert tparams["det3"]["w"].shape == (42, 256, 1, 1)
    back_p, back_s = convert.params_to_jax(tparams, tstats)
    flat_a = jax.tree_util.tree_leaves_with_path(params_np) + \
        jax.tree_util.tree_leaves_with_path(stats_np)
    flat_b = jax.tree_util.tree_leaves_with_path(back_p) + \
        jax.tree_util.tree_leaves_with_path(back_s)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_stem_kernels_match_jax(weights):
    params_np = weights[0]["backbone"]
    w1, w2 = params_np["conv_00"]["w"], params_np["conv_01"]["w"]
    k3, k2 = jdark._stem_kernels(jnp.asarray(w1), jnp.asarray(w2))
    t3, t2 = tdark._stem_kernels(
        torch.from_numpy(w1.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(w2.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(t3.permute(2, 3, 1, 0).numpy(), np.asarray(k3))
    np.testing.assert_array_equal(t2.permute(2, 3, 1, 0).numpy(), np.asarray(k2))


@pytest.mark.parametrize("fast_stem", [True, False])
def test_darknet53_matches_jax(weights, img, fast_stem):
    _, _, jparams, jstats, tparams, tstats = weights
    want = jax.jit(lambda p, s, x: jdark.darknet53(
        p, s, x, fast_stem=fast_stem, fused_early=False)[:3])(
            jparams["backbone"], jstats["backbone"], jnp.asarray(img))
    with torch.no_grad():
        got = tdark.darknet53(tparams["backbone"], tstats["backbone"],
                              torch.from_numpy(img), fast_stem=fast_stem)[:3]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_darknet_weight_file_round_trip(weights, tmp_path):
    tparams, tstats = weights[4]["backbone"], weights[5]["backbone"]
    blob = tdark.export_darknet53_weights(tparams, tstats)
    # byte-identical to the JAX package's exporter on the same weights
    assert blob == jdark.export_darknet53_weights(weights[0]["backbone"],
                                                  weights[1]["backbone"])
    path = tmp_path / "darknet53.conv.74"
    path.write_bytes(blob)
    zp, zs = tdark.init_darknet53(torch.Generator().manual_seed(1))
    lp, ls = tdark.load_darknet53_weights(str(path), zp, zs)
    for name in ("conv_00", "conv_25", "conv_51"):
        assert torch.equal(lp[name]["w"], tparams[name]["w"])
        assert torch.equal(lp[name]["beta"], tparams[name]["beta"])
        assert torch.equal(ls[name]["var"], tstats[name]["var"])
    path.write_bytes(blob + b"\0\0\0\0")
    with pytest.raises(ValueError, match="not fully consumed"):
        tdark.load_darknet53_weights(str(path), zp, zs)


def test_fixed_key_table_identical():
    np.testing.assert_array_equal(tyolo._fixed_key_table(7, 5),
                                  np.asarray(jyolo._fixed_key_table(7, 5)))


def test_mc_forward_fixed_masks_matches_jax(weights, img):
    """T samples stacked on the batch axis == vmap over T, mask for mask."""
    _, _, jparams, jstats, tparams, tstats = weights
    T = 3
    want = jax.jit(lambda p, s, x: jyolo.mc_forward(
        p, s, x, spec=tp.SPEC, T=T, rng=None, fused_early=False, fixed_masks=7))(
            jparams, jstats, jnp.asarray(img))
    with torch.no_grad():
        got = tyolo.mc_forward(tparams, tstats, torch.from_numpy(img), spec=tp.SPEC,
                               T=T, fixed_masks=7)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the samples really differ (dropout is active)
    assert not np.allclose(got[0][0].numpy(), got[0][1].numpy(), atol=1e-3)


@pytest.mark.parametrize("nb", [1, 2])
def test_mc_forward_cf_fixed_masks_matches_jax(weights, nb):
    _, _, jparams, jstats, tparams, tstats = weights
    T = 2
    x = tp.image_u8(seed=2, nb=nb).astype(np.float32) / 255.0
    want = jax.jit(lambda p, s, x: [r for r, _ in jyolo.mc_forward_cf(
        p, s, x, spec=tp.SPEC, T=T, rng=None, fused_early=False, fixed_masks=11)])(
            jparams, jstats, jnp.asarray(x))
    with torch.no_grad():
        got = tyolo.mc_forward_cf(tparams, tstats, torch.from_numpy(x), spec=tp.SPEC,
                                  T=T, fixed_masks=11)
    for (g, hw), w, stride in zip(got, want, (32, 16, 8)):
        assert hw == (64 // stride, 96 // stride)
        assert tuple(g.shape) == w.shape == (42, T, nb * hw[0] * hw[1])
        assert g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_generator_keys_are_seeded(weights, img):
    """Fresh-mask mode: the same generator seed gives the same raws, another
    seed gives other masks."""
    tparams, tstats = weights[4], weights[5]
    x = torch.from_numpy(img)

    def run(seed):
        with torch.no_grad():
            return tyolo.mc_forward(tparams, tstats, x, spec=tp.SPEC, T=2,
                                    rng=torch.Generator().manual_seed(seed))[0]

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        tyolo.mc_forward(tparams, tstats, x, spec=tp.SPEC, T=2)


def test_bf16_fused_early_branch_raises_by_name(weights, img):
    """The fused early backbone is not in this slice: asking for it raises
    and names the slice; fused_early=False runs the plain convolutions."""
    tparams, tstats = weights[4]["backbone"], weights[5]["backbone"]
    x = torch.from_numpy(img)
    with pytest.raises(NotImplementedError, match="fused early backbone"):
        tdark.darknet53(tparams, tstats, x, compute_dtype=torch.bfloat16, fused_early=True)
    with pytest.raises(NotImplementedError, match="fused early backbone"):
        tdark.darknet53(tparams, tstats, x, packed_hw=(64, 96))
    assert tdark._fused_early_auto(x, torch.bfloat16) is False  # CPU tensor


@pytest.mark.parametrize("variant,std_dropout", [("aleatoric", False), ("bayesian", True)])
def test_forward_matches_jax(weights, img, variant, std_dropout):
    """The single dropout-free pass: the aleatoric variant (same head
    widths as the bayesian one), and bayesian with standard_test_dropout."""
    from bayesian_yolov3_tpu.core.blueprint import Variant, VariantSpec

    _, _, jparams, jstats, tparams, tstats = weights
    spec = VariantSpec(Variant(variant), 2)
    want, _ = jax.jit(lambda p, s, x: jyolo.forward(
        p, s, x, spec=spec, standard_test_dropout=std_dropout, fused_early=False))(
            jparams, jstats, jnp.asarray(img))
    with torch.no_grad():
        got = tyolo.forward(tparams, tstats, torch.from_numpy(img), spec=spec,
                            standard_test_dropout=std_dropout)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
