"""Backbone and heads of the PyTorch port against the JAX package: the same
seeded numpy weights and image through both, on the CPU; float32 unless a
test says bf16.

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


def test_darknet53_batch_statistics_match_jax(weights, img):
    """An unfrozen backbone in training: every block with batch statistics
    through the plain convolutions; the three outputs and the 52 blocks'
    advanced moving statistics against the JAX package's.  Outputs at rtol
    1e-4 / atol 1e-3: each of 52 blocks normalises by statistics of its own
    batch, so float32 rounding carries further than through moving
    statistics (TOL); statistics at rtol 1e-5, atol 1e-6 for means near 0."""
    _, _, jparams, jstats, tparams, tstats = weights
    x = np.concatenate([img, img[:, ::-1]])  # two images: statistics over the batch
    *want, want_stats = jax.jit(lambda p, s, x: jdark.darknet53(p, s, x, training=True))(
        jparams["backbone"], jstats["backbone"], jnp.asarray(x))
    with torch.no_grad():
        *got, got_stats = tdark.darknet53(tparams["backbone"], tstats["backbone"],
                                          torch.from_numpy(x.copy()), training=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3)
    assert set(got_stats) == set(want_stats) and len(got_stats) == 52
    for name, blk in got_stats.items():
        for k, v in blk.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want_stats[name][k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name}/{k}")
    with pytest.raises(ValueError, match="plain backbone"):
        tdark.darknet53(tparams["backbone"], tstats["backbone"], torch.from_numpy(x.copy()),
                        training=True, fused_early=True)


def test_darknet_weight_file_round_trip(weights, tmp_path):
    tparams, tstats = weights[4]["backbone"], weights[5]["backbone"]
    blob = tdark.export_darknet53_weights(tparams, tstats)
    # byte-identical to the JAX package's exporter on the same weights
    assert blob == jdark.export_darknet53_weights(weights[0]["backbone"],
                                                  weights[1]["backbone"])
    path = tmp_path / "darknet53.conv.74"
    try:
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
    finally:
        path.unlink(missing_ok=True)  # 155 MB: not left in pytest's temp root


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


def test_bf16_fused_early_branch_runs_on_a_cpu_tensor(weights, img, monkeypatch):
    """``fused_early=True`` on a CPU tensor takes the fused kernels' plain
    versions (as the JAX package runs its kernels in interpret mode off the
    TPU); the auto-gate keeps a CPU tensor on the plain convolutions; host
    planes imply the fused branch."""
    from bayesian_yolov3_torch.data.pipeline import pack_planes_host
    from bayesian_yolov3_torch.ops import cuda_conv

    tparams, tstats = weights[4]["backbone"], weights[5]["backbone"]
    x = torch.from_numpy(img)
    assert tdark._fused_early_auto(x, torch.bfloat16) is False  # CPU tensor
    assert tdark._fused_early_auto(x, torch.float32) is False
    calls = []
    real = cuda_conv.fused_res_block

    def counting(*a, **kw):
        calls.append(a[0].shape[3])
        return real(*a, **kw)

    monkeypatch.setattr(cuda_conv, "fused_res_block", counting)
    with torch.no_grad():
        fused = tdark.darknet53(tparams, tstats, x, compute_dtype=torch.bfloat16,
                                fused_early=True)
        auto = tdark.darknet53(tparams, tstats, x, compute_dtype=torch.bfloat16)
        assert calls == [64, 128, 128] + [256] * 8  # the 11 blocks of convs 2-25
        planes = torch.from_numpy(pack_planes_host(tp.image_u8(seed=1)[0])[None])
        packed = tdark.darknet53(tparams, tstats, planes, packed_hw=(64, 96),
                                 compute_dtype=torch.bfloat16)
        assert len(calls) == 22
    with torch.no_grad():
        plain = tdark.darknet53(tparams, tstats, x, compute_dtype=torch.bfloat16,
                                fused_early=False)
    for a, b in zip(auto[:3], plain[:3]):
        assert torch.equal(a, b)  # auto on the CPU == the plain convolutions
    for f, p, k in zip(fused[:3], plain[:3], packed[:3]):
        assert f.dtype == k.dtype == torch.bfloat16 and f.shape == p.shape == k.shape
        # same function up to bf16 rounding points: relative L2 distance
        assert float((f.float() - p.float()).norm() / p.float().norm()) < 0.02
        assert float((k.float() - f.float()).norm() / f.float().norm()) < 0.02


def test_mc_forward_cf_bf16_fused_early_matches_jax(weights, img):
    """The whole bf16 path up to the raw heads: bf16, fused early backbone,
    fixed masks, T=4, in both packages (JAX: Pallas kernels in interpret mode
    for convs 0-8, its unfused bf16 path after; port: the fused chain's plain
    versions through conv 25).

    Bound: 75 bf16 convs and 15 dropout sites, whose sums and roundings fall
    in other places in the two frameworks, leave no elementwise bound of a few
    percent (the JAX package's own bf16 heads miss its float32 heads by up to
    7 % of their rms in single elements).  Held instead: the relative L2
    distance of the port's bf16 heads to the JAX package's bf16 heads is below
    0.02 (measured 0.008-0.013) AND below the distance of the JAX package's
    bf16 heads to its own float32 heads (measured 0.014-0.025)."""
    _, _, jparams, jstats, tparams, tstats = weights
    T = 4

    def jax_heads(dtype, fused):
        return [np.asarray(r) for r, _ in jyolo.mc_forward_cf(
            jparams, jstats, jnp.asarray(img), spec=tp.SPEC, T=T, rng=None,
            compute_dtype=dtype, fused_early=fused, fixed_masks=7)]

    want, ref32 = jax_heads(jnp.bfloat16, True), jax_heads(jnp.float32, False)
    with torch.no_grad():
        got = tyolo.mc_forward_cf(tparams, tstats, torch.from_numpy(img), spec=tp.SPEC, T=T,
                                  fixed_masks=7, compute_dtype=torch.bfloat16, fused_early=True)

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for (g, hw), w, f, stride in zip(got, want, ref32, (32, 16, 8)):
        assert hw == (64 // stride, 96 // stride)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape == (42, T, hw[0] * hw[1])
        d, floor = rel_l2(g.numpy(), w), rel_l2(w, f)
        assert d < 0.02 and d < floor, (stride, d, floor)


def test_bf16_dropout_divides_as_jax():
    """bf16 activations are divided by keep in bf16's own precision (a weakly
    typed scalar in the JAX package: 0.8984375, not 0.9), bit for bit."""
    from bayesian_yolov3_tpu.ops import common as jcommon
    from bayesian_yolov3_torch.ops import common as tcommon

    x = np.random.default_rng(0).normal(0, 2, (1, 5, 7, 16)).astype(np.float32)
    want = jcommon.dropout(jnp.asarray(x).astype(jnp.bfloat16), 0.1, None, key_u32=1234)
    got = tcommon.dropout(torch.from_numpy(x).to(torch.bfloat16), 0.1, 1234)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_detection_conv_cf_bf16_keeps_float32_logits():
    """bf16 operands, float32 accumulator and output: the logits are not
    rounded to bf16 (the JAX package's preferred_element_type)."""
    from bayesian_yolov3_torch.ops import common as tcommon

    r = np.random.default_rng(1)
    feats = torch.from_numpy(r.normal(0, 1, (2, 1, 3, 4, 64)).astype(np.float32))
    params = {"w": torch.from_numpy(r.normal(0, 0.2, (21, 64, 1, 1)).astype(np.float32)),
              "b": torch.from_numpy(r.normal(0, 1, 21).astype(np.float32))}
    got = tcommon.detection_conv_cf(params, feats, compute_dtype=torch.bfloat16)
    want = torch.einsum("oc,tmc->otm", params["w"].reshape(21, 64).to(torch.bfloat16).double(),
                        feats.reshape(2, 12, 64).to(torch.bfloat16).double())
    want = want + params["b"].double()[:, None, None]
    assert got.dtype == torch.float32 and tuple(got.shape) == (21, 2, 12)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    # a bf16-rounded output would miss by up to 2^-9 relative
    assert float((got.double() - want).abs().max()) < 1e-4


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
