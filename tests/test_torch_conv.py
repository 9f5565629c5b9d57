"""The fused early backbone of the PyTorch port against the JAX package, on
the CPU: the same numpy inputs and weights through the JAX package's Pallas
kernels (``interpret=True``, between ``pack_nhwc_to_flat_cf`` and
``unpack_flat_cf_to_nhwc``, as its own tests run them) and through the port's
plain versions (``ops/cuda_conv.py``; the CUDA kernels themselves are held
against those plain versions on the card by ``chip_smoke.py``).

Tolerances.  Kernel against kernel, both sides round to bf16 at the same
points and accumulate in float32; only the order of the float32 sums differs,
so an element differs where a sum lies on a rounding boundary, by one bf16
step (2^-8 relative), and a flipped intermediate can move an output by a
second step: ``KERNEL_TOL`` is two steps relative plus 0.01 absolute for sums
that cancel to near zero.  Against the JAX package's UNFUSED bf16 path the
residual add rounds at another place (bf16 + bf16 after rounding, where the
fused kernels add in float32 before the one rounding), block after block:
there the JAX package's own bound for that comparison holds
(``tests/test_pallas_conv.py``: rtol = atol = 0.05).  Every assertion message
carries the share of elements that differ at all.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_yolov3_tpu.data.pipeline import pack_planes_host as j_pack_planes_host
from bayesian_yolov3_tpu.models import darknet as jdark
from bayesian_yolov3_tpu.ops import pallas_conv as pc

from bayesian_yolov3_torch.data.pipeline import pack_planes_host
from bayesian_yolov3_torch.models import darknet as tdark
from bayesian_yolov3_torch.ops import cuda_conv as cc

import torch_parity as tp

BF = jnp.bfloat16
KERNEL_TOL = dict(rtol=2.0 ** -6, atol=1e-2)
UNFUSED_TOL = dict(rtol=0.05, atol=0.05)


def _block(seed, k, cin, cout):
    """One conv block's numpy leaves: HWIO kernel of O(1) gain and BN
    statistics that make the folded bias a few tenths, far from 0 (as
    ``tests/test_pallas_conv.py:_params`` draws them), so a border computed as
    conv-of-zeros instead of zero would show."""
    r = np.random.default_rng(seed)
    p = {"w": (r.standard_normal((k, k, cin, cout)) * np.sqrt(2.0 / (k * k * cin))).astype(np.float32),
         "gamma": r.uniform(0.5, 1.5, cout).astype(np.float32),
         "beta": r.normal(0, 0.2, cout).astype(np.float32)}
    s = {"mean": r.normal(0, 0.3, cout).astype(np.float32),
         "var": r.uniform(0.5, 2.0, cout).astype(np.float32)}
    return p, s


def _jbn(p, s, tile=1):
    return pc.fold_bn(*(jnp.tile(jnp.asarray(v), tile)
                        for v in (p["gamma"], p["beta"], s["mean"], s["var"])))


def _tbn(p, s, tile=1):
    return cc.fold_bn(*(torch.from_numpy(v).repeat(tile)
                        for v in (p["gamma"], p["beta"], s["mean"], s["var"])))


def _tw(p):
    return torch.from_numpy(p["w"].transpose(3, 2, 0, 1).copy())  # HWIO -> OIHW


def _tx(x_np):
    return torch.from_numpy(x_np).to(torch.bfloat16)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _assert_close(got, want, name, tol=KERNEL_TOL, ring=False):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    assert np.isfinite(got).all(), f"{name}: non-finite"
    if ring:  # the border ring of an (N, H, W, C) activation on its own
        m = np.zeros(got.shape[1:3], bool)
        m[0], m[-1], m[:, 0], m[:, -1] = True, True, True, True
        got, want = got[:, m], want[:, m]
    err = np.abs(got - want)
    share = float((err > 0).mean())
    bad = err > tol["atol"] + tol["rtol"] * np.abs(want)
    assert not bad.any(), (
        f"{name}: {int(bad.sum())} of {bad.size} elements beyond rtol {tol['rtol']} / atol "
        f"{tol['atol']}; max abs err {err.max():.4g}; {share:.3%} of elements differ at all")
    return share


def test_fold_bn_matches_jax():
    p, s = _block(0, 3, 8, 16)
    for g, w in zip(_tbn(p, s), _jbn(p, s)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _stem_operands(seed=1):
    p0, s0 = _block(seed, 3, 3, 32)
    p1, s1 = _block(seed + 1, 3, 32, 64)
    jk3, jk2 = jdark._stem_kernels(jnp.asarray(p0["w"]).astype(BF), jnp.asarray(p1["w"]).astype(BF))
    tk3, tk2 = tdark._stem_kernels(_tw(p0).to(torch.bfloat16), _tw(p1).to(torch.bfloat16))
    return (jk3, jk2, _jbn(p0, s0, 4), _jbn(p1, s1)), (tk3, tk2, _tbn(p0, s0, 4), _tbn(p1, s1))


def test_fused_stem_matches_jax_kernel():
    n, H, W, wp = 2, 64, 192, 128
    x = np.random.default_rng(0).uniform(0, 1, (n, H, W, 3)).astype(np.float32)
    (jk3, jk2, jbn1, jbn2), (tk3, tk2, tbn1, tbn2) = _stem_operands()
    xf = pc.pack_nhwc_to_flat_cf(jdark._space_to_depth(jnp.asarray(x)), wp, c_pad=16)
    want = pc.unpack_flat_cf_to_nhwc(
        pc.fused_stem_cf(xf, jk3, jk2, jbn1, jbn2, h=H // 2, w_real=W // 2, wp=wp,
                         interpret=True), H // 2, W // 2, wp)
    got = cc.fused_stem(tdark._space_to_depth(_tx(x)), tk3, tk2, tbn1, tbn2)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    _assert_close(got, want, "fused_stem")
    # conv2' pads t1 with exact zeros in front: row 0 and column 0 on their own
    _assert_close(got, want, "fused_stem border ring", ring=True)


def test_fused_stem_front_padding_is_zero_not_conv_of_zeros():
    """The first output row and column see t1 == 0 at row/column -1: shifting
    the image down and right by one s2d pixel over a zero border must NOT
    reproduce them (conv1 of zeros is leaky(bias1) != 0)."""
    _, (tk3, tk2, tbn1, tbn2) = _stem_operands()
    x = tdark._space_to_depth(_tx(np.random.default_rng(3).uniform(0, 1, (1, 16, 32, 3))
                                  .astype(np.float32)))
    y = cc.fused_stem(x, tk3, tk2, tbn1, tbn2)
    shifted = cc.fused_stem(torch.nn.functional.pad(x, (0, 0, 1, 0, 1, 0)), tk3, tk2, tbn1, tbn2)
    assert not torch.allclose(shifted[:, 1:, 1:][:, 0].float(), y[:, 0].float(), atol=1e-2)
    # interior rows do not care
    assert torch.equal(shifted[:, 3:, 3:], y[:, 2:, 2:])


def _res_operands(c, seed):
    pa, sa = _block(seed, 1, c, c // 2)
    pb, sb = _block(seed + 1, 3, c // 2, c)
    return pa, sa, pb, sb


def _j_res(xf, ops, h, w, wp, **kw):
    pa, sa, pb, sb = ops
    return pc.fused_res_block_cf(xf, jnp.asarray(pa["w"]), jnp.asarray(pb["w"]), _jbn(pa, sa),
                                 _jbn(pb, sb), h=h, w_real=w, wp=wp, interpret=True, **kw)


def _t_res(x, ops):
    pa, sa, pb, sb = ops
    return cc.fused_res_block(x, _tw(pa), _tw(pb), _tbn(pa, sa), _tbn(pb, sb))


def test_fused_res_block_matches_jax_kernel():
    n, h, w, c, wp = 2, 16, 200, 64, 256
    x = np.random.default_rng(3).normal(0, 1, (n, h, w, c)).astype(np.float32)
    ops = _res_operands(c, 4)
    want = pc.unpack_flat_cf_to_nhwc(
        _j_res(pc.pack_nhwc_to_flat_cf(jnp.asarray(x), wp), ops, h, w, wp), h, w, wp)
    got = _t_res(_tx(x), ops)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    _assert_close(got, want, "fused_res_block")
    # SAME padding pads t, not x: t is exactly 0 outside the image on all four
    # sides (the 1x1 of a zero pixel would be leaky(bias_a) != 0)
    _assert_close(got, want, "fused_res_block border ring", ring=True)


def test_fused_res_block_pads_t_not_x():
    """A block run on an image embedded in a zero frame differs on the
    image's border ring from the block run on the image alone (inside the
    frame the 1x1 of the zero pixels is leaky(bias_a), not 0) and is equal in
    the interior: the plain version pads t."""
    c = 64
    ops = _res_operands(c, 8)
    x = _tx(np.random.default_rng(5).normal(0, 1, (1, 6, 7, c)).astype(np.float32))
    alone = _t_res(x, ops)
    framed = _t_res(torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)), ops)[:, 1:-1, 1:-1]
    assert torch.equal(framed[:, 1:-1, 1:-1], alone[:, 1:-1, 1:-1])
    assert (framed[:, 0] != alone[:, 0]).float().mean() > 0.5
    assert (framed[:, :, -1] != alone[:, :, -1]).float().mean() > 0.5


@pytest.mark.parametrize("variant", ["split_halves", "phase_packed"])
def test_fused_downsample_matches_jax_kernels(variant):
    """Both TPU stride-2 kernels against the port's one: ``fused_downsample``
    vs ``fused_downsample_cf`` (even / odd column halves), and
    ``fused_downsample_packed`` after a residual block vs
    ``fused_res_block_cf(pack_phases=True)`` -> ``fused_downsample_packed_cf``."""
    n, h, w, c, wp, hw = 2, 32, 200, 64, 256, 128
    x = np.random.default_rng(6).normal(0, 1, (n, h, w, c)).astype(np.float32)
    pd, sd = _block(7, 3, c, 2 * c)
    xf = pc.pack_nhwc_to_flat_cf(jnp.asarray(x), wp)
    if variant == "split_halves":
        even, odd = pc.split_cols_flat(xf, wp)
        want = pc.fused_downsample_cf(even, odd, jnp.asarray(pd["w"]), _jbn(pd, sd),
                                      h_out=h // 2, w_real_out=w // 2, hw=hw, interpret=True)
        got = cc.fused_downsample(_tx(x), _tw(pd), _tbn(pd, sd))
    else:
        ops = _res_operands(c, 12)
        mid = _j_res(xf, ops, h, w, wp, pack_phases=True)
        want = pc.fused_downsample_packed_cf(mid, jnp.asarray(pd["w"]), _jbn(pd, sd),
                                             h_out=h // 2, w_real_out=w // 2, wp_in=wp,
                                             interpret=True)
        got = cc.fused_downsample_packed(_t_res(_tx(x), ops), _tw(pd), _tbn(pd, sd))
    want = pc.unpack_flat_cf_to_nhwc(want, h // 2, w // 2, hw)
    assert tuple(got.shape) == (n, h // 2, w // 2, 2 * c) and got.dtype == torch.bfloat16
    _assert_close(got, want, f"fused_downsample[{variant}]")
    _assert_close(got, want, f"fused_downsample[{variant}] border ring", ring=True)


def test_fused_downsample_odd_extent_against_plain_conv():
    """Odd H and W (the TPU kernels refuse them): against a float64 conv of
    the same bf16 operands with darknet (1,1)x(1,1) padding."""
    c = 64
    x = _tx(np.random.default_rng(9).normal(0, 1, (1, 9, 11, c)).astype(np.float32))
    pd, sd = _block(10, 3, c, 2 * c)
    got = cc.fused_downsample(x, _tw(pd), _tbn(pd, sd))
    assert tuple(got.shape) == (1, 5, 6, 2 * c)
    scale, bias = (v.double() for v in _tbn(pd, sd))
    acc = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.double().permute(0, 3, 1, 2), (1, 1, 1, 1)),
        _tw(pd).to(torch.bfloat16).double(), stride=2)
    want = torch.nn.functional.leaky_relu(
        acc * scale[None, :, None, None] + bias[None, :, None, None], 0.1)
    _assert_close(got, want.permute(0, 2, 3, 1).to(torch.bfloat16), "fused_downsample odd")


@pytest.fixture(scope="module")
def backbone():
    """Seeded backbone weights whose residual branches are damped (BN affine of
    every block's 3x3 times 0.35): the activations then stay at an rms of 1
    to 1.5 through all 52 bf16 convs, so UNFUSED_TOL's absolute 0.05 means
    about 4 % of a tensor's rms at every output.  (Undamped, the trunk grows
    to an rms of 11 at stride 32, and the JAX package's own fused and unfused
    bf16 paths disagree there by up to 0.5.)"""
    params_np, stats_np = tp.numpy_weights(seed=5)
    for i in [3, 6, 8, *range(11, 26, 2), *range(28, 43, 2), *range(45, 52, 2)]:
        block = params_np["backbone"][f"conv_{i:02d}"]
        block["gamma"] *= np.float32(0.35)
        block["beta"] *= np.float32(0.35)
    tparams, tstats = tp.to_torch(params_np, stats_np)
    return (tp.to_jax(params_np["backbone"]), tp.to_jax(stats_np["backbone"]),
            tparams["backbone"], tstats["backbone"])


def _backbones_close(got, want, tol, label):
    for g, w, name in zip(got[:3], want[:3], ("out32", "skip16", "skip8")):
        assert g.dtype == torch.bfloat16
        _assert_close(g, w, f"{label} {name}", tol)


def test_darknet53_bf16_fused_early_matches_jax(backbone):
    """Whole backbone, bf16, fused early stages in both packages.  At this
    geometry the JAX chain hands over to its unfused path after conv 8 (a
    lane-pitch gate of the TPU), the port's runs through conv 25: the eight
    256-wide blocks are compared fused against unfused, so UNFUSED_TOL."""
    jp, js, tparams, tstats = backbone
    x = np.random.default_rng(9).uniform(0, 1, (1, 64, 384, 3)).astype(np.float32)
    want = jdark.darknet53(jp, js, jnp.asarray(x), compute_dtype=BF, fused_early=True)
    with torch.no_grad():
        got = tdark.darknet53(tparams, tstats, torch.from_numpy(x),
                              compute_dtype=torch.bfloat16, fused_early=True)
        h, nxt, skip8 = tdark._fused_early_stages(tparams, tstats, torch.from_numpy(x),
                                                  torch.bfloat16)
    _backbones_close(got, want, UNFUSED_TOL, "darknet53 bf16")
    assert nxt == 26 and skip8 is h and tuple(h.shape) == (1, 8, 48, 256)
    assert torch.equal(h, got[2])


def test_geometry_the_tpu_chain_refuses(backbone):
    """W/2 a multiple of 256: the TPU chain has no dead lanes there and
    asserts; the port has no such rule.  Held against the JAX package's
    unfused bf16 backbone."""
    jp, js, tparams, tstats = backbone
    x = np.random.default_rng(512).uniform(0, 1, (1, 32, 512, 3)).astype(np.float32)
    with pytest.raises(AssertionError, match="multiple of 256"):
        jdark.darknet53(jp, js, jnp.asarray(x), compute_dtype=BF, fused_early=True)
    want = jdark.darknet53(jp, js, jnp.asarray(x), compute_dtype=BF, fused_early=False)
    with torch.no_grad():
        got = tdark.darknet53(tparams, tstats, torch.from_numpy(x),
                              compute_dtype=torch.bfloat16, fused_early=True)
    _backbones_close(got, want, UNFUSED_TOL, "W=512")


def test_pack_planes_host_is_byte_equal_to_jax():
    img = np.random.default_rng(11).integers(0, 256, (64, 384, 3), dtype=np.uint8)
    got, want = pack_planes_host(img), j_pack_planes_host(img)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (16, 48 * 256)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="even-sized uint8"):
        pack_planes_host(img[:63])


def test_darknet53_packed_input_matches_image_fed(backbone):
    """Host-packed uint8 planes against the NHWC image, in the port and
    against the JAX package's packed call.  The two feeds round the input
    differently (u8 -> bf16, times bf16(1/255), against float/255 -> bf16):
    one bf16 step on the pixels, so UNFUSED_TOL after 52 convs."""
    jp, js, tparams, tstats = backbone
    img = np.random.default_rng(12).integers(0, 256, (64, 384, 3), dtype=np.uint8)
    planes = pack_planes_host(img)[None]
    with torch.no_grad():
        fed = tdark.darknet53(tparams, tstats, torch.from_numpy(img[None]).float() / 255.0,
                              compute_dtype=torch.bfloat16, fused_early=True)
        got = tdark.darknet53(tparams, tstats, torch.from_numpy(planes),
                              compute_dtype=torch.bfloat16, packed_hw=(64, 384))
    _backbones_close(got, [_f32(f) for f in fed[:3]], UNFUSED_TOL, "packed vs image")
    want = jdark.darknet53(jp, js, jnp.asarray(planes), compute_dtype=BF, packed_hw=(64, 384))
    _backbones_close(got, want, UNFUSED_TOL, "packed vs JAX packed")
    with pytest.raises(ValueError, match="packed input"):
        tdark.darknet53(tparams, tstats, torch.from_numpy(planes), packed_hw=(32, 384))


def test_packed_stem_input_rounds_as_jax():
    """u8 -> bf16 times bf16(1/255), exactly the JAX package's values."""
    u8 = np.arange(256, dtype=np.uint8)
    want = np.asarray((jnp.asarray(u8).astype(BF) * jnp.bfloat16(1.0 / 255.0)).astype(jnp.float32))
    got = torch.from_numpy(u8).to(torch.bfloat16) * tdark._INV255_BF16
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("case", ["dtype", "channels", "rank", "kernel_shape", "bn_dtype",
                                  "bn_shape", "stem_channels", "down_channels"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    c = 64
    x = torch.zeros((1, 4, 4, c), dtype=torch.bfloat16)
    wa, wb = torch.zeros(c // 2, c, 1, 1), torch.zeros(c, c // 2, 3, 3)
    bna = (torch.ones(c // 2), torch.zeros(c // 2))
    bnb = (torch.ones(c), torch.zeros(c))
    wd, bnd = torch.zeros(2 * c, c, 3, 3), (torch.ones(2 * c), torch.zeros(2 * c))
    if case == "dtype":
        with pytest.raises(TypeError, match="bf16 activations"):
            cc.fused_res_block(x.float(), wa, wb, bna, bnb)
    elif case == "channels":
        with pytest.raises(ValueError, match="C in"):
            cc.fused_res_block(x[..., :32], wa, wb, bna, bnb)
    elif case == "rank":
        with pytest.raises(ValueError, match="activation shape"):
            cc.fused_downsample(x[0], wd, bnd)
    elif case == "kernel_shape":
        with pytest.raises(ValueError, match="OIHW"):
            cc.fused_res_block(x, wa, wb.permute(2, 3, 1, 0), bna, bnb)
    elif case == "bn_dtype":
        with pytest.raises(TypeError, match="float32"):
            cc.fused_downsample(x, wd, (bnd[0].double(), bnd[1]))
    elif case == "bn_shape":
        with pytest.raises(TypeError, match="shape"):
            cc.fused_res_block(x, wa, wb, bnb, bnb)
    elif case == "stem_channels":
        with pytest.raises(ValueError, match=r"C in \(12,\)"):
            cc.fused_stem(x, torch.zeros(128, 12, 3, 3), torch.zeros(64, 128, 2, 2),
                          (torch.ones(128), torch.zeros(128)), bnb)
    else:
        with pytest.raises(ValueError, match="C in"):
            cc.fused_downsample_packed(torch.zeros((1, 4, 4, 256), dtype=torch.bfloat16),
                                       torch.zeros(512, 256, 3, 3),
                                       (torch.ones(512), torch.zeros(512)))


def test_launch_counters_count_only_launches():
    """On CPU tensors the wrappers take the plain versions and launch nothing."""
    before = dict(cc.launch_counts)
    assert set(before) == {"fused_stem", "fused_res_block", "fused_downsample"}
    _t_res(torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16), _res_operands(64, 0))
    assert cc.launch_counts == before
