"""The port's int8 head section on the CPU against the JAX package's
(``ops/quant.py``, ``models/quant.py``): the same numpy weights, images,
calibration maxima and fixed dropout masks in both.

What is held bit for bit: the int8 weights and their dequant scales, the
entry and output scales, the int8 activations, the int32 accumulators of
the convs (1x1 and 3x3, im2col order included) and of the detection
product, the epilogue (dequant, hash dropout, BN, leaky, requant) with and
without keys, the int8 head features, and the raw heads of both forwards
in float32 from the same int8 entries.  No int8 step was found to differ
there, so the tests allow none.  What is not: the folded BN vectors,
within 2 float32 ulps — the JAX package's CPU ``rsqrt`` is not correctly
rounded (it differs from the exact value in 15 % of inputs, torch's
``1/sqrt`` in 30 %); the float32 detection outputs, within rtol 1e-6
(XLA may contract the dequant and the bias into one FMA); the calibration
maxima, at rtol 1e-5, and the entry quantization of the two float32
backbones, one step apart in at most 1e-3 of the entries (float32 sums in
another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayesian_yolov3_tpu.core.blueprint import Variant, VariantSpec
from bayesian_yolov3_tpu.models import darknet as j_darknet
from bayesian_yolov3_tpu.models import quant as j_mquant
from bayesian_yolov3_tpu.models.yolov3 import _fixed_key_table as j_fixed_key_table
from bayesian_yolov3_tpu.models.yolov3 import _heads as j_heads
from bayesian_yolov3_tpu.models.yolov3 import init_yolov3 as j_init_yolov3
from bayesian_yolov3_tpu.ops import quant as j_quant
from bayesian_yolov3_tpu.ops.common import dropout as j_dropout
from bayesian_yolov3_tpu.ops.common import leaky_relu as j_leaky_relu

from bayesian_yolov3_torch import convert
from bayesian_yolov3_torch.models import quant as p_mquant
from bayesian_yolov3_torch.models import yolov3 as p_yolov3
from bayesian_yolov3_torch.ops import common, cuda_quant
from bayesian_yolov3_torch.ops import quant as p_quant

import torch_parity as tp

T = 4
SEED = 7  # fixed_masks seed: one (T, 15) key table in both packages
BLOCKS = ([f"head{h}_conv{j}" for h in (1, 2, 3) for j in range(6)] + ["trans1", "trans2"])


@pytest.fixture(scope="module")
def weights():
    params_np, stats_np = tp.numpy_weights(seed=3)
    for i in (1, 2, 3):  # raw logits of a few units, not tens
        params_np[f"det{i}"]["w"] *= np.float32(0.2)
    return params_np, stats_np


@pytest.fixture(scope="module")
def img():
    return tp.image_u8(seed=4).astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def heads(weights, img):
    """JAX's quantized heads, calibrated by JAX on the image (its own keys),
    as numpy; and the three backbone outputs quantized at its entry
    scales."""
    jp, js = tp.to_jax(weights[0]), tp.to_jax(weights[1])
    amax = j_quant.calibrate_mc_amax(jp, js, jnp.asarray(img), spec=tp.SPEC, T=T,
                                     rng=jax.random.PRNGKey(1))
    qh = j_quant.quantize_heads(jp, js, tp.SPEC, amax)
    outs = j_darknet.darknet53(jp["backbone"], js["backbone"], jnp.asarray(img),
                               training=False)[:3]
    entry = [np.array(j_quant.quantize_act(o, qh["entry"][k]))
             for o, k in zip(outs, ("out32", "skip16", "skip8"))]
    return {"amax": amax, "qh": jax.tree.map(np.asarray, qh), "entry": entry}


def _jax_qh(heads):
    return jax.tree.map(jnp.asarray, heads["qh"])


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 3, 64, 32), (1, 1, 96, 42), (96, 42)])
def test_quantize_weight_per_channel_matches_jax(shape):
    """Per output channel: JAX's last axis, the port's first (OIHW, or
    (ch, cin) for a detection kernel)."""
    w = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel: the 1e-12 floor of the scale
    want_q, want_s = (np.asarray(a) for a in j_quant.quantize_weight_per_channel(w))
    oihw = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
    got_q, got_s = p_quant.quantize_weight_per_channel(torch.from_numpy(oihw.copy()))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    back = got_q.numpy().transpose(2, 3, 1, 0) if w.ndim == 4 else got_q.numpy().T
    np.testing.assert_array_equal(back, want_q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_matches_jax(dtype):
    x = np.random.default_rng(1).standard_normal((3, 5, 7, 16)).astype(np.float32) * 3.0
    x[0, 0, 0, :4] = [0.5 / 21.7, 1.5 / 21.7, -2.5 / 21.7, 1e3]  # ties near .5, saturation
    inv = float(np.float32(21.7))
    want = np.asarray(j_quant.quantize_act(jnp.asarray(x).astype(dtype), jnp.float32(inv)))
    got = p_quant.quantize_act(torch.from_numpy(x).to(getattr(torch, dtype)), inv)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,cin,cout", [(1, 64, 32), (3, 64, 32), (3, 24, 16), (3, 12, 8)])
def test_conv2d_int8_matches_jax(k, cin, cout):
    """int32 accumulators bit for bit: the im2col column order (kh, kw, cin)
    against the OIHW kernel's flattening, SAME padding at every border; cin
    a multiple of 8 (copied as int64 words) and not (byte by byte)."""
    rng = np.random.default_rng(k * cin)
    x = rng.integers(-127, 128, (2, 5, 7, cin), dtype=np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    want = np.asarray(j_quant.conv2d_int8(jnp.asarray(x), jnp.asarray(w)))
    got = p_quant.conv2d_int8(torch.from_numpy(x),
                              torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nhw", [(1, 2, 3), (2, 2, 4), (1, 1, 17)])
def test_conv2d_int8_few_rows_matches_jax(nhw):
    """Fewer rows of the int8 product than the card's minimum of 17 (one
    sample of a 64x96 image's 2x3 map at stride 32 has 6): zero-padded to
    17 and the padding dropped, bit for bit against the JAX package."""
    rng = np.random.default_rng(sum(nhw))
    x = rng.integers(-127, 128, (*nhw, 16), dtype=np.int8)
    w = rng.integers(-127, 128, (3, 3, 16, 8), dtype=np.int8)
    want = np.asarray(j_quant.conv2d_int8(jnp.asarray(x), jnp.asarray(w)))
    got = p_quant.conv2d_int8(torch.from_numpy(x),
                              torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    assert got.shape == (*nhw, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ch", [42, 21, 48])
def test_detection_product_matches_jax(ch):
    """The int8 detection product (weight rows zero-padded to a multiple of
    8 where ch is not): int32 bit for bit against JAX's dot_general; the
    float32 output within rtol 1e-6."""
    rng = np.random.default_rng(ch)
    feats = rng.integers(-127, 128, (3, 1, 4, 6, 64), dtype=np.int8)
    qp = {"wq": rng.integers(-127, 128, (64, ch), dtype=np.int8),
          "dq": rng.uniform(1e-4, 1e-3, ch).astype(np.float32),
          "b": rng.standard_normal(ch).astype(np.float32)}
    want_acc = np.asarray(jax.lax.dot_general(
        jnp.asarray(qp["wq"]), jnp.asarray(feats.reshape(3, 24, 64)),
        dimension_numbers=(((0,), (2,)), ((), ())), preferred_element_type=jnp.int32))
    want = np.asarray(j_quant.quant_detection_cf({k: jnp.asarray(v) for k, v in qp.items()},
                                                 jnp.asarray(feats)))
    pqp = convert.qheads_from_jax({"det": qp})["det"]
    acc = p_quant.detection_acc_int8(pqp["wq"], torch.from_numpy(feats))
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    got = p_quant.quant_detection_cf(pqp, torch.from_numpy(feats))
    assert got.shape == (ch, 3, 24) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_quantize_heads_matches_jax(weights, heads):
    """The port's quantize_heads from the same params and maxima: every int8
    kernel, dequant scale, bias and scale bit for bit; the folded BN within
    2 float32 ulps (the two packages' rsqrt round differently)."""
    tparams, tstats = tp.to_torch(*weights)
    got = p_quant.quantize_heads(tparams, tstats, tp.SPEC, heads["amax"])
    want = convert.qheads_from_jax(heads["qh"])
    assert set(got) == set(want) == set(BLOCKS) | {"det1", "det2", "det3", "entry"}
    assert got["entry"] == want["entry"]
    for name in BLOCKS + ["det1", "det2", "det3"]:
        g, w = got[name], want[name]
        assert set(g) == set(w)
        for key in set(g) - {"bns", "bnb"}:
            if isinstance(w[key], float):
                assert g[key] == w[key], (name, key)
            else:
                assert g[key].dtype == w[key].dtype and torch.equal(g[key], w[key]), (name, key)
        for key in {"bns", "bnb"} & set(g):
            torch.testing.assert_close(g[key], w[key], rtol=2.5e-7, atol=6e-8)


def _jax_epilogue(qp, acc, keys):
    """JAX quant_block's epilogue (ops/quant.py:87-92), one sample per key
    (vmapped, as mc_forward_cf_q runs it)."""

    def one(a, key):
        y = a.astype(jnp.float32) * qp["dq"]
        if key is not None:
            y = j_dropout(y, 0.1, None, key_u32=key)
        return j_quant.quantize_act(j_leaky_relu(y * qp["bns"] + qp["bnb"]), qp["inv_out"])

    if keys is None:
        return np.asarray(jax.jit(lambda a: one(a, None))(acc))
    return np.asarray(jax.jit(jax.vmap(one))(acc, jnp.asarray(keys, jnp.uint32)))


@pytest.mark.parametrize("keys", [None, [987654321], [5, 4000000000, 77]])
def test_quant_epilogue_plain_matches_jax(heads, keys):
    """The epilogue's plain version against JAX's on the same int32
    accumulators (a head-3 3x3 block's scales; accumulators up to 2^26, past
    float32's exact integers), with and without dropout keys, one and three
    stacked samples: bit for bit."""
    qp = heads["qh"]["head3_conv1"]
    s = 1 if keys is None else len(keys)
    acc = np.random.default_rng(s).integers(-2 ** 26, 2 ** 26, (s, 2, 8, 12, 256),
                                            dtype=np.int32)
    want = _jax_epilogue({k: jnp.asarray(v) for k, v in qp.items()},
                         jnp.asarray(acc[0] if keys is None else acc), keys)
    pqp = convert.qheads_from_jax({"b": qp})["b"]
    before = cuda_quant.launch_count
    got = cuda_quant.quant_epilogue(torch.from_numpy(acc).reshape(-1, 256), pqp["dq"],
                                    pqp["bns"], pqp["bnb"], pqp["inv_out"], keys=keys)
    assert cuda_quant.launch_count == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    if keys is not None:  # about 10 % of the elements dropped to bnb's requant
        assert 0.05 < float(np.mean(got.numpy() == p_quant.quantize_act(
            pqp["bnb"].expand(got.shape), pqp["inv_out"]).numpy())) < 0.5


def test_quant_epilogue_refuses_what_it_does_not_take():
    acc = torch.zeros((6, 8), dtype=torch.int32)
    vec = torch.ones(8)
    with pytest.raises(TypeError, match="int32"):
        cuda_quant.quant_epilogue(acc.float(), vec, vec, vec, 1.0)
    with pytest.raises(ValueError, match="split into 4 samples"):
        cuda_quant.quant_epilogue(acc, vec, vec, vec, 1.0, keys=[1, 2, 3, 4])
    with pytest.raises(ValueError, match="bns"):
        cuda_quant.quant_epilogue(acc, vec, torch.ones(7), vec, 1.0)


def test_upsample_and_concat_keep_int8():
    x = torch.arange(-12, 12, dtype=torch.int8).reshape(1, 2, 3, 4)
    y = common.upsample2x(x)
    assert y.dtype == torch.int8 and y.shape == (1, 4, 6, 4)
    assert torch.equal(y[0, 1::2, 1::2], x[0]) and torch.equal(y[0, ::2, ::2], x[0])


# --------------------------------------------------------------------------
# calibration
# --------------------------------------------------------------------------


@pytest.mark.parametrize("variant", [Variant.ALEATORIC, Variant.STANDARD])
def test_calibrate_forward_amax_matches_jax(variant):
    """The batched calibration (no dropout in these variants): the same
    sites and maxima, rtol 1e-5 (the maxima of float32 chains of up to 72
    convs summed in another order: 1.2e-6 apart at worst on these
    inputs)."""
    spec = VariantSpec(variant, 2)
    params_np, stats_np = tp.numpy_weights(seed=5, spec=spec)
    imgs = np.stack([tp.image_u8(seed=s)[0] for s in (6, 7)]).astype(np.float32) / 255.0
    want = j_quant.calibrate_forward_amax(tp.to_jax(params_np), tp.to_jax(stats_np),
                                          jnp.asarray(imgs), spec=spec)
    tparams, tstats = tp.to_torch(params_np, stats_np)
    got = p_quant.calibrate_forward_amax(tparams, tstats, torch.from_numpy(imgs), spec=spec)
    assert set(got) == set(want) == set(BLOCKS) | {"out32", "skip16", "skip8"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def _jax_mc_amax(weights, img, table, percentile):
    """JAX's calibrate_mc_amax under an injected key table: the backbone
    once, then ``_heads(..., fixed_site_keys=row, capture=cap)`` per sample,
    each site reduced per sample by ``ops/quant.py:_site_reduce``."""
    jp, js = tp.to_jax(weights[0]), tp.to_jax(weights[1])
    out32, skip16, skip8, _ = j_darknet.darknet53(jp["backbone"], js["backbone"],
                                                  jnp.asarray(img), training=False)

    def one_sample(site_keys):
        cap = {}
        j_heads(jp, js, out32, skip16, skip8, spec=tp.SPEC, training=False,
                dropout_active=True, fixed_site_keys=site_keys, return_features=True,
                capture=cap)
        return {n: j_quant._site_reduce(v, percentile) for n, v in cap.items()}

    per_sample = jax.jit(jax.vmap(one_sample))(jnp.asarray(table))
    out = {n: float(jnp.max(v)) for n, v in per_sample.items()}
    out.update({n: float(j_quant._site_reduce(v, percentile))
                for n, v in (("out32", out32), ("skip16", skip16), ("skip8", skip8))})
    return out


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibrate_mc_amax_matches_jax_under_one_key_table(weights, img, percentile):
    """The MC calibration with the same (T, 15) key table in both packages
    (the packages draw their own keys differently, so only an injected table
    is compared): max-abs and the 99.9th percentile, rtol 1e-5 (float32
    chains summed in another order: 1.1e-6 apart at worst here)."""
    table = j_fixed_key_table(SEED, T)
    want = _jax_mc_amax(weights, img, table, percentile)
    tparams, tstats = tp.to_torch(*weights)
    got = p_quant.calibrate_mc_amax(tparams, tstats, torch.from_numpy(img), spec=tp.SPEC, T=T,
                                    rng=table, percentile=percentile)
    assert set(got) == set(want) == set(BLOCKS) | {"out32", "skip16", "skip8"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    if percentile is not None:
        assert all(got[k] < p_quant.calibrate_mc_amax(
            tparams, tstats, torch.from_numpy(img), spec=tp.SPEC, T=T, rng=table)[k]
            for k in ("head3_conv1", "out32"))


def test_percentile_beyond_quantile_limit():
    """``torch.quantile`` refuses more than 2^24 elements; the port's
    percentile does not, and agrees with ``jnp.percentile``'s linear
    interpolation at rtol 1e-6."""
    a = np.abs(np.random.default_rng(2).standard_normal((1 << 24) + 5).astype(np.float32))
    got = float(p_quant._percentile(torch.from_numpy(a), 99.9))
    np.testing.assert_allclose(got, float(jnp.percentile(jnp.asarray(a), 99.9)), rtol=1e-6)


def test_capture_records_every_block(weights, img):
    """``_heads(capture=)`` stores each of the 20 conv blocks' post-LeakyReLU
    outputs under its name, T samples stacked."""
    tparams, tstats = tp.to_torch(*weights)
    from bayesian_yolov3_torch.models import darknet

    out32, skip16, skip8, _ = darknet.darknet53(tparams["backbone"], tstats["backbone"],
                                                torch.from_numpy(img))
    cap = {}
    feats = p_yolov3._heads(tparams, tstats, out32, skip16, skip8,
                            site_keys=p_yolov3._fixed_key_table(SEED, T),
                            return_features=True, capture=cap)
    assert set(cap) == set(BLOCKS)
    assert cap["trans1"].shape == (T, 2, 3, 256) and cap["head3_conv5"].shape == (T, 8, 12, 256)
    assert all(torch.equal(f, cap[f"head{h}_conv5"]) for h, f in enumerate(feats, 1))
    assert min(float(v.min()) for v in cap.values()) < 0  # post-leaky: small negatives


# --------------------------------------------------------------------------
# the int8 forwards
# --------------------------------------------------------------------------


def test_heads_q_matches_jax(heads):
    """The int8 head section from the same int8 entries, heads and key
    table: every int8 feature bit for bit (JAX vmaps the samples, the port
    stacks them sample-major)."""
    qh = _jax_qh(heads)
    table = j_fixed_key_table(SEED, T)
    q32, qs16, qs8 = (jnp.asarray(e) for e in heads["entry"])
    want = jax.jit(jax.vmap(lambda k: j_mquant._heads_q(qh, q32, qs16, qs8,
                                                        fixed_site_keys=k)))(jnp.asarray(table))
    got = p_mquant._heads_q(convert.qheads_from_jax(heads["qh"]),
                            *(torch.from_numpy(e) for e in heads["entry"]), site_keys=table)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), w.reshape(-1, *w.shape[2:]))


def _port_entries(qh, tparams, tstats, imgs):
    """The port's float32 backbone outputs quantized at the entry scales."""
    from bayesian_yolov3_torch.models import darknet

    outs = darknet.darknet53(tparams["backbone"], tstats["backbone"], imgs)[:3]
    return [p_quant.quantize_act(o, qh["entry"][k])
            for o, k in zip(outs, ("out32", "skip16", "skip8"))]


def _assert_entries_near_jax(got, jax_qh, jp, js, imgs):
    """Entry quantization of the two float32 backbones: a value on a rounding
    boundary may land one int8 step apart (float32 sums in another order);
    at most 1e-3 of the entries, by one step."""
    outs = j_darknet.darknet53(jp["backbone"], js["backbone"], jnp.asarray(imgs),
                               training=False)[:3]
    for g, o, k in zip(got, outs, ("out32", "skip16", "skip8")):
        w = np.asarray(j_quant.quantize_act(o, jax_qh["entry"][k])).astype(int)
        d = np.abs(g.numpy().astype(int) - w)
        assert d.max() <= 1 and d.mean() <= 1e-3, (k, d.max(), d.mean())


def _assert_raws_near(got, want):
    """End to end against the JAX forward, whose entries may differ from the
    port's by a step (above): on random weights one such step moves the raws
    of its image by a few percent (2-3 % relative L2 for the one step of
    1 in 12288 entries found), so correlation > 0.998 and relative L2 < 0.05."""
    for (g, _), (w, _) in zip(got, want):
        a, b = np.asarray(w, np.float64).ravel(), g.double().numpy().ravel()
        assert np.corrcoef(a, b)[0, 1] > 0.998
        assert np.linalg.norm(a - b) / np.linalg.norm(a) < 0.05


def test_mc_forward_cf_q_matches_jax(weights, heads, img):
    """The T-sample epistemic int8 forward, float32 backbone, fixed masks,
    the same quantized heads in both: the raws equal, at rtol 1e-6, JAX's
    int8 heads and detection product run on the port's int8 entries; and
    JAX's own mc_forward_cf_q within ``_assert_raws_near``."""
    tparams, tstats = tp.to_torch(*weights)
    pqh = convert.qheads_from_jax(heads["qh"])
    x = torch.from_numpy(img)
    got = p_mquant.mc_forward_cf_q(pqh, tparams, tstats, x, spec=tp.SPEC, T=T,
                                   compute_dtype=torch.float32, fixed_masks=SEED)
    entries = _port_entries(pqh, tparams, tstats, x)
    jp, js = tp.to_jax(weights[0]), tp.to_jax(weights[1])
    qh = _jax_qh(heads)
    _assert_entries_near_jax(entries, qh, jp, js, img)
    feats = jax.jit(jax.vmap(lambda k: j_mquant._heads_q(qh, *map(jnp.asarray, entries),
                                                         fixed_site_keys=k)))(
        jnp.asarray(j_fixed_key_table(SEED, T)))
    for (g, hw), f, h in zip(got, feats, (1, 2, 3)):
        w = np.asarray(j_quant.quant_detection_cf(qh[f"det{h}"], f))
        assert tuple(hw) == tuple(f.shape[2:4]) and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    _assert_raws_near(got, j_mquant.mc_forward_cf_q(qh, jp, js, jnp.asarray(img), spec=tp.SPEC,
                                                    T=T, rng=None, compute_dtype=jnp.float32,
                                                    fixed_masks=SEED))


@pytest.mark.parametrize("variant", [Variant.ALEATORIC, Variant.BAYESIAN])
def test_forward_cf_q_matches_jax(variant):
    """The batched int8 forward over two images, heads quantized by JAX from
    its own calibration: aleatoric (no dropout) and bayesian with dropout
    under one (1, 15) key table in both.  The raws equal, at rtol 1e-6,
    JAX's int8 heads and detection product on the port's int8 entries; the
    aleatoric ones also JAX's own forward_cf_q within ``_assert_raws_near``
    (JAX's batched forward draws its bayesian keys itself)."""
    spec = VariantSpec(variant, 2)
    params_np, stats_np = tp.numpy_weights(seed=8, spec=spec)
    for i in (1, 2, 3):
        params_np[f"det{i}"]["w"] *= np.float32(0.2)
    jp, js = tp.to_jax(params_np), tp.to_jax(stats_np)
    imgs = np.stack([tp.image_u8(seed=s)[0] for s in (9, 10)]).astype(np.float32) / 255.0
    amax = j_quant.calibrate_forward_amax(jp, js, jnp.asarray(imgs), spec=spec,
                                          rng=jax.random.PRNGKey(3))
    qh = j_quant.quantize_heads(jp, js, spec, amax)
    pqh = convert.qheads_from_jax(jax.tree.map(np.asarray, qh))
    tparams, tstats = tp.to_torch(params_np, stats_np)
    x = torch.from_numpy(imgs)
    table = j_fixed_key_table(SEED, 1)
    got = p_mquant.forward_cf_q(pqh, tparams, tstats, x, spec=spec, rng=table,
                                compute_dtype=torch.float32)
    entries = _port_entries(pqh, tparams, tstats, x)
    _assert_entries_near_jax(entries, qh, jp, js, imgs)
    drop = spec.mc_dropout
    feats = j_mquant._heads_q(qh, *map(jnp.asarray, entries), dropout_active=drop,
                              fixed_site_keys=jnp.asarray(table[0]) if drop else None)
    for (g, hw), f, h in zip(got, feats, (1, 2, 3)):
        w = np.asarray(j_quant.quant_detection_cf(qh[f"det{h}"], f))
        assert tuple(hw) == tuple(f.shape[1:3]) and g.shape == w.shape == (
            3 * spec.head_channels_per_prior, 2, hw[0] * hw[1])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    if not drop:
        _assert_raws_near(got, j_mquant.forward_cf_q(qh, jp, js, jnp.asarray(imgs), spec=spec,
                                                     compute_dtype=jnp.float32))


def test_int8_raws_track_the_float_raws(weights, heads, img):
    """The port's int8 raws against its float32 raws of the same fixed
    masks, on random weights: JAX tests/test_quant.py:67's bounds
    (correlation > 0.995, max error over scale < 0.10)."""
    tparams, tstats = tp.to_torch(*weights)
    kw = dict(spec=tp.SPEC, T=T, compute_dtype=torch.float32, fixed_masks=SEED)
    x = torch.from_numpy(img)
    outs_q = p_mquant.mc_forward_cf_q(convert.qheads_from_jax(heads["qh"]), tparams, tstats, x,
                                      **kw)
    outs_f = p_yolov3.mc_forward_cf(tparams, tstats, x, **kw)
    for (q, _), (f, _) in zip(outs_q, outs_f):
        a, b = f.double().flatten().numpy(), q.double().flatten().numpy()
        assert np.corrcoef(a, b)[0, 1] > 0.995
        assert np.abs(a - b).max() / np.abs(a).max() < 0.10


def test_mc_forward_cf_q_refuses_other_variants(heads):
    spec = VariantSpec(Variant.ALEATORIC, 2)
    with pytest.raises(ValueError, match="bayesian"):
        p_mquant.mc_forward_cf_q(convert.qheads_from_jax(heads["qh"]), {}, {},
                                 torch.zeros(1, 64, 96, 3), spec=spec, T=2)


def test_init_tree_has_what_quantize_heads_reads():
    """quantize_heads reads every head / trans block and det conv of an
    initialised tree (the port's and JAX's name sets agree)."""
    params, _ = j_init_yolov3(jax.random.PRNGKey(0), tp.SPEC)
    pparams, _ = p_yolov3.init_yolov3(torch.Generator(), tp.SPEC, device="meta")
    assert set(params) == set(pparams)
    assert set(BLOCKS) | {"det1", "det2", "det3"} <= set(pparams)
