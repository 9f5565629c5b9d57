"""The one-launch decodes over the three scales of a model's heads, on the
CPU: ``decode.scale_plan`` (the offsets and blocks that
``csrc/scale_table.cuh`` walks), the all-scales box decode and epistemic
finalize against the JAX package, the moments wrapper's ``out=`` view, and
the mc pipeline's one packed all-reduce per frame on two spawned ``gloo``
ranks.  At the suite's small sizes: a 64x96 frame (scales (2, 3), (4, 6),
(8, 12)) and ragged sets of scales.

Tolerances.  The all-scales box decode's plain version against the JAX
package's Pallas kernel in interpret mode: rtol 1e-5 / atol 1e-6 as
tests/test_torch_decode.py (elementwise float32 math from two libraries, a
few ulp apart); the layer and prior id columns exactly.  The all-scales
finalize's plain version against JAX ``epistemic_finalize`` per scale,
concatenated, on the same sums: rtol 1e-5 / atol 1e-6 except column 12
(the 4x4 covariance determinant, a difference of products of near-equal
numbers) at rtol 1e-4, as tests/test_torch_mc_sharded.py; the samples
number at least 8, so that a covariance of four coordinates is not
singular and its determinant not rounding noise.  Rows the port
computes two ways from the same inputs with the same arithmetic (all
scales at once against per scale, one packed all-reduce against three)
exactly."""

import glob
import os
import time
import traceback
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax.numpy as jnp

from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant
from bayesian_yolov3_tpu.core.blueprint import VariantSpec as JSpec
from bayesian_yolov3_tpu.ops import pallas_decode
from bayesian_yolov3_tpu.ops.pallas_epistemic import (
    epistemic_finalize as j_finalize,
    epistemic_moments_cf as j_moments,
)

from bayesian_yolov3_torch.core.blueprint import Variant, VariantSpec
from bayesian_yolov3_torch.ops import cuda_decode, cuda_epistemic, cuda_moments, decode
from bayesian_yolov3_torch.parallel import (
    epistemic as par_epistemic,
    initialize_distributed,
    make_groups,
    make_mc_sharded_fused_pipeline,
)
from bayesian_yolov3_torch.parallel.mesh import Group

import torch_parity  # noqa: F401  (two torch threads per pytest worker)

DEC_TOL = dict(rtol=1e-5, atol=1e-6)
STRIDES = (32, 16, 8)
HWS = ((2, 3), (4, 6), (8, 12))  # the scales of a 64x96 frame
RAGGED = (((1, 1), (7, 9), (13, 29)), ((3, 5), (8, 16), (16, 17)))
WORLD = 2
JOIN_TIMEOUT_S = 120


def _priors(seed, n_priors=3):
    r = np.random.default_rng(seed)
    return {s: r.uniform(0.02, 0.5, (n_priors, 2)).astype(np.float32) for s in STRIDES}


def _assert_rows_match(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., -2:], want[..., -2:])  # layer, prior ids
    np.testing.assert_allclose(got[..., :-2], want[..., :-2], **DEC_TOL)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------


def _kernel_rows(plan, nb):
    """The rows the one-launch kernels write, walked as their grid walks
    them (csrc/scale_table.cuh): per row, how often it is written and the
    (scale, prior, cell) written there."""
    B, blk = plan.n_priors, decode.SCALE_BLOCK
    hits = np.zeros((nb, plan.rows), np.int64)
    ids = np.full((nb, plan.rows, 3), -1, np.int64)
    for bx in range(plan.first_block[-1]):
        s = max(k for k in range(len(plan.hws)) if bx >= plan.first_block[k])
        hw = plan.hws[s][0] * plan.hws[s][1]
        cells = np.arange((bx - plan.first_block[s]) * blk, hw)[:blk]
        assert cells.size > 0  # no block of a scale lies past its cells
        for y in range(nb * B):
            n, b = divmod(y, B)
            rows = plan.row_off[s] + b * hw + cells
            hits[n, rows] += 1
            ids[n, rows] = np.stack([np.full_like(cells, s), np.full_like(cells, b), cells], 1)
    return hits, ids


@pytest.mark.parametrize("hws", [HWS, *RAGGED, ((128, 240),), ((8, 16), (8, 32))],
                         ids=["64x96", "ragged1", "ragged2", "one_scale", "whole_blocks"])
@pytest.mark.parametrize("n_priors,nb", [(3, 1), (3, 3), (1, 2)])
def test_scale_plan_covers_every_row_once_in_concat_order(hws, n_priors, nb):
    plan = decode.scale_plan(hws, n_priors)
    counts = [h * w for h, w in hws]
    assert plan.rows == n_priors * sum(counts)
    assert plan.row_off == tuple(n_priors * sum(counts[:k]) for k in range(len(hws)))
    assert np.diff(plan.first_block).tolist() == [-(-c // decode.SCALE_BLOCK) for c in counts]
    assert plan.first_block[0] == 0
    hits, ids = _kernel_rows(plan, nb)
    assert (hits == 1).all()
    # the order of concat_all_scales_batched: per scale an (nb, h, w, B, 3)
    # grid of (scale, prior, cell) ids
    grids = []
    for s, (h, w) in enumerate(hws):
        cell = torch.arange(h * w).reshape(1, h, w, 1).expand(nb, h, w, n_priors)
        prior = torch.arange(n_priors).reshape(1, 1, 1, n_priors).expand(nb, h, w, n_priors)
        grids.append(torch.stack([torch.full_like(cell, s), prior, cell], dim=-1))
    np.testing.assert_array_equal(ids, decode.concat_all_scales_batched(grids).numpy())


@pytest.mark.parametrize("n_imgs", [1, 3])
def test_packed_views_tile_the_buffer(n_imgs):
    plan, M = decode.scale_plan(HWS, 3), 23
    packed = torch.arange(plan.rows * M * n_imgs, dtype=torch.float32)
    views = decode.packed_views(packed, plan, M, n_imgs)
    assert [tuple(v.shape) for v in views] == [(3, M, n_imgs * h * w) for h, w in HWS]
    assert all(v.is_contiguous() for v in views)
    np.testing.assert_array_equal(torch.cat([v.reshape(-1) for v in views]).numpy(),
                                  packed.numpy())
    assert views[1].data_ptr() == packed.data_ptr() + plan.row_off[1] * M * n_imgs * 4


# --------------------------------------------------------------------------
# the box decode over all scales
# --------------------------------------------------------------------------


def _box_raws(seed, C, aleatoric, nb, hws):
    r = np.random.default_rng(seed)
    chpp = 2 * (5 + C) if aleatoric else 5 + C
    return [((r.standard_normal((3 * chpp, nb, h * w)) * 2.0).astype(np.float32), (h, w))
            for h, w in hws]


@pytest.mark.parametrize("nb,C", [(1, 1), (3, 2)])
@pytest.mark.parametrize("aleatoric", [False, True], ids=["standard", "aleatoric"])
def test_box_decode_all_scales_plain_matches_pallas(aleatoric, nb, C):
    outs = _box_raws(50 + nb + C, C, aleatoric, nb, HWS)
    pri = _priors(nb)
    variant = "ALEATORIC" if aleatoric else "STANDARD"
    want = np.asarray(pallas_decode.fused_box_decode_all_scales(
        [(jnp.asarray(r), hw) for r, hw in outs], pri, spec=JSpec(JVariant[variant], C),
        interpret=True))
    spec = VariantSpec(Variant[variant], C)
    t_outs = [(torch.from_numpy(r), hw) for r, hw in outs]
    t_pri = {s: torch.from_numpy(p) for s, p in pri.items()}
    got = cuda_decode.box_decode_all_scales_plain(t_outs, t_pri, spec=spec)
    assert tuple(got.shape) == (nb, 3 * (6 + 24 + 96), spec.decoded_width())
    _assert_rows_match(got.numpy(), want)
    # the per-scale wrapper's rows, concatenated, are the same rows
    per = torch.cat([cuda_decode.fused_box_decode_cf(
        r, t_pri[s], h=h, w=w, cls_cnt=C, layer_id=i, aleatoric=aleatoric)
        for i, ((r, (h, w)), s) in enumerate(zip(t_outs, STRIDES))], dim=1)
    assert torch.equal(got, per)
    before = cuda_decode.launch_count
    assert torch.equal(cuda_decode.fused_box_decode_all_scales(t_outs, t_pri, spec=spec), got)
    assert cuda_decode.launch_count == before  # CPU tensors launch no kernel


@pytest.mark.parametrize("hws", RAGGED, ids=["ragged1", "ragged2"])
def test_box_decode_all_scales_ragged(hws):
    """Scales that end in partial blocks: each scale's rows at its offset."""
    spec = VariantSpec(Variant.ALEATORIC, 2)
    outs = [(torch.from_numpy(r), hw) for r, hw in _box_raws(9, 2, True, 2, hws)]
    pri = {s: torch.from_numpy(p) for s, p in _priors(4).items()}
    got = cuda_decode.fused_box_decode_all_scales(outs, pri, spec=spec)
    plan = decode.scale_plan(hws, 3)
    for i, ((r, (h, w)), s) in enumerate(zip(outs, STRIDES)):
        one = cuda_decode.box_decode_plain(r, pri[s], h=h, w=w, cls_cnt=2, layer_id=i,
                                           aleatoric=True)
        assert torch.equal(got[:, plan.row_off[i]:plan.row_off[i] + 3 * h * w], one)


@pytest.mark.parametrize("case", ["four_scales", "images_differ", "priors_differ"])
def test_box_decode_all_scales_refuses(case):
    spec = VariantSpec(Variant.STANDARD, 2)
    outs = [(torch.from_numpy(r), hw) for r, hw in _box_raws(3, 2, False, 2, HWS)]
    pri = {s: torch.from_numpy(p) for s, p in _priors(3).items()}
    if case == "four_scales":
        outs, match = outs + outs[:1], "scales"
    elif case == "images_differ":
        outs[1] = (outs[1][0][:, :1].contiguous(), outs[1][1])
        match = "images"
    else:
        pri[16] = pri[16][:2]
        outs[1] = (outs[1][0][:2 * 7], outs[1][1])
        match = "priors"
    with pytest.raises(ValueError, match=match):
        cuda_decode.fused_box_decode_all_scales(outs, pri, spec=spec)


# --------------------------------------------------------------------------
# the finalize over all scales
# --------------------------------------------------------------------------


def _epi_raws(seed, C, T, n_imgs, hws):
    r = np.random.default_rng(seed)
    return [r.standard_normal((3 * 2 * (5 + C), T, n_imgs * h * w)).astype(np.float32)
            for h, w in hws]


def _packed(sums, hws, C, n_imgs):
    """Per-scale (3, 21+C, n_imgs*h*w) sums -> the packed buffer."""
    plan = decode.scale_plan(hws, 3)
    packed = torch.empty(plan.rows * (21 + C) * n_imgs)
    for view, m in zip(decode.packed_views(packed, plan, 21 + C, n_imgs), sums):
        view.copy_(torch.as_tensor(np.asarray(m)))
    return packed


@pytest.mark.parametrize("n_imgs,C,T", [(1, 2, 12), (3, 1, 9)])
def test_finalize_all_scales_plain_matches_jax(n_imgs, C, T):
    raws = _epi_raws(20 + n_imgs, C, T, n_imgs, HWS)
    pri = _priors(n_imgs + 1)
    sums = [np.array(j_moments(jnp.asarray(r), cls_cnt=C, interpret=True)) for r in raws]
    want = np.concatenate([np.asarray(j_finalize(
        jnp.asarray(m), jnp.asarray(pri[s]), T=T, h=h, w=w, cls_cnt=C, layer_id=i,
        n_imgs=n_imgs, interpret=True)) for i, (m, (h, w), s) in enumerate(zip(sums, HWS,
                                                                               STRIDES))], axis=1)
    packed = _packed(sums, HWS, C, n_imgs)
    t_pri = {s: torch.from_numpy(p) for s, p in pri.items()}
    kw = dict(T=T, hws=HWS, cls_cnt=C, n_imgs=n_imgs)
    got = cuda_moments.epistemic_finalize_all_scales_plain(packed, t_pri, **kw)
    assert tuple(got.shape) == want.shape == (n_imgs, 3 * (6 + 24 + 96), 21 + C)
    np.testing.assert_array_equal(got[..., -2:].numpy(), want[..., -2:])
    cols = [c for c in range(21 + C - 2) if c != 12]
    np.testing.assert_allclose(got[..., cols].numpy(), want[..., cols], **DEC_TOL)
    np.testing.assert_allclose(got[..., 12].numpy(), want[..., 12], rtol=1e-4, atol=1e-6)
    # the port's per-scale finalize, concatenated: the same rows
    per = torch.cat([cuda_moments.epistemic_finalize(
        torch.from_numpy(m), t_pri[s], T=T, h=h, w=w, cls_cnt=C, layer_id=i, n_imgs=n_imgs)
        for i, (m, (h, w), s) in enumerate(zip(sums, HWS, STRIDES))], dim=1)
    assert torch.equal(got, per)
    before = dict(cuda_moments.launch_counts)
    assert torch.equal(cuda_moments.epistemic_finalize_all_scales(packed, t_pri, **kw), got)
    assert cuda_moments.launch_counts == before  # CPU tensors launch no kernel


@pytest.mark.parametrize("hws", RAGGED, ids=["ragged1", "ragged2"])
def test_finalize_all_scales_equals_the_one_shot_decode(hws):
    """The moments of every scale written into the packed buffer through
    ``out=`` views and finalized at once: the one-shot decode's rows of
    each scale, concatenated, within the split tolerance (the plain
    versions sum the samples in other orders)."""
    C, T, n_imgs = 2, 9, 2
    raws = [torch.from_numpy(r) for r in _epi_raws(31, C, T, n_imgs, hws)]
    pri = {s: torch.from_numpy(p) for s, p in _priors(5).items()}
    plan = decode.scale_plan(hws, 3)
    packed = torch.empty(plan.rows * (21 + C) * n_imgs)
    for r, view in zip(raws, decode.packed_views(packed, plan, 21 + C, n_imgs)):
        cuda_moments.epistemic_moments_cf(r, cls_cnt=C, out=view)
    got = cuda_moments.epistemic_finalize_all_scales(packed, pri, T=T, hws=hws, cls_cnt=C,
                                                     n_imgs=n_imgs).numpy()
    want = torch.cat([cuda_epistemic.fused_epistemic_decode_cf_batched(
        r, pri[s], n_imgs=n_imgs, h=h, w=w, cls_cnt=C, layer_id=i)
        for i, (r, (h, w), s) in enumerate(zip(raws, hws, STRIDES))], dim=1).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 21:], want[..., 21:])
    np.testing.assert_allclose(got[..., :12], want[..., :12], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[..., 12], want[..., 12], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got[..., 13:21], want[..., 13:21], rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("case", ["size", "dtype", "four_scales", "not_contiguous"])
def test_finalize_all_scales_refuses(case):
    C, plan = 2, decode.scale_plan(HWS, 3)
    packed = torch.zeros(plan.rows * (21 + C))
    pri = {s: torch.from_numpy(p) for s, p in _priors(1).items()}
    kw = dict(T=4, hws=HWS, cls_cnt=C)
    exc, match = ValueError, None
    if case == "size":
        packed, match = packed[:-1], "packed moments of"
    elif case == "dtype":
        packed, exc, match = packed.double(), TypeError, "float32"
    elif case == "four_scales":
        kw["hws"], match = HWS + HWS[:1], "scales"
    else:
        packed, match = torch.zeros(2 * packed.numel())[::2], "contiguous"
    with pytest.raises(exc, match=match):
        cuda_moments.epistemic_finalize_all_scales(packed, pri, **kw)


# --------------------------------------------------------------------------
# the moments wrapper's out= view
# --------------------------------------------------------------------------


def test_moments_out_fills_the_view():
    C = 2
    raws = [torch.from_numpy(r) for r in _epi_raws(8, C, 3, 1, HWS)]
    plan = decode.scale_plan(HWS, 3)
    packed = torch.full((plan.rows * (21 + C),), float("nan"))
    for r, view in zip(raws, decode.packed_views(packed, plan, 21 + C)):
        got = cuda_moments.epistemic_moments_cf(r, cls_cnt=C, out=view)
        assert got.data_ptr() == view.data_ptr()
        assert torch.equal(view, cuda_moments.epistemic_moments_cf(r, cls_cnt=C))
    assert not packed.isnan().any()  # every element written


@pytest.mark.parametrize("case", ["shape", "dtype", "not_contiguous", "device"])
def test_moments_out_refuses(case):
    C, raw = 2, torch.zeros((3 * 14, 2, 12))
    out, exc, match = torch.empty((3, 23, 12)), ValueError, None
    if case == "shape":
        out, match = torch.empty((3, 22, 12)), "shape"
    elif case == "dtype":
        out, exc, match = out.double(), TypeError, "float32"
    elif case == "not_contiguous":
        out, match = torch.empty((3, 12, 23)).transpose(1, 2), "contiguous"
    else:
        out, match = out.to("meta"), "devices"
    with pytest.raises(exc, match=match):
        cuda_moments.epistemic_moments_cf(raw, cls_cnt=C, out=out)


# --------------------------------------------------------------------------
# the mc pipeline on two gloo ranks: one all-reduce per frame
# --------------------------------------------------------------------------

MC_T, MC_C, MC_FRAMES = 8, 2, 2


def _frame_raws(frame):
    """Every sample of one frame's three raw heads, (ch, T, h*w) each."""
    return [torch.from_numpy(r) for r in _epi_raws(70 + frame, MC_C, MC_T, 1, HWS)]


def _per_scale_route(group, outs, priors):
    """The mc decode as it was before the packed buffer: per scale the
    moments, an all-reduce and a finalize, then the cat."""
    rows = []
    for i, ((raw, (h, w)), s) in enumerate(zip(outs, STRIDES)):
        sums = group.all_reduce(cuda_moments.epistemic_moments_cf(raw, cls_cnt=MC_C))
        rows.append(cuda_moments.epistemic_finalize(sums, priors[s], T=MC_T, h=h, w=w,
                                                    cls_cnt=MC_C, layer_id=i)[0])
    return torch.cat(rows, dim=0)


def _mc_rank(rank, store, out):
    torch.set_num_threads(1)
    try:
        initialize_distributed("gloo", f"file://{store}", world_size=WORLD, rank=rank,
                               device="cpu")
        group = make_groups({"mc": WORLD})["mc"]
        per = MC_T // WORLD

        def local_raws(model, group, T, fixed_masks, params, stats, img, rng, qheads=None):
            return [(r[:, rank * per:(rank + 1) * per].contiguous(), hw)
                    for r, hw in zip(_frame_raws(int(img)), HWS)]

        par_epistemic._local_raws = local_raws  # this rank's samples, no model
        spec = VariantSpec(Variant.BAYESIAN, MC_C)
        priors = {s: torch.from_numpy(p) for s, p in _priors(6).items()}
        pipe = make_mc_sharded_fused_pipeline(
            types.SimpleNamespace(spec=spec), group, MC_T, priors_by_stride=priors,
            obj_idx=spec.obj_idx(epistemic=True), nms_max_boxes=10)
        calls, orig = [], Group.all_reduce
        Group.all_reduce = lambda self, t: (calls.append(t.numel()), orig(self, t))[1]
        res = {}
        for f in range(MC_FRAMES):
            res[f"decode{f}"] = pipe.decode(None, None, f).numpy()
            res[f"valid{f}"] = pipe(None, None, f)[1].numpy()
        res["calls"] = np.array(calls)
        Group.all_reduce = orig
        for f in range(MC_FRAMES):
            res[f"today{f}"] = _per_scale_route(
                group, local_raws(None, None, None, None, None, None, f, None), priors).numpy()
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def mc_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("all_scales_mc"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mc_rank, args=(r, os.path.join(out, "store"), out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.time() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = "\n".join(open(f).read() for f in sorted(glob.glob(os.path.join(out, "*.err"))))
    assert not hung, f"{len(hung)} rank(s) still running after {JOIN_TIMEOUT_S} s\n{errs}"
    assert [p.exitcode for p in procs] == [0] * WORLD, errs
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(WORLD)]


def test_mc_pipeline_makes_one_all_reduce_per_frame(mc_ranks):
    plan = decode.scale_plan(HWS, 3)
    for r in mc_ranks:  # decode and the whole pipeline, each once per frame
        assert r["calls"].tolist() == [plan.rows * (21 + MC_C)] * (2 * MC_FRAMES)


@pytest.mark.parametrize("frame", range(MC_FRAMES))
def test_mc_pipeline_rows_equal_the_per_scale_route(mc_ranks, frame):
    """The packed route's rows equal, bit for bit, those of three moments,
    three all-reduces and three finalizes; the same on both ranks; within
    the split tolerance of the one-shot decode of all T samples."""
    got = mc_ranks[0][f"decode{frame}"]
    for r in mc_ranks:
        np.testing.assert_array_equal(r[f"decode{frame}"], got)
        np.testing.assert_array_equal(r[f"today{frame}"], got)
        np.testing.assert_array_equal(r[f"valid{frame}"], mc_ranks[0][f"valid{frame}"])
    priors = {s: torch.from_numpy(p) for s, p in _priors(6).items()}
    want = torch.cat([cuda_epistemic.fused_epistemic_decode_cf_batched(
        r, priors[s], n_imgs=1, h=h, w=w, cls_cnt=MC_C, layer_id=i)[0]
        for i, (r, (h, w), s) in enumerate(zip(_frame_raws(frame), HWS, STRIDES))]).numpy()
    np.testing.assert_array_equal(got[..., 21:], want[..., 21:])
    np.testing.assert_allclose(got[..., :12], want[..., :12], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[..., 12], want[..., 12], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got[..., 13:21], want[..., 13:21], rtol=1e-4, atol=2e-4)
    assert mc_ranks[0][f"valid{frame}"].sum() > 0
