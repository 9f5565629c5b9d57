"""The port's spatial (image-height) sharding (``mesh_shape={'sp': N}`` and
``{'sp': a, 'mc': b}``, ``parallel/spatial.py``) on the CPU, over ``gloo``
ranks.

ONE module-scoped job of four spawned ranks: first the four join a group
as ``{'sp': 2, 'mc': 2}`` (subgroups, the halo exchange, the sp x mc raws,
the runner's predict and run()); then ranks 0-2 join a group as ``{'sp':
3}`` (uneven bands: batched aleatoric at 160x96, bands of 2, 2 and 1 rows of
the stride-32 map; an empty band: epistemic at 64x96, bands of 1, 1 and 0,
rank 2 idle through the convs), and ranks 0 and 1 a last one as ``{'sp':
2}`` (the batched raws of the three variants, the runner's batched and
epistemic run()).  At 64x96 and sp=2 every rank holds 32 image rows, and
one row of the stride-32 map.

References and tolerances.  Raws against the JAX package's single-device
forward under the same dropout keys (its ``_heads`` with
``fixed_site_keys``; its ``mc_forward`` with ``fixed_masks``), rtol 2e-5 /
atol 2e-5, the JAX package's own sp tolerances (tests/test_spatial.py:59-60);
the port's sp runs the plain stem where the JAX package runs its
space-to-depth stem, the same function.  ECP JSON against the port's
single-device runner at the mc path's whole-pipeline float32 tolerances
(tests/test_torch_mc_sharded.py: rtol 1e-4 / atol 1e-5, the corners times
the image size)."""

import functools
import glob
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant
from bayesian_yolov3_tpu.core.blueprint import VariantSpec as JSpec
from bayesian_yolov3_tpu.core.priors import ECP_9_PRIORS as J_PRIORS
from bayesian_yolov3_tpu.models.yolov3 import YoloV3 as JYoloV3

from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.core.blueprint import Variant, VariantSpec
from bayesian_yolov3_torch.data import pipeline, proto, tfrecord
from bayesian_yolov3_torch.infer import InferenceRunner
from bayesian_yolov3_torch.models.yolov3 import _fixed_key_table, forward_cf, mc_forward_cf
from bayesian_yolov3_torch.ops.common import dropout, hash_keep
from bayesian_yolov3_torch.parallel import (
    Band,
    Group,
    initialize_distributed,
    make_groups,
    spatial_forward_raws,
    spatial_mc_raws,
)
from bayesian_yolov3_torch.parallel.spatial import STRIDE, band_plan, check_height

import torch_parity as tp

SPMC = {"sp": 2, "mc": 2}
SP = {"sp": 2}
SP3 = {"sp": 3}
T = 8
SEED = 9  # the fixed key tables of the raw comparisons
STEP = 12
N_FRAMES = 2
IMAGES = tp.image_u8(seed=4, nb=2)
RAW_TOL = dict(rtol=2e-5, atol=2e-5)
EPI = dict(model="bayesian", inference_mode=True, T=T, batch_size=1, compute_dtype="float32",
           full_img_size=tp.IMG, nms_max_boxes=20, nms_pre_top_k=0)
BATCHED = dict(model="aleatoric", inference_mode=False, batch_size=2, compute_dtype="float32",
               full_img_size=tp.IMG, nms_max_boxes=20, nms_pre_top_k=0)
# 40 candidates cannot fill 50 selections: the certificate fails, the exact
# retry runs
FALLBACK = dict(nms_max_boxes=50, nms_pre_top_k=40)
TALL = (160, 96, 3)  # 5 rows of the stride-32 map: 2, 2 and 1 over sp=3
TALL_IMAGES = tp.image_u8(seed=6, nb=2, hw=TALL[:2])


@functools.lru_cache(maxsize=None)
def _weights(model):
    """numpy (params, stats); aleatoric and bayesian share theirs."""
    spec = JSpec(JVariant("standard" if model == "standard" else "bayesian"), 2)
    params_np, stats_np = tp.numpy_weights(seed=3, spec=spec)
    for i in (1, 2, 3):  # raw logits of a few units, not tens
        params_np[f"det{i}"]["w"] *= np.float32(0.2)
    return params_np, stats_np


def _load_state(self):
    return (*tp.to_torch(*_weights(self.config.model)), STEP)


def _config(data, base, **kw):
    return Config(**{**base, **kw}, cpu_thread_cnt=1,
                  data=DataConfig(file_pattern=data["pattern"]))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    os.makedirs(root / "data")
    with tfrecord.TFRecordWriter(str(root / "data" / "d-00000-of-00001.tfrecord")) as wr:
        for i in range(N_FRAMES):
            wr.write(proto.encode_example({
                "image/encoded": [pipeline.encode_png(tp.image_u8(seed=70 + i)[0])],
                "image/filename": [f"frame_{i}.png".encode()],
            }))
    return {"root": str(root), "pattern": str(root / "data" / "d-*-of-*.tfrecord")}


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------


def _run(runner, out_path):
    """runner.run() -> (output dir, batches written, batches retried)."""
    writes = []
    write = runner._write_batch
    runner._write_batch = lambda *a: (writes.append(1), write(*a))
    out_dir = runner.run(out_path=out_path)
    return np.array(out_dir), np.array(len(writes)), np.array(runner.retried)


def _sp_mc_work(rank, data, out):
    """Four ranks as {'sp': 2, 'mc': 2}."""
    res = {}
    groups = make_groups(SPMC)
    sp, mc = groups["sp"], groups["mc"]
    res["layout"] = np.array([sp.rank, sp.size, mc.rank, mc.size])
    # the halo exchange: first row = rank, last row = rank + 0.5
    x = torch.full((1, 3, 4, 2), float(rank))
    x[:, -1] += 0.5
    prev_last, next_first = sp.exchange_edges(x[:, 0], x[:, -1])
    only_prev, none = sp.exchange_edges(None, x[:, -1])
    res["halo"] = np.array([math.nan if t is None else float(t.mean())
                            for t in (prev_last, next_first, only_prev, none)])

    params, stats = tp.to_torch(*_weights("bayesian"))
    img = torch.from_numpy(IMAGES[:1]).float() / 255.0
    outs = spatial_mc_raws(params, stats, img, _fixed_key_table(SEED, T),
                           spec=VariantSpec(Variant.BAYESIAN, 2), group=sp, T=T,
                           compute_dtype=torch.float32, mc=mc)
    for i, (raw, hw) in enumerate(outs):
        res[f"mc_raw{i}"] = raw.numpy()
        res[f"mc_hw{i}"] = np.array(hw)

    runner = InferenceRunner(_config(data, EPI, mesh_shape=SPMC), seed=0, device="cpu")
    res["spmc_dir"], res["spmc_writes"], res["spmc_retried"] = _run(
        runner, os.path.join(out, "spmc"))
    res["epi_batch"] = np.array(InferenceRunner(_config(data, EPI, batch_size=4, mesh_shape=SPMC),
                                                device="cpu").device_batch_size())
    return res


def _sp3_work():
    """Ranks 0-2 as {'sp': 3}: the raws and the runner's predict of the
    uneven bands (batched aleatoric, 160x96) and of the bands with an empty
    one (epistemic T=8, 64x96, one fixed key table)."""
    res = {}
    (sp,) = make_groups(SP3).values()
    params, stats = tp.to_torch(*_weights("aleatoric"))
    outs = spatial_forward_raws(params, stats, torch.from_numpy(TALL_IMAGES).float() / 255.0,
                                None, spec=VariantSpec(Variant.ALEATORIC, 2), group=sp,
                                compute_dtype=torch.float32)
    res.update({f"tall_raw{i}": raw.numpy() for i, (raw, _) in enumerate(outs)})
    runner = InferenceRunner(Config(**dict(BATCHED, full_img_size=TALL), mesh_shape=SP3),
                             device="cpu")
    res["tall_rows"], res["tall_valid"] = runner.predict(params, stats, TALL_IMAGES)

    params, stats = tp.to_torch(*_weights("bayesian"))
    keys = _fixed_key_table(SEED, T)
    outs = spatial_mc_raws(params, stats, torch.from_numpy(IMAGES[:1]).float() / 255.0, keys,
                           spec=VariantSpec(Variant.BAYESIAN, 2), group=sp, T=T,
                           compute_dtype=torch.float32)
    res.update({f"empty_raw{i}": raw.numpy() for i, (raw, _) in enumerate(outs)})
    runner = InferenceRunner(Config(**EPI, mesh_shape=SP3), device="cpu")
    res["empty_rows"], res["empty_valid"] = runner.predict(params, stats, IMAGES[:1], keys)
    return res


def _sp_work(rank, data, out):
    """Ranks 0 and 1 as {'sp': 2}."""
    res = {}
    (sp,) = make_groups(SP).values()
    imgs = torch.from_numpy(IMAGES).float() / 255.0
    for model in ("standard", "aleatoric", "bayesian"):
        params, stats = tp.to_torch(*_weights(model))
        keys = _fixed_key_table(SEED, 1) if model == "bayesian" else None
        outs = spatial_forward_raws(params, stats, imgs, keys,
                                    spec=VariantSpec(Variant(model), 2), group=sp,
                                    compute_dtype=torch.float32)
        for i, (raw, _) in enumerate(outs):
            res[f"{model}_raw{i}"] = raw.numpy()
    batched = InferenceRunner(_config(data, BATCHED, mesh_shape=SP), seed=0, device="cpu")
    res["batched_dir"], res["batched_writes"], res["batched_retried"] = _run(
        batched, os.path.join(out, "sp_batched"))
    res["batched_batch"] = np.array(batched.device_batch_size())
    epi = InferenceRunner(_config(data, EPI, mesh_shape=SP, **FALLBACK), seed=0, device="cpu")
    res["epi_dir"], res["epi_writes"], res["epi_retried"] = _run(epi, os.path.join(out, "sp_epi"))
    return res


def _rank_main(rank, out, data):
    InferenceRunner.load_state = _load_state  # this process's runners: the module's weights
    initialize_distributed("gloo", "file://" + os.path.join(out, "store4"), world_size=4,
                           rank=rank, device="cpu")
    res = _sp_mc_work(rank, data, out)
    dist.destroy_process_group()
    if rank < 3:
        initialize_distributed("gloo", "file://" + os.path.join(out, "store3"), world_size=3,
                               rank=rank, device="cpu")
        res.update(_sp3_work())
        dist.destroy_process_group()
    if rank < 2:
        initialize_distributed("gloo", "file://" + os.path.join(out, "store2"), world_size=2,
                               rank=rank, device="cpu")
        res.update(_sp_work(rank, data, out))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def ranks(data):
    out = os.path.join(data["root"], "ranks")
    os.makedirs(out)
    tp.run_ranks(_rank_main, 4, out, out, data)
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(4)]


# --------------------------------------------------------------------------
# groups and halos
# --------------------------------------------------------------------------


def test_sp_mc_groups_follow_the_jax_device_order(ranks):
    """rank = sp_idx * b + mc_idx (the JAX package's make_mesh reshapes the
    device list to the axis sizes in dict order, sp major)."""
    for rank, res in enumerate(ranks):
        assert res["layout"].tolist() == [rank // 2, 2, rank % 2, 2]


def test_halo_exchange_reaches_the_sp_neighbours(ranks):
    """Within an sp group (ranks m and 2+m): the first band gets no row
    from above and the next band's first row from below; the last band the
    previous band's last row and none from below; the last-row-only
    exchange of the stride-2 convs likewise."""
    for rank, res in enumerate(ranks):
        prev_last, next_first, only_prev, none = res["halo"]
        up = rank - 2  # the sp neighbour above, on the same mc index
        assert math.isnan(none)
        if rank < 2:
            assert math.isnan(prev_last) and math.isnan(only_prev)
            assert next_first == rank + 2
        else:
            assert prev_last == only_prev == up + 0.5
            assert math.isnan(next_first)


# --------------------------------------------------------------------------
# raws against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["standard", "aleatoric", "bayesian"])
def test_sp_raws_match_jax_single_device(ranks, model):
    """sp=2: the gathered channels-first raws of a batch of 2 on both ranks
    against the JAX package's single-device forward; the bayesian variant
    with its dropout active under one (1, 15) key table."""
    keys = _fixed_key_table(SEED, 1)[0] if model == "bayesian" else None
    want = tp.jax_forward_cf(*_weights(model), IMAGES.astype(np.float32) / 255.0,
                             JSpec(JVariant(model), 2), keys)
    for res in ranks[:2]:
        for i, (w, _) in enumerate(want):
            assert res[f"{model}_raw{i}"].shape == w.shape
            np.testing.assert_allclose(res[f"{model}_raw{i}"], w, **RAW_TOL)


def test_sp_bayesian_masks_bite(ranks):
    """The bayesian raws under dropout differ from the dropout-free
    aleatoric raws of the same weights: the masks were applied."""
    assert not np.allclose(ranks[0]["bayesian_raw2"], ranks[0]["aleatoric_raw2"], atol=1e-3)


@functools.lru_cache(maxsize=None)
def _jax_mc_raws():
    """The JAX package's mc_forward of IMAGES[0] under ``fixed_masks=SEED``
    (the table of ``_fixed_key_table(SEED, T)``), channels-first: [(ch, T,
    h*w) numpy, ...]."""
    model = JYoloV3(spec=JSpec(JVariant.BAYESIAN, 2), priors=J_PRIORS, img_size=tp.IMG,
                    compute_dtype="float32")
    params_np, stats_np = _weights("bayesian")
    img = jnp.asarray(IMAGES[:1].astype(np.float32) / 255.0)
    want = jax.jit(lambda p, s, x: model.mc_forward(p, s, x, T=T, rng=None,
                                                    fixed_masks=SEED))(
        tp.to_jax(params_np), tp.to_jax(stats_np), img)
    return [np.asarray(w).transpose(3, 0, 1, 2).reshape(w.shape[3], T, -1) for w in want]


def test_sp_mc_raws_match_jax_mc_forward(ranks):
    """sp=2 x mc=2: rank (s, m) holds the whole maps of samples
    [4m, 4m+4) of the fixed table, against the JAX package's mc_forward
    under ``fixed_masks`` (the same table)."""
    per = T // 2
    for rank, res in enumerate(ranks):
        m = rank % 2
        for i, cf in enumerate(_jax_mc_raws()):
            h, w = res[f"mc_hw{i}"]
            assert cf.shape[-1] == h * w
            np.testing.assert_allclose(res[f"mc_raw{i}"], cf[:, m * per:(m + 1) * per],
                                       **RAW_TOL)


def _assert_rows_close(got, got_valid, want, want_valid):
    """Selected rows of the runner's predict against the single device's, at
    the ECP JSON's float32 tolerances below (``_assert_dets_close``; the
    epistemic covariance determinant, column 12, at rtol 1e-3)."""
    np.testing.assert_array_equal(got_valid, want_valid)
    assert want_valid.sum() > 5
    rtol = np.full(want.shape[-1], 1e-4)
    if want.shape[-1] == 23:
        rtol[12] = 1e-3
    g, w = got[got_valid], want[want_valid]
    over = np.abs(g - w) / (1e-5 + rtol * np.abs(w))
    assert over.max() <= 1.0, (f"{int((over > 1).sum())} of {over.size} values off, worst "
                               f"{over.max()} x the tolerance in column "
                               f"{np.unravel_index(over.argmax(), over.shape)[1]}")


def test_sp3_uneven_bands_match_single_device(ranks):
    """{'sp': 3} at 160x96, bands of 2, 2 and 1 rows of the stride-32 map,
    batched aleatoric, batch 2: on every rank the gathered raws against the
    port's single-device forward (which meets the JAX package's forward at
    the same weights) at RAW_TOL, and the runner's predict rows against the
    single-device runner's."""
    params_np, stats_np = _weights("aleatoric")
    params, stats = tp.to_torch(params_np, stats_np)
    imgs = TALL_IMAGES.astype(np.float32) / 255.0
    single = forward_cf(params, stats, torch.from_numpy(imgs),
                        spec=VariantSpec(Variant.ALEATORIC, 2), compute_dtype=torch.float32)
    jax_raws = tp.jax_forward_cf(params_np, stats_np, imgs, JSpec(JVariant.ALEATORIC, 2))
    rows, valid = InferenceRunner(Config(**dict(BATCHED, full_img_size=TALL)),
                                  device="cpu").predict(params, stats, TALL_IMAGES)
    for i, ((raw, hw), (want, jhw), s) in enumerate(zip(single, jax_raws, (32, 16, 8))):
        assert hw == jhw == (TALL[0] // s, TALL[1] // s)
        np.testing.assert_allclose(raw.numpy(), want, **RAW_TOL)
        for res in ranks[:3]:
            np.testing.assert_allclose(res[f"tall_raw{i}"], raw.numpy(), **RAW_TOL)
    for res in ranks[:3]:
        _assert_rows_close(res["tall_rows"], res["tall_valid"], rows, valid)


def test_sp3_empty_band_matches_single_device(ranks):
    """{'sp': 3} at 64x96, bands of 1, 1 and 0 rows of the stride-32 map (rank
    2 holds no row and idles through the convs), epistemic T=8 under one
    fixed key table: on every rank the gathered raws against the port's
    single-device mc_forward_cf (which meets the JAX package's mc_forward
    under the same table) at RAW_TOL, and the runner's predict rows against
    the single-device runner's."""
    params, stats = tp.to_torch(*_weights("bayesian"))
    keys = _fixed_key_table(SEED, T)
    single = mc_forward_cf(params, stats, torch.from_numpy(IMAGES[:1]).float() / 255.0,
                           spec=VariantSpec(Variant.BAYESIAN, 2), T=T, rng=keys,
                           compute_dtype=torch.float32)
    rows, valid = InferenceRunner(Config(**EPI), device="cpu").predict(params, stats,
                                                                       IMAGES[:1], keys)
    for i, ((raw, _), want) in enumerate(zip(single, _jax_mc_raws())):
        np.testing.assert_allclose(raw.numpy(), want, **RAW_TOL)
        for res in ranks[:3]:
            np.testing.assert_allclose(res[f"empty_raw{i}"], raw.numpy(), **RAW_TOL)
    for res in ranks[:3]:
        _assert_rows_close(res["empty_rows"], res["empty_valid"], rows, valid)


# --------------------------------------------------------------------------
# the runner
# --------------------------------------------------------------------------


def _read_dets(out_dir):
    out = {}
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            out[os.path.basename(f)] = json.load(fh)["children"]
    return out


def _assert_dets_close(got, want):
    """Detections of one frame, in NMS order (tests/test_torch_mc_sharded.py)."""
    assert len(got) == len(want) > 5
    px = max(tp.IMG[:2])
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["identity"] == w["identity"]
        assert (g["layer_id"], g["prior_id"]) == (w["layer_id"], w["prior_id"])
        for k, v in w.items():
            if k not in ("identity", "layer_id", "prior_id"):
                atol = 1e-5 * px if k in ("x0", "y0", "x1", "y1") else 1e-5
                rtol = 1e-3 if k == "total_var_epi" else 1e-4
                np.testing.assert_allclose(g[k], v, rtol=rtol, atol=atol, err_msg=k)


def _assert_run(ranks, name, want_dir, n_ranks, writes=1):
    """Every rank returned the same directory; rank 0 alone wrote, and its
    JSON is the single-device runner's, frame by frame."""
    dirs = {str(r[f"{name}_dir"]) for r in ranks[:n_ranks]}
    assert len(dirs) == 1 and dirs.pop().endswith(f"_{STEP}")
    assert [int(r[f"{name}_writes"]) for r in ranks[:n_ranks]] == [writes] + [0] * (n_ranks - 1)
    got, want = _read_dets(str(ranks[0][f"{name}_dir"])), _read_dets(want_dir)
    assert sorted(got) == sorted(want) == [f"frame_{i}.json" for i in range(N_FRAMES)]
    for frame in got:
        _assert_dets_close(got[frame], want[frame])


@pytest.fixture
def single(data, tmp_path, monkeypatch):
    """run() of the port's single-device runner on the module's frames."""
    monkeypatch.setattr(InferenceRunner, "load_state", _load_state)

    def run(base, **kw):
        runner = InferenceRunner(_config(data, base, out_path=str(tmp_path / "one"), **kw),
                                 seed=0, device="cpu")
        return runner.run(), runner.retried

    return run


def test_runner_sp_batched_json_matches_single_device(ranks, single):
    """{'sp': 2}, batched aleatoric, batch 2: the box decode of the gathered
    raws, certified NMS; one batch."""
    want_dir, _ = single(BATCHED)
    _assert_run(ranks, "batched", want_dir, 2)
    assert int(ranks[0]["batched_batch"]) == 2 and int(ranks[0]["batched_retried"]) == 0


def test_runner_sp_epistemic_json_matches_single_device(ranks, single):
    """{'sp': 2}, epistemic T=8 with drawn keys (seed 0 on every rank), batch
    1: the epistemic decode of the gathered raws; a pre-top-k that fails the
    certificate, so every frame takes the exact retry on both sides."""
    want_dir, want_retried = single(EPI, **FALLBACK)
    _assert_run(ranks, "epi", want_dir, 2, writes=N_FRAMES)
    assert [int(r["epi_retried"]) for r in ranks[:2]] == [N_FRAMES] * 2 == [want_retried] * 2


def test_runner_sp_mc_json_matches_single_device(ranks, single):
    """{'sp': 2, 'mc': 2} on four ranks, epistemic T=8, drawn keys: the
    moments of each rank's 4 samples over the gathered maps, one all-reduce
    over the mc subgroup, one finalize; batch 1 whatever batch_size says."""
    want_dir, _ = single(EPI)
    _assert_run(ranks, "spmc", want_dir, 4, writes=N_FRAMES)
    assert all(int(r["epi_batch"]) == 1 for r in ranks)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(BATCHED, mesh_shape=SPMC), AssertionError, "mc axis requires the epistemic runner"),
    (dict(EPI, mesh_shape={"sp": 2, "mc": 3}), AssertionError, "T must divide evenly"),
    (dict(EPI, mesh_shape=SP, fixed_mc_masks=7), ValueError, "fixed_mc_masks"),
    (dict(EPI, mesh_shape=SPMC, fixed_mc_masks=7), ValueError, "fixed_mc_masks"),
    (dict(BATCHED, mesh_shape=SP, quantize="int8"), ValueError, "does not compose with the sp"),
    (dict(BATCHED, mesh_shape=SP, packed_host_input=True), ValueError, "packed_host_input"),
    (dict(BATCHED, full_img_size=(80, 96, 3), mesh_shape=SP), AssertionError,
     "divisible by 32"),
    (dict(BATCHED, mesh_shape={"sp": 4}), RuntimeError, "world size 4"),
    (dict(BATCHED, mesh_shape=SP), RuntimeError, "world size 2"),
    (dict(EPI, mesh_shape=SPMC), RuntimeError, "world size 4"),
])
def test_runner_refuses_sp_rules(kw, exc, match):
    """The JAX runner's sp refusals (infer/runner.py:110-121, :147-175,
    :258-274) with its exception types — the two of its asserts included —
    and a height that is not a multiple of 32 (the model's assert), then the
    port's own: the missing group.  64 rows over sp=4 (bands of 1, 1, 0 and
    0 rows of the stride-32 map) pass the band rule and stop at the group."""
    with pytest.raises(exc, match=match):
        InferenceRunner(Config(**kw), device="cpu")


# --------------------------------------------------------------------------
# the band's pieces, no ranks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,r0,h", [((2, 8, 5, 3), 0, 4), ((2, 8, 5, 3), 4, 4),
                                        ((1, 6, 7, 2), 5, 1), ((3, 4, 3, 16), 1, 2)])
def test_dropout_band_draws_its_rows_of_the_whole_mask(shape, r0, h, dtype):
    """Two samples of an (n, H, w, c) map: a band [r0, r0+h) dropped out
    with its origin equals the same rows of the whole map dropped out, bit
    for bit."""
    gen = torch.Generator().manual_seed(r0 + 10 * h)
    x = torch.randn((2 * shape[0], *shape[1:]), generator=gen).to(dtype)
    keys = [123456789, 4000000000]
    whole = dropout(x.clone(), 0.1, keys)
    band = dropout(x[:, r0:r0 + h].clone(), 0.1, keys, origin=(r0, shape[1]))
    assert torch.equal(band, whole[:, r0:r0 + h])
    assert not torch.equal(band, x[:, r0:r0 + h])  # some elements dropped or scaled


def test_dropout_without_origin_keeps_the_flat_index_mask():
    """No origin: the mask index is the flat row-major index of the
    per-sample tensor, as before bands existed."""
    x = torch.randn((2, 4, 6, 5), generator=torch.Generator().manual_seed(1))
    got = dropout(x.clone(), 0.1, [7, 8])
    idx = torch.arange(4 * 6 * 5, dtype=torch.int64).reshape(1, 4, 6, 5)
    keep = torch.tensor(0.9, dtype=x.dtype).item()
    want = torch.cat([torch.where(hash_keep(idx, k, 58982), x[i:i + 1] / keep, 0.0)
                      for i, k in enumerate((7, 8))])
    assert torch.equal(got, want)


def test_dropout_band_outside_its_map_raises():
    with pytest.raises(ValueError, match="outside"):
        dropout(torch.ones((1, 2, 3, 1)), 0.1, [1], origin=(3, 4))


def test_band_rules():
    """H a positive multiple of 32, any sp; a halo rule for 3x3 convs at
    stride 1 and 2 only (1x1 convs need none)."""
    for h, n in ((1024, 2), (1024, 3), (1024, 32), (64, 3), (32, 5)):
        check_height(h, n)
    for h, n in ((1000, 2), (0, 1), (48, 3)):
        with pytest.raises(ValueError, match="multiple of 32"):
            check_height(h, n)
    band = Band(Group(size=2, rank=1))
    with pytest.raises(ValueError, match="no halo rule"):
        band.conv(torch.zeros((1, 2, 4, 3)), torch.zeros((3, 3, 5, 5)))
    assert band.rows(torch.zeros((1, 64, 4, 3))).shape[1] == 32
    assert band.origin(16) == (16, 32)


# (H, N): even and uneven bands, empty ones, more ranks than rows
BAND_GRID = [(32, 1), (64, 2), (64, 3), (64, 4), (96, 2), (160, 3), (128, 8), (1024, 3),
             (1024, 5), (1024, 7), (1024, 32), (1024, 33), (480, 4)]


@pytest.mark.parametrize("height,n", BAND_GRID)
def test_band_plan_follows_gspmd(height, n):
    """R = H/32 rows of the stride-32 map, per = ceil(R/N): rank r holds
    [r*per, min((r+1)*per, R)); the bands cover the map in rank order, the
    non-empty ones first, each full but the last non-empty one."""
    plan = band_plan(height, n)
    coarse = height // STRIDE
    per = -(-coarse // n)
    assert (plan.coarse, plan.per) == (coarse, per)
    covered = [row for a, c in zip(plan.start, plan.size) for row in range(a, a + c)]
    assert covered == list(range(coarse))
    assert all(0 <= c <= per for c in plan.size)
    nonempty = [c > 0 for c in plan.size]
    assert nonempty == sorted(nonempty, reverse=True)
    assert list(plan.size[:coarse // per]) == [per] * (coarse // per)
    assert sum(nonempty) == -(-coarse // per)


class _FakeGroup:
    """A rank of an sp group whose all-gathers return every rank's band from
    ``bands`` (one list of the ranks' bands per call, in call order): each
    band padded to the length of this rank's padded one, the others' with
    NaN, which the trim must drop.  Its halo exchange records the edges it
    is offered."""

    def __init__(self, size, rank, bands=()):
        self.size, self.rank, self.edges = size, rank, []
        self.bands = list(bands)

    def all_gather(self, t, dim=0):
        per_rank = self.bands.pop(0)
        own = per_rank[self.rank]
        assert torch.equal(t[..., :own.shape[-1]], own) and not t[..., own.shape[-1]:].any()
        parts = []
        for p in per_rank:
            x = torch.full((*p.shape[:-1], t.shape[-1]), float("nan"))
            x[..., :p.shape[-1]] = p
            parts.append(x)
        return torch.cat(parts, dim=dim)

    def exchange_edges(self, first, last):
        self.edges.append((first, last))
        return None, None


@pytest.mark.parametrize("height,n", BAND_GRID)
def test_band_rows_and_padded_gather(height, n):
    """Each rank's ``rows`` is its plan's band of the image; ``gather`` of
    the ranks' bands of three maps (strides 32, 16, 8) gives the whole maps,
    the padding of the uneven bands trimmed away."""
    width = 64
    imgs = torch.arange(height, dtype=torch.float32)[None, :, None, None].expand(1, height,
                                                                                  width, 1)
    plan = band_plan(height, n)
    gen = torch.Generator().manual_seed(height + n)
    whole = {s: torch.randn((3, 2, (height // s) * (width // s)), generator=gen)
             for s in (32, 16, 8)}
    bands = []
    for s, m in whole.items():
        f, w = STRIDE // s, width // s
        bands.append([m[..., a * f * w:(a + c) * f * w] for a, c in zip(plan.start, plan.size)])
    for r in range(n):
        band = Band(_FakeGroup(n, r, bands))
        rows = band.rows(imgs)
        a, c = plan.start[r] * STRIDE, plan.size[r] * STRIDE
        assert torch.equal(rows[0, :, 0, 0], torch.arange(a, a + c, dtype=torch.float32))
        got = band.gather([(per_rank[r], (plan.size[r] * STRIDE // s, width // s))
                           for per_rank, s in zip(bands, (32, 16, 8))])
        for (raw, hw), s in zip(got, (32, 16, 8)):
            assert hw == (height // s, width // s)
            assert torch.equal(raw, whole[s])


def test_empty_band_takes_part_in_the_halo_exchange():
    """A rank with no rows offers zero edges of the band's shape to every
    3x3 conv's exchange (both edges at stride 1, the last alone at stride
    2), returns an empty map of the conv's output width and channels, and
    draws its dropout mask at origin (0, 0)."""
    group = _FakeGroup(3, 2)
    band = Band(group)
    assert band.rows(torch.zeros((2, 64, 96, 3))).shape == (2, 0, 96, 3)
    x = torch.zeros((2, 0, 12, 5))
    assert band.conv(x, torch.zeros((7, 5, 3, 3))).shape == (2, 0, 12, 7)
    assert band.conv(x, torch.zeros((7, 5, 3, 3)), stride=2).shape == (2, 0, 6, 7)
    assert band.conv(x, torch.zeros((7, 5, 1, 1))).shape == (2, 0, 12, 7)
    (first, last), (none, last2) = group.edges
    assert first.shape == last.shape == last2.shape == (2, 12, 5) and none is None
    assert not first.any() and not last.any()
    assert band.origin(0) == (0, 0)
    assert dropout(x.clone(), 0.1, [1, 2], origin=band.origin(0)).shape == x.shape
