"""The port's data-parallel batched inference (``mesh_shape={'dp': N}``,
``parallel/batch.py``) on the CPU, over two ``gloo`` ranks.

The ranks are spawned processes of ONE module-scoped job: they join a group
through a file store under the test's temp directory, run every rank-side
case (predict in float32 for the three variants, int8, run() to ECP JSON),
save what they got, then run the aleatoric CLI as torchrun starts it,
joining a second group from the environment.  The tests compare.

References and tolerances.  Each rank runs the single-device batched
pipeline on its 2 of the batch's 4 images, so the reference is that
program on those 2 images: the JAX package's (its unfused forward, its
box-decode kernel in interpret mode, exact NMS) for standard and
aleatoric, held at the JAX package's own dp tolerances, rtol 1e-5 /
atol 1e-6 with ``valid`` equal (tests/test_dp_batched.py:87-88).  The
bayesian variant with dropout: rank r's rows against the port's
single-device runner on its images under row r of the key table at the
same tolerances, and against the JAX package's heads under
``fixed_site_keys=row r`` at the port's float32 bound against the JAX
runner, rtol 1e-3 / atol 1e-4 (tests/test_torch_batched.py: the
aleatoric variance columns take exp of raws that differ in the last bits).
int8 against the port's single-device int8 runner, calibrated alike."""

import functools
import glob
import json
import logging
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant
from bayesian_yolov3_tpu.core.blueprint import VariantSpec as JSpec
from bayesian_yolov3_tpu.core.priors import ECP_9_PRIORS as J_PRIORS
from bayesian_yolov3_tpu.core.priors import priors_as_array as j_priors_as_array
from bayesian_yolov3_tpu.ops import nms as jnms
from bayesian_yolov3_tpu.ops.pallas_decode import fused_box_decode_all_scales as j_decode

from bayesian_yolov3_torch.cli import inference_aleatoric as cli_aleatoric
from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.data import pipeline, proto, tfrecord
from bayesian_yolov3_torch.infer import InferenceRunner
from bayesian_yolov3_torch.models.yolov3 import draw_key_table
from bayesian_yolov3_torch.parallel import initialize_distributed

import torch_parity as tp

WORLD = 2
NB = 4  # the batch: two images per rank
STEP = 12
MAX_OUT = 20
KW = dict(inference_mode=False, batch_size=NB, compute_dtype="float32",
          full_img_size=tp.IMG, nms_max_boxes=MAX_OUT, nms_pre_top_k=0)
IMAGES = tp.image_u8(seed=4, nb=NB)
N_FRAMES = 6  # run(): a full batch of 4, then 2 padded to 4
DP = {"dp": WORLD}
DP_TOL = dict(rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _weights(model):
    """numpy (params, stats) of a variant; aleatoric and bayesian share
    theirs.  Detection convs scaled so that raw logits are a few units."""
    spec = JSpec(JVariant("standard" if model == "standard" else "bayesian"), 2)
    params_np, stats_np = tp.numpy_weights(seed=3, spec=spec)
    for i in (1, 2, 3):
        params_np[f"det{i}"]["w"] *= np.float32(0.2)
    return params_np, stats_np


def _load_state(self):
    return (*tp.to_torch(*_weights(self.config.model)), STEP)


def _config(data, **kw):
    return Config(**{**KW, "model": "aleatoric", **kw}, cpu_thread_cnt=1,
                  data=DataConfig(file_pattern=data["pattern"]))


def _share(a, r):
    per = NB // WORLD
    return a[r * per:(r + 1) * per]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    os.makedirs(root / "data")
    with tfrecord.TFRecordWriter(str(root / "data" / "d-00000-of-00001.tfrecord")) as wr:
        for i in range(N_FRAMES):
            wr.write(proto.encode_example({
                "image/encoded": [pipeline.encode_png(tp.image_u8(seed=60 + i)[0])],
                "image/filename": [f"frame_{i}.png".encode()],
            }))
    return {"root": str(root), "pattern": str(root / "data" / "d-*-of-*.tfrecord")}


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------


def _rank_work(rank, data, out):
    res = {}
    for model in ("standard", "aleatoric"):
        r = InferenceRunner(_config(data, model=model, mesh_shape=DP), device="cpu")
        params, stats = tp.to_torch(*_weights(model))
        res[f"{model}_rows"], res[f"{model}_valid"] = r.predict(params, stats, IMAGES)
        local_rows, _ = r._dp.local(params, stats,
                                    torch.from_numpy(r._dp.shard(IMAGES)).float() / 255.0)
        res[f"{model}_local"] = local_rows.numpy()
    res["batch_size"] = np.array(r.device_batch_size())
    res["on_device"] = r._to_device(IMAGES).numpy()  # what run() and predict() copy

    # the bayesian variant with dropout: predict draws an (N, 15) table from
    # the runner's generator, seeded 0 on every rank
    r = InferenceRunner(_config(data, model="bayesian", mesh_shape=DP), seed=0, device="cpu")
    res["bayes_rows"], res["bayes_valid"] = r.predict(params, stats, IMAGES)

    q = InferenceRunner(_config(data, mesh_shape=DP, quantize="int8"), device="cpu")
    q.calibrate_int8(params, stats, IMAGES[:1])
    res["int8_rows"], res["int8_valid"] = q.predict(params, stats, IMAGES)

    runner = InferenceRunner(_config(data, mesh_shape=DP, out_path=os.path.join(out, "run")),
                             device="cpu")
    writes = []
    write = runner._write_batch
    runner._write_batch = lambda *a: (writes.append(1), write(*a))
    res["run_dir"] = np.array(runner.run())
    res["run_writes"] = np.array(len(writes))
    try:  # every rank refuses a second run into the same directory
        runner.run()
        res["refused"] = np.array(False)
    except FileExistsError:
        res["refused"] = np.array(True)
    return res


def _cli_work(rank, data, out, port):
    """``cli.inference_aleatoric`` as ``torchrun --nproc_per_node 2`` starts
    it, with ``mesh_shape={"dp": 2}``, on the CPU."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    writes = []
    write = InferenceRunner._write_batch
    InferenceRunner._write_batch = lambda self, *a: (writes.append(1), write(self, *a))
    sets = {"mesh_shape": json.dumps(DP), "run_id": "dp", "step": STEP,
            "full_img_size": json.dumps(list(tp.IMG)), "batch_size": NB,
            "compute_dtype": "float32", "nms_max_boxes": MAX_OUT, "nms_pre_top_k": 0,
            "cpu_thread_cnt": 1, "data.file_pattern": data["pattern"], "data.num_shards": 1,
            "out_path": os.path.join(out, "cli")}
    argv = ["--device", "cpu"] + [a for k, v in sets.items() for a in ("--set", f"{k}={v}")]
    return {"cli_dir": np.array(cli_aleatoric.main(argv)), "cli_writes": np.array(len(writes)),
            "cli_world": np.array(dist.get_world_size()), "cli_rank": np.array(dist.get_rank()),
            "cli_log_level": np.array(logging.getLogger().level)}


def _rank_main(rank, store, out, data):
    InferenceRunner.load_state = _load_state  # this process's runners: the module's weights
    initialize_distributed("gloo", f"file://{store}", world_size=WORLD, rank=rank,
                           device="cpu")
    res = _rank_work(rank, data, out)
    port = [tp.free_port() if rank == 0 else None]
    dist.broadcast_object_list(port, src=0)
    dist.destroy_process_group()
    root = logging.getLogger()  # as a fresh process has it: no handler yet
    for h in list(root.handlers):
        root.removeHandler(h)
    root.setLevel(logging.WARNING)
    res.update(_cli_work(rank, data, out, port[0]))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def ranks(data):
    out = os.path.join(data["root"], "ranks")
    os.makedirs(out)
    tp.run_ranks(_rank_main, WORLD, out, os.path.join(out, "store"), out, data)
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(WORLD)]


# --------------------------------------------------------------------------
# references
# --------------------------------------------------------------------------


def _jax_rows(model, imgs_u8, site_keys=None):
    """The JAX package's single-device batched pipeline on ``imgs_u8``."""
    jspec = JSpec(JVariant(model), 2)
    outs = tp.jax_forward_cf(*_weights(model), imgs_u8.astype(np.float32) / 255.0, jspec,
                             site_keys)
    flat = j_decode([(jnp.asarray(r), hw) for r, hw in outs], j_priors_as_array(J_PRIORS),
                    spec=jspec, interpret=True)
    rows, valid = jnms.nms_select_batch(flat, jspec.obj_idx(False), MAX_OUT, 0.5,
                                        pre_top_k=0)[:2]
    return np.asarray(rows), np.asarray(valid)


def _single(model, **kw):
    """The port's single-device runner for one rank's share of the batch."""
    return InferenceRunner(Config(**{**KW, "model": model, "batch_size": NB // WORLD, **kw}),
                           device="cpu")


def _assert_rows(got_rows, got_valid, want_rows, want_valid, **tol):
    np.testing.assert_array_equal(got_valid, want_valid)
    np.testing.assert_array_equal(got_rows[..., -2:], want_rows[..., -2:])  # layer, prior ids
    np.testing.assert_allclose(got_rows, want_rows, **(tol or DP_TOL))


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["standard", "aleatoric"])
def test_dp_matches_jax_single_device(ranks, model):
    """Every rank holds the whole batch, in image order; each half equals
    the JAX package's single-device pipeline on those images, and the
    port's single-device runner's."""
    r0, r1 = ranks
    np.testing.assert_array_equal(r0[f"{model}_rows"], r1[f"{model}_rows"])
    np.testing.assert_array_equal(r0[f"{model}_valid"], r1[f"{model}_valid"])
    assert r0[f"{model}_rows"].shape[:2] == (NB, MAX_OUT)
    single = _single(model)
    params, stats = tp.to_torch(*_weights(model))
    for r in range(WORLD):
        got = _share(r0[f"{model}_rows"], r), _share(r0[f"{model}_valid"], r)
        want_rows, want_valid = _jax_rows(model, _share(IMAGES, r))
        assert want_valid.sum() > 10
        _assert_rows(*got, want_rows, want_valid)
        _assert_rows(*got, *single.predict(params, stats, _share(IMAGES, r)))
        # the rank's own share, before the gather
        np.testing.assert_array_equal(ranks[r][f"{model}_local"],
                                      _share(r0[f"{model}_rows"], r))


def test_dp_rank_copies_only_its_share(ranks):
    """A dp rank puts only its NB/N images of the host batch on its device."""
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["on_device"], _share(IMAGES, r))


def test_dp_bayesian_rank_r_drops_out_with_key_row_r(ranks):
    """The bayesian variant with dropout: every rank drew the same (2, 15)
    table (the runner's generator, seed 0); rank r's images took row r.
    Held against the port's single-device runner under that row and the
    JAX package's heads under ``fixed_site_keys=row r``; the two rows give
    the same images other masks."""
    table = draw_key_table(torch.Generator().manual_seed(0), WORLD)
    r0 = ranks[0]
    np.testing.assert_array_equal(r0["bayes_rows"], ranks[1]["bayes_rows"])
    single = _single("bayesian")
    params, stats = tp.to_torch(*_weights("bayesian"))
    for r in range(WORLD):
        got = _share(r0["bayes_rows"], r), _share(r0["bayes_valid"], r)
        want = single.predict(params, stats, _share(IMAGES, r), keys=table[r:r + 1])
        _assert_rows(*got, *want)
        _assert_rows(*got, *_jax_rows("bayesian", _share(IMAGES, r), table[r]),
                     rtol=1e-3, atol=1e-4)
    other = single.predict(params, stats, _share(IMAGES, 0), keys=table[1:2])[0]
    assert not np.allclose(other, _share(r0["bayes_rows"], 0), atol=1e-3)  # rows differ


def test_dp_int8_matches_single_device_int8_runner(ranks):
    """quantize="int8" over dp: each rank calibrated on the same image with
    the same seed-0 generator; its share equals the single-device int8
    runner calibrated alike."""
    single = _single("aleatoric", quantize="int8")
    params, stats = tp.to_torch(*_weights("aleatoric"))
    single.calibrate_int8(params, stats, IMAGES[:1])
    for res in ranks:
        for r in range(WORLD):
            _assert_rows(_share(res["int8_rows"], r), _share(res["int8_valid"], r),
                         *single.predict(params, stats, _share(IMAGES, r)))


def _read_dets(out_dir):
    out = {}
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            out[os.path.basename(f)] = json.load(fh)["children"]
    return out


def _assert_dets_close(got, want):
    """Detections of one frame, in NMS order, at the dp tolerances carried
    to JSON units (pixels for the corners)."""
    assert len(got) == len(want) > 5
    px = max(tp.IMG[:2])
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["identity"] == w["identity"]
        assert (g["layer_id"], g["prior_id"]) == (w["layer_id"], w["prior_id"])
        for k, v in w.items():
            if k not in ("identity", "layer_id", "prior_id"):
                atol = 1e-6 * px if k in ("x0", "y0", "x1", "y1") else 1e-6
                np.testing.assert_allclose(g[k], v, rtol=1e-5, atol=atol, err_msg=k)


def test_runner_dp_run_writes_json_on_rank_0(ranks, data, tmp_path, monkeypatch):
    """run() over 6 frames (a full batch of 4, then 2 padded to 4): rank 0
    writes every frame's JSON, rank 1 none; both return the same directory
    and refuse a second run together; the JSON equals the single-device
    runner's, batch 2 (a rank's share), frame by frame."""
    r0, r1 = ranks
    assert str(r0["run_dir"]) == str(r1["run_dir"]) and str(r0["run_dir"]).endswith(f"_{STEP}")
    assert int(r0["run_writes"]) == 2 and int(r1["run_writes"]) == 0  # batches
    assert bool(r0["refused"]) and bool(r1["refused"])
    assert int(r0["batch_size"]) == NB
    monkeypatch.setattr(InferenceRunner, "load_state", _load_state)
    want = _read_dets(_single("aleatoric", out_path=str(tmp_path / "one"),
                              data=DataConfig(file_pattern=data["pattern"])).run())
    got = _read_dets(str(r0["run_dir"]))
    assert sorted(got) == sorted(want) == [f"frame_{i}.json" for i in range(N_FRAMES)]
    for name in got:
        _assert_dets_close(got[name], want[name])


def test_cli_dp_joins_group_from_torchrun_env(ranks):
    """The aleatoric CLI under torchrun's environment with mesh_shape
    {"dp": 2}: one group of world size 2, rank 0 alone writes, rank 1 logs
    warnings only, and the JSON equals the runner's own dp run."""
    r0, r1 = ranks
    assert str(r0["cli_dir"]) == str(r1["cli_dir"]) and str(r0["cli_dir"]).endswith("cli_12")
    assert [int(r["cli_world"]) for r in ranks] == [WORLD, WORLD]
    assert [int(r["cli_rank"]) for r in ranks] == [0, 1]
    assert int(r0["cli_writes"]) == 2 and int(r1["cli_writes"]) == 0
    assert int(r0["cli_log_level"]) == logging.INFO
    assert int(r1["cli_log_level"]) == logging.WARNING
    got, want = _read_dets(str(r0["cli_dir"])), _read_dets(str(r0["run_dir"]))
    assert sorted(got) == sorted(want) and len(got) == N_FRAMES
    for name in got:
        assert got[name] == want[name]


@pytest.mark.parametrize("kw,match", [
    (dict(model="bayesian", inference_mode=True, T=4, batch_size=1), "batch-1"),
    (dict(mesh_shape={"dp": 2, "sp": 2}), "compose"),
    (dict(mesh_shape={"dp": 2, "mc": 1}), "compose"),
    (dict(batch_size=3), "divide"),
    (dict(packed_host_input=True), "packed"),
])
def test_runner_refuses_dp_rules(kw, match):
    """The JAX runner's dp refusals (infer/runner.py:80-97), each a
    ValueError, before any group is needed."""
    with pytest.raises(ValueError, match=match):
        InferenceRunner(Config(**{**KW, "model": "aleatoric", "mesh_shape": DP, **kw}),
                        device="cpu")


def test_dp_needs_a_group_of_its_size():
    with pytest.raises(RuntimeError, match="world size 2"):
        InferenceRunner(Config(**KW, model="standard", mesh_shape=DP), device="cpu")


def test_dp1_is_the_single_device_path():
    runner = InferenceRunner(Config(**KW, model="standard", mesh_shape={"dp": 1}), device="cpu")
    assert runner.group is None and runner._dp is None
    assert runner.device_batch_size() == NB and runner.draw_keys() is None
