"""The port's MC-sample-sharded epistemic inference on the CPU: the split
form of the epistemic decode (partial moments, summed, then finalized)
against the JAX package, and the sharded pipeline and runner over two
``gloo`` ranks against the JAX package's mc mesh and the port's own
single-device path.

The two ranks are spawned processes of ONE module-scoped job (process
start and checkpoint load are paid once): they join a ``gloo`` group
through a file store under the test's temp directory (parallel pytest
workers never share a port), run every rank-side case and save what they
got; then they run the CLI as torchrun would start it, joining a second
group from the environment (a TCP store on a localhost port that rank 0
picks just before); a rank that hangs fails the job at the join timeout.

Tolerances.  Kernel level (plain versions against the JAX kernels'
interpret mode, same inputs): rtol 1e-5 / atol 1e-5 for the moment sums
(float32 sums over the samples in another order), rtol 1e-5 / atol 1e-6
for the finalized rows except column 12, the 4x4 covariance determinant,
at rtol 1e-4 (a difference of products of near-equal numbers).  The split
composition against the one-shot decode: the JAX package's own split
tolerances (tests/test_pallas.py:151-153), since the sums are reordered.
Whole pipelines, float32: rtol 1e-4 / atol 1e-5 as the JAX package holds
its sharded pipeline against its single-device one
(tests/test_mc_sharded.py:180-183); ECP JSON against the JAX runner:
those tolerances carried to JSON units (pixels for the corners)."""

import glob
import json
import logging
import os
import socket
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from bayesian_yolov3_tpu.config import Config as JConfig
from bayesian_yolov3_tpu.core.priors import priors_as_array as j_priors_as_array
from bayesian_yolov3_tpu.infer.runner import InferenceRunner as JRunner
from bayesian_yolov3_tpu.models.yolov3 import YoloV3 as JYoloV3
from bayesian_yolov3_tpu.ops.pallas_epistemic import (
    epistemic_finalize as j_finalize,
    epistemic_moments_cf as j_moments,
    fused_epistemic_decode_cf_batched as j_decode,
)
from bayesian_yolov3_tpu.parallel import mesh as j_mesh
from bayesian_yolov3_tpu.parallel.epistemic import (
    make_mc_sharded_fused_pipeline as j_make_pipeline,
)

from bayesian_yolov3_torch.cli import inference_epistemic as cli_epistemic
from bayesian_yolov3_torch.cli._common import parse_cli
from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.data import pipeline, proto, tfrecord
from bayesian_yolov3_torch.infer import InferenceRunner
from bayesian_yolov3_torch.models.yolov3 import YoloV3
from bayesian_yolov3_torch.ops import cuda_epistemic, cuda_moments
from bayesian_yolov3_torch.parallel import (
    initialize_distributed,
    local_rows,
    make_groups,
    make_mc_sharded_fused_pipeline,
)
from bayesian_yolov3_torch.train import CheckpointStore, partition_params

import torch_parity as tp

PRIORS = np.array([[0.3, 0.1], [0.15, 0.05], [0.08, 0.02]], np.float32)
WORLD = 2
JOIN_TIMEOUT_S = 120
T = 8
SEED = 123  # fixed_mc_masks seed, as in tests/test_mc_sharded.py
CKPT_RUN, CKPT_STEP = "mc", 12
KW = dict(model="bayesian", inference_mode=True, T=T, batch_size=1,
          compute_dtype="float32", full_img_size=tp.IMG, nms_max_boxes=20,
          nms_pre_top_k=0, cpu_thread_cnt=1)
N_FRAMES = 2
# 40 candidates cannot fill 50 selections: the certificate fails, the exact
# retry runs
FALLBACK = dict(nms_max_boxes=50, nms_pre_top_k=40)


def _raw(rng, C, t, total, scale=1.0):
    return (rng.standard_normal((3 * 2 * (5 + C), t, total)) * scale).astype(np.float32)


def _assert_split_close(got, want):
    """tests/test_pallas.py:151-153: the split composition against the
    one-shot decode."""
    np.testing.assert_allclose(got[..., :12], want[..., :12], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[..., 12], want[..., 12], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got[..., 13:], want[..., 13:], rtol=1e-4, atol=2e-4)


# --------------------------------------------------------------------------
# the two kernels' plain versions and their composition
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,t_local,C", [(4, 8, 8, 2), (3, 5, 1, 1), (2, 6, 3, 8),
                                           (8, 16, 15, 2)])
def test_moments_plain_matches_jax(h, w, t_local, C):
    raw = _raw(np.random.default_rng(100 * h + t_local), C, t_local, h * w, scale=2.0)
    want = np.asarray(j_moments(jnp.asarray(raw), cls_cnt=C, interpret=True))
    got = cuda_moments.epistemic_moments_cf(torch.from_numpy(raw), cls_cnt=C)
    assert got.shape == want.shape == (3, 21 + C, h * w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_imgs", [1, 2])
def test_finalize_plain_matches_jax(n_imgs):
    """Finalize the same global sums in both packages; the sums are those of
    real samples, so the covariance is a covariance."""
    C, h, w = 2, 4, 6
    raw = _raw(np.random.default_rng(7 + n_imgs), C, 12, n_imgs * h * w)
    sums = np.array(j_moments(jnp.asarray(raw), cls_cnt=C, interpret=True))  # writable
    kw = dict(T=12, h=h, w=w, cls_cnt=C, layer_id=1, n_imgs=n_imgs)
    want = np.asarray(j_finalize(jnp.asarray(sums), jnp.asarray(PRIORS), interpret=True, **kw))
    got = cuda_moments.epistemic_finalize(torch.from_numpy(sums), torch.from_numpy(PRIORS),
                                          **kw).numpy()
    assert got.shape == want.shape == (n_imgs, 3 * h * w, 21 + C)
    cols = [c for c in range(21 + C) if c != 12]
    np.testing.assert_allclose(got[..., cols], want[..., cols], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[..., 12], want[..., 12], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_split_composition_matches_one_shot_decode(n_shards):
    """The port's moments of each shard, summed (the all-reduce), finalized
    with the GLOBAL T, against the one-shot decode: the port's and JAX's."""
    C, nb, h, w = 2, 2, 4, 8
    raw = _raw(np.random.default_rng(n_shards), C, T, nb * h * w)
    raw_t, pri_t = torch.from_numpy(raw), torch.from_numpy(PRIORS)
    per = T // n_shards
    sums = sum(cuda_moments.epistemic_moments_cf(raw_t[:, s * per:(s + 1) * per].contiguous(),
                                                 cls_cnt=C) for s in range(n_shards))
    kw = dict(h=h, w=w, cls_cnt=C, layer_id=2, n_imgs=nb)
    got = cuda_moments.epistemic_finalize(sums, pri_t, T=T, **kw).numpy()
    want_port = cuda_epistemic.fused_epistemic_decode_cf_batched(raw_t, pri_t, **kw).numpy()
    want_jax = np.asarray(j_decode(jnp.asarray(raw), jnp.asarray(PRIORS), interpret=True, **kw))
    for want in (want_port, want_jax):
        assert got.shape == want.shape == (nb, 3 * h * w, 21 + C)
        _assert_split_close(got, want)
    np.testing.assert_array_equal(got[..., 21:], want_jax[..., 21:])  # layer, prior ids


def test_wrappers_refuse_what_the_kernels_do_not_take():
    raw = torch.zeros((3 * 14, 2, 12))
    with pytest.raises(TypeError, match="float32"):
        cuda_moments.epistemic_moments_cf(raw.double(), cls_cnt=2)
    with pytest.raises(ValueError, match="channels"):
        cuda_moments.epistemic_moments_cf(raw, cls_cnt=3)
    sums = torch.zeros((3, 23, 12))
    pri = torch.from_numpy(PRIORS)
    with pytest.raises(ValueError, match="moment rows"):
        cuda_moments.epistemic_finalize(sums[:, :22], pri, T=2, h=3, w=4, cls_cnt=2, layer_id=0)
    with pytest.raises(ValueError, match="anchor axis"):
        cuda_moments.epistemic_finalize(sums, pri, T=2, h=3, w=4, cls_cnt=2, layer_id=0,
                                        n_imgs=2)
    with pytest.raises(ValueError, match="outside"):
        cuda_moments.epistemic_moments_cf(torch.zeros((3 * 2 * 14, 1, 4)), cls_cnt=9)


def test_local_rows_and_group_rules():
    table = np.arange(8 * 15).reshape(8, 15)
    parts = [local_rows(table, r, 4) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), table)
    assert parts[1][0, 0] == 2 * 15
    with pytest.raises(ValueError, match="divide"):
        local_rows(table, 0, 3)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="world size 2"):
        make_groups({"mc": 2})["mc"]


# --------------------------------------------------------------------------
# two gloo ranks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    params_np, stats_np = tp.numpy_weights(seed=3)
    for i in (1, 2, 3):  # raw logits of a few units, not tens
        params_np[f"det{i}"]["w"] *= np.float32(0.2)
    return params_np, stats_np


def _frames():
    return [tp.image_u8(seed=40 + i)[0] for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def data(weights, tmp_path_factory):
    """The module's checkpoint (port format) and tfrecord of N_FRAMES frames."""
    root = tmp_path_factory.mktemp("mc")
    cfg = Config(**KW, run_id=CKPT_RUN, checkpoint_path=str(root / "ckpt"))
    tparams, tstats = tp.to_torch(*weights)
    trainable, frozen = partition_params(tparams, cfg.freeze_darknet53)
    CheckpointStore(cfg.checkpoint_path, cfg.run_id).save(
        CKPT_STEP, {"params": trainable, "frozen": frozen, "stats": tstats})
    os.makedirs(root / "data")
    with tfrecord.TFRecordWriter(str(root / "data" / "d-00000-of-00001.tfrecord")) as wr:
        for i, img in enumerate(_frames()):
            wr.write(proto.encode_example({
                "image/encoded": [pipeline.encode_png(img)],
                "image/filename": [f"frame_{i}.png".encode()],
                "image/object/class/label": np.asarray([1], np.int64),
            }))
    yield {"root": str(root), "ckpt": cfg.checkpoint_path,
           "pattern": str(root / "data" / "d-*-of-*.tfrecord")}
    import shutil

    shutil.rmtree(root / "ckpt", ignore_errors=True)


def _config(data, **kw):
    return Config(**{**KW, **kw}, run_id=CKPT_RUN, checkpoint_path=data["ckpt"],
                  data=DataConfig(file_pattern=data["pattern"]))


def _rank_work(rank, data, out):
    """Everything a rank computes, saved for the tests below."""
    res = {}
    mc = {"mc": WORLD}
    fixed = InferenceRunner(_config(data, mesh_shape=mc, fixed_mc_masks=SEED), device="cpu")
    params, stats, _ = fixed.load_state()
    img_u8 = tp.image_u8(seed=4)
    img = torch.from_numpy(img_u8).float() / 255.0

    # the fused pipeline itself, fixed masks
    model = YoloV3.from_config(fixed.config)
    pipe = make_mc_sharded_fused_pipeline(
        model, make_groups(mc)["mc"], T, priors_by_stride=fixed._priors,
        obj_idx=model.spec.obj_idx(epistemic=True), nms_max_boxes=20, fixed_masks=SEED)
    res["pipe_rows"], res["pipe_valid"] = (a.numpy() for a in pipe(params, stats, img))

    # drawn keys, through the runner's own generator (seed 0 on every rank)
    drawn = InferenceRunner(_config(data, mesh_shape=mc), seed=0, device="cpu")
    res["drawn_rows"], res["drawn_valid"] = drawn.predict(params, stats, img_u8)

    # run(): fused with fixed masks; then the all-gather fallback with drawn
    # keys and a pre-top-k that fails the certificate (the exact retry)
    for name, runner in (
            ("fused", fixed),
            ("fallback", InferenceRunner(_config(data, mesh_shape=mc, use_pallas=False,
                                                 **FALLBACK), seed=0, device="cpu"))):
        writes = []
        write = runner._write_batch
        runner._write_batch = lambda *a, _w=write: (writes.append(1), _w(*a))
        res[f"{name}_dir"] = np.array(runner.run(out_path=os.path.join(out, name)))
        res[f"{name}_writes"] = np.array(len(writes))
        res[f"{name}_retried"] = np.array(runner.retried)
        res[f"{name}_fallback"] = np.array(runner._mc_forward is not None)
    try:  # every rank refuses a second run into the same directory
        fixed.run(out_path=os.path.join(out, "fused"))
        res["refused"] = np.array(False)
    except FileExistsError:
        res["refused"] = np.array(True)
    return res


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_work(rank, data, out, port):
    """``cli.inference_epistemic`` as ``torchrun --nproc_per_node 2`` starts
    it: the group joined from RANK / WORLD_SIZE / LOCAL_RANK / MASTER_* in
    the environment, the run on the CPU (``--device cpu``); then the device
    that parse_cli picks when none is named."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    root = logging.getLogger()  # as a fresh process has it: no handler yet
    for h in list(root.handlers):
        root.removeHandler(h)
    root.setLevel(logging.WARNING)
    writes = []
    write = InferenceRunner._write_batch
    InferenceRunner._write_batch = lambda self, *a: (writes.append(1), write(self, *a))
    sets = {"mesh_shape": json.dumps({"mc": WORLD}), "checkpoint_path": data["ckpt"],
            "run_id": CKPT_RUN, "step": CKPT_STEP, "full_img_size": json.dumps(list(tp.IMG)),
            "T": T, "compute_dtype": "float32", "fixed_mc_masks": SEED, "nms_max_boxes": 20,
            "nms_pre_top_k": 0, "cpu_thread_cnt": 1, "data.file_pattern": data["pattern"],
            "data.num_shards": 1, "out_path": os.path.join(out, "cli")}
    argv = ["--device", "cpu"] + [a for k, v in sets.items() for a in ("--set", f"{k}={v}")]
    res = {"cli_dir": np.array(cli_epistemic.main(argv)), "cli_writes": np.array(len(writes)),
           "cli_world": np.array(dist.get_world_size()), "cli_rank": np.array(dist.get_rank()),
           "cli_log_level": np.array(logging.getLogger().level)}
    res["cli_default_device"] = np.array(parse_cli(cli_epistemic.DEFAULTS, [])[1])
    return res


def _rank_main(rank, store, out, data):
    """Entry of a spawned rank: ``_rank_work`` in a group joined by hand,
    then ``_cli_work`` in one the CLI joins (on a port rank 0 picks)."""
    torch.set_num_threads(2)
    try:
        initialize_distributed("gloo", f"file://{store}", world_size=WORLD, rank=rank,
                               device="cpu")
        res = _rank_work(rank, data, out)
        port = [_free_port() if rank == 0 else None]
        dist.broadcast_object_list(port, src=0)
        dist.destroy_process_group()
        res.update(_cli_work(rank, data, out, port[0]))
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(data):
    """Run ``_rank_work`` on WORLD spawned gloo ranks; per rank, its results."""
    out = os.path.join(data["root"], "ranks")
    os.makedirs(out)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, os.path.join(out, "store"), out, data))
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


def _jax_model():
    from bayesian_yolov3_tpu.core.blueprint import Variant, VariantSpec
    from bayesian_yolov3_tpu.core.priors import ECP_9_PRIORS

    return JYoloV3(spec=VariantSpec(Variant.BAYESIAN, 2), priors=ECP_9_PRIORS,
                   img_size=tp.IMG, compute_dtype="float32")


def test_fused_pipeline_matches_jax_mc_mesh(ranks, weights):
    """The port's fused pipeline over two gloo ranks against the JAX
    package's over a 2-device ``mc`` mesh: same weights, image, fixed masks."""
    m = _jax_model()
    pri = j_priors_as_array(m.priors)
    fn = j_make_pipeline(m, j_mesh.make_mesh({"mc": 2}, devices=jax.devices()[:2]), T=T,
                         priors_by_stride=pri, obj_idx=m.spec.obj_idx(epistemic=True),
                         nms_max_boxes=20, interpret=True, fixed_masks=SEED)
    img = jnp.asarray(tp.image_u8(seed=4).astype(np.float32) / 255.0)
    want_rows, want_valid = (np.asarray(a) for a in fn(*map(tp.to_jax, weights), img, None))
    for r in ranks:  # every rank holds the same rows
        np.testing.assert_array_equal(r["pipe_valid"], want_valid)
        np.testing.assert_allclose(r["pipe_rows"], want_rows, rtol=1e-4, atol=1e-5)
    assert want_valid.sum() > 5


def test_drawn_keys_match_single_device(ranks, data, weights):
    """Drawn (not fixed) keys: each rank's runner draws the full table from
    its own generator, seeded alike, and computes its rows of it — the
    single-device runner's samples of the same draw.  A per-rank seed, or a
    generator advanced differently on one rank, fails here."""
    single = InferenceRunner(_config(data), seed=0, device="cpu")
    want_rows, want_valid = single.predict(*tp.to_torch(*weights), tp.image_u8(seed=4))
    for r in ranks:
        np.testing.assert_array_equal(r["drawn_valid"], want_valid)
        _assert_split_close(r["drawn_rows"], want_rows)
    assert want_valid.sum() > 5


def _read_dets(out_dir):
    out = {}
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            out[os.path.basename(f)] = json.load(fh)["children"]
    return out


def _assert_dets_close(got, want, img_hw=tp.IMG[:2]):
    """Detections of one frame, in NMS order, within the pipeline tolerance
    (rtol 1e-4 / atol 1e-5 on the rows; the corners times the image size)."""
    assert len(got) == len(want) > 5
    px = max(img_hw)
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["identity"] == w["identity"]
        assert (g["layer_id"], g["prior_id"]) == (w["layer_id"], w["prior_id"])
        for k, v in w.items():
            if k in ("identity", "layer_id", "prior_id"):
                continue
            atol = 1e-5 * px if k in ("x0", "y0", "x1", "y1") else 1e-5
            rtol = 1e-3 if k == "total_var_epi" else 1e-4
            np.testing.assert_allclose(g[k], v, rtol=rtol, atol=atol, err_msg=k)


def test_runner_mc2_matches_jax_runner_mc8(ranks, data, weights, tmp_path, monkeypatch):
    """InferenceRunner.run() with mesh_shape={'mc': 2} on two gloo ranks and
    fixed masks, against the JAX runner's mesh_shape={'mc': 8} run (fixed-mask
    bits do not depend on the mesh shape).  Rank 0 writes the JSON; rank 1
    writes nothing, returns the same directory, and both refuse to overwrite."""
    r0, r1 = ranks
    assert str(r0["fused_dir"]) == str(r1["fused_dir"]) and str(r0["fused_dir"]).endswith("_12")
    assert int(r0["fused_writes"]) == N_FRAMES and int(r1["fused_writes"]) == 0
    assert bool(r0["refused"]) and bool(r1["refused"])
    assert int(r0["fused_retried"]) == 0  # exact NMS outright
    got = _read_dets(str(r0["fused_dir"]))
    assert sorted(got) == [f"frame_{i}.json" for i in range(N_FRAMES)]

    monkeypatch.setattr(JRunner, "load_state",
                        lambda self: (*map(tp.to_jax, weights), CKPT_STEP))
    jcfg = JConfig(**KW, mesh_shape={"mc": 8}, fixed_mc_masks=SEED,
                   out_path=str(tmp_path / "jax"))
    jcfg.data.file_pattern = data["pattern"]
    want = _read_dets(JRunner(jcfg).run())
    assert sorted(want) == sorted(got)
    for name in got:
        _assert_dets_close(got[name], want[name])


def test_runner_mc2_fallback_matches_single_device(ranks, data, weights, tmp_path):
    """use_pallas=False: the all-gather fallback (the one-shot decode of the
    gathered samples, certified NMS with the exact retry) against the
    single-device runner with the same seed, frame by frame."""
    r0, r1 = ranks
    assert bool(r0["fallback_fallback"]) and bool(r1["fallback_fallback"])
    assert int(r0["fallback_writes"]) == N_FRAMES and int(r1["fallback_writes"]) == 0
    assert int(r0["fallback_retried"]) == int(r1["fallback_retried"]) == N_FRAMES
    single = InferenceRunner(_config(data, **FALLBACK, out_path=str(tmp_path / "one")),
                             seed=0, device="cpu")
    want = _read_dets(single.run())
    assert single.retried == N_FRAMES
    got = _read_dets(str(r0["fallback_dir"]))
    assert sorted(got) == sorted(want) == [f"frame_{i}.json" for i in range(N_FRAMES)]
    for name in got:
        _assert_dets_close(got[name], want[name])


def test_cli_joins_group_from_torchrun_env(ranks):
    """The torchrun entry point: each rank's CLI joined one group of world
    size 2 from the environment, rank 0 alone wrote the JSON (the same
    detections as the runner's own fused run), rank 1 logs warnings only,
    and with no ``--device`` a rank computes on ``cuda:{LOCAL_RANK}``."""
    r0, r1 = ranks
    assert str(r0["cli_dir"]) == str(r1["cli_dir"]) and str(r0["cli_dir"]).endswith("cli_12")
    assert [int(r["cli_world"]) for r in ranks] == [WORLD, WORLD]
    assert [int(r["cli_rank"]) for r in ranks] == [0, 1]
    assert int(r0["cli_writes"]) == N_FRAMES and int(r1["cli_writes"]) == 0
    assert int(r0["cli_log_level"]) == logging.INFO
    assert int(r1["cli_log_level"]) == logging.WARNING
    assert [str(r["cli_default_device"]) for r in ranks] == ["cuda:0", "cuda:1"]
    got, want = _read_dets(str(r0["cli_dir"])), _read_dets(str(r0["fused_dir"]))
    assert sorted(got) == sorted(want) == [f"frame_{i}.json" for i in range(N_FRAMES)]
    for name in got:
        _assert_dets_close(got[name], want[name])


def test_cli_single_process_device(monkeypatch):
    """Outside torchrun the CLI joins no group and computes on cuda:0, or on
    the device that --device names."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    config, device = parse_cli(cli_epistemic.DEFAULTS, ["--set", "T=10"])
    assert device == "cuda:0" and config.T == 10 and not dist.is_initialized()
    assert parse_cli(cli_epistemic.DEFAULTS, ["--device", "cpu"])[1] == "cpu"


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh_shape={"mc": 2}), RuntimeError, "initialised process group of world size 2"),
    (dict(mesh_shape={"mc": 3}), ValueError, "divide evenly"),
    (dict(mesh_shape={"mc": 2}, fixed_mc_masks=7, use_pallas=False), ValueError,
     "fixed_mc_masks"),
    (dict(mesh_shape={"mc": 2}, packed_host_input=True), ValueError, "packed_host_input"),
    (dict(mesh_shape={"mc": 2}, quantize="int8", use_pallas=False), ValueError,
     "fused pipeline"),
    (dict(mesh_shape={"dp": 2}), ValueError, "epistemic inference is batch-1"),
    (dict(mesh_shape={"sp": 2}), RuntimeError, "initialised process group of world size 2"),
    (dict(mesh_shape={"mc": 2}, model="aleatoric", inference_mode=False), ValueError,
     "epistemic"),
    (dict(mesh_shape={"data": 2}), ValueError, "unknown mesh axes"),
])
def test_runner_refuses_mesh_rules(kw, exc, match):
    with pytest.raises(exc, match=match):
        InferenceRunner(Config(**{**KW, **kw}), device="cpu")


def test_mc1_is_the_single_device_path():
    runner = InferenceRunner(Config(**KW, mesh_shape={"mc": 1}), device="cpu")
    assert runner.group is None and runner.device_batch_size() == 1
