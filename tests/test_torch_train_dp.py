"""The port's data-parallel training (``mesh_shape={'data': N}``,
``train/loop.py``) on the CPU over two ``gloo`` ranks, against the JAX
package's step with the batch sharded over conftest's 8-device CPU mesh.

The bayesian variant (dropout on), global batch 8 at 64x96, the numpy
weights of ``tests/test_torch_train.py`` (seed 0), one preprocessed batch
(JAX's GT encoding) and 15 dropout keys.  The ranks are spawned processes
of ONE module-scoped job: each takes its 4 images through the port's
``apply`` step over a group joined through a file store, then both run
``cli/pretraining.py`` in float32 under a second group joined as torchrun
starts it.

The step is compared in float64, as ``tests/test_torch_train.py``'s
``test_step1_grads_match_jax_in_float64`` compares one device's: JAX under
``jax.enable_x64`` with its ``jnp.float32`` casts read as float64, the port
with its ``.float()`` casts read as ``.double()``.  In float32 the two
packages' gradients on this batch lie up to 1.2e-3 apart (relative L2, a
head BN beta) with the port on one device: LeakyReLU
inputs that the two float32 forwards put on either side of 0 (see
``tests/test_torch_train.py:WEIGHT_SEED``).  Tolerances, PR 13's float64
ones: loss rtol 1e-12, every trainable leaf's gradient at relative L2 <=
1e-10; the new BN statistics rtol 1e-10 (these read 1.6e-14 and 1.1e-13).
The parameters after one Adam step: each element's change at rtol 1e-4 of
optax's — the port's Adam computes its bias corrections in float32, as
optax does in float32, where optax under x64 computes them in float64: the
changes then read 6.7e-6 apart (relative) and no closer."""

import contextlib
import functools
import glob
import hashlib
import json
import os
import shutil

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant, VariantSpec as JSpec
from bayesian_yolov3_tpu.core.priors import ECP_9_PRIORS
from bayesian_yolov3_tpu.data import encode as jenc
from bayesian_yolov3_tpu.models import darknet as jdarknet
from bayesian_yolov3_tpu.models.yolov3 import YoloV3 as JYolo
from bayesian_yolov3_tpu.ops import common as jcommon
from bayesian_yolov3_tpu.ops import decode as jdec
from bayesian_yolov3_tpu.ops import loss as jloss
from bayesian_yolov3_tpu.parallel import mesh as jmesh
from bayesian_yolov3_tpu.train import loop as jloop

from bayesian_yolov3_torch.cli import pretraining
from bayesian_yolov3_torch.config import Config
from bayesian_yolov3_torch.models import yolov3 as tyolo
from bayesian_yolov3_torch.ops import common
from bayesian_yolov3_torch.parallel import initialize_distributed
from bayesian_yolov3_torch.train import CheckpointStore
from bayesian_yolov3_torch.train import loop as tloop

import synth
import torch_parity as tp

WORLD = 2
IMG = (64, 96, 3)
NB, MAX_BOXES = 8, 8  # the global batch: 4 images a rank
LR = 1e-5
WEIGHT_SEED = 0  # tests/test_torch_train.py's: no LeakyReLU input near 0 in float32
SPEC = JSpec(JVariant("bayesian"), 2)
CLI_STEPS = 3
# the rank job's hang guard: it takes 33 s alone on an 8-core CPU host and
# shares the CPU with the references and the other test files in a whole
# run; a rank still running at this deadline fails the job
RANK_TIMEOUT_S = 480


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _inputs():
    """(float32 images in [0, 1), JAX's GT encoding as a list of numpy
    dicts, the (1, 15) dropout keys, the JAX key they come from) of the
    global batch."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (NB, *IMG), dtype=np.uint8)
    n = rng.integers(1, MAX_BOXES, NB)
    yx = rng.uniform(0.05, 0.6, (NB, MAX_BOXES, 2))
    hw = rng.uniform(0.08, 0.4, (NB, MAX_BOXES, 2))
    bbox = np.concatenate([yx, np.minimum(yx + hw, 0.99)], axis=-1).astype(np.float32)
    label = rng.integers(0, 2, (NB, MAX_BOXES)).astype(np.int32)
    valid = np.arange(MAX_BOXES)[None, :] < n[:, None]
    tables = jenc.build_prior_tables(JYolo(spec=SPEC, priors=ECP_9_PRIORS, img_size=IMG).blueprint)
    gts = jax.vmap(lambda b, l, v: jenc.encode_boxes(b, l, v, tables))(
        jnp.asarray(bbox), jnp.asarray(label), jnp.asarray(valid))
    kd = jax.random.PRNGKey(5)
    keys = np.asarray([[int(jax.random.bits(k, (), jnp.uint32))
                        for k in jax.random.split(kd, 15)]], np.uint32)
    return imgs.astype(np.float32) / np.float32(255.0), [_tree_np(g) for g in gts], keys, kd


def _config(**kw):
    return Config(**{**dict(model="bayesian", full_img_size=IMG, batch_size=NB,
                            max_boxes_per_img=MAX_BOXES, lr=LR, compute_dtype="float32",
                            aleatoric_loss=False, darknet53_weights=""), **kw})


def _digest(tree):
    """sha256 of a nested dict of arrays and numbers, keys in sorted order."""
    h = hashlib.sha256()

    def walk(t):
        for k in sorted(t):
            h.update(k.encode())
            v = t[k]
            if isinstance(v, dict):
                walk(v)
            else:
                h.update(np.ascontiguousarray(v).tobytes())

    walk(tree)
    return h.hexdigest()


def _as64(tree):
    return {k: _as64(v) if isinstance(v, dict) else v.double() for k, v in tree.items()}


@contextlib.contextmanager
def _port_float64():
    """The port's training step in float64: ``.float()`` read as
    ``.double()`` and a float64 compute dtype."""
    cast = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    tyolo._DTYPES["float64"] = torch.float64
    try:
        yield
    finally:
        torch.Tensor.float = cast
        del tyolo._DTYPES["float64"]


def _port_step(group, rows, inputs):
    """The port's float64 step on ``rows`` of the global batch ``inputs``
    (``_inputs()``): (loss, the averaged gradients by name, the new
    statistics, the updated trainable params)."""
    x, gts, keys, _ = inputs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop, "dropout_keys", lambda seed, step: keys)
        return _port_step_keyed(group, rows, x, gts)


def _port_step_keyed(group, rows, x, gts):
    cfg = _config()
    model = tloop.YoloV3.from_config(cfg)
    model.compute_dtype = "float64"
    step, _, opt = tloop.make_train_step(model, cfg, None, group=group)
    params, stats = tp.to_torch(*tp.numpy_weights(seed=WEIGHT_SEED, spec=SPEC))
    trainable, frozen = tloop.partition_params(_as64(params), True)
    for p in tloop.leaves(trainable):
        p.requires_grad_(True)
    state = {"params": trainable, "frozen": frozen, "stats": _as64(stats),
             "opt": opt.init(trainable), "step": 0}
    seen = {}
    update = opt.update
    opt.update = lambda grads, *a: (seen.setdefault("grads", list(grads)), update(grads, *a))[1]
    with _port_float64():
        state, metrics = step.apply(
            state, torch.from_numpy(x[rows]).double(),
            [{k: torch.from_numpy(np.array(v[rows])) for k, v in g.items()} for g in gts])
    assert all(g.dtype == torch.float64 for g in seen["grads"])
    names = list(_flat(trainable))
    return {"loss": float(metrics["total"]),
            "grads": dict(zip(names, (g.numpy() for g in seen["grads"]))),
            "stats": _flat({k: v for k, v in state["stats"].items() if k != "backbone"}),
            "params": _flat(state["params"]),
            "opt": _flat({"mu": state["opt"]["mu"], "nu": state["opt"]["nu"]})}


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------


def _rank_main(rank, store, out, pattern, inputs):
    initialize_distributed("gloo", f"file://{store}", world_size=WORLD, rank=rank,
                           device="cpu")
    group = tloop.data_group(_config(mesh_shape={"data": WORLD}))
    per = NB // WORLD
    res = {"rank": group.rank, "size": group.size}
    step = _port_step(group, slice(rank * per, (rank + 1) * per), inputs)
    res["step_digest"] = _digest(step)
    if rank == 0:  # the other's equals it (its digest): one copy to compare, as npz (fast)
        np.savez(os.path.join(out, "step0.npz"), loss=step["loss"],
                 **{f"{k}/{n}": a for k in ("grads", "stats", "params") for n, a in step[k].items()})
    # the mask of a dropout site over this rank's 4 images of the batch
    ones = torch.ones(per, 8, 12, 16)
    res["mask"] = common.dropout(ones, 0.1, 12345, origin=(0, 8, rank * per)).numpy()

    port = [tp.free_port() if rank == 0 else None]
    dist.broadcast_object_list(port, src=0)
    dist.destroy_process_group()
    res["cli"] = _cli_work(rank, out, pattern, port[0])
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _cli_work(rank, out, pattern, port):
    """``cli/pretraining.py`` as ``torchrun --nproc-per-node 2`` starts it
    with ``mesh_shape={"data": 2}``: 3 steps, a checkpoint at 2 and 3;
    which rank wrote what, and the state it ended with."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    writes = []
    for cls, name in ((CheckpointStore, "save"), (CheckpointStore, "save_config_snapshot"),
                      (tloop.Trainer, "_log_metrics"), (tloop.StepTimer, "write")):
        orig = getattr(cls, name)
        setattr(cls, name, lambda *a, _o=orig, _n=name: (writes.append(_n), _o(*a))[1])
    sets = {"mesh_shape": json.dumps({"data": WORLD}), "run_id": "dp", "crop": "false",
            "full_img_size": json.dumps(list(IMG)), "batch_size": 4, "max_boxes_per_img": 8,
            "train_steps": CLI_STEPS, "checkpoint_interval": 2, "darknet53_weights": "",
            "compute_dtype": "float32", "cpu_thread_cnt": 1, "lr": 1e-3,
            "checkpoint_path": os.path.join(out, "ckpt"), "log_path": os.path.join(out, "log"),
            "tensorboard_path": os.path.join(out, "tb"), "train.file_pattern": pattern,
            "val.file_pattern": pattern, "train.shuffle_buffer_size": 2,
            "val.shuffle_buffer_size": 2}
    argv = ["--device", "cpu"] + [a for k, v in sets.items() for a in ("--set", f"{k}={v}")]
    res = pretraining.main(argv)
    state = res["state"]
    return {"writes": writes, "world": dist.get_world_size(), "step": res["step"],
            "losses": res["losses"], "count": state["opt"]["count"],
            "digest": _digest({**{k: _flat(state[k]) for k in ("params", "frozen", "stats")},
                               "opt": _flat({"mu": state["opt"]["mu"],
                                             "nu": state["opt"]["nu"]})})}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The rank job, started: (join, its output directory)."""
    root = tmp_path_factory.mktemp("train_dp")
    pattern = synth.write_dataset(str(root / "data"), np.random.default_rng(0), n_images=8,
                                  img_hw=IMG[:2], shards=2)
    out = str(root / "ranks")
    os.makedirs(out)
    x, gts, keys, _ = _inputs()  # the ranks take the arrays: no JAX program runs there
    return tp.start_ranks(_rank_main, WORLD, out, os.path.join(out, "store"), out,
                          pattern, (x, gts, keys, None), timeout_s=RANK_TIMEOUT_S), out


@pytest.fixture(scope="module")
def ranks(started, jax_step, one_rank):
    """The ranks' results, joined after the references (computed while the
    ranks run)."""
    join, out = started
    join()
    got = []
    for r in range(WORLD):
        got.append(torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False))
        os.remove(os.path.join(out, f"rank{r}.pt"))
    step = {"grads": {}, "stats": {}, "params": {}}
    with np.load(os.path.join(out, "step0.npz")) as z:
        for key in z.files:
            if key == "loss":
                step["loss"] = float(z[key])
            else:
                kind, name = key.split("/", 1)
                step[kind][name] = z[key]
    got[0]["step"] = step
    os.remove(os.path.join(out, "step0.npz"))
    # what the CLI's run left in its store, read before its two 0.4 GB
    # checkpoints are deleted
    store = CheckpointStore(os.path.join(out, "ckpt"), "dp")
    got[0]["store"] = {"steps": store.all_steps(),
                       "snapshots": len(glob.glob(os.path.join(store.dir, "config_*.json")))}
    shutil.rmtree(os.path.join(out, "ckpt"))
    return got


# --------------------------------------------------------------------------
# references
# --------------------------------------------------------------------------


class _Float64Names:
    """``jax.numpy`` with ``float32`` read as ``float64`` (as in
    ``tests/test_torch_train.py``)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's float64 step as its ``Trainer`` runs it on a ``data`` mesh:
    ``jax.grad`` of its ``loss_fn`` jitted with the batch sharded over the 8
    devices (``parallel/mesh.py:shard_batch``), the state replicated;
    optax's Adam."""
    x, gts, _, kd = _inputs()
    jm = JYolo(spec=SPEC, priors=ECP_9_PRIORS, img_size=IMG, compute_dtype="float64")

    def loss_fn(trainable, frozen, stats, imgs, gts, rng):
        params = jloop.merge_params(trainable, frozen)
        raws, new_stats = jm.forward(params, stats, imgs, training=True, rng=rng)
        dets = [jdec.split_detection(raw, jm.spec) for raw in raws]
        total, metrics = jloss.total_loss(dets, gts, params, False)
        return total, (metrics, new_stats)

    params_np, stats_np = tp.numpy_weights(seed=WEIGHT_SEED, spec=SPEC)
    mesh = jmesh.make_mesh({"data": len(jax.devices())})
    rep = functools.partial(jmesh.replicate, mesh)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in (jcommon, jdec, jloss, jdarknet):
            mp.setattr(mod, "jnp", _Float64Names())
        f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        trainable, frozen = jloop.partition_params(f64(params_np), True)
        batch = jmesh.shard_batch(mesh, {"x": x.astype(np.float64), "gts": gts})
        assert len(batch["x"].sharding.device_set) == 8
        grads, (metrics, new_stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            rep(trainable), rep(frozen), rep(f64(stats_np)), batch["x"], batch["gts"], kd)
        opt = optax.adam(LR)
        upd, _ = opt.update(grads, opt.init(trainable), trainable)
        new = optax.apply_updates(trainable, upd)
        grads, new, new_stats, trainable = (_tree_np(t) for t in (grads, new, new_stats,
                                                                   trainable))
        loss = float(metrics["total"])
    assert grads["det1"]["w"].dtype == np.float64

    return {"loss": loss, "grads": _flat(_to_port(grads)),
            "stats": _flat({k: v for k, v in _to_port(new_stats).items() if k != "backbone"}),
            "params": _flat(_to_port(new)), "start": _flat(_to_port(trainable))}


def _to_port(tree):
    """A JAX-layout numpy tree in the port's layout (kernels OIHW), its
    dtype kept."""
    return {k: _to_port(v) if isinstance(v, dict) else
            np.ascontiguousarray(v.transpose(3, 2, 0, 1) if k == "w" else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def one_rank():
    """The port's step on one device over the whole global batch."""
    return _port_step(None, slice(0, NB), _inputs())


def _assert_step(got, want, start):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-12)
    assert got["grads"].keys() == want["grads"].keys()
    for name, w in want["grads"].items():
        assert got["grads"][name].dtype == w.dtype == np.float64, name
        rel = _rel_l2(got["grads"][name], w)
        assert rel <= 1e-10, f"{name}: gradient at relative L2 {rel:.2e}"
    assert got["stats"].keys() == want["stats"].keys()
    for name, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][name], w, rtol=1e-10, err_msg=name)
    for name, w in want["params"].items():
        change = w - start[name]
        assert np.linalg.norm(change) > 0, name
        np.testing.assert_allclose(got["params"][name] - start[name], change, rtol=1e-4,
                                   atol=0, err_msg=name)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------


def test_two_ranks_match_jax_on_the_data_mesh(ranks, jax_step):
    """Each rank's step on its 4 images — loss, every trainable leaf's
    averaged gradient, the heads' new statistics, the updated parameters —
    against JAX's step on the 8-device mesh."""
    for r in ranks:
        assert (r["rank"], r["size"]) == (ranks.index(r), WORLD)
    assert ranks[0]["step_digest"] == ranks[1]["step_digest"]
    _assert_step(ranks[0]["step"], jax_step, jax_step["start"])


def test_two_ranks_match_one_port_rank(ranks, one_rank, jax_step):
    """The same against the port's step on one device over the global batch."""
    _assert_step(ranks[0]["step"], one_rank, jax_step["start"])


def test_ranks_state_is_replicated(ranks):
    """After the step and after the CLI's three steps, the ranks hold the
    same parameters, Adam state and statistics, bit for bit (sha256 of
    every array)."""
    a, b = ranks
    assert a["step_digest"] == b["step_digest"]  # loss, gradients, stats, params, Adam
    a, b = (r["cli"] for r in ranks)
    assert a["losses"] == b["losses"] and np.all(np.isfinite(a["losses"]))
    assert a["digest"] == b["digest"]  # params, frozen, stats, Adam moments


def test_dropout_mask_is_the_global_batch_rows(ranks):
    """Rank r's mask of images [4r, 4r+4) equals those rows of the mask drawn
    over the whole batch of 8."""
    whole = common.dropout(torch.ones(NB, 8, 12, 16), 0.1, 12345).numpy()
    per = NB // WORLD
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["mask"], whole[r * per:(r + 1) * per])


def test_cli_under_torchrun_trains_and_rank0_alone_writes(ranks):
    """``cli/pretraining.py`` with ``mesh_shape={"data": 2}`` joins the group
    from torchrun's environment and trains three steps; rank 0 alone writes
    the config snapshot, the checkpoints and the step timing."""
    r0, r1 = (r["cli"] for r in ranks)
    for r in (r0, r1):
        assert r["world"] == WORLD and r["step"] == CLI_STEPS and r["count"] == CLI_STEPS
    assert sorted(r0["writes"]) == ["save", "save", "save_config_snapshot", "write"]
    assert r1["writes"] == []
    assert ranks[0]["store"] == {"steps": [2, 3], "snapshots": 1}


def test_data_axis_rules():
    """``{'data': 1}`` is the one-device path; ``{'data': 2}`` needs a process
    group of two ranks; the batch must divide over the ranks."""
    assert not dist.is_initialized()
    assert tloop.Trainer(_config(mesh_shape={"data": 1}), device="cpu").group is None
    with pytest.raises(RuntimeError, match="world size 2"):
        tloop.Trainer(_config(mesh_shape={"data": 2}), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tloop.Trainer(_config(mesh_shape={"data": 2}, batch_size=3), device="cpu")
