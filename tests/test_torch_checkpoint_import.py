"""A checkpoint that the JAX package's trainer wrote (an orbax store) goes
through ``jax_checkpoint_to_torch.py`` into the port's store, and the port
runner's ``load_state`` then gives the trees ``convert.params_from_jax``
makes of the JAX ones, exactly.

One full-width step (a few hundred MB on disk in each format) is written
to the test's temp directory and removed at the end."""

import os
import shutil

import numpy as np
import pytest

from bayesian_yolov3_tpu.config import Config as JConfig
from bayesian_yolov3_tpu.train import loop as jax_loop
from bayesian_yolov3_tpu.train.checkpoints import CheckpointStore as JaxStore

from bayesian_yolov3_torch import convert
from bayesian_yolov3_torch.config import Config
from bayesian_yolov3_torch.infer import InferenceRunner
from bayesian_yolov3_torch.train.checkpoints import _flatten

import jax_checkpoint_to_torch as tool
import torch_parity as tp

RUN, STEP = "jaxrun", 40
KW = dict(model="bayesian", inference_mode=True, T=2, full_img_size=tp.IMG, run_id=RUN)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A JAX store holding step STEP of the numpy weights (with an optimizer
    entry beside them, as the trainer saves), converted by the tool's CLI."""
    root = tmp_path_factory.mktemp("ckpt_import")
    params_np, stats_np = tp.numpy_weights(seed=11)
    trainable, frozen = jax_loop.partition_params(params_np, True)
    JaxStore(str(root / "jax"), RUN).save(
        STEP, {"params": trainable, "frozen": frozen, "stats": stats_np,
               "opt": {"count": np.asarray(STEP, np.int32)}})
    path = tool.main(["--out", str(root / "torch"), "--set", "model=bayesian",
                      "--set", f"checkpoint_path={root / 'jax'}", "--set", f"run_id={RUN}",
                      "--set", "full_img_size=[64,96,3]"])
    yield {"root": root, "path": path, "weights": (params_np, stats_np)}
    shutil.rmtree(root, ignore_errors=True)


def test_port_runner_loads_a_converted_jax_checkpoint(stores):
    params_np, stats_np = stores["weights"]
    assert stores["path"] == os.path.join(str(stores["root"] / "torch"), RUN, str(STEP))
    runner = InferenceRunner(Config(**KW, checkpoint_path=str(stores["root"] / "torch")),
                             device="cpu")
    params, stats, step = runner.load_state()
    want_params, want_stats = convert.params_from_jax(params_np, stats_np)
    assert step == STEP
    for got, want in ((params, want_params), (stats, want_stats)):
        got, want = _flatten(got), _flatten(want)
        assert set(got) == set(want)
        for name, w in want.items():
            assert got[name].dtype == w.dtype and np.array_equal(got[name], w), name


def test_the_port_alone_cannot_read_the_jax_store(stores):
    """What the tool is for: the port's store finds no step in an orbax one."""
    runner = InferenceRunner(Config(**KW, checkpoint_path=str(stores["root"] / "jax")),
                             device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        runner.load_state()


def test_tool_refuses_to_overwrite_and_a_wrong_variant(stores):
    cfg = dict(model="bayesian", checkpoint_path=str(stores["root"] / "jax"), run_id=RUN,
               full_img_size=[64, 96, 3])
    with pytest.raises(FileExistsError, match=f"step {STEP}"):
        tool.convert_checkpoint(JConfig.from_dict(cfg), str(stores["root"] / "torch"))
    with pytest.raises(ValueError, match="wrong variant or config"):
        tool.convert_checkpoint(JConfig.from_dict(dict(cfg, cls_cnt=3)),
                                str(stores["root"] / "torch3"))
