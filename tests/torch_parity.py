"""Helpers shared by the tests/test_torch_*.py parity tests: seeded numpy
weights in the JAX package's pytree layout, handed to both packages, and a
job of spawned ranks for the multi-rank tests."""

import functools
import glob
import os
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from bayesian_yolov3_tpu.core.blueprint import Variant, VariantSpec
from bayesian_yolov3_tpu.models.yolov3 import init_yolov3

from bayesian_yolov3_torch import convert

# The tier-1 run puts six pytest workers on the machine's cores, and every
# worker imports this module; torch's default of one intra-op thread per core
# then oversubscribes the cores, and its spinning threads slow the port's CPU
# tests several-fold.  Two threads per worker.
torch.set_num_threads(min(2, torch.get_num_threads()))

SPEC = VariantSpec(Variant.BAYESIAN, 2)
IMG = (64, 96, 3)


def numpy_weights(seed=0, spec=SPEC):
    """(params_np, stats_np): the bayesian model's trees with every leaf
    drawn from a seeded numpy generator — non-trivial BN statistics and
    biases, so a swapped gamma/beta or mean/var cannot cancel."""
    rng = np.random.default_rng(seed)
    params, stats = _tree_shapes(spec)
    # Activations must stay O(1) through 75 convs for an absolute tolerance
    # to mean something: variance-preserving kernels everywhere except on
    # the residual branches of the backbone, which are damped (a branch
    # gain near 1 would double the variance at each of the 23 blocks).
    straight = {"conv_00", "conv_01", "conv_04", "conv_09", "conv_26", "conv_43"}

    def leaf(block, name, shape):
        if name == "w":
            fan_in = shape[0] * shape[1] * shape[2]
            damped = block.startswith("conv_") and block not in straight
            gain = 0.6 if damped else 2.0
            return rng.standard_normal(shape).astype(np.float32) * np.float32(
                np.sqrt(gain / fan_in))
        if name in ("gamma", "var"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    def walk(tree, block=""):
        return {k: walk(v, k) if isinstance(v, dict) else leaf(block, k, v)
                for k, v in tree.items()}

    return walk(params), walk(stats)


@functools.lru_cache(maxsize=None)
def _tree_shapes(spec):
    """The shapes of the JAX package's (params, stats) trees, in their own
    key order (the order the leaves are drawn in), traced without computing
    the initial values (``jax.eval_shape``; a pytree it returns would come
    back with its keys sorted)."""
    shapes = {}

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}

    def init():
        params, stats = init_yolov3(jax.random.PRNGKey(0), spec)
        shapes["trees"] = walk(params), walk(stats)
        return 0

    jax.eval_shape(init)
    return shapes["trees"]


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(params_np, stats_np):
    return convert.params_from_jax(params_np, stats_np)


def image_u8(seed=1, nb=1, hw=IMG[:2]):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (nb, *hw, 3), dtype=np.uint8)


JOIN_TIMEOUT_S = 180  # a rank still running after this fails its spawned job


def _rank_entry(target, rank, out, args):
    # the test process's thread count (above): oneDNN's float32 sums then
    # run in the same order in a rank as in the test process
    torch.set_num_threads(min(2, torch.get_num_threads()))
    try:
        target(rank, *args)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target, world, out, *args, timeout_s=JOIN_TIMEOUT_S):
    """Run ``target(rank, *args)`` in ``world`` spawned processes and wait for them under one deadline.  A rank's traceback
    lands in ``out/rank<r>.err`` and in the failure message; a rank still
    running at the deadline is killed and fails the job, so a collective
    that never completes cannot hang the test run."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(target, r, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = "\n".join(open(f).read() for f in sorted(glob.glob(os.path.join(out, "*.err"))))
    assert not hung, f"{len(hung)} rank(s) still running after {timeout_s} s\n{errs}"
    assert [p.exitcode for p in procs] == [0] * world, errs


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_forward_cf(params_np, stats_np, imgs, spec, site_keys=None):
    """The JAX package's batched forward in channels-first form, on the CPU:
    its backbone (unfused, as off the TPU), its heads — with dropout under
    ``fixed_site_keys=site_keys`` (15,) where given, the masks of the port's
    (1, 15) table — and its channels-first detection convs.  Returns
    [(raw_cf (ch, NB, h*w) numpy, (h, w)), ...]."""
    k = None if site_keys is None else jnp.asarray(site_keys)
    raws = _jax_forward_cf_fn(spec)(to_jax(params_np), to_jax(stats_np), jnp.asarray(imgs), k)
    h, w = imgs.shape[1:3]
    return [(np.asarray(r), (h // s, w // s)) for r, s in zip(raws, (32, 16, 8))]


@functools.lru_cache(maxsize=None)
def _jax_forward_cf_fn(spec):
    from bayesian_yolov3_tpu.models import darknet as jdark
    from bayesian_yolov3_tpu.models import yolov3 as jyolo
    from bayesian_yolov3_tpu.ops import common as jcommon

    def fwd(p, s, x, k):
        out32, skip16, skip8, _ = jdark.darknet53(p["backbone"], s["backbone"], x,
                                                  fused_early=False)
        feats, _ = jyolo._heads(p, s, out32, skip16, skip8, spec=spec, training=False,
                                dropout_active=k is not None, fixed_site_keys=k,
                                return_features=True)
        return [jcommon.detection_conv_cf(p[f"det{i}"], f) for i, f in enumerate(feats, 1)]

    return jax.jit(fwd)
