"""Helpers shared by the tests/test_torch_*.py parity tests: seeded numpy
weights in the JAX package's pytree layout, handed to both packages."""

import numpy as np
import torch

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
    params, stats = init_yolov3(jax.random.PRNGKey(0), spec)
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
        return {k: walk(v, k) if isinstance(v, dict) else leaf(block, k, v.shape)
                for k, v in tree.items()}

    return walk(params), walk(stats)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(params_np, stats_np):
    return convert.params_from_jax(params_np, stats_np)


def image_u8(seed=1, nb=1, hw=IMG[:2]):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (nb, *hw, 3), dtype=np.uint8)
