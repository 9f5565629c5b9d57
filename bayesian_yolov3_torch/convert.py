"""Weights between the JAX package's pytrees and this package's dicts.

The JAX package keeps flat-name pytrees (``backbone/conv_00..51``,
``head{i}_conv{j}``, ``trans{i}``, ``det{i}``) with conv kernels HWIO;
this package keeps the same names with kernels OIHW, as torch convolutions
take them.  Both directions go through numpy, so neither package is
imported here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _map_leaves(tree: Dict, fn) -> Dict:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(k, v)
            for k, v in tree.items()}


def params_from_jax(params_np: Dict, stats_np: Dict, device="cpu") -> Tuple[Dict, Dict]:
    """JAX-layout trees of numpy arrays -> (params, stats) of float32
    tensors on ``device``; every ``w`` goes HWIO -> OIHW."""

    def leaf(name, v):
        a = np.asarray(v, dtype=np.float32)
        if name == "w":
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return _map_leaves(params_np, leaf), _map_leaves(stats_np, leaf)


def params_to_jax(params: Dict, stats: Dict) -> Tuple[Dict, Dict]:
    """Inverse of ``params_from_jax``: numpy trees, every ``w`` OIHW -> HWIO."""

    def leaf(name, v):
        a = v.detach().cpu().numpy()
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if name == "w" else a

    return _map_leaves(params, leaf), _map_leaves(stats, leaf)


def opt_from_jax(opt_np: Dict, device="cpu") -> Dict:
    """optax Adam state as numpy — ``{"mu": tree, "nu": tree, "count": n}``,
    the trees shaped like the trainable partition (JAX layout) — -> this
    package's Adam state (``train.loop.Adam``): float32 tensors on
    ``device``, every ``w`` moment HWIO -> OIHW, the count an int."""
    mu, nu = params_from_jax(opt_np["mu"], opt_np["nu"], device)
    return {"mu": mu, "nu": nu, "count": int(np.asarray(opt_np["count"]))}


def opt_to_jax(opt: Dict) -> Dict:
    """Inverse of ``opt_from_jax``: numpy trees, every ``w`` OIHW -> HWIO,
    the count as an int32 scalar (optax's)."""
    mu, nu = params_to_jax(opt["mu"], opt["nu"])
    return {"mu": mu, "nu": nu, "count": np.asarray(opt["count"], np.int32)}


def qheads_from_jax(qh_np: Dict, device="cpu") -> Dict:
    """The JAX package's quantized-head pytree (numpy leaves, from
    ``ops/quant.py:quantize_heads``) -> this package's dict
    (``ops.quant.quantize_heads``): conv blocks' int8 kernels HWIO -> OIHW,
    the detection kernels (cin, ch) -> (ch, cin) (the rows of the port's
    int8 detection product), float vectors as float32 tensors on
    ``device``, scalar scales as Python floats."""

    def leaf(name, v):
        a = np.asarray(v)
        if a.ndim == 0:
            return float(a)
        if name == "wq":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return _map_leaves(qh_np, leaf)


def tree_to(tree: Dict, device) -> Dict:
    """A params / stats tree with every tensor moved to ``device``."""
    return _map_leaves(tree, lambda _name, v: v.to(device))
