"""Reference TF-1.x training checkpoints into the port's parameter trees,
and back — the counterpart of the JAX package's ``models/tf1_import.py``:
the same variable names, the same rules.

The reference trains with ``tf.train.Saver``, so a user migrating from it
owns name-based TF1 checkpoints.  Their layout (from the reference's graph
builders):

* every conv sits in ``tf.variable_scope(None, default_name='conv')`` —
  ``'downsample'`` for the stride-2 backbone convs — so scopes uniquify per
  parent scope as ``conv, conv_1, conv_2, ...``; the parent scopes are
  ``darknet53`` and ``det_net_{1,2,3}``;
* inside a scope, ``<scope>/conv2d/kernel`` (no bias) and
  ``<scope>/batch_normalization/{gamma,beta,moving_mean,moving_variance}``;
* the detection convs are ``det_net_k/detection/conv2d/{kernel,bias}``;
* dropout, route and upsample scopes hold no variables, so the three
  variants share the layout.

TF kernels are HWIO (kh, kw, cin, cout); the port keeps OIHW, so a kernel is
transposed on the way in and out, every other leaf copied; shapes are
checked against the port's trees.  Optimizer slots (Adam moments, beta
powers, global step) are skipped; a name that maps to nothing raises
``KeyError``, as does a model variable the checkpoint lacks; a wrong shape
raises ``ValueError`` (another variant or image size).

A host tool: TensorFlow is imported inside the two functions, only to read
or write the checkpoint format, and the error names it where it is not
installed.  The card's machine has no TensorFlow, so ``chip_smoke.py`` does
not drive this module.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from . import darknet

# leaf maps: tf variable suffix -> (pytree, leaf key)
_CONV_LEAVES = (
    ("conv2d/kernel", "params", "w"),
    ("batch_normalization/gamma", "params", "gamma"),
    ("batch_normalization/beta", "params", "beta"),
    ("batch_normalization/moving_mean", "stats", "mean"),
    ("batch_normalization/moving_variance", "stats", "var"),
)
_DET_LEAVES = (("conv2d/kernel", "params", "w"), ("conv2d/bias", "params", "b"))


def _uniquified(default_name: str, i: int) -> str:
    """TF variable_scope(None, default_name=...) uniquification order."""
    return default_name if i == 0 else f"{default_name}_{i}"


def tf1_variable_map() -> Dict[str, Tuple[str, str, str]]:
    """Full map: tf1 variable name -> (tree, flat block name, leaf key).

    ``tree`` is ``"params"`` or ``"stats"``; the flat block name is a key of
    the port's trees (``backbone`` blocks are nested one level deeper and
    are returned as ``backbone/<conv_name>``).
    """
    mapping: Dict[str, Tuple[str, str, str]] = {}

    def add_conv(scope: str, flat: str):
        for suffix, tree, leaf in _CONV_LEAVES:
            mapping[f"{scope}/{suffix}"] = (tree, flat, leaf)

    # backbone: 'conv' and 'downsample' uniquify independently
    conv_i = ds_i = 0
    for i, (_, _, stride) in enumerate(darknet.DARKNET53_CONV_SPECS):
        if stride == 2:
            scope = _uniquified("downsample", ds_i)
            ds_i += 1
        else:
            scope = _uniquified("conv", conv_i)
            conv_i += 1
        add_conv(f"darknet53/{scope}", f"backbone/{darknet._conv_name(i)}")

    # det heads: heads 2/3 start with the 1x1 transition conv of the
    # PREVIOUS head's branch (the reference's det_net_2/conv)
    for head in (1, 2, 3):
        prefix = f"det_net_{head}"
        idx = 0
        if head in (2, 3):
            add_conv(f"{prefix}/{_uniquified('conv', idx)}", f"trans{head - 1}")
            idx += 1
        for j in range(6):
            add_conv(f"{prefix}/{_uniquified('conv', idx)}", f"head{head}_conv{j}")
            idx += 1
        for suffix, tree, leaf in _DET_LEAVES:
            mapping[f"{prefix}/detection/{suffix}"] = ("params", f"det{head}", leaf)
    return mapping


def _resolve(tree: Dict, flat: str):
    node = tree
    for part in flat.split("/"):
        node = node[part]
    return node


_SKIP_SUBSTRINGS = ("/Adam", "beta1_power", "beta2_power", "global_step",
                    "optimizer/")


def _tensorflow():
    try:
        import tensorflow as tf
    except ImportError:
        raise ImportError("reading or writing a TF1 checkpoint needs tensorflow, which is not "
                          "installed (a host tool: run it where tensorflow is)") from None
    return tf


def _copy(tree: Dict) -> Dict:
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in tree.items()}


def _tf_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    """A port leaf's array in TF's layout: kernels OIHW -> HWIO."""
    return a.transpose(2, 3, 1, 0) if leaf == "w" else a


def load_tf1_checkpoint(ckpt_path: str, params: Dict, stats: Dict) -> Tuple[Dict, Dict]:
    """A reference TF1 checkpoint into copies of ``(params, stats)``.

    ``params`` / ``stats`` are templates from ``YoloV3.init`` (``"meta"``
    tensors will do): keys and shapes are checked against the checkpoint;
    the loaded leaves are float32 tensors on the template's device (the
    CPU for a meta template).  Every model variable of the checkpoint is
    consumed and every mapped variable must exist."""
    tf = _tensorflow()
    reader = tf.train.load_checkpoint(ckpt_path)
    mapping = tf1_variable_map()
    trees = {"params": _copy(params), "stats": _copy(stats)}
    seen = set()
    for name in reader.get_variable_to_shape_map():
        if any(s in name for s in _SKIP_SUBSTRINGS):
            continue
        if name not in mapping:
            raise KeyError(f"unmapped reference variable {name!r} — not a known model "
                           "variable or optimizer slot")
        tree, flat, leaf = mapping[name]
        block = _resolve(trees[tree], flat)
        shape = tuple(block[leaf].shape)
        want = (shape[2], shape[3], shape[1], shape[0]) if leaf == "w" else shape  # as HWIO
        got = reader.get_tensor(name)
        if tuple(got.shape) != want:
            raise ValueError(f"{name!r}: checkpoint shape {tuple(got.shape)} != model shape "
                             f"{want} (wrong variant or image size?)")
        a = np.asarray(got, np.float32)
        a = a.transpose(3, 2, 0, 1) if leaf == "w" else a
        dev = block[leaf].device
        block[leaf] = torch.from_numpy(np.ascontiguousarray(a)).to(
            "cpu" if dev.type == "meta" else dev)
        seen.add(name)
    missing = sorted(set(mapping) - seen)
    if missing:
        raise KeyError(f"checkpoint is missing {len(missing)} model variables, "
                       f"e.g. {missing[:3]}")
    return trees["params"], trees["stats"]


def save_tf1_checkpoint(ckpt_prefix: str, params: Dict, stats: Dict,
                        global_step: int = 0) -> str:
    """The port's trees as a reference-compatible TF1 checkpoint: the
    variable names the reference's builders create (kernels HWIO), written
    by the eager ``tf.raw_ops.SaveV2`` at ``<ckpt_prefix>-<global_step>``
    with the ``checkpoint`` state file that ``tf.train.latest_checkpoint``
    reads.  Model variables only (no optimizer slots).  Returns the
    prefix written."""
    tf = _tensorflow()
    mapping = tf1_variable_map()
    trees = {"params": params, "stats": stats}
    names, tensors = [], []
    for tf_name in sorted(mapping):
        tree, flat, leaf = mapping[tf_name]
        arr = _resolve(trees[tree], flat)[leaf].detach().cpu().numpy().astype(np.float32)
        names.append(tf_name)
        tensors.append(tf.constant(np.ascontiguousarray(_tf_layout(leaf, arr))))
    prefix = f"{ckpt_prefix}-{global_step}"
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=[""] * len(names), tensors=tensors)
    base = os.path.basename(prefix)
    with open(os.path.join(os.path.dirname(prefix), "checkpoint"), "w") as f:
        f.write(f'model_checkpoint_path: "{base}"\n'
                f'all_model_checkpoint_paths: "{base}"\n')
    return prefix
