"""The port's TF1 checkpoint importer and exporter (``models/tf1_import.py``)
against the JAX package's, through real checkpoint files written by
tensorflow: the same variable names into the port's trees (kernels OIHW),
bit for bit, both ways, and the same refusals."""

import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

from bayesian_yolov3_tpu.models import tf1_import as jtf1

from bayesian_yolov3_torch import convert
from bayesian_yolov3_torch.core.blueprint import Variant, VariantSpec
from bayesian_yolov3_torch.models import tf1_import
from bayesian_yolov3_torch.models.yolov3 import init_yolov3

import torch_parity as tp

ALEATORIC = VariantSpec(Variant.ALEATORIC, 2)


def _template(spec=ALEATORIC):
    return init_yolov3(torch.Generator(), spec, device="meta")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_variable_map_is_a_bijection_onto_the_port_trees():
    """Every TF1 name lands on a leaf of the port's trees and every leaf is
    covered once; the map is the JAX package's."""
    assert tf1_import.tf1_variable_map() == jtf1.tf1_variable_map()
    params, stats = _template()
    trees = {"params": params, "stats": stats}
    targets = set()
    for name, (tree, flat, leaf) in tf1_import.tf1_variable_map().items():
        assert leaf in tf1_import._resolve(trees[tree], flat), name
        assert (tree, flat, leaf) not in targets, name
        targets.add((tree, flat, leaf))
    every = {(t, *path.rsplit("/", 1)) for t in trees for path, _ in _leaves(trees[t])}
    assert targets == every


@pytest.fixture(scope="module")
def weights():
    """Seeded numpy weights of the aleatoric variant in the JAX layout."""
    return tp.numpy_weights(seed=4, spec=tp.SPEC)


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for name in w:
        assert g[name].dtype == w[name].dtype, name
        assert torch.equal(g[name], w[name]), name


def test_jax_checkpoint_loads_bit_equal_through_both(tf, weights, tmp_path):
    """A checkpoint written by the JAX package's ``save_tf1_checkpoint`` loads
    through both importers; the port's trees equal ``params_from_jax`` of
    JAX's, and the weights written."""
    params_np, stats_np = weights
    prefix = jtf1.save_tf1_checkpoint(str(tmp_path / "jax" / "model.ckpt"), params_np,
                                      stats_np, global_step=7)
    assert prefix.endswith("model.ckpt-7")
    jparams, jstats = jtf1.load_tf1_checkpoint(prefix, *tp.to_jax(tp.numpy_weights(0)))
    got = tf1_import.load_tf1_checkpoint(prefix, *_template())
    want = convert.params_from_jax(jax_np(jparams), jax_np(jstats))
    _assert_trees_equal(got[0], want[0])
    _assert_trees_equal(got[1], want[1])
    # and the weights written, exactly
    _assert_trees_equal(got[0], convert.params_from_jax(params_np, {})[0])
    os.remove(prefix + ".data-00000-of-00001")  # 250 MB


def jax_np(tree):
    return {k: jax_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def test_port_export_reads_back_through_jax(tf, weights, tmp_path):
    params, stats = convert.params_from_jax(*weights)
    prefix = tf1_import.save_tf1_checkpoint(str(tmp_path / "port" / "model.ckpt"), params,
                                            stats)
    assert tf.train.latest_checkpoint(str(tmp_path / "port")) == prefix
    jparams, jstats = jtf1.load_tf1_checkpoint(prefix, *tp.to_jax(tp.numpy_weights(0)))
    want = convert.params_to_jax(params, stats)
    for got_tree, want_tree in ((jax_np(jparams), want[0]), (jax_np(jstats), want[1])):
        g, w = dict(_leaves(got_tree)), dict(_leaves(want_tree))
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    reader = tf.train.load_checkpoint(prefix)  # the model variables, nothing else
    assert set(reader.get_variable_to_shape_map()) == set(tf1_import.tf1_variable_map())
    os.remove(prefix + ".data-00000-of-00001")  # 250 MB


class _FakeReader:
    def __init__(self, tensors):
        self.tensors = tensors

    def get_variable_to_shape_map(self):
        return {k: list(v.shape) for k, v in self.tensors.items()}

    def get_tensor(self, name):
        return self.tensors[name]


def _full(spec=VariantSpec(Variant.STANDARD, 2)):
    """Every mapped variable at its TF shape, zeros, for the fake reader."""
    params, stats = _template(spec)
    trees = {"params": params, "stats": stats}
    out = {}
    for name, (tree, flat, leaf) in tf1_import.tf1_variable_map().items():
        shape = tuple(tf1_import._resolve(trees[tree], flat)[leaf].shape)
        out[name] = np.zeros((shape[2], shape[3], shape[1], shape[0]) if leaf == "w" else shape,
                             np.float32)
    return out


def test_import_refusals(tf):
    """A variable of the wrong shape (another variant) raises ValueError
    naming the variant or image size; an unknown name and a missing
    variable raise KeyError; optimizer slots are skipped; a full checkpoint
    of the right variant loads."""
    standard = VariantSpec(Variant.STANDARD, 2)
    cases = {
        "wrong shape": ({**_full(), "det_net_1/detection/conv2d/kernel":
                         np.zeros((1, 1, 4, 4), np.float32)}, ValueError, "variant or image"),
        "unknown": ({**_full(), "det_net_1/extra/kernel": np.zeros(1, np.float32)}, KeyError,
                    "unmapped"),
        "missing": ({k: v for k, v in _full().items() if "det_net_3/conv_2/" not in k},
                    KeyError, "missing 5"),
    }
    for name, (tensors, exc, match) in cases.items():
        with mock.patch.object(tf.train, "load_checkpoint", return_value=_FakeReader(tensors)):
            with pytest.raises(exc, match=match):
                tf1_import.load_tf1_checkpoint("x", *_template(standard))
    slots = {**_full(), "det_net_1/detection/conv2d/kernel/Adam": np.zeros(3, np.float32),
             "beta1_power": np.zeros((), np.float32), "global_step": np.zeros((), np.int64)}
    with mock.patch.object(tf.train, "load_checkpoint", return_value=_FakeReader(slots)):
        params, stats = tf1_import.load_tf1_checkpoint("x", *_template(standard))
    assert params["det1"]["w"].shape == (21, 1024, 1, 1)
    assert params["det1"]["w"].device.type == "cpu"


def test_missing_tensorflow_is_named(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tf(name, *a, **kw):
        if name == "tensorflow":
            raise ImportError("No module named 'tensorflow'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tf)
    with pytest.raises(ImportError, match="needs tensorflow"):
        tf1_import.load_tf1_checkpoint("x", *_template())
