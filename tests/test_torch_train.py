"""The port's training step and trainer (``train/loop.py``) against the JAX
package's, on the CPU at 64x96, batch 2, float32: the same numpy-seeded
weights, batch and 15 dropout keys through JAX's ``loss_fn`` (its
``jax.grad``, optax's Adam) and the port's step.  Tolerances, each stated
where it is used: step-1 loss rtol 1e-5; gradients relative L2 <= 1e-4 per
trainable leaf (and <= 1e-10 with both packages in float64); BN statistics
rtol 1e-5; three Adam steps — losses rtol 1e-4, each trainable leaf's
change over the three steps at relative L2 <= 5e-2 of optax's change;
bf16 step-1 loss rtol 5e-3 against float32 (the bound of
``tests/test_train_oracle.py:test_bf16_training_tracks_f32``)."""

import copy
import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from bayesian_yolov3_tpu.core.blueprint import Variant as JVariant, VariantSpec as JSpec
from bayesian_yolov3_tpu.core.priors import ECP_9_PRIORS
from bayesian_yolov3_tpu.data import encode as jenc
from bayesian_yolov3_tpu.models import darknet as jdarknet
from bayesian_yolov3_tpu.models.yolov3 import YoloV3 as JYolo
from bayesian_yolov3_tpu.ops import common as jcommon
from bayesian_yolov3_tpu.ops import decode as jdec
from bayesian_yolov3_tpu.ops import loss as jloss
from bayesian_yolov3_tpu.train import loop as jloop

from bayesian_yolov3_torch import convert
from bayesian_yolov3_torch.cli import inference_standard_yolov3, yolov3_training
from bayesian_yolov3_torch.config import Config, DataConfig
from bayesian_yolov3_torch.models import yolov3 as tyolo
from bayesian_yolov3_torch.train import loop as tloop

import synth
import torch_parity as tp

IMG = (64, 96, 3)
NB, MAX_BOXES = 2, 8
LR = 1e-5  # the training CLIs' lr
MODELS = {"aleatoric": True, "bayesian": False}  # model -> aleatoric_loss
# The gradient of a LeakyReLU network jumps where a pre-activation crosses
# 0: an element that two float32 forwards put on either side of 0 takes
# slope 1 in one and 0.1 in the other.  With numpy weights of seeds 1, 2 and
# 11 such elements move the aleatoric model's head gradients apart between
# the packages (the largest leaf at a relative L2 of 1.3e-2, 2.3e-3 and
# 4.6e-3), and at seeds 2 and 11 JAX's own float32 gradients lie as far from
# its float64 ones (5.1e-3, 6.8e-3).  In float64 the two packages agree
# (``test_step1_grads_match_jax_in_float64`` holds seed 1): the float32 gap
# is the kinks' rounding, not the port.  Seed 0 puts no element on the other
# side in float32, and there the 1e-4 bound tests the port.
WEIGHT_SEED = 0


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _pairs(a, b, prefix=""):
    """(name, leaf of a, leaf of b) over a's leaves, b's found by name (a JAX
    tree comes back with its keys sorted)."""
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _pairs(v, b[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v, b[k]


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _batch(seed):
    """(uint8 images, padded boxes, labels, valid) of NB examples."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (NB, *IMG), dtype=np.uint8)
    n = rng.integers(1, MAX_BOXES, NB)
    yx = rng.uniform(0.05, 0.6, (NB, MAX_BOXES, 2))
    hw = rng.uniform(0.08, 0.4, (NB, MAX_BOXES, 2))
    bbox = np.concatenate([yx, np.minimum(yx + hw, 0.99)], axis=-1).astype(np.float32)
    label = rng.integers(0, 2, (NB, MAX_BOXES)).astype(np.int32)
    valid = np.arange(MAX_BOXES)[None, :] < n[:, None]
    return imgs, bbox, label, valid


@functools.lru_cache(maxsize=None)
def _encoded_batch(seed):
    """(float32 images in [0, 1), JAX's GT encoding as numpy) of
    ``_batch(seed)``: the 64x96 blueprint, the same for every variant."""
    jmodel = JYolo(spec=JSpec(JVariant("standard"), 2), priors=ECP_9_PRIORS, img_size=IMG)
    tables = jenc.build_prior_tables(jmodel.blueprint)
    imgs, bbox, label, valid = _batch(seed)
    x = imgs.astype(np.float32) / np.float32(255.0)
    gts = jax.vmap(lambda b, l, v: jenc.encode_boxes(b, l, v, tables))(
        jnp.asarray(bbox), jnp.asarray(label), jnp.asarray(valid))
    return x, _tree_np({str(i): g for i, g in enumerate(gts)})


def _config(model, aleatoric_loss, **kw):
    return Config(model=model, full_img_size=IMG, batch_size=NB, max_boxes_per_img=MAX_BOXES,
                  lr=LR, compute_dtype="float32", aleatoric_loss=aleatoric_loss,
                  darknet53_weights="", **kw)


class Case:
    """One model's shared inputs and JAX program: weights, a batch already
    preprocessed (scaled, GT-encoded by JAX), the 15 dropout keys, and the
    jitted ``jax.grad`` of JAX's ``loss_fn``."""

    def __init__(self, model, aleatoric_loss):
        variant = JVariant(model)
        self.spec = JSpec(variant, 2)
        self.params_np, self.stats_np = tp.numpy_weights(seed=WEIGHT_SEED, spec=self.spec)
        self.jmodel = JYolo(spec=self.spec, priors=ECP_9_PRIORS, img_size=IMG,
                            compute_dtype="float32")
        self.batches = [_encoded_batch(seed) for seed in (1, 2, 3)]
        self.kd = jax.random.PRNGKey(5)
        site = jax.random.split(self.kd, 15)
        self.keys = np.asarray([[int(jax.random.bits(k, (), jnp.uint32)) for k in site]],
                               np.uint32)
        aleatoric = aleatoric_loss and self.spec.aleatoric_head
        jm = self.jmodel

        def loss_fn(trainable, frozen, stats, imgs, gts, rng):
            params = jloop.merge_params(trainable, frozen)
            raws, new_stats = jm.forward(params, stats, imgs, training=True, rng=rng)
            dets = [jdec.split_detection(raw, jm.spec) for raw in raws]
            total, metrics = jloss.total_loss(dets, gts, params, aleatoric)
            return total, (metrics, new_stats)

        self.grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
        self.config = _config(model, aleatoric_loss)

    def jax_steps(self, n):
        """n optax Adam steps on batches 0..n-1: (losses, grads of step 1,
        new stats of step 1, final trainable params)."""
        trainable, frozen = jloop.partition_params(tp.to_jax(self.params_np), True)
        stats = tp.to_jax(self.stats_np)
        opt = optax.adam(LR)
        ostate = opt.init(trainable)
        losses = []
        for i in range(n):
            x, gts = self.batches[i]
            grads, (metrics, new_stats) = self.grad_fn(
                trainable, frozen, stats, jnp.asarray(x), [tp.to_jax(g) for g in gts.values()],
                self.kd)
            if i == 0:
                first = (_tree_np(grads), _tree_np(new_stats), _tree_np(metrics))
            losses.append(float(metrics["total"]))
            upd, ostate = opt.update(grads, ostate, trainable)
            trainable = optax.apply_updates(trainable, upd)
            stats = new_stats
        return losses, first, _tree_np(trainable)

    def port_state(self, compute_dtype="float32"):
        """(model, step function, fresh state) of the port on the CPU."""
        cfg = copy.deepcopy(self.config)
        cfg.compute_dtype = compute_dtype
        model = tloop.YoloV3.from_config(cfg)
        step, _, opt = tloop.make_train_step(model, cfg, None)
        params, stats = tp.to_torch(self.params_np, self.stats_np)
        trainable, frozen = tloop.partition_params(params, True)
        for p in tloop.leaves(trainable):
            p.requires_grad_(True)
        state = {"params": trainable, "frozen": frozen, "stats": stats,
                 "opt": opt.init(trainable), "step": 0}
        return model, step, state

    def port_batch(self, i):
        x, gts = self.batches[i]
        return torch.from_numpy(x), [{k: torch.from_numpy(np.array(v)) for k, v in g.items()}
                                     for g in gts.values()]


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    c = Case(request.param, MODELS[request.param])
    c.jax = c.jax_steps(3)
    return c


@pytest.fixture
def injected_keys(case, monkeypatch):
    monkeypatch.setattr(tloop, "dropout_keys", lambda seed, step: case.keys)


def test_step1_loss_grads_and_stats_match_jax(case, injected_keys):
    """Step 1: the loss at rtol 1e-5, every trainable leaf's gradient at
    relative L2 <= 1e-4, the heads' new BN statistics at rtol 1e-5 (atol
    1e-6) and the
    frozen backbone's returned unchanged."""
    _, (jgrads, jstats, jmetrics), _ = case.jax
    _, step, state = case.port_state()
    imgs, gts = case.port_batch(0)
    total, (metrics, new_stats) = step.loss_fn(state["params"], state["frozen"],
                                               state["stats"], imgs, gts, case.keys)
    grads = torch.autograd.grad(total, tloop.leaves(state["params"]))
    np.testing.assert_allclose(float(total.detach()), float(jmetrics["total"]), rtol=1e-5)
    # each term at rtol 1e-4: the aleatoric loc term weights the squared
    # error by exp(-log_var), which amplifies the forward's float32 rounding
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-4,
                                   err_msg=k)
    want, _ = convert.params_from_jax(jgrads, {})
    by_name = dict(zip((n for n, _, _ in _pairs(state["params"], want)), grads))
    assert len(by_name) == len(grads)
    for name, _, w in _pairs(state["params"], want):
        rel = _rel_l2(by_name[name].numpy(), w.numpy())
        assert rel <= 1e-4, f"{name}: relative L2 {rel:.2e}"
    heads = {k: v for k, v in new_stats.items() if k != "backbone"}
    for name, got, w in _pairs(heads, convert.params_from_jax({}, jstats)[1]):
        # atol 1e-6 beside rtol 1e-5: a moving mean near 0 (2e-3, say) takes
        # a batch mean whose float32 sum cancels, rounded at ~1e-7 absolute
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    assert new_stats["backbone"] is state["stats"]["backbone"]


class _Float64Names:
    """``jax.numpy`` with ``float32`` read as ``float64``.  The JAX package
    casts to float32 by that name (BN statistics, the decode, the loss); read
    through this from its modules under x64, its training step runs in
    float64 throughout."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_step1_grads_match_jax_in_float64(monkeypatch):
    """The weight seed's witness: with numpy weights of seed 1 the two
    packages' float32 step-1 gradients differ by up to 1.3e-2 (see
    ``WEIGHT_SEED``); with both in float64 every trainable leaf agrees at
    relative L2 <= 1e-10 and the loss at rtol 1e-12, so that gap is the
    rounding of float32, not the port.  Aleatoric model with
    ``aleatoric_loss``, the same float32 GT encoding on both sides.  The
    port is cast by test-time patches: its ``.float()`` casts read as
    ``.double()``, and a float64 compute dtype."""
    _float64_step1_agrees(monkeypatch, freeze=True)


def test_unfrozen_step1_grads_match_jax_in_float64(monkeypatch):
    """The same witness with the backbone unfrozen (``freeze_darknet53=
    False``, the accuracy-parity recipe): batch-statistics BN through all 52
    Darknet convs, and every leaf of the backbone trained, in float64
    against JAX's ``jax.grad`` at relative L2 <= 1e-10 (in float32 the
    LeakyReLU kinks of 52 more blocks move the backbone's gradients by ~1e-2
    between the packages)."""
    _float64_step1_agrees(monkeypatch, freeze=False)


def _float64_step1_agrees(monkeypatch, freeze):
    spec = JSpec(JVariant("aleatoric"), 2)
    params_np, stats_np = tp.numpy_weights(seed=1, spec=spec)
    jm = JYolo(spec=spec, priors=ECP_9_PRIORS, img_size=IMG, compute_dtype="float64",
               freeze_darknet53=freeze)
    x, gts = _encoded_batch(1)
    gts = list(gts.values())

    for mod in (jcommon, jdec, jloss, jdarknet):
        monkeypatch.setattr(mod, "jnp", _Float64Names())
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        trainable, frozen = jloop.partition_params(f64(tp.to_jax(params_np)), freeze)

        def loss_fn(trainable, frozen, stats, imgs, gts):
            params = jloop.merge_params(trainable, frozen)
            raws, _ = jm.forward(params, stats, imgs, training=True, rng=jax.random.PRNGKey(5))
            dets = [jdec.split_detection(raw, spec) for raw in raws]
            return jloss.total_loss(dets, gts, params, True)[0]

        jtotal, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
            trainable, frozen, f64(tp.to_jax(stats_np)), jnp.asarray(x, jnp.float64),
            [tp.to_jax(g) for g in gts])
        jtotal, jgrads = float(jtotal), _tree_np(jgrads)

    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    monkeypatch.setitem(tyolo._DTYPES, "float64", torch.float64)
    cfg = _config("aleatoric", True, freeze_darknet53=freeze)
    model = tloop.YoloV3.from_config(cfg)
    model.compute_dtype = "float64"
    step, _, _ = tloop.make_train_step(model, cfg, None)
    params, stats = tp.to_torch(params_np, stats_np)
    as64 = lambda t: {k: as64(v) for k, v in t.items()} if isinstance(t, dict) else t.double()
    trainable, frozen = tloop.partition_params(as64(params), freeze)
    for leaf in tloop.leaves(trainable):
        leaf.requires_grad_(True)
    total, _ = step.loss_fn(trainable, frozen, as64(stats), torch.from_numpy(x).double(),
                            [{k: torch.from_numpy(np.array(v)) for k, v in g.items()}
                             for g in gts], np.zeros((1, 15), np.uint32))
    grads = torch.autograd.grad(total, tloop.leaves(trainable))
    np.testing.assert_allclose(float(total.detach()), jtotal, rtol=1e-12)
    # the port's gradients in the JAX layout (HWIO kernels), float64 kept
    flat = iter(grads)
    tree_of = lambda t: {k: tree_of(v) if isinstance(v, dict) else next(flat) for k, v in t.items()}
    got, _ = convert.params_to_jax(tree_of(trainable), {})
    names = [n for n, _, _ in _pairs(jgrads, got)]
    assert len(names) == len(grads)
    assert freeze or sum(n.startswith("backbone/") for n in names) == 156  # 52 x (w, gamma, beta)
    for name, w, g in _pairs(jgrads, got):
        assert g.dtype == w.dtype == np.float64, name
        rel = _rel_l2(g, w)  # 6e-14 at most frozen, 1.3e-13 unfrozen
        assert rel <= 1e-10, f"{name}: relative L2 {rel:.2e}"


class _NumpyFloat64Names:
    """``numpy`` with ``float32`` read as ``float64``: the port's Adam takes
    its bias corrections in float32, as optax does on float32 parameters;
    read through this, in float64, as optax does on float64 ones."""

    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


RECIPE_LR = 3e-3  # the accuracy-parity recipe's (eval/parity.py:overfit_config)
RECIPE_F64_STEPS = 4


def test_unfrozen_adam_steps_match_jax_in_float64(monkeypatch):
    """The accuracy-parity recipe's training against JAX's, step after step,
    in float64: the bayesian variant with the aleatoric loss, the backbone
    unfrozen (batch-statistics BN through all 52 Darknet convs, the moving
    statistics carried from step to step), hash dropout with each step's own
    15 keys, Adam at the recipe's lr 3e-3 over every leaf — RECIPE_F64_STEPS
    steps of ``apply`` on one fixed batch, as the recipe repeats its batch.
    Every step's loss at rtol 1e-8; after the last step every parameter
    leaf and every BN statistic at relative L2 <= 1e-8 of optax's and JAX's
    (measured: 3.3e-11 at most) — float32's own rounding is 6e-8.  Both packages are cast to float64 as in
    ``test_step1_grads_match_jax_in_float64``."""
    spec = JSpec(JVariant("bayesian"), 2)
    params_np, stats_np = tp.numpy_weights(seed=1, spec=spec)
    jm = JYolo(spec=spec, priors=ECP_9_PRIORS, img_size=IMG, compute_dtype="float64",
               freeze_darknet53=False)
    x, gts = _encoded_batch(1)
    gts = list(gts.values())
    kds = [jax.random.PRNGKey(100 + i) for i in range(RECIPE_F64_STEPS)]
    port_keys = [np.asarray([[int(jax.random.bits(k, (), jnp.uint32))
                              for k in jax.random.split(kd, 15)]], np.uint32) for kd in kds]

    for mod in (jcommon, jdec, jloss, jdarknet):
        monkeypatch.setattr(mod, "jnp", _Float64Names())
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        trainable, frozen = jloop.partition_params(f64(tp.to_jax(params_np)), False)
        stats = f64(tp.to_jax(stats_np))

        def loss_fn(trainable, frozen, stats, imgs, gts, rng):
            params = jloop.merge_params(trainable, frozen)
            raws, new_stats = jm.forward(params, stats, imgs, training=True, rng=rng)
            dets = [jdec.split_detection(raw, spec) for raw in raws]
            return jloss.total_loss(dets, gts, params, True)[0], new_stats

        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        opt = optax.adam(RECIPE_LR)
        ostate = opt.init(trainable)
        jx, jgts = jnp.asarray(x, jnp.float64), [tp.to_jax(g) for g in gts]
        jlosses = []
        for kd in kds:
            (total, stats), grads = grad_fn(trainable, frozen, stats, jx, jgts, kd)
            upd, ostate = opt.update(grads, ostate, trainable)
            trainable = optax.apply_updates(trainable, upd)
            jlosses.append(float(total))
        jparams, jstats = _tree_np(trainable), _tree_np(stats)

    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    monkeypatch.setitem(tyolo._DTYPES, "float64", torch.float64)
    monkeypatch.setattr(tloop, "np", _NumpyFloat64Names())
    monkeypatch.setattr(tloop, "dropout_keys", lambda seed, step: port_keys[step])
    cfg = _config("bayesian", True, freeze_darknet53=False)
    cfg.lr = RECIPE_LR
    model = tloop.YoloV3.from_config(cfg)
    model.compute_dtype = "float64"
    step, _, opt = tloop.make_train_step(model, cfg, None)
    params, stats = tp.to_torch(params_np, stats_np)
    as64 = lambda t: {k: as64(v) for k, v in t.items()} if isinstance(t, dict) else t.double()
    trainable, frozen = tloop.partition_params(as64(params), False)
    for leaf in tloop.leaves(trainable):
        leaf.requires_grad_(True)
    state = {"params": trainable, "frozen": frozen, "stats": as64(stats),
             "opt": opt.init(trainable), "step": 0}
    imgs = torch.from_numpy(x).double()
    pgts = [{k: torch.from_numpy(np.array(v)) for k, v in g.items()} for g in gts]
    losses = []
    for _ in range(RECIPE_F64_STEPS):
        state, metrics = step.apply(state, imgs, pgts)
        losses.append(float(metrics["total"]))
    # measured: 1e-15 at step 1, 1.8e-10 at step 4 (Adam divides each
    # element's moment by its own root: a gradient near eps carries its
    # rounding into the step at full weight, and the next forward feels it)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-8)
    assert state["opt"]["count"] == RECIPE_F64_STEPS
    got_p, got_s = convert.params_to_jax(tloop.detached(state["params"]), state["stats"])
    n_backbone = 0
    for kind, want, got in (("params", jparams, got_p), ("stats", jstats, got_s)):
        names = [n for n, _, _ in _pairs(want, got)]
        assert len(names) == len(list(_pairs(got, want))), kind
        for name, w, g in _pairs(want, got):
            assert g.dtype == w.dtype == np.float64, name
            rel = _rel_l2(g, w)
            assert rel <= 1e-8, f"{kind} {name}: relative L2 {rel:.2e}"
            n_backbone += name.startswith("backbone/")
    assert n_backbone == 52 * 3 + 52 * 2  # every conv's (w, gamma, beta) and (mean, var)


def test_three_adam_steps_match_jax(case, injected_keys):
    """Three steps of ``apply`` (forward, loss, backward, Adam) on three
    batches: losses at rtol 1e-4; each trainable leaf's change over the
    three steps at relative L2 <= 5e-2 of optax's change; the frozen
    backbone and its statistics bit-unchanged.  Adam scales each element's
    step by its own gradient's size, so an element whose gradient is small
    beside its leaf's largest carries its float32 rounding into the change
    at full weight: the leaves read a median of 4.3e-3, at most 1.1e-2.
    The last step's update left out reads about 0.3; one of the wrong sign,
    applied twice or without its bias correction, more."""
    jlosses, _, jparams = case.jax
    _, step, state = case.port_state()
    backbone = {k: v.clone() for k, v in zip(
        [f"{b}/{k}" for b, blk in state["frozen"]["backbone"].items() for k in blk],
        tloop.leaves(state["frozen"]))}
    bstats = [t.clone() for t in tloop.leaves(state["stats"]["backbone"])]
    losses = []
    for i in range(3):
        state, metrics = step.apply(state, *case.port_batch(i))
        losses.append(float(metrics["total"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert state["step"] == 3 and state["opt"]["count"] == 3
    p0 = tloop.partition_params(convert.params_from_jax(case.params_np, {})[0], True)[0]
    start = {name: leaf.numpy() for name, leaf, _ in _pairs(p0, p0)}
    for name, g, w in _pairs(state["params"], convert.params_from_jax(jparams, {})[0]):
        want = w.numpy() - start[name]
        assert np.linalg.norm(want) > 0, name
        rel = _rel_l2(g.detach().numpy() - start[name], want)
        assert rel <= 5e-2, f"{name}: change at relative L2 {rel:.2e} of optax's"
    for name, before in zip(backbone, tloop.leaves(state["frozen"])):
        assert torch.equal(before, backbone[name]), name
    for before, after in zip(bstats, tloop.leaves(state["stats"]["backbone"])):
        assert torch.equal(before, after)


def test_bf16_step1_loss_tracks_float32(case, injected_keys):
    """bf16 convolutions (the default compute dtype; on the CPU the plain
    convolutions, and with ``fused_early=True`` the fused kernels' plain
    versions for the frozen backbone): step-1 loss at rtol 5e-3 of JAX's
    float32 loss."""
    jloss1 = case.jax[1][2]["total"]
    for fused in (None, True):
        model, _, state = case.port_state("bfloat16")
        cfg = copy.deepcopy(case.config)
        cfg.compute_dtype = "bfloat16"
        step, _, _ = tloop.make_train_step(model, cfg, None, fused_early=fused)
        imgs, gts = case.port_batch(0)
        with torch.no_grad():
            total, _ = step.loss_fn(state["params"], state["frozen"], state["stats"], imgs, gts,
                                    case.keys)
        np.testing.assert_allclose(float(total), float(jloss1), rtol=5e-3)


def test_adam_matches_optax(rng):
    """``Adam.update`` against optax's Adam over four steps, at float32
    rounding (gradients away from 0), and its state through
    ``convert.opt_from_jax`` / ``opt_to_jax``."""
    params_np = {"a": {"w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                       "b": rng.standard_normal(4).astype(np.float32)}}
    jparams = tp.to_jax(params_np)
    opt = optax.adam(1e-2)
    jstate = opt.init(jparams)
    tparams, _ = convert.params_from_jax(params_np, {})
    adam = tloop.Adam(1e-2)
    tstate = adam.init(tparams)
    for _ in range(4):
        g_np = {"a": {k: (rng.standard_normal(v.shape) + 2.0).astype(np.float32)
                      for k, v in params_np["a"].items()}}
        upd, jstate = opt.update(tp.to_jax(g_np), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = adam.update(tloop.leaves(convert.params_from_jax(g_np, {})[0]), tstate, tparams)
    for name, g, w in _pairs(tparams, convert.params_from_jax(_tree_np(jparams), {})[0]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
    adam_state = jstate[0]
    mapped = convert.opt_from_jax({"mu": _tree_np(adam_state.mu), "nu": _tree_np(adam_state.nu),
                                   "count": np.asarray(adam_state.count)})
    assert mapped["count"] == tstate["count"] == 4
    for name in ("mu", "nu"):
        for leaf, g, w in _pairs(tstate[name], mapped[name]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-8,
                                       err_msg=f"{name}/{leaf}")
    back = convert.opt_to_jax(mapped)
    assert back["count"].dtype == np.int32 and int(back["count"]) == 4
    np.testing.assert_array_equal(back["mu"]["a"]["w"], np.asarray(adam_state.mu["a"]["w"]))


# --------------------------------------------------------------------------
# the port alone: the split step, resume, the trainer and the CLIs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("train_data")
    return synth.write_dataset(str(path), np.random.default_rng(0), n_images=6,
                               img_hw=IMG[:2])


def _data_config(tmp_path, pattern, model="bayesian", **kw):
    defaults = dict(model=model, full_img_size=IMG, batch_size=NB,
                    max_boxes_per_img=MAX_BOXES, lr=1e-3, compute_dtype="float32",
                    train_steps=4, checkpoint_interval=2, ckp_max_to_keep=3,
                    checkpoint_path=str(tmp_path / "ckpt"), darknet53_weights="",
                    tensorboard_path=str(tmp_path / "tb"),
                    train=DataConfig(file_pattern=pattern, shuffle_buffer_size=4),
                    val=DataConfig(file_pattern=pattern, shuffle_buffer_size=4))
    defaults.update(kw)
    return Config(**defaults)


def _host_batches(pattern, cfg, n):
    from bayesian_yolov3_torch.data import pipeline

    loader = pipeline.TrainLoader(cfg, "train", seed=1)
    it = loader.batches()
    out = [next(it) for _ in range(n)]
    loader.close()
    return out


def _assert_states_equal(a, b):
    assert a["step"] == b["step"] and a["opt"]["count"] == b["opt"]["count"]
    for key in ("params", "frozen", "stats"):
        for x, y in zip(tloop.leaves(a[key]), tloop.leaves(b[key])):
            assert torch.equal(x, y), key
    for key in ("mu", "nu"):
        for x, y in zip(tloop.leaves(a["opt"][key]), tloop.leaves(b["opt"][key])):
            assert torch.equal(x, y), key


def test_split_equals_fused_and_resume_equals_uninterrupted(tmp_path, dataset):
    """Bayesian, crops of 64x96 from 96x144 frames (the rescaled crop and
    the augmentation on): ``preprocess`` + ``apply`` equals the fused
    ``train_step`` bit for bit; 2 steps, a checkpoint, a restore into a
    fresh state and 2 more steps equal 4 uninterrupted steps bit for bit,
    on the same batches."""
    pattern = synth.write_dataset(str(tmp_path / "full"), np.random.default_rng(3),
                                  n_images=4, img_hw=(96, 144))
    cfg = _data_config(tmp_path, pattern, full_img_size=(96, 144, 3), crop=True,
                       crop_img_size=IMG)
    trainer = tloop.Trainer(cfg, seed=4, device="cpu")
    batches = [trainer._place_batch(b) for b in _host_batches(pattern, cfg, 4)]
    step = trainer.train_step_fn

    fused = trainer.fresh_state()
    split = trainer.fresh_state()
    for b in batches[:2]:
        fused, mf = step(fused, b)
        imgs, gts = step.preprocess(b, split["step"])
        split, ms = step.apply(split, imgs, gts)
        assert torch.equal(mf["total"], ms["total"])
    _assert_states_equal(fused, split)

    trainer.save(split, 2)
    for b in batches[2:]:
        fused, _ = step(fused, b)
    resumed, at = trainer.restore(trainer.fresh_state(), "last")
    assert at == 2
    for b in batches[2:]:
        resumed, _ = step(resumed, b)
    _assert_states_equal(fused, resumed)


def test_unfrozen_backbone_advances_its_stats(tmp_path, dataset):
    cfg = _data_config(tmp_path, dataset, model="standard", freeze_darknet53=False)
    trainer = tloop.Trainer(cfg, device="cpu")
    state = trainer.fresh_state()
    assert state["frozen"] == {} and "backbone" in state["params"]
    w0 = state["params"]["backbone"]["conv_00"]["w"].detach().clone()
    s0 = {k: v.clone() for k, v in state["stats"]["backbone"]["conv_51"].items()}
    state, m = trainer.train_step_fn(state, trainer._place_batch(_host_batches(dataset, cfg,
                                                                                1)[0]))
    assert np.isfinite(float(m["total"]))
    assert not torch.equal(state["params"]["backbone"]["conv_00"]["w"], w0)
    for k, v in s0.items():
        assert not torch.equal(state["stats"]["backbone"]["conv_51"][k], v), k


def test_trainer_runs_logs_and_checkpoints(tmp_path, dataset):
    cfg = _data_config(tmp_path, dataset, model="aleatoric", train_steps=3,
                       checkpoint_interval=2)
    trainer = tloop.Trainer(cfg, device="cpu")
    out = trainer.run()
    assert out["step"] == 3 and out["state"]["step"] == 3
    assert trainer.store.all_steps() == [2, 3]
    assert os.path.exists(os.path.join(trainer.store.dir, "step_timing.jsonl"))
    assert [f for f in os.listdir(trainer.store.dir) if f.startswith("config_")]


def test_nan_guard_aborts_and_saves(tmp_path, dataset, monkeypatch):
    cfg = _data_config(tmp_path, dataset, model="standard", train_steps=50,
                       checkpoint_interval=100)
    trainer = tloop.Trainer(cfg, device="cpu")
    orig = trainer.fresh_state

    def poisoned():
        state = orig()
        with torch.no_grad():
            state["params"]["det1"]["w"].mul_(float("nan"))
        return state

    monkeypatch.setattr(trainer, "fresh_state", poisoned)
    out = trainer.run()
    assert out["step"] == 2  # the non-finite step 1, read while step 2 ran
    assert trainer.store.latest_step() == 2


def test_warm_start_pretrain_to_uncertainty(tmp_path, dataset):
    """A pretraining (aleatoric) checkpoint resumed by an uncertainty run
    (bayesian, aleatoric loss) of the same run id: every variable restores
    (both variants share the aleatoric head), and training continues."""
    cfg = _data_config(tmp_path, dataset, model="aleatoric", train_steps=2)
    out1 = tloop.Trainer(cfg, device="cpu").run()
    cfg2 = _data_config(tmp_path, dataset, model="bayesian", aleatoric_loss=True,
                        train_steps=3, resume_training=True, resume_checkpoint="last")
    t2 = tloop.Trainer(cfg2, seed=1, device="cpu")
    restored, step = t2.restore(t2.fresh_state(), "last")
    assert step == 2 and restored["opt"]["count"] == 2
    assert torch.equal(restored["params"]["det1"]["w"], out1["state"]["params"]["det1"]["w"])
    out2 = t2.run()
    assert out2["step"] == 3 and out2["state"]["opt"]["count"] == 3


def test_dp_training_is_refused():
    """dp training (``mesh_shape={'data': 2}``) without a process group of two
    ranks is refused (``tests/test_torch_train_dp.py`` trains over one)."""
    with pytest.raises(RuntimeError, match="world size 2"):
        tloop.Trainer(_config("standard", False, mesh_shape={"data": 2}), device="cpu")


def test_cli_trains_and_inference_loads_its_checkpoint(tmp_path, dataset):
    """``cli/yolov3_training.py`` for 4 steps on the CPU, then
    ``cli/inference_standard_yolov3.py`` restores its last checkpoint and
    writes one JSON per image."""
    common = ["--device", "cpu", "--set", "run_id=cli", "--set", "full_img_size=[64,96,3]",
              "--set", f"checkpoint_path={tmp_path / 'ckpt'}", "--set", "cpu_thread_cnt=2",
              "--set", "compute_dtype=float32"]
    out = yolov3_training.main(common + [
        "--set", "crop=false", "--set", "batch_size=2", "--set", "train_steps=4",
        "--set", "checkpoint_interval=4", "--set", "darknet53_weights=",
        "--set", "max_boxes_per_img=8", "--set", f"log_path={tmp_path / 'log'}",
        "--set", f"tensorboard_path={tmp_path / 'tb'}",
        "--set", f"train.file_pattern={dataset}", "--set", f"val.file_pattern={dataset}"])
    assert out["step"] == 4
    out_dir = inference_standard_yolov3.main(common + [
        "--set", "batch_size=2", "--set", f"data.file_pattern={dataset}",
        "--set", f"out_path={tmp_path / 'out'}"])
    files = sorted(f for f in os.listdir(out_dir) if f.endswith(".json"))
    assert len(files) == 6
    with open(os.path.join(out_dir, files[0])) as f:
        assert isinstance(json.load(f), dict)
