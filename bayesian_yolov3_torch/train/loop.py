"""The trainer: device-side preprocessing, Adam steps over the trainable
partition, the NaN guard, checkpoint/resume and the train/val metric
streams — the PyTorch counterpart of the JAX package's ``train/loop.py``.

* Adam(lr) (b1 0.9, b2 0.999, eps 1e-8, bias-corrected, optax's
  arithmetic) over the trainable variables only: with ``freeze_darknet53``
  the backbone runs on its moving statistics under ``torch.no_grad`` — on
  the card in bf16 through the fused conv kernels — and gets no gradient;
  the heads take batch-statistics BN and, in the bayesian variant, hash
  dropout.
* abort on a NaN/Inf total loss; train losses logged every 25 steps, a val
  batch (random crop, no augmentation) evaluated every 100 steps on the
  same weights; a checkpoint every ``checkpoint_interval`` steps, at the
  end, and best-effort on an error or interrupt; resume from 'last' or a
  given step; a fresh start loads ``darknet53_weights`` after the init.
* The step is split: ``preprocess(batch, step)`` (scale to [0, 1), random
  crop — a third of the time rescaled —, augmentation on the train split,
  GT encoding) and ``apply(state, imgs, gts)`` (forward, loss, backward,
  Adam).  Every draw of step i — the preprocessing's and the 15 dropout
  keys — depends only on (seed, i), so a resumed run draws at step i what
  an uninterrupted run draws, and the host enqueues batch i+1's
  preprocessing right after step i.

One card: ``mesh_shape={'data': N}`` with N > 1 (data-parallel training,
the BN batch statistics synchronised over the ranks) is the next slice.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..config import Config
from ..data import augment as aug
from ..data import encode, pipeline
from ..models.yolov3 import N_DROP_SITES, YoloV3
from ..ops import decode
from ..ops import loss as loss_ops
from ..utils.profiling import StepTimer
from .checkpoints import CheckpointStore

log = logging.getLogger("byolo.train")

METRIC_KEYS = ("loc", "obj", "cls", "detection", "l2_weight_reg", "total")
_PREPROCESS, _DROPOUT = 0, 1  # the two random streams of a step


def partition_params(params: Dict, freeze_backbone: bool) -> Tuple[Dict, Dict]:
    if freeze_backbone:
        trainable = {k: v for k, v in params.items() if k != "backbone"}
        frozen = {"backbone": params["backbone"]}
    else:
        trainable, frozen = dict(params), {}
    return trainable, frozen


def merge_params(trainable: Dict, frozen: Dict) -> Dict:
    return {**frozen, **trainable}


def leaves(tree: Dict) -> List[torch.Tensor]:
    """The tensors of a tree, in its (insertion) order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def _map(tree: Dict, fn) -> Dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _seed_of(seed: int, step: int, stream: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed), int(step), stream])


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s preprocessing draws."""
    state = _seed_of(seed, step, _PREPROCESS).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) >> 1)


def dropout_keys(seed: int, step: int) -> np.ndarray:
    """Step ``step``'s (1, 15) uint32 dropout keys: one per site for the
    whole batch."""
    gen = np.random.Generator(np.random.Philox(_seed_of(seed, step, _DROPOUT)))
    return gen.integers(0, 2**32, size=(1, N_DROP_SITES), dtype=np.uint32)


class Adam:
    """``optax.adam(lr)`` over a tree of tensors: b1 0.9, b2 0.999, eps 1e-8,
    bias-corrected, in optax's order of operations::

        mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  count += 1
        p += -lr * (mu / (1-b1^count)) / (sqrt(nu / (1-b2^count)) + eps)

    The state is ``{"mu": tree, "nu": tree, "count": int}`` (optax's
    ``ScaleByAdamState``; ``convert.opt_from_jax`` maps one to the other).
    ``update`` works in place on the parameters and the state; the count
    and the bias corrections stay on the host."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Dict) -> Dict:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
        return {"mu": _map(params, zeros), "nu": _map(params, zeros), "count": 0}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], opt: Dict, params: Dict) -> Dict:
        """Apply one step for ``grads`` (in ``leaves(params)`` order)."""
        ps, mu, nu = leaves(params), leaves(opt["mu"]), leaves(opt["nu"])
        grads = list(grads)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                   1.0 - self.b2))
        count = opt["count"] + 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** count)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(ps, upd)
        return {**opt, "count": count}


def make_preprocess(config: Config, tables: encode.PriorTables, split: str, seed: int):
    """Device-side per-batch preprocessing: [0,1) scale -> crop -> augment
    (train only) -> GT encode.  ``preprocess(batch, step)`` takes a batch of
    tensors on the device (``image`` uint8 NHWC, ``bbox``, ``label``,
    ``valid``) and returns (imgs, [gt1, gt2, gt3]); its draws come from
    ``step_generator(seed, step)``."""
    cropper = (aug.ImageCropper(tuple(config.full_img_size), tuple(config.crop_img_size))
               if config.crop else None)
    augment_on = split == "train"
    columns = {}  # the prior tables on the device, copied once

    def preprocess(batch, step: int):
        images, bboxes, labels, valids = (batch[k] for k in ("image", "bbox", "label", "valid"))
        n = images.shape[0]
        draws = aug.draw_batch(step_generator(seed, step), n, cropper, augment_on)
        imgs, boxes, labs, vals = [], [], [], []
        for i, d in enumerate(draws):
            img = images[i].float() / 255.0
            bbox, label, valid = bboxes[i], labels[i], valids[i]
            if cropper is not None:  # train and val both take the random crop
                img, bbox, valid = cropper.random_crop_and_sometimes_rescale(
                    img, bbox, valid, d["crop"])
            if augment_on:
                img, bbox, label = aug.augment(img, bbox, label, d["augment"])
            imgs.append(img)
            boxes.append(bbox)
            labs.append(label)
            vals.append(valid)
        dev = images.device
        if dev not in columns:
            columns[dev] = tables.to(dev)
        gts = encode.encode_boxes(torch.stack(boxes), torch.stack(labs), torch.stack(vals),
                                  tables, config.ign_thresh, columns=columns[dev])
        return torch.stack(imgs), gts

    return preprocess


def make_train_step(model: YoloV3, config: Config, tables: encode.PriorTables,
                    seed: int = 0, fused_early=None) -> Tuple[Callable, Callable, Adam]:
    """Build (train_step, eval_step, optimizer).

    ``train_step(state, batch)`` = ``apply(state, *preprocess(batch,
    state["step"]))``, also reachable as ``train_step.preprocess(batch,
    step)`` and ``train_step.apply(state, imgs, gts)``; it advances
    ``state`` in place (parameters, Adam state, statistics, step) and
    returns ``(state, metrics)``, the metrics 0-d tensors on the device.
    ``train_step.loss_fn`` gives (total, (metrics, new_stats)) of a batch.
    ``eval_step(state, batch)`` returns the val metrics: the random crop, no
    augmentation, training-mode forward, no update.  ``fused_early``: as
    ``models.darknet.darknet53`` takes it (None: the fused conv kernels for a
    frozen bf16 backbone on the card).
    """
    optimizer = Adam(config.lr)
    preprocess_train = make_preprocess(config, tables, "train", seed)
    preprocess_val = make_preprocess(config, tables, "val", seed)
    aleatoric = bool(config.aleatoric_loss) and model.spec.aleatoric_head

    def loss_fn(trainable, frozen, stats, imgs, gts, keys):
        params = merge_params(trainable, frozen)
        raws, new_stats = model.forward(params, stats, imgs, training=True, rng=keys,
                                        fused_early=fused_early)
        dets = [decode.split_detection(raw, model.spec) for raw in raws]
        total, metrics = loss_ops.total_loss(dets, gts, params, aleatoric)
        return total, (metrics, new_stats)

    def apply_step(state, imgs, gts):
        keys = dropout_keys(seed, state["step"])
        total, (metrics, new_stats) = loss_fn(state["params"], state["frozen"], state["stats"],
                                              imgs, gts, keys)
        grads = torch.autograd.grad(total, leaves(state["params"]))
        state["opt"] = optimizer.update(grads, state["opt"], state["params"])
        state["stats"] = new_stats
        state["step"] += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        return apply_step(state, *preprocess_train(batch, state["step"]))

    @torch.no_grad()
    def eval_step(state, batch):
        imgs, gts = preprocess_val(batch, state["step"])
        _, (metrics, _) = loss_fn(state["params"], state["frozen"], state["stats"], imgs, gts,
                                  dropout_keys(seed, state["step"]))
        return metrics

    train_step.preprocess = preprocess_train
    train_step.apply = apply_step
    train_step.loss_fn = loss_fn
    return train_step, eval_step, optimizer


def init_state(model: YoloV3, config: Config, gen: torch.Generator, optimizer: Adam,
               device) -> Dict[str, Any]:
    """The fresh training state on ``device``: the model's init from ``gen``,
    then ``darknet53_weights`` where that file exists; the trainable
    partition's tensors require grad."""
    params, stats = model.init(gen, device)
    if config.darknet53_weights and os.path.exists(config.darknet53_weights):
        params, stats = model.load_darknet53_weights(config.darknet53_weights, params, stats)
        log.info("loaded darknet53 weights from %s", config.darknet53_weights)
    trainable, frozen = partition_params(params, config.freeze_darknet53)
    for p in leaves(trainable):
        p.requires_grad_(True)
    return {"params": trainable, "frozen": frozen, "stats": stats,
            "opt": optimizer.init(trainable), "step": 0}


class _HostMetrics:
    """A step's metrics copied to pinned host memory without blocking, read
    one step later: ``values()`` waits on this copy's event only, not on the
    step enqueued since."""

    def __init__(self, metrics: Dict[str, torch.Tensor]):
        vec = torch.stack([metrics[k].float() for k in METRIC_KEYS])
        if vec.is_cuda:
            self.host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            self.host.copy_(vec, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = vec, None

    def values(self) -> Dict[str, float]:
        if self.event is not None:
            self.event.synchronize()
        return dict(zip(METRIC_KEYS, self.host.tolist()))


class Trainer:
    """End-to-end training on one device (``cuda`` unless the caller
    passes another)."""

    def __init__(self, config: Config, seed: int = 0, device="cuda"):
        if config.mesh_shape.get("data", 1) > 1:
            raise NotImplementedError(
                f"mesh_shape={config.mesh_shape}: dp training (a 'data' axis, the BN batch "
                "statistics synchronised over the ranks) is not ported yet; the port trains "
                "on one device")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer computes on a CUDA device and none is available; "
                               "pass device='cpu' to run on the CPU knowingly")
        self.config = config
        self.seed = seed
        self.model = YoloV3.from_config(config)
        self.tables = encode.build_prior_tables(self.model.blueprint)
        self.train_step_fn, self.eval_step_fn, self.optimizer = make_train_step(
            self.model, config, self.tables, seed)
        self.store = CheckpointStore(config.checkpoint_path, config.run_id,
                                     config.ckp_max_to_keep)
        self.metrics_path = os.path.join(self.store.dir, "metrics.jsonl")
        self._tb_writers = None

    # -- state ----------------------------------------------------------

    def fresh_state(self) -> Dict[str, Any]:
        return init_state(self.model, self.config, torch.Generator().manual_seed(self.seed),
                          self.optimizer, self.device)

    def restore(self, state: Dict[str, Any], step: Any = "last"):
        """``state`` replaced by checkpoint ``step`` ('last' or a number) of
        this run's store, on the trainer's device.  Returns (state, step)."""
        restored, step = self.store.restore(state, step=step)
        restored = _map(restored, lambda v: v.to(self.device) if torch.is_tensor(v) else v)
        for p in leaves(restored["params"]):
            p.requires_grad_(True)
        return restored, step

    def save(self, state: Dict[str, Any], step: int):
        self.store.save(step, state)
        log.info("checkpoint saved at step %d", step)

    def _place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Start the host -> device copy of a batch (pinned, asynchronous on
        the card), one step ahead of the step that consumes it."""
        out = {}
        for k in ("image", "bbox", "label", "valid"):
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # -- loop -----------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        cfg = self.config
        self.store.save_config_snapshot(cfg)
        state = self.fresh_state()
        step = 0
        if cfg.resume_training:
            state, step = self.restore(state, cfg.resume_checkpoint)
            log.info("resumed from step %d", step)

        train_loader = pipeline.TrainLoader(cfg, "train", seed=1)
        val_loader = pipeline.TrainLoader(cfg, "val", seed=2)
        train_it, val_it = train_loader.batches(), val_loader.batches()
        mfile = open(self.metrics_path, "a")
        self._tb_writers = self._make_tb_writers()
        pre, apply = self.train_step_fn.preprocess, self.train_step_fn.apply
        timer = StepTimer(window=100)
        # The metrics are read one step behind the dispatch: the NaN guard
        # checks step i-1 while step i runs, and aborts one step later.
        inflight: "collections.deque" = collections.deque()
        losses: List[float] = []  # every step's total loss, as read
        t0 = time.time()

        def drain_one() -> bool:
            """Read the oldest in-flight metrics; True => non-finite loss."""
            nonlocal t0
            s, m = inflight.popleft()
            m = m.values()
            losses.append(m["total"])
            if not np.isfinite(m["total"]):
                log.error("step %d: non-finite total loss %r — aborting "
                          "(detected with one step in flight)", s, m["total"])
                return True
            if s % 25 == 0:
                self._log_metrics(mfile, "train", s, m, t0)
                t0 = time.time()
            return False

        try:
            # batch i+1 is placed and preprocessed right after step i is
            # enqueued (the loader repeats forever, so the pull past
            # train_steps is harmless)
            pending = pre(self._place_batch(next(train_it)), step)
            while step < cfg.train_steps:
                step += 1
                timer.tick()
                state, metrics = apply(state, *pending)
                pending = pre(self._place_batch(next(train_it)), step)
                inflight.append((step, _HostMetrics(metrics)))
                if len(inflight) >= 2 and drain_one():
                    break
                if step % 100 == 0:
                    vm = self.eval_step_fn(state, self._place_batch(next(val_it)))
                    self._log_metrics(mfile, "val", step, {k: float(v) for k, v in vm.items()},
                                      None)
                if step % cfg.checkpoint_interval == 0:
                    self.save(state, step)
                    timer.write(os.path.join(self.store.dir, "step_timing.jsonl"))
            while inflight:
                if drain_one():
                    break
        except KeyboardInterrupt:
            log.warning("interrupted at step %d — saving checkpoint", step)
            self.save(state, step)
            raise
        except Exception:
            log.exception("training error at step %d — best-effort save", step)
            self.save(state, step)
            raise
        finally:
            mfile.close()
            train_loader.close()
            val_loader.close()
            for w in (self._tb_writers or {}).values():
                w.close()
        self.save(state, step)
        return {"state": state, "step": step, "losses": losses}

    def _make_tb_writers(self):
        """TensorBoard train/val writers through tensorboardX where it is
        installed; None otherwise."""
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        base = os.path.join(self.config.tensorboard_path, self.config.run_id)
        return {"train": SummaryWriter(os.path.join(base, "train")),
                "val": SummaryWriter(os.path.join(base, "val"))}

    def _log_metrics(self, mfile, split: str, step: int, m: Dict[str, float], t0):
        line = {"split": split, "step": step, **m}
        if t0 is not None:
            line["sec_per_step"] = (time.time() - t0) / 25.0
        mfile.write(json.dumps(line) + "\n")
        mfile.flush()
        if self._tb_writers:
            w = self._tb_writers[split]
            for k, v in m.items():
                w.add_scalar(f"loss/{k}", v, step)
            if "sec_per_step" in line:
                w.add_scalar("perf/sec_per_step", line["sec_per_step"], step)
        log.info("%5d %s >>> total: %8.2f det: %8.2f loc: %8.2f obj: %8.2f cls: %8.2f "
                 "reg: %8.5f", step, split, m["total"], m["detection"], m["loc"], m["obj"],
                 m["cls"], m["l2_weight_reg"])
