"""Inference runner: tfrecords -> detections -> ECP JSON files.

Two single-device branches, in ``compute_dtype`` "bfloat16" (the default:
convs 0-25 of the backbone through the fused conv kernels of
``ops.cuda_conv``, the rest in bf16 on the tensor cores) and "float32":

* EPISTEMIC (bayesian variant, ``inference_mode``): T-sample channels-first
  MC forward (``models.yolov3.mc_forward_cf``), the epistemic decode kernel
  (``ops.cuda_epistemic``), rows 21+C wide.
* BATCHED standard / aleatoric (every other configuration, the bayesian
  variant with ``inference_mode=False`` included): one channels-first
  forward of the image batch (``models.yolov3.forward_cf``; the bayesian
  variant keeps its dropout unless ``standard_test_dropout``), the box
  decode kernel (``ops.cuda_decode``), rows 7+C or 14+C wide.

Both end in certified NMS over the flattened rows (``ops.nms`` with the
greedy-NMS kernel, one block per image) and the exact (pre_top_k=0) retry
of batches whose certificate fails — on the decoded rows already computed;
the JAX runner re-runs its whole jitted program, with the same result.
JSON writing overlaps the next batch on a worker thread; the final partial
batch is padded with copies of its last image.

The runner computes on ``device`` ("cuda" unless the caller passes another
one) and raises when that device is not there; it never moves to the CPU
by itself.  On CUDA tensors the pipeline goes through the hand-written
kernels; on CPU tensors (the tests) through their plain versions.

``packed_host_input``: ``run()`` feeds the loader's host-packed
space-to-depth uint8 planes (``data.pipeline.pack_planes_host``) instead of
NHWC images, in both branches; ``predict()`` keeps taking NHWC images and
refuses that configuration, as the JAX runner does.

Multi-rank axes (``mesh_shape``, ``parallel/``), one runner per rank over
an initialised process group, every rank reading the same frames and
drawing the same keys; only rank 0 writes JSON:

* ``{'mc': N}`` (epistemic, batch 1) splits the T samples over the N
  ranks: ``use_pallas=True`` takes the fused pipeline (partial moments,
  all-reduce, finalize; exact NMS, so no retry), ``use_pallas=False`` the
  all-gather fallback (the one-shot decode of the gathered samples,
  certified NMS and the exact retry).
* ``{'dp': N}`` (batched, not epistemic) splits the image batch: each rank
  runs the whole batched pipeline on its NB/N images with exact NMS, then
  the rows are all-gathered; the bayesian variant's rank r drops out with
  row r of an (N, 15) key table.  Composes with ``quantize="int8"``.
* ``{'sp': N}`` (any variant) splits the image rows into one band per rank,
  every 3x3 conv exchanging its halo rows; the raw heads are gathered and
  decoded by the single-device kernels, then certified NMS with the exact
  retry.  ``{'sp': a, 'mc': b}`` (epistemic) also splits the T samples:
  the gathered raws of the rank's T/b samples go through the fused mc
  pipeline's back half (moments, one all-reduce over the mc subgroup, one
  finalize).  Epistemic sp is batch 1; H must be a multiple of 32
  (GSPMD's uneven bands, ``parallel.spatial.band_plan``).

An axis of size 1 is the single-device path.  The refusals follow the JAX
runner's, with its exception types.

``quantize="int8"`` runs the head section in int8 on all three paths
(``models.quant``: ``mc_forward_cf_q`` on the epistemic path,
``forward_cf_q`` on the batched one, the int8 heads inside the fused mc
pipeline), behind the same decode and NMS kernels.  ``calibrate_int8``
builds the quantized heads from a few images (``run()`` calibrates on the
dataset's first ``quant_calib_images`` frames by itself); ``predict()``
refuses to run before it.  The mc all-gather fallback refuses int8, as the
JAX runner's GSPMD fallback does.

Spans and counters (``utils.profiling``, always on, kept in memory): a
``predict`` call is one request, root span ``byolo.predict``; a batch of
``run()`` is one, root ``byolo.batch`` from the loader's pull to its rows
on the host.  Inside: ``byolo.load`` (the loader's pull), ``byolo.h2d``
(the uint8 batch onto the device), ``byolo.backbone``, ``byolo.heads``
(with one ``byolo.dropout`` span per dropout site), ``byolo.decode``,
``byolo.nms`` and, on a failed certificate, ``byolo.nms_exact``, the waits
for the device ``byolo.wait.nms_scalar`` (inside ``byolo.nms``: a host
scalar's blocking copy, ``ops.nms.nms_select_batch``),
``byolo.wait.certificate`` and ``byolo.wait.fetch`` (the rows' copy to the
host), and ``byolo.write`` on the writer thread.
Counters: ``images``, ``nms_certificate_failed`` (images),
``nms_exact_retry`` (0 or 1), ``h2d_bytes``.

The operator's reading: ``run()`` ends with one log line of host ms per
image -- ``load`` (tfrecord read and PNG decode), ``h2d`` (a blocking copy
from pageable memory), ``enqueue`` (the host launching the device program:
backbone, heads, decode, NMS), ``wait`` (the host blocked on the device),
``write`` (JSON, on its own thread) -- then the copy's rate (GB/s,
``h2d_bytes`` over the ``byolo.h2d`` spans), and the batches re-run with
exact NMS with the images whose certificate failed
(``nms_exact_retry``, ``nms_certificate_failed``).  ``wait`` close to the
time per image means the device sets the pace;
``enqueue`` or ``load`` well above ``wait`` mean the host does; ``write``
near the time per image means the writer thread does (its JSON building
also holds the interpreter lock against the launches, which inflates
``enqueue``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..convert import tree_to
from ..core.blueprint import Variant
from ..core.priors import priors_as_array
from ..data import pipeline
from ..models.quant import forward_cf_q, mc_forward_cf_q
from ..models.yolov3 import YoloV3, _batch_keys, _key_table, forward_cf, mc_forward_cf
from ..ops import nms
from ..ops.cuda_decode import fused_box_decode_all_scales
from ..ops.cuda_epistemic import fused_epistemic_decode_cf_batched
from ..ops.quant import calibrate_forward_amax, calibrate_mc_amax, quantize_heads
from ..parallel import (
    make_dp_batched_pipeline,
    make_groups,
    make_mc_sharded_forward,
    make_mc_sharded_fused_pipeline,
    sharded_moments_rows,
    spatial_forward_raws,
    spatial_mc_raws,
    world_group,
)
from ..parallel.spatial import check_height
from ..train.checkpoints import CheckpointStore
from ..train.loop import merge_params, partition_params
from ..utils import profiling
from ..utils.profiling import annotate
from .ecp import bbox_to_ecp_format

log = logging.getLogger("byolo.infer")

# the spans whose host time is the device program's enqueue (a wait span
# inside one counts as wait)
ENQUEUE_SPANS = ("byolo.backbone", "byolo.heads", "byolo.decode", "byolo.nms", "byolo.nms_exact")


class InferenceRunner:
    def __init__(self, config: Config, seed: int = 0, device="cuda"):
        if config.crop:
            raise ValueError("inference runs on full images")
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceRunner computes on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU knowingly"
            )
        self.model = YoloV3.from_config(config)
        self.spec = self.model.spec
        self.epistemic = self.spec.variant == Variant.BAYESIAN and config.inference_mode
        self._qheads = None  # the int8 head section, once calibrated
        if config.quantize is not None and config.quantize != "int8":
            raise ValueError(f"unknown quantize mode {config.quantize!r}")
        # run() then feeds host-packed planes to the fused early backbone
        self.packed = bool(config.packed_host_input)
        # the dropout keys of every batch come from this CPU generator, seeded
        # alike on every rank of a group: every rank draws the same table
        self.rng = torch.Generator(device="cpu")
        self.rng.manual_seed(seed)
        self.retried = 0  # batches the last run() re-ran with exact NMS
        self.last_run = {}  # images and seconds of the last run()'s loop
        self._priors = {
            stride: torch.from_numpy(p).to(self.device)
            for stride, p in priors_as_array(self.model.priors).items()
        }
        self.group = None  # every rank of a multi-rank run, or None on a single device
        self._mc_fused = None
        self._mc_forward = None
        self._dp = None  # the dp pipeline
        self._sp = None  # the sp axis's group
        self._sp_mc = None  # the mc axis's group beside sp
        self._setup_mesh(config.mesh_shape or {})

    def _setup_mesh(self, shape):
        unknown = set(shape) - {"mc", "dp", "sp"}
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; known: mc, dp, sp")
        if shape.get("dp", 0) > 1:
            self._setup_dp(shape)
        elif shape.get("sp", 0) > 1:
            self._setup_sp(shape["sp"], shape.get("mc", 0))
        elif shape.get("mc", 0) > 1:
            self._setup_mc(shape["mc"])

    def _setup_dp(self, shape):
        cfg = self.config
        n = shape["dp"]
        if self.epistemic:
            raise ValueError("the dp axis shards the image batch; epistemic inference is "
                             "batch-1 (shard T with {'mc': N} instead)")
        if len(shape) > 1:
            raise ValueError("dp does not compose with sp/mc axes")
        if cfg.batch_size % n:
            raise ValueError(f"batch_size {cfg.batch_size} must divide over the dp axis ({n})")
        if self.packed:
            raise ValueError("packed_host_input is a single-device feed; the dp path takes "
                             "plain NHWC batches")
        self.group = make_groups({"dp": n})["dp"]
        self._dp = make_dp_batched_pipeline(
            self.model, self.group, priors_by_stride=self._priors,
            obj_idx=self.spec.obj_idx(epistemic=False), nms_max_boxes=cfg.nms_max_boxes,
            nms_iou_thresh=cfg.nms_iou_thresh, standard_test_dropout=cfg.standard_test_dropout)

    def _setup_sp(self, n, mc):
        cfg = self.config
        shape = {"sp": n}
        if mc > 1:
            # AssertionError, as the JAX runner's asserts raise (explicit, so
            # that python -O keeps the check)
            if not self.epistemic:
                raise AssertionError("mc axis requires the epistemic runner")
            if cfg.T % mc:
                raise AssertionError("T must divide evenly over the mc axis")
            shape["mc"] = mc
        if cfg.fixed_mc_masks is not None:
            raise ValueError(
                "fixed_mc_masks composes with the single-device epistemic paths and the "
                "mc-sharded FUSED pipeline (use_pallas); the sp mesh draws its keys per call")
        if cfg.quantize is not None:
            raise ValueError(
                "quantize='int8' does not compose with the sp (spatial) mesh: the quantized "
                "section runs on the gathered head inputs, which the sp axis shards")
        if self.packed:
            raise ValueError("packed_host_input is a single-device feed; the sp path takes "
                             "NHWC images")
        check_height(cfg.full_img_size[0], n)
        groups = make_groups(shape)
        self.group = world_group()
        self._sp, self._sp_mc = groups["sp"], groups.get("mc")

    def _setup_mc(self, n):
        cfg = self.config
        if not self.epistemic:
            raise ValueError("the mc axis splits the MC samples of epistemic inference "
                             "(bayesian, inference_mode)")
        if cfg.T % n:
            raise ValueError(f"T={cfg.T} must divide evenly over the mc axis ({n})")
        if self.packed:
            raise ValueError("packed_host_input is a single-device feed; the mc path "
                             "takes NHWC images")
        if cfg.quantize is not None and not cfg.use_pallas:
            raise ValueError(
                "quantize='int8' over the mc axis requires the fused pipeline "
                "(use_pallas=True); the all-gather fallback does not run the int8 "
                "heads")
        if cfg.fixed_mc_masks is not None and not cfg.use_pallas:
            raise ValueError(
                "fixed_mc_masks composes with the single-device epistemic paths and the "
                "mc-sharded FUSED pipeline (use_pallas); the all-gather fallback draws "
                "its keys per call")
        self.group = make_groups({"mc": n})["mc"]
        if cfg.use_pallas:
            self._mc_fused = make_mc_sharded_fused_pipeline(
                self.model, self.group, cfg.T, priors_by_stride=self._priors,
                obj_idx=self.spec.obj_idx(epistemic=True),
                nms_max_boxes=cfg.nms_max_boxes, nms_iou_thresh=cfg.nms_iou_thresh,
                fixed_masks=cfg.fixed_mc_masks)
        else:
            self._mc_forward = make_mc_sharded_forward(self.model, self.group, cfg.T)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else self.group.rank

    # -- checkpoint handling -------------------------------------------

    def load_state(self):
        """Restore params/stats from a checkpoint ('last' or a step) onto
        the runner's device."""
        store = CheckpointStore(
            self.config.checkpoint_path, self.config.run_id,
            max_to_keep=self.config.ckp_max_to_keep,
        )
        params, stats = self.model.init(self.rng, device="meta")  # shapes only
        trainable, frozen = partition_params(params, self.config.freeze_darknet53)
        like = {"params": trainable, "frozen": frozen, "stats": stats}
        restored, step = store.restore_partial(like, step=self.config.step)
        params = merge_params(restored["params"], restored["frozen"])
        return tree_to(params, self.device), tree_to(restored["stats"], self.device), step

    # -- device program -------------------------------------------------

    def calibrate_int8(self, params, stats, images):
        """Calibrate and build the int8 head section (``quantize="int8"``).

        ``images``: a representative uint8 NHWC batch (1-4 images: max-abs
        calibration).  Epistemic runners calibrate over the MC sample
        distribution (``calibrate_mc_amax``), batched ones over the batched
        forward (``calibrate_forward_amax``).  The dropout keys come from a
        generator of its own, seeded 0, so the runner's key stream does not
        move.  ``run()`` calls this on the dataset's first
        ``quant_calib_images`` frames; ``predict()`` users call it once."""
        cfg = self.config
        if cfg.quantize != "int8":
            raise ValueError("config.quantize is not 'int8'")
        imgs = torch.as_tensor(np.asarray(images)).to(self.device).float() / 255.0
        gen = torch.Generator(device="cpu").manual_seed(0)
        kw = dict(spec=self.spec, rng=gen, compute_dtype=self.model._dtype,
                  percentile=cfg.quant_calib_percentile)
        if self.epistemic:
            amax = calibrate_mc_amax(params, stats, imgs, T=cfg.T, **kw)
        else:
            amax = calibrate_forward_amax(params, stats, imgs,
                                          standard_test_dropout=cfg.standard_test_dropout, **kw)
        self._qheads = quantize_heads(params, stats, self.spec, amax)
        log.info("int8 head section calibrated on %d images (%d sites)", imgs.shape[0],
                 len(amax))
        return self._qheads

    def device_batch_size(self) -> int:
        """Largest image batch one pipeline call takes: the image batch
        folds onto the anchor axis of the epistemic decode, onto the batch
        axis of the batched forward (split over the ranks under dp); the
        epistemic mc and sp paths are batch 1."""
        return 1 if self.epistemic and self.group is not None else self.config.batch_size

    def draw_keys(self, gen: Optional[torch.Generator] = None) -> Optional[np.ndarray]:
        """uint32 dropout keys for one batch, drawn from ``gen`` (default:
        the runner's generator): epistemic — a (T, 15) table, the constant
        one of ``fixed_mc_masks`` if set; batched — where the bayesian
        variant's dropout is active a (1, 15) table, an (N, 15) one over a
        dp group of N (row r for rank r), else None."""
        gen = self.rng if gen is None else gen
        if self.epistemic:
            return _key_table(gen, self.config.fixed_mc_masks, self.config.T)
        return _batch_keys(self.spec, gen, self.config.standard_test_dropout,
                           n=1 if self._dp is None else self.group.size)

    @torch.no_grad()
    def _decoded_rows(self, params, stats, images, keys):
        """uint8 NHWC batch (tensor on the runner's device) + key table (see
        ``draw_keys``) -> the decoded rows of every anchor, (nb, N_total,
        width): forward, then the decode (one launch over the three scales
        on the batched path, one a scale on the epistemic path).  With
        ``packed_host_input`` ``images`` is the host-packed uint8 planes
        (nb, 16, L); the scaling then happens inside the backbone."""
        if self._dp is not None:
            raise ValueError("the dp pipeline decodes and selects on each rank; call "
                             "predict() or run()")
        packed_hw = tuple(self.config.full_img_size[:2]) if self.packed else None
        imgs = images if self.packed else images.float() / 255.0
        qh = self._qheads  # the int8 forwards take the float ones' arguments and qh
        dtype = self.model._dtype
        if not self.epistemic:
            kw = dict(spec=self.spec, rng=keys,
                      standard_test_dropout=self.config.standard_test_dropout,
                      compute_dtype=dtype)
            if self._sp is not None:
                outs = spatial_forward_raws(params, stats, imgs, group=self._sp, **kw)
            elif qh is None:
                outs = forward_cf(params, stats, imgs, packed_hw=packed_hw, **kw)
            else:
                outs = forward_cf_q(qh, params, stats, imgs, packed_hw=packed_hw, **kw)
            with annotate("byolo.decode"):
                return fused_box_decode_all_scales(outs, self._priors, spec=self.spec)
        nb = imgs.shape[0]
        if self._mc_fused is not None:
            return self._mc_fused.decode(params, stats, imgs, keys, qheads=qh)[None]
        if self._sp is not None:
            outs = spatial_mc_raws(params, stats, imgs, keys, spec=self.spec, group=self._sp,
                                   T=self.config.T, compute_dtype=dtype, mc=self._sp_mc)
            if self._sp_mc is not None:
                with annotate("byolo.decode"):
                    return sharded_moments_rows(outs, self._sp_mc, self.config.T, self._priors,
                                                self.spec.cls_cnt)[None]
        elif self._mc_forward is not None:
            outs = self._mc_forward(params, stats, imgs, keys)
        else:
            kw = dict(spec=self.spec, T=self.config.T, rng=keys,
                      compute_dtype=self.model._dtype, packed_hw=packed_hw)
            outs = (mc_forward_cf(params, stats, imgs, **kw) if qh is None
                    else mc_forward_cf_q(qh, params, stats, imgs, **kw))
        with annotate("byolo.decode"):
            return torch.cat(
                [
                    fused_epistemic_decode_cf_batched(
                        raw_cf, self._priors[stride], n_imgs=nb, h=hw[0], w=hw[1],
                        cls_cnt=self.spec.cls_cnt, layer_id=i,
                    )
                    for i, ((raw_cf, hw), stride) in enumerate(zip(outs, (32, 16, 8)))
                ],
                dim=1,
            )

    def _select(self, flat, pre_top_k):
        """Decoded rows -> (rows, valid, cert) padded NMS selections.
        ``cert`` is the per-image exactness certificate of the pre-top-k
        restriction (ops.nms); ``pre_top_k=0`` is exact by construction."""
        cfg = self.config
        rows, valid, _, cert = nms.nms_select_batch(
            flat, self.spec.obj_idx(self.epistemic), cfg.nms_max_boxes,
            cfg.nms_iou_thresh, pre_top_k=pre_top_k, with_certificate=True,
        )
        return rows, valid, cert

    def _select_certified(self, flat):
        """NMS on the top ``nms_pre_top_k`` candidates; where any image's
        certificate fails, exact NMS over all anchors of the SAME decoded
        rows (the forward is not run again: the rows do not depend on
        ``pre_top_k``).  Returns (rows, valid, retried); counts the images
        whose certificate failed and the retry on the current request."""
        with annotate("byolo.nms"):
            rows, valid, cert = self._select(flat, self.config.nms_pre_top_k)
        with annotate("byolo.wait.certificate"):
            failed = 0 if bool(cert.all()) else int((~cert).sum())
        if not failed:
            return rows, valid, False
        profiling.count("nms_certificate_failed", failed)
        profiling.count("nms_exact_retry")
        with annotate("byolo.nms_exact"):
            rows, valid, _ = self._select(flat, 0)
        return rows, valid, True

    def _launch(self, params, stats, images, keys):
        """Launch one batch's device program (asynchronous) on ``images``,
        the batch on the runner's device as ``_to_device`` puts it there;
        returns ``finish() -> (rows, valid, retried)``, which waits for it
        (the whole batch's rows under dp too).  The
        fused mc pipeline and the dp pipeline run their own exact NMS (no
        retry); every other path decodes here and takes the certified NMS
        in ``finish``."""
        fused = self._mc_fused or self._dp  # exact NMS of their own
        if fused is not None:
            rows, valid = fused(params, stats, images.float() / 255.0, keys,
                                qheads=self._qheads)
            return lambda: (rows, valid, False)
        flat = self._decoded_rows(params, stats, images, keys)
        return lambda: self._select_certified(flat)

    def _to_device(self, images):
        """A uint8 host batch on the runner's device; under dp only the
        rank's share of it (``_dp.shard``), which is all its pipeline reads."""
        with annotate("byolo.h2d"):
            images = np.asarray(images)
            if self._dp is not None:
                images = self._dp.shard(images)
            images = np.ascontiguousarray(images)
            profiling.count("h2d_bytes", images.nbytes)
            return torch.from_numpy(images).to(self.device)

    def _device_pipeline(self, params, stats, images, keys, *, pre_top_k):
        """The whole device program: uint8 batch -> (rows, valid, cert)."""
        return self._select(self._decoded_rows(params, stats, images, keys), pre_top_k)

    def exact_pipeline(self, params, stats, images, keys):
        """Exact-NMS (pre_top_k=0) instance of the device program.  Trained
        score surfaces certify essentially always; diffuse ones (random
        weights) do not and need this one."""
        return self._device_pipeline(params, stats, images, keys, pre_top_k=0)

    def predict(self, params, stats, images, keys=None):
        """uint8 NHWC image batch (numpy) -> (rows, valid) numpy detections,
        with the exact-NMS certificate retry applied.  ``keys``: a key table
        as ``draw_keys`` gives; None draws one.  One request
        (``utils.profiling``): the root span ``byolo.predict`` and its
        counters."""
        if self.packed:
            raise ValueError("predict() takes NHWC uint8 images; packed_host_input "
                             "is a run()-loop feed")
        if self.config.quantize is not None and self._qheads is None:
            raise RuntimeError(
                "config.quantize is set but the int8 head section is not calibrated: "
                "call calibrate_int8(params, stats, images) once before predict()")
        images = np.asarray(images)
        with profiling.request("byolo.predict", images=images.shape[0]):
            if keys is None:
                keys = self.draw_keys()
            rows, valid, _ = self._launch(params, stats, self._to_device(images), keys)()
            with annotate("byolo.wait.fetch"):
                return rows.cpu().numpy(), valid.cpu().numpy()

    # -- host loop -------------------------------------------------------

    def run(self, out_path: Optional[str] = None) -> str:
        cfg = self.config
        params, stats, step = self.load_state()
        out_dir = f"{out_path or cfg.out_path}_{step}"
        # refuses to overwrite an earlier run's output; over a group rank 0
        # writes, and every rank refuses together (no rank left waiting in a
        # collective that the others never reach)
        fresh = not os.path.exists(out_dir)
        if self.group is not None and not self.group.all_true(fresh, self.device):
            raise FileExistsError(f"{out_dir} exists (seen by a rank of the group)")
        if self.rank == 0:
            os.makedirs(out_dir)

        if cfg.quantize is not None and self._qheads is None:
            # calibrate on the dataset's first frames (a loader of its own; the
            # main loop reads them again and runs them quantized like the rest)
            calib = []
            for b in pipeline.TestLoader(cfg, batch_size=1).batches():
                calib.append(b["image"][0])
                if len(calib) >= cfg.quant_calib_images:
                    break
            self.calibrate_int8(params, stats, np.stack(calib))
        batch_size = self.device_batch_size()
        loader = pipeline.TestLoader(cfg, batch_size=batch_size, pack_planes=self.packed)
        batches = loader.batches()
        n = 0
        self.retried = 0
        start = time.time()
        inflight = None  # (finish() of the launched batch, bsz, names, its request)
        written: Optional[Future] = None  # the writer thread's previous batch
        records = []  # every batch's request record

        def pull():
            """The next batch (None past the last) under a fresh request,
            whose root opens at the loader's pull."""
            req = profiling.Request("byolo.batch")
            with req, annotate("byolo.load"):
                batch = next(batches, None)
            if batch is None:
                req.end(keep=False)
            return req, batch

        def drain(entry):
            nonlocal written
            finish, bsz, names, req = entry
            with req:
                rows_d, valid_d, _ = finish()
                with annotate("byolo.wait.fetch"):
                    rows = rows_d[:bsz].cpu().numpy()
                    valid = valid_d[:bsz].cpu().numpy()
            req.end()
            records.append(req.record)
            self.retried += req.record["counters"]["nms_exact_retry"]
            if self.rank != 0:
                return  # every rank holds the same rows; rank 0 writes them
            if written is not None:
                written.result()  # a failed write raises here, not silently
            written = writer.submit(self._write_batch, rows, valid, names, out_dir, req)

        with ThreadPoolExecutor(max_workers=1) as writer:
            req, batch = pull()
            while batch is not None:
                images = batch["packed"] if self.packed else batch["image"]
                bsz = images.shape[0]
                req.count("images", bsz)
                if bsz < batch_size:  # pad the final partial batch
                    pad = np.repeat(images[-1:], batch_size - bsz, axis=0)
                    images = np.concatenate([images, pad], axis=0)
                # every rank reads the same batches (a dp rank copies and
                # computes its share alone, an sp rank its band); launch this
                # batch's forward + decode BEFORE fetching the previous one's
                # results: launches are asynchronous, the certificate check
                # and the fetch in drain() synchronise
                with req:
                    finish = self._launch(params, stats, self._to_device(images),
                                          self.draw_keys())
                names = [f.decode() if isinstance(f, bytes) else f
                         for f in batch["filename"]]
                if inflight is not None:
                    drain(inflight)
                inflight = (finish, bsz, names, req)
                n += bsz
                if n % 15 == 0:
                    log.info("Processed %d images.", n)
                req, batch = pull()
            if inflight is not None:
                drain(inflight)
            if written is not None:
                written.result()
        elapsed = time.time() - start
        self.last_run = {"images": n, "seconds": elapsed}
        log.info("Processed %d images in %.1fs (%.2f img/s).", n, elapsed,
                 n / max(elapsed, 1e-9))
        log.info("Host ms per image: %s; h2d %.2f GB/s; %d batches re-run with exact NMS "
                 "(certificate failed on %d images).",
                 ", ".join(f"{k} {v:.3f}" for k, v in host_ms_per_image(records).items()),
                 h2d_gb_per_s(records), self.retried,
                 sum(r["counters"]["nms_certificate_failed"] for r in records))
        return out_dir

    def _write_batch(self, rows, valid, names, out_dir, req):
        """One batch's ECP JSON files (on the writer thread: ``req`` is the
        batch's request, which its ``byolo.write`` span joins)."""
        with annotate("byolo.write", request=req):
            for b in range(rows.shape[0]):
                dets = [
                    bbox_to_ecp_format(
                        rows[b, i],
                        self.config.full_img_size,
                        self.spec,
                        epistemic=self.epistemic,
                        implicit_background_class=self.config.implicit_background_class,
                    )
                    for i in np.flatnonzero(valid[b])
                ]
                base = os.path.splitext(os.path.basename(names[b]))[0]
                with open(os.path.join(out_dir, f"{base}.json"), "w") as f:
                    json.dump({"children": dets}, f)


def host_ms_per_image(records) -> dict:
    """Host ms per image over request records (``utils.profiling``): the
    loader's pull (``byolo.load``), the copy onto the device
    (``byolo.h2d``), the device program's enqueue (``ENQUEUE_SPANS``), the
    waits for the device (``byolo.wait.*``) and the JSON writing
    (``byolo.write``, on the writer thread)."""
    ms = dict.fromkeys(("load", "h2d", "enqueue", "wait", "write"), 0.0)
    of = {"byolo.load": "load", "byolo.h2d": "h2d", "byolo.write": "write",
          **dict.fromkeys(ENQUEUE_SPANS, "enqueue")}
    images = 0
    for rec in records:
        images += rec["counters"]["images"]
        name_of = {s["id"]: s["name"] for s in rec["spans"]}
        for span in rec["spans"]:
            dt = (span["end_ns"] - span["start_ns"]) * 1e-6
            if span["name"].startswith("byolo.wait."):
                ms["wait"] += dt
                if name_of.get(span["parent"]) in ENQUEUE_SPANS:
                    ms["enqueue"] -= dt  # a wait inside an enqueue span (the NMS scalar)
            elif span["name"] in of:
                ms[of[span["name"]]] += dt
    return {k: v / max(images, 1) for k, v in ms.items()}


def h2d_gb_per_s(records) -> float:
    """The copy onto the device over request records: ``h2d_bytes`` over
    the host time of the ``byolo.h2d`` spans (0 where there is none)."""
    ns = sum(s["end_ns"] - s["start_ns"] for r in records for s in r["spans"]
             if s["name"] == "byolo.h2d")
    return sum(r["counters"]["h2d_bytes"] for r in records) / max(ns, 1)
