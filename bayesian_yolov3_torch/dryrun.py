"""Driver entry points of the port: the flagship pipeline as a function with
its example arguments, and a dry run that composes every multi-rank axis.

``entry(device)`` gives ``(fn, example_args)``: epistemic inference of the
bayesian variant at 256x480, T=8, bf16 — ``mc_forward_cf`` (on the card the
fused conv kernels), the epistemic decode kernel per scale, NMS keeping up
to 1000 boxes — on weights from the model's init under a seeded CPU
generator, a seeded numpy image and the constant key table of
``fixed_mc_masks=1``; ``fn(*example_args)`` returns (rows (1000, 23),
valid, count).

``dryrun_multichip(n, device)`` spawns ``n`` ranks (``n`` even) that join a
gloo group through a file store and run, at 64x96 with the port's own
APIs, the seven compositions of the JAX package's ``__graft_entry__.py``:

1. dp training over ``{'data': n}``: one ``train_step``, then its
   ``preprocess`` / ``apply`` halves, finite losses equal on every rank;
2. mc raws over ``{'mc': n}`` through the all-gather fallback;
3. the fused mc pipeline (moments, one all-reduce, finalize, exact NMS);
4. the same in int8 with fixed masks, a second call bit-identical;
5. the sp forward over ``{'sp': n}``;
6. sp x mc raws over ``{'sp': n/2, 'mc': 2}``;
7. sp x mc through ``InferenceRunner.predict`` to ECP dicts, then dp
   batched inference (aleatoric, 2n images) over ``{'dp': n}``.

An sp axis needs the image height to be a multiple of 32 x its size
(``parallel.spatial.check_height``), so the sp compositions take the
smallest such height of at least 64 rows: 64 up to sp = 2, 128 at sp = 4.
On ``device="cuda"`` rank r computes on card r mod the card count (every
rank on the one card of a one-card machine); gloo carries the collectives
through the host.  Prints one ``dryrun_multichip OK ...`` line.

    python -m bayesian_yolov3_torch.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .config import Config
from .core.priors import priors_as_array
from .data import encode
from .infer.ecp import bbox_to_ecp_format
from .infer.runner import InferenceRunner
from .models.yolov3 import YoloV3, _fixed_key_table, mc_forward_cf
from .ops import launches, nms
from .ops.cuda_epistemic import fused_epistemic_decode_cf_batched
from .ops.quant import calibrate_mc_amax, quantize_heads
from .parallel import (initialize_distributed, make_groups, make_mc_sharded_forward,
                       make_mc_sharded_fused_pipeline, spatial_forward_raws, spatial_mc_raws)
from .train.loop import data_group, detached, init_state, make_train_step, merge_params

ENTRY_IMG = (256, 480, 3)
ENTRY_T = 8
DRY_IMG = (64, 96, 3)
JOIN_TIMEOUT_S = 300  # a rank still running then is killed and fails the dry run


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU "
                           "knowingly")
    return device


def entry(device="cuda"):
    """(fn, example_args): the flagship epistemic pipeline and its inputs."""
    device = _device(device)
    cfg = Config(model="bayesian", full_img_size=ENTRY_IMG, T=ENTRY_T, inference_mode=True,
                 compute_dtype="bfloat16")
    model = YoloV3.from_config(cfg)
    priors = {s: torch.from_numpy(p).to(device) for s, p in priors_as_array(model.priors).items()}
    obj_idx = model.spec.obj_idx(epistemic=True)

    @torch.no_grad()
    def pipeline(params, stats, image, keys):
        outs = mc_forward_cf(params, stats, image, spec=model.spec, T=ENTRY_T, rng=keys,
                             compute_dtype=model._dtype)
        flat = torch.cat([
            fused_epistemic_decode_cf_batched(raw_cf, priors[stride], n_imgs=1, h=hw[0],
                                              w=hw[1], cls_cnt=model.cls_cnt, layer_id=i)
            for i, ((raw_cf, hw), stride) in enumerate(zip(outs, (32, 16, 8)))], dim=1)
        return nms.nms_select(flat[0], obj_idx, max_out=1000)

    params, stats = model.init(torch.Generator().manual_seed(0), device)
    image = np.random.default_rng(0).uniform(0, 1, (1, *ENTRY_IMG)).astype(np.float32)
    return pipeline, (params, stats, torch.from_numpy(image).to(device),
                      _fixed_key_table(1, ENTRY_T))


def _sp_height(sp: int) -> int:
    """The smallest multiple of 32 x sp of at least DRY_IMG's 64 rows."""
    return 32 * sp * math.ceil(DRY_IMG[0] / (32 * sp))


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def _compositions(n: int, dev: torch.device) -> dict:
    """The seven compositions on this rank of an initialised group of n."""
    rank = dist.get_rank()
    out = {}

    # 1. dp training: the global batch of 2n images, 2 a rank
    batch = 2 * n
    cfg = Config(model="bayesian", full_img_size=DRY_IMG, batch_size=batch,
                 aleatoric_loss=True, max_boxes_per_img=4, compute_dtype="float32",
                 darknet53_weights="", mesh_shape={"data": n})
    model = YoloV3.from_config(cfg)
    group = data_group(cfg)
    train_step, _, optimizer = make_train_step(
        model, cfg, encode.build_prior_tables(model.blueprint), group=group)
    state = init_state(model, cfg, torch.Generator().manual_seed(0), optimizer, dev)
    rng = np.random.default_rng(0)
    host = {"image": rng.integers(0, 255, (batch, *DRY_IMG), dtype=np.uint8),
            "bbox": np.tile(np.asarray([[0.2, 0.2, 0.6, 0.5]], np.float32), (batch, 4, 1)),
            "label": np.ones((batch, 4), np.int32), "valid": np.ones((batch, 4), bool)}
    mine = {k: torch.from_numpy(v[2 * rank:2 * rank + 2]).to(dev) for k, v in host.items()}
    state, metrics = train_step(state, mine)
    pre = train_step.preprocess(mine, state["step"])
    state, metrics2 = train_step.apply(state, *pre)
    totals = torch.stack([metrics["total"], metrics2["total"]]).float()
    _check(_finite(totals), f"dp training: non-finite loss {totals.tolist()}")
    every = group.all_gather(totals[None])
    _check(bool((every == totals).all()), f"dp training: the ranks' losses differ {every}")
    out["dp_train_loss"], out["dp_train_loss_split"] = totals.tolist()

    # 2. mc raws through the all-gather fallback, T = 2n
    T = 2 * n
    params = detached(merge_params(state["params"], state["frozen"]))
    stats = state["stats"]
    mc_model = YoloV3.from_config(Config(model="bayesian", full_img_size=DRY_IMG, T=T,
                                         inference_mode=True, compute_dtype="float32",
                                         darknet53_weights=""))
    spec = mc_model.spec
    mc = make_groups({"mc": n})["mc"]
    img = torch.from_numpy(host["image"][:1]).to(dev).float() / 255.0
    raws = make_mc_sharded_forward(mc_model, mc, T)(params, stats, img,
                                                    torch.Generator().manual_seed(2))
    for raw_cf, _ in raws:
        _check(raw_cf.shape[1] == T and _finite(raw_cf), f"mc raws: {tuple(raw_cf.shape)}")
    out["mc_T"] = T

    # 3. the fused mc pipeline
    priors = {s: torch.from_numpy(p).to(dev) for s, p in priors_as_array(mc_model.priors).items()}
    kw = dict(priors_by_stride=priors, obj_idx=spec.obj_idx(epistemic=True), nms_max_boxes=50)
    rows, valid = make_mc_sharded_fused_pipeline(mc_model, mc, T, **kw)(
        params, stats, img, torch.Generator().manual_seed(5))
    _check(_finite(rows[valid]), "mc fused: non-finite rows")
    out["mc_fused_detections"] = int(valid.sum())

    # 4. int8 heads with fixed masks: deterministic
    amax = calibrate_mc_amax(params, stats, img, spec=spec, T=4,
                             rng=torch.Generator().manual_seed(9), compute_dtype=mc_model._dtype)
    qheads = quantize_heads(params, stats, spec, amax)
    fused_q = make_mc_sharded_fused_pipeline(mc_model, mc, T, fixed_masks=123, **kw)
    rows_q, valid_q = fused_q(params, stats, img, None, qheads)
    rows_q2, valid_q2 = fused_q(params, stats, img, None, qheads)
    _check(_finite(rows_q[valid_q]), "mc fused int8: non-finite rows")
    _check(torch.equal(rows_q, rows_q2) and torch.equal(valid_q, valid_q2),
           "mc fused int8 with fixed masks: a second call differs")
    out["mc_int8_detections"] = int(valid_q.sum())

    # 5. the sp forward over all n ranks
    h_sp = _sp_height(n)
    img_sp = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (1, h_sp, DRY_IMG[1], 3), dtype=np.uint8)).to(dev).float() / 255.0
    raws_sp = spatial_forward_raws(params, stats, img_sp, torch.Generator().manual_seed(6),
                                   spec=spec, group=make_groups({"sp": n})["sp"],
                                   compute_dtype=torch.float32)
    for (raw_cf, hw), stride in zip(raws_sp, (32, 16, 8)):
        _check(hw == (h_sp // stride, DRY_IMG[1] // stride) and _finite(raw_cf),
               f"sp forward: {tuple(raw_cf.shape)} at {hw}")
    out["sp_image_rows"] = h_sp

    # 6. sp x mc raws: each rank its band and half of the T2 samples
    T2, h_spmc = 4, _sp_height(n // 2)
    groups = make_groups({"sp": n // 2, "mc": 2})
    img_spmc_u8 = np.random.default_rng(7).integers(0, 256, (1, h_spmc, DRY_IMG[1], 3),
                                                    dtype=np.uint8)
    img_spmc = torch.from_numpy(img_spmc_u8).to(dev).float() / 255.0
    raws_spmc = spatial_mc_raws(params, stats, img_spmc, torch.Generator().manual_seed(7),
                                spec=spec, group=groups["sp"], T=T2,
                                compute_dtype=torch.float32, mc=groups["mc"])
    for raw_cf, _ in raws_spmc:
        _check(raw_cf.shape[1] == T2 // 2 and _finite(raw_cf),
               f"sp x mc raws: {tuple(raw_cf.shape)}")

    # 7. sp x mc through the runner to ECP dicts, then dp batched inference
    size_spmc = (h_spmc, DRY_IMG[1], 3)
    runner = InferenceRunner(Config(model="bayesian", full_img_size=size_spmc, T=T2,
                                    inference_mode=True, compute_dtype="float32",
                                    darknet53_weights="",
                                    mesh_shape={"sp": n // 2, "mc": 2}), device=dev)
    rows, valid = runner.predict(params, stats, img_spmc_u8)
    ecp = [bbox_to_ecp_format(rows[0, i], size_spmc, runner.spec, epistemic=True,
                              implicit_background_class=True)
           for i in np.flatnonzero(valid[0])]
    _check(all(np.isfinite(d["score"]) and np.isfinite(d["obj_mutual_info"]) for d in ecp),
           "sp x mc runner: a non-finite ECP detection")
    out["spmc_ecp_detections"] = len(ecp)
    runner_dp = InferenceRunner(Config(model="aleatoric", full_img_size=DRY_IMG,
                                       compute_dtype="float32", darknet53_weights="",
                                       batch_size=batch, nms_max_boxes=50,
                                       mesh_shape={"dp": n}), device=dev)
    p_dp, s_dp = runner_dp.model.init(torch.Generator().manual_seed(13), dev)
    imgs_dp = np.random.default_rng(5).integers(0, 256, (batch, *DRY_IMG), dtype=np.uint8)
    rows_dp, valid_dp = runner_dp.predict(p_dp, s_dp, imgs_dp)
    _check(rows_dp.shape[0] == batch and np.isfinite(rows_dp[valid_dp]).all(),
           f"dp batched: {rows_dp.shape}")
    out["dp_images"], out["dp_batched_detections"] = batch, int(valid_dp.sum())
    return out


def _rank(rank: int, n: int, store: str, device: str, res_dir: str) -> None:
    """One spawned rank: the compositions, the result (or the traceback)
    into ``res_dir/rank<r>.json``, the group destroyed at the end."""
    res = {"rank": rank}
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        else:  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        initialize_distributed("gloo", f"file://{store}", world_size=n, rank=rank, device=dev)
        t0 = time.time()
        launches.reset()
        res.update(_compositions(n, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        res["launches"] = launches.read()
        res["seconds"] = time.time() - t0
    except BaseException:
        res["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(res_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_multichip(n: int, device="cuda") -> list:
    """Run the seven compositions on ``n`` spawned ranks (see the module's
    docstring), joined under JOIN_TIMEOUT_S; print the OK line and return
    the ranks' results.  Raises if a rank fails or hangs."""
    if n < 2 or n % 2:
        raise ValueError(f"the composed sp x mc mesh needs an even rank count >= 2, not {n}")
    device = _device(device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        procs = [ctx.Process(target=_rank, args=(r, n, os.path.join(tmp, "store"),
                                                 str(device), tmp)) for r in range(n)]
        t0 = time.time()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(0.0, t0 + JOIN_TIMEOUT_S - time.time()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        ranks = []
        for r in range(n):
            path = os.path.join(tmp, f"rank{r}.json")
            if not os.path.exists(path):
                ranks.append({"rank": r, "error": "no result"})
                continue
            with open(path) as f:
                ranks.append(json.load(f))
    errors = [r["error"] for r in ranks if "error" in r]
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"dryrun_multichip: {len(hung)} rank(s) hung after "
                           f"{JOIN_TIMEOUT_S} s; errors: {errors}")
    r0 = ranks[0]
    print(f"dryrun_multichip OK on {n} ranks ({device.type}, gloo): dp train loss "
          f"{r0['dp_train_loss']:.3f}, mc inference T={r0['mc_T']}, fused sharded pipeline "
          f"{r0['mc_fused_detections']} detections, mc fused int8+fixed-masks "
          f"{r0['mc_int8_detections']} detections (deterministic), sp (H-sharded) forward OK "
          f"at {r0['sp_image_rows']} rows, sp x mc composed full pipeline (decode+NMS+ECP) "
          f"{r0['spmc_ecp_detections']} detections, dp batched inference "
          f"({r0['dp_images']} imgs over {n} ranks) {r0['dp_batched_detections']} detections",
          flush=True)
    return ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's multi-rank dry run")
    ap.add_argument("n", type=int, nargs="?", default=4, help="ranks (even)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
