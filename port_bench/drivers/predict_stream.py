"""Entry ``predict_stream``: closed-loop ``InferenceRunner.predict`` calls,
one client.  Each call takes the next ``batch`` frames of the seeded pool
(cycled) and, for the epistemic configuration, a fresh (T, 15) dropout key
table drawn by the benchmark from the seed; it returns when the call's rows
are on the host.

Set-up builds the runner, the weights and the pool, and warms up the
cell's own shapes: the certified call and the exact-NMS retry.  After the
window the checked calls (a seeded sample) are recomputed by the reference
and judged (``reference/judge.py``)."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from bench_lib import frames, seeds, trace, weights
from reference import arch, judge
from reference import yolov3 as ref_model

from bayesian_yolov3_torch.config import Config
from bayesian_yolov3_torch.core.priors import Prior
from bayesian_yolov3_torch.infer.runner import InferenceRunner
from bayesian_yolov3_torch.ops import launches

KIND = "infer"
N_SITES = 15  # dropout sites: convs 0..4 of the three heads


def program_config(cfg: Dict, batch: int, control: bool) -> Config:
    """The program's configuration of ``cfg``; ``control``: its int8 head
    section (the precision below bf16) in place of the bf16 one."""
    priors = {int(s): [Prior(h=p[0], w=p[1]) for p in ps] for s, ps in cfg["priors"].items()}
    return Config(
        model=cfg["variant"], inference_mode=bool(cfg.get("epistemic")), T=cfg.get("T", 1),
        batch_size=batch, full_img_size=tuple(cfg["full_img_size"]), cls_cnt=cfg["cls_cnt"],
        priors=priors, nms_max_boxes=cfg["nms_max_boxes"],
        nms_pre_top_k=cfg["nms_pre_top_k"], nms_iou_thresh=cfg["nms_iou_thresh"],
        compute_dtype=cfg["compute_dtype"], quantize="int8" if control else None)


class Session:
    def __init__(self, ctx: Dict):
        self.cfg, traffic, self.check_spec = ctx["config"], ctx["traffic"], ctx["check"]
        self.dev = torch.device(ctx["device"])
        self.seed = ctx["seed"]
        self.nb = int(traffic["batch"])
        self.epistemic = bool(self.cfg.get("epistemic"))
        self.T = int(self.cfg.get("T", 1))
        hw = self.image_hw = tuple(self.cfg["full_img_size"][:2])
        t0 = time.perf_counter()
        self.runner = InferenceRunner(program_config(self.cfg, self.nb, ctx["control"]),
                                      device=self.dev)
        self.params, self.stats = weights.make(self.cfg, self.seed, self.dev)
        self.pool = frames.pool(self.seed, int(traffic["pool"]), hw, self.dev)
        t1 = time.perf_counter()
        if len(self.pool) % self.nb:
            raise ValueError(f"pool of {len(self.pool)} frames is not whole batches of {self.nb}")
        self.keys_rng = seeds.rng(self.seed, "keys")
        self.sample_rng = seeds.rng(self.seed, "sample")
        self.kept, self.calls = [], []
        warm = seeds.rng(self.seed, "warmup")
        if ctx["control"]:
            self.runner.calibrate_int8(self.params, self.stats, self.pool[:2])
        for _ in range(int(traffic.get("warmup_calls", 2))):
            self.runner.predict(self.params, self.stats, self.pool[:self.nb], self._keys(warm))
        # the exact-NMS retry, which a call whose certificate fails takes
        x = torch.from_numpy(self.pool[:self.nb]).to(self.dev)
        self.runner.exact_pipeline(self.params, self.stats, x, self._keys(warm))
        self.timing_keys = self._keys(warm)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        # seconds of set-up by part: runner, weights and frames; the warm-up,
        # which loads (in a fresh checkout: builds) the kernels
        self.setup_parts = {"inputs_s": t1 - t0, "warmup_s": time.perf_counter() - t1}

    def _keys(self, rng):
        if not self.epistemic:
            return None
        return rng.integers(0, 2**32, size=(self.T, N_SITES), dtype=np.uint32)

    def call(self, i: int) -> int:
        """Request ``i``: its frames, its keys, its rows on the host."""
        j = (i * self.nb) % len(self.pool)
        keys = self._keys(self.keys_rng)
        nms0 = launches.read()["greedy_nms"]
        t0 = time.perf_counter()
        rows, valid = self.runner.predict(self.params, self.stats, self.pool[j:j + self.nb], keys)
        ms = (time.perf_counter() - t0) * 1e3
        self.calls.append({"ms": ms, "nms_runs": launches.read()["greedy_nms"] - nms0,
                           "picks": valid.sum(axis=1).tolist()})
        # a seeded reservoir sample of the calls, judged after the window
        k = int(self.check_spec["calls"])
        entry = (i, j, keys, rows, valid)
        if len(self.kept) < k:
            self.kept.append(entry)
        else:
            r = int(self.sample_rng.integers(0, i + 1))
            if r < k:
                self.kept[r] = entry
        return self.nb

    def counters(self) -> Dict[str, int]:
        """The program's launch counters of its hand-written kernels."""
        return launches.read()

    def finish(self) -> None:
        """Every call returns with its rows on the host: nothing in flight."""

    def layers(self) -> Dict[str, float]:
        """Device ms per image of the backbone, the heads and the 15 dropout
        sites alone, from the profiler's trace of each at the cell's batch
        and dtype."""
        from bayesian_yolov3_torch.models import darknet, yolov3
        from bayesian_yolov3_torch.ops import common

        r, p, s = self.runner, self.params, self.stats
        dtype = r.model._dtype
        x = torch.from_numpy(self.pool[:self.nb]).to(self.dev).float() / 255.0
        out = {}
        with torch.no_grad():
            bb = trace.device_ms(lambda: darknet.darknet53(
                p["backbone"], s["backbone"], x, compute_dtype=dtype), 5)
            if self.epistemic:
                fw = trace.device_ms(lambda: yolov3.mc_forward_cf(
                    p, s, x, spec=r.spec, T=self.T, rng=self.timing_keys, compute_dtype=dtype), 2)
                sites = [torch.ones((self.T * self.nb, h, w, c), device=self.dev, dtype=dtype)
                         for (h, w), head in zip(self._hws(), (1, 2, 3))
                         for _, c in arch.HEAD_PLANS[head][:arch.BRANCH_IDX + 1]]
                keys = list(range(self.T))
                out["dropout_ms_per_img"] = trace.device_ms(
                    lambda: [common.dropout(t, self.cfg["drop_rate"], keys) for t in sites],
                    2) / self.nb
                del sites
            else:
                fw = trace.device_ms(lambda: yolov3.forward_cf(
                    p, s, x, spec=r.spec, compute_dtype=dtype), 5)
        out["backbone_ms_per_img"] = bb / self.nb
        out["heads_ms_per_img"] = (fw - bb) / self.nb
        return out

    def _hws(self):
        h, w = self.cfg["full_img_size"][:2]
        return [(h // s, w // s) for s in arch.STRIDES]

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.runner = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The kept calls recomputed by the reference and judged."""
        cfg, spec = self.cfg, self.check_spec
        readings = []
        for _, j, keys, rows, valid in sorted(self.kept, key=lambda e: e[0]):
            imgs = torch.from_numpy(self.pool[j:j + self.nb]).to(self.dev)
            ref = ref_model.decoded_rows(cfg, self.params, self.stats, imgs, keys)
            twin = ref_model.decoded_rows(cfg, self.params, self.stats, imgs, keys,
                                          dtype=torch.bfloat16)
            for b in range(self.nb):
                readings.append(judge.judge_image(
                    ref[b], twin[b], rows[b], valid[b], epistemic=self.epistemic, cls_cnt=cfg["cls_cnt"],
                    img_hw=tuple(cfg["full_img_size"][:2]), hws=self._hws(),
                    max_out=cfg["nms_max_boxes"], thresh=cfg["nms_iou_thresh"],
                    slack=spec["iou_slack"]))
            del ref, twin
        return judge.numbers(readings)
