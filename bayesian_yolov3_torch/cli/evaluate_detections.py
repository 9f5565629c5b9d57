#!/usr/bin/env python
"""Score an inference output directory (ECP-format JSON) against the GT of
tfrecords: per-class AP@0.5 and LAMR (MR-2), and mAP, printed as JSON.

    python -m bayesian_yolov3_torch.cli.evaluate_detections JSON_DIR \\
        --set data.file_pattern='./data/ecp-day-val-*-of-*' [--score-thresh 0.0]

Host code (numpy): the records are read by the package's own
``data.pipeline.parse_example``, no TensorFlow.
"""

import argparse
import glob
import json
import logging
import os

import numpy as np

from ..data import pipeline, tfrecord
from ..eval import evaluate_detections
from ..utils import setup_logging
from ._common import build_config

DEFAULTS = {
    "full_img_size": [1024, 1920, 3],  # edit
    "cls_cnt": 2,
    "implicit_background_class": True,
    "crop": False,
    "data": {"file_pattern": "./data/ecp-day-val-*-of-*"},  # edit
}


def main(argv=None):
    """Returns the metrics (also printed)."""
    setup_logging()
    p = argparse.ArgumentParser()
    p.add_argument("json_dir")
    p.add_argument("--score-thresh", type=float, default=0.0)
    args, rest = p.parse_known_args(argv)
    config = build_config(DEFAULTS, rest)
    h, w = config.full_img_size[:2]

    ground_truth = {}
    for rec in tfrecord.read_shards(config.data.file_pattern):
        ex = pipeline.parse_example(rec, config, with_filename=True)
        name = os.path.splitext(os.path.basename(ex["filename"].decode()))[0]
        ground_truth[name] = (ex["bbox"] * [h, w, h, w], ex["label"])

    predictions = {}
    for f in glob.glob(os.path.join(args.json_dir, "*.json")):
        name = os.path.splitext(os.path.basename(f))[0]
        with open(f) as fh:
            dets = json.load(fh)["children"]
        boxes, scores, labels = [], [], []
        for d in dets:
            if d["score"] <= args.score_thresh:
                continue
            boxes.append([d["y0"], d["x0"], d["y1"], d["x1"]])
            scores.append(d["score"])
            labels.append(int(np.argmax(d["cls_scores"])))
        predictions[name] = (np.asarray(boxes, float).reshape(-1, 4), np.asarray(scores),
                             np.asarray(labels))

    missing = set(ground_truth) - set(predictions)
    if missing:
        logging.warning("%d GT images have no prediction file", len(missing))
    out = evaluate_detections(predictions, ground_truth, cls_ids=range(config.cls_cnt))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
