"""CityPersons -> tfrecords dataset ingestion — the counterpart of the JAX
package's ``data/citypersons.py``:

* reads CityPersons ``anno_{train,val}.mat`` (``anno_*_aligned`` structs:
  city, im_name, bbs rows of [class_label, x1, y1, w, h, instance_id,
  x1_vis, y1_vis, w_vis, h_vis]) through ``scipy.io`` and the Cityscapes
  PNGs;
* label mapping: rider(2) -> 2; ignore(0)/group(5) -> skipped;
  pedestrian/sitting/unusual -> 1 (labels start at 1: the implicit
  background class of the TF object detection API);
* refuses images other than 1024 x 2048 (``AssertionError``, as the JAX
  package's asserts raise); annotations cast to int64 before use (no uint8
  overflow);
* boxes normalized, the TF-ODAPI feature schema with class text, instance
  ids and ``image/object/cnt``;
* shards written by a thread pool, the train box sizes saved for prior
  clustering (``data/prior_clustering.py``) and numpy's global RNG state
  pickled, so a shuffle can be reproduced; ``np.random.shuffle`` over that
  state gives the JAX package's shard membership.

Each PNG is decoded and re-encoded by the package's own codec
(``data.pipeline.decode_png`` / ``encode_png``): no PIL, no TensorFlow.
The encoded bytes differ from PIL's; the decoded pixels are the same.
"""

from __future__ import annotations

import logging
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from . import proto, tfrecord
from .pipeline import decode_png, encode_png

log = logging.getLogger("byolo.citypersons")

LABEL_TO_TEXT = ["ignore", "pedestrian", "rider", "sitting", "unusual", "group"]
EXPECTED_HW = (1024, 2048)


def reencode_png(path: str) -> Tuple[bytes, Tuple[int, int]]:
    """Load a PNG and re-encode it as RGB (decode, then encode)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    h, w = img.shape[:2]
    return encode_png(img), (h, w)


def create_example(img_path: str, annotations: np.ndarray):
    encoded, (img_h, img_w) = reencode_png(img_path)
    if img_h != EXPECTED_HW[0]:
        raise AssertionError(f"unexpected height {img_h}")
    if img_w != EXPECTED_HW[1]:
        raise AssertionError(f"unexpected width {img_w}")

    ymin, xmin, ymax, xmax, label, text, inst_id = [], [], [], [], [], [], []
    skipped = 0
    box_sizes: List[Tuple[int, int]] = []
    for anno in annotations:
        anno = anno.astype(np.int64)  # no uint8 overflow in y1 + h
        class_label, x1, y1, w, h, instance_id = anno[:6]
        if class_label == 2:
            class_label = 2  # rider
        elif class_label in (0, 5):
            skipped += 1  # ignore, group
            continue
        else:
            class_label = 1  # pedestrian, sitting, unusual
        ymin.append(float(y1) / img_h)
        xmin.append(float(x1) / img_w)
        ymax.append(float(y1 + h) / img_h)
        xmax.append(float(x1 + w) / img_w)
        label.append(int(class_label))
        text.append(LABEL_TO_TEXT[class_label].encode("utf8"))
        inst_id.append(int(instance_id))
        box_sizes.append((int(h), int(w)))

    example = proto.encode_example(
        {
            "image/height": np.asarray([img_h], np.int64),
            "image/width": np.asarray([img_w], np.int64),
            "image/filename": [img_path.encode("utf8")],
            "image/source_id": [img_path.encode("utf8")],
            "image/encoded": [encoded],
            "image/format": [b"png"],
            "image/object/bbox/xmin": np.asarray(xmin, np.float32),
            "image/object/bbox/xmax": np.asarray(xmax, np.float32),
            "image/object/bbox/ymin": np.asarray(ymin, np.float32),
            "image/object/bbox/ymax": np.asarray(ymax, np.float32),
            "image/object/class/text": text,
            "image/object/class/label": np.asarray(label, np.int64),
            "image/object/instance/id": np.asarray(inst_id, np.int64),
            "image/object/cnt": np.asarray([len(label)], np.int64),
        }
    )
    return example, skipped, box_sizes, (img_h, img_w)


def _shard_filename(out_dir, dataset_name, split, shard, num_shards):
    return os.path.join(
        out_dir, f"{dataset_name}-{split}-{shard:05d}-of-{num_shards:05d}"
    )


def write_shard(args):
    shard, num_shards, split, data, img_dir, out_dir, dataset_name = args
    out_file = _shard_filename(out_dir, dataset_name, split, shard, num_shards)
    log.info("Creating shard %s-%d/%d", split, shard, num_shards)
    skipped = 0
    box_sizes: List[Tuple[int, int]] = []
    img_sizes = set()
    with tfrecord.TFRecordWriter(out_file) as writer:
        for cnt, datum in enumerate(data, start=1):
            datum = datum[0][0]  # the .mat struct's nesting
            city = str(datum[0][0])
            img_name = str(datum[1][0])
            annotations = datum[2]
            img_path = os.path.join(img_dir, city, img_name)
            example, skip, sizes, img_size = create_example(img_path, annotations)
            skipped += skip
            box_sizes.extend(sizes)
            img_sizes.add(img_size)
            writer.write(example)
            if cnt % 10 == 0:
                log.info("Written %d examples for shard %s-%d/%d", cnt, split, shard, num_shards)
    log.info(
        "Finished shard %s-%d/%d: %d annotations skipped", split, shard, num_shards, skipped
    )
    return box_sizes, split, img_sizes


def process_dataset(
    out_dir: str,
    dataset_name: str,
    anno_dir: str,
    img_dir: str,
    train_shards: int,
    val_shards: int,
    shuffle: bool,
):
    import scipy.io

    out_dir = os.path.expandvars(out_dir)
    img_dir = os.path.expandvars(img_dir)
    anno_dir = os.path.expandvars(anno_dir)
    os.makedirs(out_dir, exist_ok=True)

    if shuffle:
        with open(os.path.join(out_dir, f"{dataset_name}-np_random_state"), "wb") as f:
            pickle.dump(np.random.get_state(), f)

    train_anno = scipy.io.loadmat(
        os.path.join(anno_dir, "annotations", "anno_train.mat")
    )["anno_train_aligned"][0]
    val_anno = scipy.io.loadmat(
        os.path.join(anno_dir, "annotations", "anno_val.mat")
    )["anno_val_aligned"][0]

    train_img_dir = os.path.join(img_dir, "leftImg8bit_trainvaltest", "leftImg8bit", "train")
    val_img_dir = os.path.join(img_dir, "leftImg8bit_trainvaltest", "leftImg8bit", "val")

    def jobs(split, anno, imdir, num_shards):
        anno = np.array(anno, dtype=object)
        if shuffle:
            np.random.shuffle(anno)
        k, m = divmod(len(anno), num_shards)
        shards = [
            anno[i * k + min(i, m) : (i + 1) * k + min(i + 1, m)]
            for i in range(num_shards)
        ]
        return [
            (i + 1, num_shards, split, s, imdir, out_dir, dataset_name)
            for i, s in enumerate(shards)
        ]

    all_jobs = jobs("train", train_anno, train_img_dir, train_shards) + jobs(
        "val", val_anno, val_img_dir, val_shards
    )
    with ThreadPoolExecutor() as ex:
        results = list(ex.map(write_shard, all_jobs, chunksize=1))

    box_sizes: List[Tuple[int, int]] = []
    img_sizes = set()
    for sizes, split, sizes_set in results:
        img_sizes.update(sizes_set)
        if split == "train":
            box_sizes.extend(sizes)
    if len(img_sizes) > 1:
        log.error("Different image sizes detected: %s", img_sizes)
    np.save(
        os.path.join(out_dir, f"{dataset_name}-train-box_sizes"),
        np.asarray(box_sizes, np.float64),
    )
    np.save(
        os.path.join(out_dir, f"{dataset_name}-img_size_height_width"),
        list(img_sizes)[0],
    )
