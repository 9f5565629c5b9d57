#!/usr/bin/env python
"""CityPersons -> tfrecords (``data/citypersons.py``):

    python -m bayesian_yolov3_torch.cli.create_tf_records_citypersons \\
        --set out_dir=... --set anno_dir=... --set img_dir=...

Host code: ``.mat`` through scipy, PNGs through the package's own codec.
"""

import argparse
import logging
import time

from ..data.citypersons import process_dataset
from ..utils import setup_logging
from ._common import parse_value

DEFAULTS = {
    "out_dir": "$HOME/data/citypersons/tfrecords",  # edit
    "dataset_name": "citypersons",
    "anno_dir": "$HOME/data/citypersons",  # edit
    "img_dir": "$HOME/data/cityscapes",  # edit
    "train_shards": 3,
    "val_shards": 1,
    "shuffle": True,
}


def main(argv=None):
    setup_logging()
    p = argparse.ArgumentParser()
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = p.parse_args(argv)
    config = dict(DEFAULTS)
    for kv in args.set:
        k, _, v = kv.partition("=")
        config[k] = parse_value(v)

    logging.info("Saving results to %s", config["out_dir"])
    start = time.time()
    process_dataset(**config)
    elapsed = int(time.time() - start)
    logging.info("finished in %02d:%02d:%02d", elapsed // 3600, (elapsed // 60) % 60,
                 elapsed % 60)


if __name__ == "__main__":
    main()
