"""The port's training loaders (``data/pipeline.py``: ``ShuffleBuffer``,
``TrainLoader``) against the JAX package's: the same seed gives the same
batches, over two epochs and more, with and without the parsed-element
cache, on one host and on a stripe of two."""

import numpy as np
import pytest

from bayesian_yolov3_tpu.config import Config as JConfig, DataConfig as JData
from bayesian_yolov3_tpu.data import pipeline as jp

from bayesian_yolov3_torch.config import Config as TConfig, DataConfig as TData
from bayesian_yolov3_torch.data import pipeline as tpl

import synth

N_IMAGES, BATCH = 7, 2


@pytest.fixture(scope="module")
def pattern(tmp_path_factory):
    path = tmp_path_factory.mktemp("loader")
    return synth.write_dataset(str(path), np.random.default_rng(5), n_images=N_IMAGES,
                               img_hw=(64, 96), shards=3)


def _configs(pattern, cache):
    kw = dict(model="standard", full_img_size=(64, 96, 3), batch_size=BATCH,
              max_boxes_per_img=3, cpu_thread_cnt=2)
    split = dict(file_pattern=pattern, shuffle_buffer_size=4, cache=cache)
    return (JConfig(**kw, train=JData(**split), val=JData(**split)),
            TConfig(**kw, train=TData(**split), val=TData(**split)))


def test_shuffle_buffer_matches_jax():
    for size in (1, 3, 8, 50):
        got = list(tpl.ShuffleBuffer(size, np.random.default_rng(4))(iter(range(30))))
        want = list(jp.ShuffleBuffer(size, np.random.default_rng(4))(iter(range(30))))
        assert got == want and sorted(got) == list(range(30))


def test_pad_and_zero_center_match_jax(rng):
    parsed = {"image": np.zeros((2, 2, 3), np.uint8),
              "bbox": rng.uniform(0, 1, (5, 4)).astype(np.float32),
              "label": rng.integers(0, 2, 5).astype(np.int32)}
    for m in (3, 5, 8):
        got, want = tpl._pad(parsed, m), jp._pad(parsed, m)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    x = rng.uniform(0, 1, 10).astype(np.float32)
    np.testing.assert_array_equal(tpl.zero_center(x), jp.zero_center(x))


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("split,seed,hosts", [("train", 1, (0, 1)), ("val", 2, (1, 2))])
def test_train_loader_matches_jax(pattern, cache, split, seed, hosts):
    """Nine batches: past the second epoch of the seven images (one host),
    or of the stripe (two hosts, the second)."""
    jcfg, tcfg = _configs(pattern, cache)
    host_index, host_count = hosts
    jl = jp.TrainLoader(jcfg, split, seed=seed, host_index=host_index, host_count=host_count)
    tl = tpl.TrainLoader(tcfg, split, seed=seed, host_index=host_index, host_count=host_count)
    try:
        jit, tit = jl.batches(), tl.batches()
        for _ in range(9):
            want, got = next(jit), next(tit)
            assert set(got) == set(want) == {"image", "bbox", "label", "valid"}
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        jl.close()
        tl.close()
