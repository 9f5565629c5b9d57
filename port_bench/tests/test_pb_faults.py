"""A run's ``correct`` on the CPU at 64x96, the harness's look for a card
skipped and the rest of a run driven: true for the program as it is, false
with its timed path broken underneath -- an answer altered where it is
produced, half of the MC samples (or half of the image batch) left out."""

import numpy as np
import pytest
import torch

import run
from bayesian_yolov3_torch.infer import runner as runner_mod

SMALL = {"epistemic_T30_batch1": ({"full_img_size": [64, 96, 3], "T": 8},
                                  {"pool": 2, "batch": 1}),
         "aleatoric_batch11": ({"full_img_size": [64, 96, 3]}, {"pool": 4, "batch": 2})}


def _run(cell, seed=2**31 + 101):
    cfg, traffic = SMALL[cell]
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.3"])
    result, checks, _ = run.run(args, device="cpu",
                                overrides={"config": cfg, "traffic": traffic})
    return result["correct"], checks


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_program_is_correct(cell):
    ok, checks = _run(cell)
    assert ok, checks


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_answer_altered_is_not_correct(cell, monkeypatch):
    predict = runner_mod.InferenceRunner.predict

    def altered(self, *a, **kw):
        rows, valid = predict(self, *a, **kw)
        rows = rows.copy()
        rows[0, :, :4] += np.float32(2.0 / 96)  # image 0's boxes two pixels off
        return rows, valid

    monkeypatch.setattr(runner_mod.InferenceRunner, "predict", altered)
    ok, checks = _run(cell)
    assert not ok, checks


def test_half_the_samples_is_not_correct(monkeypatch):
    decode = runner_mod.fused_epistemic_decode_cf_batched

    def half(raw_cf, *a, **kw):  # the moments over the first T/2 samples only
        return decode(raw_cf[:, :raw_cf.shape[1] // 2].contiguous(), *a, **kw)

    monkeypatch.setattr(runner_mod, "fused_epistemic_decode_cf_batched", half)
    ok, checks = _run("epistemic_T30_batch1")
    assert not ok, checks


def test_half_the_batch_is_not_correct(monkeypatch):
    predict = runner_mod.InferenceRunner.predict

    def half(self, params, stats, images, keys=None):  # the second half not computed
        n = images.shape[0] // 2
        rows, valid = predict(self, params, stats, images[:n], keys)
        return np.concatenate([rows, rows]), np.concatenate([valid, valid])

    monkeypatch.setattr(runner_mod.InferenceRunner, "predict", half)
    ok, checks = _run("aleatoric_batch11")
    assert not ok, checks
