"""The port's entry points (``bayesian_yolov3_torch/dryrun.py``, the
twin of ``__graft_entry__.py``) on the CPU, as tests/test_dryrun.py guards
the JAX package's: the multi-rank dry run on four spawned gloo ranks (its
seven compositions hold their own checks and raise), and ``entry()``'s
pipeline called on its example arguments."""

import pytest
import torch

import torch_parity  # noqa: F401  (two torch threads per pytest worker)

from bayesian_yolov3_torch import dryrun


def test_dryrun_multichip_4_ranks(capsys):
    ranks = dryrun.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip OK on 4 ranks" in capsys.readouterr().out
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    # the dp training step is replicated: one loss on every rank
    assert len({r["dp_train_loss"] for r in ranks}) == 1
    # the mc and sp x mc pipelines end in the same rows on every rank
    for key in ("mc_fused_detections", "mc_int8_detections", "spmc_ecp_detections"):
        assert len({r[key] for r in ranks}) == 1, key
    # on CPU tensors the wrappers take the plain versions and launch nothing
    assert all(not any(r["launches"].values()) for r in ranks)


@pytest.mark.parametrize("n", [0, 3])
def test_dryrun_needs_an_even_rank_count(n):
    with pytest.raises(ValueError, match="even"):
        dryrun.dryrun_multichip(n, device="cpu")


def test_entry_runs_and_repeats_bit_for_bit():
    fn, args = dryrun.entry(device="cpu")
    params, stats, image, keys = args
    assert image.shape == (1, 256, 480, 3) and keys.shape == (8, 15)
    rows, valid, count = fn(*args)
    assert rows.shape == (1000, 23)
    assert valid.dtype == torch.bool
    assert int(count) >= 0 and int(count) == int(valid.sum())
    assert torch.isfinite(rows[valid]).all()
    again = fn(*args)
    assert all(torch.equal(a, b) for a, b in zip((rows, valid, count), again))
