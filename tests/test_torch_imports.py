"""The PyTorch port stands alone: importing every module of
``bayesian_yolov3_torch``, ``chip_smoke`` and ``parity_fullres_torch``
(without running them) pulls in
neither jax nor orbax nor the JAX package, nor PIL, matplotlib or
tensorflow, which the card's machine lacks (the tools import them, where at
all, inside the function that needs them) — checked in a fresh
interpreter, because this test process has them loaded."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

import bayesian_yolov3_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = sorted(
    m.name for m in pkgutil.walk_packages(bayesian_yolov3_torch.__path__,
                                          "bayesian_yolov3_torch.")
) + ["chip_smoke", "parity_fullres_torch"]

_PROBE = """
import importlib, json, sys
report = {}
for name in sys.argv[1:]:
    importlib.import_module(name)
    report[name] = sorted(m for m in sys.modules
                          if m.split('.')[0] in ('jax', 'jaxlib', 'orbax', 'bayesian_yolov3_tpu',
                                                 'PIL', 'matplotlib', 'tensorflow'))
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def foreign_after_import():
    """One fresh interpreter imports the modules in order and reports, after
    each, which foreign modules are loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, *MODULES], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_is_listed():
    for needed in ("bayesian_yolov3_torch.infer.runner", "bayesian_yolov3_torch.ops.cuda_nms",
                   "bayesian_yolov3_torch.ops.cuda_epistemic", "bayesian_yolov3_torch.ops._build",
                   "bayesian_yolov3_torch.ops.cuda_conv", "bayesian_yolov3_torch.models.darknet",
                   "bayesian_yolov3_torch.cli.inference_epistemic",
                   "bayesian_yolov3_torch.ops.cuda_decode", "bayesian_yolov3_torch.infer.detect",
                   "bayesian_yolov3_torch.cli.inference_standard_yolov3",
                   "bayesian_yolov3_torch.cli.inference_aleatoric",
                   "bayesian_yolov3_torch.cli.detect",
                   "bayesian_yolov3_torch.data.pipeline", "bayesian_yolov3_torch.convert",
                   "bayesian_yolov3_torch.ops.cuda_moments", "bayesian_yolov3_torch.parallel",
                   "bayesian_yolov3_torch.parallel.mesh",
                   "bayesian_yolov3_torch.parallel.epistemic",
                   "bayesian_yolov3_torch.ops.quant", "bayesian_yolov3_torch.ops.cuda_quant",
                   "bayesian_yolov3_torch.models.quant", "bayesian_yolov3_torch.ops.loss",
                   "bayesian_yolov3_torch.data.encode", "bayesian_yolov3_torch.data.augment",
                   "bayesian_yolov3_torch.utils.profiling", "bayesian_yolov3_torch.train.loop",
                   "bayesian_yolov3_torch.cli.pretraining",
                   "bayesian_yolov3_torch.cli.uncertainty_training",
                   "bayesian_yolov3_torch.cli.yolov3_training",
                   "bayesian_yolov3_torch.models.tf1_import", "bayesian_yolov3_torch.eval",
                   "bayesian_yolov3_torch.eval.detection_metrics",
                   "bayesian_yolov3_torch.cli.evaluate_detections",
                   "bayesian_yolov3_torch.data.citypersons",
                   "bayesian_yolov3_torch.cli.create_tf_records_citypersons",
                   "bayesian_yolov3_torch.data.prior_clustering",
                   "bayesian_yolov3_torch.infer.vis", "bayesian_yolov3_torch.infer.plasma",
                   "bayesian_yolov3_torch.cli.vis_uncertainty",
                   "bayesian_yolov3_torch.infer.qualitative",
                   "bayesian_yolov3_torch.eval.parity", "bayesian_yolov3_torch.dryrun",
                   "bayesian_yolov3_torch.ops.launches"):
        assert needed in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax(foreign_after_import, module):
    assert foreign_after_import[module] == []


def test_kernel_sources_are_found_without_a_compiler():
    """Importing builds nothing; the build names every kernel's source."""
    from bayesian_yolov3_torch.ops import _build

    assert _build.kernel_names() == ["box_decode", "epistemic_decode", "epistemic_finalize",
                                     "epistemic_moments", "fused_downsample",
                                     "fused_res_block", "fused_stem", "greedy_nms",
                                     "quant_epilogue"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.build_dir().startswith(os.path.join(REPO, "build"))


def test_library_name_covers_the_shared_header(tmp_path, monkeypatch):
    """A library is named by a hash of its source AND of every shared
    ``csrc/*.cuh``: an edited header must not reuse a stale library."""
    import shutil

    from bayesian_yolov3_torch.ops import _build

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    before = {n: _build._target(n) for n in _build.kernel_names()}
    assert before == {n: _build._target(n) for n in _build.kernel_names()}  # stable
    with open(src / "conv_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build._target(n) for n in _build.kernel_names()}
    assert all(after[n] != before[n] for n in before)
    with open(src / "greedy_nms.cu", "a") as f:
        f.write("// edited\n")
    last = {n: _build._target(n) for n in _build.kernel_names()}
    assert last["greedy_nms"] != after["greedy_nms"]
    assert last["fused_stem"] == after["fused_stem"]
