#!/usr/bin/env python3
"""The latency of one load from device memory on the card, by a pointer chase.

    python3 measure_latency.py

One thread follows dependent loads through a random cycle over 128 MB (more
than L2), after the cache is overwritten; the time of a launch over the
number of loads is the unloaded latency of one load.  It is the latency
against which ``csrc/epistemic_decode.cu`` reckons its bytes in flight by
Little's law.  Prints the card (nvidia-smi) and one JSON line; needs a CUDA
device and ``nvcc``.  The probe is built into ``build/`` (ignored by git)
with the package's flags.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from bayesian_yolov3_torch.ops import _build

PROBE = r"""
__global__ void chase(const int* __restrict__ next, int steps, int* __restrict__ end) {
  int i = 0;
  for (int k = 0; k < steps; ++k) i = next[i];
  *end = i;
}
extern "C" int chase_launch(const int* next, int steps, int* end, void* stream) {
  chase<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, end);
  return (int)cudaGetLastError();
}
"""


def build_probe() -> ctypes.CDLL:
    out_dir = _build.build_dir()
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "latency_probe.cu"), os.path.join(out_dir, "latency_probe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], check=True)
    fn = ctypes.CDLL(lib).chase_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(steps: int = 20000, reps: int = 5) -> int:
    if not torch.cuda.is_available():
        print("measure_latency.py: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    fn = build_probe()
    n = 32 * 1024 * 1024  # int32: 128 MB
    perm = torch.randperm(n, device=dev, generator=torch.Generator(device=dev).manual_seed(8))
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    end = torch.empty(1, dtype=torch.int32, device=dev)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    del perm

    def probe():
        rc = fn(nxt.data_ptr(), steps, end.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"probe launch failed (cudaError {rc})")

    probe()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        probe()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) * 1e6 / steps)
    print(card)
    print(json.dumps({"latency_ns": float(np.median(times)), "readings_ns": times,
                      "steps": steps, "buffer_bytes": n * 4}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
