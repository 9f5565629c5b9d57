"""The epilogue of an int8 head conv block: the hand-written CUDA kernel,
its wrapper and its plain PyTorch version.

int32 accumulators (M, cout) -> dequant -> hash dropout -> BN affine ->
LeakyReLU(0.1) -> requant -> int8 (M, cout), the epilogue of the JAX
package's ``ops/quant.py:quant_block``, which XLA fused into the int8 conv
on the TPU (no Pallas kernel there).  The kernel source is
``csrc/quant_epilogue.cu``: one pass, each int32 read once and each int8
written once; it is bound by bytes.  The plain version is the same
arithmetic in PyTorch passes (``ops.common.dropout`` and ``leaky_relu``),
which the kernel equals bit for bit on the card.

On a CUDA tensor the wrapper launches the kernel or raises; the plain
version runs only for tensors that lie on the CPU (and where a caller asks
for it by name, to compare).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _build
from .common import dropout, leaky_relu

launch_count = 0  # kernel launches made by this module's wrapper
MAX_KEYS = 64  # QE_MAX_KEYS of csrc/quant_epilogue.cu: samples per launch


class QuantKeys(ctypes.Structure):
    """``struct QuantKeys`` of csrc/quant_epilogue.cu: the dropout keys of
    the samples of one launch, passed by value."""

    _fields_ = [("key", ctypes.c_uint32 * MAX_KEYS)]


def _lib():
    lib = _build.load("quant_epilogue")
    fn = lib.quant_epilogue_launch
    if not fn.argtypes:
        if lib.quant_epilogue_max_keys() != MAX_KEYS:
            raise RuntimeError("csrc/quant_epilogue.cu's QE_MAX_KEYS is not "
                               f"ops/cuda_quant.py's {MAX_KEYS}")
        # acc, out, dq, bns, bnb, inv_out, keys, sample_elems, n_elems, cout,
        # thresh, inv_keep, stream
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.POINTER(QuantKeys)]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                                                    ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(acc, dq, bns, bnb, keys):
    if acc.dtype != torch.int32:
        raise TypeError(f"the int8 epilogue takes int32 accumulators, not {acc.dtype}")
    if acc.dim() != 2:
        raise ValueError(f"accumulators of shape {tuple(acc.shape)}, want (M, cout)")
    cout = acc.shape[1]
    for name, v in (("dq", dq), ("bns", bns), ("bnb", bnb)):
        if v.dtype != torch.float32 or tuple(v.shape) != (cout,):
            raise ValueError(f"{name}: {v.dtype} {tuple(v.shape)}, want float32 ({cout},)")
        if v.device != acc.device:
            raise ValueError(f"{name} and the accumulators lie on different devices")
    if keys is not None and (not len(keys) or acc.shape[0] % len(keys)):
        raise ValueError(f"{acc.shape[0]} rows do not split into {len(keys)} samples")


def quant_epilogue_plain(acc: torch.Tensor, dq: torch.Tensor, bns: torch.Tensor,
                         bnb: torch.Tensor, inv_out: float, *,
                         keys: Optional[Sequence[int]] = None,
                         rate: float = 0.1) -> torch.Tensor:
    """The same function in plain PyTorch: float32 passes, in the kernel's
    order."""
    from .quant import quantize_act

    _check(acc, dq, bns, bnb, keys)
    y = acc.float() * dq
    if keys is not None:
        y = dropout(y, rate, list(keys))
    return quantize_act(leaky_relu(y * bns + bnb), inv_out)


def quant_epilogue(acc: torch.Tensor, dq: torch.Tensor, bns: torch.Tensor, bnb: torch.Tensor,
                   inv_out: float, *, keys: Optional[Sequence[int]] = None,
                   rate: float = 0.1) -> torch.Tensor:
    """int32 accumulators (M, cout) -> int8 (M, cout).

    ``acc`` holds S samples stacked sample-major (rows [s*M/S, (s+1)*M/S)
    are sample s), ``keys`` one uint32 dropout key per sample, or None for
    no dropout; the mask indexes the flat row-major index within a sample,
    as ``ops.common.dropout`` does.  ``dq``, ``bns``, ``bnb``: float32
    (cout,); ``inv_out``: the output's inverse scale, a float32 value."""
    _check(acc, dq, bns, bnb, keys)
    if not acc.is_cuda:
        return quant_epilogue_plain(acc, dq, bns, bnb, inv_out, keys=keys, rate=rate)
    return _launch(acc, dq, bns, bnb, inv_out, keys, rate)


def _launch(acc, dq, bns, bnb, inv_out, keys, rate):
    global launch_count
    m, cout = acc.shape
    if cout % 4 or not acc.is_contiguous() or acc.data_ptr() % 16:
        raise ValueError("the int8 epilogue kernel takes contiguous, 16-byte aligned "
                         "accumulators with cout % 4 == 0")
    keep = 1.0 - rate
    thresh = min(round(keep * 65536.0), 65535)
    # the divisor as ``dropout`` applies it to a float32 CUDA tensor: a multiply
    # by the float32 reciprocal of float32(keep)
    inv_keep = float(1.0 / torch.tensor(keep, dtype=torch.float32))
    out = torch.empty((m, cout), dtype=torch.int8, device=acc.device)
    params = [p.contiguous() for p in (dq, bns, bnb)]
    fn = _lib()
    # one launch per MAX_KEYS samples (one for every path of the package)
    n_samples = 1 if keys is None else len(keys)
    rows = m // n_samples
    sample_elems = rows * cout
    if sample_elems >= 1 << 32:
        raise ValueError(f"{sample_elems} elements a sample: the hash index is uint32")
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        for s0 in range(0, n_samples, MAX_KEYS):
            n = min(MAX_KEYS, n_samples - s0)
            table = None
            if keys is not None:
                table = QuantKeys()
                table.key[:n] = [int(k) & 0xFFFFFFFF for k in keys[s0:s0 + n]]
                table = ctypes.byref(table)
            rc = fn(acc[s0 * rows:].data_ptr(), out[s0 * rows:].data_ptr(),
                    *(p.data_ptr() for p in params), float(inv_out), table, sample_elems,
                    n * sample_elems, cout, thresh, inv_keep, stream)
            if rc != 0:
                raise RuntimeError(f"quant_epilogue kernel launch failed (cudaError {rc})")
            launch_count += 1
    return out
