"""The conv kernels' derived parameters (re-laid weights, folded BN) are
computed once per set of weight tensors and never served stale; and the
downsample kernel's weight layout and even/odd column split, written out in
PyTorch exactly as the kernel indexes them, give the convolution.  All on
the CPU (the wrappers take their plain versions there; the layout helpers
are plain tensor code).  Tolerances: equality where the same arithmetic
runs, 1e-9 relative for a float64 product against a float64 convolution."""

import gc

import numpy as np
import pytest
import torch

from bayesian_yolov3_torch.models import darknet as tdark
from bayesian_yolov3_torch.ops import cuda_conv as cc
from bayesian_yolov3_torch.ops.common import init_conv_block


def test_cached_hits_and_recomputes_after_writes():
    calls = []

    def double(t):
        calls.append(1)
        return t * 2

    w = torch.arange(6.0)
    first = cc.cached(double, w)
    assert cc.cached(double, w) is first and len(calls) == 1
    w.add_(1)  # an in-place write moves the version counter
    second = cc.cached(double, w)
    assert len(calls) == 2 and torch.equal(second, (torch.arange(6.0) + 1) * 2)
    with torch.no_grad():
        w.copy_(torch.zeros(6))  # as load_state_dict loads
    assert torch.equal(cc.cached(double, w), torch.zeros(6)) and len(calls) == 3
    w.data = torch.ones(6)  # a swapped storage
    assert torch.equal(cc.cached(double, w), torch.full((6,), 2.0)) and len(calls) == 4
    v = w.clone()  # equal values, another tensor: computed for itself
    cc.cached(double, v)
    assert len(calls) == 5
    with torch.inference_mode():  # no version counter: never cached
        t = torch.ones(2)
        cc.cached(double, t), cc.cached(double, t)
    assert len(calls) == 7


def test_cached_forgets_dead_tensors():
    before = len(cc._derived)
    w = torch.ones(3)
    cc.cached(cc._down_kernel_weights, torch.ones(128, 64, 3, 3))  # dies at once
    cc.cached(torch.neg, w)
    gc.collect()
    assert len(cc._derived) == before + 1
    del w
    gc.collect()
    assert len(cc._derived) == before


def _early_weights(seed):
    """Backbone convs 0-25 with BN statistics far from the identity."""
    gen = torch.Generator().manual_seed(seed)
    params, stats, cin = {}, {}, 3
    for i, (k, cout, _) in enumerate(tdark.DARKNET53_CONV_SPECS[:26]):
        p, s = init_conv_block(gen, k, cin, cout)
        p["gamma"] = torch.rand(cout, generator=gen) + 0.5
        p["beta"] = torch.randn(cout, generator=gen) * 0.2
        s["mean"] = torch.randn(cout, generator=gen) * 0.3
        s["var"] = torch.rand(cout, generator=gen) + 0.5
        params[f"conv_{i:02d}"], stats[f"conv_{i:02d}"] = p, s
        cin = cout
    return params, stats


def _clone(tree):
    return {k: {n: t.clone() for n, t in v.items()} for k, v in tree.items()}


def test_fused_early_stages_follow_newly_loaded_weights():
    """One model, other parameters loaded into the same tensors (in place) and
    into new tensors: each run equals a run on fresh copies with an empty
    cache."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (1, 32, 64, 3)).astype(np.float32))

    def run(p, s):
        with torch.no_grad():
            return tdark._fused_early_stages(p, s, x, torch.bfloat16)[0]

    pa, sa = _early_weights(1)
    pb, sb = _early_weights(2)
    cc._derived.clear()
    want_b = run(_clone(pb), _clone(sb))
    cc._derived.clear()
    got_a = run(pa, sa)
    assert cc._derived, "the fused stages cached nothing"
    bn = cc.cached(cc.fold_bn, pa["conv_04"]["gamma"], pa["conv_04"]["beta"],
                   sa["conv_04"]["mean"], sa["conv_04"]["var"])
    assert cc.cached(cc.fold_bn, pa["conv_04"]["gamma"], pa["conv_04"]["beta"],
                     sa["conv_04"]["mean"], sa["conv_04"]["var"]) is bn  # a hit
    for tree_a, tree_b in ((pa, pb), (sa, sb)):
        for name in tree_a:
            for leaf in tree_a[name]:
                tree_a[name][leaf].copy_(tree_b[name][leaf])
    got = run(pa, sa)
    assert not torch.equal(got, got_a)
    assert torch.equal(got, want_b)
    assert torch.equal(run(_clone(pa), _clone(sa)), want_b)
    assert torch.equal(run(pa, sa), want_b)


@pytest.mark.parametrize("shape", [(1, 9, 11, 64), (2, 6, 7, 128), (1, 16, 64, 64)])
def test_downsample_kernel_layout_and_phase_split(shape):
    """The kernel's GEMM written out: K slice s = cb*9 + di*3 + dj of
    ``_down_kernel_weights`` (un-swizzled as the kernel's shared-memory reads
    un-swizzle it) times the halo tile's even-t columns (dj = 0, dj = 2
    shifted by one) or odd-t columns (dj = 1), summed over slices, equals the
    stride-2 convolution with darknet padding."""
    n, h, w, c = shape
    gen = torch.Generator().manual_seed(c + h)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    wt = torch.randn((2 * c, c, 3, 3), generator=gen, dtype=torch.float64)
    wk = cc._down_kernel_weights(wt)
    assert wk.dtype == torch.bfloat16 and tuple(wk.shape) == (9 * c // 64, 2 * c, 64)
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    # local input column t of output column J's window is global 2J - 1 + t
    xp = torch.nn.functional.pad(x, (0, 0, 1, 2 * wo + 1 - w, 1, 2 * ho + 1 - h))
    even, odd = xp[:, :, 0::2], xp[:, :, 1::2]  # t = 2e, t = 2o + 1
    # each output channel's eight 16-byte chunks are stored swizzled: logical
    # chunk k of channel o at chunk k ^ (o & 7)
    o = torch.arange(2 * c)[:, None]
    k = torch.arange(64)[None, :]
    unswizzle = ((k // 8) ^ (o & 7)) * 8 + k % 8
    acc = torch.zeros((n, ho, wo, 2 * c), dtype=torch.float64)
    for s in range(wk.shape[0]):
        cb, tap = divmod(s, 9)
        di, dj = divmod(tap, 3)
        src = odd if dj == 1 else even
        a = src[:, di:di + 2 * ho:2, (dj >> 1):(dj >> 1) + wo, 64 * cb:64 * cb + 64]
        acc += a @ torch.gather(wk[s], 1, unswizzle).double().T
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), wt.to(torch.bfloat16).double(),
                                      stride=2, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(acc, want, rtol=1e-9, atol=1e-9)
