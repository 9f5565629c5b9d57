"""The sample split of the epistemic decode and partial-moments kernels
(``csrc/decode_common.cuh:reduce_anchor_samples``) mirrored in numpy from
the constants that ``ops/cuda_epistemic.py`` exports: part g of G sums the
samples [g T / G, (g+1) T / G) in increasing order, then for d = 1, 2, 4, ..
part g (g % 2d == 0) adds part g + d through a shared-memory slot; G comes
from ``sample_parts`` over one frame's anchor rows (``frame_parts``), which
both wrappers hand their launches.  All on the CPU, at small sizes.

The mirror's float32 sums are held against ``epistemic_moments_plain`` and
the JAX package's ``epistemic_moments_cf`` (interpret mode) at the
tolerance ``chip_smoke.py`` holds the kernel to (``MOM_TOL``: rtol 1e-5,
atol 1e-4; float32 sums over the samples in another order).  The mirror
rounds each product on its own where the kernel may fuse a multiply-add, so
it mirrors the kernel's order, not its last bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_yolov3_tpu.ops.pallas_epistemic import epistemic_moments_cf as j_moments

from bayesian_yolov3_torch.ops import cuda_epistemic as ce
from bayesian_yolov3_torch.ops import cuda_moments

import torch_parity  # noqa: F401  (two torch threads per pytest worker)

MOM_RTOL, MOM_ATOL = 1e-5, 1e-4
SCALES = ((32, 60), (64, 120), (128, 240))  # strides 32, 16, 8 of a 1024x1920 frame
PARTS = [1 << k for k in range(ce.SPLIT_WARPS.bit_length()) if 1 << k <= ce.SPLIT_WARPS]
TRIU = [(i, j) for i in range(4) for j in range(i, 4)]


def part_bounds(T, G):
    """Samples [t0, t1) of each part."""
    return [(g * T // G, (g + 1) * T // G) for g in range(G)]


def combine(parts):
    """The fixed tree: p_g = p_g + p_{g+d} for g % 2d == 0, d = 1, 2, 4, ..;
    the kernel's part 0 ends with the result."""
    p = list(parts)
    d = 1
    while d < len(p):
        for g in range(0, len(p), 2 * d):
            p[g] = p[g] + p[g + d]
        d *= 2
    return p[0]


def block_layout(G):
    """(anchor warp, part) of each warp of a block, as the kernels assign them."""
    return [(wi // G, wi % G) for wi in range(ce.SPLIT_WARPS)]


def slot(a, g, G, d):
    """The shared-memory slot through which part g (g % 2d == d) of anchor
    warp a hands its sums to part g - d at step d."""
    return a * (G // (2 * d)) + g // (2 * d)


def summands(raw, C, n_priors=3):
    """(B, 21+C, T, total) float32: each sample's terms of the M sums, in
    add_sample_moments' expressions."""
    x = raw.reshape(n_priors, -1, *raw.shape[1:]).astype(np.float32)
    one = np.float32(1)
    loc = x[:, 0:4]
    obj = one / (one + np.exp(-x[:, 8]))

    def xlogx(p):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(p > 0, p * np.log(np.where(p > 0, p, one)), np.float32(0))

    cls = x[:, 10:10 + C]
    e = np.exp(cls - cls.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True, dtype=np.float32)
    pe = np.zeros_like(obj)
    for c in range(C):
        pe = pe - xlogx(probs[:, c])
    terms = [loc[:, j] for j in range(4)] + [loc[:, i] * loc[:, j] for i, j in TRIU]
    terms += [np.exp(x[:, 4 + j]) for j in range(4)]
    terms += [obj, -(xlogx(obj) + xlogx(one - obj))]
    terms += [probs[:, c] for c in range(C)] + [pe]
    return np.stack(terms, axis=1).astype(np.float32)


def mirror_sums(raw, C, G, n_priors=3):
    """The kernels' (B, 21+C, total) sums at G parts: each part sequential
    in float32 from zero, then the tree."""
    terms = summands(raw, C, n_priors)
    parts = []
    for t0, t1 in part_bounds(raw.shape[1], G):
        s = np.zeros((terms.shape[0], terms.shape[1], terms.shape[3]), np.float32)
        for t in range(t0, t1):
            s = s + terms[:, :, t]
        parts.append(s)
    return combine(parts)


def _raw(seed, C, T, total):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3 * 2 * (5 + C), T, total)) * 2.0).astype(np.float32)


@pytest.mark.parametrize("G", PARTS)
def test_every_sample_once_in_order(G):
    """For T = 1 .. 64 the parts tile the samples, and the tree over them,
    with concatenation for addition, is every sample once, in order."""
    for T in range(1, 65):
        bounds = part_bounds(T, G)
        assert bounds[0][0] == 0 and bounds[-1][1] == T
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert combine([list(range(t0, t1)) for t0, t1 in bounds]) == list(range(T))


@pytest.mark.parametrize("G", PARTS)
def test_block_layout_and_slots(G):
    """Each warp of a block is one (anchor warp, part); at every step of the
    tree the writers' slots are distinct, each read by its partner, and
    among the SPLIT_WARPS / 2 slots the kernels reserve."""
    layout = block_layout(G)
    n_anchor_warps = len(layout) // G
    assert sorted(layout) == [(a, g) for a in range(n_anchor_warps) for g in range(G)]
    d = 1
    while d < G:
        writers = [(a, g) for a, g in layout if g % (2 * d) == d]
        readers = [(a, g) for a, g in layout if g % (2 * d) == 0]
        slots = [slot(a, g, G, d) for a, g in writers]
        assert len(set(slots)) == len(slots)
        assert all(0 <= s < len(layout) // 2 for s in slots)
        assert sorted(slot(a, g, G, d) for a, g in readers) == sorted(slots)
        d *= 2


def test_sample_parts():
    """G is a power of two, at most SPLIT_WARPS and T rounded up to a
    power of two, the least that gives SPLIT_MIN_WARPS warps; at T = 30 the
    ECP scales take 8, 4 and 1 parts, and at T_local = 15 or more every
    scale but the coarsest (at its cap) puts 16 warps on each of 132 SMs."""
    for T in range(1, 65):
        cap = min(ce.SPLIT_WARPS, 1 << (T - 1).bit_length())
        for rows in (1, 31, 32, 3 * 35, 5760, 23040, 92160, 10 ** 6):
            G = ce.sample_parts(T, rows)
            assert G in PARTS and G <= cap
            warps = -(-rows // 32)
            assert G == cap or warps * G >= ce.SPLIT_MIN_WARPS
            assert G == 1 or warps * (G // 2) < ce.SPLIT_MIN_WARPS
    assert [ce.sample_parts(30, 3 * h * w) for h, w in SCALES] == [8, 4, 1]
    for T in (15, 29, 30, 50):
        assert ce.sample_parts(T, 3 * 32 * 60) == ce.SPLIT_WARPS
        for h, w in SCALES[1:]:
            assert -(-3 * h * w // 32) * ce.sample_parts(T, 3 * h * w) >= 16 * 132


@pytest.mark.parametrize("T,C,h,w", [(1, 2, 4, 8), (7, 2, 4, 8), (15, 1, 3, 5), (30, 2, 4, 8),
                                     (50, 8, 2, 6)])
def test_mirror_sums_match_plain_and_jax(T, C, h, w):
    """At every G the kernels may pick for this T, the mirror's sums agree
    with the plain version and with JAX's moments (interpret mode)."""
    raw = _raw(T * 10 + C, C, T, h * w)
    plain = cuda_moments.epistemic_moments_plain(torch.from_numpy(raw), cls_cnt=C).numpy()
    want_jax = np.asarray(j_moments(jnp.asarray(raw), cls_cnt=C, interpret=True))
    cap = min(ce.SPLIT_WARPS, 1 << (T - 1).bit_length())
    for G in [g for g in PARTS if g <= cap]:
        got = mirror_sums(raw, C, G)
        assert got.shape == plain.shape == (3, 21 + C, h * w)
        for want in (plain, want_jax):
            np.testing.assert_allclose(got, want, rtol=MOM_RTOL, atol=MOM_ATOL)
    # one part is the order of a plain sequential loop over t
    seq = np.zeros_like(plain)
    terms = summands(raw, C)
    for t in range(T):
        seq = seq + terms[:, :, t]
    np.testing.assert_array_equal(mirror_sums(raw, C, 1), seq)


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for one on the card, so that they
    reach their launch (stubbed here) with the part count they chose."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("T,n_imgs,h,w", [(7, 1, 3, 7), (15, 2, 3, 7), (30, 4, 32, 60),
                                          (30, 2, 64, 120)])
def test_one_shard_split_is_the_one_shot_order(T, n_imgs, h, w, monkeypatch):
    """The part count each wrapper hands its launch: the decode of n_imgs
    frames and the moments of one frame at T_local = T take the G of one
    frame (``frame_parts``), whatever the batch; so the mirror gives each
    frame the same bits in the batched one-shot decode and the one-shard
    split."""
    parts = {}
    monkeypatch.setattr(ce, "_decode_launch", lambda *a: parts.setdefault("decode", a[-1]))
    monkeypatch.setattr(cuda_moments, "_moments_launch",
                        lambda *a: parts.setdefault("moments", a[-1]))
    C, hw = 2, h * w
    raw = _raw(T + n_imgs, C, T, n_imgs * hw)
    priors = torch.tensor([[0.3, 0.1], [0.15, 0.05], [0.08, 0.02]])
    ce.fused_epistemic_decode_cf_batched(torch.from_numpy(raw).as_subclass(_OnCard), priors,
                                         n_imgs=n_imgs, h=h, w=w, cls_cnt=C, layer_id=0)
    frame = np.ascontiguousarray(raw[:, :, :hw])
    cuda_moments.epistemic_moments_cf(torch.from_numpy(frame).as_subclass(_OnCard), cls_cnt=C)
    assert parts["decode"] == parts["moments"] == ce.frame_parts(T, 3, h, w)
    if (h, w) == (32, 60):  # the coarsest ECP scale: one frame's G, not four frames'
        assert parts["decode"] == ce.SPLIT_WARPS > ce.sample_parts(T, 3 * n_imgs * hw)
    got = mirror_sums(raw, C, parts["decode"])
    for i in range(n_imgs):
        one = np.ascontiguousarray(raw[:, :, i * hw:(i + 1) * hw])
        np.testing.assert_array_equal(got[..., i * hw:(i + 1) * hw],
                                      mirror_sums(one, C, parts["moments"]))
