"""NMS of the PyTorch port against the JAX package: the plain greedy loop
(what the CUDA kernel is held against on the card) against
``ops.nms.greedy_nms`` and the Pallas kernel in interpret mode, and
``nms_select[_batch]`` with its certificate.  Indices, counts and
certificates are integers / booleans: EXACTLY equal, no tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayesian_yolov3_tpu.ops import nms as jnms
from bayesian_yolov3_tpu.ops.pallas_nms import greedy_nms_pallas_imgvec
from bayesian_yolov3_torch.ops import cuda_nms as tcn
from bayesian_yolov3_torch.ops import nms as tnms


def _boxes(rng, n, size=0.2):
    yx = rng.uniform(0, 1 - size, (n, 2))
    hw = rng.uniform(0.02, size, (n, 2))
    return np.concatenate([yx, yx + hw], axis=1).astype(np.float32)


def _cases(rng):
    n = 256
    boxes = _boxes(rng, n)
    plain = rng.random(n).astype(np.float32)
    tied = np.round(rng.random(n) * 8).astype(np.float32) / 8  # many exact ties
    padded = plain.copy()
    padded[rng.random(n) < 0.5] = -np.inf
    zero_area = boxes.copy()
    zero_area[::3, 2:] = zero_area[::3, :2]  # degenerate: NaN IoU among themselves
    dup = boxes.copy()
    dup[1::2] = dup[::2]  # identical pairs, IoU exactly 1
    return {
        "random": (boxes, plain),
        "tied_scores": (boxes, tied),
        "neg_inf_padding": (boxes, padded),
        "zero_area_boxes": (zero_area, tied),
        "duplicates_with_ties": (dup, np.repeat(plain[::2], 2)),
        "all_padding": (boxes, np.full(n, -np.inf, np.float32)),
    }


CASE_NAMES = ["random", "tied_scores", "neg_inf_padding", "zero_area_boxes",
              "duplicates_with_ties", "all_padding"]


@pytest.mark.parametrize("name", CASE_NAMES)
@pytest.mark.parametrize("max_out,thresh", [(40, 0.5), (300, 0.3)])
def test_plain_greedy_equals_jax_and_pallas(rng, name, max_out, thresh):
    boxes, scores = _cases(rng)[name]
    want_idx, want_cnt = jnms.greedy_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                         max_out, thresh)
    got_idx, got_cnt = tnms.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                       max_out, thresh)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert int(got_cnt) == int(want_cnt)
    if name == "all_padding":
        assert int(got_cnt) == 0
    pal_idx, pal_cnt = greedy_nms_pallas_imgvec(
        jnp.asarray(boxes)[None], jnp.asarray(scores)[None], max_out=max_out,
        iou_thresh=thresh, interpret=True)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(pal_idx)[0])
    assert int(got_cnt) == int(pal_cnt[0])


def test_wrapper_is_batched_and_counts_no_launch_on_cpu(rng):
    cases = _cases(rng)
    names = ["random", "tied_scores", "neg_inf_padding"]
    boxes = torch.from_numpy(np.stack([cases[n][0] for n in names]))
    scores = torch.from_numpy(np.stack([cases[n][1] for n in names]))
    before = tcn.launch_count
    idx, cnt = tcn.greedy_nms_cuda(boxes, scores, 50, 0.5)
    assert tcn.launch_count == before  # CPU tensors launch no kernel
    assert idx.shape == (3, 50) and idx.dtype == torch.int32 and cnt.dtype == torch.int32
    for b, n in enumerate(names):
        wi, wc = jnms.greedy_nms(jnp.asarray(cases[n][0]), jnp.asarray(cases[n][1]), 50, 0.5)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(wi))
        assert int(cnt[b]) == int(wc)
    with pytest.raises(TypeError):
        tcn.greedy_nms_cuda(boxes.double(), scores, 50, 0.5)
    with pytest.raises(ValueError):
        tcn.greedy_nms_cuda(boxes[:, :, :3], scores, 50, 0.5)


def test_pre_top_k_keeps_lowest_index_among_ties():
    """torch.topk does not order ties by index; the certificate needs it.
    Scores [1,3,3,2,3]: top-2 must be anchors 1 and 2, not 2 and 4."""
    scores = np.array([1, 3, 3, 2, 3], np.float32)
    decoded = np.zeros((5, 6), np.float32)
    decoded[:, :4] = [[0.1 * i, 0.1 * i, 0.1 * i + 0.05, 0.1 * i + 0.05] for i in range(5)]
    decoded[:, 4] = scores
    decoded[:, 5] = np.arange(5)  # anchor id rides along
    rows, valid, count, cert = tnms.nms_select(
        torch.from_numpy(decoded), 4, max_out=2, pre_top_k=2, with_certificate=True)
    np.testing.assert_array_equal(rows[:, 5].numpy(), [1.0, 2.0])
    assert int(count) == 2 and bool(valid.all())
    # min selected (3) >= max excluded (3): certified, ties included
    assert bool(cert)
    jrows, _, _, jcert = jnms.nms_select(jnp.asarray(decoded), 4, max_out=2, pre_top_k=2,
                                         with_certificate=True)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert bool(jcert) == bool(cert)


def _decoded(rng, n, width=23, obj_idx=14, ties=False, size=0.2):
    d = rng.random((n, width)).astype(np.float32)
    d[:, :4] = _boxes(rng, n, size)
    if ties:
        d[:, obj_idx] = np.round(d[:, obj_idx] * 16) / 16
    return d


@pytest.mark.parametrize("n,max_out,pre_top_k,ties,size", [
    (400, 20, 64, False, 0.05),   # certificate holds
    (400, 20, 64, True, 0.05),    # holds with tied scores at the cut
    (400, 60, 64, False, 0.6),    # heavy suppression: fewer than max_out -> False
    (400, 20, 0, False, 0.2),     # no pre-filter: exact by construction
    (50, 20, 64, True, 0.2),      # pre_top_k >= N: no pre-filter
])
def test_nms_select_equals_jax(rng, n, max_out, pre_top_k, ties, size):
    d = _decoded(rng, n, ties=ties, size=size)
    want = jnms.nms_select(jnp.asarray(d), 14, max_out, 0.5, pre_top_k=pre_top_k,
                           with_certificate=True)
    got = tnms.nms_select(torch.from_numpy(d), 14, max_out, 0.5, pre_top_k=pre_top_k,
                          with_certificate=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    assert bool(got[3]) == bool(want[3])


def test_nms_select_batch_equals_jax_with_mixed_certificates(rng):
    d = np.stack([_decoded(rng, 300, size=0.05), _decoded(rng, 300, size=0.7),
                  _decoded(rng, 300, ties=True, size=0.1)])
    want = jnms.nms_select_batch(jnp.asarray(d), 14, 40, 0.5, pre_top_k=64,
                                 with_certificate=True)
    got = tnms.nms_select_batch(torch.from_numpy(d), 14, 40, 0.5, pre_top_k=64,
                                with_certificate=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cert = got[3].numpy()
    assert cert[0] and not cert[1]  # both outcomes are exercised
    # an uncertified image re-run with pre_top_k=0 equals exact NMS
    exact = tnms.nms_select_batch(torch.from_numpy(d), 14, 40, 0.5, pre_top_k=0,
                                  with_certificate=True)
    assert bool(exact[3].all())
    np.testing.assert_array_equal(exact[0][0].numpy(), got[0][0].numpy())


def test_per_class_nms_equals_jax(rng):
    d = _decoded(rng, 120)
    want = jnms.per_class_nms(jnp.asarray(d), 14, 17, 2, max_out=30)
    got = tnms.per_class_nms(torch.from_numpy(d), 14, 17, 2, max_out=30)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


def _clusters(rng, n_clusters, per, jitter=0.004):
    """Dense clusters: ``per`` jittered copies of each of ``n_clusters`` boxes,
    scores interleaved across clusters, so every cluster's picks and
    suppressions reach across the sorted order."""
    centres = _boxes(rng, n_clusters, 0.15)
    boxes = np.repeat(centres, per, axis=0) + rng.uniform(-jitter, jitter, (n_clusters * per, 4))
    return boxes.astype(np.float32), rng.random(n_clusters * per).astype(np.float32)


@pytest.mark.parametrize("name", CASE_NAMES + ["dense_clusters"])
@pytest.mark.parametrize("max_out,thresh", [(40, 0.5), (300, 0.3), (1000, 0.5)])
def test_chunked_formulation_equals_greedy(rng, name, max_out, thresh):
    """The kernels' sorted, chunked bitmask scan (``greedy_nms_chunked``) at a
    chunk of 64, index for index against the plain greedy loop and the JAX
    package's ``greedy_nms``: ties, -inf padding, zero-area NaN IoUs,
    duplicates, dense clusters, fewer than max_out survivors.  Exact."""
    if name == "dense_clusters":
        boxes, scores = _clusters(rng, 96, 5)
    else:
        boxes, scores = _cases(rng)[name]
    tb, ts = torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None]
    got_idx, got_cnt = tcn.greedy_nms_chunked(tb, ts, max_out, thresh, chunk=64)
    plain_idx, plain_cnt = tcn.greedy_nms_plain(tb, ts, max_out, thresh)
    want_idx, want_cnt = jnms.greedy_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                         max_out, thresh)
    np.testing.assert_array_equal(got_idx[0].numpy(), plain_idx[0].numpy())
    np.testing.assert_array_equal(got_idx[0].numpy(), np.asarray(want_idx))
    assert int(got_cnt[0]) == int(plain_cnt[0]) == int(want_cnt)
    if name == "dense_clusters" and max_out > 40:  # picks from at least three chunks
        order = torch.sort(ts[0], descending=True, stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(len(order))
        picked = got_idx[0][:int(got_cnt[0])].long()
        assert len(set((rank[picked] // 64).tolist())) >= 3


def test_chunked_formulation_batched_and_at_every_chunk_size(rng):
    """Several images at once, and chunks that split the candidates unevenly
    (1, 7, 64, 100, all K in one): the same picks as the plain loop."""
    cases = _cases(rng)
    names = ["random", "tied_scores", "neg_inf_padding", "duplicates_with_ties"]
    boxes = torch.from_numpy(np.stack([cases[n][0] for n in names]))
    scores = torch.from_numpy(np.stack([cases[n][1] for n in names]))
    want_idx, want_cnt = tcn.greedy_nms_plain(boxes, scores, 60, 0.5)
    for chunk in (1, 7, 64, 100, 256):
        got_idx, got_cnt = tcn.greedy_nms_chunked(boxes, scores, 60, 0.5, chunk=chunk)
        assert torch.equal(got_idx, want_idx) and torch.equal(got_cnt, want_cnt), chunk
