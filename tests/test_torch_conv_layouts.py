"""The persistent stem and res-block kernels' arithmetic written out in
float64 from the cached weight layouts, exactly as the kernels index their
shared memory: each piece un-swizzled as a swizzled read un-swizzles it, the
1x1 (res block) or im2col conv1 (stem) over the flat halo list in m64 tiles,
the intermediate zeroed outside the image, each 3x3 / 2x2 tap a run of 64
consecutive rows shifted by the tap, and the tile walk that the kernels
compute from the block count.  All on the CPU; the result is held against
``F.conv2d`` at 1e-9 relative (float64 sums in another order)."""

import itertools

import pytest
import torch
import torch.nn.functional as F

from bayesian_yolov3_torch.ops import cuda_conv as cc

BF16 = torch.bfloat16


def tile_walk(n, h, w, tile, blocks):
    """The tiles of a persistent kernel (``tile`` = ``cc.STEM_TILE`` or
    ``cc.RES_TILE``) per block, as the kernels' ``tile_at`` enumerates them:
    tile t = (image, row tile, column tile), column tiles fastest, is taken
    by block t % blocks (block b walks t = b, b + blocks, ..., across image
    boundaries).  Tile (i, ty, tx) covers output rows ``tile[0]*ty ..`` and
    columns ``tile[1]*tx ..`` of image i, masked at the image's edge."""
    tiles_x = -(-w // tile[1])
    per_img = -(-h // tile[0]) * tiles_x
    return [[(t // per_img, t % per_img // tiles_x, t % tiles_x)
             for t in range(b, n * per_img, blocks)] for b in range(blocks)]


def _unswizzle(piece):
    """A stored (rows, 64) piece -> its logical rows: logical chunk k of row
    o sits at chunk k ^ (o & 7)."""
    o = torch.arange(piece.shape[0])[:, None]
    k = torch.arange(64)[None, :]
    return torch.gather(piece, 1, ((k // 8) ^ (o & 7)) * 8 + k % 8)


def _pieces(flat, sizes):
    """Split the flat layout into un-swizzled (rows, 64) pieces."""
    out, off = [], 0
    for rows in sizes:
        out.append(_unswizzle(flat[off:off + rows * 64].reshape(rows, 64)).double())
        off += rows * 64
    assert off == flat.numel()
    return out


def _halo(x, i, y0, x0, rows, cols):
    """Pixels (y0 + r, x0 + c) of image i for r < rows, c < cols as a flat
    list (row-major), zero outside the image, and the inside mask."""
    _, h, w, _ = x.shape
    r, c = torch.div(torch.arange(rows * cols), cols, rounding_mode="floor"), torch.arange(rows * cols) % cols
    gy, gx = y0 + r, x0 + c
    inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    flat = torch.zeros((rows * cols, x.shape[3]), dtype=x.dtype)
    flat[inside] = x[i, gy[inside], gx[inside]]
    return flat, inside


def _res_emulated(x, w_k, blocks):
    """The res-block kernel's two GEMMs (no BN, no rounding) over its tiles."""
    n, h, w, c = x.shape
    cm, rb = c // 2, min(c, 128)
    nks, nh, na = -(-9 * cm // 64), c // rb, cm // 2
    na_off = c // 64 * cm * 64  # wa's pieces, then wb's
    wa = _pieces(w_k[:na_off], [cm] * (c // 64))
    wb = _pieces(w_k[na_off:], [rb] * (nks * nh))
    y = torch.full((n, h, w, c), float("nan"), dtype=torch.float64)
    th, tw = cc.RES_TILE
    for walk in tile_walk(n, h, w, cc.RES_TILE, blocks):
        for i, ty, tx in walk:
            y0, x0 = th * ty, tw * tx
            xh, inside = _halo(x, i, y0 - 1, x0 - 1, 4, 64)  # 256 halo pixels
            # 1x1 in four m64 tiles; warpgroup g computes t channels g*na ..
            # from rows g*na .. of each wa piece.  t's 8 spare rows past the
            # halo hold garbage (NaN here): only unstored columns read them
            t = torch.zeros((max(1, cm // 64), 264, 64), dtype=torch.float64)
            t[:, 256:] = float("nan")
            for mt in range(4):
                m0 = 64 * mt
                for g in range(2):
                    acc = sum(xh[m0:m0 + 64, 64 * s:64 * s + 64] @ wa[s][g * na:(g + 1) * na].T
                              for s in range(c // 64))
                    for j in range(na):
                        ch = g * na + j
                        t[ch // 64, m0:m0 + 64, ch % 64] = acc[:, j]
            t[:, :256][:, ~inside] = 0.0  # t, not x, is zero outside the image
            for r in range(2):  # one warpgroup per output row
                acc = torch.zeros((64, c), dtype=torch.float64)
                for hb in range(nh):
                    for s3 in range(nks):
                        for kk in range(4):
                            k0 = 64 * s3 + 16 * kk
                            if k0 >= 9 * cm:
                                continue
                            tap, c0 = divmod(k0, cm)
                            di, dj = divmod(tap, 3)
                            a0 = (r + di) * 64 + dj
                            a = t[c0 // 64, a0:a0 + 64, c0 % 64:c0 % 64 + 16]
                            b = wb[hb * nks + s3][:, 16 * kk:16 * kk + 16]
                            acc[:, hb * rb:(hb + 1) * rb] += a @ b.T
                gy, cols = y0 + r, x0 + torch.arange(64)
                ok = (torch.arange(64) < tw) & (cols < w)  # columns 62, 63 not stored
                if gy < h:
                    y[i, gy, cols[ok]] = acc[ok]
    return y


@pytest.mark.parametrize("shape,blocks", [((1, 5, 9, 64), 1), ((1, 5, 9, 128), 2),
                                          ((1, 5, 9, 256), 2), ((2, 3, 70, 64), 3)])
def test_res_block_kernel_layout_and_tiles(shape, blocks):
    n, h, w, c = shape
    gen = torch.Generator().manual_seed(c + w)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    wa = torch.randn((c // 2, c, 1, 1), generator=gen, dtype=torch.float64)
    wb = torch.randn((c, c // 2, 3, 3), generator=gen, dtype=torch.float64)
    w_k = cc._res_kernel_weights(wa, wb)
    assert w_k.dtype == BF16 and w_k.is_contiguous()
    got = _res_emulated(x, w_k, blocks)
    xc = x.permute(0, 3, 1, 2)
    t = F.conv2d(xc, wa.to(BF16).double())
    want = F.conv2d(t, wb.to(BF16).double(), padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


def _stem_emulated(x, w_k, blocks):
    """The stem kernel's im2col conv1 and 2x2 conv2' (no BN, no rounding)."""
    n, h2, w2, _ = x.shape
    p = _pieces(w_k, [128, 128] + [64] * 8)
    w1 = torch.cat(p[:2], dim=1)  # (128, 128): K byte 2k = 24*tap + 2*c
    w2s = p[2:]                   # slice tap*2 + plane: (64, 64)
    y = torch.full((n, h2, w2, 64), float("nan"), dtype=torch.float64)
    th, tw = cc.STEM_TILE
    for walk in tile_walk(n, h2, w2, cc.STEM_TILE, blocks):
        for i, ty, tx in walk:
            y0, x0 = th * ty, tw * tx
            xt, _ = _halo(x, i, y0 - 2, x0 - 2, 5, 67)
            xt = xt.reshape(5, 67, 12)
            t1 = torch.zeros((2, 195, 64), dtype=torch.float64)
            _, inside = _halo(x, i, y0 - 1, x0 - 1, 3, 65)
            for mt in range(4):  # the last m64 tile starts at row 131
                m0 = min(64 * mt, 195 - 64)
                im = torch.zeros((64, 128), dtype=torch.float64)
                for row in range(64):
                    hr, hc = divmod(m0 + row, 65)
                    for u in range(27):  # 8-byte move u: K values 4u .. 4u+3
                        tap, part = divmod(u, 3)
                        di, dj = divmod(tap, 3)
                        im[row, 4 * u:4 * u + 4] = xt[hr + di, hc + dj, 4 * part:4 * part + 4]
                acc = sum(im[:, 16 * kk:16 * kk + 16] @ w1[:, 16 * kk:16 * kk + 16].T
                          for kk in range(7))
                t1[0, m0:m0 + 64], t1[1, m0:m0 + 64] = acc[:, :64], acc[:, 64:]
            t1[:, ~inside] = 0.0  # the front padding of t1 is zero
            for r in range(2):
                acc = torch.zeros((64, 64), dtype=torch.float64)
                for tap in range(4):
                    a, b = divmod(tap, 2)
                    a0 = (r + a) * 65 + b
                    for pl in range(2):
                        for kk in range(4):
                            acc += (t1[pl, a0:a0 + 64, 16 * kk:16 * kk + 16]
                                    @ w2s[tap * 2 + pl][:, 16 * kk:16 * kk + 16].T)
                gy, cols = y0 + r, x0 + torch.arange(64)
                ok = cols < w2
                if gy < h2:
                    y[i, gy, cols[ok]] = acc[ok]
    return y


@pytest.mark.parametrize("shape,blocks", [((1, 5, 9), 1), ((2, 3, 70), 3)])
def test_stem_kernel_layout_and_tiles(shape, blocks):
    n, h2, w2 = shape
    gen = torch.Generator().manual_seed(h2 + w2)
    x = torch.randn((n, h2, w2, 12), generator=gen, dtype=torch.float64)
    k3 = torch.randn((128, 12, 3, 3), generator=gen, dtype=torch.float64)
    k2 = torch.randn((64, 128, 2, 2), generator=gen, dtype=torch.float64)
    w_k = cc._stem_kernel_weights(k3, k2)
    assert w_k.dtype == BF16 and w_k.numel() == 2 * 128 * 64 + 8 * 64 * 64
    got = _stem_emulated(x, w_k, blocks)
    t1 = F.conv2d(x.permute(0, 3, 1, 2), k3.to(BF16).double(), padding=1)
    want = F.conv2d(F.pad(t1, (1, 0, 1, 0)), k2.to(BF16).double()).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n", [1, 3, 11])
def test_tile_walk_covers_every_pixel_once(n):
    """Every output pixel in exactly one tile, each block's tiles in walk
    order, and the walk of a block crossing image boundaries."""
    h, w = 37, 130
    for (th, tw), blocks in itertools.product((cc.STEM_TILE, cc.RES_TILE), (1, 7, 132)):
        walk = tile_walk(n, h, w, (th, tw), blocks)
        assert len(walk) == blocks
        seen = torch.zeros((n, h, w), dtype=torch.int64)
        for tiles in walk:
            assert tiles == sorted(tiles)
            for i, ty, tx in tiles:
                seen[i, th * ty:th * (ty + 1), tw * tx:tw * (tx + 1)] += 1
        assert bool((seen == 1).all())
        if n > 1 and blocks == 7:
            assert len({i for i, _, _ in walk[0]}) == n
