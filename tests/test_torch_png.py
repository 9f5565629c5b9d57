"""The port's PNG decoder against the JAX package's ``decode_png`` (PIL's
``convert("RGB")``): every colour type, bit depth and interlace, files
written here by hand with zlib + struct, rows stored under all five filter
types.  Equality is exact.  And the C unfilter against a per-row Python
reference."""

import struct
import zlib

import numpy as np
import pytest

from bayesian_yolov3_tpu.data import pipeline as jpipeline

from bayesian_yolov3_torch.data import pipeline

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
CASES = [(ct, d) for ct, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                                    (4, (8, 16)), (6, (8, 16))) for d in depths]


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(
        ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _pack_rows(samples, depth):
    """(h, w, ch) samples -> (h, rowbytes) bytes, big-endian, rows padded."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * ch).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    per = 8 // depth
    v = samples.reshape(h, w * ch).astype(np.uint8)
    n = -(-v.shape[1] // per)
    v = np.pad(v, ((0, 0), (0, n * per - v.shape[1]))).reshape(h, n, per)
    shifts = np.array([8 - depth * (i + 1) for i in range(per)], np.uint8)
    return (v << shifts).sum(axis=2).astype(np.uint8)


def _filter(rows, bpp, ftypes):
    """Store row y with filter ftypes[y] (the encoder's side of PNG 9.2)."""
    x = rows.astype(np.int32)
    out = bytearray()
    for y, ft in enumerate(ftypes):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])[:cur.size]
        c = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])[:cur.size]
        p = a + up - c
        pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
        pred = (0, a, up, (a + up) // 2,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c)))[ft]
        out.append(ft)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
    return bytes(out)


def png_bytes(samples, depth, ctype, rng, *, interlace=0, plte=None, trns=None):
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    data = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            rows = _pack_rows(sub, depth)
            data += _filter(rows, bpp, rng.integers(0, 5, rows.shape[0]))
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        body += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    return (b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IDAT", zlib.compress(data))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", CASES)
def test_decode_png_equals_jax(rng, ctype, depth, interlace):
    """Each colour type x bit depth x interlace, at sizes whose Adam7 passes
    are empty, ragged or byte-padded; samples span the full range (16-bit
    gray above 255 clips, 16-bit colour keeps the high byte, sub-8-bit gray
    scales, palette indices past PLTE give black, alpha and tRNS drop)."""
    ch = CHANNELS[ctype]
    for h, w in ((1, 1), (3, 2), (9, 11), (17, 5)):
        samples = rng.integers(0, 1 << depth, (h, w, ch)).astype(np.uint16)
        plte = trns = None
        if ctype == 3:
            plte = rng.integers(0, 256, (max(1, (1 << depth) - 3), 3))
            trns = bytes(rng.integers(0, 256, 2, dtype=np.uint8))
        elif ctype in (0, 2) and depth == 16:
            trns = struct.pack(">" + "H" * ch, *samples[0, 0, :ch].tolist())
        data = png_bytes(samples, depth, ctype, rng, interlace=interlace, plte=plte,
                         trns=trns)
        want = jpipeline.decode_png(data)
        got = pipeline._decode_png_zlib(data)
        assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pipeline.decode_png(data), want)


def test_pil_conversion_quirks(rng):
    """The conversions spelled out, one pixel row each (PIL 12's values)."""
    def dec(samples, depth, ctype, **kw):
        return pipeline._decode_png_zlib(png_bytes(np.asarray(samples, np.uint16)[None],
                                                   depth, ctype, rng, **kw))[0]

    np.testing.assert_array_equal(dec([[1], [255], [256], [1000]], 16, 0)[:, 0],
                                  [1, 255, 255, 255])
    np.testing.assert_array_equal(dec([[0x0102, 0x0304, 0xfe00]], 16, 2), [[1, 3, 254]])
    np.testing.assert_array_equal(dec([[10, 0]], 8, 4), [[10, 10, 10]])
    np.testing.assert_array_equal(dec([[10, 20, 30, 0]], 8, 6), [[10, 20, 30]])
    np.testing.assert_array_equal(dec([[0], [1], [2], [3]], 2, 0)[:, 0], [0, 85, 170, 255])
    np.testing.assert_array_equal(dec([[0], [1]], 1, 0)[:, 0], [0, 255])
    plte = np.array([[1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(dec([[1], [0], [3]], 2, 3, plte=plte, trns=b"\x00"),
                                  [[4, 5, 6], [1, 2, 3], [0, 0, 0]])


def _unfilter_reference(raw, h, stride, bpp):
    """The PNG spec's per-byte loop, row by row."""
    out = np.zeros((h, stride), np.int64)
    for y in range(h):
        ft, line = int(raw[y, 0]), raw[y, 1:].astype(np.int64)
        for i in range(stride):
            a = out[y, i - bpp] if i >= bpp else 0
            b = out[y - 1, i] if y else 0
            c = out[y - 1, i - bpp] if (y and i >= bpp) else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = (0, a, b, (a + b) >> 1,
                    a if (pa <= pb and pa <= pc) else (b if pb <= pc else c))[ft]
            out[y, i] = (line[i] + pred) & 0xFF
    return out.astype(np.uint8)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_unfilter_matches_reference(rng, bpp):
    """Mixed filters 0-4 on random bytes, every filter distance PNG has."""
    h, stride = 12, 5 * bpp
    raw = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    raw[:, 0] = np.resize([4, 3, 2, 1, 0, 4, 3], h)
    np.testing.assert_array_equal(pipeline._unfilter(raw, h, stride, bpp),
                                  _unfilter_reference(raw, h, stride, bpp))


def test_unfilter_refuses_bad_input(rng):
    raw = rng.integers(0, 256, (3, 7), dtype=np.uint8)
    raw[:, 0] = [0, 5, 1]
    with pytest.raises(ValueError, match="bad PNG filter type 5 in row 1"):
        pipeline._unfilter(raw, 3, 6, 3)
    raw[:, 0] = 0
    with pytest.raises(ValueError, match="filter distance of 5"):
        pipeline._unfilter(raw, 3, 6, 5)


@pytest.mark.parametrize("filters", [(0,), (1, 2, 3, 4), (4,), (3, 1)])
def test_encode_png_filters_round_trip(rng, filters):
    """encode_png's row filters: JAX's decoder (PIL) and the port's read back
    the image."""
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    for im in (img, img[..., 1]):
        data = pipeline.encode_png(im, filters=filters)
        want = im if im.ndim == 3 else np.repeat(im[..., None], 3, axis=2)
        np.testing.assert_array_equal(jpipeline.decode_png(data), want)
        np.testing.assert_array_equal(pipeline._decode_png_zlib(data), want)


def test_host_build_failure_raises_with_the_compiler_message(tmp_path, monkeypatch):
    """A source the compiler refuses raises RuntimeError with its message,
    never a quiet fallback."""
    from bayesian_yolov3_torch.ops import _build

    (tmp_path / "broken.c").write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="(?s)failed for csrc/broken.c:.*error"):
        _build.load_host("broken")
