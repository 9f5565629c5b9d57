"""Host-side input pipeline: tfrecords -> decoded, batched numpy.

The counterpart of the JAX package's ``data/pipeline.py``: record reading,
PNG decode, batching and a prefetch thread, overlapped with device work —
``TestLoader`` (one ordered epoch, for inference) and ``TrainLoader`` (the
shuffled, repeating train / val batches).

Output batches are dicts of numpy arrays::

    image  (B, H, W, 3) uint8
    filename (B,) bytes                                  (TestLoader)
    bbox (B, max_boxes, 4) float32, label (B, max_boxes) int32,
    valid (B, max_boxes) bool                            (TrainLoader)

PNG needs no PIL: ``decode_png`` uses the libpng helper of the repository's
``native/`` directory for 8-bit alpha-free files when that library is built,
and otherwise a ``zlib`` + numpy decoder whose row unfilter is a small C
helper (``csrc/png_unfilter.c``, built at first use by ``ops._build``); both
return what the JAX package's PIL decode returns, for every colour type,
bit depth and interlace.  ``encode_png`` writes 8-bit gray or RGB files.
"""

from __future__ import annotations

import collections
import ctypes
import queue
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from ..config import Config
from . import proto, tfrecord


def parallel_map(fn: Callable, it: Iterable, workers: int, depth_factor: int = 4) -> Iterator:
    """Order-preserving parallel map over an iterator (thread pool).

    Record parse + PNG decode fan out over ``workers`` threads (zlib and
    the native decoder release the GIL), with a bounded in-flight window
    so memory stays flat.  Results come back in input order.
    """
    if workers <= 1:
        for x in it:
            yield fn(x)
        return
    pending: "collections.deque" = collections.deque()
    with ThreadPoolExecutor(max_workers=workers) as ex:
        try:
            for x in it:
                pending.append(ex.submit(fn, x))
                if len(pending) >= workers * depth_factor:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_NATIVE = None


def _png_native():
    """The libpng decode functions of native/libbyolo_native.so, or False."""
    global _PNG_NATIVE
    if _PNG_NATIVE is None:
        lib = tfrecord._load_native()
        if lib and hasattr(lib, "byolo_png_decode_rgb") and hasattr(lib, "byolo_png_probe"):
            lib.byolo_png_probe.restype = ctypes.c_int
            lib.byolo_png_probe.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.byolo_png_decode_rgb.restype = ctypes.c_int
            lib.byolo_png_decode_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ]
            _PNG_NATIVE = lib
        else:
            _PNG_NATIVE = False
    return _PNG_NATIVE


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        yield ctype, data[pos + 8:pos + 8 + length]
        pos += 12 + length


_UNFILTER = None


def _unfilter_fn():
    """``png_unfilter`` of ``csrc/png_unfilter.c``, built at first use."""
    global _UNFILTER
    if _UNFILTER is None:
        from ..ops import _build

        fn = _build.load_host("png_unfilter").png_unfilter
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int]
        _UNFILTER = fn
    return _UNFILTER


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (all five types) in C.  raw: (h, 1 + stride)
    uint8 -> (h, stride) uint8; ``bpp`` is the filter's byte distance."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.shape != (h, stride + 1):
        raise ValueError(f"PNG rows {raw.shape}, want ({h}, {stride + 1})")
    out = np.empty((h, stride), np.uint8)
    bad = _unfilter_fn()(raw.ctypes.data, out.ctypes.data, h, stride, bpp)
    if bad < 0:
        raise ValueError(f"no PNG format has a filter distance of {bpp} bytes")
    if bad:
        raise ValueError(f"bad PNG filter type {int(raw[bad - 1, 0])} in row {bad - 1}")
    return out


# colour type -> (samples per pixel, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _unpack_samples(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, rowbytes) -> the first ``n`` samples of each row,
    (h, n), uint8 for depths up to 8 and uint16 for 16 (big-endian)."""
    if depth == 8:
        return rows[:, :n]
    if depth == 16:
        pairs = rows[:, :2 * n].reshape(rows.shape[0], n, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(rows.shape[0], n, depth)
    out = np.zeros((rows.shape[0], n), np.uint8)
    for i in range(depth):  # most significant bit first
        out = (out << 1) | bits[..., i]
    return out


def _decode_png_zlib(data: bytes) -> np.ndarray:
    """PNG bytes -> (h, w, 3) uint8 with zlib, numpy and the C unfilter:
    every colour type and bit depth, Adam7 included, converted as PIL's
    ``Image.convert("RGB")`` converts them — 16-bit gray clipped at 255,
    other 16-bit samples by their high byte, sub-8-bit gray scaled to
    0..255, palette indices through PLTE (black past its end), alpha and
    tRNS dropped."""
    ihdr, plte, idat = None, None, []
    for ctype, body in _png_chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1] or interlace > 1:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    ch = _PNG_TYPES[ctype][0]
    bits = ch * depth
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    samples = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if not pw or not ph:
            continue  # an empty pass has no rows, not even filter bytes
        rowbytes = (pw * bits + 7) // 8
        n = ph * (rowbytes + 1)
        if pos + n > raw.size:
            raise ValueError("PNG data has the wrong length")
        rows = _unfilter(raw[pos:pos + n].reshape(ph, rowbytes + 1), ph, rowbytes,
                         max(1, bits // 8))
        pos += n
        samples[y0::dy, x0::dx] = _unpack_samples(rows, pw * ch, depth).reshape(ph, pw, ch)
    if pos != raw.size:
        raise ValueError("PNG data has the wrong length")
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:min(len(plte), 256)] = plte[:256]
        return pal[samples[..., 0]]
    if depth == 16:
        # PIL: 16-bit gray opens as I;16 and clips; the rest keep the high byte
        samples = (np.minimum(samples, 255) if ctype == 0 else samples >> 8).astype(np.uint8)
    elif depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def png_decoder_name() -> str:
    """Which decoder ``decode_png`` takes for 8-bit alpha-free files."""
    if _png_native():
        return "native libpng (native/libbyolo_native.so)"
    return "zlib + C unfilter (csrc/png_unfilter.c)"


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (h, w, 3) uint8 (the [0,1) scaling happens on device),
    equal to the JAX package's ``decode_png`` (PIL's ``convert("RGB")``)
    for every PNG: 8-bit alpha-free files through the native libpng helper
    when it is built, everything else through ``_decode_png_zlib``."""
    lib = _png_native()
    if lib:
        h, w, flags = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
        if (
            lib.byolo_png_probe(data, len(data), ctypes.byref(h), ctypes.byref(w),
                                ctypes.byref(flags)) == 0
            and flags.value == 0  # no alpha, not 16-bit
        ):
            out = np.empty((h.value, w.value, 3), np.uint8)
            rc = lib.byolo_png_decode_rgb(
                data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
            if rc == 0:
                return out
    return _decode_png_zlib(data)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> np.ndarray:
    """(h, n) uint8 rows -> (h, 1 + n) PNG scanlines, row y stored with the
    filter type ``filters[y % len(filters)]`` (0 None .. 4 Paeth)."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    ftype = np.resize(np.asarray(filters, np.uint8), rows.shape[0])
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = ftype
    for t in range(5):
        m = ftype == t
        if not m.any():
            continue
        a_m, b_m, c_m = a[m], b[m], c[m]
        if t == 4:
            p = a_m + b_m - c_m
            pa, pb, pc = np.abs(p - a_m), np.abs(p - b_m), np.abs(p - c_m)
            pred = np.where((pa <= pb) & (pa <= pc), a_m, np.where(pb <= pc, b_m, c_m))
        else:
            pred = (0, a_m, b_m, (a_m + b_m) >> 1)[t]
        out[m, 1:] = (x[m] - pred) & 0xFF
    return out


def encode_png(img: np.ndarray, level: int = 6, filters=(0,)) -> bytes:
    """(h, w, 3) or (h, w) uint8 -> PNG bytes (8-bit); row y is stored with
    filter type ``filters[y % len(filters)]`` (default: 0 on every row)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        ctype, rows = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, rows = 2, img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"encode_png takes (h, w) or (h, w, 3) uint8, got {img.shape}")
    if not set(filters) <= {0, 1, 2, 3, 4}:
        raise ValueError(f"PNG filter types are 0..4, got {filters}")
    h, w = img.shape[:2]
    raw = _filter_rows(rows, 1 if ctype == 0 else 3, filters)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


# --------------------------------------------------------------------------
# records -> batches
# --------------------------------------------------------------------------


def parse_example(record: bytes, config: Config, with_filename: bool = False) -> Dict[str, np.ndarray]:
    """TF Object Detection API schema parse.

    Applies the implicit-background-class label shift (labels start at 1 in
    the tfrecords -> shift to 0-based).
    """
    feats = proto.decode_example(record)
    img = decode_png(feats["image/encoded"][0])
    xmin = np.asarray(feats.get("image/object/bbox/xmin", []), np.float32)
    ymin = np.asarray(feats.get("image/object/bbox/ymin", []), np.float32)
    xmax = np.asarray(feats.get("image/object/bbox/xmax", []), np.float32)
    ymax = np.asarray(feats.get("image/object/bbox/ymax", []), np.float32)
    bbox = np.stack([ymin, xmin, ymax, xmax], axis=1) if len(xmin) else np.zeros((0, 4), np.float32)
    label = np.asarray(feats.get("image/object/class/label", []), np.int64).astype(np.int32)
    if config.implicit_background_class:
        label = label - 1
    out = {"image": img, "bbox": bbox, "label": label}
    if with_filename:
        names = feats.get("image/filename", [b""])
        out["filename"] = names[0] if names else b""
    return out


def zero_center(img):
    """[0,1) -> [-1,1) (present in the reference but wired into no pipeline;
    the networks consume [0,1) images)."""
    return 2.0 * (img - 0.5)


def _pad(parsed: Dict, max_boxes: int) -> Dict:
    m = min(len(parsed["bbox"]), max_boxes)
    bbox = np.zeros((max_boxes, 4), np.float32)
    label = np.zeros((max_boxes,), np.int32)
    valid = np.zeros((max_boxes,), bool)
    bbox[:m] = parsed["bbox"][:m]
    label[:m] = parsed["label"][:m]
    valid[:m] = True
    return {**parsed, "bbox": bbox, "label": label, "valid": valid}


class ShuffleBuffer:
    """Reservoir-style shuffle buffer (tf.data.Dataset.shuffle semantics)."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size = max(1, size)
        self.rng = rng
        self.buf: List = []

    def __call__(self, it: Iterator) -> Iterator:
        for item in it:
            if len(self.buf) < self.size:
                self.buf.append(item)
                continue
            j = int(self.rng.integers(0, self.size))
            out, self.buf[j] = self.buf[j], item
            yield out
        self.rng.shuffle(self.buf)
        while self.buf:
            yield self.buf.pop()


def _batch(items: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for k in items[0].keys():
        if k == "filename":
            out[k] = np.asarray([it[k] for it in items], dtype=object)
        else:
            out[k] = np.stack([it[k] for it in items])
    return out


class _Prefetcher:
    """Background-thread prefetch."""

    def __init__(self, gen_fn, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def run():
            try:
                for item in gen_fn():
                    if self._stop.is_set():
                        return
                    self.q.put(item)
            except BaseException as e:  # surface worker errors to the consumer
                self.q.put(e)
            self.q.put(None)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self):
        self._stop.set()
        while not self.q.empty():
            self.q.get_nowait()


PACK_PAD = 8  # zero rows above and below the planes of ``pack_planes_host``


def packed_row_pitch(width: int) -> int:
    """Row pitch of the packed planes of a ``width``-wide image: W/2 rounded
    up to a multiple of 256."""
    return -(-(width // 2) // 256) * 256


def pack_planes_host(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (16, (H/2 + 2*PACK_PAD) * pitch) uint8: the image
    in its 2x2 space-to-depth form, channels first.

    Plane ``(pi*2 + pj)*3 + c`` holds pixel phase (pi, pj) of colour c on the
    (H/2, W/2) grid, inside ``PACK_PAD`` zero rows above and below and zero
    columns up to ``packed_row_pitch(W)``; planes 12-15 are zero.  The byte
    layout is the JAX package's, so one host loader can feed either package;
    the device casts, scales by 1/255 and reads the 12 image planes through
    a strided view (``models.darknet._fused_early_stages``).
    """
    H, W, C = img.shape
    if C != 3 or H % 2 or W % 2 or img.dtype != np.uint8:
        raise ValueError(f"pack_planes_host takes an even-sized uint8 RGB image, got "
                         f"{img.shape} {img.dtype}")
    h2, w2 = H // 2, W // 2
    y = img.reshape(h2, 2, w2, 2, C).transpose(1, 3, 4, 0, 2)
    y = np.ascontiguousarray(y).reshape(4 * C, h2, w2)
    out = np.zeros((16, h2 + 2 * PACK_PAD, packed_row_pitch(W)), np.uint8)
    out[:12, PACK_PAD:PACK_PAD + h2, :w2] = y
    return out.reshape(16, -1)


class TestLoader:
    """One-epoch, ordered (img, filename) batches.

    ``pack_planes=True``: each image is additionally emitted as
    space-to-depth channels-first uint8 planes under the ``"packed"`` key
    (``pack_planes_host``), computed on the parser threads, for the runner's
    packed-input feed.
    """

    __test__ = False  # not a pytest class

    def __init__(self, config: Config, batch_size: Optional[int] = None,
                 pack_planes: bool = False):
        self.config = config
        self.batch_size = batch_size or config.batch_size
        self.pack_planes = pack_planes

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        def parse(rec):
            parsed = parse_example(rec, self.config, with_filename=True)
            parsed.pop("bbox"), parsed.pop("label")
            if self.pack_planes:
                parsed["packed"] = pack_planes_host(parsed["image"])
            return parsed

        def gen():
            buf = []
            parsed_it = parallel_map(
                parse,
                tfrecord.read_shards(self.config.data.file_pattern),
                self.config.cpu_thread_cnt,
            )
            for parsed in parsed_it:
                buf.append(parsed)
                if len(buf) == self.batch_size:
                    yield _batch(buf)
                    buf = []
            if buf:
                yield _batch(buf)  # final partial batch

        return iter(_Prefetcher(gen))


class TrainLoader:
    """Infinite shuffled train/val batches.

    Several hosts: pass ``host_index`` / ``host_count`` — each host reads a
    disjoint stripe of the shard files and yields local batches of
    ``batch_size / host_count`` rows.  With the same seed the batches are
    the JAX package's ``TrainLoader``'s (both draw from numpy).
    """

    def __init__(self, config: Config, split: str = "train", seed: int = 0,
                 host_index: int = 0, host_count: int = 1):
        self.config = config
        self.split_cfg = getattr(config, split)
        self.split = split
        self.host_index = host_index
        self.host_count = host_count
        if config.batch_size % host_count:
            raise ValueError(f"global batch {config.batch_size} not divisible by "
                             f"{host_count} hosts")
        self.local_batch_size = config.batch_size // host_count
        self.rng = np.random.default_rng(seed + 1031 * host_index)
        self._prefetcher: Optional[_Prefetcher] = None

    def _epochs(self) -> Iterator[Dict]:
        """parse -> [cache] -> shuffle -> repeat.  The cache holds PARSED
        elements (decoded uint8 images + padded GT), so epochs after the
        first skip record parse and PNG decode; the shuffle comes after it."""
        cache: Optional[List[Dict]] = [] if self.split_cfg.cache else None
        first = True
        while True:  # repeat
            if cache is not None and not first:
                parsed_it: Iterator[Dict] = iter(cache)
            else:
                records = tfrecord.read_shards(
                    self.split_cfg.file_pattern, shuffle_rng=self.rng,
                    shard_index=self.host_index, shard_count=self.host_count,
                )
                parsed_it = parallel_map(
                    lambda rec: _pad(parse_example(rec, self.config),
                                     self.config.max_boxes_per_img),
                    records,
                    self.config.cpu_thread_cnt,
                )
                if cache is not None:
                    parsed_it = self._caching_iter(parsed_it, cache)
            yield from ShuffleBuffer(self.split_cfg.shuffle_buffer_size, self.rng)(parsed_it)
            first = False

    @staticmethod
    def _caching_iter(records, cache):
        for r in records:
            cache.append(r)
            yield r

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        def gen():
            buf = []
            for item in self._epochs():
                buf.append(item)
                if len(buf) == self.local_batch_size:
                    yield _batch(buf)
                    buf = []

        self._prefetcher = _Prefetcher(gen)
        return iter(self._prefetcher)

    def close(self):
        if self._prefetcher:
            self._prefetcher.close()
