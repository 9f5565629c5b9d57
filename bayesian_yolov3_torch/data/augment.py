"""Training-time augmentation and cropping on the device, with the random
draws made apart from their application.

PyTorch counterpart of the JAX package's ``data/augment.py``:

* ``augment``: 50% horizontal flip (bbox-aware), 5% blur (2x2 or 3x3 box
  filter), 5% color (one of saturation 0.5-1.5 / brightness +-0.2 / hue
  +-0.2), 5% noise (one of colored salt&pepper / gray salt&pepper /
  additive Gaussian sigma in [0.001, 0.05]);
* ``ImageCropper``: random crop with y ~ N(center, range/4) clipped, x ~
  uniform; 33% of the time the window is randomly rescaled (scale =
  clip(N(0, 0.5), -0.7, 0.7)) and resampled back to the crop size, by one
  bilinear product per axis; ``center_crop`` for eval.  ``crop_boxes``
  clips boxes to the window and clears the validity of boxes keeping < 25%
  of their area.

The JAX functions draw from split keys inside ``lax.cond``; here
``draw_batch`` draws every per-example value of a batch from one CPU
``torch.Generator`` up front (a fixed count per example, whatever is
chosen), and the augment and crop functions take those draws as arguments.
Each example then branches on host values: no step reads a device tensor.
The full-size noise fields are made on the image's device from a seed
among the draws (``noise_fields``).

The window arithmetic keeps the JAX package's types: a random window's
bounds are float32 (``np.float32`` here), the center crop's Python floats,
so that the clipped boxes and their validity come out bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.common import _true_float32

F32 = np.float32

# --------------------------------------------------------------------------
# color space helpers
# --------------------------------------------------------------------------


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    rng = maxc - minc
    one = torch.ones_like(rng)
    safe_rng = torch.where(rng > 0, rng, one)
    s = torch.where(maxc > 0, rng / torch.where(maxc > 0, maxc, one), torch.zeros_like(rng))
    rc = (maxc - r) / safe_rng
    gc = (maxc - g) / safe_rng
    bc = (maxc - b) / safe_rng
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(c0, c1, c2, c3, c4, c5):
        out = c5
        for idx, c in ((4, c4), (3, c3), (2, c2), (1, c1), (0, c0)):
            out = torch.where(i == idx, c, out)
        return out

    r = pick(v, q, p, p, t, v)
    g = pick(t, v, v, q, p, p)
    b = pick(p, p, t, v, v, q)
    return torch.stack([r, g, b], dim=-1)


# --------------------------------------------------------------------------
# the draws
# --------------------------------------------------------------------------

# per example: rescale, x, flip, blur, k, color, its choice and value,
# noise, its choice and value; then the rescale's scale and the window's y
_N_UNIFORM, _N_NORMAL = 11, 2


def draw_batch(gen: torch.Generator, n: int, cropper: Optional["ImageCropper"],
               augment_on: bool) -> List[Dict]:
    """Every random value of an n-example batch's preprocessing, from the CPU
    generator ``gen``, as Python values: a dict per example with ``crop``
    (``ImageCropper.window`` of the draws, or None without a cropper) and
    ``augment`` (the argument of ``augment``, or None when off).  The
    generator advances by the same amount whatever is chosen."""
    u = torch.rand((n, _N_UNIFORM), generator=gen, dtype=torch.float64).numpy()
    z = torch.randn((n, _N_NORMAL), generator=gen, dtype=torch.float64).numpy()
    seeds = torch.randint(0, 2**62, (n,), generator=gen, dtype=torch.int64).tolist()
    out = []
    for i in range(n):
        ui = [float(v) for v in u[i]]
        crop = cropper.window(ui[0] < 0.33, z[i, 0], z[i, 1], ui[1]) if cropper else None
        aug = None
        if augment_on:
            color_choice = min(int(ui[6] * 3), 2)
            noise_choice = min(int(ui[9] * 3), 2)
            aug = {
                "flip": ui[2] < 0.5,
                "blur": (2 if ui[4] < 0.5 else 3) if ui[3] < 0.05 else None,
                "color": (color_choice, _color_value(color_choice, ui[7]))
                if ui[5] < 0.05 else None,
                "noise": (noise_choice, _noise_value(noise_choice, ui[10]), seeds[i])
                if ui[8] < 0.05 else None,
            }
        out.append({"crop": crop, "augment": aug})
    return out


def _color_value(choice: int, u: float) -> float:
    """Saturation factor in [0.5, 1.5), else a brightness or hue delta in
    [-0.2, 0.2)."""
    return 0.5 + u if choice == 0 else -0.2 + 0.4 * u


def _noise_value(choice: int, u: float) -> float:
    """Salt-and-pepper amount in [0.0005, 0.008), else Gaussian sigma in
    [0.001, 0.05)."""
    return 0.0005 + 0.0075 * u if choice < 2 else 0.001 + 0.049 * u


def noise_fields(choice: int, shape, seed: int, device) -> Tuple[torch.Tensor, ...]:
    """The full-size random fields of one noise draw, made on ``device``:
    salt and pepper uniforms of the image's shape (colored) or of its (H, W)
    (gray), or one standard normal of the image's shape (Gaussian)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if choice == 2:
        return (torch.randn(shape, generator=gen, device=device),)
    hw = tuple(shape) if choice == 0 else tuple(shape[:2])
    return (torch.rand(hw, generator=gen, device=device),
            torch.rand(hw, generator=gen, device=device))


# --------------------------------------------------------------------------
# individual augmentations (one (H, W, 3) float32 image)
# --------------------------------------------------------------------------


def flip_lr(img: torch.Tensor, bbox: torch.Tensor):
    """Horizontal flip; bbox [ymin,xmin,ymax,xmax] -> xmin' = 1 - xmax."""
    img = torch.flip(img, dims=(1,))
    bbox = torch.stack([bbox[:, 0], 1.0 - bbox[:, 3], bbox[:, 2], 1.0 - bbox[:, 1]], dim=1)
    return img, bbox


def _box_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """Depthwise k x k box filter, SAME zero padding, as k^2 shift-adds in
    the JAX package's order."""
    h, w, _ = img.shape
    lo, hi = (k - 1) // 2, k // 2  # TF 'SAME' padding split
    x = F.pad(img, (0, 0, lo, hi, lo, hi))
    acc = None
    for dy in range(k):
        for dx in range(k):
            window = x[dy:dy + h, dx:dx + w]
            acc = window if acc is None else acc + window
    return acc / float(k * k)


def color_augment(img: torch.Tensor, choice: int, value: float) -> torch.Tensor:
    """choice 0: saturation times ``value``; 1: brightness plus ``value``
    (not clipped); 2: hue plus ``value``.  Saturation and hue share one
    rgb -> hsv -> rgb round trip, the other's adjustment the identity
    (clip of s * 1, hue + 0 mod 1), as in the JAX package."""
    if choice == 1:
        return img + value
    factor = value if choice == 0 else 1.0
    hue_delta = value if choice == 2 else 0.0
    h, s, v = rgb_to_hsv(torch.clamp(img, 0.0, 1.0)).unbind(-1)
    s = torch.clamp(s * factor, 0.0, 1.0)
    h = torch.remainder(h + hue_delta, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def noise_augment(img: torch.Tensor, choice: int, value: float, fields) -> torch.Tensor:
    """choice 0: colored salt and pepper (``fields`` = the salt and pepper
    uniforms of the image's shape, ``value`` the amount); 1: gray salt and
    pepper ((H, W) uniforms; salt and pepper on one pixel cancel); 2:
    additive Gaussian (``fields`` = one standard normal, ``value`` sigma)."""
    if choice == 2:
        return img + value * fields[0]
    salt, pepper = fields[0] < value, fields[1] < value
    if choice == 0:
        zero, one = torch.zeros((), device=img.device), torch.ones((), device=img.device)
        return torch.where(pepper, zero, torch.where(salt, one, img))
    delta = salt.to(img.dtype) - pepper.to(img.dtype)
    return torch.clamp(img + delta[..., None], 0.0, 1.0)


def augment(img: torch.Tensor, bbox: torch.Tensor, label: torch.Tensor, draws: Dict):
    """The augmentation chain on one example: flip, blur, color, noise, each
    as ``draws`` (one entry of ``draw_batch``'s ``augment``) says.  A noise
    draw carries its fields' seed, or the ``fields`` themselves."""
    if draws["flip"]:
        img, bbox = flip_lr(img, bbox)
    if draws["blur"] is not None:
        img = _box_blur(img, draws["blur"])
    if draws["color"] is not None:
        img = color_augment(img, *draws["color"])
    if draws["noise"] is not None:
        choice, value, fields = draws["noise"]
        if isinstance(fields, int):
            fields = noise_fields(choice, img.shape, fields, img.device)
        img = noise_augment(img, choice, value, fields)
    return img, bbox, label


# --------------------------------------------------------------------------
# cropping
# --------------------------------------------------------------------------


def crop_boxes(bbox: torch.Tensor, valid: torch.Tensor, y_min, x_min, y_max, x_max,
               thresh: float = 0.25):
    """Clip padded boxes to a window; invalidate boxes keeping < 25% area.

    The bounds are ``np.float32`` (a random window: the extents are taken in
    float32) or Python floats (the center crop: in float64, rounded once).
    """
    y0, x0, y1, x1 = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    areas = (y1 - y0) * (x1 - x0)
    y0c = torch.clamp(y0, float(y_min), float(y_max))
    y1c = torch.clamp(y1, float(y_min), float(y_max))
    x0c = torch.clamp(x0, float(x_min), float(x_max))
    x1c = torch.clamp(x1, float(x_min), float(x_max))
    dy, dx = float(y_max - y_min), float(x_max - x_min)
    clipped = torch.stack(
        [(y0c - float(y_min)) / dy, (x0c - float(x_min)) / dx,
         (y1c - float(y_min)) / dy, (x1c - float(x_min)) / dx], dim=1)
    areas_c = (y1c - y0c) * (x1c - x0c)
    keep = valid & (areas_c / torch.where(areas > 0, areas, torch.ones_like(areas)) > thresh) \
        & (areas > 0)
    return clipped, keep


@dataclasses.dataclass(frozen=True)
class ImageCropper:
    """Crop policies.  The random crops take the window of ``window``."""

    full_img_size: Tuple[int, int, int]
    crop_img_size: Tuple[int, int, int]

    def __post_init__(self):
        fh, fw = self.full_img_size[:2]
        ch, cw = self.crop_img_size[:2]
        if fw / float(fh) != cw / float(ch):
            raise ValueError("invalid crop aspect ratio, must match the full image")

    def window(self, rescale: bool, z_scale: float, z_y: float, u_x: float) -> Dict:
        """The crop window of one example from its draws: ``rescale`` (the
        33% branch), two standard normals and a uniform in [0, 1).  Returns
        ``{"rescale", "y", "x", "h", "w"}`` (Python ints), the extents in
        float32 as the JAX package takes them."""
        ch, cw = self.crop_img_size[:2]
        fh, fw = self.full_img_size[:2]
        if rescale:
            scale = np.clip(F32(z_scale) * F32(0.5), F32(-0.7), F32(0.7))
            crop_h = int(min((F32(1.0) + scale) * F32(ch), F32(fh)))
            crop_w = int(min((F32(1.0) + scale) * F32(cw), F32(fw)))
        else:
            crop_h, crop_w = ch, cw
        y_maxval = F32(fh - crop_h)
        y = F32(z_y) * (y_maxval / F32(4.0)) + y_maxval / F32(2.0)
        y = int(np.clip(y, F32(0.0), y_maxval))
        span = fw - crop_w + 1
        x = min(int(u_x * span), span - 1)
        return {"rescale": bool(rescale), "y": y, "x": x, "h": crop_h, "w": crop_w}

    def random_crop(self, img, bbox, valid, y: int, x: int):
        ch, cw = self.crop_img_size[:2]
        fh, fw = self.full_img_size[:2]
        out = img[y:y + ch, x:x + cw]
        y_min, x_min = F32(y) / F32(fh), F32(x) / F32(fw)
        bbox, valid = crop_boxes(bbox, valid, y_min, x_min,
                                 y_min + F32(ch / fh), x_min + F32(cw / fw))
        return out, bbox, valid

    def random_crop_with_rescale(self, img, bbox, valid, y: int, x: int, crop_h: int,
                                 crop_w: int):
        """The window [y, y+crop_h) x [x, x+crop_w) resampled bilinearly to
        the crop size."""
        ch, cw = self.crop_img_size[:2]
        fh, fw = self.full_img_size[:2]
        out = _bilinear_window_resample(img, y, x, crop_h, crop_w, (ch, cw))
        y_min, x_min = F32(y) / F32(fh), F32(x) / F32(fw)
        bbox, valid = crop_boxes(bbox, valid, y_min, x_min,
                                 y_min + F32(crop_h) / F32(fh), x_min + F32(crop_w) / F32(fw))
        return out, bbox, valid

    def random_crop_and_sometimes_rescale(self, img, bbox, valid, window: Dict):
        """The rescaled crop when ``window["rescale"]`` (33% of draws), else
        the plain random crop."""
        if window["rescale"]:
            return self.random_crop_with_rescale(img, bbox, valid, window["y"], window["x"],
                                                 window["h"], window["w"])
        return self.random_crop(img, bbox, valid, window["y"], window["x"])

    def center_crop(self, img, bbox, valid):
        ch, cw = self.crop_img_size[:2]
        fh, fw = self.full_img_size[:2]
        y, x = (fh - ch) // 2, (fw - cw) // 2
        out = img[y:y + ch, x:x + cw]
        bbox, valid = crop_boxes(bbox, valid, y / fh, x / fw, (y + ch) / fh, (x + cw) / fw)
        return out, bbox, valid


def _hat_weights(src: torch.Tensor, n: int) -> torch.Tensor:
    """(len(src), n) two-tap bilinear weight rows: relu(1 - |i - src|), the
    sources clamped to [0, n-1]."""
    src = torch.clamp(src, 0.0, float(n - 1))
    idx = torch.arange(n, dtype=torch.float32, device=src.device)
    return torch.clamp(1.0 - torch.abs(idx[None, :] - src[:, None]), min=0.0)


def _bilinear_window_resample(img: torch.Tensor, y0: int, x0: int, win_h: int, win_w: int,
                              out_hw) -> torch.Tensor:
    """Sample an (out_h, out_w) grid bilinearly (half-pixel centers) from the
    window [y0:y0+win_h, x0:x0+win_w] of an (h, w, c) image: one float32
    product with the hat weights per axis, x then y."""
    oh, ow = out_hw
    h, w, c = img.shape
    dev = img.device
    sy = F32(win_h) / F32(oh)
    sx = F32(win_w) / F32(ow)
    yy = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * float(sy) - 0.5 + y0
    xx = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * float(sx) - 0.5 + x0
    wy = _hat_weights(yy, h)  # (oh, h)
    wx = _hat_weights(xx, w)  # (ow, w)
    _true_float32()
    # the x pass as one (h*c, w) x (w, ow) product: a batch of h products
    # with 3 rows each runs the card at a few percent of its rate
    rows = img.permute(0, 2, 1).reshape(h * c, w)
    tmp = torch.matmul(rows, wx.t())  # (h*c, ow)
    out = torch.matmul(wy, tmp.reshape(h, c * ow))  # (oh, c * ow): the y pass
    return out.reshape(oh, c, ow).permute(0, 2, 1)
