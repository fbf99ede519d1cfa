"""Image transforms of the port (counterpart of
multimodal_concept_learning_tpu/data/transforms.py), without Pillow.

Every transform of the JAX registry, on uint8 [H, W, 3] numpy arrays until
``ToTensor`` (float32 CHW in [0, 1]) and on float32 arrays after it
(``Normalize``, ``RandomErasing``).  Each draws the same random numbers from
the ``Compose``'s PCG64 generator, in the same order, as its JAX class, and
reproduces the arithmetic of the Pillow call that the JAX class makes:

- ``Resize`` / ``RandomResizedCrop``: ``Resample.c``'s antialiased bilinear
  resample (support scaled by the reduction, weights normalised in double
  and rounded to 22-bit integers, the horizontal pass first over only the
  rows the vertical pass reads, each pass rounded and clipped to uint8);
- rotate / affine / perspective: ``Geometry.c``'s bilinear sampling at
  pixel centres, 0 outside the image, the lerp in double then truncated;
- brightness / contrast / colour / sharpness: ``ImageEnhance`` through
  ``Image.blend`` (float32 alpha, truncation in [0, 1], clipping outside),
  the L conversion, the contrast mean and the ``SMOOTH`` 3x3 filter;
- hue: ``Convert.c``'s RGB <-> HSV with C's float/double promotions;
- autocontrast, equalize, posterize, solarize: ``ImageOps``' lookup tables.

``tests/test_torch_transforms.py`` holds each one to the JAX class bitwise.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Union

import numpy as np

_TransformSpec = Union[str, Dict[str, Any]]
_PRECISION_BITS = 22  # Resample.c: 32 - 8 - 2


def _as_tuple(value):
    return tuple(value) if isinstance(value, (list, tuple)) else value


# ---------------------------------------------------------------------------
# Pillow's arithmetic on uint8 [H, W, C] arrays
# ---------------------------------------------------------------------------


def _resample_coeffs(in_size: int, in0: float, in1: float, out_size: int):
    """Resample.c precompute_coeffs + normalize_coeffs_8bpc for the bilinear
    filter: (xmin [out], int32 weights [out, ksize], ksize)."""
    scale = float(np.float32(in1) - np.float32(in0)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = in0 + (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int) truncates
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):  # sequential sums, as the C loop adds them
        live = x < xmax
        w = np.abs(((x + xmin).astype(np.float64) - center + 0.5) * ss)
        w = np.where(live & (w < 1.0), 1.0 - w, 0.0)
        k[:, x] = w
        ww = ww + w
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    scaled = k * (1 << _PRECISION_BITS)
    kk = np.trunc(np.where(k < 0, -0.5 + scaled, 0.5 + scaled)).astype(np.int64)
    return xmin, kk, xmax


def _resample_axis(img: np.ndarray, axis: int, xmin, kk, xmax) -> np.ndarray:
    """One pass of ImagingResample{Horizontal,Vertical}_8bpc along ``axis``.
    The sums fit int32: weights are positive and add up to about 2**22."""
    src = np.moveaxis(img, axis, 0)  # [N, ..., C] uint8
    out = np.full((len(xmin),) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    shape = (-1,) + (1,) * (src.ndim - 1)
    for x in range(kk.shape[1]):
        weight = np.where(x < xmax, kk[:, x], 0).astype(np.int32).reshape(shape)
        out += src[np.minimum(xmin + x, src.shape[0] - 1)] * weight
    out = np.clip(out >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def resize(img: np.ndarray, size, box=None) -> np.ndarray:
    """``Image.resize(size=(w, h), BILINEAR, box)`` on a uint8 [H, W, C]."""
    h, w = img.shape[:2]
    out_w, out_h = size
    box = (0, 0, w, h) if box is None else tuple(box)
    if (out_w, out_h) == (w, h) and box == (0, 0, w, h):
        return img.copy()
    x0, y0, x1, y1 = (float(np.float32(v)) for v in box)
    need_h = out_w != w or x0 != 0 or x1 != out_w
    need_v = out_h != h or y0 != 0 or y1 != out_h
    ymin, ykk, ymax = _resample_coeffs(h, y0, y1, out_h)
    if need_h:
        first, last = int(ymin[0]), int(ymin[-1] + ymax[-1])
        xmin, xkk, xmax = _resample_coeffs(w, x0, x1, out_w)
        img = _resample_axis(img[first:last], 1, xmin, xkk, xmax)
        ymin = ymin - first
    if need_v:
        img = _resample_axis(img, 0, ymin, ykk, ymax)
    return img


def _sample_bilinear(img: np.ndarray, xin: np.ndarray, yin: np.ndarray) -> np.ndarray:
    """Geometry.c bilinear_filter32RGB at input points (xin, yin) [H, W],
    0 where the point falls outside [0, w) x [0, h)."""
    h, w = img.shape[:2]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xs = np.where(inside, xin, 0.5) - 0.5
    ys = np.where(inside, yin, 0.5) - 0.5
    xf = np.floor(xs)
    yf = np.floor(ys)
    dx = (xs - xf)[..., None]
    dy = (ys - yf)[..., None]
    xf = xf.astype(np.int64)
    yf = yf.astype(np.int64)
    cx0 = np.clip(xf, 0, w - 1)
    cx1 = np.clip(xf + 1, 0, w - 1)
    row0 = np.clip(yf, 0, h - 1) * w
    has_row1 = (yf + 1 >= 0) & (yf + 1 < h)
    row1 = np.where(has_row1, np.clip(yf + 1, 0, h - 1) * w, row0)
    flat = img.reshape(h * w, -1)
    a, b = flat[row0 + cx0].astype(np.float64), flat[row0 + cx1].astype(np.float64)
    v1 = a + (b - a) * dx
    c, d = flat[row1 + cx0].astype(np.float64), flat[row1 + cx1].astype(np.float64)
    v2 = c + (d - c) * dx  # where row y + 1 is outside, row1 is row0: v2 == v1
    v = v1 + (v2 - v1) * dy
    out = v.astype(np.uint8)  # C's (UINT8) cast truncates a value in [0, 255]
    out[~inside] = 0
    return out


def _pixel_centres(w: int, h: int):
    y, x = np.mgrid[0:h, 0:w]
    return x.astype(np.float64) + 0.5, y.astype(np.float64) + 0.5


def affine(img: np.ndarray, matrix) -> np.ndarray:
    """``Image.transform(size, AFFINE, matrix, BILINEAR)`` at the same size."""
    a0, a1, a2, a3, a4, a5 = (float(v) for v in matrix[:6])
    h, w = img.shape[:2]
    xin, yin = _pixel_centres(w, h)
    return _sample_bilinear(img, a0 * xin + a1 * yin + a2, a3 * xin + a4 * yin + a5)


def perspective(img: np.ndarray, coeffs) -> np.ndarray:
    """``Image.transform(size, PERSPECTIVE, coeffs, BILINEAR)`` at the same size."""
    a0, a1, a2, a3, a4, a5, a6, a7 = (float(v) for v in coeffs[:8])
    h, w = img.shape[:2]
    xin, yin = _pixel_centres(w, h)
    den = a6 * xin + a7 * yin + 1
    return _sample_bilinear(img, (a0 * xin + a1 * yin + a2) / den,
                            (a3 * xin + a4 * yin + a5) / den)


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """``Image.rotate(angle, resample=BILINEAR)`` (about the centre, no expand)."""
    angle = angle % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    center = (w / 2, h / 2)
    rad = -math.radians(angle)
    matrix = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
              round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    a, b, _, d, e, _ = matrix
    x, y = -center[0] - 0, -center[1] - 0
    matrix[2], matrix[5] = a * x + b * y + 0.0, d * x + e * y + 0.0
    matrix[2] += center[0]
    matrix[5] += center[1]
    return affine(img, matrix)


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(im1, im2, alpha)``: a float32 lerp, truncated."""
    a = np.float32(alpha)
    if a == 0.0:
        return im1.copy()
    if a == 1.0:
        return im2.copy()
    base = im1.astype(np.float32)
    value = base + a * (im2.astype(np.float32) - base)
    if 0.0 <= a <= 1.0:
        return value.astype(np.uint8)
    return np.where(value <= 0.0, 0, np.where(value >= 255.0, 255, value)).astype(np.uint8)


def to_luma(img: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    c = img.astype(np.int64)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def enhance_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return blend(np.zeros_like(img), img, factor)


def enhance_color(img: np.ndarray, factor: float) -> np.ndarray:
    gray = np.repeat(to_luma(img)[..., None], img.shape[2], axis=2)
    return blend(gray, img, factor)


def enhance_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    hist = np.bincount(to_luma(img).ravel(), minlength=256)
    mean = float(np.dot(np.arange(256, dtype=np.float64), hist)) / hist.sum()
    degenerate = np.full_like(img, int(mean + 0.5))
    return blend(degenerate, img, factor)


def smooth(img: np.ndarray) -> np.ndarray:
    """``img.filter(ImageFilter.SMOOTH)``: Filter.c's 3x3 kernel (1 1 1 /
    1 5 1 / 1 1 1) / 13, rounded to nearest, border pixels kept.  The
    integer form is Pillow's float32 sum exactly: a sum over 13 never lies
    within float32 error of a half."""
    h, w = img.shape[:2]
    out = img.copy()
    if h < 3 or w < 3:
        return out
    c = img.astype(np.int64)
    s = sum(c[dy:h - 2 + dy, dx:w - 2 + dx] for dy in range(3) for dx in range(3))
    s = s + 4 * c[1:-1, 1:-1]
    out[1:-1, 1:-1] = np.clip((s + 6) // 13, 0, 255).astype(np.uint8)
    return out


def enhance_sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    return blend(smooth(img), img, factor)


def _clip8(x):
    return np.clip(x, 0, 255)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C ``round`` for x >= 0 (numpy's rounds half to even)."""
    fl = np.floor(x)
    return fl + (x - fl >= 0.5)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Convert.c rgb2hsv_row: float32 variables, C's double promotions."""
    f32, f64 = np.float32, np.float64
    c = img.astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    flat = maxc == minc
    cr = (maxc - minc).astype(f32)
    cr_safe = np.where(flat, f32(1), cr)
    s = cr / np.where(maxc == 0, 1, maxc).astype(f32)
    rc = (maxc - r).astype(f32) / cr_safe
    gc = (maxc - g).astype(f32) / cr_safe
    bc = (maxc - b).astype(f32) / cr_safe
    h = np.where(r == maxc, (bc - gc).astype(f32),
                 np.where(g == maxc, (2.0 + rc.astype(f64) - bc.astype(f64)).astype(f32),
                          (4.0 + gc.astype(f64) - rc.astype(f64)).astype(f32)))
    h = np.fmod(h.astype(f64) / 6.0 + 1.0, 1.0).astype(f32)
    uh = _clip8(np.trunc(h.astype(f64) * 255.0).astype(np.int64))
    us = _clip8(np.trunc(s.astype(f64) * 255.0).astype(np.int64))
    out = np.stack([np.where(flat, 0, uh), np.where(flat, 0, us), maxc], axis=-1)
    return out.astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Convert.c hsv2rgb: float32 variables, C's double promotions."""
    f32, f64 = np.float32, np.float64
    c = hsv.astype(np.int64)
    h, s, v = c[..., 0], c[..., 1], c[..., 2]
    scaled = h.astype(f32).astype(f64) * 6.0 / 255.0
    i = np.floor(scaled).astype(np.int64)
    f = (scaled - i.astype(f32).astype(f64)).astype(f32)
    fs = (s.astype(f32).astype(f64) / 255.0).astype(f32)
    vv = v.astype(f32).astype(f64)
    p = _clip8(_round_half_away(vv * (1.0 - fs.astype(f64))).astype(np.int64))
    q = _clip8(_round_half_away(vv * (1.0 - (fs * f).astype(f64))).astype(np.int64))
    t = _clip8(_round_half_away(vv * (1.0 - fs.astype(f64) * (1.0 - f.astype(f64))))
               .astype(np.int64))
    sector = i % 6
    choices = [np.stack(ch, axis=-1) for ch in
               ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))]
    out = np.select([(sector == k)[..., None] for k in range(6)], choices)
    out = np.where((s == 0)[..., None], np.stack([v, v, v], axis=-1), out)
    return out.astype(np.uint8)


def _apply_lut(img: np.ndarray, luts) -> np.ndarray:
    """``image.point(lut)``: one 256-entry table per channel, each entry
    clipped to 0..255 as Pillow stores it."""
    out = np.empty_like(img)
    for ch, lut in enumerate(luts):
        out[..., ch] = np.clip(np.asarray(lut, np.int64), 0, 255).astype(np.uint8)[img[..., ch]]
    return out


def _histograms(img: np.ndarray):
    return [np.bincount(img[..., ch].ravel(), minlength=256).tolist()
            for ch in range(img.shape[2])]


def autocontrast(img: np.ndarray) -> np.ndarray:
    """``ImageOps.autocontrast(img)`` (cutoff 0)."""
    luts = []
    for h in _histograms(img):
        lo = next((i for i in range(256) if h[i]), 255)
        hi = next((i for i in range(255, -1, -1) if h[i]), 0)
        if hi <= lo:
            luts.append(list(range(256)))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append([min(max(int(ix * scale + offset), 0), 255) for ix in range(256)])
    return _apply_lut(img, luts)


def equalize(img: np.ndarray) -> np.ndarray:
    """``ImageOps.equalize(img)``."""
    luts = []
    for h in _histograms(img):
        histo = [v for v in h if v]
        if len(histo) <= 1:
            luts.append(list(range(256)))
            continue
        step = (sum(histo) - histo[-1]) // 255
        if not step:
            luts.append(list(range(256)))
            continue
        lut, n = [], step // 2
        for i in range(256):
            lut.append(n // step)
            n = n + h[i]
        luts.append(lut)
    return _apply_lut(img, luts)


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    mask = ~(2 ** (8 - bits) - 1)
    return _apply_lut(img, [[i & mask for i in range(256)]] * img.shape[2])


def solarize(img: np.ndarray, threshold: int) -> np.ndarray:
    return _apply_lut(img, [[i if i < threshold else 255 - i for i in range(256)]]
                      * img.shape[2])


# ---------------------------------------------------------------------------
# Individual transforms.  Each is a callable (img, rng) -> img, split in two
# so a loader can draw in sample order and apply in parallel:
# ``draw(shape, rng) -> (plan, output shape)`` makes every random draw (they
# depend on the image's shape alone), ``apply(img, plan)`` the pixels.
# ---------------------------------------------------------------------------


class _Transform:
    def draw(self, shape, rng):
        return None, shape

    def apply(self, img, plan):
        raise NotImplementedError

    def __call__(self, img, rng):
        return self.apply(img, self.draw(np.shape(img), rng)[0])


class Resize(_Transform):
    """Int size -> resize the shorter side keeping the aspect; a pair -> exact."""

    def __init__(self, size):
        self.size = size

    def draw(self, shape, rng):
        h, w = shape[:2]
        if isinstance(self.size, int):
            short, long = (w, h) if w <= h else (h, w)
            new_long = int(round(self.size * long / short))
            new_w, new_h = (self.size, new_long) if w <= h else (new_long, self.size)
        else:
            new_h, new_w = self.size if len(self.size) == 2 else (self.size[0], self.size[0])
        return (new_w, new_h), (new_h, new_w) + tuple(shape[2:])

    def apply(self, img, plan):
        return resize(img, plan)


class RandomResizedCrop(_Transform):
    """torchvision's sampling: 10 attempts over (area scale, log ratio),
    centre-crop fallback; the box resampled to ``size``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0)):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)

    def _box(self, w, h, rng):
        area = w * h
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = int(rng.integers(0, w - cw + 1))
                top = int(rng.integers(0, h - ch + 1))
                return left, top, left + cw, top + ch
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            cw, ch = int(round(h * self.ratio[1])), h
        else:
            cw, ch = w, h
        left, top = (w - cw) // 2, (h - ch) // 2
        return left, top, left + cw, top + ch

    def draw(self, shape, rng):
        h, w = shape[:2]
        return self._box(w, h, rng), self.size + tuple(shape[2:])

    def apply(self, img, plan):
        return resize(img, self.size[::-1], box=plan)


class RandomHorizontalFlip(_Transform):
    def __init__(self, p=0.5):
        self.p = p

    def draw(self, shape, rng):
        return rng.random() < self.p, shape

    def apply(self, img, plan):
        return np.ascontiguousarray(img[:, ::-1]) if plan else img


class ColorJitter(_Transform):
    """torchvision semantics: factors drawn in [max(0, 1-x), 1+x] (hue in
    [-hue, hue]), applied in a random order."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _adjust_hue(img, factor):
        if factor == 0:
            return img
        hsv = rgb_to_hsv(img).astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(round(factor * 255))) % 256
        return hsv_to_rgb(hsv.astype(np.uint8))

    def draw(self, shape, rng):
        ops = []
        if self.brightness:
            ops.append((enhance_brightness, rng.uniform(max(0.0, 1 - self.brightness),
                                                        1 + self.brightness)))
        if self.contrast:
            ops.append((enhance_contrast, rng.uniform(max(0.0, 1 - self.contrast),
                                                      1 + self.contrast)))
        if self.saturation:
            ops.append((enhance_color, rng.uniform(max(0.0, 1 - self.saturation),
                                                   1 + self.saturation)))
        if self.hue:
            ops.append((self._adjust_hue, rng.uniform(-self.hue, self.hue)))
        return [ops[i] for i in rng.permutation(len(ops))], shape

    def apply(self, img, plan):
        for op, factor in plan:
            img = op(img, factor)
        return img


class RandomRotation(_Transform):
    def __init__(self, degrees=15):
        self.degrees = ((-degrees, degrees) if not isinstance(degrees, (tuple, list))
                        else tuple(degrees))

    def draw(self, shape, rng):
        return rng.uniform(*self.degrees), shape

    def apply(self, img, plan):
        return rotate(img, plan)


class RandomAffine(_Transform):
    def __init__(self, degrees=0, translate=(0.1, 0.1), scale=(0.9, 1.1), shear=0):
        self.degrees = ((-degrees, degrees) if not isinstance(degrees, (tuple, list))
                        else tuple(degrees))
        self.translate = tuple(translate) if translate else None
        self.scale = tuple(scale) if scale else None
        self.shear = (-shear, shear) if not isinstance(shear, (tuple, list)) else tuple(shear)

    def draw(self, shape, rng):
        h, w = shape[:2]
        angle = math.radians(rng.uniform(*self.degrees))
        if self.translate is not None:
            tx = rng.uniform(-self.translate[0], self.translate[0]) * w
            ty = rng.uniform(-self.translate[1], self.translate[1]) * h
        else:
            tx = ty = 0.0
        s = rng.uniform(*self.scale) if self.scale is not None else 1.0
        shear_x = math.radians(rng.uniform(*self.shear)) if self.shear != (0, 0) else 0.0
        # the inverse of s * R(angle) @ ShearX(shear_x) + translate, about the centre
        cx, cy = w / 2, h / 2
        cos_a, sin_a = math.cos(angle), math.sin(angle)
        tan_s = math.tan(shear_x)
        a = s * cos_a
        b = s * (cos_a * tan_s - sin_a)
        d = s * sin_a
        e = s * (sin_a * tan_s + cos_a)
        det = a * e - b * d
        ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
        ox, oy = cx + tx, cy + ty
        c = cx - ia * ox - ib * oy
        f = cy - id_ * ox - ie * oy
        return (ia, ib, c, id_, ie, f), shape

    def apply(self, img, plan):
        return affine(img, plan)


class RandomPerspective(_Transform):
    def __init__(self, distortion_scale=0.2, p=0.5):
        self.distortion_scale = distortion_scale
        self.p = p

    def draw(self, shape, rng):
        if rng.random() >= self.p:
            return None, shape
        h, w = shape[:2]
        d = self.distortion_scale
        half_w, half_h = int(d * w / 2), int(d * h / 2)

        def j(maxv):
            return int(rng.integers(0, maxv + 1)) if maxv > 0 else 0

        tl = (j(half_w), j(half_h))
        tr = (w - 1 - j(half_w), j(half_h))
        br = (w - 1 - j(half_w), h - 1 - j(half_h))
        bl = (j(half_w), h - 1 - j(half_h))
        src = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        return _perspective_coeffs([tl, tr, br, bl], src), shape

    def apply(self, img, plan):
        return img if plan is None else perspective(img, plan)


def _perspective_coeffs(src_pts, dst_pts):
    """The 8 coefficients mapping output -> input (Pillow's convention)."""
    a, b = [], []
    for (sx, sy), (dx, dy) in zip(src_pts, dst_pts):
        a.append([sx, sy, 1, 0, 0, 0, -dx * sx, -dx * sy])
        a.append([0, 0, 0, sx, sy, 1, -dy * sx, -dy * sy])
        b.extend([dx, dy])
    return np.linalg.solve(np.asarray(a, dtype=np.float64),
                           np.asarray(b, dtype=np.float64)).tolist()


def _require_tensor(x, name: str) -> None:
    if not (isinstance(x, np.ndarray) and x.dtype == np.float32):
        raise TypeError(f"{name} must come after ToTensor")


class RandomErasing(_Transform):
    """Tensor-space erase (after ToTensor), torchvision defaults."""

    def __init__(self, p=0.25, scale=(0.02, 0.33), ratio=(0.3, 3.3), value=0.0):
        self.p = p
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.value = value

    def __call__(self, x, rng):
        _require_tensor(x, "RandomErasing")
        return super().__call__(x, rng)

    def draw(self, shape, rng):
        if rng.random() >= self.p:
            return None, shape
        _, h, w = shape
        area = h * w
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target = area * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            eh = int(round(math.sqrt(target * aspect)))
            ew = int(round(math.sqrt(target / aspect)))
            if eh < h and ew < w:
                top = int(rng.integers(0, h - eh + 1))
                left = int(rng.integers(0, w - ew + 1))
                return (top, left, eh, ew), shape
        return None, shape

    def apply(self, x, plan):
        _require_tensor(x, "RandomErasing")
        if plan is None:
            return x
        top, left, eh, ew = plan
        x = x.copy()
        x[:, top:top + eh, left:left + ew] = self.value
        return x


RAND_AUGMENT_OPS = (
    "Identity", "AutoContrast", "Equalize", "Rotate", "Solarize",
    "Color", "Posterize", "Contrast", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateX", "TranslateY",
)


class RandAugment(_Transform):
    """``num_ops`` random ops at a shared magnitude (torchvision's catalog)."""

    def __init__(self, num_ops=2, magnitude=10, num_magnitude_bins=31):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.bins = num_magnitude_bins

    def _mag(self, lo, hi):
        return lo + (hi - lo) * self.magnitude / (self.bins - 1)

    def draw(self, shape, rng):
        plan = []
        for _ in range(self.num_ops):
            op = RAND_AUGMENT_OPS[int(rng.integers(0, len(RAND_AUGMENT_OPS)))]
            plan.append((op, -1.0 if rng.random() < 0.5 else 1.0))
        return plan, shape

    def apply(self, img, plan):
        for op, sign in plan:
            img = self._apply(img, op, sign)
        return img

    def _apply(self, img, op, sign):
        h, w = img.shape[:2]
        if op == "Identity":
            return img
        if op == "AutoContrast":
            return autocontrast(img)
        if op == "Equalize":
            return equalize(img)
        if op == "Rotate":
            return rotate(img, sign * self._mag(0.0, 30.0))
        if op == "Solarize":
            return solarize(img, int(self._mag(255.0, 0.0)))
        if op == "Color":
            return enhance_color(img, 1.0 + sign * self._mag(0.0, 0.9))
        if op == "Posterize":
            return posterize(img, max(1, int(8 - self._mag(0.0, 4.0))))
        if op == "Contrast":
            return enhance_contrast(img, 1.0 + sign * self._mag(0.0, 0.9))
        if op == "Brightness":
            return enhance_brightness(img, 1.0 + sign * self._mag(0.0, 0.9))
        if op == "Sharpness":
            return enhance_sharpness(img, 1.0 + sign * self._mag(0.0, 0.9))
        if op == "ShearX":
            return affine(img, (1, sign * self._mag(0.0, 0.3), 0, 0, 1, 0))
        if op == "ShearY":
            return affine(img, (1, 0, 0, sign * self._mag(0.0, 0.3), 1, 0))
        if op == "TranslateX":
            return affine(img, (1, 0, sign * self._mag(0.0, 150.0 / 331.0) * w, 0, 1, 0))
        if op == "TranslateY":
            return affine(img, (1, 0, 0, 0, 1, sign * self._mag(0.0, 150.0 / 331.0) * h))
        return img


class ToTensor(_Transform):
    """uint8 [H, W, C] -> float32 [C, H, W] in [0, 1]."""

    def draw(self, shape, rng):
        shape = tuple(shape) + (1,) * (3 - len(shape))
        return None, (shape[2], shape[0], shape[1])

    def apply(self, img, plan):
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.ascontiguousarray(arr.transpose(2, 0, 1))


class Normalize(_Transform):
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, dtype=np.float32).reshape(-1, 1, 1)

    def apply(self, x, plan):
        _require_tensor(x, "Normalize")
        return (x - self.mean) / self.std


class Compose:
    """Sequential pipeline owning its random generator.

    Called as ``t(img)`` (the owned generator) or ``t(img, rng)``; or in two
    steps, ``plans = t.draw(img.shape)`` then ``t.apply(img, plans)``, which
    make the same draws and the same pixels.
    """

    def __init__(self, transforms_list, seed: int = 0):
        self.transforms = transforms_list
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def __call__(self, img, rng=None):
        rng = rng if rng is not None else self.rng
        for t in self.transforms:
            img = t(img, rng)
        return img

    def draw(self, shape, rng=None) -> list:
        """Every random draw of one image of ``shape``, in order."""
        rng = rng if rng is not None else self.rng
        plans = []
        for t in self.transforms:
            plan, shape = t.draw(shape, rng)
            plans.append(plan)
        return plans

    def apply(self, img, plans: list):
        for t, plan in zip(self.transforms, plans):
            img = t.apply(img, plan)
        return img

    def uint8_spec(self):
        """(mean, std) float32 [3] when the pipeline is ToTensor [+ Normalize],
        so the device can normalise uint8 images itself; else None."""
        seq = self.transforms
        if not seq or not isinstance(seq[0], ToTensor) or len(seq) > 2:
            return None
        if len(seq) == 1:
            return np.zeros(3, np.float32), np.ones(3, np.float32)
        if not isinstance(seq[1], Normalize):
            return None
        return seq[1].mean.reshape(-1), seq[1].std.reshape(-1)


# ---------------------------------------------------------------------------
# Registry: the JAX package's table of classes, its per-class defaults (the
# constructors' signatures) and its config-derived values.
# ---------------------------------------------------------------------------

_TRANSFORM_CLASSES = {
    cls.__name__: cls
    for cls in (
        Resize, RandomResizedCrop, RandomHorizontalFlip, ColorJitter,
        RandomRotation, RandomAffine, RandomPerspective, RandomErasing,
        RandAugment, ToTensor, Normalize,
    )
}

_NORM_STATS_BY_DATASET = {
    name: ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
    for name in ("imagenet", "imagenet100", "imagenet_multimodal")
}
_NORM_STATS_FALLBACK = ([0.5, 0.5, 0.5], [0.5, 0.5, 0.5])

_SIZE_FROM_CONFIG = ("Resize", "RandomResizedCrop")


def _fill_config_defaults(name: str, config, kwargs: Dict[str, Any]) -> None:
    """Config-derived values for the parameters the YAML spec left out."""
    if name in _SIZE_FROM_CONFIG and "size" not in kwargs:
        kwargs["size"] = getattr(config, "image_size", 224)
    if name == "Normalize":
        mean = kwargs.get("mean", getattr(config, "normalize_mean", None))
        std = kwargs.get("std", getattr(config, "normalize_std", None))
        if mean is None or std is None:  # both from the dataset table, never mixed
            mean, std = _NORM_STATS_BY_DATASET.get(getattr(config, "dataset_name", None),
                                                   _NORM_STATS_FALLBACK)
        kwargs["mean"], kwargs["std"] = mean, std


def _instantiate(name: str, config, params: Dict[str, Any]):
    cls = _TRANSFORM_CLASSES.get(name)
    if cls is None:
        raise ValueError(f"Unknown transform: {name}")
    accepted = inspect.signature(cls.__init__).parameters
    kwargs = {k: _as_tuple(v) for k, v in params.items() if k in accepted and v is not None}
    _fill_config_defaults(name, config, kwargs)
    return cls(**kwargs)


def _parse_spec(entry: _TransformSpec):
    if isinstance(entry, str):
        return entry, {}
    if isinstance(entry, dict):
        if not entry.get("name"):
            raise ValueError("Transform dict entries must include a 'name' key.")
        return entry["name"], {k: v for k, v in entry.items() if k != "name"}
    raise TypeError("Transform entries must be either strings or dictionaries with a 'name' key.")


def create_transforms(config, is_train: bool = True, seed: int = 0) -> Compose:
    """The config's ``train_transforms`` / ``val_transforms`` pipeline, with
    ``transform_params`` overrides under inline dict keys."""
    entries = getattr(config, "train_transforms" if is_train else "val_transforms", None)
    if not entries:
        raise ValueError("Transform list is empty or undefined in config.")
    shared = getattr(config, "transform_params", {}) or {}
    built = []
    for entry in entries:
        name, inline = _parse_spec(entry)
        built.append(_instantiate(name, config, {**shared.get(name, {}), **inline}))
    return Compose(built, seed=seed)


__all__ = [
    "ColorJitter", "Compose", "Normalize", "RandAugment", "RandomAffine", "RandomErasing",
    "RandomHorizontalFlip", "RandomPerspective", "RandomResizedCrop", "RandomRotation",
    "Resize", "ToTensor", "create_transforms",
]
