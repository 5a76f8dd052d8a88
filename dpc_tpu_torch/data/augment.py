"""The host augmentation of the frame pipeline (a numpy copy of
``dpc_tpu/data/augment.py``), over uint8 clips ``[T, H, W, C]``:
``Compose``, ``Padding``, ``Scale``, ``CenterCrop``, ``RandomCrop``,
``RandomCropWithProb``, ``RandomSizedCrop``, ``RandomHorizontalFlip``,
``RandomGray``, ``ColorJitter``, ``Normalize`` and the pretrain and
finetune recipes.

The draws, their order and the geometry are those of the JAX package
(reference ``utils/augmentation.py``), so a clip sampled with the same
``np.random.Generator`` is the same clip.  OpenCV is not used: the resizes
follow its pixel-centre conventions (``INTER_LINEAR`` / ``INTER_NEAREST``),
``cv2.LUT`` is a numpy gather, and the hue shift rewrites OpenCV's uint8
``COLOR_RGB2HSV_FULL`` / ``COLOR_HSV2RGB_FULL`` round trip (fixed-point
forward, float32 back).  The bilinear blend and the float32 hue sector may
round one grey level the other way.  Also ``FiveCrop``, ``PadTo`` and
``PerCrop`` (the five-crop dense test) and ``HostScaleCrop``, the host half
of ``--device_augment``, which the JPEG codec can execute inside the decode
(``native.decode_jpeg_batch_scale_crop``).  ``RandomRotation`` and
``RandomCrop``'s optical-flow proposals, which no recipe uses, are here
too: the rotation is OpenCV's ``warpAffine`` written as a float64
inverse-map bilinear warp, within one grey level of it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _linear_taps(n_in: int, n_out: int):
    s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.clip(s, 0.0, n_in - 1)
    i0 = np.floor(s).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (s - i0).astype(np.float32)


def _resize_clip(clip: np.ndarray, size_wh: tuple[int, int],
                 interpolation: str) -> np.ndarray:
    t, h, w, c = clip.shape
    ow, oh = size_wh
    if interpolation == "nearest":
        ys = np.minimum((np.arange(oh) * (h / oh)).astype(np.int64), h - 1)
        xs = np.minimum((np.arange(ow) * (w / ow)).astype(np.int64), w - 1)
        return clip[:, ys][:, :, xs]
    if interpolation != "bilinear":
        raise ValueError(f"unknown interpolation {interpolation!r}")
    y0, y1, fy = _linear_taps(h, oh)
    x0, x1, fx = _linear_taps(w, ow)
    f = clip.astype(np.float32)
    fy = fy[None, :, None, None]
    rows = f[:, y0] * (1.0 - fy) + f[:, y1] * fy
    fx = fx[None, None, :, None]
    out = rows[:, :, x0] * (1.0 - fx) + rows[:, :, x1] * fx
    if clip.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(clip.dtype)


class Compose:
    def __init__(self, ops: Sequence):
        self.ops = list(ops)

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        for op in self.ops:
            clip = op(clip, rng)
        return clip


def shortside_dims(h: int, w: int, s: int) -> tuple[int, int]:
    """Output (h, w) of a short-side-``s`` aspect-preserving resize
    (torchvision truncation semantics)."""
    if (w <= h and w == s) or (h <= w and h == s):
        return h, w
    if w < h:
        return int(s * h / w), s
    return s, int(s * w / h)


class Padding:
    def __init__(self, pad: int):
        self.pad = pad

    def __call__(self, clip, rng):
        p = self.pad
        return np.pad(clip, ((0, 0), (p, p), (p, p), (0, 0)))


class Scale:
    """Short-side resize (int size) or fixed (w, h) resize."""

    def __init__(self, size, interpolation: str = "nearest"):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, clip, rng):
        t, h, w, c = clip.shape
        if isinstance(self.size, int):
            oh, ow = shortside_dims(h, w, self.size)
            if (oh, ow) == (h, w):
                return clip
            return _resize_clip(clip, (ow, oh), self.interpolation)
        return _resize_clip(clip, tuple(self.size), self.interpolation)


def _crop(clip, y, x, th, tw):
    return clip[:, y: y + th, x: x + tw]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, (int, float)) else size

    def __call__(self, clip, rng):
        t, h, w, c = clip.shape
        th, tw = self.size
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        return _crop(clip, y1, x1, th, tw)


class RandomCrop:
    """Random crop: one window for the clip (``consistent``) or one per
    frame.  With a ``flowmap`` (``[T, H, W, ...]``, per-frame windows
    only), each frame draws ``num_proposals`` windows and keeps the first
    with the largest ``|mean(flow)|`` (the reference's optical-flow
    proposals, ``augmentation.py:126-137``)."""

    def __init__(self, size, consistent: bool = True, num_proposals: int = 3):
        self.size = (size, size) if isinstance(size, (int, float)) else size
        self.consistent = consistent
        self.num_proposals = num_proposals

    def __call__(self, clip, rng, flowmap=None):
        t, h, w, c = clip.shape
        th, tw = self.size
        if w == tw and h == th:
            return clip
        if flowmap is not None:
            assert not self.consistent
            out = np.empty((t, th, tw, c), clip.dtype)
            for i in range(t):
                best, best_mag = (0, 0), -1.0
                for _ in range(self.num_proposals):
                    x = int(rng.integers(0, w - tw + 1))
                    y = int(rng.integers(0, h - th + 1))
                    mag = abs(float(
                        np.mean(flowmap[i, y: y + th, x: x + tw])))
                    if mag > best_mag:
                        best, best_mag = (y, x), mag
                out[i] = clip[i, best[0]: best[0] + th,
                              best[1]: best[1] + tw]
            return out
        if self.consistent:
            x1 = int(rng.integers(0, w - tw + 1))
            y1 = int(rng.integers(0, h - th + 1))
            return _crop(clip, y1, x1, th, tw)
        out = np.empty((t, th, tw, c), clip.dtype)
        for i in range(t):
            x1 = int(rng.integers(0, w - tw + 1))
            y1 = int(rng.integers(0, h - th + 1))
            out[i] = clip[i, y1: y1 + th, x1: x1 + tw]
        return out


class FiveCrop:
    """The four corners and the centre → ``[5, T, size, size, C]`` (the
    eval dataset's five-crop test, ``eval/dataset_3d_lc.py:98-107``)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, (int, float)) else size

    def __call__(self, clip, rng=None):
        t, h, w, c = clip.shape
        th, tw = self.size
        if th > h or tw > w:
            raise ValueError(f"five crops of {self.size} from a "
                             f"{h}x{w} clip")
        cx = int(round((w - tw) / 2.0))
        cy = int(round((h - th) / 2.0))
        corners = [(0, 0), (0, w - tw), (h - th, 0), (h - th, w - tw),
                   (cy, cx)]
        return np.stack([_crop(clip, y, x, th, tw) for y, x in corners])


class PadTo:
    """Reflect-pad so the clip is at least (min_h, min_w): a safety net
    ahead of fixed-size crops for portrait videos."""

    def __init__(self, min_h: int, min_w: int):
        self.min_h, self.min_w = min_h, min_w

    def __call__(self, clip, rng=None):
        t, h, w, c = clip.shape
        ph, pw = max(0, self.min_h - h), max(0, self.min_w - w)
        if not (ph or pw):
            return clip
        return np.pad(clip, ((0, 0), (ph // 2, ph - ph // 2),
                             (pw // 2, pw - pw // 2), (0, 0)),
                      mode="reflect")


class PerCrop:
    """Apply an op to each crop of a multi-crop ``[K, T, H, W, C]`` clip
    (the ops after :class:`FiveCrop` in a recipe)."""

    def __init__(self, op):
        self.op = op

    def __call__(self, clip, rng=None):
        if clip.ndim == 4:
            return self.op(clip, rng)
        return np.stack([self.op(c, rng) for c in clip])


class RandomCropWithProb:
    def __init__(self, size, p: float = 0.8, consistent: bool = True):
        self.size = (size, size) if isinstance(size, (int, float)) else size
        self.p = p
        self.consistent = consistent

    def __call__(self, clip, rng):
        t, h, w, c = clip.shape
        th, tw = self.size
        if w == tw and h == th:
            return clip

        def corner():
            if rng.random() < self.p:
                return (int(rng.integers(0, w - tw + 1)),
                        int(rng.integers(0, h - th + 1)))
            return (int(round((w - tw) / 2.0)), int(round((h - th) / 2.0)))

        if self.consistent:
            x1, y1 = corner()
            return _crop(clip, y1, x1, th, tw)
        out = np.empty((t, th, tw, c), clip.dtype)
        for i in range(t):
            x1, y1 = corner()
            out[i] = clip[i, y1: y1 + th, x1: x1 + tw]
        return out


class RandomSizedCrop:
    """Area ∈ [0.5, 1], aspect ∈ [3/4, 4/3], 10 attempts, fallback
    Scale + CenterCrop, p-gated else CenterCrop (reference ``:144-195``).
    One draw for the whole clip (the reference's ``consistent=True``, the
    only form the recipes use)."""

    consistent = True

    def __init__(self, size: int, interpolation: str = "bilinear",
                 p: float = 1.0,
                 area_range: tuple[float, float] = (0.5, 1.0),
                 aspect_range: tuple[float, float] = (3 / 4, 4 / 3)):
        self.size = size
        self.interpolation = interpolation
        self.p = p
        self.area_range = area_range
        self.aspect_range = aspect_range

    def __call__(self, clip, rng):
        t, hh, ww, c = clip.shape
        if rng.random() >= self.p:
            return CenterCrop(self.size)(clip, rng)
        out_wh = (self.size, self.size)
        for _ in range(10):
            target_area = rng.uniform(*self.area_range) * ww * hh
            aspect = rng.uniform(*self.aspect_range)
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if rng.random() < 0.5:
                w, h = h, w
            if w <= ww and h <= hh:
                x1 = int(rng.integers(0, ww - w + 1))
                y1 = int(rng.integers(0, hh - h + 1))
                return _resize_clip(_crop(clip, y1, x1, h, w), out_wh,
                                    self.interpolation)
        scaled = Scale(self.size, self.interpolation)(clip, rng)
        return CenterCrop(self.size)(scaled, rng)


class RandomHorizontalFlip:
    def __init__(self, consistent: bool = True,
                 command: Optional[str] = None):
        self.consistent = consistent
        self.p = {"left": 0.0, "right": 1.0}.get(command, 0.5)

    def __call__(self, clip, rng):
        if self.consistent:
            return clip[:, :, ::-1] if rng.random() < self.p else clip
        flips = rng.random(clip.shape[0]) < self.p
        out = clip.copy()
        out[flips] = out[flips, :, ::-1]
        return out


class RandomGray:
    """Channel splitting: replace RGB with one channel replicated ×3."""

    def __init__(self, consistent: bool = True, p: float = 0.5):
        self.consistent = consistent
        self.p = p

    def __call__(self, clip, rng):
        if self.consistent:
            if rng.random() < self.p:
                ch = int(rng.integers(0, 3))
                return np.repeat(clip[..., ch: ch + 1], 3, axis=-1)
            return clip
        picks = [(i, int(rng.integers(0, 3))) for i in range(clip.shape[0])
                 if rng.random() < self.p]
        out = clip.copy()
        if picks:
            idx, chans = (list(x) for x in zip(*picks))
            out[idx] = np.take_along_axis(
                clip[idx], np.asarray(chans)[:, None, None, None], axis=3)
        return out


# The colour adjustments work on frames [n, H, W, 3] with one factor per
# frame, each frame computed exactly as a lone frame would be: whole-clip
# numpy calls spend their time with the interpreter lock released, where
# frame-sized ones hold it, so a thread-pool loader scales.

def _grayscale(img: np.ndarray) -> np.ndarray:
    # ITU-R 601-2 luma, matching PIL convert('L') / torchvision
    g = (img[..., 0] * 0.299 + img[..., 1] * 0.587
         + img[..., 2] * 0.114).astype(np.uint8)
    return g[..., None]


def _blend_luts(factors: np.ndarray, others: np.ndarray) -> np.ndarray:
    """``[n, 256]`` uint8 tables of torchvision's blend
    ``clip(v·factor + other·(1−factor))`` with a scalar ``other`` a frame,
    in float32 as the per-pixel formula computes it."""
    v = np.arange(256, dtype=np.float32)
    f = factors.astype(np.float32)[:, None]
    w = (1.0 - factors).astype(np.float32)[:, None]
    o = np.asarray(others, np.float32)[:, None]
    return np.clip(v * f + o * w, 0, 255).astype(np.uint8)


def _apply_luts(frames: np.ndarray, luts: np.ndarray) -> np.ndarray:
    idx = frames.astype(np.intp)
    idx += (256 * np.arange(len(frames)))[:, None, None, None]
    return np.take(luts.ravel(), idx)


def _brightness(frames, factors):
    return _apply_luts(frames, _blend_luts(factors, np.zeros(len(frames))))


def _contrast(frames, factors):
    means = _grayscale(frames).reshape(len(frames), -1).mean(axis=1)
    return _apply_luts(frames, _blend_luts(factors,
                                           np.floor(means + 0.5)))


def _saturation(frames, factors):
    out = frames.astype(np.float32)
    out *= factors.astype(np.float32)[:, None, None, None]
    out += (_grayscale(frames).astype(np.float32)
            * (1.0 - factors).astype(np.float32)[:, None, None, None])
    return np.clip(out, 0, 255).astype(np.uint8)


# OpenCV's uint8 HSV tables (color_hsv: hsv_shift = 12, rounded divisions)
_HSV_SHIFT = 12
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT)
                                     / np.arange(1, 256))]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((256 << _HSV_SHIFT)
                                     / (6.0 * np.arange(1, 256)))]
                       ).astype(np.int32)
# per hue sector, the slots of (v, p, q, t) that hold r, g and b
_RGB_SLOTS = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0],
                       [3, 1, 0], [0, 1, 2]])


def _hue_shift(frames: np.ndarray, shifts: np.ndarray) -> np.ndarray:
    """OpenCV's ``RGB2HSV_FULL`` (hue over 256 steps, fixed point), the
    per-frame hue shift with 8-bit wrap, and ``HSV2RGB_FULL`` (hue over
    255 steps, float32), in numpy."""
    r, g, b = (frames[..., i].astype(np.int32) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h *= _HDIV[diff]
    h += half
    h >>= _HSV_SHIFT
    h += shifts.astype(np.int32)[:, None, None]
    h &= 255  # a negative hue wraps as OpenCV's +256 does
    hf = h.astype(np.float32)
    hf *= np.float32(6.0 / 255)
    sector = hf.astype(np.int32)
    f = hf - sector
    sf = s.astype(np.float32)
    sf *= np.float32(1.0 / 255)
    vf = v.astype(np.float32)
    n = vf.size
    tab = np.empty((n, 4), np.float32)
    tab[:, 0] = vf.ravel()
    tab[:, 1] = (vf * (1 - sf)).ravel()
    tab[:, 2] = (vf * (1 - sf * f)).ravel()
    tab[:, 3] = (vf * (1 - sf * (1 - f))).ravel()
    idx = _RGB_SLOTS[sector.ravel() % 6] + (4 * np.arange(n))[:, None]
    out = np.rint(np.take(tab.ravel(), idx))
    return out.astype(np.uint8).reshape(frames.shape)


def _hue(frames, factors, chunk: int = 8):
    """The hue shift of each frame, ``chunk`` frames a call: long enough
    calls to release the interpreter lock, short enough that their int32
    intermediates stay in cache."""
    shifts = np.asarray([int(round(f * 255)) for f in factors])
    # a zero shift is the identity: the uint8 HSV round trip is lossy
    moved = np.flatnonzero(shifts)
    out = frames.copy()
    for lo in range(0, len(moved), chunk):
        sel = moved[lo:lo + chunk]
        out[sel] = _hue_shift(frames[sel], shifts[sel])
    return out


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _brightness(img[None], np.array([factor]))[0]


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    return _contrast(img[None], np.array([factor]))[0]


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    return _saturation(img[None], np.array([factor]))[0]


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """Shift the hue wheel of one image by ``factor`` ∈ [−0.5, 0.5]
    (8-bit wrap, the PIL/torchvision uint8 semantics)."""
    return _hue(img[None], np.array([factor]))[0]


_FRAME_OPS = {"brightness": _brightness, "contrast": _contrast,
              "saturation": _saturation, "hue": _hue}


class ColorJitter:
    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 hue=0.0, consistent: bool = False, p: float = 1.0):
        self.brightness = self._range(brightness)
        self.contrast = self._range(contrast)
        self.saturation = self._range(saturation)
        self.hue = self._range(hue, center=0.0, clip_zero=False)
        self.consistent = consistent
        self.p = p

    @staticmethod
    def _range(v, center: float = 1.0, clip_zero: bool = True):
        if isinstance(v, (tuple, list)):
            lo, hi = v
        else:
            lo, hi = center - v, center + v
            if clip_zero:
                lo = max(lo, 0.0)
        return None if lo == hi == center else (lo, hi)

    def _params(self, rng) -> list[tuple[str, float]]:
        """One frame's (op, factor) list, in the order it applies them."""
        ops = [(name, rng.uniform(*bounds)) for name, bounds in
               (("brightness", self.brightness), ("contrast", self.contrast),
                ("saturation", self.saturation), ("hue", self.hue))
               if bounds is not None]
        rng.shuffle(ops)
        return ops

    def __call__(self, clip, rng):
        if rng.random() >= self.p:
            return clip
        t = clip.shape[0]
        plans = ([self._params(rng)] * t if self.consistent
                 else [self._params(rng) for _ in range(t)])
        # frame i applies plans[i] in order; the k-th op of all frames runs
        # as one call per op kind
        out = clip.copy()
        for k in range(max(len(plan) for plan in plans)):
            for name, fn in _FRAME_OPS.items():
                idx = [i for i, plan in enumerate(plans) if plan[k][0] == name]
                if idx:
                    factors = np.array([plans[i][k][1] for i in idx])
                    out[idx] = fn(out[idx], factors)
        return out


def _rotate_expand(clip: np.ndarray, deg: float) -> np.ndarray:
    """Every frame of ``clip [T, H, W, C]`` rotated by ``deg`` (counter-
    clockwise) on its expanded canvas: ``cv2.warpAffine``'s inverse map,
    bilinear over four taps, taps outside the frame reading 0
    (``BORDER_CONSTANT``), rounded to uint8."""
    h, w = clip.shape[1:3]
    # cv2.getRotationMatrix2D((w/2, h/2), deg, 1.0) in float64, the canvas
    # grown to hold the whole rotated frame
    a = deg * math.pi / 180
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = w / 2, h / 2
    m = np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                  [-beta, alpha, beta * cx + (1 - alpha) * cy]])
    cos, sin = abs(m[0, 0]), abs(m[0, 1])
    nw = int(h * sin + w * cos)
    nh = int(h * cos + w * sin)
    m[0, 2] += (nw - w) / 2
    m[1, 2] += (nh - h) / 2
    inv = np.linalg.inv(np.vstack([m, [0.0, 0.0, 1.0]]))[:2]
    ys, xs = np.mgrid[0:nh, 0:nw].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    # a one-pixel zero border: a tap outside the frame lands on it
    pad = np.pad(clip, ((0, 0), (1, 1), (1, 1), (0, 0)))
    xa, xb = np.clip(x0, -1, w) + 1, np.clip(x0 + 1, -1, w) + 1
    ya, yb = np.clip(y0, -1, h) + 1, np.clip(y0 + 1, -1, h) + 1
    out = pad[:, ya, xa] * ((1 - fx) * (1 - fy))
    out += pad[:, ya, xb] * (fx * (1 - fy))
    out += pad[:, yb, xa] * ((1 - fx) * fy)
    out += pad[:, yb, xb] * (fx * fy)
    if clip.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(clip.dtype)


class RandomRotation:
    """Rotate by an integer degree in ``[-degree, degree)``, the canvas
    expanded to hold the whole frame (reference ``:353-366``), p-gated.
    Per-frame degrees (``consistent=False``) give canvases of different
    sizes; each frame is centred on the largest (PARITY.md #16)."""

    def __init__(self, consistent: bool = True, degree: float = 15,
                 p: float = 1.0):
        self.consistent = consistent
        self.degree = degree
        self.p = p

    def __call__(self, clip, rng):
        if rng.random() >= self.p:
            return clip
        if self.consistent:
            deg = float(rng.integers(-self.degree, self.degree))
            return _rotate_expand(clip, deg)
        frames = [_rotate_expand(clip[i:i + 1], float(
            rng.integers(-self.degree, self.degree)))[0]
            for i in range(clip.shape[0])]
        hm = max(f.shape[0] for f in frames)
        wm = max(f.shape[1] for f in frames)
        out = np.zeros((len(frames), hm, wm) + clip.shape[3:], clip.dtype)
        for i, f in enumerate(frames):
            y0 = (hm - f.shape[0]) // 2
            x0 = (wm - f.shape[1]) // 2
            out[i, y0:y0 + f.shape[0], x0:x0 + f.shape[1]] = f
        return out


class Normalize:
    """uint8 [T,H,W,C] → float32 ``(x/255 − mean)/std``, as one per-channel
    scale and offset (dpc_tpu's fused form; within 5e-7 of the literal
    expression)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        std64 = self.std.astype(np.float64)
        self._scale = (1.0 / (255.0 * std64)).astype(np.float32)
        self._offset = (-self.mean.astype(np.float64) / std64
                        ).astype(np.float32)

    def __call__(self, clip, rng=None):
        out = np.multiply(clip, self._scale, dtype=np.float32)
        out += self._offset
        return out


def frame_consistent(transform) -> bool:
    """True when the transform maps every frame of a clip the same way
    (every draw per clip, or no draw), so a frame's output does not depend
    on the frames beside it: the precondition of the dense test's
    decode-each-frame-once path.  Containers recurse into their ops;
    unknown ops count as not consistent."""
    if isinstance(transform, Compose):
        return all(frame_consistent(op) for op in transform.ops)
    if isinstance(transform, PerCrop):
        return frame_consistent(transform.op)
    if isinstance(transform, HostScaleCrop):
        return all(frame_consistent(op) for op in (
            transform._scale, transform._pad, transform._crop))
    if hasattr(transform, "consistent"):
        return bool(transform.consistent)
    return isinstance(transform, (Padding, Scale, CenterCrop, FiveCrop,
                                  PadTo, Normalize))


# ---------------------------------------------------------------------------
# Recipes (dpc/main.py:115-133, eval/test.py:121-126,161-176)
# ---------------------------------------------------------------------------

class HostScaleCrop:
    """The host half of ``--device_augment``: ``Scale(short)`` →
    ``PadTo(win)`` → a consistent ``RandomCrop(win)`` (or ``CenterCrop``
    with ``center=True``, the dense test's), as one op the JPEG codec runs
    inside the decode (``native.decode_jpeg_batch_scale_crop``: only the
    pixels that feed the window are decoded).

    :meth:`plan` returns the (short side, crop) the codec needs, drawing
    the window with ``RandomCrop``'s rng calls (x, then y), or None when the
    scaled frame is smaller than the window (portrait frames that need the
    reflect pad: the numpy ``__call__`` handles those).  ``__call__`` runs
    the same geometry on decoded frames, the scale bilinear."""

    def __init__(self, short: int, win_hw: tuple[int, int],
                 center: bool = False):
        self.short = short
        self.win_h, self.win_w = win_hw
        self.center = center
        self._scale = Scale(short, interpolation="bilinear")
        self._pad = PadTo(*win_hw)
        self._crop = (CenterCrop(win_hw) if center
                      else RandomCrop(win_hw, consistent=True))

    def scaled_dims(self, h: int, w: int) -> tuple[int, int]:
        return shortside_dims(h, w, self.short)

    def plan(self, src_hw: tuple[int, int], rng
             ) -> Optional[tuple[int, tuple[int, int, int, int]]]:
        oh, ow = self.scaled_dims(*src_hw)
        if oh < self.win_h or ow < self.win_w:
            return None
        if self.center:  # CenterCrop's rounding (round-half-even)
            x1 = int(round((ow - self.win_w) / 2.0))
            y1 = int(round((oh - self.win_h) / 2.0))
        else:
            x1 = int(rng.integers(0, ow - self.win_w + 1))
            y1 = int(rng.integers(0, oh - self.win_h + 1))
        return self.short, (y1, x1, self.win_h, self.win_w)

    def __call__(self, clip, rng):
        clip = self._scale(clip, rng)
        clip = self._pad(clip, rng)
        return self._crop(clip, rng)


def pretrain_transform(dataset: str, img_dim: int) -> Compose:
    if dataset in ("ucf101", "hmdb51", "synthetic"):
        return Compose([
            RandomHorizontalFlip(consistent=True),
            RandomCrop(size=224, consistent=True),
            Scale(size=(img_dim, img_dim)),
            RandomGray(consistent=False, p=0.5),
            ColorJitter(0.5, 0.5, 0.5, 0.25, consistent=False, p=1.0),
            Normalize(),
        ])
    if dataset == "k400":
        return Compose([
            RandomSizedCrop(size=img_dim, p=1.0),
            RandomHorizontalFlip(consistent=True),
            RandomGray(consistent=False, p=0.5),
            ColorJitter(0.5, 0.5, 0.5, 0.25, consistent=False, p=1.0),
            Normalize(),
        ])
    raise ValueError(f"no pretrain recipe for {dataset!r}")


def finetune_transform(img_dim: int, mode: str = "train",
                       five_crop: bool = False) -> Compose:
    """The LC recipes.  ``five_crop`` in test mode: the reference's five
    crops at 224 (``eval/dataset_3d_lc.py:98-107``), each scaled to
    ``img_dim``; the crops ride the window axis of the softmax average."""
    if five_crop and mode == "test":
        return Compose([
            FiveCrop(224),
            PerCrop(Scale(size=(img_dim, img_dim))),
            Normalize(),
        ])
    if mode == "train":
        return Compose([
            RandomSizedCrop(size=224),
            Scale(size=(img_dim, img_dim)),
            RandomHorizontalFlip(consistent=True),
            ColorJitter(0.5, 0.5, 0.5, 0.25, consistent=True, p=0.3),
            Normalize(),
        ])
    if mode == "val":
        return Compose([
            RandomSizedCrop(size=224, p=0.3),
            Scale(size=(img_dim, img_dim)),
            RandomHorizontalFlip(consistent=True),
            ColorJitter(0.2, 0.2, 0.2, 0.1, consistent=True, p=0.3),
            Normalize(),
        ])
    # test: the deterministic centre path (eval/test.py:121-126)
    return Compose([
        RandomSizedCrop(size=224, p=0.0),
        Scale(size=(img_dim, img_dim)),
        Normalize(),
    ])
