"""The parts of ``dpc_tpu/data/augment.py`` the synthetic pretraining recipe
needs: ``Compose``, ``Scale``, ``CenterCrop``, ``RandomSizedCrop`` and
``Normalize``, over numpy uint8 clips ``[T, H, W, C]``.

The draws and geometry are those of the JAX package (reference
``utils/augmentation.py``).  The resizes are written in numpy with OpenCV's
pixel-centre conventions (``INTER_LINEAR`` / ``INTER_NEAREST``) so the port
needs no OpenCV; rounding of the bilinear blend may differ from OpenCV's
fixed-point arithmetic by one grey level.
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


class Scale:
    """Aspect-preserving short-side resize."""

    def __init__(self, size: int, interpolation: str = "nearest"):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, clip, rng):
        t, h, w, c = clip.shape
        oh, ow = shortside_dims(h, w, self.size)
        if (oh, ow) == (h, w):
            return clip
        return _resize_clip(clip, (ow, oh), self.interpolation)


def _crop(clip, y, x, th, tw):
    return clip[:, y: y + th, x: x + tw]


class CenterCrop:
    def __init__(self, size: int):
        self.size = (size, size)

    def __call__(self, clip, rng):
        t, h, w, c = clip.shape
        th, tw = self.size
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        return _crop(clip, y1, x1, th, tw)


class RandomSizedCrop:
    """Area ∈ [0.5, 1], aspect ∈ [3/4, 4/3], 10 attempts, fallback
    Scale + CenterCrop, p-gated else CenterCrop (reference ``:144-195``).
    One draw for the whole clip (the reference's ``consistent=True``, the
    only form the pretraining recipes use)."""

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


class Normalize:
    """uint8 [T,H,W,C] → float32 ``(x/255 − mean)/std``."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, clip, rng=None):
        return (clip.astype(np.float32) / 255.0 - self.mean) / self.std
