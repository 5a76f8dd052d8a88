"""The plain reference of the device recipes the train steps run on uint8
windows: the pretrain recipe (RandomSizedCrop to the model's size, flip,
per-frame RandomGray and ColorJitter, Normalize; ``dpc/main.py:115-133``)
and the finetune recipe (RandomSizedCrop, flip, clip-consistent
ColorJitter with p=0.3, Normalize; ``eval/test.py:121-176``).

The draws are the recipes' random values made from the benchmark's
per-step ``torch.Generator``: a frozen copy of the system's draw order
(one attempt of RandomSizedCrop, the flip, the gray pick and channel, the
jitter factors), so that both sides crop, flip and jitter alike.  The
arithmetic is written here plainly: a bilinear resample of the crop at
half-pixel centres, then the colour operations one after another, with
the hue a rotation about the gray axis, the blend targets taken from the
brightened frame, and one clamp at the end.
"""

from __future__ import annotations

import math

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)
PRETRAIN_JITTER = (0.5, 0.5, 0.5, 0.25)
FINETUNE_JITTER = (0.5, 0.5, 0.5, 0.25)


# ---------------------------------------------------------------------------
# The draws
# ---------------------------------------------------------------------------

def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _randint(gen, n):
    u = torch.rand(n.shape, generator=gen, dtype=torch.float64)
    return torch.minimum((u * n).floor().long(), n - 1)


def _crop(gen, b, h, w):
    area = _uniform(gen, (b,), 0.5, 1.0) * (h * w)
    aspect = torch.exp(_uniform(gen, (b,), math.log(3 / 4), math.log(4 / 3)))
    cw = torch.sqrt(area * aspect).clamp(8.0, w).long()
    ch = torch.sqrt(area / aspect).clamp(8.0, h).long()
    x0 = _randint(gen, (w - cw).clamp_min(0) + 1)
    y0 = _randint(gen, (h - ch).clamp_min(0) + 1)
    return torch.stack([x0, y0, cw, ch], dim=-1)


def _jitter(gen, shape, strengths):
    b, c, s, hue = strengths
    return torch.stack([_uniform(gen, shape, max(0.0, 1 - b), 1 + b),
                        _uniform(gen, shape, max(0.0, 1 - c), 1 + c),
                        _uniform(gen, shape, max(0.0, 1 - s), 1 + s),
                        _uniform(gen, shape, -hue, hue)], dim=-1)


def draw_pretrain(gen, b, frames, h, w) -> dict:
    crop = _crop(gen, b, h, w)
    return {"crop": crop, "flip": torch.rand(b, generator=gen) < 0.5,
            "gray": torch.rand((b, frames), generator=gen) < 0.5,
            "gray_chan": torch.randint(0, 3, (b, frames), generator=gen),
            "jitter": _jitter(gen, (b, frames), PRETRAIN_JITTER)}


def draw_finetune(gen, b, h, w) -> dict:
    flip = torch.rand(b, generator=gen) < 0.5
    crop = _crop(gen, b, h, w)
    jitter = _jitter(gen, (b, 1), FINETUNE_JITTER)
    return {"crop": crop, "flip": flip, "jitter": jitter,
            "jitter_p": torch.rand(b, generator=gen) < 0.3}


# ---------------------------------------------------------------------------
# The arithmetic, frames [B, F, H, W, 3]
# ---------------------------------------------------------------------------

def _taps(start, length, out, src):
    """Bilinear taps of ``out`` samples over ``[start, start + length)``:
    centres ``start + (i + 0.5)·length/out − 0.5`` clamped to the axis."""
    i = torch.arange(out, dtype=torch.float32, device=start.device)
    c = start.float()[:, None] + (i + 0.5) * (length.float()[:, None] / out) \
        - 0.5
    c = c.clamp(0.0, src - 1.0)
    lo = c.floor()
    return lo.long(), torch.clamp(lo.long() + 1, max=src - 1), c - lo


def resized_crop(frames, crop, out, flip):
    """The crop resampled bilinearly to ``out``², mirrored where ``flip``;
    f32 in the input's scale."""
    b, f, h, w, c = frames.shape
    x0, y0, cw, ch = (crop[:, i].to(frames.device) for i in range(4))
    ix0, ix1, fx = _taps(x0, cw, out, w)
    iy0, iy1, fy = _taps(y0, ch, out, h)
    bi = torch.arange(b, device=frames.device)[:, None, None]

    def at(iy, ix):  # [B, out, out, F, C] → [B, F, out, out, C]
        return frames[bi, :, iy[:, :, None], ix[:, None, :]].permute(
            0, 3, 1, 2, 4).float()

    wx = fx[:, None, None, :, None]
    wy = fy[:, None, :, None, None]
    top = at(iy0, ix0) * (1 - wx) + at(iy0, ix1) * wx
    bottom = at(iy1, ix0) * (1 - wx) + at(iy1, ix1) * wx
    img = top * (1 - wy) + bottom * wy
    flip = flip.to(frames.device).view(b, 1, 1, 1, 1)
    return torch.where(flip, img.flip(-2), img)


def gray(x, apply, chan):
    """RandomGray: a picked frame takes one channel on all three."""
    b, f = apply.shape
    idx = chan.to(x.device).view(b, f, 1, 1, 1).expand(*x.shape[:4], 1)
    g = x.gather(-1, idx).expand_as(x)
    return torch.where(apply.to(x.device).view(b, f, 1, 1, 1), g, x)


def _luma(x):
    l0, l1, l2 = LUMA
    return x[..., 0:1] * l0 + x[..., 1:2] * l1 + x[..., 2:3] * l2


def jitter(x, factors):
    """Brightness, contrast and saturation blends, then the hue rotated
    about the gray axis, then one clamp to [0, 1].  ``factors`` [B, F', 4]
    (F' = F per frame, 1 for the clip)."""
    f = factors.to(x.device)[:, :, None, None, None, :]
    fb, fc, fs, fh = f[..., 0], f[..., 1], f[..., 2], f[..., 3]
    x1 = x * fb
    lum = _luma(x1)
    m = lum.mean(dim=(-3, -2), keepdim=True)
    x2 = fc * x1 + (1 - fc) * m
    x3 = fs * x2 + (1 - fs) * lum
    th = 2 * math.pi * fh
    cos, sin = torch.cos(th), torch.sin(th)
    a = cos + (1 - cos) / 3
    bq = (1 - cos) / 3 - sin / math.sqrt(3)
    cq = (1 - cos) / 3 + sin / math.sqrt(3)
    r, g, bl = x3[..., 0:1], x3[..., 1:2], x3[..., 2:3]
    x4 = torch.cat([a * r + bq * g + cq * bl,
                    cq * r + a * g + bq * bl,
                    bq * r + cq * g + a * bl], dim=-1)
    return x4.clamp(0.0, 1.0)


def normalize(x):
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return (x - mean) / std


def pretrain(clips, draws, img_dim):
    """uint8 [B, N, SL, H, W, 3] → normalised f32 [B, N, SL, D, D, 3]."""
    b, n, sl, h, w, c = clips.shape
    x = resized_crop(clips.reshape(b, n * sl, h, w, c), draws["crop"],
                     img_dim, draws["flip"]) / 255.0
    x = jitter(gray(x, draws["gray"], draws["gray_chan"]), draws["jitter"])
    return normalize(x).reshape(b, n, sl, img_dim, img_dim, c)


def finetune(clips, draws, img_dim):
    b, n, sl, h, w, c = clips.shape
    x = resized_crop(clips.reshape(b, n * sl, h, w, c), draws["crop"],
                     img_dim, draws["flip"]) / 255.0
    p = draws["jitter_p"].to(x.device).view(b, 1, 1, 1, 1)
    x = torch.where(p, jitter(x, draws["jitter"]), x)
    return normalize(x).reshape(b, n, sl, img_dim, img_dim, c)
