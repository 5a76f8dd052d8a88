"""Clip augmentation on the device, inside the train, val and test steps
(port of ``dpc_tpu/data/device_augment.py``).

With ``--device_augment`` the host workers only decode uint8 windows
(``augment.HostScaleCrop``, executed inside the JPEG decode where the codec
can); the random crop, flip, per-frame gray, colour jitter and Normalize
of the reference recipes run here on the whole batch.

The draws are split from the arithmetic: ``draw_pretrain`` and
``draw_finetune`` draw every random value of a batch from an explicit
``torch.Generator`` into a :class:`Draws` of small tensors, and the apply
functions are deterministic in (clips, draws).  The drivers seed that
generator per step from ``loop.step_seed``, so a resumed run draws what the
uninterrupted run drew, and the tests can hand ``dpc_tpu``'s own draws to
the apply functions.  The draws follow ``dpc_tpu``'s distributions
(single-attempt RandomSizedCrop, clip-consistent crop and flip, per-frame
gray and jitter in the pretrain recipes, clip-consistent jitter in the
finetune recipes), not its JAX random streams.

The resamples are gathers, as suits a GPU (``dpc_tpu`` writes them as
selection- and interpolation-matrix contractions for the TPU's MXU):
NEAREST is an index gather with OpenCV's ``INTER_NEAREST`` indices
(``_cv2_nearest_idx``), the crop + resize of RandomSizedCrop a two-tap
gather and lerp on the coordinates of ``dpc_tpu``'s ``_lin_weights``, and
the flip is folded into the column indices.  Clips stay uint8 until after
the crop or resize, so the full-resolution window is never f32.  No matmul
is used (the 3×3 colour matrices are explicit sums), so TF32 cannot touch
the NEAREST path's exactness.  The hue jitter is ``dpc_tpu``'s device hue:
a rotation about the gray axis, composed with brightness, contrast and
saturation into one per-frame 3×3 matrix plus bias and one clamp
(PARITY.md #6), not the host recipe's HSV round trip.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

# (mean, std, scale) of the stem conv's normalize fold
# (``models.layers.conv3d_input_norm``): a recipe run with
# normalize_out=False emits [0, 1] f32 (scale 1) or raw uint8 windows
# (scale 255), and the model applies the affine inside the stem conv
INPUT_NORM_01 = (IMAGENET_MEAN, IMAGENET_STD, 1.0)
INPUT_NORM_U8 = (IMAGENET_MEAN, IMAGENET_STD, 255.0)

RECIPES = ("sized_crop", "crop_resize")
# ColorJitter strengths (brightness, contrast, saturation, hue)
PRETRAIN_JITTER = (0.5, 0.5, 0.5, 0.25)
FINETUNE_JITTER = {"train": (0.5, 0.5, 0.5, 0.25), "val": (0.2, 0.2, 0.2, 0.1)}


# Whether fold_normalize="auto" folds with --device_augment: no.  The fold
# measured slower than the recipe's own normalize on an NVIDIA H100 (PERF.md
# §6, the fused stem's entry; chip_smoke.py's fold_turns): the pretrain
# step by 2.4%, the finetune step by 2.7% and the dense-test forward by
# 3.4%, as the fold's border correction is a pass over the 64-channel stem
# activation in each direction and the normalize one over the 3-channel
# input.
FOLD_AUTO = False


def resolve_fold(cfg, dense_test: bool = False):
    """``--fold_normalize`` resolved to ``(fold, input_norm)``: callers run
    the recipe with ``normalize_out=not fold`` and the model with
    ``input_norm`` (uint8 windows' in the dense test, [0, 1] f32's in the
    train and val recipes).  'auto' is ``FOLD_AUTO``; 'on' and 'off' force
    it."""
    if cfg.fold_normalize not in ("auto", "on", "off"):
        raise ValueError("fold_normalize must be one of 'auto'|'on'|'off', "
                         f"got {cfg.fold_normalize!r}")
    if not getattr(cfg, "device_augment", False):
        return False, None
    fold = (FOLD_AUTO if cfg.fold_normalize == "auto"
            else cfg.fold_normalize == "on")
    norm = INPUT_NORM_U8 if dense_test else INPUT_NORM_01
    return fold, (norm if fold else None)


def device_augment_geometry(dataset: str, img_dim: int,
                            task: str = "pretrain"
                            ) -> tuple[int, tuple[int, int]]:
    """(short_side, window_hw) of the host half: the one source of the
    window each recipe decodes.  UCF/HMDB pretrain takes the consistent
    224-of-240 crop (``dpc/main.py:116-124``); the finetune recipes'
    RandomSizedCrop draws from the whole frame (``eval/test.py:121-176``),
    so ``task='finetune'`` keeps the 4:3 frame at short side 240; the
    dense test decodes straight to its centre 224² window (``'test'``) or
    keeps the frame its five crops are cut from (``'test_five'``); K400 is
    always a native-geometry window (``dpc/main.py:126-133``)."""
    if dataset == "k400":
        short = 256 if img_dim > 140 else 150
        return short, (short, int(round(short * 4 / 3)))
    if dataset == "synthetic":
        short = max(img_dim, 130)
        if task in ("finetune", "test", "test_five"):
            return short, (short, short)
        return short, (int(round(short * 224 / 240)),) * 2
    if task in ("finetune", "test_five"):
        return 240, (240, 320)
    return 240, (dense_test_crop(dataset, img_dim),) * 2


def dense_test_crop(dataset: str, img_dim: int) -> int:
    """Spatial crop of the dense-test recipe: the reference's 224
    (``eval/test.py:121-126``); the synthetic frames are only
    ``max(img_dim, 130)``, so there it is ``img_dim``."""
    return img_dim if dataset == "synthetic" else 224


def _cv2_nearest_idx(out: int, src: int) -> np.ndarray:
    """OpenCV ``INTER_NEAREST`` source indices, ``floor(i·src/out)`` (no
    half-pixel centring): the host recipes' Scale, so the dense-test path
    here is pixel-equal to the host chain."""
    return np.minimum(np.floor(np.arange(out) * (src / out)),
                      src - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# The draws
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Draws:
    """Every random value of one batch of a recipe.  ``B`` samples of
    ``F`` frames; a field a recipe does not use is None."""

    flip: torch.Tensor                        # bool [B]
    crop: Optional[torch.Tensor] = None       # int64 [B, 4]: x0, y0, cw, ch
    crop_p: Optional[torch.Tensor] = None     # bool [B]: the sized crop is
                                              # taken (else the centre crop)
    gray: Optional[torch.Tensor] = None       # bool [B, F]
    gray_chan: Optional[torch.Tensor] = None  # int64 [B, F]
    jitter: Optional[torch.Tensor] = None     # f32 [B, F or 1, 4]: fb, fc,
                                              # fs, fh (1: clip-consistent)
    jitter_p: Optional[torch.Tensor] = None   # bool [B]: the jitter applies

    def to(self, device) -> "Draws":
        """The draws on ``device``; to a card from pinned memory without a
        host sync, so the host keeps queueing ahead of the device."""
        device = torch.device(device)

        def move(v):
            if v is None or device.type != "cuda":
                return None if v is None else v.to(device)
            return v.pin_memory().to(device, non_blocking=True)

        return Draws(**{f.name: move(getattr(self, f.name))
                        for f in dataclasses.fields(self)})

    def rows(self, first: int, n: int) -> "Draws":
        """The draws of samples ``first .. first + n`` (a model peer's
        share of its data group's draws, ``parallel.mesh.peer_rows``)."""
        return Draws(**{f.name: None if getattr(self, f.name) is None
                        else getattr(self, f.name)[first:first + n]
                        for f in dataclasses.fields(self)})


def _uniform(gen: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _randint(gen: torch.Generator, n: torch.Tensor) -> torch.Tensor:
    """One integer uniform on ``[0, n)`` per element of ``n`` (int64)."""
    u = torch.rand(n.shape, generator=gen, dtype=torch.float64)
    return torch.minimum((u * n).floor().long(), n - 1)


def draw_crop(gen: torch.Generator, b: int, h: int, w: int,
              area_range=(0.5, 1.0), aspect_range=(3 / 4, 4 / 3)
              ) -> torch.Tensor:
    """RandomSizedCrop's window per sample, one attempt (``dpc_tpu``'s
    branch-free variant: a draw outside the frame is clamped to it):
    ``[B, 4]`` int64 (x0, y0, cw, ch)."""
    area = _uniform(gen, (b,), *area_range) * (h * w)
    aspect = torch.exp(_uniform(gen, (b,), math.log(aspect_range[0]),
                                math.log(aspect_range[1])))
    cw = torch.sqrt(area * aspect).clamp(8.0, w).long()
    ch = torch.sqrt(area / aspect).clamp(8.0, h).long()
    x0 = _randint(gen, (w - cw).clamp_min(0) + 1)
    y0 = _randint(gen, (h - ch).clamp_min(0) + 1)
    return torch.stack([x0, y0, cw, ch], dim=-1)


def _jitter_factors(gen: torch.Generator, shape, strengths) -> torch.Tensor:
    """(fb, fc, fs, fh) of ColorJitter: ``[*shape, 4]`` f32."""
    b, c, s, hue = strengths
    return torch.stack([_uniform(gen, shape, max(0.0, 1 - b), 1 + b),
                        _uniform(gen, shape, max(0.0, 1 - c), 1 + c),
                        _uniform(gen, shape, max(0.0, 1 - s), 1 + s),
                        _uniform(gen, shape, -hue, hue)], dim=-1)


def draw_pretrain(gen: torch.Generator, b: int, frames: int, h: int, w: int,
                  recipe: str = "sized_crop", gray_p: float = 0.5) -> Draws:
    """The draws of :func:`augment_batch` for ``b`` clips of ``frames``
    frames of ``h×w``: a crop window (``sized_crop``) and a flip per clip,
    a gray pick and the jitter factors per frame."""
    if recipe not in RECIPES:
        raise ValueError(f"unknown device-augment recipe {recipe!r}; "
                         f"expected one of {RECIPES}")
    crop = draw_crop(gen, b, h, w) if recipe == "sized_crop" else None
    return Draws(flip=torch.rand(b, generator=gen) < 0.5, crop=crop,
                 gray=torch.rand((b, frames), generator=gen) < gray_p,
                 gray_chan=torch.randint(0, 3, (b, frames), generator=gen),
                 jitter=_jitter_factors(gen, (b, frames), PRETRAIN_JITTER))


def draw_finetune(gen: torch.Generator, b: int, h: int, w: int,
                  mode: str = "train") -> Draws:
    """The draws of :func:`finetune_augment_batch`, all per clip: the crop
    window, its p=0.3 gate (val), the flip, the jitter factors and their
    p=0.3 gate."""
    if mode not in FINETUNE_JITTER:
        raise ValueError(f"unknown finetune recipe mode {mode!r}")
    return Draws(
        flip=torch.rand(b, generator=gen) < 0.5,
        crop=draw_crop(gen, b, h, w),
        crop_p=(torch.rand(b, generator=gen) < 0.3) if mode == "val"
        else None,
        jitter=_jitter_factors(gen, (b, 1), FINETUNE_JITTER[mode]),
        jitter_p=torch.rand(b, generator=gen) < 0.3)


# ---------------------------------------------------------------------------
# The arithmetic: clips are [B, F, H, W, C]
# ---------------------------------------------------------------------------

def _gather_hw(clips: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor
               ) -> torch.Tensor:
    """``out[b, f, i, j] = clips[b, f, iy[b, i], ix[b, j]]``, with ``iy``
    and ``ix`` int64 ``[B, n]`` per sample or ``[n]`` shared."""
    if iy.ndim == 1 and ix.ndim == 1:
        return clips.index_select(2, iy).index_select(3, ix)
    b = clips.shape[0]
    iy = iy.expand(b, -1) if iy.ndim == 1 else iy
    ix = ix.expand(b, -1) if ix.ndim == 1 else ix
    bi = torch.arange(b, device=clips.device)[:, None, None]
    out = clips[bi, :, iy[:, :, None], ix[:, None, :]]   # [B, oy, ox, F, C]
    return out.permute(0, 3, 1, 2, 4).contiguous()


def _flip_index(idx: torch.Tensor, flip: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """Per-sample column indices with the flip folded in: reversing the
    output columns is the same gather as flipping its result."""
    if flip is None:
        return idx
    return torch.where(flip[:, None], idx.flip(-1), idx)


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _lin_taps(start: torch.Tensor, length: torch.Tensor, out: int,
              src: int):
    """Two-tap bilinear sampling of ``out`` points over ``[start,
    start + length)`` of a ``src``-long axis, per sample: the coordinates
    ``start + (i + 0.5)·length/out − 0.5`` of ``dpc_tpu``'s
    ``_lin_weights``, clamped to ``[0, src − 1]``.  Returns (i0, i1,
    frac), ``[B, out]`` each."""
    i = torch.arange(out, device=start.device, dtype=torch.float32)
    step = length.float()[:, None] / out
    c = start.float()[:, None] + (i + 0.5) * step - 0.5
    c = c.clamp(0.0, src - 1.0)
    i0 = c.floor()
    frac = c - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=src - 1), frac


def random_resized_crop(clips: torch.Tensor, crop: torch.Tensor,
                        out_size: int, flip: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Crop ``crop`` ([B, 4] x0, y0, cw, ch) and resize it bilinearly to
    ``out_size``², with the flip (bool [B]) folded into the columns.
    ``clips`` may be uint8: the four taps are gathered at the output
    size and only they become f32.  Returns f32 in the input's scale."""
    b, f, h, w, c = clips.shape
    x0, y0, cw, ch = crop.unbind(-1)
    ix0, ix1, fx = _lin_taps(x0, cw, out_size, w)
    iy0, iy1, fy = _lin_taps(y0, ch, out_size, h)
    if flip is not None:
        ix0, ix1, fx = (_flip_index(v, flip) for v in (ix0, ix1, fx))
    fx = fx[:, None, None, :, None]
    fy = fy[:, None, :, None, None]

    def row(iy):
        return (_gather_hw(clips, iy, ix0).float() * (1.0 - fx)
                + _gather_hw(clips, iy, ix1).float() * fx)

    return row(iy0) * (1.0 - fy) + row(iy1) * fy


def random_hflip(clips: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip the clips whose ``flip`` (bool [B]) is set."""
    return torch.where(flip.view(-1, 1, 1, 1, 1), clips.flip(-2), clips)


def random_gray(clips: torch.Tensor, apply: torch.Tensor,
                chan: torch.Tensor) -> torch.Tensor:
    """Channel splitting (reference RandomGray, ``augmentation.py:224-250``):
    the frames whose ``apply`` ([B, F] bool) is set take channel ``chan``
    ([B, F]) on all three channels."""
    b, f, h, w, c = clips.shape
    gray = clips.gather(-1, chan.view(b, f, 1, 1, 1).expand(b, f, h, w, 1))
    return torch.where(apply.view(b, f, 1, 1, 1), gray.expand_as(clips),
                       clips)


def _color_matrix(factors: torch.Tensor, dtype) -> torch.Tensor:
    """The per-frame 3×3 matrix M = R·(fs·fc·fb·I + (1−fs)·fb·𝟙Lᵀ) of
    :func:`color_jitter`, ``[B, F', 3, 3]``."""
    fb, fc, fs, fh = factors.unbind(-1)
    luma = torch.tensor([0.299, 0.587, 0.114], dtype=dtype,
                        device=factors.device)
    theta = 2.0 * math.pi * fh
    cos, sin = torch.cos(theta), torch.sin(theta)
    one3 = 1.0 / 3.0
    sq3 = 1.0 / math.sqrt(3.0)
    a = cos + (1 - cos) * one3
    bq = one3 * (1 - cos) - sq3 * sin
    cq = one3 * (1 - cos) + sq3 * sin
    rot = torch.stack([torch.stack([a, bq, cq], -1),
                       torch.stack([cq, a, bq], -1),
                       torch.stack([bq, cq, a], -1)], -2)
    eye = torch.eye(3, dtype=dtype, device=factors.device)
    mix = ((fs * fc * fb)[..., None, None] * eye
           + ((1 - fs) * fb)[..., None, None] * luma.expand(3, 3))
    # a 3-long contraction written out: no matmul, so no TF32
    return (rot[..., :, :, None] * mix[..., None, :, :]).sum(-2)


def color_jitter(clips: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast and saturation blends and the hue rotation
    about the gray axis, on [0, 1] floats, as one per-frame affine map and
    one clamp:

        x1 = fb·x;  lum = L·x1;  m = mean(lum)
        x2 = fc·x1 + (1−fc)·m;  x3 = fs·x2 + (1−fs)·lum;  x4 = R(2π·fh)·x3
        ⇒ x4 = M·x + fs·(1−fc)·m

    ``factors`` ``[B, F', 4]`` (fb, fc, fs, fh), F' = F per frame or 1 for
    the clip."""
    luma = torch.tensor([0.299, 0.587, 0.114], dtype=clips.dtype,
                        device=clips.device)
    fb, fc, fs, _ = factors.unbind(-1)
    mu = clips.mean(dim=(-3, -2))                     # [B, F, 3]
    m = fb * (mu * luma).sum(-1)                      # frame luma mean
    mat = _color_matrix(factors, clips.dtype)         # [B, F', 3, 3]
    beta = (fs * (1 - fc) * m)[..., None, None, None]  # [B, F, 1, 1, 1]
    mat = mat[:, :, None, None]                       # [B, F', 1, 1, 3, 3]
    x = (clips[..., 0:1] * mat[..., 0] + clips[..., 1:2] * mat[..., 1]
         + clips[..., 2:3] * mat[..., 2])
    return (x + beta).clamp(0.0, 1.0)


def normalize(clips: torch.Tensor) -> torch.Tensor:
    # asynchronous copies: a blocking one waits for the queued work
    mean = torch.from_numpy(IMAGENET_MEAN).to(clips.device, non_blocking=True)
    std = torch.from_numpy(IMAGENET_STD).to(clips.device, non_blocking=True)
    return (clips - mean) / std


def resize_fixed(clips: torch.Tensor, out_size: int,
                 flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NEAREST resize of every frame to ``out_size``² with OpenCV's
    ``INTER_NEAREST`` indices (the reference Scale's interpolation,
    ``utils/augmentation.py:20``), the flip (bool [B]) folded into the
    columns.  A gather, so exact; f32 in the input's scale.  (``dpc_tpu``'s
    other methods, through ``jax.image.resize``, have no caller.)"""
    b, f, h, w, c = clips.shape
    iy = _index(_cv2_nearest_idx(out_size, h), clips.device)
    ix = _index(_cv2_nearest_idx(out_size, w), clips.device)
    if flip is not None:
        ix = _flip_index(ix.expand(b, -1), flip)
    return _gather_hw(clips, iy, ix).float()


def center_crop_resize(clips: torch.Tensor, crop_size: int,
                       out_size: int) -> torch.Tensor:
    """``CenterCrop(crop_size)`` (clamped to the frame, its round-half-even
    origin) then NEAREST resize to ``out_size``²: the finetune val recipe's
    p-miss path, pixel-equal to the host chain.  f32."""
    b, f, h, w, c = clips.shape
    ch, cw = min(crop_size, h), min(crop_size, w)
    y0 = int(round((h - ch) / 2.0))
    x0 = int(round((w - cw) / 2.0))
    iy = _index(y0 + _cv2_nearest_idx(out_size, ch), clips.device)
    ix = _index(x0 + _cv2_nearest_idx(out_size, cw), clips.device)
    return _gather_hw(clips, iy, ix).float()


def test_preprocess_batch(clips: torch.Tensor, img_dim: int, crop_size: int,
                          five_crop: bool = False,
                          normalize_out: bool = True) -> torch.Tensor:
    """The dense-test recipe: ``CenterCrop(crop_size)`` (or the four
    corners and the centre with ``five_crop``) → NEAREST ``Scale(img_dim)``
    → ``Normalize`` (``eval/test.py:121-126``, five crops
    ``eval/dataset_3d_lc.py:98-107``).  ``clips`` ``[R, N, SL, H, W, C]``
    uint8; returns ``[R·K, N, SL, D, D, C]``, K = 5 with ``five_crop``,
    each row's crops contiguous: f32 normalised, or uint8 when the caller
    folds the normalize into the stem (``normalize_out=False``)."""
    r, n, sl, h, w, c = clips.shape
    flat = clips.reshape(r, n * sl, h, w, c)
    ch, cw = min(crop_size, h), min(crop_size, w)
    if five_crop:  # FiveCrop's corner order and centre rounding
        corners = [(0, 0), (0, w - cw), (h - ch, 0), (h - ch, w - cw),
                   (int(round((h - ch) / 2.0)), int(round((w - cw) / 2.0)))]
    else:
        corners = [(int(round((h - ch) / 2.0)), int(round((w - cw) / 2.0)))]
    iy = _cv2_nearest_idx(img_dim, ch)
    ix = _cv2_nearest_idx(img_dim, cw)
    out = torch.stack([_gather_hw(flat, _index(y0 + iy, clips.device),
                                  _index(x0 + ix, clips.device))
                       for y0, x0 in corners], dim=1)   # [R, K, F, D, D, C]
    if normalize_out:
        out = normalize(out.float() / 255.0)
    return out.reshape(r * len(corners), n, sl, img_dim, img_dim, c)


def finetune_augment_batch(clips: torch.Tensor, draws: Draws, img_dim: int,
                           mode: str = "train", normalize_out: bool = True
                           ) -> torch.Tensor:
    """The finetune and probe recipes (``augment.finetune_transform``;
    reference ``eval/test.py:121-176``), every draw per clip:

      train: RandomSizedCrop(224) → Scale(img_dim) → flip →
             ColorJitter(.5, .5, .5, .25, p=.3) → Normalize
      val:   the crop taken with p=.3 (else CenterCrop(224) + Scale), the
             jitter at (.2, .2, .2, .1)

    The crop and its two resamples are one bilinear resample to
    ``img_dim`` (``dpc_tpu``'s, PARITY.md).  ``clips`` ``[B, N, SL, H, W,
    C]`` uint8 full-geometry windows."""
    b, n, sl, h, w, c = clips.shape
    flat = clips.reshape(b, n * sl, h, w, c)
    if mode == "train":
        out = random_resized_crop(flat, draws.crop, img_dim,
                                  flip=draws.flip) / 255.0
    elif mode == "val":
        out = torch.where(draws.crop_p.view(b, 1, 1, 1, 1),
                          random_resized_crop(flat, draws.crop, img_dim),
                          center_crop_resize(flat, 224, img_dim)) / 255.0
        out = random_hflip(out, draws.flip)
    else:
        raise ValueError(f"unknown finetune recipe mode {mode!r}")
    out = torch.where(draws.jitter_p.view(b, 1, 1, 1, 1),
                      color_jitter(out, draws.jitter), out)
    out = normalize(out) if normalize_out else out
    return out.reshape(b, n, sl, img_dim, img_dim, c)


def augment_batch(clips: torch.Tensor, draws: Draws, img_dim: int,
                  recipe: str = "sized_crop",
                  normalize_out: bool = True) -> torch.Tensor:
    """The pretrain recipes (reference ``dpc/main.py:115-133``):

      * ``'sized_crop'`` (K400): RandomSizedCrop to ``img_dim`` from the
        native-geometry window, flip;
      * ``'crop_resize'`` (UCF/HMDB): the host took the consistent 224
        crop; NEAREST Scale to ``img_dim``, flip;

    then per-frame RandomGray(p=.5) and ColorJitter(.5, .5, .5, .25) and
    Normalize.  ``clips`` ``[B, N, SL, H, W, C]`` uint8; returns ``[B, N,
    SL, img_dim, img_dim, C]`` f32."""
    if recipe not in RECIPES:
        raise ValueError(f"unknown device-augment recipe {recipe!r}; "
                         f"expected one of {RECIPES}")
    b, n, sl, h, w, c = clips.shape
    flat = clips.reshape(b, n * sl, h, w, c)
    if recipe == "sized_crop":
        x = random_resized_crop(flat, draws.crop, img_dim, flip=draws.flip)
    else:
        x = resize_fixed(flat, img_dim, flip=draws.flip)
    x = random_gray(x / 255.0, draws.gray, draws.gray_chan)
    x = color_jitter(x, draws.jitter)
    x = normalize(x) if normalize_out else x
    return x.reshape(b, n, sl, img_dim, img_dim, c)
