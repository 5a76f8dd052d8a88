"""Synthetic video dataset: deterministic procedurally-generated clips
(a copy of ``dpc_tpu/data/synthetic.py``).

Plays the role of the reference's ``unit_test`` 32-video subsample
(``dpc/dataset_3d.py:85``) but without any real data on disk: every video
is a moving-pattern animation generated from its index, with genuine
temporal structure (constant-velocity motion) so that DPC pretraining has
signal to learn and smoke runs can show a falling loss.  Class label =
motion direction bucket, so LC finetuning is learnable too.
"""

from __future__ import annotations

import numpy as np

from dpc_tpu_torch.core import shapes
from dpc_tpu_torch.data.augment import Compose, Normalize


class SyntheticVideoDataset:
    """API-compatible with FrameClipDataset.sample()."""

    def __init__(self, transform: Compose | None = None, *,
                 num_videos: int = 32, video_len: int = 256,
                 frame_size: int = 150, num_seq: int = 8, seq_len: int = 5,
                 downsample: int = 3, mode: str = "train",
                 return_label: bool = False, num_classes: int = 8,
                 window_stride: int | None = None, seed: int = 0,
                 tail_window: bool = False):
        self.transform = transform or Compose([Normalize()])
        self.num_videos = num_videos
        self.video_len = video_len
        self.frame_size = frame_size
        self.num_seq = num_seq
        self.seq_len = seq_len
        self.downsample = downsample
        self.mode = mode
        self.return_label = return_label
        self.num_classes = num_classes
        self.window_stride = window_stride or max(1, num_seq // 2)
        self.tail_window = tail_window
        self.seed = seed
        self.class_names = {i: f"motion_{i}" for i in range(num_classes)}
        assert video_len > shapes.clip_span(num_seq, seq_len, downsample)

    def __len__(self) -> int:
        return self.num_videos

    def _label(self, vid: int) -> int:
        return vid % self.num_classes

    def _render_frames(self, vid: int, frame_ids: np.ndarray) -> np.ndarray:
        """Render frames of video ``vid`` at times ``frame_ids`` (uint8)."""
        s = self.frame_size
        vrng = np.random.default_rng(self.seed * 100003 + vid)
        # static per-video appearance
        base_color = vrng.integers(40, 216, size=3)
        bg_phase = vrng.uniform(0, 2 * np.pi, size=2)
        blob = vrng.uniform(0.08, 0.2) * s          # blob radius
        # motion defines the class: direction bucket + per-video speed
        angle = (2 * np.pi * self._label(vid) / self.num_classes
                 + vrng.uniform(-0.2, 0.2))
        speed = vrng.uniform(0.5, 1.5) * s / 64.0
        x0, y0 = vrng.uniform(0.2 * s, 0.8 * s, size=2)

        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        frames = np.empty((len(frame_ids), s, s, 3), np.uint8)
        for i, t in enumerate(np.asarray(frame_ids, np.float32)):
            cx = (x0 + speed * t * np.cos(angle)) % s
            cy = (y0 + speed * t * np.sin(angle)) % s
            # toroidal distance so the blob wraps smoothly
            dx = np.minimum(np.abs(xx - cx), s - np.abs(xx - cx))
            dy = np.minimum(np.abs(yy - cy), s - np.abs(yy - cy))
            mask = np.exp(-(dx * dx + dy * dy) / (2 * blob * blob))
            bg = (0.5 + 0.25 * np.sin(2 * np.pi * xx / s + bg_phase[0])
                  + 0.25 * np.sin(2 * np.pi * yy / s + bg_phase[1]))
            for ch in range(3):
                frames[i, :, :, ch] = np.clip(
                    bg * 80 + mask * base_color[ch] + 20, 0, 255
                ).astype(np.uint8)
        return frames

    def sample(self, index: int, rng: np.random.Generator):
        if self.mode == "test":
            windows = shapes.test_time_windows(
                self.video_len, self.num_seq, self.seq_len,
                self.downsample, self.window_stride,
                tail_window=self.tail_window)
            nw = windows.shape[0]
            # overlapping windows (stride num_seq//2) share ~half their
            # frames: render each unique frame once and gather — exact
            # (per-frame rendering is a pure function of the per-video
            # params and t; same dedupe FrameClipDataset does for decode)
            flat = windows.reshape(-1)
            uniq, inv = np.unique(flat, return_inverse=True)
            frames = self._render_frames(index, uniq)[inv]
            clip = self.transform(frames, rng)
            h, w, c = clip.shape[-3:]
            # multi-crop transforms (FiveCrop) return [k, T, h, w, c]:
            # crops ride the window axis, like FrameClipDataset
            clip = clip.reshape(-1, self.num_seq, self.seq_len, h, w, c)
            assert clip.shape[0] % nw == 0, (clip.shape, nw)
            return (clip, self._label(index)) if self.return_label else clip

        start = shapes.sample_clip_start(rng, self.video_len, self.num_seq,
                                         self.seq_len, self.downsample)
        idx = shapes.clip_block_indices(start, self.num_seq, self.seq_len,
                                        self.downsample)
        frames = self._render_frames(index, idx.reshape(-1))
        clip = self.transform(frames, rng)
        h, w, c = clip.shape[-3:]
        clip = clip.reshape(self.num_seq, self.seq_len, h, w, c)
        return (clip, self._label(index)) if self.return_label else clip
