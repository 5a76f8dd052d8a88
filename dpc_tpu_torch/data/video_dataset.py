"""Frame-tree video datasets: clip samplers over offline-extracted JPEGs
(a copy of ``dpc_tpu/data/video_dataset.py``, decoding through the port's
own codec, ``dpc_tpu_torch.native``).

Disk layout (the reference's, ``dpc/dataset_3d.py:97-106``): each video is
a directory of ``image_%05d.jpg`` frames (1-indexed), and a split CSV lists
``(video_dir, num_frames)`` rows.  Split CSVs and ``classInd.txt`` live
under ``{data_root}/{dataset}/``.

Kept from ``dpc_tpu``:
  * short videos are dropped from every split (``dpc/dataset_3d.py:76-82``);
  * a uniform random clip start on the stride lattice (``:88-95``);
  * the val split is the TEST split, 30% subsampled with seed 666;
  * labels from ``classInd.txt``, 0-based;
  * test mode: every frame, non-overlapping ``seq_len`` blocks, windows of
    ``num_seq`` blocks (stride N/2 on UCF, 3N/4 on HMDB's plain test;
    ``eval/dataset_3d_lc.py:76-78,109-125``), each unique frame decoded
    once; ``keep_short_test`` keeps videos shorter than one clip as one
    padded window (PARITY.md #10);
  * the ``unit_test`` subsample of 32 videos (``dpc/dataset_3d.py:85``);
  * the planned decode of ``--device_augment``: a transform with a
    ``plan`` (``augment.HostScaleCrop``) runs inside the JPEG decode.

Where the plan cannot run (a portrait frame that needs padding, a frame
the ROI decode rejects), the sample falls back to the full decode and the
transform's numpy path; :func:`planned_fallbacks` counts those samples.  A
frame the codec cannot decode at all raises: there is no second decoder to
fall back to.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from dpc_tpu_torch import native
from dpc_tpu_torch.core import shapes
from dpc_tpu_torch.data import augment
from dpc_tpu_torch.data.augment import Compose


def count_fallbacks(*datasets) -> Optional[dict[str, int]]:
    """The planned-decode fallbacks of the datasets that plan (None when
    none does), summed by reason."""
    planned = [d for d in datasets if hasattr(d.transform, "plan")
               and hasattr(d, "planned_fallbacks")]
    if not planned:
        return None
    counts = {"unplanned": 0, "undecoded": 0}
    for d in planned:
        for k, v in d.planned_fallbacks().items():
            counts[k] += v
    return counts


def load_frame(path: str,
               target_hw: Optional[tuple[int, int]] = None) -> np.ndarray:
    """Decode one JPEG to RGB uint8 ``[H, W, 3]``, resized to ``target_hw``
    when given."""
    return native.decode_file(path, target_hw)


def read_split_csv(path: str) -> list[tuple[str, int]]:
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row:
                continue
            rows.append((row[0], int(float(row[1]))))
    return rows


def read_class_index(path: str) -> dict[str, int]:
    """``classInd.txt``: 'id,name' or 'id name' rows, ids 1-based on disk,
    0-based in memory (``dpc/dataset_3d.py:47-56``)."""
    mapping: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.replace(",", " ").split()
            mapping[parts[1]] = int(parts[0]) - 1
    return mapping


@dataclass
class VideoRecord:
    path: str
    num_frames: int
    label: int = -1


class FrameClipDataset:
    """Random-clip sampler over a list of video frame directories."""

    def __init__(self, records: list[VideoRecord], transform: Compose, *,
                 num_seq: int = 8, seq_len: int = 5, downsample: int = 3,
                 mode: str = "train", return_label: bool = False,
                 window_stride: Optional[int] = None,
                 class_names: Optional[dict[int, str]] = None,
                 decode_threads: int = 4,
                 keep_short_test: bool = False,
                 tail_window: bool = False):
        self.transform = transform
        self.decode_threads = decode_threads
        self.num_seq = num_seq
        self.seq_len = seq_len
        self.downsample = downsample
        self.mode = mode
        self.return_label = return_label
        self.window_stride = window_stride or max(1, num_seq // 2)
        self.class_names = class_names or {}
        self.tail_window = tail_window
        # one reason per sample that fell back from the planned decode
        # (list.append is atomic, so thread workers need no lock; process
        # workers send theirs back with each sample, see data/loader.py)
        self.fallbacks: list[str] = []
        span = shapes.clip_span(num_seq, seq_len, downsample)
        # the reference drops too-short videos from every split, test
        # included (eval/dataset_3d_lc.py:61-67); keep_short_test keeps
        # them in the test split as one padded window (PARITY.md #10)
        if mode == "test" and keep_short_test:
            self.records = [r for r in records if r.num_frames > 0]
        else:
            self.records = [r for r in records if r.num_frames > span]

    def __len__(self) -> int:
        return len(self.records)

    def planned_fallbacks(self) -> dict[str, int]:
        """Samples of a plan-capable transform decoded in full instead:
        ``unplanned`` (the plan declined the frame size), ``undecoded``
        (the ROI decode failed a frame)."""
        return {k: self.fallbacks.count(k)
                for k in ("unplanned", "undecoded")}

    def _frame_path(self, record: VideoRecord, idx: int) -> str:
        return os.path.join(record.path, f"image_{idx + 1:05d}.jpg")

    def _load_frames(self, record: VideoRecord,
                     indices: np.ndarray) -> np.ndarray:
        """Decode the frames at ``indices`` in one native call (a pthread
        pool with the interpreter lock released)."""
        # clamp: a CSV's frame count can overcount by one
        flat = np.minimum(indices.reshape(-1), record.num_frames - 1)
        paths = [self._frame_path(record, int(i)) for i in flat]
        buffers = []
        for p in paths:
            with open(p, "rb") as f:
                buffers.append(f.read())
        # frames of one video share their size (the extraction contract):
        # frame 0's header sets the batch shape
        th, tw = native.jpeg_dims(buffers[0])
        out, failures = native.decode_jpeg_batch(
            buffers, th, tw, threads=self.decode_threads)
        if failures:
            raise ValueError(f"{failures} of {len(paths)} frames of "
                             f"{record.path} did not decode")
        return out

    def sample(self, index: int, rng: np.random.Generator):
        """Load + transform one item.

        train/val: ``[N, SL, H, W, 3]`` (plus int label when
        ``return_label``).  test: ``[num_windows, N, SL, H, W, 3]``, the
        crops of a multi-crop transform riding the window axis.
        """
        record = self.records[index]
        planned = hasattr(self.transform, "plan")
        if self.mode == "test":
            windows = shapes.test_time_windows(
                record.num_frames, self.num_seq, self.seq_len,
                self.downsample, self.window_stride,
                tail_window=self.tail_window)
            # decode and transform each unique frame once (the windows
            # overlap); valid for a frame-consistent transform, which the
            # dense-test recipes are; the inverse gather restores the
            # windows' frame order exactly
            flat = np.minimum(windows.reshape(-1), record.num_frames - 1)
            uniq, inverse = np.unique(flat, return_inverse=True)
            clip = None
            if planned:  # a plan is per clip, so the dedupe is exact
                clip = self._load_frames_planned(record, uniq, rng)
                if clip is not None:
                    clip = clip[inverse]
            if clip is None:
                if augment.frame_consistent(self.transform):
                    # plain transforms return [U, h, w, c], multi-crop
                    # ones [k, U, h, w, c]: gather on the frame axis
                    clip = np.take(self.transform(
                        self._load_frames(record, uniq), rng), inverse,
                        axis=-4)
                else:
                    clip = self.transform(self._load_frames(record, windows),
                                          rng)
            h, w, c = clip.shape[-3:]
            clip = clip.reshape(-1, self.num_seq, self.seq_len, h, w, c)
            return (clip, record.label) if self.return_label else clip

        start = shapes.sample_clip_start(rng, record.num_frames,
                                         self.num_seq, self.seq_len,
                                         self.downsample)
        if start is None:
            raise ValueError(f"{record.path}: {record.num_frames} frames "
                             "are too few for one clip")
        indices = shapes.clip_block_indices(start, self.num_seq,
                                            self.seq_len, self.downsample)
        clip = (self._load_frames_planned(record, indices, rng)
                if planned else None)
        if clip is None:
            clip = self.transform(self._load_frames(record, indices), rng)
        h, w, c = clip.shape[-3:]
        clip = clip.reshape(self.num_seq, self.seq_len, h, w, c)
        return (clip, record.label) if self.return_label else clip

    def _load_frames_planned(self, record: VideoRecord, indices: np.ndarray,
                             rng: np.random.Generator
                             ) -> Optional[np.ndarray]:
        """Run a plan-capable transform (``augment.HostScaleCrop``) inside
        one batch ROI decode: the plan is made from the first frame's
        header (the frames of a video share their size) before the other
        frames are read.  Returns None, counted, where the full decode and
        the numpy path must take over; that path draws afresh, which is
        fine: any consistent window is a valid sample."""
        flat = np.minimum(indices.reshape(-1), record.num_frames - 1)
        with open(self._frame_path(record, int(flat[0])), "rb") as f:
            first = f.read()
        plan = self.transform.plan(native.jpeg_dims(first), rng)
        if plan is None:
            self.fallbacks.append("unplanned")
            return None
        buffers = [first]
        for i in flat[1:]:
            with open(self._frame_path(record, int(i)), "rb") as f:
                buffers.append(f.read())
        short, crop = plan
        out, failures = native.decode_jpeg_batch_scale_crop(
            buffers, short, crop, threads=self.decode_threads)
        if failures:
            self.fallbacks.append("undecoded")
            return None
        return out


def _subsample(records: list[VideoRecord], frac: float,
               seed: int = 666) -> list[VideoRecord]:
    rng = np.random.default_rng(seed)
    n = max(1, int(round(len(records) * frac)))
    idx = rng.permutation(len(records))[:n]
    return [records[i] for i in sorted(idx)]


def _labelled_records(rows: list[tuple[str, int]],
                      encode: dict[str, int]) -> list[VideoRecord]:
    recs = []
    for vpath, vlen in rows:
        # the action's name is a directory above the video's
        parts = os.path.normpath(vpath).split(os.sep)
        label = -1
        for p in reversed(parts[:-1]):
            if p in encode:
                label = encode[p]
                break
        recs.append(VideoRecord(vpath, vlen, label))
    return recs


def make_dataset(dataset: str, data_root: str, mode: str,
                 transform: Compose, *, num_seq: int = 8, seq_len: int = 5,
                 downsample: int = 3, split: int = 1, big: bool = False,
                 return_label: bool = False, unit_test: bool = False,
                 val_subsample: float = 0.3, keep_short_test: bool = False,
                 tail_window: bool = False,
                 five_crop: bool = False) -> FrameClipDataset:
    """The ucf101 / hmdb51 / k400 split conventions.

    ucf101/hmdb51: ``{root}/{name}/{train|test}_split{split:02d}.csv``
    (``dpc/dataset_3d.py:155-165``), val reading the test split; k400:
    ``{root}/kinetics400[_256]/{train|val}_split.csv``
    (``dpc/dataset_3d.py:59-74``).
    """
    if dataset == "k400":
        sub = "kinetics400_256" if big else "kinetics400"
        split_file = os.path.join(
            data_root, sub,
            "train_split.csv" if mode == "train" else "val_split.csv")
        class_file = os.path.join(data_root, "kinetics400", "classInd.txt")
    elif dataset in ("ucf101", "hmdb51"):
        # the reference validates on the TEST split, 30%-subsampled
        # (dpc/dataset_3d.py:157-163,184; eval/dataset_3d_lc.py:41-46,69)
        part = "train" if mode == "train" else "test"
        split_file = os.path.join(data_root, dataset,
                                  f"{part}_split{split:02d}.csv")
        class_file = os.path.join(data_root, dataset, "classInd.txt")
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

    rows = read_split_csv(split_file)
    encode = read_class_index(class_file) if os.path.exists(class_file) \
        else {}
    records = _labelled_records(rows, encode)
    if mode == "val" and val_subsample < 1.0:
        records = _subsample(records, val_subsample)
    if unit_test:
        records = _subsample(records, min(1.0, 32 / max(len(records), 1)))
    names = {v: k for k, v in encode.items()}
    # dense-test window stride: N/2 on UCF and in the multi-crop test, 3N/4
    # on HMDB's plain test (eval/dataset_3d_lc.py:119,124 vs :249,254)
    window_stride = (3 * num_seq // 4
                     if dataset == "hmdb51" and not five_crop
                     else num_seq // 2)
    return FrameClipDataset(records, transform, num_seq=num_seq,
                            seq_len=seq_len, downsample=downsample,
                            mode=mode, return_label=return_label,
                            window_stride=window_stride, class_names=names,
                            keep_short_test=keep_short_test,
                            tail_window=tail_window)
