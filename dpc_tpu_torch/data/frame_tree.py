"""Write a frame tree in the reference's layout from synthetic videos, for
tests and smoke runs that have no real videos (real videos go through
``data/preprocess.py``'s ``extract``, which needs OpenCV).

Each video is rendered as ``data/synthetic.py`` renders it (a blob moving
at constant velocity over a smooth background, the class set by the
direction of motion), cut to ``height × width`` and written with the
port's JPEG encoder as ``{root}/{dataset}/frame/{class}/{video}/
image_%05d.jpg``, with ``classInd.txt`` and the ``train``/``test`` split
CSVs of ``video_dataset.make_dataset``'s layout beside them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from dpc_tpu_torch import native
from dpc_tpu_torch.data.synthetic import SyntheticVideoDataset

MOTION_CLASSES = 8  # the synthetic videos' direction buckets
QUALITY = 90


def render_frames(video: int, frame_ids: np.ndarray, height: int = 240,
                  width: int = 320) -> np.ndarray:
    """Frames ``frame_ids`` of synthetic video ``video``, uint8
    ``[T, height, width, 3]``: the centre of a square render."""
    side = max(height, width)
    frames = SyntheticVideoDataset(
        num_videos=video + 1, video_len=2, frame_size=side, num_seq=1,
        seq_len=1, downsample=1, num_classes=MOTION_CLASSES
    )._render_frames(video, frame_ids)
    y0, x0 = (side - height) // 2, (side - width) // 2
    return np.ascontiguousarray(frames[:, y0:y0 + height, x0:x0 + width])


def write_frame_tree(root: str, dataset: str = "ucf101", *,
                     num_videos: int = 16, num_frames: int = 150,
                     height: int = 240, width: int = 320,
                     num_classes: int = 101, train_rows: int = 128,
                     test_rows: int = 224, workers: int = 8) -> str:
    """Render and encode ``num_videos`` distinct videos of ``num_frames``
    frames, list them ``train_rows`` and ``test_rows`` times (cycling) in
    the split CSVs, and return the data root to pass as ``--data_root``.
    Video ``v`` moves in direction bucket ``v % MOTION_CLASSES`` and is
    filed under class ``v % MOTION_CLASSES`` of ``num_classes``; the split
    CSVs are split 1's."""
    base = os.path.join(root, dataset)
    names = [f"class{i + 1:03d}" for i in range(num_classes)]

    def video_dir(v: int) -> str:
        cls = names[v % MOTION_CLASSES]
        return os.path.join(base, "frame", cls, f"v_{cls}_g{v + 1:02d}_c01")

    def write_video(v: int) -> None:
        out = video_dir(v)
        os.makedirs(out, exist_ok=True)
        frames = render_frames(v, np.arange(num_frames), height, width)
        for i, frame in enumerate(frames):
            native.encode_file(os.path.join(out, f"image_{i + 1:05d}.jpg"),
                               frame, QUALITY)

    with ThreadPoolExecutor(max(1, workers)) as pool:
        list(pool.map(write_video, range(num_videos)))
    with open(os.path.join(base, "classInd.txt"), "w") as f:
        f.writelines(f"{i + 1} {n}\n" for i, n in enumerate(names))
    for part, rows in (("train", train_rows), ("test", test_rows)):
        with open(os.path.join(base, f"{part}_split01.csv"), "w") as f:
            f.writelines(f"{video_dir(r % num_videos)},{num_frames}\n"
                         for r in range(rows))
    return root
