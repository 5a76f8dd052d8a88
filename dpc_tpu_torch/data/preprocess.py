"""Offline preprocessing: video → JPEG frame trees + split CSVs.

The port's copy of ``dpc_tpu/data/preprocess.py`` (reference
``process_data/src/{extract_frame,write_csv}.py``), with the same names,
arguments and outputs.  ``extract`` decodes each video with OpenCV,
resizes it so the short side hits a per-dataset target (UCF/HMDB 240px,
K400 150px or 256px), and writes ``image_%05d.jpg`` (1-based, quality
80); the CSV subcommands walk the official split files and write
``(video_dir, num_frames)`` rows.

Video is decoded with OpenCV, which the port does not otherwise need:
``cv2`` is imported inside :func:`extract_video` only, so the CSV half
(``csv-ucf``, ``csv-hmdb``, ``csv-classdirs``, ``classind``) runs on a
machine without it.

As in ``dpc_tpu`` (not silently different from the reference):
  * resumable per video: a ``.done`` marker holding the frame count is
    written after the last frame, so an interrupted run redoes only the
    video it was in;
  * unreadable videos are appended to ``failed.txt``;
  * the Kinetics class-dir CSV path works (``csv-classdirs``).

    python -m dpc_tpu_torch.data.preprocess csv-ucf ucfTrainTestlist \\
        /data/ucf101/frame /data/ucf101 --split 1
"""

from __future__ import annotations

import csv
import glob
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterable, Optional


def resize_dims(w: int, h: int, short_side: int) -> tuple[int, int]:
    """Target (width, height) so min(w, h) == short_side, aspect kept
    (``extract_frame.py:39-44``)."""
    if w >= h:
        return int(round(w * short_side / h)), short_side
    return short_side, int(round(h * short_side / w))


def extract_video(video_path: str, out_dir: str, short_side: int = 256,
                  quality: int = 80) -> int:
    """Decode one video into ``out_dir/image_%05d.jpg``.  Returns the frame
    count (0 on failure).  Resumable: skips when ``.done`` exists.  Needs
    OpenCV."""
    done_marker = os.path.join(out_dir, ".done")
    if os.path.exists(done_marker):
        return len(glob.glob(os.path.join(out_dir, "*.jpg")))
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "extracting frames needs OpenCV (cv2), the only video decoder "
            "the port uses; the CSV subcommands (csv-ucf, csv-hmdb, "
            "csv-classdirs, classind) need none") from e
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return 0
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    count = 0
    size: Optional[tuple[int, int]] = None
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if size is None:  # the first frame's size holds for the video
                h, w = frame.shape[:2]
                size = resize_dims(w, h, short_side)
            if (frame.shape[1], frame.shape[0]) != size:
                frame = cv2.resize(frame, size,
                                   interpolation=cv2.INTER_LINEAR)
            count += 1
            cv2.imwrite(os.path.join(out_dir, f"image_{count:05d}.jpg"),
                        frame, params)
    finally:
        cap.release()
    if count > 0:
        with open(done_marker, "w") as f:
            f.write(str(count))
    return count


def extract_tree(video_root: str, out_root: str, short_side: int,
                 extensions: Iterable[str] = (".avi", ".mp4", ".webm"),
                 num_workers: int = 8, use_processes: bool = True) -> None:
    """Extract every video under ``video_root`` (class-dir layout) into
    ``out_root/<class>/<video-stem>/`` frame dirs, in parallel."""
    jobs = []
    for dirpath, _, files in os.walk(video_root):
        for fname in sorted(files):
            if os.path.splitext(fname)[1].lower() in extensions:
                rel = os.path.relpath(dirpath, video_root)
                stem = os.path.splitext(fname)[0]
                jobs.append((os.path.join(dirpath, fname),
                             os.path.join(out_root, rel, stem)))
    pool_cls = ProcessPoolExecutor if use_processes else ThreadPoolExecutor
    failed = []
    with pool_cls(num_workers) as pool:
        futures = {pool.submit(extract_video, src, dst, short_side): src
                   for src, dst in jobs}
        for fut, src in futures.items():
            if fut.result() == 0:
                failed.append(src)
    if failed:
        with open(os.path.join(out_root, "failed.txt"), "a") as f:
            f.write("\n".join(failed) + "\n")
    print(f"extracted {len(jobs) - len(failed)}/{len(jobs)} videos "
          f"→ {out_root}")


def count_frames(video_dir: str) -> int:
    return len(glob.glob(os.path.join(video_dir, "*.jpg")))


def write_split_csv(video_dirs: list[str], out_csv: str,
                    num_workers: int = 8) -> int:
    """Emit ``(video_dir, num_frames)`` rows; drops empty dirs
    (``write_csv.py:5-10,46-52``)."""
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with ThreadPoolExecutor(num_workers) as pool:
        counts = list(pool.map(count_frames, video_dirs))
    kept = 0
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f)
        for vdir, n in zip(video_dirs, counts):
            if n > 0:
                writer.writerow([vdir, n])
                kept += 1
    print(f"wrote {kept}/{len(video_dirs)} rows → {out_csv}")
    return kept


def ucf_split_to_dirs(split_file: str, frame_root: str) -> list[str]:
    """Official UCF101 ``trainlist0X.txt``/``testlist0X.txt`` → frame dirs
    (``write_csv.py:12-32``)."""
    dirs = []
    with open(split_file) as f:
        for line in f:
            line = line.strip().split(" ")[0]
            if not line:
                continue
            rel = os.path.splitext(line)[0]  # ClassName/v_...avi
            dirs.append(os.path.join(frame_root, rel))
    return dirs


def hmdb_split_to_dirs(splits_root: str, frame_root: str,
                       which_split: int) -> tuple[list[str], list[str]]:
    """Official HMDB51 per-class ``<action>_test_split<N>.txt`` files →
    (train_dirs, test_dirs) (``write_csv.py:34-53``): each line is
    ``video.avi <type>`` with type 1 = train, 2 = test, 0 = unused."""
    pattern = os.path.join(splits_root, f"*_test_split{which_split}.txt")
    split_files = sorted(glob.glob(pattern))
    if not split_files:
        raise FileNotFoundError(f"no HMDB split files match {pattern}")
    suffix = len(f"_test_split{which_split}.txt")
    train, test = [], []
    for split_file in split_files:
        action = os.path.basename(split_file)[:-suffix]
        with open(split_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                stem = os.path.splitext(parts[0])[0]
                vpath = os.path.join(frame_root, action, stem)
                if parts[1] == "1":
                    train.append(vpath)
                elif parts[1] == "2":
                    test.append(vpath)
    return train, test


def class_dirs_to_dirs(frame_root: str) -> list[str]:
    """All video dirs under a class-dir frame tree (the K400 convention)."""
    return sorted(
        d for d in glob.glob(os.path.join(frame_root, "*", "*"))
        if os.path.isdir(d))


def write_class_index(class_names: list[str], out_path: str) -> None:
    """``classInd.txt`` with 1-based ids, matching the UCF format."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        for i, name in enumerate(sorted(class_names)):
            f.write(f"{i + 1},{name}\n")


def main(argv=None) -> None:
    """CLI: extract frames and/or write split CSVs.

    Examples:
      python -m dpc_tpu_torch.data.preprocess extract /videos/UCF101 \\
          /data/ucf101/frame --short_side 256
      python -m dpc_tpu_torch.data.preprocess csv-ucf ucfTrainTestlist \\
          /data/ucf101/frame /data/ucf101 --split 1
      python -m dpc_tpu_torch.data.preprocess csv-classdirs \\
          /data/k400/frame /data/kinetics400/train_split.csv
    """
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("extract", help="videos -> JPEG frame trees "
                                        "(needs OpenCV)")
    ex.add_argument("video_root")
    ex.add_argument("out_root")
    ex.add_argument("--short_side", type=int, default=256,
                    help="UCF/HMDB 256(240), K400 150 or 256")
    ex.add_argument("--workers", type=int, default=8)

    cu = sub.add_parser("csv-ucf", help="official UCF split lists -> CSVs")
    cu.add_argument("split_dir", help="dir with trainlist0X/testlist0X.txt")
    cu.add_argument("frame_root")
    cu.add_argument("out_dir")
    cu.add_argument("--split", type=int, default=1)

    ch = sub.add_parser("csv-hmdb", help="official HMDB51 per-class "
                                         "*_test_split<N>.txt lists -> CSVs")
    ch.add_argument("split_dir", help="dir with <action>_test_split<N>.txt")
    ch.add_argument("frame_root")
    ch.add_argument("out_dir")
    ch.add_argument("--split", type=int, default=1)

    cc = sub.add_parser("csv-classdirs",
                        help="class-dir frame tree -> one CSV (K400 style)")
    cc.add_argument("frame_root")
    cc.add_argument("out_csv")

    ci = sub.add_parser("classind", help="write classInd.txt from class dirs")
    ci.add_argument("frame_root")
    ci.add_argument("out_path")

    args = p.parse_args(argv)
    if args.cmd == "extract":
        extract_tree(args.video_root, args.out_root, args.short_side,
                     num_workers=args.workers)
    elif args.cmd == "csv-ucf":
        for name, out in (("trainlist", "train_split"),
                          ("testlist", "test_split")):
            lst = os.path.join(args.split_dir,
                               f"{name}{args.split:02d}.txt")
            if not os.path.exists(lst):
                print(f"skip missing {lst}")
                continue
            dirs = ucf_split_to_dirs(lst, args.frame_root)
            write_split_csv(dirs, os.path.join(
                args.out_dir, f"{out}{args.split:02d}.csv"))
    elif args.cmd == "csv-hmdb":
        train, test = hmdb_split_to_dirs(args.split_dir, args.frame_root,
                                         args.split)
        for dirs, out in ((train, "train_split"), (test, "test_split")):
            write_split_csv(dirs, os.path.join(
                args.out_dir, f"{out}{args.split:02d}.csv"))
    elif args.cmd == "csv-classdirs":
        write_split_csv(class_dirs_to_dirs(args.frame_root), args.out_csv)
    elif args.cmd == "classind":
        classes = sorted(os.listdir(args.frame_root))
        write_class_index(classes, args.out_path)


if __name__ == "__main__":
    main()
