"""The port's offline toolkit (``dpc_tpu_torch/data/preprocess.py``)
against ``dpc_tpu``'s on the same inputs.

Both packages decode and encode with the same OpenCV, so the frame files,
the directory layout, the ``.done`` markers and ``failed.txt`` must be
byte-equal; so must every CSV and ``classInd.txt`` the subcommands write.
The CSV half must run, and ``extract_video`` must raise the ImportError
that names OpenCV, in a process where ``cv2`` cannot be imported.  No
process pool is started (``extract`` runs on threads).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dpc_tpu.data import preprocess as jax_pre
from dpc_tpu_torch.data import preprocess

ROOT = Path(__file__).resolve().parent.parent


def _tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _write_videos(root: Path) -> None:
    """Two tiny MJPG videos (one portrait) and one corrupt file, in class
    dirs."""
    import cv2

    rng = np.random.default_rng(0)
    for cls, name, (w, h), n in (("classA", "v_a.avi", (80, 64), 12),
                                 ("classB", "v_b.avi", (48, 70), 7)):
        (root / cls).mkdir(parents=True, exist_ok=True)
        wr = cv2.VideoWriter(str(root / cls / name),
                             cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
        for _ in range(n):
            wr.write(rng.integers(0, 255, (h, w, 3), np.uint8))
        wr.release()
    (root / "classB" / "broken.avi").write_bytes(b"not a video at all")


def test_extract_tree_byte_equal_and_resumable(tmp_path):
    videos = tmp_path / "videos"
    _write_videos(videos)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for mod, out in ((preprocess, ours), (jax_pre, theirs)):
        mod.extract_tree(str(videos), str(out), short_side=32,
                         num_workers=1, use_processes=False)
    got = _tree_bytes(ours)
    assert got == _tree_bytes(theirs)
    assert sorted(p.relative_to(ours).as_posix() for p in ours.rglob("*")
                  if p.is_dir()) == sorted(
        p.relative_to(theirs).as_posix() for p in theirs.rglob("*")
        if p.is_dir())
    assert got["classA/v_a/.done"] == b"12"
    assert got["classB/v_b/.done"] == b"7"
    assert "classA/v_a/image_00012.jpg" in got
    assert got["failed.txt"] == (str(videos / "classB" / "broken.avi")
                                 + "\n").encode()

    # a second run skips the finished videos through .done and retries
    # (and again records) the broken one, as dpc_tpu's does
    stamp = (ours / "classA" / "v_a" / "image_00001.jpg").stat().st_mtime_ns
    for mod, out in ((preprocess, ours), (jax_pre, theirs)):
        mod.extract_tree(str(videos), str(out), short_side=32,
                         num_workers=1, use_processes=False)
    assert (ours / "classA" / "v_a" / "image_00001.jpg"
            ).stat().st_mtime_ns == stamp
    assert preprocess.extract_video(str(videos / "classA" / "v_a.avi"),
                                    str(ours / "classA" / "v_a"), 32) == 12
    assert _tree_bytes(ours) == _tree_bytes(theirs)
    assert (ours / "failed.txt").read_text().count("broken.avi") == 2


def test_resize_dims_match():
    for w in (1, 2, 31, 48, 64, 70, 171, 320, 341, 1920):
        for h in (1, 3, 48, 64, 70, 128, 240, 256, 1080):
            for s in (32, 150, 240, 256):
                assert preprocess.resize_dims(w, h, s) == \
                    jax_pre.resize_dims(w, h, s), (w, h, s)


def _frame_tree(root: Path) -> Path:
    """A class-dir frame tree with one empty video dir."""
    frames = root / "frame"
    for cls, vid, n in (("Basketball", "v_Basketball_g01_c01", 3),
                        ("Basketball", "v_Basketball_g02_c01", 5),
                        ("ApplyLipstick", "v_ApplyLipstick_g01_c01", 2),
                        ("ApplyLipstick", "v_ApplyLipstick_g03_c02", 0)):
        d = frames / cls / vid
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"image_{i + 1:05d}.jpg").write_bytes(b"x")
    return frames


def _hmdb_lists(root: Path) -> Path:
    sd = root / "hmdb_splits"
    sd.mkdir()
    (sd / "Basketball_test_split1.txt").write_text(
        "v_Basketball_g01_c01.avi 1 \nv_Basketball_g02_c01.avi 2 \n"
        "v_gone.avi 0 \n")
    (sd / "ApplyLipstick_test_split1.txt").write_text(
        "v_ApplyLipstick_g01_c01.avi 1 \nv_ApplyLipstick_g03_c02.avi 2 \n")
    (sd / "Basketball_test_split2.txt").write_text(
        "v_Basketball_g02_c01.avi 1 \n")
    return sd


def _ucf_lists(root: Path) -> Path:
    sd = root / "ucf_lists"
    sd.mkdir()
    (sd / "trainlist01.txt").write_text(
        "Basketball/v_Basketball_g01_c01.avi 2\n"
        "ApplyLipstick/v_ApplyLipstick_g01_c01.avi 1\n\n"
        "ApplyLipstick/v_ApplyLipstick_g03_c02.avi 1\n"
        "Basketball/v_Basketball_g01_c01.avi 2\n")
    (sd / "testlist01.txt").write_text(
        "Basketball/v_Basketball_g02_c01.avi\n")
    return sd


def test_csv_helpers_byte_equal(tmp_path):
    frames = _frame_tree(tmp_path)
    fr = str(frames)
    lists = _ucf_lists(tmp_path)
    train = preprocess.ucf_split_to_dirs(str(lists / "trainlist01.txt"), fr)
    assert train == jax_pre.ucf_split_to_dirs(
        str(lists / "trainlist01.txt"), fr)
    assert len(train) == 4
    hm = _hmdb_lists(tmp_path)
    got = preprocess.hmdb_split_to_dirs(str(hm), fr, 1)
    assert got == jax_pre.hmdb_split_to_dirs(str(hm), fr, 1)
    assert got == ([f"{fr}/ApplyLipstick/v_ApplyLipstick_g01_c01",
                    f"{fr}/Basketball/v_Basketball_g01_c01"],
                   [f"{fr}/ApplyLipstick/v_ApplyLipstick_g03_c02",
                    f"{fr}/Basketball/v_Basketball_g02_c01"])
    for mod in (preprocess, jax_pre):
        with pytest.raises(FileNotFoundError):
            mod.hmdb_split_to_dirs(str(hm), fr, 3)
    dirs = preprocess.class_dirs_to_dirs(fr)
    assert dirs == jax_pre.class_dirs_to_dirs(fr) and len(dirs) == 4

    outs = {}
    for name, mod in (("ours", preprocess), ("theirs", jax_pre)):
        out = tmp_path / name
        kept = mod.write_split_csv(train + dirs, str(out / "split.csv"),
                                   num_workers=2)
        assert kept == 6   # the empty dir is dropped, twice
        mod.write_class_index(["Basketball", "ApplyLipstick"],
                              str(out / "classInd.txt"))
        outs[name] = _tree_bytes(out)
    assert outs["ours"] == outs["theirs"]
    assert outs["ours"]["split.csv"].count(b"\r\n") == 6
    assert outs["ours"]["classInd.txt"] == b"1,ApplyLipstick\n2,Basketball\n"


@pytest.mark.parametrize("cmd", ["extract", "csv-ucf", "csv-hmdb",
                                 "csv-classdirs", "classind"])
def test_main_subcommands_byte_equal(cmd, tmp_path, monkeypatch, capsys):
    frames = _frame_tree(tmp_path)
    args = {"csv-ucf": [str(_ucf_lists(tmp_path)), str(frames), "{out}",
                        "--split", "1"],
            "csv-hmdb": [str(_hmdb_lists(tmp_path)), str(frames), "{out}",
                         "--split", "1"],
            "csv-classdirs": [str(frames), "{out}/train_split.csv"],
            "classind": [str(frames), "{out}/classInd.txt"]}
    if cmd == "extract":
        videos = tmp_path / "videos"
        _write_videos(videos)
        args["extract"] = [str(videos), "{out}", "--short_side", "32",
                           "--workers", "1"]
        # the subcommand's process pool, run on threads here
        from concurrent.futures import ThreadPoolExecutor
        for mod in (preprocess, jax_pre):
            monkeypatch.setattr(mod, "ProcessPoolExecutor",
                                ThreadPoolExecutor)
    outs, printed = {}, {}
    for name, mod in (("ours", preprocess), ("theirs", jax_pre)):
        out = tmp_path / name
        mod.main([cmd] + [a.replace("{out}", str(out)) for a in args[cmd]])
        outs[name] = _tree_bytes(out)
        printed[name] = capsys.readouterr().out.replace(str(out), "OUT")
    assert outs["ours"] and outs["ours"] == outs["theirs"]
    assert printed["ours"] == printed["theirs"]
    if cmd in ("csv-ucf", "csv-hmdb"):
        assert set(outs["ours"]) == {"train_split01.csv", "test_split01.csv"}


_NO_CV2 = r"""
import sys
sys.modules["cv2"] = None          # any import of OpenCV now raises
from dpc_tpu_torch.data import preprocess
preprocess.main(sys.argv[1:])
try:
    preprocess.extract_video("any.avi", "no_such_dir", 32)
except ImportError as e:
    assert "OpenCV" in str(e) and "csv-ucf" in str(e), e
    print("extract raised")
else:
    raise SystemExit("extract_video ran without OpenCV")
"""


def test_csv_subcommands_run_without_opencv(tmp_path):
    frames = _frame_tree(tmp_path)
    lists = _ucf_lists(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for argv in (["csv-ucf", str(lists), str(frames), str(tmp_path / "out"),
                  "--split", "1"],
                 ["classind", str(frames), str(tmp_path / "out")
                  + "/classInd.txt"]):
        res = subprocess.run([sys.executable, "-c", _NO_CV2, *argv],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert "extract raised" in res.stdout
    jax_pre.main(["csv-ucf", str(lists), str(frames),
                  str(tmp_path / "want"), "--split", "1"])
    jax_pre.main(["classind", str(frames),
                  str(tmp_path / "want" / "classInd.txt")])
    assert _tree_bytes(tmp_path / "out") == _tree_bytes(tmp_path / "want")
