"""The port's two CLIs on a frame tree, on the CPU: validation, checkpoints,
exact resume, preemption and the pretrain → finetune → test workflow.

A tiny UCF-shaped tree is written with the port's JPEG encoder.  Resume is
exact: the dropout draws and the loader's order derive from (seed, epoch,
batch), so a run of two epochs, one epoch plus ``--resume``, and a run
preempted by SIGTERM mid-epoch plus ``--resume`` from its step checkpoint
end with bit-equal parameters.  No subprocess is started: the SIGTERM is
sent by the process to itself inside ``loop.run_epoch``.
"""

import math
import os
import re
import shutil
import signal

import numpy as np
import pytest
import torch

from dpc_tpu_torch.core import checkpoint as ckpt
from dpc_tpu_torch.data.frame_tree import write_frame_tree
from dpc_tpu_torch.train import evaluate, loop, pretrain
from torch_threads import one_thread  # noqa: F401

SMALL = ["--device", "cpu", "--img_dim", "32", "--num_seq", "3",
         "--seq_len", "4", "--ds", "1", "--batch_size", "2",
         "--num_workers", "2", "--compute_dtype", "float32",
         "--print_freq", "1", "--steps_per_epoch", "2"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 8 train rows (4 batches, cut to 2 steps), 14 test rows (val: 4)
    return write_frame_tree(str(tmp_path_factory.mktemp("frames")),
                            num_videos=4, num_frames=16, num_classes=8,
                            train_rows=8, test_rows=14, workers=4)


def _pretrain(tree, log_dir, *extra):
    pretrain.main(["--dataset", "ucf101", "--data_root", tree, *SMALL,
                   "--pred_step", "1", "--nce_impl", "fused",
                   "--log_dir", str(log_dir), *extra])
    (run,) = [p for p in log_dir.iterdir() if p.is_dir()]
    return run


def _final(run, epoch=2) -> dict:
    return ckpt.load_file(str(run / "model" / f"epoch{epoch}.pth.tar"))


def _assert_same_params(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def reference_run(tree, tmp_path_factory):
    """Two uninterrupted epochs: the run every resume must reproduce."""
    return _pretrain(tree, tmp_path_factory.mktemp("ref"), "--epochs", "2")


def test_pretrain_validates_checkpoints_and_resumes_exactly(
        tree, reference_run, tmp_path, capsys):
    ref = _final(reference_run)
    assert {"epoch", "net", "state_dict", "optimizer", "best_acc",
            "iteration", "val_acc"} <= ref.keys() and ref["epoch"] == 2
    names = sorted(os.listdir(reference_run / "model"))
    assert names[0] == "epoch2.pth.tar" and len(names) == 2
    assert names[1].startswith("model_best_epoch")

    run = _pretrain(tree, tmp_path / "a", "--epochs", "1")
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("epoch 0: train")]
    assert line and "[epoch 0] 2 train steps" in out
    assert "| val loss" in line[0], out
    assert all(math.isfinite(float(p.split()[0]))
               for p in line[0].split("loss")[1:])
    shutil.copytree(run, tmp_path / "reset")
    pretrain.main(["--resume", str(run), "--dataset", "ucf101",
                   "--data_root", tree, *SMALL, "--pred_step", "1",
                   "--nce_impl", "fused", "--epochs", "2"])
    out = capsys.readouterr().out
    assert "resumed epoch 1" in out
    assert "Training from ep 1 to ep 2 finished" in out
    _assert_same_params(_final(run)["state_dict"], ref["state_dict"])
    assert _final(run)["optimizer"]["state"][0]["step"] == 4

    # --reset_lr: parameters restored, Adam restarted from step 0
    pretrain.main(["--resume", str(tmp_path / "reset"), "--reset_lr",
                   "--dataset", "ucf101", "--data_root", tree, *SMALL,
                   "--pred_step", "1", "--nce_impl", "fused",
                   "--epochs", "2"])
    assert "resumed epoch 1" in capsys.readouterr().out
    reset = _final(tmp_path / "reset")
    assert reset["optimizer"]["state"][0]["step"] == 2
    assert not torch.equal(reset["state_dict"]["backbone.conv1.weight"],
                           ref["state_dict"]["backbone.conv1.weight"])


def test_sigterm_checkpoints_and_mid_epoch_resume_is_exact(
        tree, reference_run, tmp_path, monkeypatch, capsys):
    real_seed = loop.step_seed

    def preempt_at_epoch1_step0(seed, epoch, idx):
        if (epoch, idx) == (1, 0):
            os.kill(os.getpid(), signal.SIGTERM)
        return real_seed(seed, epoch, idx)

    monkeypatch.setattr(loop, "step_seed", preempt_at_epoch1_step0)
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit, match=r"\[preemption\] checkpointed"):
        _pretrain(tree, tmp_path, "--epochs", "2", "--save_every_steps",
                  "1")
    assert signal.getsignal(signal.SIGTERM) == previous  # guard removed
    monkeypatch.setattr(loop, "step_seed", real_seed)
    (run,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert "[preemption] signal" in capsys.readouterr().out
    shutil.rmtree(run / "model")  # resume from the step file alone
    pretrain.main(["--resume", str(run), "--dataset", "ucf101",
                   "--data_root", tree, *SMALL, "--pred_step", "1",
                   "--nce_impl", "fused", "--epochs", "2",
                   "--save_every_steps", "1"])
    out = capsys.readouterr().out
    assert "resumed mid-epoch: epoch 1 batch 1" in out
    _assert_same_params(_final(run)["state_dict"],
                        _final(reference_run)["state_dict"])


def test_finetune_from_pretrain_run_then_dense_test(
        tree, reference_run, tmp_path, capsys):
    capsys.readouterr()
    evaluate.main(["--dataset", "ucf101", "--data_root", tree, *SMALL,
                   "--num_class", "8", "--epochs", "1",
                   "--pretrain", str(reference_run),
                   "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[transfer_load] loaded" in out
    line = [ln for ln in out.splitlines() if ln.startswith("epoch 0: train")]
    assert line and "| val top1" in line[0], out
    (run,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    ft = _final(run, epoch=1)
    pre = _final(reference_run)["state_dict"]
    assert ft["epoch"] == 1 and "final_bn.running_mean" in ft["state_dict"]
    assert not torch.equal(ft["state_dict"]["backbone.conv1.weight"],
                           pre["backbone.conv1.weight"])  # it trained
    evaluate.main(["--dataset", "ucf101", "--data_root", tree, *SMALL,
                   "--num_class", "8", "--test", str(run),
                   "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"loaded test checkpoint {run} epoch 1" in out
    line = [ln for ln in out.splitlines() if ln.startswith("[test] loss")]
    assert line and math.isfinite(float(line[0].split()[2].rstrip(";")))
    # 14 test rows of 16 frames: 4 blocks of 4, windows of 3 blocks at
    # stride 1 (N/2): two a video
    assert "28 windows / 14 videos" in out


# the epoch lines of dpc_tpu's CLIs (dpc_tpu/train/pretrain.py:493-495,
# dpc_tpu/train/evaluate.py:768), which log parsers read
PRETRAIN_LINE = re.compile(r"^epoch \d+: train loss \d+\.\d{4} top1 "
                           r"\d\.\d{4} \| val loss \d+\.\d{4} top1 \d\.\d{4}$")
LC_LINE = re.compile(r"^epoch \d+: train top1 \d\.\d{4} \| val top1 "
                     r"\d\.\d{4}$")


def test_pretrain_picks_best_by_last_five_val_steps(tmp_path, capsys):
    """Seven val steps: the epoch line and the checkpoint's val_acc are the
    unweighted means of the last five steps, as in dpc_tpu, not the epoch
    mean; the line has dpc_tpu's format."""
    # SMALL without its --steps_per_epoch cap, which would cut val too
    pretrain.main(["--dataset", "synthetic", "--synthetic_videos", "14",
                   *SMALL[:-2], "--pred_step", "1", "--nce_impl", "fused",
                   "--epochs", "1", "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    val = re.findall(r"^\[val\] epoch 0 \[\d+/7\] loss (\S+) top1 (\S+)",
                     out, re.M)
    assert len(val) == 7, out
    loss, top1 = (np.array([float(v[k]) for v in val]) for k in (0, 1))
    (line,) = [ln for ln in out.splitlines() if ln.startswith("epoch 0:")]
    assert PRETRAIN_LINE.match(line), line
    got_loss = float(line.split("val loss")[1].split()[0])
    got_top1 = float(line.split("top1")[-1])
    assert got_loss == pytest.approx(loss[-5:].mean(), abs=2e-4)
    assert abs(loss[-5:].mean() - loss.mean()) > 1e-3  # the test can tell
    assert got_top1 == pytest.approx(top1[-5:].mean(), abs=2e-4)
    (run,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert _final(run, 1)["val_acc"] == pytest.approx(top1[-5:].mean(),
                                                      abs=2e-4)
    assert re.search(r"^\[epoch 0\] 7 train steps in \S+ s, 7 val steps$",
                     out, re.M), out


def test_unit_test_keep_short_and_lc_epoch_line(tmp_path, capsys):
    """--unit_test keeps 32 videos of a longer split (both CLIs);
    --test_keep_short tests a video shorter than one clip, which the dense
    test drops by default; the LC epoch line has dpc_tpu's format."""
    root = write_frame_tree(str(tmp_path / "frames"), num_videos=2,
                            num_frames=16, num_classes=8, train_rows=40,
                            test_rows=3, workers=2)
    split = tmp_path / "frames" / "ucf101" / "test_split01.csv"
    rows = split.read_text().splitlines()
    # the clip spans 12 frames: a row of 10 is a short video
    rows[0] = rows[0].rsplit(",", 1)[0] + ",10"
    split.write_text("\n".join(rows) + "\n")
    common = ["--dataset", "ucf101", "--data_root", root, *SMALL,
              "--log_dir", str(tmp_path / "log")]
    pretrain.main([*common, "--pred_step", "1", "--nce_impl", "fused",
                   "--epochs", "1", "--steps_per_epoch", "1",
                   "--unit_test"])
    assert "train videos: 32;" in capsys.readouterr().out
    evaluate.main([*common, "--num_class", "8", "--epochs", "1",
                   "--steps_per_epoch", "1", "--unit_test"])
    out = capsys.readouterr().out
    assert "train videos: 32;" in out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("epoch 0:")]
    assert LC_LINE.match(line), line
    for extra, n in (([], 2), (["--test_keep_short"], 3)):
        evaluate.main([*common, "--num_class", "8", "--test", "random",
                       *extra])
        assert f" / {n} videos in" in capsys.readouterr().out


def test_device_augment_epoch_resume_is_exact(tree, tmp_path, capsys):
    """--device_augment on the CPU: the windows are ROI-decoded with no
    fallback, the recipe runs in the step with draws seeded per step, and
    one epoch plus --resume ends bit-equal to two uninterrupted epochs."""
    aug = ["--device_augment", "--fold_normalize", "on"]
    ref = _pretrain(tree, tmp_path / "ref", "--epochs", "2", *aug)
    run = _pretrain(tree, tmp_path / "run", "--epochs", "1", *aug)
    pretrain.main(["--resume", str(run), "--dataset", "ucf101",
                   "--data_root", tree, *SMALL, "--pred_step", "1",
                   "--nce_impl", "fused", "--epochs", "2", *aug])
    out = capsys.readouterr().out
    assert "resumed epoch 1" in out
    _assert_same_params(_final(run)["state_dict"], _final(ref)["state_dict"])
    assert out.count("[feed] planned-decode fallbacks: {'unplanned': 0, "
                     "'undecoded': 0}") == 3, out
