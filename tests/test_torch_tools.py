"""The port's bench, profiling and interchange tools against dpc_tpu's, on
the CPU.

* ``utils.profiling``: ``device_busy`` is the union of the streams' busy
  intervals; ``trace`` writes a Chrome trace; ``enable_debug`` makes a
  step with a NaN raise, and is off again after ``disable_debug``.
* ``models.registry`` names the same backbones with the same
  ``feature_size``; the metrics helpers are exactly dpc_tpu's.
* ``bench``, ``train.bench_loop``, ``train.bench_breakdown`` and
  ``train.bench_input`` run with ``--device cpu`` at a tiny size and print
  one JSON line with dpc_tpu's keys; the breakdown's ``model_fwd`` is
  dpc_tpu's ``apply_dpc`` + ``nce_loss`` on the same weights and input (f32,
  GRU dropout off, rtol 1e-5: one scalar, the two conv libraries' sums
  agree far closer than the 1e-4 of the raw forward).
* The CLIs' tensorboard calls, through a fake ``tensorboardX``, carry the
  tags dpc_tpu's CLIs write, and a CLI runs without ``tensorboardX``.
* The loop reads a step's metrics from a copy started right after the step
  was queued, before the next one (the one-deep drain on the card).
* Interchange: a port LC checkpoint with running statistics loads into
  dpc_tpu bit for bit, and ``dpc_tpu.utils.export_torch.export`` output
  loads into the port's DPC and LC.
"""

import json
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpc_tpu.core import checkpoint as jax_ckpt
from dpc_tpu.core.config import DPCConfig as JaxDPCConfig
from dpc_tpu.models import dpc as jax_dpc
from dpc_tpu.models import lc as jax_lc
from dpc_tpu.models import registry as jax_registry
from dpc_tpu.ops import nce as jax_nce
from dpc_tpu.train import metrics as jax_metrics
from dpc_tpu.utils import export_torch, torch_compat
from dpc_tpu_torch import bench
from dpc_tpu_torch.core import checkpoint as ckpt
from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
from dpc_tpu_torch.models import dpc, lc, registry
from dpc_tpu_torch.models.resnet2d3d import ResNet2d3d
from dpc_tpu_torch.train import (bench_breakdown, bench_input, bench_loop,
                                 evaluate, loop, metrics, optim, pretrain,
                                 pretrain_step)
from dpc_tpu_torch.utils import profiling
from dpc_tpu_torch.utils.weights import (dpc_state_dict_from_jax,
                                         lc_state_dict_from_jax)
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--img_dim", "32", "--batch_size", "2",
        "--compute_dtype", "float32"]
SMALL = dict(img_dim=32, num_seq=3, seq_len=4, pred_step=1, gru_dropout=0.0)
CLI = ["--device", "cpu", "--dataset", "synthetic", "--img_dim", "32",
       "--num_seq", "3", "--seq_len", "4", "--ds", "1", "--batch_size", "2",
       "--epochs", "1", "--steps_per_epoch", "2", "--num_workers", "2",
       "--compute_dtype", "float32", "--print_freq", "1",
       "--synthetic_videos", "4"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def small_flagship(monkeypatch):
    """The tools' flagship at 3×4 blocks, pred 1: the tools' own code at a
    cost the CPU run affords."""
    full = bench.flagship
    monkeypatch.setattr(bench, "flagship", lambda *a, **k: full(
        *a, **k, num_seq=3, seq_len=4, pred_step=1))


def _json_keys(path: Path) -> set:
    """The keys of the one JSON line a dpc_tpu tool prints: the string
    keys of the dict literal it hands to ``json.dumps``."""
    src = path.read_text()
    body = src[src.rindex("json.dumps({"):]
    body = body[:body.index("})")]
    return set(re.findall(r'"(\w+)":', body))


def _last_json(out: str) -> dict:
    lines = out.strip().splitlines()
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# utils.profiling
# ---------------------------------------------------------------------------

def _stub_event(start, end, device="cuda", annotation=False):
    kind = (torch.autograd.DeviceType.CUDA if device == "cuda"
            else torch.autograd.DeviceType.CPU)
    return types.SimpleNamespace(
        device_type=kind, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_device_busy_is_the_union_over_streams():
    """A copy stream overlapping the compute stream counts once: the busy
    time is the union of the device intervals (µs), never their sum, and
    host events and user-annotation ranges count for nothing."""
    prof = types.SimpleNamespace(events=lambda: [
        _stub_event(0, 4000), _stub_event(1000, 3000),   # copy under compute
        _stub_event(3500, 6000), _stub_event(8000, 9000),
        _stub_event(0, 10000, annotation=True), _stub_event(0, 10000, "cpu")])
    busy_ms, pct = profiling.device_busy(prof, wall_ms=10.0)
    assert busy_ms == pytest.approx(7.0)
    assert pct == pytest.approx(70.0)
    # the whole wall covered by two overlapping streams reads 100%, not 200%
    prof = types.SimpleNamespace(events=lambda: [_stub_event(0, 10000),
                                                 _stub_event(0, 10000)])
    assert profiling.device_busy(prof, wall_ms=10.0)[1] == pytest.approx(100)


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = tmp_path.glob("*.pt.trace.json")
    assert f"trace written to {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert profiling.device_events(prof) == []  # no card, no device time


def _small_step(model_cfg=None):
    cfg = model_cfg or DPCConfig(**SMALL)
    tcfg = TrainConfig(batch_size=2, nce_impl="fused")
    model = dpc.build_dpc(cfg, torch.device("cpu"), seed=0)
    step = pretrain_step.make_pretrain_step(
        cfg, tcfg, model, optim.pretrain_optimizer(model, 1e-3, 1e-5))
    x = torch.randn(2, cfg.num_seq, cfg.seq_len, 32, 32, 3,
                    generator=torch.Generator().manual_seed(0))
    return model, step, x


def test_enable_debug_raises_on_a_nan():
    model, step, x = _small_step()
    x[0, 0, 0, 0, 0, 0] = float("nan")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not profiling.nan_checks_on()
    profiling.enable_debug(nan_checks=True)
    try:
        assert profiling.nan_checks_on()
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            step(x)
    finally:
        profiling.disable_debug()
    assert not torch.is_anomaly_enabled()
    # raised before the backward: nothing was updated
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # without the debug mode the step runs on (the loop checks the loss)
    assert not np.isfinite(float(step(x)["loss"]))


def test_stem_conv_computes_in_the_compute_dtype():
    """Under the bf16 step the stem conv (3 input channels) computes in
    bf16, as dpc_tpu casts every conv's input and weight: the f32 kernel
    the card's profile shows for it is cuDNN's engine for C=3 (PERF.md
    §5), not a cast the port left out."""
    model, step, x = _small_step(DPCConfig(**SMALL,
                                           compute_dtype="bfloat16"))
    seen = []
    model.backbone.conv1.register_forward_hook(
        lambda mod, inp, out: seen.append(out.dtype))
    step(x)
    assert seen == [torch.bfloat16]


# ---------------------------------------------------------------------------
# registry and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("network", jax_registry.list_backbones())
def test_registry_matches_dpc_tpu(network):
    assert registry.list_backbones() == jax_registry.list_backbones()
    _, _, want = jax_registry.select_backbone(network)
    build, got = registry.select_backbone(network,
                                          track_running_stats=False)
    assert got == want
    assert build.func is ResNet2d3d and build.args == (network,)
    with pytest.raises(ValueError, match="unknown backbone"):
        registry.select_backbone("resnet19")


def test_registry_builds_the_backbone():
    build, param = registry.select_backbone("resnet18")
    net = build()
    assert isinstance(net, ResNet2d3d) and net.network == "resnet18"
    assert net.bn1.track_running_stats  # the default, as dpc_tpu's
    y = net(torch.randn(2, 4, 32, 32, 3))
    assert y.shape[-1] == param["feature_size"]


def _scores():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(64, 10)).astype(np.float32),
            rng.integers(0, 10, 64))


@pytest.mark.parametrize("name", ["topk_accuracy_np", "accuracy_np",
                                  "accuracy_binary_np", "denormalize"])
def test_metrics_helpers_match_dpc_tpu(name):
    scores, targets = _scores()
    if name == "topk_accuracy_np":
        for ks in ((1, 5), (1, 3, 5), (10,)):
            assert (metrics.topk_accuracy_np(scores, targets, ks)
                    == jax_metrics.topk_accuracy_np(scores, targets, ks))
    elif name == "accuracy_np":
        assert (metrics.accuracy_np(scores, targets)
                == jax_metrics.accuracy_np(scores, targets))
    elif name == "accuracy_binary_np":
        bits = np.random.default_rng(8).integers(0, 2, scores.shape)
        assert (metrics.accuracy_binary_np(scores, bits)
                == jax_metrics.accuracy_binary_np(scores, bits))
    else:
        frames = np.random.default_rng(9).normal(
            size=(16, 8, 8, 3)).astype(np.float32)
        got = metrics.denormalize(frames)
        np.testing.assert_array_equal(got, jax_metrics.denormalize(frames))
        assert got.min() == 0.0 and got.max() == 1.0


# ---------------------------------------------------------------------------
# the bench tools on the CPU
# ---------------------------------------------------------------------------

def test_bench_prints_one_json_line(small_flagship, capsys):
    bench.main([*TINY, "--windows", "2", "--iters", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    got = json.loads(out[0])
    assert _json_keys(ROOT / "bench.py") <= got.keys()
    assert got["metric"] == "clips/sec/cpu" and got["value"] > 0
    assert len(got["windows"]) == 2 and got["device"] == "cpu"
    assert got["peak_mem_mib"] is None  # no device memory off the card


@pytest.mark.parametrize("source,extra", [("cached", []),
                                          ("device", ["--sync"])])
def test_bench_loop_prints_dpc_tpu_keys(source, extra, small_flagship,
                                        capsys):
    bench_loop.main([*TINY, "--steps", "2", "--source", source, *extra])
    got = _last_json(capsys.readouterr().out)
    assert set(got) == _json_keys(ROOT / "dpc_tpu/train/bench_loop.py")
    assert got["source"] == source and got["steps"] == 2
    assert got["value"] > 0 and not got["device_augment"]


def test_bench_loop_device_augment_from_the_loader(small_flagship, capsys):
    bench_loop.main([*TINY, "--steps", "1", "--source", "loader",
                     "--device_augment", "--num_workers", "2"])
    got = _last_json(capsys.readouterr().out)
    assert got["device_augment"] and got["steps"] == 1 and got["value"] > 0


BREAKDOWN_KEYS = ["full_step"] + [
    f"{n}_{k}" for n in ("stem+pool", "thru_l1", "thru_l2", "thru_l3",
                         "backbone") for k in ("fwd", "fwdbwd")] + [
    "stem_conv_fwd", "head_fwd", "head_fwdbwd", "model_fwd", "model_fwdbwd"]


def test_bench_breakdown_prints_dpc_tpu_keys(small_flagship, tmp_path,
                                             capsys):
    # dpc_tpu's keys, in its order (dpc_tpu/train/bench_breakdown.py)
    src = (ROOT / "dpc_tpu/train/bench_breakdown.py").read_text()
    for key in ("full_step", "stem_conv_fwd", "head_fwd", "model_fwdbwd",
                "stem+pool", "thru_l3"):
        assert key in src
    prof = tmp_path / "breakdown.txt"
    bench_breakdown.main([*TINY, "--iters", "1", "--profile", str(prof)])
    got = _last_json(capsys.readouterr().out)
    assert list(got) == BREAKDOWN_KEYS
    assert all(v > 0 for v in got.values())
    rec = json.loads(Path(str(prof) + ".json").read_text())
    assert rec["busy_ms"] is None and rec["rows"] == []  # no card
    assert "aten::" in prof.read_text()  # the table grouped by shape
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1


def test_breakdown_model_fwd_matches_dpc_tpu():
    """model_fwd's loss against dpc_tpu's apply_dpc + nce_loss, the same
    bridged weights and input, f32, GRU dropout off."""
    jcfg = JaxDPCConfig(**SMALL)
    params = jax_dpc.init_dpc(jax.random.PRNGKey(0), jcfg)
    cfg = DPCConfig(**SMALL)
    tcfg = TrainConfig(batch_size=2, nce_impl="fused")
    model = dpc.DPC(cfg)
    model.load_state_dict(dpc_state_dict_from_jax(_np_tree(params)))
    x = np.random.default_rng(3).normal(
        size=(2, 3, 4, 32, 32, 3)).astype(np.float32)
    parts = bench_breakdown.components(cfg, tcfg, model, None,
                                       torch.tensor(x), None)
    got = float(parts["model_fwd"]())
    targets = jnp.asarray(jax_nce.nce_targets(2, cfg.pred_step, cfg.sq))
    want = float(jax.jit(lambda p, v: jax_nce.nce_loss(jax_dpc.apply_dpc(
        p, v, cfg=jcfg, train=True, key=jax.random.PRNGKey(1))[0],
        targets)[0])(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the head from features and the full forward compute the same loss
    assert float(parts["head_fwd"]()) == pytest.approx(got, rel=1e-6)


@pytest.mark.parametrize("decode_only", [False, True])
def test_bench_input_synthetic(decode_only, capsys):
    got = bench_input.main(["--device", "cpu", "--dataset", "synthetic",
                            "--batches", "2", "--batch_size", "2",
                            "--num_workers", "2", "--img_dim", "32"]
                           + (["--decode_only"] if decode_only else []))
    assert _last_json(capsys.readouterr().out) == got
    assert set(got) == _json_keys(ROOT / "dpc_tpu/train/bench_input.py")
    assert got["value"] > 0 and got["roi_decode"] == decode_only


def test_tools_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench.main, bench_loop.main, bench_breakdown.main,
                 bench_input.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])


# ---------------------------------------------------------------------------
# the CLIs: tensorboard and --debug_nans
# ---------------------------------------------------------------------------

class _Writer:
    log: list = []

    def __init__(self, logdir):
        self.logdir = logdir

    def add_scalar(self, tag, value, step):
        self.log.append((Path(self.logdir).name, "scalar", tag, float(value),
                         step))

    def add_images(self, tag, images, step, dataformats="NCHW"):
        self.log.append((Path(self.logdir).name, "images", tag,
                         images.shape, step, dataformats,
                         float(images.min()), float(images.max())))

    def close(self):
        self.log.append((Path(self.logdir).name, "close"))


@pytest.fixture
def fake_tensorboard(monkeypatch):
    _Writer.log = []
    mod = types.ModuleType("tensorboardX")
    mod.SummaryWriter = _Writer
    monkeypatch.setitem(sys.modules, "tensorboardX", mod)
    return _Writer.log


def _dpc_tpu_tags(path: str) -> set:
    """The tags dpc_tpu's CLI writes, ``{k}`` left as a pattern."""
    src = (ROOT / path).read_text()
    return set(re.findall(r'add_(?:scalar|images)\(\s*f?"([^"]+)"', src))


def _as_patterns(tags: set) -> set:
    return {re.sub(r"/(loss|top\d|accuracy)$", "/{k}", t)
            if t.startswith("global/") else t for t in tags}


def test_pretrain_cli_tensorboard_tags(fake_tensorboard, tmp_path):
    pretrain.main([*CLI, "--pred_step", "1", "--nce_impl", "fused",
                   "--log_dir", str(tmp_path)])
    log = fake_tensorboard
    tags = {e[2] for e in log if e[1] in ("scalar", "images")}
    assert _as_patterns(tags) == _dpc_tpu_tags("dpc_tpu/train/pretrain.py")
    local = [e for e in log if e[1] == "scalar" and e[2].startswith("local/")]
    assert [(e[0], e[2], e[4]) for e in local] == [
        ("train", "local/loss", 0), ("train", "local/accuracy", 0),
        ("train", "local/loss", 1), ("train", "local/accuracy", 1)]
    (grid,) = [e for e in log if e[1] == "images"]
    assert grid[:6] == ("train", "images", "input_seq", (12, 32, 32, 3), 0,
                        "NHWC")
    assert 0.0 <= grid[6] and grid[7] <= 1.0
    for split in ("train", "val"):
        assert {e[2] for e in log if e[0] == split and e[1] == "scalar"
                and e[2].startswith("global/")} == {
            "global/loss", "global/top1", "global/top3", "global/top5"}
    assert sum(e[1] == "close" for e in log) == 2
    (run,) = tmp_path.iterdir()
    assert {e[0] for e in log} == {"train", "val"}
    assert (run / "config.json").exists()


def test_finetune_cli_tensorboard_tags(fake_tensorboard, tmp_path):
    evaluate.main([*CLI, "--log_dir", str(tmp_path)])
    log = fake_tensorboard
    tags = {e[2] for e in log if e[1] in ("scalar", "images")}
    assert _as_patterns(tags) == _dpc_tpu_tags("dpc_tpu/train/evaluate.py")
    assert [e[3] for e in log if e[1] == "scalar"
            and e[2] == "lr/scale"] == [1.0]
    (grid,) = [e for e in log if e[1] == "images"]
    # the batch's first 16 frames (two clips of 12), as dpc_tpu's finetune
    assert grid[2:4] == ("input_seq", (16, 32, 32, 3))


def test_pretrain_cli_without_tensorboard_with_debug_nans_and_profile(
        monkeypatch, tmp_path, capsys):
    """No tensorboardX: a line, and the run goes on; --debug_nans is off
    again when the run ends; --profile's second epoch writes its table,
    the kernel JSON and a Chrome trace beside them, and prints its line
    as before."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    prof = tmp_path / "prof" / "profile.txt"
    prof.parent.mkdir()
    pretrain.main([*CLI, "--pred_step", "1", "--nce_impl", "fused",
                   "--log_dir", str(tmp_path / "log"), "--debug_nans",
                   "--epochs", "2", "--profile", str(prof)])
    out = capsys.readouterr().out
    assert "tensorboard disabled:" in out
    assert "[epoch 1] 2 train steps" in out
    assert not torch.is_anomaly_enabled()  # the CLI turned it off again
    assert re.search(r"^\[profile\] 2 train steps: wall \S+ ms, \S+ clips/s, "
                     r"device busy \S+ ms \(\S+%\); table in ", out, re.M)
    assert json.loads(Path(str(prof) + ".json").read_text())["steps"] == 2
    assert len(list(prof.parent.glob("*.pt.trace.json"))) == 1


def test_input_grid_of_uint8_windows():
    clips = np.full((2, 3, 4, 8, 8, 3), 255, np.uint8)
    grid = loop.input_grid(torch.from_numpy(clips))
    assert grid.shape == (16, 8, 8, 3) and grid.dtype == np.float32
    assert (grid == 1.0).all()


# ---------------------------------------------------------------------------
# the loop's metric fetch
# ---------------------------------------------------------------------------

def test_run_epoch_fetches_each_step_behind_it(monkeypatch):
    """The copy of step i's metrics starts right after step i is queued and
    before step i+1 is; step i's values are read after step i+1 is queued.
    (On the card the copy is queued behind step i alone, so reading it
    lets step i+1 run; reading the device tensors would wait for it.)"""
    events = []

    class Fetch:
        def __init__(self, m):
            events.append(("fetch", m["i"]))
            self.m = m

        def get(self):
            events.append(("read", self.m["i"]))
            return {"loss": 1.0}

    monkeypatch.setattr(loop, "MetricsFetch", Fetch)

    def dispatch(idx, batch):
        events.append(("queue", idx))
        return {"i": idx}

    from dpc_tpu_torch.train.metrics import MetricBundle
    loop.run_epoch(dispatch, [np.zeros((2, 1))] * 3, MetricBundle(),
                   print_freq=100)
    assert events == [("queue", 0), ("fetch", 0), ("queue", 1), ("fetch", 1),
                      ("read", 0), ("queue", 2), ("fetch", 2), ("read", 1),
                      ("read", 2)]


def test_metrics_fetch_passes_cpu_values():
    fetch = loop.MetricsFetch({"loss": torch.tensor(2.5), "top1": 0.5})
    assert fetch.event is None and fetch.get() == {"loss": 2.5, "top1": 0.5}


# ---------------------------------------------------------------------------
# interchange
# ---------------------------------------------------------------------------

def test_port_lc_checkpoint_loads_into_dpc_tpu(tmp_path):
    """An LC epoch file of the port, running statistics moved by a train
    forward, read by dpc_tpu's --test path (lc_key_map, lc_state_key_map):
    every parameter and statistic bit for bit."""
    cfg = DPCConfig(**SMALL)
    model = lc.build_lc(cfg, 7, torch.device("cpu"), dropout=0.0, seed=3)
    with torch.no_grad():
        lc.apply_lc(model, torch.randn(2, 3, 4, 32, 32, 3), cfg=cfg,
                    train=True)
    assert float(model.final_bn.running_mean.abs().sum()) > 0
    mgr = ckpt.CheckpointManager(str(tmp_path / "model"))
    mgr.save(1, {"epoch": 1, "net": cfg.network,
                 "state_dict": model.state_dict(), "best_acc": 0.0},
             val_acc=0.0)
    path = str(tmp_path / "model" / "epoch1.pth.tar")
    params, state = jax_lc.init_lc(jax.random.PRNGKey(5),
                                   JaxDPCConfig(**SMALL), 7)
    params, rep = torch_compat.load_reference_checkpoint(
        path, params, torch_compat.lc_key_map(params), verbose=False)
    state, srep = torch_compat.load_reference_checkpoint(
        path, state, torch_compat.lc_state_key_map(state), verbose=False)
    assert not rep["missing"] and not srep["missing"]
    read = lc_state_dict_from_jax(_np_tree(params), _np_tree(state))
    sd = model.state_dict()
    for k, v in read.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == {
        k for k in read if not k.endswith("num_batches_tracked")}


def test_dpc_tpu_export_loads_into_the_port(tmp_path):
    """export_torch.export of a dpc_tpu run directory (written by its
    checkpoint manager) loads strictly into the port's DPC and LC (torch's
    BN fills the num_batches_tracked counters the export does not write
    with 0)."""
    jcfg = JaxDPCConfig(img_dim=32, num_seq=3, seq_len=4, pred_step=1)
    shape = dict(net="resnet18", img_dim=32, num_seq=3, seq_len=4,
                 pred_step=1)
    params = jax_dpc.init_dpc(jax.random.PRNGKey(2), jcfg)
    mgr = jax_ckpt.make_manager(str(tmp_path / "dpc" / "model"))
    jax_ckpt.save(mgr, 1, {"params": params}, metrics={"val_acc": 0.0})
    out = str(tmp_path / "dpc.pth.tar")
    export_torch.export(str(tmp_path / "dpc"), out, model="dpc", **shape)
    sd, _ = ckpt.state_dict_of(out)
    model = dpc.DPC(DPCConfig(**SMALL))
    model.load_state_dict(sd, strict=True)
    want = dpc_state_dict_from_jax(_np_tree(params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k

    lparams, lstate = jax_lc.init_lc(jax.random.PRNGKey(4), jcfg, 9)
    lstate = jax.tree.map(lambda v: v + 0.25, lstate)
    mgr = jax_ckpt.make_manager(str(tmp_path / "lc" / "model"))
    jax_ckpt.save(mgr, 1, {"params": lparams, "bn_state": lstate},
                  metrics={"val_acc": 0.0})
    out = str(tmp_path / "lc.pth.tar")
    export_torch.export(str(tmp_path / "lc"), out, model="lc",
                        num_classes=9, **shape)
    sd, _ = ckpt.state_dict_of(out)
    model = lc.LC(DPCConfig(**SMALL), 9)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    model.load_state_dict(sd, strict=True)
    want = lc_state_dict_from_jax(_np_tree(lparams), _np_tree(lstate))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
