"""The span reduction (``benchmark/spans.py``) and the metrics that read it,
on stub profiler events: times in µs, thread 1 the main thread, thread 2
autograd's device thread, stream 3 the compute stream and 7 the feed's."""

from __future__ import annotations

import sys
import types

import pytest
import torch

from benchmark import counts, peaks, spans, spec, tracing
from benchmark.reference.model import feature_size
from benchmark.tests.conftest import tiny_cell

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, start, end, thread=1, kind=CPU, id=0, stream=0):
    return types.SimpleNamespace(
        name=name, device_type=kind, thread=thread, id=id,
        is_user_annotation=False,
        device_resource_id=stream,
        time_range=types.SimpleNamespace(start=start, end=end,
                                         elapsed_us=lambda: end - start))


def _launch(id, at, start, end, thread=1, stream=3,
            call="cudaLaunchKernel"):
    """A runtime call at ``at`` and the device operation it launched."""
    return [_ev(call, at, at + 2, thread, id=id),
            _ev(f"kernel{id}", start, end, kind=CUDA, id=id, stream=stream)]


def _events(copy=(40, 140)) -> list:
    return [
        _ev(tracing.WINDOW, 0, 1000),
        _ev("dpc.loop.dispatch", 10, 500),
        _ev("dpc.feed.copy", 20, 30),
        *_launch(101, 22, *copy, stream=7, call="cudaMemcpyAsync"),
        _ev("dpc.step.forward", 50, 200),
        *_launch(102, 60, 100, 180),
        _ev("dpc.step.backward", 210, 400),
        _ev("autograd::engine::evaluate_function: X", 220, 300, thread=2),
        _ev("dpc.agg.backward", 225, 260, thread=2),
        *_launch(103, 230, 230, 250, thread=2),
        _ev("dpc.backbone.stem.backward", 300, 300, thread=2),
        *_launch(104, 310, 310, 330, thread=2),
        _ev("cudaStreamSynchronize", 410, 450),
        _ev("dpc.step.optimizer", 460, 490),
        *_launch(105, 465, 470, 480),
        _ev("dpc.loop.drain", 600, 700),
        _ev("cudaEventSynchronize", 610, 690),
        *_launch(106, 800, 800, 810),
    ]


def test_a_launch_counts_on_its_thread_or_autograds():
    """A kernel counts towards the spans whose host interval holds its
    launch on the span's thread; a launch on autograd's thread inside the
    step's backward counts towards the backward and the spans around it;
    the stem's region runs from its mark to the backward's end."""
    got = spans.reduce(_events(), steps=1)["spans"]
    ms = {k: round(v["device_ms"], 6) for k, v in got.items()}
    assert ms == {"dpc.feed.copy": 0.1, "dpc.step.forward": 0.08,
                  "dpc.agg.backward": 0.02,
                  "dpc.backbone.stem.backward": 0.02,
                  "dpc.step.backward": 0.04, "dpc.step.optimizer": 0.01,
                  "dpc.loop.dispatch": 0.23, "dpc.loop.drain": 0.0,
                  "outside": 0.01}
    launches = {k: v["launches"] for k, v in got.items() if v["launches"]}
    assert launches == {"dpc.feed.copy": 1, "dpc.step.forward": 1,
                        "dpc.agg.backward": 1,
                        "dpc.backbone.stem.backward": 1,
                        "dpc.step.optimizer": 1, "outside": 1}


@pytest.mark.parametrize("copy, exposed", [((40, 140), 0.06),
                                           ((110, 170), 0.0)])
def test_a_copy_overlapping_compute_is_not_exposed(copy, exposed):
    got = spans.reduce(_events(copy), steps=1)
    assert got["feed_exposed_ms"] == pytest.approx(exposed)


def test_a_blocking_call_counts_under_its_innermost_span():
    got = spans.reduce(_events(), steps=2)["spans"]
    syncs = {k: v["syncs"] for k, v in got.items() if v["syncs"]}
    assert syncs == {"dpc.loop.dispatch": 0.5, "dpc.loop.drain": 0.5}
    d = got["dpc.loop.dispatch"]
    assert d["syncs_within"] == 0.5
    assert d["sync_ms_within"] == pytest.approx(0.02)
    assert d["host_ms"] == pytest.approx(0.245)


def test_coverage_and_idle_by_span():
    got = spans.reduce(_events(), steps=1)
    # stream 3: 140 µs, of which 130 under the step's spans
    assert got["coverage"] == pytest.approx(100 * 130 / 140)
    assert got["window_ms"] == pytest.approx(1.0)
    idle = {k: round(v * 1e6) for k, v in got["idle_s"].items()}
    assert idle == {"dpc.feed.copy": 40, "dpc.loop.dispatch": 50,
                    "dpc.step.backward": 200, "dpc.loop.drain": 320,
                    "outside": 190}


def test_readers_read_the_spans_and_nothing_without_them():
    trace = {"steps": 1, "spans": spans.reduce(_events(), steps=1)}
    ctx = {"cell": tiny_cell("pretrain"), "rank0": {"trace": trace}}
    read = {m: spec.reader(m)(ctx) for m in spans.SPAN_METRICS}
    assert read["adam_step_ms"] == pytest.approx(0.01)
    assert read["feed_exposed_ms"] == pytest.approx(0.06)
    assert read["host_queue_ms"] == pytest.approx(0.49 - 0.04)
    assert read["host_syncs_per_step"] == 1
    # the stub has no recipe, stem, aggregator or loss span
    for m in ("recipe_step_ms", "stem_step_roofline",
              "convgru_step_roofline", "nce_step_roofline"):
        assert read[m] is None, m
    # a roofline: the work's least time over the spans' device ms
    cell = ctx["cell"]
    cfg = cell.config
    flops, nbytes = counts.gru_cost(cfg, 4, cfg["num_seq"] - cfg["pred_step"],
                                    feature_size(cfg["network"]))
    ctx["rank0"] = {"trace": {"spans": {"spans": {
        "dpc.agg": {"device_ms": 0.5}, "dpc.agg.backward": {"device_ms": 1.5}}}}}
    assert spec.reader("convgru_step_roofline")(ctx) == pytest.approx(
        100 * peaks.least_seconds(flops, nbytes) / 2e-3)
    # a trace without the span reduction (the harness as it is) reads None
    for trace in ({"steps": 1}, None):
        ctx["rank0"] = {"trace": trace}
        assert all(spec.reader(m)(ctx) is None for m in spans.SPAN_METRICS)



@pytest.mark.parametrize("where", ["reporting process", "rank"])
def test_main_prints_no_result_where_jax_was_loaded(monkeypatch, capsys,
                                                     where):
    """``python3 -m benchmark.spans`` refuses as ``run.py`` does: where the
    reporting process or a rank loaded one of ``harness.BANNED``, it exits
    3 and prints no result line; ``tracing.reduce`` is itself again."""
    from benchmark import harness

    def rank_run(rank, params):
        # harness.traced's reduction, through the events kept for spans
        trace = tracing.reduce(types.SimpleNamespace(events=_events))
        trace["steps"] = 1
        return {"rank": rank, "trace": trace,
                "banned": ["jax"] if where == "rank" else []}

    monkeypatch.setattr(tracing, "reduce", lambda prof: {})
    plain = tracing.reduce
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(harness, "rank_run", rank_run)
    if where == "reporting process":
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = spans.main(["--workload", "r18-128-pretrain-b64", "--seed",
                     str(2**31 + 5), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 3
    assert out.out == ""
    assert "no result" in out.err and "[trace]" not in out.err
    assert tracing.reduce is plain
