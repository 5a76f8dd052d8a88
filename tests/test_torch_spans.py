"""The program's spans (``utils.profiling.span`` and ``mark_backward``) on
the CPU, at the tools' tiny size (32², 3 blocks of 4, pred 1) with the
device recipes, the recurrence kernel's path and the flash NCE's
autograd function (their plain versions here).

* Under ``torch.profiler``, steps driven through ``loop.run_epoch`` and
  ``loop.DeviceFeed`` record every span of the step once a step, nested
  as ``benchmark/spans.py`` reads them: the stem's backward mark after the
  aggregator's backward, inside the step's backward.
* With no profiler recording, the spans change nothing: two steps give
  bit-identical losses and parameters with the spans in place and with
  them patched out, and the autograd graph has as many nodes; under the
  profiler too.
"""

import contextlib
from collections import Counter

import pytest
import torch

from dpc_tpu_torch.core.config import DPCConfig, EvalConfig, TrainConfig
from dpc_tpu_torch.models import dpc, lc
from dpc_tpu_torch.train import finetune_step, loop, optim, pretrain_step
from dpc_tpu_torch.train.metrics import MetricBundle
from dpc_tpu_torch.utils import profiling
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
SMALL = dict(img_dim=32, num_seq=3, seq_len=4, pred_step=1, gru_dropout=0.1,
             gru_impl="pallas")
CLASSES = 5
STEPS = 2

MODEL = ("dpc.backbone.stem", "dpc.agg")
BACKWARD = ("dpc.step.backward", "dpc.agg.backward",
            "dpc.backbone.stem.backward")
SPANS = {
    "pretrain": ("dpc.loop.dispatch", "dpc.loop.drain", "dpc.feed.copy",
                 "dpc.step.recipe", "dpc.step.forward", "dpc.step.loss",
                 "dpc.step.optimizer", "dpc.nce.backward") + MODEL + BACKWARD,
    "finetune": ("dpc.loop.dispatch", "dpc.loop.drain", "dpc.feed.copy",
                 "dpc.step.recipe", "dpc.step.forward", "dpc.step.loss",
                 "dpc.step.optimizer") + MODEL + BACKWARD,
    "pretrain_eval": ("dpc.loop.dispatch", "dpc.loop.drain", "dpc.feed.copy",
                      "dpc.step.recipe", "dpc.step.forward", "dpc.step.loss")
    + MODEL,
    "finetune_eval": ("dpc.loop.dispatch", "dpc.loop.drain", "dpc.feed.copy",
                      "dpc.step.recipe", "dpc.step.forward", "dpc.step.loss")
    + MODEL,
}


def _job(kind: str):
    """``(model, call(batch, dropout_gen, recipe_gen) -> metrics)``."""
    cfg = DPCConfig(**SMALL)
    if kind.startswith("pretrain"):
        tcfg = TrainConfig(batch_size=2, nce_impl="fused",
                           device_augment=True)
        model = dpc.build_dpc(cfg, CPU, seed=0)
        if kind == "pretrain_eval":
            step = pretrain_step.make_eval_step(cfg, tcfg, model)
            return model, lambda b, g, a: step(b, a)
        step = pretrain_step.make_pretrain_step(
            cfg, tcfg, model, optim.pretrain_optimizer(model, 1e-3, 1e-5))
        return model, lambda b, g, a: step(b, g, a)
    ecfg = EvalConfig(num_classes=CLASSES, batch_size=2, device_augment=True)
    model = lc.build_lc(cfg, CLASSES, CPU, dropout=0.5)
    if kind == "finetune_eval":
        step = finetune_step.make_finetune_eval_step(cfg, ecfg, model)
        return model, lambda b, g, a: step(b[0], b[1], a)
    step = finetune_step.make_finetune_step(
        cfg, ecfg, model, optim.finetune_optimizer(model, 1e-3, 1e-5))
    return model, lambda b, g, a: step(b[0], b[1], g, 1.0, a)


def _batches(kind: str) -> list:
    g = torch.Generator().manual_seed(1)
    out = []
    for _ in range(STEPS):
        x = torch.randint(0, 256, (2, 3, 4, 40, 48, 3), generator=g,
                          dtype=torch.uint8)
        out.append(x if kind.startswith("pretrain")
                   else (x, torch.randint(0, CLASSES, (2,), generator=g)))
    return out


def _run(kind: str):
    """``STEPS`` steps through the epoch loop and the feed: ``(model,
    each step's loss)``."""
    model, call = _job(kind)
    feed = loop.DeviceFeed(CPU)
    dropout, recipe = torch.Generator(), torch.Generator()
    losses = []

    def dispatch(idx, batch):
        dropout.manual_seed(idx)
        recipe.manual_seed(100 + idx)
        out = call(feed(batch), dropout, recipe)
        losses.append(out["loss"])
        return out

    loop.run_epoch(dispatch, _batches(kind), MetricBundle(),
                   print_freq=1 << 30)
    return model, [float(v) for v in losses]


def _inside(a, b) -> bool:
    return (b.time_range.start <= a.time_range.start
            and a.time_range.end <= b.time_range.end)


@pytest.mark.parametrize("kind", list(SPANS))
def test_steps_record_every_span_once_a_step(kind):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(kind)
    spans = sorted((e for e in prof.events() if e.name.startswith("dpc.")),
                   key=lambda e: e.time_range.start)
    assert Counter(e.name for e in spans) == {n: STEPS for n in SPANS[kind]}
    by = {n: [e for e in spans if e.name == n] for n in SPANS[kind]}
    for i, d in enumerate(by["dpc.loop.dispatch"]):
        for name in SPANS[kind]:
            if name not in ("dpc.loop.dispatch", "dpc.loop.drain"):
                assert _inside(by[name][i], d), name
        for name in MODEL:
            assert _inside(by[name][i], by["dpc.step.forward"][i]), name
        if "dpc.step.backward" in by:
            bwd = by["dpc.step.backward"][i]
            for name in BACKWARD[1:] + ("dpc.nce.backward",):
                if name in by:
                    assert _inside(by[name][i], bwd), name
            mark = by["dpc.backbone.stem.backward"][i]
            assert (mark.time_range.start
                    >= by["dpc.agg.backward"][i].time_range.end)
    # the drain waits for the previous step, outside any dispatch
    for drain in by["dpc.loop.drain"]:
        assert not any(_inside(drain, d) for d in by["dpc.loop.dispatch"])


def _graph_nodes(fn) -> int:
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo.extend(n for n, _ in f.next_functions)
    return len(seen)


@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_spans_leave_the_step_bit_identical(kind, monkeypatch):
    backward = torch.Tensor.backward
    nodes: list = []

    def counting(self, *a, **k):
        nodes.append(_graph_nodes(self.grad_fn))
        return backward(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "backward", counting)
    runs = {}
    runs["in place"] = _run(kind)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        runs["profiled"] = _run(kind)
    with monkeypatch.context() as m:
        m.setattr(profiling, "span", lambda name: contextlib.nullcontext())
        m.setattr(profiling, "mark_backward", lambda x, name: x)
        runs["patched out"] = _run(kind)
    assert len(nodes) == 3 * STEPS
    assert nodes[:STEPS] == nodes[STEPS:2 * STEPS] == nodes[2 * STEPS:]
    want_model, want_losses = runs.pop("patched out")
    want = want_model.state_dict()
    for name, (model, losses) in runs.items():
        assert losses == want_losses, name
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), (name, k)


def test_span_and_mark_record_only_under_a_profiler():
    # off: one shared no-op context, and no hook on the tensor
    assert profiling.span("dpc.a") is profiling.span("dpc.b")
    x = torch.ones(3, requires_grad=True)
    y = profiling.mark_backward(x * 2, "dpc.mark")
    assert y._backward_hooks is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("dpc.a"):
            y = profiling.mark_backward(x * 2, "dpc.mark")
        z = profiling.mark_backward(x.detach() * 2, "dpc.no_grad")
        y.sum().backward()
    assert z._backward_hooks is None
    names = [e.name for e in prof.events() if e.name.startswith("dpc.")]
    assert sorted(names) == ["dpc.a", "dpc.mark"]
    assert torch.equal(x.grad, torch.full((3,), 2.0))
