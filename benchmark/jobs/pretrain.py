"""The pretrain job: the system's DPC train step
(``pretrain_step.make_pretrain_step``) with ``--device_augment``, its Adam
(``optim.pretrain_optimizer``), the ConvGRU kernel path the pretrain CLI
forces and its other defaults, on one rank or each rank of a ``{data: n}``
mesh."""

from __future__ import annotations

import contextlib

import torch

from benchmark.jobs import common
from dpc_tpu_torch.core.config import TrainConfig
from dpc_tpu_torch.models import convgru, dpc
from dpc_tpu_torch.ops import nce, nce_cuda
from dpc_tpu_torch.train import optim, pretrain_step


class Job(common.Job):
    name = "pretrain"
    pieces = ("recipe", "stem", "convgru", "nce")

    def __init__(self, cfg: dict, traffic: dict, device, mesh):
        super().__init__(cfg, traffic, device, mesh)
        world = mesh.size if mesh else 1
        self.tcfg = TrainConfig(
            batch_size=traffic["batch"] * world, lr=cfg["lr"], wd=cfg["wd"],
            negatives=cfg["negatives"], device_augment=True,
            device_augment_recipe=traffic["recipe"])
        self.model = dpc.build_dpc(self.mcfg, device, seed=0)
        self.optimizer = optim.pretrain_optimizer(self.model, self.tcfg.lr,
                                                  self.tcfg.wd)
        self.step = pretrain_step.make_pretrain_step(
            self.mcfg, self.tcfg, self.model, self.optimizer, mesh)

    def call(self, batch, dropout_gen, recipe_gen) -> dict:
        return self.step(batch, dropout_gen, recipe_gen)

    @contextlib.contextmanager
    def capture(self, recipe: bool = True):
        """The first step's (pred, gt) as the step hands them to the loss
        and, with ``recipe``, the recipe's output as the backbone gets it."""
        got: dict = {}
        saved = nce_cuda.fused_nce_loss, nce.dense_score

        def keep(pred, gt):
            got.setdefault("embed", {"pred": pred.detach().float().cpu(),
                                     "gt": gt.detach().float().cpu()})

        def fused(pred, gt, *a, **k):
            keep(pred, gt)
            return saved[0](pred, gt, *a, **k)

        def dense(pred, gt):
            keep(pred, gt)
            return saved[1](pred, gt)

        nce_cuda.fused_nce_loss, nce.dense_score = fused, dense
        hook = self.capture_recipe(got, recipe)
        try:
            yield got
        finally:
            nce_cuda.fused_nce_loss, nce.dense_score = saved
            hook.remove()

    def piece(self, name: str, batch, dropout_gen, recipe_gen):
        m, dev = self.mcfg, self.device
        b, ls, d = self.traffic["batch"], m.last_size, m.feature_size
        if name == "recipe":
            augment, _ = pretrain_step.make_augment(m, self.tcfg, self.mesh)
            return lambda: augment(batch, recipe_gen)
        if name == "stem":
            augment, _ = pretrain_step.make_augment(m, self.tcfg, self.mesh)
            return self.stem_piece(augment(batch, recipe_gen))
        if name == "convgru":
            x = torch.rand((b, m.context_blocks, ls, ls, d), device=dev)
            return self.gru_piece(x, dropout_gen)
        if name == "nce":
            local = TrainConfig(batch_size=b, negatives="local",
                                nce_impl=self.tcfg.nce_impl)
            loss_fn = pretrain_step.make_nce_loss(m, local, dev)
            shape = (b, m.pred_step, ls, ls, d)
            pred = torch.randn(shape, device=dev, requires_grad=True)
            gt = torch.randn(shape, device=dev, requires_grad=True)

            def run():
                loss, _ = loss_fn(pred, gt)
                loss.backward()
            return run
        raise KeyError(name)

    def gru_call(self, x, dropout_gen):
        _, last = convgru.apply_convgru(
            self.model.agg, x, dropout=self.mcfg.gru_dropout, train=True,
            generator=dropout_gen, impl=self.mcfg.gru_impl)
        return last
