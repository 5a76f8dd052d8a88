"""The finetune job: the system's LC train step
(``finetune_step.make_finetune_step``) with ``--device_augment``, its Adam
(``optim.finetune_optimizer``: the trunk at ``lr·backbone_lr_scale``, the
head at ``lr``), the ConvGRU kernel path, on one rank or each rank of a
``{data: n}`` mesh; the labels come with the batch."""

from __future__ import annotations

import contextlib

import torch

from benchmark.jobs import common
from dpc_tpu_torch.core.config import EvalConfig
from dpc_tpu_torch.models import convgru, lc
from dpc_tpu_torch.train import finetune_step, optim


class Job(common.Job):
    name = "finetune"
    pieces = ("recipe", "stem", "convgru")

    def __init__(self, cfg: dict, traffic: dict, device, mesh):
        super().__init__(cfg, traffic, device, mesh)
        world = mesh.size if mesh else 1
        ft = cfg["finetune"]
        self.ecfg = EvalConfig(
            num_classes=ft["num_classes"], dropout=ft["dropout"],
            train_what=ft["train_what"], lr=ft["lr"], wd=ft["wd"],
            batch_size=traffic["batch"] * world,
            backbone_lr_scale=ft["backbone_lr_scale"], device_augment=True)
        e = self.ecfg
        self.model = lc.build_lc(self.mcfg, e.num_classes, device, e.dropout)
        self.optimizer = optim.finetune_optimizer(
            self.model, e.lr, e.wd, e.train_what, e.backbone_lr_scale)
        self.step = finetune_step.make_finetune_step(
            self.mcfg, e, self.model, self.optimizer, mesh)

    def call(self, batch, dropout_gen, recipe_gen) -> dict:
        clips, labels = batch
        return self.step(clips, labels, dropout_gen, 1.0, recipe_gen)

    @contextlib.contextmanager
    def capture(self, recipe: bool = True):
        """The first step's logits and, with ``recipe``, the recipe's
        output."""
        got: dict = {}

        def keep(_module, _args, out):
            got.setdefault("embed", {"logits": out.detach().float().cpu()})

        hooks = [self.capture_recipe(got, recipe),
                 self.model.final_fc[1].register_forward_hook(keep)]
        try:
            yield got
        finally:
            for h in hooks:
                h.remove()

    def piece(self, name: str, batch, dropout_gen, recipe_gen):
        m, dev = self.mcfg, self.device
        clips = batch[0]
        augment, _ = finetune_step.make_augment(m, self.ecfg, "train",
                                                self.mesh)
        if name == "recipe":
            return lambda: augment(clips, recipe_gen)
        if name == "stem":
            return self.stem_piece(augment(clips, recipe_gen))
        if name == "convgru":
            ls, d = m.last_size, m.feature_size
            x = torch.rand((self.traffic["batch"], m.num_seq, ls, ls, d),
                           device=dev)
            return self.gru_piece(x, dropout_gen)
        raise KeyError(name)

    def gru_call(self, x, dropout_gen):
        out, _ = convgru.apply_convgru(
            self.model.agg, x, dropout=self.mcfg.gru_dropout, train=True,
            generator=dropout_gen, impl=self.mcfg.gru_impl)
        return out[:, -1]
