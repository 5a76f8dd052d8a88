"""Optimizers and the LR schedule (port of ``dpc_tpu/train/optim.py``).

``torch.optim.Adam(lr, weight_decay=wd)`` is the reference's optimizer
(``dpc/main.py:81``) and, by construction, ``dpc_tpu``'s ``torch_adam``:
coupled L2 decay added to the gradient before the moments, eps outside
the square root.
"""

from __future__ import annotations

import torch
from torch import nn


def pretrain_optimizer(model: nn.Module, lr: float, wd: float,
                       train_what: str = "all") -> torch.optim.Adam:
    """Adam over the trainable parameters.  ``train_what='last'`` freezes
    the backbone (the reference's ``requires_grad=False``,
    ``dpc/main.py:70-72``) and trains the aggregator and predictor only."""
    if train_what not in ("all", "last"):
        raise ValueError(f"train_what must be 'all' or 'last', got "
                         f"{train_what!r}")
    if train_what == "last":
        for p in model.backbone.parameters():
            p.requires_grad_(False)
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=lr, weight_decay=wd)


TRUNK = ("backbone", "agg")


def finetune_optimizer(model: nn.Module, lr: float, wd: float,
                       train_what: str = "ft",
                       backbone_lr_scale: float = 0.1) -> torch.optim.Adam:
    """LC finetune (port of ``dpc_tpu/train/optim.py:60-82``): the trunk
    (``backbone``, ``agg``) at ``lr·backbone_lr_scale`` and the head at
    ``lr``, both torch Adam with coupled L2.  ``train_what='last'`` freezes
    the trunk (the linear probe).

    The reference intends the trunk at lr/10 but its name filter
    (``eval/test.py:78-81``) matches nothing, so as written every group
    trains at the full lr; ``backbone_lr_scale=1.0`` reproduces that.  Each
    group keeps its ``base_lr`` for ``set_lr_scale``."""
    if train_what not in ("ft", "last"):
        raise ValueError(f"train_what must be 'ft' or 'last', got "
                         f"{train_what!r}")
    trunk = [p for name in TRUNK for p in getattr(model, name).parameters()]
    head = [p for name, mod in model.named_children() if name not in TRUNK
            for p in mod.parameters()]
    if train_what == "last":
        for p in trunk:
            p.requires_grad_(False)
        groups = [{"params": head, "base_lr": lr}]
    else:
        groups = [{"params": trunk, "base_lr": lr * backbone_lr_scale},
                  {"params": head, "base_lr": lr}]
    for g in groups:
        g["lr"] = g["base_lr"]
    return torch.optim.Adam(groups, weight_decay=wd)


def set_lr_scale(optimizer: torch.optim.Optimizer, scale: float) -> None:
    """Every group at ``base_lr·scale``: the JAX step's ``lr_scale``, which
    multiplies Adam's update, as one multiplier of the learning rate."""
    for g in optimizer.param_groups:
        g["lr"] = g["base_lr"] * scale


def multistep_restart_lr(epoch: int, base_lr: float, milestones,
                         gamma: float, repeat: int = 1) -> float:
    """The reference's ``MultiStepLR_Restart_Multiplier``
    (``eval/test.py:408-420``): decay by ``gamma`` at each milestone within
    a cycle of ``max(milestones)`` epochs; after ``repeat`` cycles hold at
    the second-deepest level.  Canonical sets (``eval/test.py:94-98``):
    ucf101-128 (60, 80, 100), ucf101-224 (300, 400, 500), hmdb51
    (150, 250, 300), all with repeat 1."""
    max_step = max(milestones)
    if epoch // max_step >= repeat:
        exp = len(milestones) - 1
    else:
        eff = epoch % max_step
        exp = sum(1 for m in milestones if eff >= m)
    return base_lr * gamma ** exp
