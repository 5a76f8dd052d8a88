"""Pretraining optimizer (port of ``dpc_tpu/train/optim.py:21-57``).

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
