"""Backbone registry / factory: the ``select_backbone`` equivalent (port of
``dpc_tpu/models/registry.py``).

Reference: ``backbone/select_backbone.py:3-21`` returns ``(model, param)``
where param carries the feature size consumed by the heads.  Here the
factory returns a constructor of the port's ``ResNet2d3d`` plus the same
param dict.
"""

from __future__ import annotations

import functools
from typing import Callable

from dpc_tpu_torch.models import resnet2d3d


def select_backbone(network: str, track_running_stats: bool = True
                    ) -> tuple[Callable[..., resnet2d3d.ResNet2d3d], dict]:
    """→ (constructor of the backbone module, param dict).

    param mirrors the reference's dict: ``feature_size`` (256 for
    BasicBlock nets, 1024 for Bottleneck — ``select_backbone.py:4-20``).
    The constructor takes ``ResNet2d3d``'s remaining keyword arguments
    (``stem_pool_impl``, ``stem_impl``).
    """
    if network not in resnet2d3d.ARCH:
        raise ValueError(f"unknown backbone: {network!r}")
    build = functools.partial(resnet2d3d.ResNet2d3d, network,
                              track_running_stats=track_running_stats)
    return build, {"feature_size": resnet2d3d.feature_size(network)}


def list_backbones() -> list[str]:
    return sorted(resnet2d3d.ARCH)
