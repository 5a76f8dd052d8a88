"""Weight bridge from ``dpc_tpu`` parameter trees to the port's modules.

``dpc_state_dict_from_jax`` takes a DPC parameter tree of ``dpc_tpu`` as
nested dicts and lists of numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns a state_dict under the reference's names, which
``DPC.load_state_dict(..., strict=True)`` accepts; ``lc_state_dict_from_jax``
does the same for an LC parameter tree and its BN running statistics, for
``LC``.  The key maps and layout transforms are this package's own copy of
``dpc_tpu/utils/torch_compat.py``:
  * Conv3d weight  (kT, kH, kW, I, O) → (O, I, kT, kH, kW)
  * Conv2d weight  (kH, kW, I, O)     → (O, I, kH, kW)
  * Linear weight  (I, O)             → (O, I)
  * BN scale / bias                   → weight / bias
  * BN running mean / var             → running_mean / running_var
Because the names are the reference's, a reference ``.pth.tar`` state_dict
loads into the port with no mapping at all.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_CONVERT = {
    "conv3d": lambda w: np.transpose(w, (4, 3, 0, 1, 2)),
    "conv2d": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "linear": lambda w: np.transpose(w, (1, 0)),
    "raw": lambda w: w,
}


def _backbone_key_map(params: dict) -> dict[str, tuple[str, str]]:
    """JAX path → (reference key, kind) for a resnet2d3d tree."""
    m = {"stem.conv.w": ("conv1.weight", "conv3d"),
         "stem.bn.scale": ("bn1.weight", "raw"),
         "stem.bn.bias": ("bn1.bias", "raw")}
    for li in range(1, 5):
        for bi, block in enumerate(params.get(f"layer{li}", [])):
            j, t = f"layer{li}.{bi}", f"layer{li}.{bi}"
            for ci in (1, 2, 3):
                if f"conv{ci}" in block:
                    m[f"{j}.conv{ci}.w"] = (f"{t}.conv{ci}.weight", "conv3d")
                    m[f"{j}.bn{ci}.scale"] = (f"{t}.bn{ci}.weight", "raw")
                    m[f"{j}.bn{ci}.bias"] = (f"{t}.bn{ci}.bias", "raw")
            if "downsample" in block:
                m[f"{j}.downsample.conv.w"] = (f"{t}.downsample.0.weight",
                                               "conv3d")
                m[f"{j}.downsample.bn.scale"] = (f"{t}.downsample.1.weight",
                                                 "raw")
                m[f"{j}.downsample.bn.bias"] = (f"{t}.downsample.1.bias",
                                                "raw")
    return m


def _backbone_state_key_map(state: dict) -> dict[str, tuple[str, str]]:
    """JAX path → (reference key, kind) of a resnet2d3d running-stats tree."""
    m = {"stem.bn.mean": ("bn1.running_mean", "raw"),
         "stem.bn.var": ("bn1.running_var", "raw")}
    for li in range(1, 5):
        for bi, block in enumerate(state.get(f"layer{li}", [])):
            j = t = f"layer{li}.{bi}"
            for ci in (1, 2, 3):
                if f"bn{ci}" in block:
                    m[f"{j}.bn{ci}.mean"] = (f"{t}.bn{ci}.running_mean", "raw")
                    m[f"{j}.bn{ci}.var"] = (f"{t}.bn{ci}.running_var", "raw")
            if "downsample" in block:
                m[f"{j}.downsample.bn.mean"] = (
                    f"{t}.downsample.1.running_mean", "raw")
                m[f"{j}.downsample.bn.var"] = (
                    f"{t}.downsample.1.running_var", "raw")
    return m


def _trunk_key_map(params: dict) -> dict[str, tuple[str, str]]:
    """The backbone and ConvGRU keys that DPC and LC trees share."""
    m = {f"backbone.{k}": (f"backbone.{tk}", kind)
         for k, (tk, kind) in _backbone_key_map(params["backbone"]).items()}
    for li in range(len(params["agg"]["cells"])):
        for gate in ("reset", "update", "out"):
            m[f"agg.cells.{li}.{gate}.w"] = (
                f"agg.cell_list.{li}.{gate}_gate.weight", "conv2d")
            m[f"agg.cells.{li}.{gate}.b"] = (
                f"agg.cell_list.{li}.{gate}_gate.bias", "raw")
    return m


def dpc_key_map(params: dict) -> dict[str, tuple[str, str]]:
    """JAX path → (reference DPC_RNN state_dict key, kind)."""
    m = _trunk_key_map(params)
    m["pred.conv1.w"] = ("network_pred.0.weight", "conv2d")
    m["pred.conv1.b"] = ("network_pred.0.bias", "raw")
    m["pred.conv2.w"] = ("network_pred.2.weight", "conv2d")
    m["pred.conv2.b"] = ("network_pred.2.bias", "raw")
    return m


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """{'a.b.0.c': leaf} paths of a nested dict/list tree."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def lc_key_map(params: dict) -> dict[str, tuple[str, str]]:
    """JAX path → (reference LC state_dict key, kind)
    (``eval/model_3d_lc.py``)."""
    m = _trunk_key_map(params)
    m["final_bn.scale"] = ("final_bn.weight", "raw")
    m["final_bn.bias"] = ("final_bn.bias", "raw")
    m["final_fc.w"] = ("final_fc.1.weight", "linear")
    m["final_fc.b"] = ("final_fc.1.bias", "raw")
    return m


def lc_state_key_map(state: dict) -> dict[str, tuple[str, str]]:
    """JAX path → (reference key, kind) of an LC running-stats tree."""
    m = {f"backbone.{k}": (f"backbone.{tk}", kind) for k, (tk, kind)
         in _backbone_state_key_map(state["backbone"]).items()}
    m["final_bn.mean"] = ("final_bn.running_mean", "raw")
    m["final_bn.var"] = ("final_bn.running_var", "raw")
    return m


def _convert(tree: dict, key_map: dict[str, tuple[str, str]]
             ) -> dict[str, torch.Tensor]:
    flat = _flatten(tree)
    extra = set(flat) - set(key_map)
    if extra:
        raise KeyError(f"entries with no reference name: {sorted(extra)}")
    return {tk: torch.tensor(np.ascontiguousarray(
                _CONVERT[kind](np.asarray(flat[path], np.float32))))
            for path, (tk, kind) in key_map.items()}


def dpc_state_dict_from_jax(params_np: dict) -> dict[str, torch.Tensor]:
    """A ``dpc_tpu`` DPC parameter tree → the port's ``DPC`` state_dict."""
    return _convert(params_np, dpc_key_map(params_np))


def lc_state_dict_from_jax(params_np: dict, state_np: dict
                           ) -> dict[str, torch.Tensor]:
    """A ``dpc_tpu`` LC parameter tree and its running-stats tree → the
    port's ``LC`` state_dict.  Every BN's ``num_batches_tracked`` is 0."""
    sd = _convert(params_np, lc_key_map(params_np))
    stats = _convert(state_np, lc_state_key_map(state_np))
    sd.update(stats)
    for k in stats:
        if k.endswith("running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(0, dtype=torch.long))
    return sd
