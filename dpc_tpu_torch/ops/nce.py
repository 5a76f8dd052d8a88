"""Dense spatio-temporal InfoNCE: score, mask, targets, loss.

Port of ``dpc_tpu/ops/nce.py``.  Every predicted spatial cell is scored
against every ground-truth cell of the (local) batch with one matrix
product, and each prediction classifies its own cell among all candidates:
plain softmax cross-entropy over the flattened ``[B·P·SQ, B·P·SQ]`` score,
with top-1/3/5 accuracy (reference ``dpc/model_3d.py:76-96``,
``dpc/main.py:209-218``).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

# Semantic mask codes (reference dpc/model_3d.py:87)
POSITIVE = 1
EASY_NEG = 0        # different sample in batch
TEMPORAL_NEG = -1   # same sample & spatial cell, wrong time step
OMIT = -2           # reserved, never assigned in the canonical config
SPATIAL_NEG = -3    # same sample, different spatial cell


@functools.lru_cache(maxsize=16)
def nce_mask(batch: int, pred_step: int, sq: int) -> np.ndarray:
    """Full semantic mask, int8 ``[B, P, SQ, B, P, SQ]`` (pred sample, pred
    step, pred cell, GT sample, GT step, GT cell)."""
    b = np.arange(batch)
    p = np.arange(pred_step)
    q = np.arange(sq)
    same_b = (b[:, None] == b[None, :])[:, None, None, :, None, None]
    same_q = (q[:, None] == q[None, :])[None, None, :, None, None, :]
    same_p = (p[:, None] == p[None, :])[None, :, None, None, :, None]
    mask = np.zeros((batch, pred_step, sq, batch, pred_step, sq), np.int8)
    mask = np.where(same_b, SPATIAL_NEG, mask)
    mask = np.where(same_b & same_q, TEMPORAL_NEG, mask)
    mask = np.where(same_b & same_q & same_p, POSITIVE, mask)
    return mask.astype(np.int8)


@functools.lru_cache(maxsize=16)
def nce_targets(batch: int, pred_step: int, sq: int) -> np.ndarray:
    """Row (b, p, q) of the flattened score has its positive at column
    (b, p, q): the diagonal (``mask.view(R, C).argmax(1)`` of the
    reference)."""
    return np.arange(batch * pred_step * sq, dtype=np.int32)


def dense_score(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred, gt: ``[B, P, S, S, D]`` → the ``[B·P·S², B·P·S²]`` score."""
    d = pred.shape[-1]
    return pred.reshape(-1, d) @ gt.reshape(-1, d).t()


def nce_loss(score: torch.Tensor, targets: torch.Tensor
             ) -> tuple[torch.Tensor, dict]:
    """Softmax cross-entropy over ``score [R, C]`` and top-1/3/5."""
    t = targets.long()
    logz = torch.logsumexp(score, dim=-1)
    pos = score.gather(1, t[:, None])[:, 0]
    loss = (logz - pos).mean()
    return loss, topk_accuracy(score.detach(), t, (1, 3, 5))


def topk_accuracy(score: torch.Tensor, targets: torch.Tensor,
                  ks: tuple[int, ...] = (1, 3, 5)) -> dict:
    """Fraction of rows whose positive ranks in the top-k columns; k is
    clamped to the candidate count."""
    ncols = score.shape[-1]
    maxk = min(max(ks), ncols)
    idx = torch.topk(score, maxk, dim=-1).indices
    hit = idx == targets.long()[:, None]
    return {f"top{k}": hit[:, :min(k, ncols)].any(-1).float().mean()
            for k in ks}


def device_memory_bytes(device: torch.device) -> int:
    """Memory of ``device``: the card's, or the host's for the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def pick_nce_impl(n_rows: int, n_cols: int, device: torch.device,
                  budget_frac: float = 0.125) -> str:
    """'xla' (materialised score) or 'fused' (flash kernels) by projected
    score bytes: 'fused' when the two score-sized buffers (forward score,
    backward softmax) would claim more than ``budget_frac`` of the
    device's memory.  The name 'xla' is kept so configs read the same in
    both packages; here it means the plain matmul + softmax path."""
    score_bytes = 2 * 4 * n_rows * n_cols
    return ("fused" if score_bytes > budget_frac * device_memory_bytes(device)
            else "xla")
