"""Flash-NCE: CUDA kernels and their plain PyTorch versions.

Port of ``dpc_tpu/ops/nce_pallas.py``.  ``nce_forward`` runs K-NCE-F
(``csrc/nce.cu``) on CUDA tensors and ``nce_forward_plain`` on CPU tensors;
``nce_backward`` likewise runs K-NCE-B or ``nce_backward_plain``.  A CUDA
tensor launches the kernel or raises; nothing falls back.  The kernels run
their products on the tensor cores as 3xTF32 (f32 split into two TF32
terms, three products), which holds the f32 contract; each entry point
splits its operands into scratch that the wrapper allocates.

loss_i = logsumexp_j(s_ij) − s_i,pos with s = rows·colsᵀ, and top-k from
the rank ``#{j ≠ target_i : s_ij > pos_i}``.  The kernels never write the
score matrix to device memory.

``nce_lse_rank_shard`` (K7, ``nce_pallas.nce_lse_rank_shard``) runs the
same two kernels over one candidate shard for the model-parallel NCE
(``ops/sharded_nce.py``), with ``pos`` passed in and the target ``-1`` off
the shard that owns the positive; its launches count as
``nce_fwd_shard`` and ``nce_bwd_shard``.
"""

from __future__ import annotations

from typing import Optional

import torch

from dpc_tpu_torch.ops import _build


def nce_forward_plain(rows, cols, pos, targets):
    """(lse, rank) per row from the materialised score."""
    with torch.autocast(rows.device.type, enabled=False):
        score = rows @ cols.t()
        lse = torch.logsumexp(score, dim=-1)
        col = torch.arange(cols.shape[0], device=rows.device)
        beats = (score > pos[:, None]) & (col[None, :] != targets[:, None])
        return lse, beats.sum(-1).float()


def nce_backward_plain(rows, cols, lse, g):
    """drows = P·cols, dcols = Pᵀ·rows with P = exp(S − lse)·g."""
    with torch.autocast(rows.device.type, enabled=False):
        p = torch.exp(rows @ cols.t() - lse[:, None]) * g[:, None]
        return p @ cols, p.t() @ rows


def nce_forward(rows, cols, pos, targets, count_as: str = "nce_fwd"):
    """K-NCE-F.  rows ``[R, D]``, cols ``[C, D]``, pos ``[R]`` f32,
    targets ``[R]`` int32 (``-1``: no column is excluded from the rank) →
    (lse, rank), both ``[R]`` f32."""
    if rows.device.type == "cpu":
        return nce_forward_plain(rows, cols, pos, targets)
    _build.check_cuda_f32(rows, cols, pos)
    if targets.dtype != torch.int32 or targets.device != rows.device:
        raise TypeError("targets must be int32 on the rows' device")
    r, c, d = _check_shapes(rows, cols, pos, targets)
    lse = torch.empty(r, device=rows.device, dtype=torch.float32)
    rank = torch.empty_like(lse)
    scratch = _build.scratch("nce", "nce_fwd_scratch_floats", rows.device,
                             r, c, d)
    _build.launch("nce", "nce_fwd", rows, cols, pos, targets.contiguous(),
                  lse, rank, scratch, scratch.numel(), r, c, d,
                  count_as=count_as)
    return lse, rank


def nce_backward(rows, cols, lse, g, count_as: str = "nce_bwd"):
    """K-NCE-B: (drows, dcols) of Σ_i g_i·lse_i, both sweeps in one kernel
    launch, its partial sums reduced in a fixed order (no atomics)."""
    if rows.device.type == "cpu":
        return nce_backward_plain(rows, cols, lse, g)
    g = g.contiguous()
    _build.check_cuda_f32(rows, cols, lse, g)
    r, c, d = _check_shapes(rows, cols, lse, g)
    drows, dcols = torch.empty_like(rows), torch.empty_like(cols)
    scratch = _build.scratch("nce", "nce_bwd_scratch_floats", rows.device,
                             r, c, d)
    _build.launch("nce", "nce_bwd", rows, cols, lse, g, drows, dcols,
                  scratch, scratch.numel(), r, c, d, count_as=count_as)
    return drows, dcols


def _check_shapes(rows, cols, *per_row):
    """rows ``[R, D]``, cols ``[C, D]`` and vectors of length R → R, C, D."""
    if rows.dim() != 2 or cols.dim() != 2 or rows.shape[1] != cols.shape[1]:
        raise ValueError(f"rows {tuple(rows.shape)} and cols "
                         f"{tuple(cols.shape)} must be [R, D] and [C, D]")
    r = rows.shape[0]
    if any(v.shape != (r,) for v in per_row):
        raise ValueError(f"per-row inputs must be [{r}]: "
                         f"{[tuple(v.shape) for v in per_row]}")
    return r, cols.shape[0], rows.shape[1]


class _LseRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, cols, targets):
        t = targets.long()
        pos = (rows * cols[t]).sum(-1)
        lse, rank = nce_forward(rows, cols, pos, targets)
        ctx.save_for_backward(rows, cols, targets, lse)
        ctx.mark_non_differentiable(rank)
        return lse, pos, rank

    @staticmethod
    def backward(ctx, g_lse, g_pos, _g_rank):
        rows, cols, targets, lse = ctx.saved_tensors
        t = targets.long()
        drows, dcols = nce_backward(rows, cols, lse, g_lse)
        # positive-logit term: d(pos_i)/drows_i = cols[t_i], scattered
        # onto the target columns for dcols
        drows = drows + g_pos[:, None] * cols[t]
        dcols = dcols.index_add(0, t, g_pos[:, None] * rows)
        return drows, dcols, None


def nce_lse_rank(rows: torch.Tensor, cols: torch.Tensor,
                 targets: torch.Tensor):
    """(lse, pos, rank) per row without materialising the score matrix on
    the card.  rows ``[R, D]`` f32, cols ``[C, D]`` f32, targets ``[R]``
    int32.  loss = mean(lse − pos); top-k accuracy = mean(rank < k)."""
    return _LseRank.apply(rows, cols, targets)


class _LseRankShard(torch.autograd.Function):
    """K7: the statistics of one candidate shard.  The backward is K6 with
    this shard's lse and the incoming cotangent: for L = f(logsumexp_s
    lse_s), e^{s_ij−lse_s}·∂L/∂lse_s = e^{s_ij−LSE}·∂L/∂LSE, the global
    softmax, so the cross-shard combine composes with plain autograd."""

    @staticmethod
    def forward(ctx, rows, cols, pos, targets, plain):
        ctx.plain = plain
        if plain:
            lse, rank = nce_forward_plain(rows, cols, pos, targets)
        else:
            lse, rank = nce_forward(rows, cols, pos, targets,
                                    count_as="nce_fwd_shard")
        ctx.save_for_backward(rows, cols, lse)
        ctx.mark_non_differentiable(rank)
        return lse, rank

    @staticmethod
    def backward(ctx, g_lse, _g_rank):
        rows, cols, lse = ctx.saved_tensors
        if ctx.plain:
            drows, dcols = nce_backward_plain(rows, cols, lse, g_lse)
        else:
            drows, dcols = nce_backward(rows, cols, lse, g_lse,
                                        count_as="nce_bwd_shard")
        # pos enters only the rank count; its loss term is a gather outside
        # the kernel, differentiated there (_shard_bwd, nce_pallas.py:380)
        return drows, dcols, torch.zeros_like(lse), None, None


def nce_lse_rank_shard(rows: torch.Tensor, cols: torch.Tensor,
                       pos: torch.Tensor, targets: torch.Tensor):
    """K7 (``nce_pallas.nce_lse_rank_shard``): ``(lse_local, rank_local)``
    of ``rows [R, D]`` against one candidate shard ``cols [C/m, D]`` (f32),
    ``pos [R]`` the positive logit (broadcast from its owner) and
    ``targets [R]`` int32 the positive's local column on its owner, ``-1``
    elsewhere.  The caller combines ``logsumexp`` of the lse and the sum
    of the ranks over the model group.  Gradients for rows and cols; zero
    for pos."""
    return _LseRankShard.apply(rows, cols, pos, targets, False)


def nce_lse_rank_shard_plain(rows, cols, pos, targets):
    """K7's plain version (``nce_forward_plain`` and
    ``nce_backward_plain`` under the same autograd contract), for any
    device; the reference of the kernel on the card."""
    return _LseRankShard.apply(rows, cols, pos, targets, True)


def fused_nce_loss(pred: torch.Tensor, gt: torch.Tensor,
                   targets: Optional[torch.Tensor] = None,
                   ks: tuple[int, ...] = (1, 3, 5)
                   ) -> tuple[torch.Tensor, dict]:
    """Drop-in for ``dense_score`` + ``nce_loss``.  pred, gt:
    ``[B, P, S, S, D]``; targets default to the diagonal."""
    d = pred.shape[-1]
    rows = pred.reshape(-1, d).float().contiguous()
    cols = gt.reshape(-1, d).float().contiguous()
    if targets is None:
        if rows.shape[0] != cols.shape[0]:
            raise ValueError("default diagonal targets need as many GT "
                             "cells as predictions")
        targets = torch.arange(rows.shape[0], device=rows.device,
                               dtype=torch.int32)
    lse, pos, rank = nce_lse_rank(rows, cols, targets.int())
    loss = (lse - pos).mean()
    return loss, {f"top{k}": (rank < k).float().mean() for k in ks}
