"""Candidate-sharded dense NCE over the model axis (port of
``dpc_tpu/ops/sharded_nce.py``).

With global negatives the candidate pool grows with the global batch.
Each model peer scores its data group's predictions against a 1/m slice
of the gathered GT pool; the softmax normaliser is a stable cross-peer
logsumexp (the shift, the max over the peers, is outside autograd), the
positive logit lives on one peer and is summed over the model group, and
top-k re-ranks the union of the per-peer top-k.  ``'fused'`` streams each
peer's ``[R_l, C/m]`` tile through K7 (``nce_cuda.nce_lse_rank_shard``)
and combines the per-peer lse and ranks; ``'xla'`` materialises the tile.

The collectives and their gradients are ``parallel/collectives.py``'s,
which are JAX's transposes, so every rank gets the gradient that
``dpc_tpu``'s ``shard_map`` body gets on its device.
"""

from __future__ import annotations

import torch

from dpc_tpu_torch.ops import nce, nce_cuda
from dpc_tpu_torch.parallel import collectives as C
from dpc_tpu_torch.parallel.mesh import Mesh


def _positives(mesh: Mesh, r_per_dev: int, c_local: int, device):
    """Each row's global positive column, its column in this peer's slice
    (clamped), and whether this peer owns it."""
    global_pos = (mesh.data_index * r_per_dev
                  + torch.arange(r_per_dev, device=device))
    local_pos = global_pos - mesh.model_index * c_local
    owned = (local_pos >= 0) & (local_pos < c_local)
    return global_pos, local_pos.clamp(0, c_local - 1), owned


def sharded_nce_loss(pred: torch.Tensor, gt: torch.Tensor, mesh: Mesh, *,
                     ks: tuple[int, ...] = (1, 3, 5), impl: str = "auto"
                     ) -> tuple[torch.Tensor, dict]:
    """Global-negative NCE with the candidate axis sharded over the model
    group.  ``pred``, ``gt``: this data group's ``[B_l, P, S, S, D]``
    (the same on every model peer).  Returns ``(loss, metrics)`` already
    averaged over the data group, equal on every rank; the loss equals the
    unsharded global-negatives loss."""
    bl, p, s, _, d = pred.shape
    rows = pred.reshape(bl * p * s * s, d).float()
    cols_full = C.all_gather(gt, mesh.data_group)
    cols_full = cols_full.reshape(-1, d).float()
    if cols_full.shape[0] % mesh.n_model:
        raise ValueError(f"{cols_full.shape[0]} candidates not divisible by "
                         f"{mesh.n_model} model peers")
    c_local = cols_full.shape[0] // mesh.n_model
    cols = cols_full[mesh.model_index * c_local:
                     (mesh.model_index + 1) * c_local]
    if impl == "auto":
        impl = nce.pick_nce_impl(rows.shape[0], c_local, d, rows.device)
    if impl not in ("xla", "fused"):
        raise ValueError(f"impl must be 'auto'|'xla'|'fused', got {impl!r}")
    global_pos, safe, owned = _positives(mesh, rows.shape[0], c_local,
                                         rows.device)
    with torch.autocast(rows.device.type, enabled=False):
        if impl == "fused":
            return _sharded_fused(rows, cols.contiguous(), mesh, global_pos,
                                  safe, owned, ks)
        score = rows @ cols.t()                              # [R_l, C/m]
        # stable cross-shard logsumexp; the max shift cancels analytically
        gmax = C.gather_max(score.detach().amax(dim=-1), mesh.model_group)
        sumexp = torch.exp(score - gmax[:, None]).sum(dim=-1)
        logz = torch.log(C.psum(sumexp, mesh.model_group)) + gmax
        pos_here = score.gather(1, safe[:, None])[:, 0]
        pos = C.psum(torch.where(owned, pos_here, 0.0), mesh.model_group)
        loss = C.pmean((logz - pos).mean(), mesh.data_group)

        # top-k: re-rank the union of the per-shard top-k (exact)
        maxk = min(max(ks), c_local)
        topv, topi = torch.topk(score.detach(), maxk, dim=-1)
        allv = C.gather(topv, mesh.model_group, dim=1)
        alli = C.gather(topi + mesh.model_index * c_local, mesh.model_group,
                        dim=1)
        order = torch.argsort(-allv, dim=-1)[:, :max(ks)]
        hit = alli.gather(1, order) == global_pos[:, None]
        metrics = {f"top{k}": _mean_over(hit[:, :k].any(-1).float().mean(),
                                          mesh)
                   for k in ks}
    return loss, metrics


def _mean_over(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A metric's mean over the model group, then over the data group."""
    x = C.mean_(x.detach().clone(), mesh.model_group)
    return C.mean_(x, mesh.data_group)


def _sharded_fused(rows, cols, mesh: Mesh, global_pos, safe, owned, ks):
    """K7 over this peer's candidate slice and the cross-shard combine:
    one pos sum, one ``[m, R]`` lse gather and one rank sum a step; the
    score tile exists only inside the kernels."""
    # the positive logit: a row dot on the owning peer, summed over the
    # model group (autograd routes its gradient to the owner)
    pos_here = (rows * cols[safe]).sum(dim=-1)
    pos = C.psum(torch.where(owned, pos_here, 0.0), mesh.model_group)
    tgt_local = torch.where(owned, safe, -1).int()
    lse_local, rank_local = nce_cuda.nce_lse_rank_shard(rows, cols, pos,
                                                        tgt_local)
    lse_all = C.all_gather(lse_local[None], mesh.model_group)   # [m, R]
    gmax = lse_all.detach().amax(dim=0)
    logz = torch.log(torch.exp(lse_all - gmax).sum(dim=0)) + gmax
    loss = C.pmean((logz - pos).mean(), mesh.data_group)
    rank = C.sum_(rank_local.clone(), mesh.model_group)
    metrics = {f"top{k}": C.mean_((rank < k).float().mean(), mesh.data_group)
               for k in ks}
    return loss, metrics
