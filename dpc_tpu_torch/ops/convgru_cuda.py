"""Whole-sequence ConvGRU recurrence (kernel_size 1): CUDA kernels and
their plain PyTorch versions.

Port of ``dpc_tpu/ops/convgru_pallas.py``.  ``convgru_forward`` runs
K-GRU-F (``csrc/convgru.cu``) on CUDA tensors and ``convgru_forward_plain``
on CPU tensors; ``convgru_backward`` likewise runs K-GRU-B or
``convgru_backward_plain``.  There is no fallback between them: a CUDA
tensor launches the kernel or raises.  The kernels run every product on the
tensor cores as 3xTF32 (f32 split into two TF32 terms, three products),
which holds the f32 contract; the products that do not carry the hidden
state are hoisted out of the recurrence, which runs as one persistent
kernel.  Each entry point works in scratch that the wrapper allocates.

Sequence layout is time-major ``[T, R, C]`` with R = B·H·W rows; the
weights are ``pack_weights`` of the JAX op:
  wzr_x [Cin, 2Ch], wzr_h [Ch, 2Ch], b_zr [2Ch]   (update ‖ reset, fused)
  wo_x  [Cin,  Ch], wo_h  [Ch,  Ch], b_o  [Ch]
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dpc_tpu_torch.ops import _build
from dpc_tpu_torch.utils import profiling


def pack_weights(cell: nn.Module) -> tuple[torch.Tensor, ...]:
    """1×1 gate convs (``[Ch, Cin+Ch, 1, 1]``) → the dense kernel layout.
    Differentiable: gradients reach the conv parameters through autograd."""
    wz = cell.update_gate.weight[:, :, 0, 0].t()   # [Cin+Ch, Ch]
    wr = cell.reset_gate.weight[:, :, 0, 0].t()
    wo = cell.out_gate.weight[:, :, 0, 0].t()
    ch = wz.shape[1]
    cin = wz.shape[0] - ch
    wzr = torch.cat([wz, wr], dim=1)                # [Cin+Ch, 2Ch]
    return (wzr[:cin].contiguous(), wzr[cin:].contiguous(),
            torch.cat([cell.update_gate.bias, cell.reset_gate.bias]),
            wo[:cin].contiguous(), wo[cin:].contiguous(), cell.out_gate.bias)


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors; the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------

def _gates(x, h, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o):
    ch = h.shape[-1]
    zr = torch.sigmoid(x @ wzr_x + h @ wzr_h + b_zr)
    z, r = zr[..., :ch], zr[..., ch:]
    o = torch.tanh(x @ wo_x + (h * r) @ wo_h + b_o)
    return z, r, o


def convgru_forward_plain(x_seq, h0, weights, masks):
    """Every ``h_t`` of the recurrence, stacked ``[T, R, Ch]``."""
    with torch.autocast(x_seq.device.type, enabled=False):
        h = h0
        outs = []
        for t in range(x_seq.shape[0]):
            z, _, o = _gates(x_seq[t], h, *weights)
            h = (h * (1.0 - z) + o * z) * masks[t]
            outs.append(h)
        return torch.stack(outs)


def convgru_backward_plain(x_seq, h0, out, weights, masks, g_out):
    """Reverse scan with recomputed gates (``_core_bwd_jax`` of the JAX op).
    Returns ``(dx, dh0, dwzr_x, dwzr_h, db_zr, dwo_x, dwo_h, db_o)``."""
    wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o = weights
    with torch.autocast(x_seq.device.type, enabled=False):
        h_prev = torch.cat([h0[None], out[:-1]])
        dh = torch.zeros_like(h0)
        dx = torch.empty_like(x_seq)
        grads = [torch.zeros_like(w) for w in weights]
        for t in reversed(range(x_seq.shape[0])):
            x, h_in = x_seq[t], h_prev[t]
            z, r, o = _gates(x, h_in, *weights)
            dh_raw = (dh + g_out[t]) * masks[t]
            dz = dh_raw * (o - h_in)
            dh = dh_raw * (1.0 - z)
            dao = dh_raw * z * (1.0 - o * o)
            dhr = dao @ wo_h.t()
            dh = dh + dhr * r
            dazr = torch.cat([dz * z * (1.0 - z), dhr * h_in * r * (1.0 - r)],
                             dim=-1)
            dx[t] = dazr @ wzr_x.t() + dao @ wo_x.t()
            dh = dh + dazr @ wzr_h.t()
            for acc, upd in zip(grads, (x.t() @ dazr, h_in.t() @ dazr,
                                        dazr.sum(0), x.t() @ dao,
                                        (h_in * r).t() @ dao, dao.sum(0))):
                acc += upd
        return (dx, dh, *grads)


# ---------------------------------------------------------------------------
# Wrappers: kernel for CUDA tensors, plain version for CPU tensors
# ---------------------------------------------------------------------------

def convgru_forward(x_seq, h0, weights, masks):
    """K-GRU-F.  x_seq ``[T, R, Cin]``, h0 ``[R, Ch]``, masks ``[T, R, Ch]``
    (inverted-dropout multipliers, ones without dropout), all f32."""
    if x_seq.device.type == "cpu":
        return convgru_forward_plain(x_seq, h0, weights, masks)
    t, r, cin = x_seq.shape
    ch = h0.shape[-1]
    _build.check_cuda_f32(x_seq, h0, *weights, masks)
    out = torch.empty((t, r, ch), device=x_seq.device, dtype=torch.float32)
    scratch = _build.scratch("convgru", "convgru_fwd_scratch_floats",
                             x_seq.device, t, r, cin, ch)
    _build.launch("convgru", "convgru_fwd", x_seq, h0, *weights, masks, out,
                  scratch, scratch.numel(), t, r, cin, ch)
    return out


def convgru_backward(x_seq, h0, out, weights, masks, g_out):
    """K-GRU-B.  Returns ``(dx, dh0, dwzr_x, dwzr_h, db_zr, dwo_x, dwo_h,
    db_o)``; the weight gradients are sums over all T·R rows."""
    if x_seq.device.type == "cpu":
        return convgru_backward_plain(x_seq, h0, out, weights, masks, g_out)
    t, r, cin = x_seq.shape
    ch = h0.shape[-1]
    g_out = g_out.contiguous()
    _build.check_cuda_f32(x_seq, h0, out, *weights, masks, g_out)
    hin_seq = torch.cat([h0[None], out[:-1]])
    new = lambda *shape: torch.empty(shape, device=x_seq.device,
                                     dtype=torch.float32)
    dx, dh0 = new(t, r, cin), new(r, ch)
    dwzr_xb, dwzr_h = new(cin + 1, 2 * ch), new(ch, 2 * ch)
    dwo_xb, dwo_h = new(cin + 1, ch), new(ch, ch)
    scratch = _build.scratch("convgru", "convgru_bwd_scratch_floats",
                             x_seq.device, t, r, cin, ch)
    _build.launch("convgru", "convgru_bwd", x_seq, hin_seq, masks, g_out,
                  *weights, dx, dh0, dwzr_xb, dwzr_h, dwo_xb, dwo_h,
                  scratch, scratch.numel(), t, r, cin, ch)
    return (dx, dh0, dwzr_xb[:cin], dwzr_h, dwzr_xb[cin], dwo_xb[:cin],
            dwo_h, dwo_xb[cin])


class _FusedCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_seq, h0, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o, masks):
        weights = (wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o)
        out = convgru_forward(x_seq, h0, weights, masks)
        ctx.save_for_backward(x_seq, h0, out, *weights, masks)
        return out

    @staticmethod
    def backward(ctx, g_out):
        x_seq, h0, out, *weights, masks = ctx.saved_tensors
        with profiling.span("dpc.agg.backward"):
            return (*convgru_backward(x_seq, h0, out, tuple(weights), masks,
                                      g_out), None)


def fused_core(x_seq, h0, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o, masks):
    """Differentiable recurrence over packed weights: the counterpart of
    ``convgru_pallas._fused_core``."""
    return _FusedCore.apply(x_seq, h0, wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o,
                            masks)


def fused_convgru_layer(cell: nn.Module, x: torch.Tensor, h0: torch.Tensor,
                        masks: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One ConvGRU layer over a block sequence through the recurrence kernel.

    x: ``[B, T, H, W, Cin]`` f32; h0: ``[B, H, W, Ch]`` f32; masks: ``[T,
    B·H·W, Ch]`` dropout multipliers, or None for no dropout.  Returns
    (outputs ``[B, T, H, W, Ch]``, h_last ``[B, H, W, Ch]``).
    """
    b, t, hh, ww, cin = x.shape
    ch = h0.shape[-1]
    rows = b * hh * ww
    x_seq = x.permute(1, 0, 2, 3, 4).reshape(t, rows, cin).contiguous()
    if masks is None:
        masks = torch.ones((t, rows, ch), device=x.device, dtype=torch.float32)
    out = fused_core(x_seq, h0.reshape(rows, ch).contiguous(),
                     *pack_weights(cell), masks)
    out = out.reshape(t, b, hh, ww, ch).permute(1, 0, 2, 3, 4)
    return out, out[:, -1]
