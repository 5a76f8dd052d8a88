"""Convolutional GRU aggregator (port of ``dpc_tpu/models/convgru.py``).

A stack of gated conv-recurrent cells run over the block axis, as in the
reference ``backbone/convrnn.py``:
  * gate wiring ``h' = h·(1−z) + tanh(out([x, h·r]))·z`` with z, r from
    ``[x, h]`` (``convrnn.py:30-34``);
  * dropout on the hidden state at every step; the dropped hidden state
    both feeds the next step and is the step's output (``convrnn.py:59,78``),
    and stays live in the autoregressive rollout;
  * orthogonal weights, zero biases (``convrnn.py:17-22``).

``apply_convgru`` with ``impl="pallas"`` and a 1×1 kernel runs the whole
sequence through the recurrence kernel (``ops/convgru_cuda.py``); otherwise
it runs the plain per-step loop.  ``convgru_single_step`` is always the
plain step, as in the JAX package's rollout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from dpc_tpu_torch.models import layers as L
from dpc_tpu_torch.ops import convgru_cuda
from dpc_tpu_torch.utils import profiling


class ConvGRUCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, kernel_size: int):
        super().__init__()
        c = input_size + hidden_size
        self.reset_gate = L.conv2d(c, hidden_size, kernel_size)
        self.update_gate = L.conv2d(c, hidden_size, kernel_size)
        self.out_gate = L.conv2d(c, hidden_size, kernel_size)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One gated step.  x: ``[B, H, W, Cin]``, h: ``[B, H, W, Ch]``."""
        xh = torch.cat([x, h], dim=-1)
        z = torch.sigmoid(L.conv2d_cl(self.update_gate, xh))
        r = torch.sigmoid(L.conv2d_cl(self.reset_gate, xh))
        out = torch.tanh(L.conv2d_cl(self.out_gate,
                                     torch.cat([x, h * r], dim=-1)))
        return h * (1.0 - z) + out * z


class ConvGRU(nn.Module):
    """Reference module ``agg``: ``cell_list.L.{reset,update,out}_gate``."""

    def __init__(self, input_size: int, hidden_size: int,
                 kernel_size: int = 1, num_layers: int = 1):
        super().__init__()
        self.kernel_size = kernel_size
        self.hidden_size = hidden_size
        self.cell_list = nn.ModuleList([
            ConvGRUCell(input_size if i == 0 else hidden_size, hidden_size,
                        kernel_size) for i in range(num_layers)])


def apply_convgru(agg: ConvGRU, x: torch.Tensor,
                  hidden: Optional[Sequence[torch.Tensor]] = None, *,
                  dropout: float = 0.1, train: bool = True,
                  generator: Optional[torch.Generator] = None,
                  impl: str = "scan",
                  masks: Optional[Sequence[torch.Tensor]] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the stack over a block sequence.

    x: ``[B, T, H, W, C]``; hidden: optional per-layer ``[B, H, W, Ch]``.
    Returns ``(outputs [B, T, H, W, Ch], last_states [B, L, H, W, Ch])``.

    Dropout is drawn from ``generator`` when ``train`` and ``dropout > 0``
    (no generator: no dropout, as a missing key is in the JAX package).
    ``masks`` injects the dropout multipliers instead: one ``[T, B·H·W,
    Ch]`` tensor per layer, rows in ``(b, h, w)`` order.
    """
    cells = agg.cell_list
    b, t, hgt, wid, _ = x.shape
    ch = agg.hidden_size
    rows = b * hgt * wid
    if hidden is None:
        hidden = [x.new_zeros((b, hgt, wid, ch))] * len(cells)
    use_dropout = train and dropout > 0.0 and generator is not None

    def layer_masks(li):
        if masks is not None:
            return masks[li]
        if use_dropout:
            return L.dropout_mask((t, rows, ch), dropout, generator, x.device)
        return None

    last_states = []
    cur = x
    with profiling.span("dpc.agg"):
        for li, cell in enumerate(cells):
            m = layer_masks(li)
            if impl == "pallas" and agg.kernel_size == 1:
                cur, h = convgru_cuda.fused_convgru_layer(
                    cell, cur, hidden[li].to(cur.dtype), m)
            else:
                h = hidden[li]
                outs = []
                for step in range(t):
                    h = cell(cur[:, step], h)
                    if m is not None:
                        h = h * m[step].reshape(b, hgt, wid, ch).to(h.dtype)
                    outs.append(h)
                cur = torch.stack(outs, dim=1)
            last_states.append(h)
        return cur, torch.stack(last_states, dim=1)


def convgru_single_step(agg: ConvGRU, x: torch.Tensor,
                        hidden: Sequence[torch.Tensor], *,
                        dropout: float = 0.1, train: bool = True,
                        generator: Optional[torch.Generator] = None
                        ) -> list[torch.Tensor]:
    """Advance every layer by ONE step (the rollout path,
    ``dpc/model_3d.py:70``).  Returns the new per-layer hidden list."""
    new_hidden = []
    inp = x
    for li, cell in enumerate(agg.cell_list):
        h_new = L.dropout(cell(inp, hidden[li]), dropout, generator, train)
        new_hidden.append(h_new)
        inp = h_new
    return new_hidden
