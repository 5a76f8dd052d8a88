"""The arithmetic precision the reference runs in.

``Precision("float32")`` is the reference itself: every operand as it is,
and TF32 off on the card (``exact_f32``), since a float32 product there may
otherwise run in TF32.

``Precision("float8")`` is the control of the correctness check: the
configurations' bfloat16 autocast taken one step down, as fp8 training
does it.  Each operand of a convolution, linear map or score product is
rounded to float8 e4m3 with a per-tensor scale, and each gradient flowing
back into one to float8 e5m2; each product's output, and the gradient
flowing back into it, is rounded to bfloat16, as autocast's outputs are;
the device recipe, which the configurations run in float32, is rounded to
bfloat16, its step below.

``Precision("bfloat16")`` is a witness, not a control: the same structure
with bfloat16 operands, the rounding the system's autocast does, to show
how far the system's own rounding moves each compared number.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float
               ) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Round(torch.autograd.Function):
    """Round the value one way and its gradient another."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().to(x.dtype)


def _e4m3(x):
    return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)


def _e5m2(x):
    return _round_fp8(x, torch.float8_e5m2, E5M2_MAX)


class Precision:
    NAMES = ("float32", "bfloat16", "float8")

    def __init__(self, name: str = "float32"):
        if name not in self.NAMES:
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, in this precision."""
        if self.name == "float32":
            return x
        if self.name == "bfloat16":
            return _Round.apply(x, _bf16, _bf16)
        return _Round.apply(x, _e4m3, _e5m2)

    def act(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output, as autocast hands it on."""
        return y if self.name == "float32" else _Round.apply(y, _bf16, _bf16)

    def recipe(self, x: torch.Tensor) -> torch.Tensor:
        """The device recipe's output, in this precision."""
        return _bf16(x) if self.name == "float8" else x


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and cuDNN inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
