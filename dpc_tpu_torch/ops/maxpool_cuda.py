"""The stem's ReLU + 3×3/s2/p1 max-pool: CUDA kernels and their plain
PyTorch versions.

Port of ``dpc_tpu/ops/maxpool_pallas.py``.  On CUDA tensors
``maxpool_relu_fwd`` runs K1, ``maxpool_fwd`` K1's ReLU-off instance,
``maxpool_relu_bwd`` K2 and ``maxpool_bwd_eq`` K8 (``csrc/maxpool.cu``);
on CPU tensors each runs its ``*_plain`` version.  There is no fallback
between them: a CUDA tensor launches the kernel or raises.

The kernels work on a channels-last view ``[M, H, W, C]`` (M = N·T, H and W
even).  The public functions keep the JAX package's NDHWC layout:

* ``relu_maxpool_3x3s2(z)``: ``relu(maxpool(z))`` with a backward that
  routes each window's gradient to its first maximal input, as ATen does;
  it saves only K1's uint8 code, not z.
* ``maxpool_3x3s2_eq(z)``: the max-pool with ``F.max_pool3d`` forward (the
  JAX forward is XLA's ``reduce_window``, outside any kernel) and K8's
  equality-routed backward, which gives every tied maximum the window's
  gradient.
* ``relu_maxpool_3x3s2_eq(z)``: ``relu(maxpool(z))`` through K1 forward and
  K8 gated by z > 0 backward: the stem's ``eqroute`` pool.
* ``maxpool_3x3s2(z)``: ``maxpool(z)``, no ReLU, through K1's ReLU-off
  instance and K2, first-max routing: the fused stem's pool
  (``dpc_tpu``'s ``layers._maxpool_sas_raw``).

The code of an output element is the first maximal window slot ``k = 3·dh +
dw`` (0-8), or 9 when the window max is ≤ 0 and the ReLU kills the
gradient; the ReLU-off instance never writes 9.  A window that holds a
NaN gives NaN, as ``dpc_tpu``'s kernel does, with the code of its last max
before the first NaN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dpc_tpu_torch.ops import _build

DEAD = 9  # code of a window whose max is <= 0


def _pool_shape(shape) -> tuple[int, int, int, int]:
    if len(shape) != 4:
        raise ValueError(f"expected [M, H, W, C], got shape {tuple(shape)}")
    m, h, w, c = shape
    if h % 2 or w % 2:
        raise ValueError(f"the 3x3/s2 stem pool needs even H and W, got "
                         f"{h}x{w}")
    return m, h, w, c


def _check_cuda(*tensors: torch.Tensor, vector: bool) -> bool:
    """The kernels take contiguous bf16 or f32 tensors of one dtype on one
    CUDA device.  ``vector``: the kernel moves 16-byte channel vectors, so
    C must fill them and the data must be 16-byte aligned.  Returns whether
    the data is bf16."""
    x = tensors[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"pool kernels take bfloat16 or float32, got "
                        f"{x.dtype}")
    for t in tensors:
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}, expected "
                             f"{x.device} (cuda)")
        if t.dtype != x.dtype:
            raise TypeError(f"mixed dtypes {t.dtype} and {x.dtype}")
        if not t.is_contiguous():
            raise ValueError("pool kernel input must be contiguous "
                             "[M, H, W, C] (channels-last)")
        if vector and t.data_ptr() % 16:
            raise ValueError("pool kernel input must be 16-byte aligned")
    vec = 16 // x.element_size()
    if vector and x.shape[-1] % vec:
        raise ValueError(f"C={x.shape[-1]} is not a multiple of {vec} "
                         f"({x.dtype} channel vectors)")
    return x.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors; the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------

def _pad(x: torch.Tensor, fill: float) -> torch.Tensor:
    """One row and column of ``fill`` on each side of H and W."""
    return F.pad(x, (0, 0, 1, 1, 1, 1), value=fill)


def maxpool_fwd_plain(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(maxpool(z), code)`` of ``z [M, H, W, C]``, no ReLU; compares in
    f32, the first strict > in window order wins (code 0-8), −inf padding
    never does.  The running max propagates NaN, as ``dpc_tpu``'s kernel's
    does: a window that holds a NaN gives NaN and keeps the code of its
    last max before the first NaN."""
    m, h, w, c = _pool_shape(z.shape)
    ho, wo = h // 2, w // 2
    zp = _pad(z.float(), float("-inf"))
    best = torch.full((m, ho, wo, c), float("-inf"), device=z.device)
    code = torch.zeros((m, ho, wo, c), dtype=torch.uint8, device=z.device)
    for k in range(9):
        dh, dw = divmod(k, 3)
        win = zp[:, dh:dh + 2 * ho:2, dw:dw + 2 * wo:2]
        code.masked_fill_(win > best, k)
        best = torch.maximum(best, win)
    return best.to(z.dtype), code


def maxpool_relu_fwd_plain(z: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(relu(maxpool(z)), code)``: ``maxpool_fwd_plain`` with the ReLU's
    clamp, and the code 9 where the window max is ≤ 0 (NaN stays NaN)."""
    best, code = maxpool_fwd_plain(z)
    code.masked_fill_(best <= 0, DEAD)
    out = torch.where((best > 0) | best.isnan(), best,
                      torch.zeros_like(best))
    return out, code


def maxpool_relu_bwd_plain(dout: torch.Tensor, code: torch.Tensor
                           ) -> torch.Tensor:
    """dz ``[M, H, W, C]``: each window's gradient at its coded input, summed
    in f32 over windows in (row, column) order, rounded once."""
    m, ho, wo, c = dout.shape
    h, w = 2 * ho, 2 * wo
    g = dout.float()
    dzp = torch.zeros((m, h + 2, w + 2, c), device=dout.device)
    # descending k adds the windows covering an input in (row, column) order
    for k in reversed(range(9)):
        dh, dw = divmod(k, 3)
        dzp[:, dh:dh + 2 * ho:2, dw:dw + 2 * wo:2] += torch.where(
            code == k, g, torch.zeros_like(g))
    return dzp[:, 1:h + 1, 1:w + 1].to(dout.dtype).contiguous()


def _shift(x: torch.Tensor, dh: int, dw: int, fill: float) -> torch.Tensor:
    """``y[:, i, j] = x[:, i + dh, j + dw]``, ``fill`` past the border."""
    _, h, w, _ = x.shape
    return _pad(x, fill)[:, 1 + dh:1 + dh + h, 1 + dw:1 + dw + w]


def maxpool_bwd_eq_plain(src: torch.Tensor, g: torch.Tensor,
                         relu: bool = False) -> torch.Tensor:
    """Equality-routed dz ``[M, H, W, C]`` of the max-pool of ``src`` for the
    output gradient ``g [M, H/2, W/2, C]``:
    ``dz[p] = Σ_δ G[p+δ]·[src[p] = M3[p+δ]]`` with G = g at the even window
    centres and M3 the stride-1 3×3 max of src, in f32 (the TPU kernel's
    algorithm, ``maxpool_pallas.py:271-285``).  ``torch.maximum``
    propagates NaN, so a window that holds a NaN routes nothing.  ``relu``:
    dz of ``maxpool(relu(src))``: a window whose max is not positive routes
    nothing (its M3 becomes NaN), so dz is the same sum where src > 0 and 0
    elsewhere, and a NaN or inf in g still reaches its whole window, as in
    ``dpc_tpu``'s eqroute backward (``layers._rmp_bwd``)."""
    _pool_shape(src.shape)
    s = src.float()
    gfull = torch.zeros_like(s)
    gfull[:, ::2, ::2] = g.float()
    shifts = [(dh, dw) for dh in (-1, 0, 1) for dw in (-1, 0, 1)
              if (dh, dw) != (0, 0)]
    m3 = s
    for dh, dw in shifts:
        m3 = torch.maximum(m3, _shift(s, dh, dw, float("-inf")))
    if relu:
        m3 = torch.where(m3 > 0, m3, torch.full_like(m3, float("nan")))
    acc = gfull * (s == m3).float()
    for dh, dw in shifts:
        eq = (s == _shift(m3, dh, dw, float("-inf"))).float()
        acc = acc + _shift(gfull, dh, dw, 0.0) * eq
    return acc.to(g.dtype)


# ---------------------------------------------------------------------------
# Wrappers: kernel for CUDA tensors, plain version for CPU tensors
# ---------------------------------------------------------------------------

def maxpool_relu_fwd(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1.  z ``[M, H, W, C]`` bf16 or f32 → ``(out [M, H/2, W/2, C]`` in
    z's dtype, ``code`` uint8 of out's shape)."""
    if z.device.type == "cpu":
        return maxpool_relu_fwd_plain(z)
    m, h, w, c = _pool_shape(z.shape)
    bf16 = _check_cuda(z, vector=True)
    out = torch.empty((m, h // 2, w // 2, c), dtype=z.dtype, device=z.device)
    code = torch.empty(out.shape, dtype=torch.uint8, device=z.device)
    _build.launch("maxpool", "maxpool_relu_fwd", z, out, code, m, h, w, c,
                  int(bf16))
    return out, code


def maxpool_fwd(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's ReLU-off instance.  z ``[M, H, W, C]`` bf16 or f32 → ``(out
    [M, H/2, W/2, C]`` in z's dtype, ``code`` uint8 0-8 of out's shape)."""
    if z.device.type == "cpu":
        return maxpool_fwd_plain(z)
    m, h, w, c = _pool_shape(z.shape)
    bf16 = _check_cuda(z, vector=True)
    out = torch.empty((m, h // 2, w // 2, c), dtype=z.dtype, device=z.device)
    code = torch.empty(out.shape, dtype=torch.uint8, device=z.device)
    _build.launch("maxpool", "maxpool_fwd", z, out, code, m, h, w, c,
                  int(bf16))
    return out, code


def maxpool_relu_bwd(dout: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """K2.  dout ``[M, H/2, W/2, C]`` and K1's code → dz ``[M, H, W, C]``."""
    if dout.device.type == "cpu":
        return maxpool_relu_bwd_plain(dout, code)
    m, ho, wo, c = dout.shape
    bf16 = _check_cuda(dout, vector=True)
    if (code.dtype != torch.uint8 or code.shape != dout.shape
            or code.device != dout.device or not code.is_contiguous()):
        raise ValueError("code must be K1's contiguous uint8 code of "
                         "dout's shape, on dout's device")
    dz = torch.empty((m, 2 * ho, 2 * wo, c), dtype=dout.dtype,
                     device=dout.device)
    _build.launch("maxpool", "maxpool_relu_bwd", dout, code, dz, m, 2 * ho,
                  2 * wo, c, int(bf16))
    return dz


def maxpool_bwd_eq(src: torch.Tensor, g: torch.Tensor,
                   relu: bool = False) -> torch.Tensor:
    """K8.  src ``[M, H, W, C]`` and g ``[M, H/2, W/2, C]`` of one dtype →
    dz ``[M, H, W, C]``, gated by src > 0 with ``relu``.  Any C: the kernel
    moves 16-byte vectors by TMA when a pixel's channels fill them, and
    runs a scalar path otherwise."""
    if src.device.type == "cpu":
        return maxpool_bwd_eq_plain(src, g, relu)
    m, h, w, c = _pool_shape(src.shape)
    if g.shape != (m, h // 2, w // 2, c):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                         f"{(m, h // 2, w // 2, c)}")
    bf16 = _check_cuda(src, g, vector=False)
    dz = torch.empty_like(src)
    _build.launch("maxpool", "maxpool_bwd_eq", src, g, dz, m, h, w, c,
                  int(bf16), int(relu))
    return dz


class _CodedMaxPool(torch.autograd.Function):
    """K1 (``relu``) or its ReLU-off instance forward, K2 by its codes
    backward."""

    @staticmethod
    def forward(ctx, z4, relu: bool):
        out, code = (maxpool_relu_fwd if relu else maxpool_fwd)(z4)
        ctx.save_for_backward(code)
        return out

    @staticmethod
    def backward(ctx, g):
        (code,) = ctx.saved_tensors
        return maxpool_relu_bwd(g.contiguous(), code), None


class _MaxPoolEq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z4):
        ctx.save_for_backward(z4)
        out = F.max_pool2d(z4.permute(0, 3, 1, 2), 3, 2, 1)
        return out.permute(0, 2, 3, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        (z4,) = ctx.saved_tensors
        return maxpool_bwd_eq(z4, g.contiguous())


class _ReluMaxPoolEq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z4):
        out, _ = maxpool_relu_fwd(z4)
        ctx.save_for_backward(z4)
        return out

    @staticmethod
    def backward(ctx, g):
        (z4,) = ctx.saved_tensors
        return maxpool_bwd_eq(z4, g.contiguous(), relu=True)


def _as_m_h_w_c(z: torch.Tensor) -> torch.Tensor:
    if z.ndim != 5:
        raise ValueError(f"expected NDHWC [N, T, H, W, C], got shape "
                         f"{tuple(z.shape)}")
    n, t, h, w, c = z.shape
    _pool_shape((n * t, h, w, c))
    return z.reshape(n * t, h, w, c)


def relu_maxpool_3x3s2(z: torch.Tensor) -> torch.Tensor:
    """``relu(maxpool3d(z, (1,3,3), (1,2,2), (0,1,1)))`` over NDHWC
    ``[N, T, H, W, C]`` (even H, W) → ``[N, T, H/2, W/2, C]``, through K1
    and K2 on CUDA tensors.  The counterpart of
    ``maxpool_pallas.maxpool_relu_3x3s2``."""
    n, t, h, w, c = z.shape
    out = _CodedMaxPool.apply(_as_m_h_w_c(z), True)
    return out.reshape(n, t, h // 2, w // 2, c)


def maxpool_3x3s2(z: torch.Tensor) -> torch.Tensor:
    """``maxpool3d(z, (1,3,3), (1,2,2), (0,1,1))`` over NDHWC (even H, W),
    no ReLU, through K1's ReLU-off instance and K2 (first-max routing) on
    CUDA tensors; saves only the uint8 code.  The counterpart of
    ``dpc_tpu``'s ``layers._maxpool_sas_raw``, the fused stem's pool."""
    n, t, h, w, c = z.shape
    out = _CodedMaxPool.apply(_as_m_h_w_c(z), False)
    return out.reshape(n, t, h // 2, w // 2, c)


def maxpool_3x3s2_eq(z: torch.Tensor) -> torch.Tensor:
    """``maxpool3d(z, (1,3,3), (1,2,2), (0,1,1))`` over NDHWC (even H, W),
    with the equality-routed K8 backward.  The counterpart of
    ``maxpool_pallas.maxpool_3x3s2_eq``."""
    n, t, h, w, c = z.shape
    out = _MaxPoolEq.apply(_as_m_h_w_c(z))
    return out.reshape(n, t, h // 2, w // 2, c)


def relu_maxpool_3x3s2_eq(z: torch.Tensor) -> torch.Tensor:
    """``relu(maxpool3d(z, (1,3,3), (1,2,2), (0,1,1)))`` over NDHWC (even H,
    W) with the equality-routed backward: K1's forward (its code unused)
    and K8 gated by z > 0, which saves z.  Every tied maximum gets the
    window's gradient.  The counterpart of ``dpc_tpu``'s
    ``relu_maxpool_stem(impl="eqroute")`` (``layers._relu_maxpool_eq``)."""
    n, t, h, w, c = z.shape
    out = _ReluMaxPoolEq.apply(_as_m_h_w_c(z))
    return out.reshape(n, t, h // 2, w // 2, c)
