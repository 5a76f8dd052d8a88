"""The port's ConvGRU against dpc_tpu's on the CPU.

* The plain recurrence (what ``convgru_cuda`` runs for CPU tensors, and
  what chip_smoke.py holds K-GRU-F/K-GRU-B against on the card) matches
  ``convgru_pallas._fused_core`` in Pallas interpret mode with the same
  injected dropout masks: outputs, dx, dh0 and every weight and bias grad.
* ``apply_convgru`` with ``impl="pallas"`` matches the JAX scan path with
  dropout off, including a row count that is not a multiple of 8.
* The algorithm of the H100 kernels (``csrc/convgru.cu``), in plain torch:
  the forward with its input products hoisted and every product run as
  3xTF32 with a fresh accumulator per 32-wide K chunk holds the value
  tolerance over 8 steps where one TF32 pass does not; the backward's
  parallel gate recompute, reverse scan, hoisted dX and split-K weight
  gradients reduced in split order hold the gradient tolerance, at a row
  count that is not a multiple of the kernels' 64-row tiles and a channel
  count that is not a multiple of their 32-wide chunks.

Tolerances are those of tests/test_convgru_pallas.py: 1e-5 relative on
values, 1e-4 on gradients (f32, different summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpc_tpu.models import convgru as jax_convgru
from dpc_tpu.ops import convgru_pallas
from dpc_tpu_torch.models import convgru
from dpc_tpu_torch.ops import convgru_cuda
from dpc_tpu_torch.utils.weights import _CONVERT
from torch_threads import one_thread  # noqa: F401


def _packed(rng, cin, ch):
    w = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)
    return (w(cin, 2 * ch), w(ch, 2 * ch), w(2 * ch), w(cin, ch), w(ch, ch),
            w(ch))


@pytest.mark.parametrize("t,r,cin,ch", [(5, 24, 16, 16), (3, 16, 8, 12)])
def test_plain_recurrence_matches_pallas_core(t, r, cin, ch):
    # the Pallas core takes row counts that are multiples of 8; ragged rows
    # are covered through apply_convgru below
    rng = np.random.default_rng(0)
    x = rng.normal(size=(t, r, cin)).astype(np.float32)
    h0 = rng.normal(size=(r, ch)).astype(np.float32) * 0.5
    weights = _packed(rng, cin, ch)
    masks = (rng.random((t, r, ch)) > 0.1).astype(np.float32) / 0.9
    g = rng.normal(size=(t, r, ch)).astype(np.float32)

    jargs = [jnp.asarray(a) for a in (x, h0, *weights)]
    jm = jnp.asarray(masks)

    def jloss(*args):
        return jnp.sum(convgru_pallas._fused_core(*args, jm) * g)

    jout = convgru_pallas._fused_core(*jargs, jm)
    jgrads = jax.grad(jloss, argnums=tuple(range(8)))(*jargs)

    targs = [torch.tensor(a, requires_grad=True) for a in (x, h0, *weights)]
    tout = convgru_cuda.fused_core(*targs, torch.from_numpy(masks))
    (tout * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    for name, ta, ja in zip(["dx", "dh0", "dwzr_x", "dwzr_h", "db_zr",
                             "dwo_x", "dwo_h", "db_o"], targs, jgrads):
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def _load_cells(agg, jparams):
    with torch.no_grad():
        for cell, jc in zip(agg.cell_list, jparams["cells"]):
            for gate in ("reset", "update", "out"):
                conv = getattr(cell, f"{gate}_gate")
                conv.weight.copy_(torch.tensor(
                    _CONVERT["conv2d"](np.asarray(jc[gate]["w"]))))
                conv.bias.copy_(torch.tensor(np.asarray(jc[gate]["b"])))


@pytest.mark.parametrize("layers,shape", [(1, (1, 4, 3, 3, 8)),
                                          (2, (2, 3, 2, 2, 8))])
def test_apply_convgru_kernel_path_matches_jax_scan(layers, shape):
    """Rows 1·3·3 = 9 (not a multiple of 8) and a two-layer stack."""
    jparams = jax_convgru.init_convgru(jax.random.PRNGKey(0), 8, 8, 1, layers)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)

    def jloss(p, xx):
        out, last = jax_convgru.apply_convgru(p, xx, train=False, impl="scan")
        return jnp.sum(out ** 2) + jnp.sum(jnp.sin(last)), (out, last)

    (_, (jout, jlast)), (jg, jdx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(x))

    agg = convgru.ConvGRU(8, 8, 1, layers)
    _load_cells(agg, jparams)
    tx = torch.tensor(x, requires_grad=True)
    out, last = convgru.apply_convgru(agg, tx, train=False, impl="pallas")
    ((out ** 2).sum() + torch.sin(last).sum()).backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(jlast),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=1e-4, atol=1e-5)
    for cell, jc in zip(agg.cell_list, jg["cells"]):
        for gate in ("reset", "update", "out"):
            conv = getattr(cell, f"{gate}_gate")
            np.testing.assert_allclose(
                conv.weight.grad.numpy(),
                _CONVERT["conv2d"](np.asarray(jc[gate]["w"])),
                rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(conv.bias.grad.numpy(),
                                       np.asarray(jc[gate]["b"]),
                                       rtol=1e-4, atol=1e-5)


def test_scan_and_kernel_paths_agree_with_injected_dropout():
    """The per-step loop and the recurrence path apply the same masks the
    same way (dropped h feeds the next step and is the output)."""
    agg = convgru.ConvGRU(8, 8, 1, 1)
    x = torch.randn(2, 4, 2, 3, 8, generator=torch.Generator().manual_seed(0))
    keep = torch.rand(4, 12, 8, generator=torch.Generator().manual_seed(1))
    masks = [(keep > 0.1).float() / 0.9]
    a, la = convgru.apply_convgru(agg, x, impl="scan", masks=masks)
    b, lb = convgru.apply_convgru(agg, x, impl="pallas", masks=masks)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-6)


# --- the H100 kernels' arithmetic (csrc/convgru.cu), emulated in plain torch

BK = 32  # K chunk of a product: one fresh tensor-core accumulator each


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round f32 to 10 mantissa bits, to nearest,
    ties away from zero (the low 13 bits of the result are zero)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split_hi_lo(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b, chunks=None, init=None):
    """a [M, K] · b [N, K]ᵀ as the kernels compute it: each 32-wide K chunk
    is hi·hi + hi·lo + lo·hi from a fresh accumulator, and the chunks are
    added in f32 in order, onto ``init`` when given.  ``chunks`` restricts
    the sum to a range of chunks (one split of K)."""
    ah, al = split_hi_lo(a)
    bh, bl = split_hi_lo(b)
    nk = -(-a.shape[1] // BK)
    out = init
    for k in range(*(chunks or (0, nk))):
        s = slice(k * BK, (k + 1) * BK)
        c = (ah[:, s] @ bh[:, s].t() + ah[:, s] @ bl[:, s].t()
             + al[:, s] @ bh[:, s].t())
        out = c if out is None else out + c
    return out


def mm_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b).t()


def mm_split_k(a, b, splits):
    """a·bᵀ with K split as the weight-gradient blocks split it: split s
    takes chunks [s·nk/S, (s+1)·nk/S) into its own partial, and the
    partials are added in split order (``reduce_splits``)."""
    nk = -(-a.shape[1] // BK)
    total = None
    for s in range(splits):
        part = mm_3xtf32(a, b, (s * nk // splits, (s + 1) * nk // splits))
        total = part if total is None else total + part
    return total


def fwd_emulated(x, h0, weights, masks, mm=mm_3xtf32):
    """K-GRU-F's algorithm: Gx for all steps in one product, then per step
    (a) h·Wzr_h and (b) (h⊙r)·Wo_h, h kept in f32 and split afresh."""
    wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o = weights
    t, r, cin = x.shape
    ch = h0.shape[1]
    gx = mm(x.reshape(t * r, cin), torch.cat([wzr_x, wo_x], 1).t())
    gx = gx.reshape(t, r, 3 * ch)
    h, outs = h0, []
    for s in range(t):
        zr = torch.sigmoid(mm(h, wzr_h.t()) + gx[s, :, :2 * ch] + b_zr)
        z, rr = zr[:, :ch], zr[:, ch:]
        o = torch.tanh(mm(h * rr, wo_h.t()) + gx[s, :, 2 * ch:] + b_o)
        h = (h * (1 - z) + o * z) * masks[s]
        outs.append(h)
    return torch.stack(outs)


def bwd_emulated(x, h0, out, weights, masks, g, splits):
    """K-GRU-B's algorithm: the gates recomputed for all rows at once, the
    reverse scan with (c) dhr = dao·Wo_hᵀ and (d) dh += dazr·Wzr_hᵀ, then
    dX as two products into one sum and the weight gradients with K = T·R
    split, the biases from a row of ones appended to xᵀ."""
    wzr_x, wzr_h, b_zr, wo_x, wo_h, b_o = weights
    t, r, cin = x.shape
    ch = h0.shape[1]
    xf = x.reshape(t * r, cin)
    hin = torch.cat([h0[None], out[:-1]]).reshape(t * r, ch)
    gx = mm_3xtf32(xf, torch.cat([wzr_x, wo_x], 1).t())
    zr = torch.sigmoid(gx[:, :2 * ch] + mm_3xtf32(hin, wzr_h.t()) + b_zr)
    z, rr = zr[:, :ch], zr[:, ch:]
    hr = hin * rr
    o = torch.tanh(gx[:, 2 * ch:] + mm_3xtf32(hr, wo_h.t()) + b_o)
    z, rr, o, h3 = (v.reshape(t, r, ch) for v in (z, rr, o, hin))
    dh = torch.zeros(r, ch)
    dazr, dao = torch.empty(t, r, 2 * ch), torch.empty(t, r, ch)
    for s in reversed(range(t)):
        draw = (dh + g[s]) * masks[s]
        dz = draw * (o[s] - h3[s])
        dh = draw * (1 - z[s])
        dao[s] = draw * z[s] * (1 - o[s] * o[s])
        dhr = mm_3xtf32(dao[s], wo_h)                  # (c)
        dh = dh + dhr * rr[s]
        dazr[s] = torch.cat([dz * z[s] * (1 - z[s]),
                             dhr * h3[s] * rr[s] * (1 - rr[s])], 1)
        dh = dh + mm_3xtf32(dazr[s], wzr_h)            # (d)
    dazr, dao = dazr.reshape(t * r, 2 * ch), dao.reshape(t * r, ch)
    dx = mm_3xtf32(dao, wo_x, init=mm_3xtf32(dazr, wzr_x)).reshape(t, r, cin)
    x1t = torch.cat([xf, torch.ones(t * r, 1)], 1).t()
    dwzr_xb = mm_split_k(x1t, dazr.t(), splits)
    dwo_xb = mm_split_k(x1t, dao.t(), splits)
    return (dx, dh, dwzr_xb[:cin], mm_split_k(hin.t(), dazr.t(), splits),
            dwzr_xb[cin], dwo_xb[:cin], mm_split_k(hr.t(), dao.t(), splits),
            dwo_xb[cin])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _gru_data(t, r, cin, ch, seed):
    """x ReLU'd, h0 and gout normal, weights 0.2·normal, dropout masks at
    p = 0.1, as chip_smoke.py's check_gru draws them."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(t, r, cin)), 0).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(r, ch))).astype(np.float32)
    weights = _packed(rng, cin, ch)
    masks = ((rng.random((t, r, ch)) > 0.1) / 0.9).astype(np.float32)
    g = rng.normal(size=(t, r, ch)).astype(np.float32)
    return x, h0, weights, masks, g


# R = 80 is not a multiple of the kernels' 64-row tiles (but of the Pallas
# core's 8), Ch = 40 not a multiple of their 32-wide K chunks and columns
RAGGED = (8, 80, 48, 40)


@pytest.mark.parametrize("t,r,cin,ch", [RAGGED, (5, 64, 32, 32)])
def test_tensor_core_forward_holds_value_tolerance(t, r, cin, ch):
    """The hoisted-Gx forward with per-step 3xTF32 products holds 1e-5
    against convgru_forward_plain and the Pallas core over 8 steps, where
    h feeds every step; the same algorithm with one TF32 pass does not."""
    x, h0, weights, masks, _ = _gru_data(t, r, cin, ch, seed=t + r)
    tw = [torch.from_numpy(w) for w in weights]
    tx, th0, tm = (torch.from_numpy(a) for a in (x, h0, masks))
    emu = fwd_emulated(tx, th0, tw, tm)
    plain = convgru_cuda.convgru_forward_plain(tx, th0, tw, tm)
    pallas = convgru_pallas._fused_core(
        *(jnp.asarray(a) for a in (x, h0, *weights, masks)))
    assert _rel(emu, plain) <= 1e-5
    assert _rel(emu, pallas) <= 1e-5
    assert _rel(fwd_emulated(tx, th0, tw, tm, mm_1xtf32), plain) > 1e-5


@pytest.mark.parametrize("splits", [1, 3])
def test_tensor_core_backward_holds_gradient_tolerance(splits):
    """The backward's algorithm (parallel gate recompute, the reverse scan
    with products (c) and (d), dX hoisted, weight gradients with K = T·R
    split and reduced in split order) matches convgru_backward_plain and
    the Pallas core's VJP at 1e-4."""
    x, h0, weights, masks, g = _gru_data(*RAGGED, seed=11)
    tw = [torch.from_numpy(w) for w in weights]
    tx, th0, tm, tg = (torch.from_numpy(a) for a in (x, h0, masks, g))
    out = convgru_cuda.convgru_forward_plain(tx, th0, tw, tm)
    emu = bwd_emulated(tx, th0, out, tw, tm, tg, splits)
    plain = convgru_cuda.convgru_backward_plain(tx, th0, out, tw, tm, tg)

    jm = jnp.asarray(masks)
    jgrads = jax.grad(
        lambda *a: jnp.sum(convgru_pallas._fused_core(*a, jm) * g),
        argnums=tuple(range(8)))(*(jnp.asarray(a) for a in (x, h0, *weights)))
    names = ("dx", "dh0", "dwzr_x", "dwzr_h", "db_zr", "dwo_x", "dwo_h",
             "db_o")
    for name, e, p, j in zip(names, emu, plain, jgrads):
        assert _rel(e, p) <= 1e-4, name
        assert _rel(e, j) <= 1e-4, name


def test_weight_gradient_splits_cover_every_chunk_once():
    """The split ranges of the K = T·R products partition the chunks, and
    the row of ones appended to xᵀ gives the bias gradient exactly."""
    for nk in (1, 5, 128, 160):
        for splits in range(1, min(nk, 16) + 1):
            bounds = [(s * nk // splits, (s + 1) * nk // splits)
                      for s in range(splits)]
            assert bounds[0][0] == 0 and bounds[-1][1] == nk
            assert all(b0 < b1 for b0, b1 in bounds)
            assert all(bounds[i][1] == bounds[i + 1][0]
                       for i in range(splits - 1))
    hi, lo = split_hi_lo(torch.ones(3, 7))
    assert torch.equal(hi, torch.ones(3, 7)) and not lo.any()
