"""The port's ConvGRU against dpc_tpu's on the CPU.

* The plain recurrence (what ``convgru_cuda`` runs for CPU tensors, and
  what chip_smoke.py holds K-GRU-F/K-GRU-B against on the card) matches
  ``convgru_pallas._fused_core`` in Pallas interpret mode with the same
  injected dropout masks: outputs, dx, dh0 and every weight and bias grad.
* ``apply_convgru`` with ``impl="pallas"`` matches the JAX scan path with
  dropout off, including a row count that is not a multiple of 8.

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
