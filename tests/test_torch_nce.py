"""The port's NCE against dpc_tpu's on the CPU.

* ``nce_cuda.nce_lse_rank`` (its plain version runs for CPU tensors; the
  card holds K-NCE-F/K-NCE-B against it) matches
  ``nce_pallas.nce_lse_rank`` in Pallas interpret mode: lse, pos, rank and
  both gradients, for a ragged R, an asymmetric C > R and targets off the
  diagonal.
* ``fused_nce_loss`` and the port's ``nce_loss`` match ``nce.nce_loss``.

Tolerances follow tests/test_nce_pallas.py: 1e-5 relative on values,
1e-4 relative on gradients (f32, different summation order); ranks are
integers and must be equal (the data has no near-ties).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpc_tpu.ops import nce as jax_nce
from dpc_tpu.ops import nce_pallas
from dpc_tpu_torch.ops import nce, nce_cuda


@pytest.mark.parametrize("r,c,d,shift", [
    (96, 96, 32, 0),     # square, diagonal targets
    (37, 37, 16, 5),     # ragged R, targets off the diagonal
    (24, 100, 16, 40),   # asymmetric pool C > R
])
def test_lse_rank_and_grads_match_pallas(r, c, d, shift):
    rng = np.random.default_rng(r + c)
    rows = rng.normal(size=(r, d)).astype(np.float32)
    cols = rng.normal(size=(c, d)).astype(np.float32)
    targets = ((np.arange(r) + shift) % c).astype(np.int32)
    g_lse = rng.normal(size=r).astype(np.float32)
    g_pos = rng.normal(size=r).astype(np.float32)

    def jfun(a, b):
        lse, pos, rank = nce_pallas.nce_lse_rank(a, b, jnp.asarray(targets),
                                                 16, 32, (1, 3, 5))
        return jnp.sum(lse * g_lse) + jnp.sum(pos * g_pos), (lse, pos, rank)

    (_, (jl, jp, jr)), (jdr, jdc) = jax.value_and_grad(
        jfun, argnums=(0, 1), has_aux=True)(jnp.asarray(rows),
                                            jnp.asarray(cols))

    tr = torch.tensor(rows, requires_grad=True)
    tc = torch.tensor(cols, requires_grad=True)
    lse, pos, rank = nce_cuda.nce_lse_rank(tr, tc, torch.tensor(targets))
    ((lse * torch.tensor(g_lse)).sum()
     + (pos * torch.tensor(g_pos)).sum()).backward()

    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl),
                               rtol=1e-5)
    np.testing.assert_allclose(pos.detach().numpy(), np.asarray(jp),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jdr),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jdc),
                               rtol=1e-4, atol=1e-5)


def test_fused_loss_and_plain_loss_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(2, 3, 4, 4, 32)).astype(np.float32)
    gt = rng.normal(size=(2, 3, 4, 4, 32)).astype(np.float32)
    targets = jax_nce.nce_targets(2, 3, 16)
    jloss, jm = jax_nce.nce_loss(
        jax_nce.dense_score(jnp.asarray(pred), jnp.asarray(gt)),
        jnp.asarray(targets))

    tpred, tgt = torch.tensor(pred), torch.tensor(gt)
    t = torch.tensor(nce.nce_targets(2, 3, 16))
    fl, fm = nce_cuda.fused_nce_loss(tpred, tgt, t)
    pl_, pm = nce.nce_loss(nce.dense_score(tpred, tgt), t)
    for loss, metrics in ((fl, fm), (pl_, pm)):
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for k in ("top1", "top3", "top5"):
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                       atol=1e-6)


def test_targets_and_mask_match_jax():
    np.testing.assert_array_equal(nce.nce_targets(3, 2, 4),
                                  jax_nce.nce_targets(3, 2, 4))
    np.testing.assert_array_equal(nce.nce_mask(3, 2, 4),
                                  jax_nce.nce_mask(3, 2, 4))


def test_pick_nce_impl_reads_device_memory():
    cpu = torch.device("cpu")
    assert nce.pick_nce_impl(8, 8, cpu) == "xla"
    huge = int(np.sqrt(nce.device_memory_bytes(cpu))) + 1
    assert nce.pick_nce_impl(huge, huge, cpu) == "fused"
