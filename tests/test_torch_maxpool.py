"""The port's stem pool against dpc_tpu's on the CPU.

* The plain K1/K2 versions (what ``maxpool_cuda`` runs for CPU tensors, and
  what chip_smoke.py holds the CUDA kernels against on the card) match
  ``maxpool_pallas._run_fwd`` / ``_core_bwd`` in Pallas interpret mode:
  values bit for bit, codes exactly (including 9 for dead windows), and dz.
* The plain K8 matches ``maxpool_pallas.maxpool_bwd_eq``, tie cases
  included, where every tied max receives the window's gradient.
* ``relu_maxpool_3x3s2`` routes ties to the first max as torch's
  ``F.max_pool3d`` autograd does, and ``relu_maxpool_stem`` dispatches as
  ``dpc_tpu``'s does.

Tolerances: forward values and codes exact (a max of the inputs); dz in
f32 to 1e-6 relative (at most four terms summed, the same order as the
TPU kernel); in bf16 within one bf16 ulp of max |dz| (the port sums in f32
and rounds once, the TPU kernel sums in bf16).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dpc_tpu.ops import maxpool_pallas
from dpc_tpu_torch.models import layers as L
from dpc_tpu_torch.ops import _build, maxpool_cuda as P
from torch_threads import one_thread  # noqa: F401

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(shape, dtype, seed, ties=False):
    """The same values as a torch tensor and a jax array."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if ties:
        x = np.round(2 * x) / 2
    tdt, jdt = DTYPES[dtype]
    t = torch.tensor(x).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_grad(got: torch.Tensor, want: np.ndarray, dtype: str) -> None:
    got = got.float().numpy()
    peak = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)
    else:
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        assert np.abs(got - want).max() <= ulp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 8, 8, 16), (5, 4, 12, 8)])
def test_plain_fwd_bwd_match_pallas(shape, dtype):
    # (5, 4, 12, 8): non-square, and M = 5 is not a multiple of any tile
    z, zj = _pair(shape, dtype, seed=sum(shape))
    out, code = P.maxpool_relu_fwd(z)
    jout, jcode = maxpool_pallas._run_fwd(zj)
    np.testing.assert_array_equal(out.float().numpy(), _np(jout))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    assert (code.numpy() == P.DEAD).any()         # some windows are dead
    g, gj = _pair(out.shape, dtype, seed=1)
    dz = P.maxpool_relu_bwd(g, code)
    (jdz,) = maxpool_pallas._core_bwd(jcode, gj)
    assert dz.shape == z.shape and dz.dtype == z.dtype
    _assert_grad(dz, _np(jdz), dtype)


def test_relu_gate_kills_dead_windows():
    z = -torch.tensor(np.abs(np.random.default_rng(3).normal(
        size=(1, 1, 4, 4, 8))).astype(np.float32)) - 0.1
    z.requires_grad_(True)
    out = P.relu_maxpool_3x3s2(z)
    assert (out == 0).all()
    out.sum().backward()
    assert (z.grad == 0).all()
    _, code = P.maxpool_relu_fwd(z.detach()[0])
    assert (code == P.DEAD).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_windows_match_pallas(dtype):
    """A window that holds a NaN gives NaN, as dpc_tpu's kernel (whose max
    propagates NaN) and ATen's relu-then-pool do, with dpc_tpu's code; the
    rest is untouched.  A pool that turned NaN into 0 would hide a NaN
    from the loss and from --debug_nans."""
    z, zj = _pair((4, 8, 12, 8), dtype, seed=21)
    flat = np.random.default_rng(22).integers(0, z.numel(), 12)
    z.view(-1)[torch.tensor(flat)] = float("nan")
    zj = jnp.asarray(z.float().numpy()).astype(DTYPES[dtype][1])
    out, code = P.maxpool_relu_fwd(z)
    jout, jcode = maxpool_pallas._run_fwd(zj)
    jout = _np(jout)
    aten = F.max_pool3d(F.relu(z.float().permute(0, 3, 1, 2).unsqueeze(2)),
                        (1, 3, 3), (1, 2, 2), (0, 1, 1))
    aten = aten.squeeze(2).permute(0, 2, 3, 1)
    nan = out.float().isnan()
    assert 0 < int(nan.sum()) < nan.numel()
    np.testing.assert_array_equal(nan.numpy(), np.isnan(jout))
    np.testing.assert_array_equal(nan.numpy(), aten.isnan().numpy())
    np.testing.assert_array_equal(out.float().nan_to_num().numpy(),
                                  np.nan_to_num(jout))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))


def test_gradient_on_tie_free_data_matches_torch_autograd():
    z, _ = _pair((2, 3, 8, 10, 8), "float32", seed=2)
    g = torch.tensor(np.random.default_rng(4).normal(
        size=(2, 3, 4, 5, 8)).astype(np.float32))
    a = z.clone().requires_grad_(True)
    P.relu_maxpool_3x3s2(a).backward(g)
    b = z.permute(0, 4, 1, 2, 3).clone().requires_grad_(True)
    F.max_pool3d(F.relu(b), (1, 3, 3), (1, 2, 2), (0, 1, 1)).backward(
        g.permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(a.grad.numpy(),
                               b.grad.permute(0, 2, 3, 4, 1).numpy(),
                               rtol=0, atol=1e-7)


def test_ties_route_to_the_first_max_like_torch():
    z, _ = _pair((2, 2, 8, 8, 8), "float32", seed=5, ties=True)
    g = torch.tensor(np.random.default_rng(6).normal(
        size=(2, 2, 4, 4, 8)).astype(np.float32))
    a = z.clone().requires_grad_(True)
    P.relu_maxpool_3x3s2(a).backward(g)
    b = z.permute(0, 4, 1, 2, 3).clone().requires_grad_(True)
    F.max_pool3d(F.relu(b), (1, 3, 3), (1, 2, 2), (0, 1, 1)).backward(
        g.permute(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(a.grad.numpy(),
                                  b.grad.permute(0, 2, 3, 4, 1).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
def test_plain_eq_backward_matches_pallas(dtype, ties):
    src, srcj = _pair((3, 8, 12, 16), dtype, seed=7, ties=ties)
    g, gj = _pair((3, 4, 6, 16), dtype, seed=8)
    dz = P.maxpool_bwd_eq(src, g)
    want = _np(maxpool_pallas.maxpool_bwd_eq(srcj, gj))
    _assert_grad(dz, want, dtype)


def test_eq_routes_to_every_tied_max():
    # two maximal positions in one window: each gets the window's gradient
    # (maxpool_pallas's own tie case); (0,1) also tops window (0,1)
    z = torch.zeros(1, 1, 4, 4, 1)
    z[0, 0, 0, 0, 0] = z[0, 0, 0, 1, 0] = 5.0
    z.requires_grad_(True)
    P.maxpool_3x3s2_eq(z).sum().backward()
    assert float(z.grad[0, 0, 0, 0, 0]) == 1.0
    assert float(z.grad[0, 0, 0, 1, 0]) == 2.0
    zj = jnp.asarray(z.detach().numpy())
    np.testing.assert_array_equal(
        _np(maxpool_pallas.maxpool_3x3s2_eq(zj)),
        P.maxpool_3x3s2_eq(z.detach()).numpy())
    jgrad = jax.grad(lambda v: jnp.sum(maxpool_pallas.maxpool_3x3s2_eq(v)))
    np.testing.assert_array_equal(_np(jgrad(zj)), z.grad.numpy())


def test_stem_dispatch():
    x = torch.tensor(np.random.default_rng(9).normal(
        size=(2, 8, 3, 6, 6)).astype(np.float32))            # NCDHW
    want = F.max_pool3d(F.relu(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    _build.reset_launches()
    for impl in ("auto", "xla", "pallas"):
        np.testing.assert_array_equal(L.relu_maxpool_stem(x, impl).numpy(),
                                      want.numpy())
    assert _build.LAUNCHES["maxpool_relu_fwd"] == 0   # CPU: plain versions
    for impl in ("sas", "eqroute"):
        with pytest.raises(NotImplementedError, match="not ported"):
            L.relu_maxpool_stem(x, impl)
    with pytest.raises(ValueError, match="even"):
        P.relu_maxpool_3x3s2(torch.zeros(1, 1, 5, 6, 8))
