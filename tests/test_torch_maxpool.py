"""The port's stem pool against dpc_tpu's on the CPU.

* The plain K1/K2 versions (what ``maxpool_cuda`` runs for CPU tensors, and
  what chip_smoke.py holds the CUDA kernels against on the card) match
  ``maxpool_pallas._run_fwd`` / ``_core_bwd`` in Pallas interpret mode:
  values bit for bit, codes exactly (including 9 for dead windows), and dz.
* The plain K8 matches ``maxpool_pallas.maxpool_bwd_eq``, tie cases
  included, where every tied max receives the window's gradient.
* ``relu_maxpool_3x3s2`` routes ties to the first max as torch's
  ``F.max_pool3d`` autograd does, and ``relu_maxpool_stem`` dispatches as
  ``dpc_tpu``'s does: its "eqroute" (K1 forward, K8 gated by x > 0) and
  "sas" (ATen's first-max autograd) stems match ``dpc_tpu``'s, NaN
  windows route nothing in K8 as in ``dpc_tpu``'s kernel, and a tiny DPC
  model with the eqroute stem matches the plain stem on tie-free data.

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

from dpc_tpu.models import layers as jax_layers
from dpc_tpu.ops import maxpool_pallas
from dpc_tpu_torch.core.config import DPCConfig
from dpc_tpu_torch.models import dpc, layers as L
from dpc_tpu_torch.ops import nce
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
    if peak == 0:
        np.testing.assert_array_equal(got, 0 * want)
    elif dtype == "float32":
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
    for impl in ("auto", "xla", "pallas", "sas", "eqroute"):
        a = x.clone().requires_grad_(True)
        y = L.relu_maxpool_stem(a, impl)
        np.testing.assert_array_equal(y.detach().numpy(), want.numpy())
        y.sum().backward()
        assert a.grad.shape == x.shape
    assert all(n == 0 for n in _build.LAUNCHES.values())  # CPU: plain
    with pytest.raises(ValueError, match="unknown stem pool impl"):
        L.relu_maxpool_stem(x, "fused")
    with pytest.raises(ValueError, match="even"):
        P.relu_maxpool_3x3s2(torch.zeros(1, 1, 5, 6, 8))
    with pytest.raises(ValueError, match="even"):
        P.relu_maxpool_3x3s2_eq(torch.zeros(1, 1, 6, 5, 8))


# ---------------------------------------------------------------------------
# The stem's "eqroute" and "sas" pools against dpc_tpu's
# ---------------------------------------------------------------------------

# NDHWC shapes and data of the eqroute cases: "negative" shifts the draws
# so that many windows hold no positive value (the ReLU gate); "boundary"
# is one 2x2 input, a single window that is three parts padding
STEM_CASES = {"tie_free": ((2, 3, 8, 10, 8), False, 0.0),
              "ties": ((2, 3, 8, 10, 8), True, 0.0),
              "negative": ((2, 3, 8, 10, 8), False, -1.5),
              "boundary": ((3, 2, 2, 2, 8), True, 0.0)}


def _stem_case(case: str, dtype: str):
    shape, ties, shift = STEM_CASES[case]
    x = np.random.default_rng(31).normal(size=shape).astype(np.float32)
    x = x + shift
    if ties:
        x = np.round(2 * x) / 2
    n, t, h, w, c = shape
    g = np.random.default_rng(32).normal(
        size=(n, t, h // 2, w // 2, c)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    xt, gt = torch.tensor(x).to(tdt), torch.tensor(g).to(tdt)
    return (xt, gt, jnp.asarray(xt.float().numpy()).astype(jdt),
            jnp.asarray(gt.float().numpy()).astype(jdt))


def _jax_stem(impl: str, xj, gj):
    """dpc_tpu's stem pool over NDHWC and its vjp for the output gradient."""
    out, vjp = jax.vjp(lambda v: jax_layers.relu_maxpool_stem(v, impl=impl),
                       xj)
    (dx,) = vjp(gj)
    return _np(out), _np(dx)


def _torch_stem(impl: str, xt, gt):
    """The port's stem pool over the same NDHWC data (it takes NCDHW)."""
    a = xt.permute(0, 4, 1, 2, 3).clone().requires_grad_(True)
    y = L.relu_maxpool_stem(a, impl)
    y.backward(gt.permute(0, 4, 1, 2, 3))
    return (y.detach().permute(0, 2, 3, 4, 1).float().numpy(),
            a.grad.permute(0, 2, 3, 4, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(STEM_CASES))
def test_stem_eqroute_matches_dpc_tpu(case, dtype):
    xt, gt, xj, gj = _stem_case(case, dtype)
    jout, jdx = _jax_stem("eqroute", xj, gj)
    out, dx = _torch_stem("eqroute", xt, gt)
    np.testing.assert_array_equal(out, jout)
    _assert_grad(dx, jdx, dtype)
    if case == "negative":
        assert (out == 0).any() and (out > 0).any()   # dead and live windows
    if case in ("ties", "boundary"):
        # a tied max gets the whole gradient: more inputs are routed to than
        # the first-max pool routes to
        _, first = _torch_stem("xla", xt, gt)
        assert int((dx != 0).sum()) > int((first != 0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
def test_gated_plain_eq_matches_rmp_bwd(dtype, ties):
    """The plain K8 with the ReLU gate is ``dpc_tpu``'s ``_rmp_bwd`` (the
    eqroute stem's custom VJP) through ``jax.grad``."""
    z, zj = _pair((3, 8, 12, 16), dtype, seed=41, ties=ties)
    g, gj = _pair((3, 4, 6, 16), dtype, seed=42)
    z5 = zj[:, None]                                    # [N, T=1, H, W, C]
    _, vjp = jax.vjp(jax_layers._relu_maxpool_eq, z5)
    (want,) = vjp(gj[:, None])
    _assert_grad(P.maxpool_bwd_eq_plain(z, g, relu=True), _np(want)[:, 0],
                 dtype)
    _assert_grad(P.maxpool_bwd_eq(z, g, relu=True), _np(want)[:, 0], dtype)


def test_gated_eq_nonfinite_gradient_matches_rmp_bwd():
    """A NaN or inf in g reaches every input of its window (g·0 is NaN),
    inputs at src <= 0 included, in the gated plain K8 as in ``dpc_tpu``'s
    ``_rmp_bwd``.  (The ungated Pallas kernel writes the same product, but
    XLA on the CPU rewrites g·[eq] into a select in its interpret mode, so
    there a NaN g reaches only the window's maxima.)"""
    z, zj = _pair((3, 8, 12, 16), "float32", seed=48)
    g, _ = _pair((3, 4, 6, 16), "float32", seed=49)
    flat = torch.tensor(np.random.default_rng(50).integers(0, g.numel(), 5))
    g.view(-1)[flat] = torch.tensor([float("nan")] * 3 + [float("inf")] * 2)
    gj = jnp.asarray(g.numpy())
    _, vjp = jax.vjp(jax_layers._relu_maxpool_eq, zj[:, None])
    want = _np(vjp(gj[:, None])[0])[:, 0]
    got = P.maxpool_bwd_eq(z, g, relu=True).numpy()
    assert np.isnan(want).sum() > int(np.isnan(got[z.numpy() > 0]).sum())
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                               atol=1e-6 * np.abs(want[ok]).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["single", "scattered"])
def test_plain_eq_nan_matches_pallas(case, dtype):
    """A window that holds a NaN routes nothing, as in ``dpc_tpu``'s kernel,
    whose window max propagates NaN; a NaN-ignoring max would send the
    window's gradient to its other maxima."""
    if case == "single":
        z, _ = _pair((1, 4, 4, 1), dtype, seed=43)
        z[0, 1, 1, 0] = float("nan")        # in all four windows
    else:
        z, _ = _pair((4, 8, 12, 8), dtype, seed=44)
        flat = np.random.default_rng(45).integers(0, z.numel(), 12)
        z.view(-1)[torch.tensor(flat)] = float("nan")
    zj = jnp.asarray(z.float().numpy()).astype(DTYPES[dtype][1])
    m, h, w, c = z.shape
    g, gj = _pair((m, h // 2, w // 2, c), dtype, seed=46)
    want = _np(maxpool_pallas.maxpool_bwd_eq(zj, gj))
    dz = P.maxpool_bwd_eq(z, g)
    assert not dz.float().isnan().any()
    _assert_grad(dz, want, dtype)
    # the NaN-ignoring routing differs: it gives the NaN windows' maxima
    # their gradient
    ignoring = P.maxpool_bwd_eq_plain(torch.nan_to_num(z, nan=-1e30), g)
    assert not torch.equal(ignoring, dz)
    if case == "single":
        assert (dz == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_sas_matches_dpc_tpu(dtype):
    """"sas" is ATen's relu-then-pool autograd, first-max routing: the
    routing of ``dpc_tpu``'s SelectAndScatter backward, on tie data."""
    if not jax_layers._SAS_AVAILABLE:
        pytest.skip("jax's private select_and_scatter_add binding is "
                    "unavailable: dpc_tpu's sas stem falls back")
    xt, gt, xj, gj = _stem_case("ties", dtype)
    jout, jdx = _jax_stem("sas", xj, gj)
    out, dx = _torch_stem("sas", xt, gt)
    np.testing.assert_array_equal(out, jout)
    _assert_grad(dx, jdx, dtype)


def test_dpc_with_eqroute_stem_matches_xla_stem():
    """A tiny DPC model with the eqroute stem against the same model with
    the plain stem, on tie-free f32 data (where the two routings agree):
    loss and every parameter's gradient to 1e-6."""
    cfg = DPCConfig(img_dim=64, num_seq=4, seq_len=5, pred_step=2,
                    gru_dropout=0.0)
    x = torch.tensor(np.random.default_rng(47).normal(
        size=(2, 4, 5, 64, 64, 3)).astype(np.float32))
    targets = torch.tensor(nce.nce_targets(2, cfg.pred_step,
                                           cfg.last_size ** 2))
    got = {}
    for impl in ("xla", "eqroute"):
        model = dpc.build_dpc(cfg, torch.device("cpu"), seed=0)
        model.backbone.stem_pool_impl = impl
        score, _, _ = dpc.apply_dpc(model, x, cfg=cfg)
        loss, _ = nce.nce_loss(score, targets)
        loss.backward()
        got[impl] = (loss.item(), {k: v.grad.clone()
                                   for k, v in model.named_parameters()})
    (l_x, g_x), (l_e, g_e) = got["xla"], got["eqroute"]
    assert abs(l_e - l_x) <= 1e-6 * abs(l_x)
    for k, want in g_x.items():
        peak = float(want.abs().max())
        assert float((g_e[k] - want).abs().max()) <= 1e-6 * max(peak, 1e-30), k
