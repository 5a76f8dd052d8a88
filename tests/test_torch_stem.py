"""The port's fused stem against dpc_tpu's on the CPU.

* ``maxpool_fwd_plain`` (what ``maxpool_cuda.maxpool_fwd``, K1's ReLU-off
  instance, runs for CPU tensors, and what chip_smoke.py holds the kernel
  against on the card) against ``dpc_tpu``'s ``layers._maxpool_sas_raw``:
  values exactly, tie data included, the codes against ATen's first-max
  indices on tie data and against ``maxpool_pallas._run_fwd``'s codes on
  NaN data; ``maxpool_3x3s2``'s gradient (K2 through the codes) against
  ``_maxpool_sas_raw``'s on tie-free data.
* ``layers.fused_stem`` against ``dpc_tpu``'s ``fused_stem`` on the cases
  of ``tests/test_maxpool_pallas.py``'s ``TestFusedStem`` (channels with
  γ < 0, a γ = 0 channel with β = 0.7), with a conv bias and with
  ``input_norm`` at scales 1 and 255: values to 1e-5, the gradients of the
  conv weight, γ, β and x to 2e-4, the γ = 0 channel's dγ included (both
  pool x', so nothing ties); against the port's unfused stem with that
  dγ left out (both live); and in the LC modes: train (values and the
  running statistics to 1e-5 / 1e-6 of both) and eval (running
  statistics untouched).
* ``ResNet2d3d(stem_impl="fused")`` against ``dpc_tpu``'s
  ``apply_resnet2d3d(stem_impl="fused")``, batch 2, f32, with
  tests/test_torch_models.py's tolerance (rtol 1e-3, atol 5e-4: two conv
  libraries sum in different orders through 17 batch-stat BNs), and
  ``stem_impl="auto"``'s rule.

The bn_group case runs in tests/test_torch_parallel.py's two-rank job.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp

from dpc_tpu.core.config import DPCConfig as JaxDPCConfig
from dpc_tpu.models import dpc as jax_dpc
from dpc_tpu.models import layers as jax_layers
from dpc_tpu.models import resnet2d3d as jax_resnet
from dpc_tpu.ops import maxpool_pallas
from dpc_tpu_torch.core.config import DPCConfig
from dpc_tpu_torch.data import device_augment as da
from dpc_tpu_torch.models import dpc, layers as L, resnet2d3d
from dpc_tpu_torch.ops import maxpool_cuda as P
from dpc_tpu_torch.utils.weights import dpc_state_dict_from_jax
from torch_threads import one_thread  # noqa: F401

COUT = 8


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


# --- the ReLU-off pool ------------------------------------------------------

def _pool_data(shape, seed, ties=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.round(2 * x) / 2 if ties else x


def _sas_raw(z4: np.ndarray) -> np.ndarray:
    """dpc_tpu's ``_maxpool_sas_raw`` of ``[M, H, W, C]``."""
    return _np(jax_layers._maxpool_sas_raw(jnp.asarray(z4)[:, None]))[:, 0]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(6, 8, 8, 16), (5, 4, 12, 8)])
def test_plain_pool_matches_sas_raw(shape, ties):
    z = _pool_data(shape, sum(shape), ties)
    out, code = P.maxpool_fwd(torch.tensor(z))
    np.testing.assert_array_equal(out.numpy(), _sas_raw(z))
    assert int(code.max()) <= 8
    # ATen's first-max index, as the window slot 3·dh + dw
    x = torch.tensor(z).permute(0, 3, 1, 2)
    _, idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
    w = shape[2]
    ih, iw = idx // w, idx % w
    ho = torch.arange(shape[1] // 2).view(1, 1, -1, 1)
    wo = torch.arange(shape[2] // 2).view(1, 1, 1, -1)
    slot = 3 * (ih - 2 * ho + 1) + (iw - 2 * wo + 1)
    np.testing.assert_array_equal(code.numpy(),
                                  slot.permute(0, 2, 3, 1).numpy())
    if ties:   # a window tie that the first max decided
        assert (code.numpy() != _first_strict(z)).sum() == 0


def _first_strict(z: np.ndarray) -> np.ndarray:
    """The first slot holding the window max, by brute force."""
    m, h, w, c = z.shape
    zp = np.pad(z, ((0, 0), (1, 1), (1, 1), (0, 0)),
                constant_values=-np.inf)
    wins = np.stack([zp[:, dh:dh + h:2, dw:dw + w:2]
                     for dh in range(3) for dw in range(3)])
    return np.argmax(wins == wins.max(axis=0), axis=0)


def test_pool_gradient_matches_sas_raw_on_tie_free_data():
    z = _pool_data((2, 3, 8, 10, 8), seed=2)
    g = _pool_data((2, 3, 4, 5, 8), seed=4)
    a = torch.tensor(z, requires_grad=True)
    P.maxpool_3x3s2(a).backward(torch.tensor(g))
    _, vjp = jax.vjp(jax_layers._maxpool_sas_raw, jnp.asarray(z))
    (want,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(a.grad.numpy(), _np(want))


def test_pool_nan_windows_match_dpc_tpu():
    """A window that holds a NaN gives NaN, as ``_maxpool_sas_raw`` does,
    with the code of ``dpc_tpu``'s kernel (its last max before the first
    NaN); every other value is untouched."""
    z = _pool_data((4, 8, 12, 8), seed=21)
    flat = np.random.default_rng(22).integers(0, z.size, 12)
    z.reshape(-1)[flat] = np.nan
    out, code = P.maxpool_fwd(torch.tensor(z))
    want = _sas_raw(z)
    nan = out.isnan().numpy()
    assert 0 < nan.sum() < nan.size
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(out.nan_to_num().numpy(),
                                  np.nan_to_num(want))
    _, jcode = maxpool_pallas._run_fwd(jnp.asarray(z))
    jcode = np.asarray(jcode)
    live = jcode != P.DEAD             # the ReLU kernel's dead code aside
    assert live[nan].all()
    np.testing.assert_array_equal(code.numpy()[live], jcode[live])


# --- the stem ---------------------------------------------------------------

def _mk(seed, negate_some=True, bias=False, state=False):
    """TestFusedStem._mk's draws (and _mk of TestFusedStemRunningStats),
    as numpy."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(1, 7, 7, 3, COUT)).astype(np.float32) * 0.1
    gamma = rng.uniform(0.5, 1.5, COUT).astype(np.float32)
    beta = rng.normal(size=COUT).astype(np.float32)
    if negate_some:
        gamma[::3] *= -1.0
        gamma[1] = 0.0
        beta[1] = 0.7
    out = {"w": w, "gamma": gamma, "beta": beta}
    if state:
        out["mean"] = rng.normal(size=COUT).astype(np.float32) * 0.3
        out["var"] = rng.uniform(0.5, 2.0, COUT).astype(np.float32)
    out["x"] = rng.normal(size=(2, 3, 16, 16, 3)).astype(np.float32)
    if bias:
        out["b"] = np.random.default_rng(seed + 1).normal(
            size=COUT).astype(np.float32)
    return out


def _jax_params(d):
    conv = {"w": jnp.asarray(d["w"])}
    if "b" in d:
        conv["b"] = jnp.asarray(d["b"])
    bn = {"scale": jnp.asarray(d["gamma"]), "bias": jnp.asarray(d["beta"])}
    state = ({"mean": jnp.asarray(d["mean"]), "var": jnp.asarray(d["var"])}
             if "mean" in d else None)
    return conv, bn, state


def _port_modules(d, track=False, train=True):
    conv = nn.Conv3d(3, COUT, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                     bias="b" in d)
    bn = L.batchnorm3d(COUT, track_running_stats=track)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(d["w"]).permute(4, 3, 0, 1, 2))
        if "b" in d:
            conv.bias.copy_(torch.tensor(d["b"]))
        bn.weight.copy_(torch.tensor(d["gamma"]))
        bn.bias.copy_(torch.tensor(d["beta"]))
        if track:
            bn.running_mean.copy_(torch.tensor(d["mean"]))
            bn.running_var.copy_(torch.tensor(d["var"]))
    bn.train(train)
    return conv, bn


def _port_unfused(conv, bn, x, input_norm=None):
    h = conv(x) if input_norm is None else L.conv3d_input_norm(
        conv, x, input_norm)
    return L.relu_maxpool_stem(L.batchnorm(bn, h), "xla")


def _port_run(fn, conv, bn, x_np, ct, input_norm=None):
    """``fn``'s output (NDHWC) and the gradients of ``sum(y·ct)`` by the
    conv weight (JAX layout), γ, β and x (None for integer x)."""
    x = torch.tensor(x_np)
    if x.is_floating_point():
        x.requires_grad_(True)
    y = fn(conv, bn, x.permute(0, 4, 1, 2, 3), input_norm=input_norm)
    y = y.permute(0, 2, 3, 4, 1)
    (y * torch.tensor(ct)).sum().backward()
    grads = {"w": conv.weight.grad.permute(2, 3, 4, 1, 0).numpy(),
             "gamma": bn.weight.grad.numpy(), "beta": bn.bias.grad.numpy(),
             "x": None if x.grad is None else x.grad.numpy()}
    if conv.bias is not None:
        grads["b"] = conv.bias.grad.numpy()
    return y.detach().numpy(), grads


def _jax_run(d, ct, input_norm=None):
    conv, bn, _ = _jax_params(d)
    x = jnp.asarray(d["x"])

    def loss(conv, bn, x):
        y = jax_layers.fused_stem(conv, bn, x, input_norm=input_norm)[0]
        return jnp.sum(y * ct), y

    argnums = (0, 1, 2) if jnp.issubdtype(x.dtype, jnp.floating) else (0, 1)
    (_, y), g = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(
        conv, bn, x)
    grads = {"w": _np(g[0]["w"]), "gamma": _np(g[1]["scale"]),
             "beta": _np(g[1]["bias"]),
             "x": _np(g[2]) if len(g) == 3 else None}
    if "b" in d:
        grads["b"] = _np(g[0]["b"])
    return _np(y), grads


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _fused(conv, bn, x, input_norm=None):
    return L.fused_stem(conv, bn, x, input_norm=input_norm)


STEM_CASES = {"plain": (20, {}, None), "bias": (23, {"bias": True}, None),
              "norm01": (24, {}, da.INPUT_NORM_01),
              "norm_u8": (25, {}, da.INPUT_NORM_U8)}


def _case(name):
    seed, kw, input_norm = STEM_CASES[name]
    d = _mk(seed, **kw)
    if input_norm is da.INPUT_NORM_01:
        d["x"] = (d["x"] * 0.25 + 0.5).clip(0, 1).astype(np.float32)
    elif input_norm is da.INPUT_NORM_U8:
        d["x"] = np.random.default_rng(seed).integers(
            0, 256, d["x"].shape).astype(np.uint8)
    ct = np.random.default_rng(seed + 7).normal(
        size=(2, 3, 4, 4, COUT)).astype(np.float32)
    return d, ct, input_norm


@pytest.mark.parametrize("case", list(STEM_CASES))
def test_fused_stem_matches_dpc_tpu(case):
    d, ct, input_norm = _case(case)
    y, g = _port_run(_fused, *_port_modules(d), d["x"], ct, input_norm)
    jy, jg = _jax_run(d, ct, input_norm)
    _close(y, jy, 1e-5)
    for k, want in jg.items():
        if want is not None:
            _close(g[k], want, 2e-4)
    assert abs(float(g["gamma"][1])) > 1e-3     # γ = 0 keeps a live dγ


@pytest.mark.parametrize("case", ["plain", "bias", "norm01"])
def test_fused_stem_matches_unfused(case):
    d, ct, input_norm = _case(case)
    y, g = _port_run(_fused, *_port_modules(d), d["x"], ct, input_norm)
    uy, ug = _port_run(_port_unfused, *_port_modules(d), d["x"], ct,
                       input_norm)
    _close(y, uy, 1e-5)
    # γ = 0: the unfused pre-pool activation is constant, every window
    # ties, and the two forms pick different (valid) subgradients
    mask = np.arange(COUT) != 1
    _close(g["gamma"][mask], ug["gamma"][mask], 2e-4)
    for k in ("w", "beta", "x", "b"):
        if k in g:
            _close(g[k], ug[k], 2e-4)
    assert abs(float(g["gamma"][1])) > 1e-3
    assert abs(float(ug["gamma"][1])) > 1e-3


def test_fused_stem_lc_train_mode_values_and_ema():
    d = _mk(40, negate_some=False, state=True)
    d["gamma"][::3] *= -1.0
    conv, bn, state = _jax_params(d)
    jy, jstate = jax_layers.fused_stem(conv, bn, jnp.asarray(d["x"]),
                                       state=state, train=True)
    x = torch.tensor(d["x"]).permute(0, 4, 1, 2, 3)
    got = {}
    for name, fn in (("fused", L.fused_stem), ("unfused", _port_unfused)):
        tconv, tbn = _port_modules(d, track=True, train=True)
        with torch.no_grad():
            y = fn(tconv, tbn, x).permute(0, 2, 3, 4, 1).numpy()
        got[name] = (y, tbn)
    y, bn_f = got["fused"]
    uy, bn_u = got["unfused"]
    _close(y, _np(jy), 1e-5)
    _close(y, uy, 1e-5)
    for want in ({"mean": _np(jstate["mean"]), "var": _np(jstate["var"])},
                 {"mean": bn_u.running_mean.numpy(),
                  "var": bn_u.running_var.numpy()}):
        np.testing.assert_allclose(bn_f.running_mean.numpy(), want["mean"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn_f.running_var.numpy(), want["var"],
                                   rtol=1e-5, atol=1e-6)
    assert int(bn_f.num_batches_tracked) == int(bn_u.num_batches_tracked) == 1


def test_fused_stem_eval_mode_keeps_running_stats():
    d = _mk(41, negate_some=False, state=True)
    d["gamma"][::3] *= -1.0
    conv, bn, state = _jax_params(d)
    jy, jstate = jax_layers.fused_stem(conv, bn, jnp.asarray(d["x"]),
                                       state=state, train=False)
    assert jstate is state
    x = torch.tensor(d["x"]).permute(0, 4, 1, 2, 3)
    tconv, tbn = _port_modules(d, track=True, train=False)
    uconv, ubn = _port_modules(d, track=True, train=False)
    with torch.no_grad():
        y = L.fused_stem(tconv, tbn, x).permute(0, 2, 3, 4, 1).numpy()
        uy = _port_unfused(uconv, ubn, x).permute(0, 2, 3, 4, 1).numpy()
    _close(y, _np(jy), 1e-5)
    _close(y, uy, 1e-5)
    np.testing.assert_array_equal(tbn.running_mean.numpy(), d["mean"])
    np.testing.assert_array_equal(tbn.running_var.numpy(), d["var"])
    assert int(tbn.num_batches_tracked) == 0


# --- the backbone and the switch --------------------------------------------

def test_backbone_fused_stem_matches_dpc_tpu():
    cfg = dict(img_dim=64, num_seq=4, seq_len=5, pred_step=2,
               gru_dropout=0.0)
    jparams = jax_dpc.init_dpc(jax.random.PRNGKey(0), JaxDPCConfig(**cfg))
    model = dpc.DPC(DPCConfig(**cfg))
    model.load_state_dict(dpc_state_dict_from_jax(
        jax.tree.map(np.asarray, jparams)), strict=True)
    bb = model.backbone
    bb.stem_impl = "fused"
    x = np.random.default_rng(42).normal(
        size=(2, 5, 64, 64, 3)).astype(np.float32)
    jy, _ = jax_resnet.apply_resnet2d3d(
        jparams["backbone"], None, jnp.asarray(x), network="resnet18",
        train=True, stem_impl="fused")
    with torch.no_grad():
        ty = bb(torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                               rtol=1e-3, atol=5e-4)


def test_stem_impl_auto_rule():
    cpu = torch.zeros(1)
    card = types.SimpleNamespace(is_cuda=True)
    assert resnet2d3d.resolve_stem_impl("auto", cpu) == "unfused"
    assert resnet2d3d.resolve_stem_impl("auto", card) == "fused"
    for impl in ("fused", "unfused"):
        for x in (cpu, card):
            assert resnet2d3d.resolve_stem_impl(impl, x) == impl
    with pytest.raises(ValueError):
        resnet2d3d.ResNet2d3d(stem_impl="literal")
    with pytest.raises(ValueError):
        resnet2d3d.resolve_stem_impl("sas", cpu)
