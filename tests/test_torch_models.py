"""The port's backbone and DPC forward against dpc_tpu's on the CPU, with
the same weights (through ``dpc_state_dict_from_jax``) and inputs.

f32 throughout.  The backbone tolerance is that of
tests/test_parity_backbone.py:45 (rtol 1e-3, atol 5e-4): two conv
libraries sum in different orders through 17 batch-stat BNs.  The inputs
are continuous normal draws, so the stem max-pool has no ties.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpc_tpu.core.config import DPCConfig as JaxDPCConfig
from dpc_tpu.models import dpc as jax_dpc
from dpc_tpu.models import resnet2d3d as jax_resnet
from dpc_tpu_torch.core.config import DPCConfig
from dpc_tpu_torch.models import dpc
from dpc_tpu_torch.utils.weights import dpc_state_dict_from_jax

CFG = dict(img_dim=64, num_seq=4, seq_len=5, pred_step=2, gru_dropout=0.0)


@pytest.fixture(scope="module")
def pair():
    jparams = jax_dpc.init_dpc(jax.random.PRNGKey(0), JaxDPCConfig(**CFG))
    model = dpc.DPC(DPCConfig(**CFG))
    model.load_state_dict(dpc_state_dict_from_jax(
        jax.tree.map(np.asarray, jparams)), strict=True)
    return jparams, model


def test_backbone_r18_matches_jax(pair):
    jparams, model = pair
    x = np.random.default_rng(42).normal(
        size=(2, 5, 64, 64, 3)).astype(np.float32)
    jy, _ = jax_resnet.apply_resnet2d3d(
        jparams["backbone"], None, jnp.asarray(x), network="resnet18",
        train=True, stem_impl="unfused")
    with torch.no_grad():
        ty = model.backbone(torch.tensor(x))
    assert ty.shape == (2, 2, 2, 2, 256)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                               rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("gru_impl", ["scan", "pallas"])
def test_apply_dpc_matches_jax(pair, gru_impl):
    jparams, model = pair
    x = np.random.default_rng(7).normal(
        size=(2, 4, 5, 64, 64, 3)).astype(np.float32)
    jcfg = dataclasses.replace(JaxDPCConfig(**CFG), gru_impl="scan")
    js, jpred, jgt = jax_dpc.apply_dpc(jparams, jnp.asarray(x), cfg=jcfg,
                                       train=False)
    with torch.no_grad():
        ts, tpred, tgt = dpc.apply_dpc(
            model, torch.tensor(x), cfg=DPCConfig(**CFG, gru_impl=gru_impl),
            train=False)
    assert ts.shape == (16, 16)
    for t, j in ((tgt, jgt), (tpred, jpred), (ts, js)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   rtol=1e-3, atol=5e-4)
