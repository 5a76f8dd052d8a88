"""The port's weight bridge: dpc_tpu DPC trees load strictly into
dpc_tpu_torch's DPC under the reference's names, with values intact."""

import numpy as np
import pytest
import torch

import jax

from dpc_tpu.core.config import DPCConfig as JaxDPCConfig
from dpc_tpu.models import dpc as jax_dpc
from dpc_tpu.utils import torch_compat
from dpc_tpu_torch.core.config import DPCConfig
from dpc_tpu_torch.models import dpc
from dpc_tpu_torch.utils.weights import dpc_state_dict_from_jax


def _jax_tree(network):
    """dpc_tpu's DPC tree for ``network``: its structure and shapes from
    ``init_dpc`` (traced, not run), filled with distinct random values."""
    shapes = jax.eval_shape(lambda: jax_dpc.init_dpc(
        jax.random.PRNGKey(0), JaxDPCConfig(network=network)))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("network", ["resnet18", "resnet34", "resnet50"])
def test_strict_load_and_values(network):
    tree = _jax_tree(network)
    sd = dpc_state_dict_from_jax(tree)
    model = dpc.DPC(DPCConfig(network=network))
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # round trip: what the model now holds is the JAX package's own export
    # (its torch_compat key map and layout transforms), bit for bit
    want = torch_compat.export_torch_state_dict(
        tree, torch_compat.dpc_key_map(tree))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
