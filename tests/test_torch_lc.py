"""The port's LC path against dpc_tpu's on the CPU: the classifier forward in
train and eval mode with non-trivial running statistics, the trunk context
in both orders, one finetune step against ``make_finetune_step`` on a
one-device mesh, the linear probe, the eval step, the dense-test forward
and the LR schedule.  Same weights (through ``lc_state_dict_from_jax``),
same inputs, f32, dropout off.

Tolerances: values at those of tests/test_parity_lc.py (rtol 1e-3, atol
1e-4; two conv libraries sum in different orders through 17 BNs);
gradients within 1e-3 of each tensor's largest; the first Adam step moves
a parameter by about lr·sign(g), so the post-step parameters compare the
sign of every gradient: at least 99.9% of them within 1% of their group's
lr and all within the 2·lr a sign flip of a near-zero gradient costs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpc_tpu.core.config import DPCConfig as JaxDPCConfig
from dpc_tpu.core.config import EvalConfig as JaxEvalConfig
from dpc_tpu.models import dpc as jax_dpc
from dpc_tpu.models import lc as jax_lc
from dpc_tpu.parallel import mesh as meshlib
from dpc_tpu.train import finetune_step as jax_ft
from dpc_tpu.train import optim as jax_optim
from dpc_tpu_torch.core.config import DPCConfig, EvalConfig
from dpc_tpu_torch.models import dpc, lc
from dpc_tpu_torch.train import finetune_step, optim
from dpc_tpu_torch.utils.weights import (dpc_state_dict_from_jax,
                                         lc_state_dict_from_jax)
from torch_threads import one_thread  # noqa: F401

SHAPE = dict(img_dim=32, num_seq=3, seq_len=4, gru_dropout=0.0)
B, CLASSES, LR, WD = 4, 7, 1e-3, 1e-3
TOL = dict(rtol=1e-3, atol=1e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_lc_tree():
    """dpc_tpu LC params and running stats, BN affine and stats made
    non-trivial (a fresh BN is near identity and would hide a wrong one)."""
    params, state = jax_lc.init_lc(jax.random.PRNGKey(0),
                                   JaxDPCConfig(**SHAPE), CLASSES)
    rng = np.random.default_rng(0)

    def vary(path, leaf):
        name = str(path[-1].key)
        n = leaf.shape
        if name == "mean":
            return jnp.asarray(rng.normal(0, 0.3, n).astype(np.float32))
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, n).astype(np.float32))
        if name == "scale":
            return jnp.asarray(rng.uniform(0.8, 1.2, n).astype(np.float32))
        if name == "bias" and leaf.ndim == 1 and "final_fc" not in str(path):
            return jnp.asarray(rng.normal(0, 0.1, n).astype(np.float32))
        return leaf

    params = jax.tree_util.tree_map_with_path(vary, params)
    state = jax.tree_util.tree_map_with_path(vary, state)
    return params, state


def _port_lc(jtree, **cfg) -> lc.LC:
    params, state = jtree
    model = lc.LC(DPCConfig(**{**SHAPE, **cfg}), CLASSES)
    model.load_state_dict(lc_state_dict_from_jax(_np_tree(params),
                                                  _np_tree(state)),
                          strict=True)
    return model


def _x(seed, n=B):
    return np.random.default_rng(seed).normal(
        size=(n, 3, 4, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("train", [True, False])
def test_lc_forward_matches_jax(jax_lc_tree, train):
    params, state = jax_lc_tree
    x = _x(1)
    jlogits, jctx, jstate = jax_lc.apply_lc(
        params, state, jnp.asarray(x), cfg=JaxDPCConfig(**SHAPE),
        num_classes=CLASSES, train=train)
    model = _port_lc(jax_lc_tree)
    with torch.no_grad():
        logits, ctx, stats = lc.apply_lc(model, torch.tensor(x),
                                         cfg=DPCConfig(**SHAPE), train=train)
    assert logits.shape == (B, 1, CLASSES) and ctx.shape == (B, 1, 256)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
    want = lc_state_dict_from_jax(_np_tree(params), _np_tree(jstate))
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_dpc_params():
    """One dpc_tpu DPC initialisation for both context orders."""
    return jax_dpc.init_dpc(jax.random.PRNGKey(1),
                            JaxDPCConfig(**SHAPE, pred_step=1))


@pytest.mark.parametrize("order", ["lc", "dpc"])
def test_extract_context_matches_jax(jax_dpc_params, order):
    cfg = dict(SHAPE, pred_step=1)
    jparams = jax_dpc_params
    model = dpc.DPC(DPCConfig(**cfg))
    model.load_state_dict(dpc_state_dict_from_jax(_np_tree(jparams)),
                          strict=True)
    x = _x(2, n=2)
    want = jax_dpc.extract_context(jparams, jnp.asarray(x),
                                   cfg=JaxDPCConfig(**cfg), num_blocks=2,
                                   order=order)
    with torch.no_grad():
        got = dpc.extract_context(model, torch.tensor(x), cfg=DPCConfig(**cfg),
                                  num_blocks=2, order=order)
    assert got.shape == (2, 1, 1, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_loss(params, state, x, labels):
    logits, _, new_state = jax_lc.apply_lc(
        params, state, x, cfg=JaxDPCConfig(**SHAPE), num_classes=CLASSES,
        train=True)
    return jax_ft.softmax_xent(logits[:, 0], labels), new_state


# one trace and compile for every test that takes dpc_tpu's gradients
_jax_value_and_grad = jax.jit(jax.value_and_grad(_jax_loss, has_aux=True))


def _jax_grads(params, state, x, labels):
    return _jax_value_and_grad(params, state, x, labels)


def _assert_first_adam_step(model, before, want_after, group_lr):
    """Per parameter: the port's and the JAX update agree to 1% of the
    group's lr on >= 99.9% of elements and to 2.05·lr everywhere."""
    after = model.state_dict()
    close = total = 0
    for k, want in want_after.items():
        if "running" in k or "num_batches" in k:
            continue
        lr = group_lr(k)
        diff = ((after[k] - before[k]) - (want - before[k])).abs()
        assert diff.max() <= 2.05 * lr, k
        close += int((diff <= 1e-2 * lr).sum())
        total += diff.numel()
    assert close >= 0.999 * total, (close, total)


def test_finetune_step_matches_jax(jax_lc_tree):
    params, state = jax_lc_tree
    x, labels = _x(3), np.array([0, 3, 6, 3], np.int32)
    jcfg = JaxDPCConfig(**SHAPE)
    ecfg = dict(num_classes=CLASSES, dropout=0.0, lr=LR, wd=WD,
                batch_size=B, train_what="ft", backbone_lr_scale=0.1)
    # dpc_tpu's step on a one-device mesh, at lr_scale 0.5
    mesh = meshlib.make_mesh(1)
    tx = jax_optim.finetune_optimizer(params, LR, WD, "ft", 0.1)
    jstate = meshlib.replicate(mesh, jax_ft.FinetuneState(
        params, state, tx.init(params), jnp.zeros((), jnp.int32)))
    jstep = jax_ft.make_finetune_step(jcfg, JaxEvalConfig(**ecfg), mesh, tx,
                                      donate=False)
    jstate, jm = jstep(jstate, meshlib.shard_batch(mesh, jnp.asarray(x)),
                       meshlib.shard_batch(mesh, jnp.asarray(labels)),
                       jax.random.PRNGKey(0), jnp.float32(0.5))
    (jloss, _), jgrads = _jax_grads(params, state, jnp.asarray(x),
                                    jnp.asarray(labels))

    model = _port_lc(jax_lc_tree, gru_impl="pallas")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optim.finetune_optimizer(model, LR, WD, "ft", 0.1)
    step = finetune_step.make_finetune_step(
        DPCConfig(**SHAPE, gru_impl="pallas"), EvalConfig(**ecfg), model, opt)
    tm = step(torch.tensor(x), torch.tensor(labels), lr_scale=0.5)

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(jloss), float(jm["loss"]), rtol=1e-6)
    for k in ("top1", "top5"):
        assert float(tm[k]) == float(jm[k]), k
    # gradients of the trunk and the head
    gwant = lc_state_dict_from_jax(_np_tree(jgrads), _np_tree(state))
    for k, p in model.named_parameters():
        scale = float(gwant[k].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), gwant[k].numpy(), rtol=0,
                                   atol=1e-3 * scale + 1e-9, err_msg=k)
    # the Adam update, trunk at lr·0.1·0.5 and head at lr·0.5
    after = lc_state_dict_from_jax(_np_tree(jstate.params),
                                   _np_tree(jstate.state))
    _assert_first_adam_step(
        model, before, after,
        lambda k: 0.5 * LR * (0.1 if k.startswith(("backbone", "agg"))
                              else 1.0))
    for k, v in lc.running_stats(model).items():
        np.testing.assert_allclose(v.numpy(), after[k].numpy(), **TOL,
                                   err_msg=k)


def test_linear_probe_freezes_the_trunk(jax_lc_tree):
    params, state = jax_lc_tree
    x, labels = _x(4), np.array([1, 2, 5, 0], np.int32)
    (_, _), jgrads = _jax_grads(params, state, jnp.asarray(x),
                                jnp.asarray(labels))
    tx = jax_optim.finetune_optimizer(params, LR, WD, "last")
    import optax

    updates, _ = tx.update(jgrads, tx.init(params), params)
    after = lc_state_dict_from_jax(
        _np_tree(optax.apply_updates(params, updates)), _np_tree(state))

    model = _port_lc(jax_lc_tree)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optim.finetune_optimizer(model, LR, WD, "last")
    step = finetune_step.make_finetune_step(
        DPCConfig(**SHAPE), EvalConfig(num_classes=CLASSES, dropout=0.0,
                                       train_what="last"), model, opt)
    step(torch.tensor(x), torch.tensor(labels))
    for k, p in model.named_parameters():
        if k.startswith(("backbone", "agg")):
            assert not p.requires_grad and torch.equal(p, before[k]), k
            np.testing.assert_array_equal(after[k].numpy(), before[k].numpy())
    _assert_first_adam_step(model, before, after, lambda k: LR)


def test_eval_step_and_test_forward_match_jax(jax_lc_tree):
    params, state = jax_lc_tree
    x, labels = _x(5, n=6), np.array([0, 1, 2, 3, 4, 5], np.int32)
    jcfg = JaxDPCConfig(**SHAPE)
    jfwd = jax_ft.make_test_forward(jcfg, JaxEvalConfig(num_classes=CLASSES))
    jlogits = jfwd(params, state, jnp.asarray(x))

    model = _port_lc(jax_lc_tree)
    ecfg = EvalConfig(num_classes=CLASSES)
    logits = finetune_step.make_test_forward(DPCConfig(**SHAPE), ecfg,
                                             model)(torch.tensor(x))
    assert logits.shape == (6, CLASSES)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    metrics = finetune_step.make_finetune_eval_step(
        DPCConfig(**SHAPE), ecfg, model)(torch.tensor(x), torch.tensor(labels))
    jl = jnp.asarray(jlogits)
    np.testing.assert_allclose(
        float(metrics["loss"]),
        float(jax_ft.softmax_xent(jl, jnp.asarray(labels))), rtol=1e-4)
    for k, n in (("top1", 1), ("top5", 5)):
        assert float(metrics[k]) == float(
            jax_ft._accuracy(jl, jnp.asarray(labels), n)), k
    # eval mode leaves the running statistics as they were
    want = lc_state_dict_from_jax(_np_tree(params), _np_tree(state))
    for k, v in lc.running_stats(model).items():
        assert torch.equal(v, want[k]), k


def test_remat_step_computes_the_plain_step(jax_lc_tree):
    """With dropout on, the recomputing step draws the same masks and
    applies one running-stats update, so it matches the plain step."""
    x, labels = torch.tensor(_x(6)), torch.tensor([6, 5, 4, 3])
    results = []
    for remat in (False, True):
        model = _port_lc(jax_lc_tree, gru_dropout=0.1, gru_impl="pallas")
        opt = optim.finetune_optimizer(model, LR, WD)
        ecfg = EvalConfig(num_classes=CLASSES, dropout=0.5, remat=remat)
        step = finetune_step.make_finetune_step(
            DPCConfig(**{**SHAPE, "gru_dropout": 0.1}, gru_impl="pallas"),
            ecfg,
            model, opt)
        m = step(x, labels, torch.Generator().manual_seed(0))
        results.append((float(m["loss"]), model.state_dict()))
    (l0, sd0), (l1, sd1) = results
    assert l0 == pytest.approx(l1, rel=1e-6)
    for k in sd0:
        np.testing.assert_allclose(sd1[k].numpy(), sd0[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("milestones", [(60, 80, 100), (300, 400, 500),
                                        (150, 250, 300)])
def test_multistep_restart_lr_matches_jax(milestones):
    for repeat in (1, 2):
        for epoch in range(0, 2 * max(milestones) + 20, 7):
            assert optim.multistep_restart_lr(
                epoch, 1e-3, milestones, 0.1, repeat) == pytest.approx(
                jax_optim.multistep_restart_lr(
                    epoch, 1e-3, milestones, 0.1, repeat), rel=1e-12)


def test_unported_options_raise():
    """Every option of the LC steps is ported; what they cannot run
    raises: an unknown fold policy, a device recipe handed f32 clips or no
    generator, a train_what the reference has not."""
    model = lc.LC(DPCConfig(**SHAPE), CLASSES)
    opt = optim.finetune_optimizer(model, LR, WD)
    with pytest.raises(ValueError, match="fold_normalize"):
        finetune_step.make_finetune_step(
            DPCConfig(**SHAPE), EvalConfig(device_augment=True,
                                           fold_normalize="maybe"),
            model, opt)
    step = finetune_step.make_finetune_step(
        DPCConfig(**SHAPE), EvalConfig(device_augment=True), model, opt)
    clips = torch.zeros(2, 3, 4, 40, 40, 3)
    labels = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match="uint8"):
        step(clips, labels, augment_gen=torch.Generator())
    with pytest.raises(ValueError, match="generator"):
        step(clips.to(torch.uint8), labels)
    with pytest.raises(ValueError, match="train_what"):
        optim.finetune_optimizer(model, LR, WD, train_what="all")
