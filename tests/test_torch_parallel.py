"""The port's multi-rank pretraining on CPU ranks (gloo, one thread a rank)
against ``dpc_tpu``'s ``shard_map`` steps on the virtual 8-device mesh
(Pallas in interpret mode), same weights, same numpy-seeded inputs, f32,
``DPCConfig(img_dim=32, num_seq=3, seq_len=4, pred_step=1,
gru_dropout=0.0)``, B=8.

The port's ranks are spawned twice for the whole module (2 ranks for the
``{data:2}`` layouts, 4 for ``{data:2, model:2}``), in background threads
while ``dpc_tpu`` compiles its programs; each rank runs every task of its
job and returns small results, rank 0 its updated parameters in a file.

Tolerances: K7 lse and gradients 1e-5 relative, ranks exact; the sharded
loss 1e-5 relative, top-k exact, d(pred) and d(gt) 1e-4 of the largest;
group BN outputs and gradients 1e-5 of the largest; the steps' loss and
top-k 1e-4 relative.  The Adam step moves a parameter by about
lr·g/(|g| + eps), so the updated parameters compare gradient signs, and
at this size the gradients carry f32 noise of up to 2% of a tensor's
largest (the port against itself on 1 and 7 threads, batch-statistics BN
over a few elements), which flips the sign of about 0.15% of the Adam
updates against dpc_tpu's (measured: 99.86% within 1e-4 of the largest
parameter, update cosine 0.9968, at ``{data:2}`` global).  So: every
parameter within the 2·lr that a flipped sign costs, the two updates'
cosine at least 0.99, and 99.5% of the parameters within 1e-4 of the
largest; a step that averaged the wrong gradients would move about half
of them the other way.  The SGD update-norm ratio of ``{data:2, model:2}`` to
``{data:2}`` is 1 within 1e-3 (a psum where the model mean belongs
doubles it).
"""

import math
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dpc_tpu.core.config import DPCConfig as JaxDPCConfig
from dpc_tpu.core.config import TrainConfig as JaxTrainConfig
from dpc_tpu.models import dpc as jax_dpc
from dpc_tpu.models import layers as jax_layers
from dpc_tpu.ops import nce_pallas
from dpc_tpu.ops import sharded_nce as jax_sharded_nce
from dpc_tpu.parallel import mesh as jax_mesh
from dpc_tpu.train import optim as jax_optim
from dpc_tpu.train import pretrain_step as jax_step
from dpc_tpu_torch.core.config import DPCConfig, TrainConfig
from dpc_tpu_torch.models import dpc, layers
from dpc_tpu_torch.ops import nce_cuda, sharded_nce
from dpc_tpu_torch.parallel import dryrun
from dpc_tpu_torch.parallel import mesh as meshlib
from dpc_tpu_torch.train import optim, pretrain, pretrain_step
from dpc_tpu_torch.utils.weights import dpc_state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(img_dim=32, num_seq=3, seq_len=4, pred_step=1, gru_dropout=0.0)
B, LR, WD = 8, 1e-3, 1e-5
# name: (ranks, model axis, the port's TrainConfig fields; dpc_tpu runs
# the same layout with nce_impl="xla")
LAYOUTS = {
    "data2_local": (2, 1, dict(negatives="local", nce_impl="fused")),
    "data2_global": (2, 1, dict(negatives="global", nce_impl="fused")),
    "data2_xbn": (2, 1, dict(negatives="local", nce_impl="xla",
                             cross_replica_bn=True)),
    "data2_model2": (4, 2, dict(negatives="global", nce_impl="fused")),
}
NCE_SHAPE = (8, 3, 2, 2, 16)   # pred, gt: [B, P, S, S, D] over data=2
BN_SHAPE = (8, 2, 3, 3, 8)     # channels-last x of the group BN, 4 ranks


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "x": rng.normal(size=(B, 3, 4, 32, 32, 3)).astype(np.float32),
        "pred": rng.normal(size=NCE_SHAPE).astype(np.float32),
        "gt": rng.normal(size=NCE_SHAPE).astype(np.float32),
        "bn_x": rng.normal(size=BN_SHAPE).astype(np.float32),
        "bn_ct": rng.normal(size=BN_SHAPE).astype(np.float32),
        "bn_w": rng.uniform(0.5, 1.5, size=BN_SHAPE[-1]).astype(np.float32),
        "bn_b": rng.normal(size=BN_SHAPE[-1]).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# The port's ranks (spawned: module-level functions)
# ---------------------------------------------------------------------------

def _port_model(weights: str):
    model = dpc.DPC(DPCConfig(**SHAPE))
    model.load_state_dict(torch.load(weights, weights_only=True))
    return model


def _port_step(mesh, tmp: str, name: str, sgd: bool, x: np.ndarray) -> dict:
    world, mp, fields = LAYOUTS[name]
    cfg = DPCConfig(**SHAPE, gru_impl="pallas")
    tcfg = TrainConfig(batch_size=B, lr=LR, wd=WD, model_parallel=mp,
                       **fields)
    model = _port_model(os.path.join(tmp, "weights.pt"))
    before = [p.detach().clone() for p in model.parameters()]
    opt = (torch.optim.SGD(model.parameters(), lr=1.0) if sgd
           else optim.pretrain_optimizer(model, LR, WD))
    step = pretrain_step.make_pretrain_step(cfg, tcfg, model, opt, mesh)
    metrics = step(torch.from_numpy(meshlib.shard_batch(mesh, x)))
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "digest": dryrun.param_digest(model)}
    if sgd:
        out["norm"] = math.sqrt(sum(
            float(((p.detach() - q) ** 2).sum())
            for p, q in zip(model.parameters(), before)))
    elif mesh.rank == 0:
        torch.save(model.state_dict(), os.path.join(tmp, f"{name}.pt"))
    return out


def _port_nce(mesh, inp: dict) -> dict:
    out = {}
    d = mesh.data_index
    bl = NCE_SHAPE[0] // mesh.n_data
    for impl in ("xla", "fused"):
        pred = torch.tensor(inp["pred"][d * bl:(d + 1) * bl],
                            requires_grad=True)
        gt = torch.tensor(inp["gt"][d * bl:(d + 1) * bl], requires_grad=True)
        loss, metrics = sharded_nce.sharded_nce_loss(pred, gt, mesh,
                                                     impl=impl)
        loss.backward()
        out[impl] = {"loss": float(loss),
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "dpred": pred.grad.numpy(), "dgt": gt.grad.numpy()}
    return out


def _port_bn(mesh, inp: dict) -> dict:
    per = BN_SHAPE[0] // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    bn = layers.batchnorm3d(BN_SHAPE[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["bn_w"]))
        bn.bias.copy_(torch.from_numpy(inp["bn_b"]))
    x = torch.tensor(inp["bn_x"][rows]).permute(0, 4, 1, 2, 3)
    x.requires_grad_(True)
    y = layers.batchnorm(bn, x, mesh.world_group)
    ct = torch.from_numpy(inp["bn_ct"][rows]).permute(0, 4, 1, 2, 3)
    (y * ct).sum().backward()
    ema = layers.batchnorm3d(BN_SHAPE[-1], track_running_stats=True)
    layers.batchnorm(ema, x.detach(), mesh.world_group)
    return {"y": y.detach().permute(0, 2, 3, 4, 1).numpy(),
            "dx": x.grad.permute(0, 2, 3, 4, 1).numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "running": (ema.running_mean.numpy(), ema.running_var.numpy())}


def _port_eval(mesh, tmp: str, x: np.ndarray) -> dict:
    tcfg = TrainConfig(batch_size=B, negatives="global", model_parallel=2,
                       nce_impl="xla")
    model = _port_model(os.path.join(tmp, "weights.pt"))
    ev = pretrain_step.make_eval_step(DPCConfig(**SHAPE, gru_impl="pallas"),
                                      tcfg, model, mesh)
    return {k: float(v) for k, v in
            ev(torch.from_numpy(meshlib.shard_batch(mesh, x))).items()}


def _port_job(rank: int, tmp: str, inp: dict) -> dict:
    world = torch.distributed.get_world_size()
    mesh = meshlib.make_mesh(0, model_parallel=2 if world == 4 else 1)
    out = {}
    if world == 4:
        out["nce"] = _port_nce(mesh, inp)
        out["bn"] = _port_bn(mesh, inp)
        out["eval"] = _port_eval(mesh, tmp, inp["x"])
        out["dryrun"] = dryrun._dryrun_rank(rank, 2, 4)
    for name, (n, _, _) in LAYOUTS.items():
        if n == world:
            out[name] = _port_step(mesh, tmp, name, False, inp["x"])
    sgd = "data2_model2" if world == 4 else "data2_global"
    out["sgd"] = _port_step(mesh, tmp, sgd, True, inp["x"])
    return out


# ---------------------------------------------------------------------------
# dpc_tpu's side
# ---------------------------------------------------------------------------

def _jax_steps(jparams, x) -> dict:
    jcfg = JaxDPCConfig(**SHAPE)
    out = {}
    for name, (n, mp, fields) in LAYOUTS.items():
        mesh = jax_mesh.make_mesh(n, model_parallel=mp)
        jfields = dict(fields, nce_impl="xla")
        tcfg = JaxTrainConfig(batch_size=B, lr=LR, wd=WD, donate=False,
                              **jfields)
        tx = jax_optim.pretrain_optimizer(jparams, LR, WD)
        state = jax_step.TrainState(jparams, tx.init(jparams),
                                    jnp.zeros((), jnp.int32))
        xb = jax_mesh.shard_batch(mesh, jnp.asarray(x))
        state, m = jax_step.make_pretrain_step(jcfg, tcfg, mesh, tx)(
            state, xb, jax.random.PRNGKey(1))
        out[name] = ({k: float(v) for k, v in m.items()},
                     dpc_state_dict_from_jax(
                         jax.tree.map(np.asarray, state.params)))
        if name == "data2_model2":
            ev = jax_step.make_eval_step(jcfg, tcfg, mesh)
            out["eval"] = {k: float(v) for k, v in
                           ev(jparams, xb, jax.random.PRNGKey(1)).items()}
    return out


def _jax_nce(inp) -> dict:
    mesh = jax_mesh.make_mesh(4, model_parallel=2)
    out = {}
    for impl in ("xla", "fused"):
        def body(pred, gt, impl=impl):
            def loss(pr, g):
                return jax_sharded_nce.sharded_nce_loss(pr, g, impl=impl)
            (l, met), grads = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(pred, gt)
            return l, met, grads[0], grads[1]

        l, met, dp, dg = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=(P(), P(), P(("data", "model")), P(("data", "model"))),
            check_vma=False))(jnp.asarray(inp["pred"]),
                              jnp.asarray(inp["gt"]))
        out[impl] = {"loss": float(l),
                     "metrics": {k: float(v) for k, v in met.items()},
                     "dpred": np.asarray(dp), "dgt": np.asarray(dg)}
    return out


def _jax_bn(inp) -> dict:
    mesh = jax_mesh.make_mesh(4)
    params = {"scale": jnp.asarray(inp["bn_w"]),
              "bias": jnp.asarray(inp["bn_b"])}

    def body(x, p, ct):
        def f(x, p):
            y, _ = jax_layers.batchnorm(p, None, x, train=True,
                                        axis_name="data")
            return jnp.sum(y * ct), y
        (_, y), (dx, dp) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(x, p)
        return y, dx, dp["scale"][None], dp["bias"][None]

    y, dx, dw, db = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("data"), P(), P("data")),
        out_specs=(P("data"),) * 4, check_vma=False))(
        jnp.asarray(inp["bn_x"]), params, jnp.asarray(inp["bn_ct"]))
    return {"y": np.asarray(y), "dx": np.asarray(dx),
            "dw": np.asarray(dw), "db": np.asarray(db)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every comparison: the port's two rank jobs run in
    background threads while dpc_tpu compiles and runs its programs."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    inp = _inputs()
    jparams = jax_dpc.init_dpc(jax.random.PRNGKey(0), JaxDPCConfig(**SHAPE))
    before = dpc_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    torch.save(before, os.path.join(tmp, "weights.pt"))
    port, errors = {}, []

    def job(world):
        try:
            port[world] = meshlib.run_ranks(_port_job, world, (tmp, inp))
        except Exception as e:  # reported by the fixture below
            errors.append(e)

    threads = [threading.Thread(target=job, args=(w,)) for w in (4, 2)]
    for t in threads:
        t.start()
    ref = {"steps": _jax_steps(jparams, inp["x"]), "nce": _jax_nce(inp),
           "bn": _jax_bn(inp)}
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "a rank job did not finish"
    if errors:
        raise errors[0]
    params = {name: torch.load(os.path.join(tmp, f"{name}.pt"),
                               weights_only=True) for name in LAYOUTS}
    return {"port": port, "ref": ref, "inp": inp, "before": before,
            "params": params}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _assert_params_close(got: dict, want: dict, before: dict) -> None:
    """Updated parameters: every one within the 2·lr an Adam step costs
    where its gradient's sign flips; the two updates' cosine at least
    0.99; and 99.5% of them within 1e-4 of the largest parameter."""
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    close = total = 0
    dot = n_got = n_want = 0.0
    for k, w in want.items():
        g = torch.as_tensor(got[k]).double() - before[k].double()
        w = torch.as_tensor(w).double() - before[k].double()
        diff = (g - w).abs()
        assert float(diff.max()) <= 2.05 * LR, k
        close += int((diff <= 1e-4 * scale).sum())
        total += diff.numel()
        dot += float((g * w).sum())
        n_got += float((g * g).sum())
        n_want += float((w * w).sum())
    assert dot / math.sqrt(n_got * n_want) >= 0.99
    assert close >= 0.995 * total, (close, total)


# ---------------------------------------------------------------------------
# (a) K7's plain version against nce_pallas.nce_lse_rank_shard
# ---------------------------------------------------------------------------

def test_k7_plain_matches_pallas_shard_kernel():
    rng = np.random.default_rng(1)
    r, c, d = 40, 56, 24
    rows = rng.normal(size=(r, d)).astype(np.float32) * 0.5
    cols = rng.normal(size=(c, d)).astype(np.float32) * 0.5
    targets = rng.integers(0, c, size=r).astype(np.int32)
    targets[::2] = -1                      # off the owner: half the rows
    pos = (rows * cols[np.maximum(targets, 0)]).sum(-1).astype(np.float32)
    g = rng.normal(size=r).astype(np.float32)

    (lse_j, rank_j), vjp = jax.vjp(
        lambda a, b, p: nce_pallas.nce_lse_rank_shard(
            a, b, p, jnp.asarray(targets)),
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(pos))
    dr_j, dc_j, dp_j = vjp((jnp.asarray(g), jnp.zeros_like(rank_j)))

    for fn in (nce_cuda.nce_lse_rank_shard, nce_cuda.nce_lse_rank_shard_plain):
        a = torch.tensor(rows, requires_grad=True)
        b = torch.tensor(cols, requires_grad=True)
        p = torch.tensor(pos, requires_grad=True)
        lse, rank = fn(a, b, p, torch.from_numpy(targets))
        (lse * torch.from_numpy(g)).sum().backward()
        assert _rel(lse.detach(), lse_j) <= 1e-5
        np.testing.assert_array_equal(rank.numpy(), np.asarray(rank_j))
        assert _rel(a.grad, dr_j) <= 1e-5
        assert _rel(b.grad, dc_j) <= 1e-5
        assert float(p.grad.abs().max()) == 0.0 == float(np.abs(dp_j).max())


# ---------------------------------------------------------------------------
# (b) the candidate-sharded loss, (c) group BN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_sharded_nce_loss_matches_shard_map(runs, impl):
    want = runs["ref"]["nce"][impl]
    rank_b = NCE_SHAPE[0] // 2  # each peer holds its data group's clips
    for r, res in enumerate(runs["port"][4]):
        got = res["nce"][impl]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["metrics"] == want["metrics"]
        rows = slice(r * rank_b, (r + 1) * rank_b)
        assert _rel(got["dpred"], want["dpred"][rows]) <= 1e-4
        assert _rel(got["dgt"], want["dgt"][rows]) <= 1e-4


def test_group_batchnorm_matches_cross_replica_bn(runs):
    want = runs["ref"]["bn"]
    per = BN_SHAPE[0] // 4
    for r, res in enumerate(runs["port"][4]):
        got = res["bn"]
        rows = slice(r * per, (r + 1) * per)
        assert _rel(got["y"], want["y"][rows]) <= 1e-5
        assert _rel(got["dx"], want["dx"][rows]) <= 1e-5
        assert _rel(got["dw"], want["dw"][r]) <= 1e-5
        assert _rel(got["db"], want["db"][r]) <= 1e-5


def test_group_batchnorm_running_stats_use_the_global_count(runs):
    """The running statistics of a group BN in train mode equal those of
    one BN over the whole batch: the unbiased variance takes the global
    element count (``test_train_step.py``'s EMA pin, here against
    torch's own BN on the full batch)."""
    full = layers.batchnorm3d(BN_SHAPE[-1], track_running_stats=True)
    full(torch.from_numpy(runs["inp"]["bn_x"]).permute(0, 4, 1, 2, 3))
    for res in runs["port"][4]:
        mean, var = res["bn"]["running"]
        assert _rel(mean, full.running_mean) <= 1e-5
        assert _rel(var, full.running_var) <= 1e-5


# ---------------------------------------------------------------------------
# (d) the train steps, (e) the eval step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(LAYOUTS))
def test_train_step_matches_dpc_tpu(runs, name):
    world = LAYOUTS[name][0]
    want_m, want_p = runs["ref"]["steps"][name]
    results = [res[name] for res in runs["port"][world]]
    for res in results:
        for k, v in want_m.items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-4,
                                       err_msg=k)
    # the same Adam update on every rank: bit-identical parameters
    assert len({res["digest"] for res in results}) == 1
    _assert_params_close(runs["params"][name], want_p, runs["before"])


def test_model_axis_equals_data_only_layout(runs):
    """{data:2, model:2} computes what {data:2} computes (the port's own
    pin of dpc_tpu's ``{d,m} ≡ {d}``): loss and top-k, the Adam update,
    and the SGD update's norm (a miscounted m-factor scales it by m)."""
    mp = runs["port"][4][0]["data2_model2"]["metrics"]
    dp = runs["port"][2][0]["data2_global"]["metrics"]
    for k in dp:
        np.testing.assert_allclose(mp[k], dp[k], rtol=1e-4, err_msg=k)
    _assert_params_close(runs["params"]["data2_model2"],
                         runs["params"]["data2_global"], runs["before"])
    ratio = (runs["port"][4][0]["sgd"]["norm"]
             / runs["port"][2][0]["sgd"]["norm"])
    assert abs(ratio - 1.0) <= 1e-3, ratio


def test_eval_step_matches_dpc_tpu(runs):
    want = runs["ref"]["steps"]["eval"]
    for res in runs["port"][4]:
        for k, v in want.items():
            np.testing.assert_allclose(res["eval"][k], v, rtol=1e-4,
                                       err_msg=k)


def test_dryrun_body_takes_one_finite_step(runs):
    """``dryrun_multichip(4)``'s rank body on the module's 4 ranks: uint8
    windows through the sized-crop recipe, {data:2, model:2}, global
    negatives; a finite loss, one Adam step, the same parameters on every
    rank."""
    results = [res["dryrun"] for res in runs["port"][4]]
    assert results[0]["shape"] == {"data": 2, "model": 2}
    assert all(math.isfinite(r["loss"]) and r["steps"] == [1]
               for r in results)
    assert len({r["digest"] for r in results}) == 1


# ---------------------------------------------------------------------------
# (f) the guards
# ---------------------------------------------------------------------------

def test_layout_guards():
    model = dpc.DPC(DPCConfig(**SHAPE))
    opt = optim.pretrain_optimizer(model, LR, WD)
    mesh = meshlib.Mesh(4, 2, 0)   # {data:4, model:2}, no groups
    cfg = DPCConfig(**SHAPE)
    local = TrainConfig(batch_size=B, negatives="local", model_parallel=2)
    with pytest.raises(ValueError, match="negatives global"):
        pretrain_step.make_pretrain_step(cfg, local, model, opt, mesh)
    with pytest.raises(ValueError, match="negatives global"):
        pretrain_step.make_eval_step(cfg, local, model, mesh)
    odd = TrainConfig(batch_size=12, negatives="global", model_parallel=2)
    with pytest.raises(ValueError, match="not divisible"):
        pretrain_step.make_pretrain_step(cfg, odd, model, opt, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        pretrain_step.make_eval_step(cfg, odd, model, mesh)
    with pytest.raises(ValueError, match="needs a mesh"):
        pretrain_step.make_pretrain_step(
            cfg, TrainConfig(batch_size=B, model_parallel=2), model, opt)


def test_cli_refuses_bad_layouts_before_starting_ranks(monkeypatch):
    base = ["--dataset", "synthetic", "--batch_size", "8"]
    with pytest.raises(SystemExit, match="negatives global"):
        pretrain.main(base + ["--device", "cpu", "--num_devices", "4",
                              "--model_parallel", "2"])
    with pytest.raises(SystemExit, match="divisible by 3 devices"):
        pretrain.main(base + ["--device", "cpu", "--num_devices", "3"])
    # one card: two ranks are refused, not put on the one card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 2 cards"):
        pretrain.main(base + ["--num_devices", "2"])


def test_seed_streams_follow_the_layout():
    """Data shards draw distinct streams, model peers share the
    augmentation stream and take their slice of the data group's draws,
    and their dropout streams differ; one data shard changes nothing."""
    grid = [meshlib.Mesh(2, 2, r) for r in range(4)]
    data = [meshlib.data_seed(m, 7) for m in grid]
    assert data[0] == data[1] != data[2] == data[3]
    assert len({meshlib.dropout_seed(m, 7) for m in grid}) == 4
    assert [meshlib.peer_rows(m, 3) for m in grid] == [(6, 0), (6, 3)] * 2
    one = meshlib.Mesh(1, 1, 0)
    assert meshlib.data_seed(one, 7) == meshlib.dropout_seed(one, 7) == 7
    assert meshlib.shard_batch(grid[2], np.arange(8)).tolist() == [4, 5]


# ---------------------------------------------------------------------------
# (g) the CLI on two CPU ranks, (h) a signal to one rank
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--dataset", "synthetic", "--img_dim", "32",
       "--num_seq", "3", "--seq_len", "4", "--pred_step", "1",
       "--batch_size", "4", "--synthetic_videos", "8", "--num_workers", "1",
       "--compute_dtype", "float32", "--print_freq", "1"]


def _cli(*args) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE")}
    proc = subprocess.run(
        [sys.executable, "-m", "dpc_tpu_torch.train.pretrain", *CLI, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_cli_two_ranks_trains_checkpoints_and_resumes(tmp_path):
    out = _cli("--num_devices", "2", "--negatives", "global",
               "--nce_impl", "fused", "--steps_per_epoch", "2", "--epochs",
               "1", "--log_dir", str(tmp_path))
    assert "devices: {'data': 2, 'model': 1} × cpu" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("epoch 0: train")]
    assert len(lines) == 1, out        # rank 0 alone prints
    loss = float(lines[0].split("loss")[1].split()[0])
    assert math.isfinite(loss)
    run = next(tmp_path.glob("*/model"))
    assert sorted(p.name for p in run.iterdir()) == [
        "epoch1.pth.tar", "model_best_epoch1.pth.tar"]
    out = _cli("--num_devices", "2", "--negatives", "global",
               "--nce_impl", "fused", "--steps_per_epoch", "2", "--epochs",
               "2", "--resume", str(run.parent))
    assert out.count("resumed epoch 1") == 1, out
    assert [ln for ln in out.splitlines() if ln.startswith("epoch ")] \
        == [ln for ln in out.splitlines() if ln.startswith("epoch 1: train")]
    assert (run / "epoch2.pth.tar").exists()


def _preempted_rank(rank: int, argv: list) -> dict:
    """Run the CLI as one rank; rank 1 sends itself SIGTERM as step 1 is
    seeded.  Returns the step positions this rank checkpointed at and its
    exit message."""
    from dpc_tpu_torch.core import checkpoint as ck
    from dpc_tpu_torch.train import loop

    saved = []
    step_id, step_seed = ck.mid_epoch_step_id, loop.step_seed

    def spy_id(epoch, batch_idx, offset=0):
        saved.append((epoch, batch_idx))
        return step_id(epoch, batch_idx, offset)

    def seed(s, epoch, idx, *stream):
        if rank == 1 and idx == 1 and not stream:
            os.kill(os.getpid(), signal.SIGTERM)
        return step_seed(s, epoch, idx, *stream)

    ck.mid_epoch_step_id, loop.step_seed = spy_id, seed
    try:
        pretrain.main(argv)
    except SystemExit as e:
        return {"saved": saved, "exit": str(e.code)}
    return {"saved": saved, "exit": ""}


def test_signal_to_one_rank_checkpoints_every_rank_at_one_step(tmp_path):
    argv = CLI + ["--num_devices", "2", "--steps_per_epoch", "4",
                  "--epochs", "1", "--save_every_steps", "100",
                  "--log_dir", str(tmp_path)]
    results = meshlib.run_ranks(_preempted_rank, 2, (argv,))
    assert [r["saved"] for r in results] == [[(0, 1)], [(0, 1)]], results
    assert all(r["exit"].startswith("[preemption]") for r in results)
    (step_file,) = tmp_path.glob("*/model_steps/step*.pth.tar")
    payload = torch.load(step_file, weights_only=True)
    assert (payload["epoch"], payload["batch_idx"]) == (0, 1)
