"""The port's NCE against dpc_tpu's on the CPU.

* ``nce_cuda.nce_lse_rank`` (its plain version runs for CPU tensors; the
  card holds K-NCE-F/K-NCE-B against it) matches
  ``nce_pallas.nce_lse_rank`` in Pallas interpret mode: lse, pos, rank and
  both gradients, for a ragged R, an asymmetric C > R and targets off the
  diagonal.
* ``fused_nce_loss`` and the port's ``nce_loss`` match ``nce.nce_loss``.
* The arithmetic the H100 kernels (``csrc/nce.cu``) rely on, in plain
  torch: the 3xTF32 split holds the f32 tolerances where one TF32 pass
  does not; the forward's per-split (max, sum, count) partials merged in
  split order give ``nce_forward_plain``; the backward's per-split partial
  sums, with P fed as the wgmma A fragment against the permuted transposed
  planes, reduced in split order give ``nce_backward_plain``.

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
from torch_threads import one_thread  # noqa: F401


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
    assert nce.pick_nce_impl(8, 8, 256, cpu) == "xla"
    huge = int(np.sqrt(nce.device_memory_bytes(cpu))) + 1
    assert nce.pick_nce_impl(huge, huge, 256, cpu) == "fused"


def test_pick_nce_impl_follows_the_h100_sweep(monkeypatch):
    """On the card: the flash kernels at D = 256 at every corner of the
    sweep, the materialised score at D = 1024 (from R = 3072 on, where
    the sweep measured it 2.1-3.4x faster; at 768 rows both are launch
    bound), and the flash kernels whenever the score would not fit the
    memory budget, whatever D."""
    card = torch.device("cuda")
    monkeypatch.setattr(nce, "device_memory_bytes", lambda device: 80 << 30)
    for r, c in ((768, 768), (3072, 3072), (12288, 12288), (1536, 3072)):
        assert nce.pick_nce_impl(r, c, 256, card) == "fused"
        assert nce.pick_nce_impl(r, c, 1024, card) == "xla"
    assert nce.pick_nce_impl(3072, 3072, nce.FLASH_MAX_D, card) == "fused"
    assert nce.pick_nce_impl(3072, 3072, nce.FLASH_MAX_D + 1, card) == "xla"
    huge = int(np.sqrt((80 << 30) / 64)) + 1
    assert nce.pick_nce_impl(huge, huge, 1024, card) == "fused"


# --- the kernels' arithmetic, emulated in plain torch -----------------------

TILE = 64  # columns of a score tile in csrc/nce.cu


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round f32 to 10 mantissa bits, to nearest,
    ties away from zero (the low 13 bits of the result are zero)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split_hi_lo(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_3xtf32(a, b):
    """a · bᵀ as the kernels compute it: hi·hi + hi·lo + lo·hi in f32."""
    ah, al = split_hi_lo(a)
    bh, bl = split_hi_lo(b)
    return ah @ bh.t() + ah @ bl.t() + al @ bh.t()


def mm_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b).t()


def split_ranges(n: int, splits: int):
    """Column tiles [tb, te) of each split, as ``split_range`` in nce.cu."""
    nt = -(-n // TILE)
    return [(s * nt // splits * TILE, min((s + 1) * nt // splits * TILE, n))
            for s in range(splits)]


def _nce_data(r, c, d, seed):
    rng = np.random.default_rng(seed)
    rows = torch.tensor(0.25 * rng.standard_normal((r, d)), dtype=torch.float32)
    cols = torch.tensor(0.25 * rng.standard_normal((c, d)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal(r) / r, dtype=torch.float32)
    return rows, cols, g


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + 0.49 * ulp, one + 0.5 * ulp, -(one + 0.5 * ulp),
                      one + 1.5 * ulp, 3.0], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, -(one + ulp), one + 2 * ulp, 3.0])
    assert torch.equal(tf32_rna(x), want)
    assert not (tf32_rna(x).view(torch.int32) & 0x1FFF).any()


def test_3xtf32_split_holds_the_nce_tolerances_one_pass_does_not():
    """R = C = 512, D = 256, 0.25·randn as chip_smoke's check_nce: the
    three-pass split holds lse to 1e-5 and drows/dcols to 1e-4 relative
    against f64; one TF32 pass misses the gradient tolerance."""
    rows, cols, g = _nce_data(512, 512, 256, seed=0)
    r64, c64 = rows.double(), cols.double()
    s64 = r64 @ c64.t()
    lse64 = torch.logsumexp(s64, -1)
    p64 = torch.exp(s64 - lse64[:, None]) * g.double()[:, None]
    drows64, dcols64 = p64 @ c64, p64.t() @ r64

    errs = {}
    for name, mm in (("3x", mm_3xtf32), ("1x", mm_1xtf32)):
        s = mm(rows, cols)
        p = torch.exp(s - lse64.float()[:, None]) * g[:, None]
        errs[name] = (_rel(torch.logsumexp(s, -1), lse64),
                      _rel(mm(p, cols.t()), drows64),
                      _rel(mm(p.t(), rows.t()), dcols64))
    lse_err, dr_err, dc_err = errs["3x"]
    assert lse_err <= 1e-5 and dr_err <= 1e-4 and dc_err <= 1e-4, errs
    assert max(errs["1x"][1:]) > 1e-4, errs


@pytest.mark.parametrize("r,c,splits,shift", [
    (96, 200, 3, 5),    # ragged last tile, uneven splits
    (37, 130, 2, 0),
    (64, 64, 1, 7),     # one split, one tile
])
def test_split_column_forward_matches_plain(r, c, splits, shift):
    """Per-split (max, sum, count) over 64-column tiles with the online
    update of nce_fwd_kernel, merged in split order as nce_fwd_combine."""
    rows, cols, _ = _nce_data(r, c, 32, seed=r + c)
    targets = ((torch.arange(r) + shift) % c).int()
    pos = (rows * cols[targets.long()]).sum(-1)
    s = rows @ cols.t()
    col = torch.arange(c)
    parts = []
    for c0, c1 in split_ranges(c, splits):
        m = torch.full((r,), -torch.inf)
        tot, cnt = torch.zeros(r), torch.zeros(r)
        for b0 in range(c0, c1, TILE):
            tile = s[:, b0:min(b0 + TILE, c1)]
            mn = torch.maximum(m, tile.max(-1).values)
            tot = tot * torch.exp(m - mn) + torch.exp(tile - mn[:, None]).sum(-1)
            m = mn
            beats = (tile > pos[:, None]) & (
                col[b0:b0 + tile.shape[1]][None, :] != targets[:, None])
            cnt = cnt + beats.sum(-1)
        parts.append((m, tot, cnt))
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    tot, cnt = torch.zeros(r), torch.zeros(r)
    for m, t, k in parts:          # split order
        tot = tot + t * torch.exp(m - mx)
        cnt = cnt + k
    lse_p, rank_p = nce_cuda.nce_forward_plain(rows, cols, pos, targets)
    torch.testing.assert_close(torch.log(tot) + mx, lse_p, rtol=1e-6, atol=0)
    assert torch.equal(cnt.float(), rank_p)


def _transposed_plane(x: torch.Tensor) -> torch.Tensor:
    """The prep pass's transposed plane of x [n, D]: [D, roundup(n, 8)],
    position q holding x[8·(q//8) + sigma(q % 8)], the pad zero."""
    n, d = x.shape
    ld = -(-n // 8) * 8
    sigma = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    src = (torch.arange(ld) // 8) * 8 + sigma[torch.arange(ld) % 8]
    padded = torch.cat([x, torch.zeros(ld - n, d)])
    return padded[src].t().contiguous()


def _p_times_other(p_tile, planeT, b0):
    """out[64, D] = P_tile · other over the tile's columns, as the wgmma
    with P as A from the accumulator registers computes it: K step jt's A
    fragment (g, t), (g+8, t), (g, t+4), (g+8, t+4) is accumulator column
    8jt + 2t, 8jt + 2t, 8jt + 2t + 1, 8jt + 2t + 1, against positions
    8jt .. 8jt + 7 of the transposed plane."""
    width = p_tile.shape[1]
    out = torch.zeros(p_tile.shape[0], planeT.shape[0])
    for jt in range(-(-width // 8)):
        frag = torch.zeros(p_tile.shape[0], 8)
        for t in range(4):
            for kpos, col in ((t, 8 * jt + 2 * t), (t + 4, 8 * jt + 2 * t + 1)):
                if col < width:
                    frag[:, kpos] = p_tile[:, col]
        b = planeT[:, b0 + 8 * jt:b0 + 8 * jt + 8].t()
        out += frag[:, :b.shape[0]] @ b
    return out


@pytest.mark.parametrize("r,c,d,splits_r,splits_c", [
    (96, 200, 48, 2, 1),
    (130, 70, 40, 3, 2),
])
def test_split_backward_partials_match_plain(r, c, d, splits_r, splits_c):
    """drows: each split of the column tiles sums P·cols into its own
    partial, using the permuted colsᵀ plane; the partials are added in
    split order.  dcols likewise with rows and columns swapped."""
    rows, cols, g = _nce_data(r, c, d, seed=7 * r + c)
    lse = torch.logsumexp(rows @ cols.t(), -1)
    want_dr, want_dc = nce_cuda.nce_backward_plain(rows, cols, lse, g)

    def sweep(own, other, splits, p_of):
        plane = _transposed_plane(other)
        total = torch.zeros(own.shape[0], own.shape[1])
        for c0, c1 in split_ranges(other.shape[0], splits):
            part = torch.zeros_like(total)
            for a0 in range(0, own.shape[0], TILE):
                for b0 in range(c0, c1, TILE):
                    s = own[a0:a0 + TILE] @ other[b0:min(b0 + TILE, c1)].t()
                    p = p_of(s, a0, b0)
                    part[a0:a0 + TILE] += _p_times_other(p, plane, b0)
            total = total + part   # split order
        return total

    def p_rows(s, a0, b0):
        n = s.shape[0]
        return torch.exp(s - lse[a0:a0 + n, None]) * g[a0:a0 + n, None]

    def p_cols(s, a0, b0):
        n = s.shape[1]
        return torch.exp(s - lse[None, b0:b0 + n]) * g[None, b0:b0 + n]

    dr = sweep(rows, cols, splits_r, p_rows)
    dc = sweep(cols, rows, splits_c, p_cols)
    torch.testing.assert_close(dr, want_dr, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(dc, want_dc, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("pred_step", [3, 1])   # 1: no temporal negative
def test_dense_score_6d_and_mask_code_stats_match_jax(pred_step):
    """The analysis helpers at B=4, 4x4 cells, D=8, within 1e-5 of
    dpc_tpu's (the means as max |d| / max |mean|); with pred_step 1 the
    mask holds no temporal negative, whose mean is then 0."""
    rng = np.random.default_rng(pred_step)
    pred = rng.normal(size=(4, pred_step, 4, 4, 8)).astype(np.float32)
    gt = rng.normal(size=(4, pred_step, 4, 4, 8)).astype(np.float32)
    mask = nce.nce_mask(4, pred_step, 16)
    want6 = np.asarray(jax_nce.dense_score_6d(jnp.asarray(pred),
                                              jnp.asarray(gt)))
    got6 = nce.dense_score_6d(torch.tensor(pred), torch.tensor(gt))
    assert got6.shape == want6.shape == (4, pred_step, 16, 4, pred_step, 16)
    assert got6.dtype == torch.float32
    np.testing.assert_allclose(got6.numpy(), want6, rtol=1e-5,
                               atol=1e-5 * np.abs(want6).max())
    # bf16 inputs are scored in f32
    assert nce.dense_score_6d(torch.tensor(pred).bfloat16(),
                              torch.tensor(gt).bfloat16()).dtype \
        == torch.float32

    got = nce.mask_code_stats(got6, mask)
    want = jax_nce.mask_code_stats(jnp.asarray(want6), mask)
    assert list(got) == list(want)
    g = np.array([float(v) for v in got.values()])
    w = np.array([float(v) for v in want.values()])
    assert all(v.dim() == 0 for v in got.values())
    assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    if pred_step == 1:
        assert float(got["temporal_neg"]) == 0.0
    for name, code in (("pos", nce.POSITIVE), ("easy_neg", nce.EASY_NEG)):
        np.testing.assert_allclose(float(got[name]),
                                   want6[mask == code].mean(), rtol=1e-5)
