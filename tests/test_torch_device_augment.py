"""The port's device augmentation against ``dpc_tpu.data.device_augment``
and the stem's normalize fold against ``dpc_tpu``'s, on the CPU.

The port draws from a ``torch.Generator`` into ``Draws`` and applies them
deterministically, so each test derives ``dpc_tpu``'s draws from its JAX key
with its own split order, hands them to the port's apply functions and
holds the outputs against ``dpc_tpu``'s on the same uint8 input (made with
numpy from a seed).  Tolerances: the gathers (NEAREST resize, centre crop,
the dense-test recipe before Normalize) exactly; everything with a bilinear
tap, a colour matrix or Normalize to 1e-5 absolute on normalised values
(the sums run in another order than XLA's contractions).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dpc_tpu.core.config import EvalConfig as JaxEvalConfig
from dpc_tpu.core.config import TrainConfig as JaxTrainConfig
from dpc_tpu.data import device_augment as jda
from dpc_tpu.models import layers as jax_layers
from dpc_tpu_torch.core.config import EvalConfig, TrainConfig
from dpc_tpu_torch.data import device_augment as da
from dpc_tpu_torch.models import layers
from dpc_tpu_torch.utils.weights import _CONVERT

B, N, SL, H, W, D = 2, 2, 3, 40, 56, 16
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _clips(seed=0, h=H, w=W):
    return np.random.default_rng(seed).integers(
        0, 256, size=(B, N, SL, h, w, 3)).astype(np.uint8)


def _t(x):
    return torch.from_numpy(np.array(x))


# dpc_tpu's draws, from its keys, in its split order -------------------------

def _jax_crop(key, h, w):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    area = jax.random.uniform(k1, (), minval=0.5, maxval=1.0) * (h * w)
    aspect = jnp.exp(jax.random.uniform(k2, (), minval=math.log(3 / 4),
                                        maxval=math.log(4 / 3)))
    cw = jnp.clip(jnp.sqrt(area * aspect), 8.0, w).astype(jnp.int32)
    ch = jnp.clip(jnp.sqrt(area / aspect), 8.0, h).astype(jnp.int32)
    x0 = jax.random.randint(k3, (), 0, jnp.maximum(w - cw, 0) + 1)
    y0 = jax.random.randint(k4, (), 0, jnp.maximum(h - ch, 0) + 1)
    return jnp.stack([x0, y0, cw, ch])


def _jax_jitter(key, shape, strengths):
    b, c, s, hue = strengths
    kb, kc, ks, kh = jax.random.split(key, 4)
    return jnp.stack([
        jax.random.uniform(kb, shape, minval=max(0, 1 - b), maxval=1 + b),
        jax.random.uniform(kc, shape, minval=max(0, 1 - c), maxval=1 + c),
        jax.random.uniform(ks, shape, minval=max(0, 1 - s), maxval=1 + s),
        jax.random.uniform(kh, shape, minval=-hue, maxval=hue)], -1)


def _pretrain_draws(key, frames, h, w, recipe):
    def one(k):
        kc, kf, kg, kj = jax.random.split(k, 4)
        k1, k2 = jax.random.split(kg)
        return (jax.random.bernoulli(kf), _jax_crop(kc, h, w),
                jax.random.bernoulli(k1, 0.5, (frames,)),
                jax.random.randint(k2, (frames,), 0, 3),
                _jax_jitter(kj, (frames,), da.PRETRAIN_JITTER))

    flip, crop, gray, chan, jit = (np.asarray(v) for v in
                                   jax.vmap(one)(jax.random.split(key, B)))
    return da.Draws(flip=_t(flip), gray=_t(gray), gray_chan=_t(chan).long(),
                    jitter=_t(jit),
                    crop=_t(crop).long() if recipe == "sized_crop" else None)


def _finetune_draws(key, h, w, mode):
    def one(k):
        kp, kc, kf, kq, kj = jax.random.split(k, 5)
        return (jax.random.bernoulli(kf), _jax_crop(kc, h, w),
                jax.random.bernoulli(kp, 0.3), jax.random.bernoulli(kq, 0.3),
                _jax_jitter(kj, (1,), da.FINETUNE_JITTER[mode]))

    flip, crop, crop_p, jit_p, jit = (np.asarray(v) for v in
                                      jax.vmap(one)(jax.random.split(key, B)))
    return da.Draws(flip=_t(flip), crop=_t(crop).long(),
                    crop_p=_t(crop_p) if mode == "val" else None,
                    jitter_p=_t(jit_p), jitter=_t(jit))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


# the functions one by one --------------------------------------------------

def test_gathers_are_exact():
    clips = _clips(1)
    flat = clips.reshape(B, N * SL, H, W, 3)
    flips = np.array([True, False])
    got = da.resize_fixed(_t(flat), D, flip=_t(flips))
    for i in range(B):
        want = jda.resize_fixed(jnp.asarray(flat[i]), D,
                                flip=jnp.asarray(flips[i]))
        assert np.array_equal(got[i].numpy(), np.asarray(want))
        want = jda.center_crop_resize(jnp.asarray(flat[i]), 24, D)
        assert np.array_equal(
            da.center_crop_resize(_t(flat), 24, D)[i].numpy(),
            np.asarray(want))
    assert np.array_equal(da._cv2_nearest_idx(13, 57),
                          jda._cv2_nearest_idx(13, 57))


@pytest.mark.parametrize("five", [False, True])
def test_test_preprocess_batch(five):
    clips = _clips(2)
    got = da.test_preprocess_batch(_t(clips), D, 32, five_crop=five,
                                   normalize_out=False)
    want = jda.test_preprocess_batch(jnp.asarray(clips), D, 32,
                                     five_crop=five, normalize_out=False)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))
    _close(da.test_preprocess_batch(_t(clips), D, 32, five_crop=five),
           jda.test_preprocess_batch(jnp.asarray(clips), D, 32,
                                     five_crop=five))


@pytest.mark.parametrize("flip", [None, True, False])
def test_random_resized_crop(flip):
    clips = _clips(3).reshape(B, N * SL, H, W, 3)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    crops = np.stack([np.asarray(_jax_crop(k, H, W)) for k in keys])
    got = da.random_resized_crop(
        _t(clips), _t(crops).long(), D,
        flip=None if flip is None else torch.tensor([flip, not flip]))
    for i in range(B):
        want = jda.random_resized_crop(
            keys[i], jnp.asarray(clips[i]), D,
            flip=None if flip is None else jnp.asarray([flip, not flip][i]))
        _close(got[i] / 255.0, np.asarray(want) / 255.0)


def test_gray_jitter_and_normalize():
    x = np.random.default_rng(5).random((B, N * SL, 12, 10, 3),
                                        dtype=np.float32)
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    draws = _pretrain_draws(jax.random.PRNGKey(6), N * SL, 12, 10,
                            "crop_resize")
    gray = da.random_gray(_t(x), draws.gray, draws.gray_chan)
    jit = da.color_jitter(_t(x), draws.jitter)
    flip = da.random_hflip(_t(x), draws.flip)
    for i in range(B):
        kc, kf, kg, kj = jax.random.split(keys[i], 4)
        assert np.array_equal(gray[i].numpy(), np.asarray(
            jda.random_gray(kg, jnp.asarray(x[i]), p=0.5, per_frame=True)))
        _close(jit[i], jda.color_jitter(kj, jnp.asarray(x[i]),
                                        per_frame=True))
        assert np.array_equal(flip[i].numpy(), np.asarray(
            jda.random_hflip(kf, jnp.asarray(x[i]))))
    _close(da.normalize(_t(x)), jda.normalize(jnp.asarray(x)), tol=0)


@pytest.mark.parametrize("recipe,h,w", [("sized_crop", H, W),
                                        ("crop_resize", 36, 36)])
@pytest.mark.parametrize("normalize_out", [True, False])
def test_augment_batch(recipe, h, w, normalize_out):
    clips = _clips(7, h, w)
    key = jax.random.PRNGKey(8)
    got = da.augment_batch(_t(clips),
                           _pretrain_draws(key, N * SL, h, w, recipe), D,
                           recipe=recipe, normalize_out=normalize_out)
    want = jda.augment_batch(key, jnp.asarray(clips), D, recipe=recipe,
                             normalize_out=normalize_out)
    assert got.shape == (B, N, SL, D, D, 3) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_finetune_augment_batch(mode):
    clips = _clips(9)
    for seed in range(3):  # the val recipe's crop and jitter gates vary
        key = jax.random.PRNGKey(10 + seed)
        got = da.finetune_augment_batch(
            _t(clips), _finetune_draws(key, H, W, mode), D, mode=mode)
        want = jda.finetune_augment_batch(key, jnp.asarray(clips), D,
                                          mode=mode)
        _close(got, want)


# the policy and the geometry ----------------------------------------------

@pytest.mark.parametrize("fold", ["auto", "on", "off"])
@pytest.mark.parametrize("device_augment", [False, True])
def test_resolve_fold_and_geometry_match(fold, device_augment):
    for ours, ref in ((TrainConfig(device_augment=device_augment,
                                   fold_normalize=fold),
                       JaxTrainConfig(device_augment=device_augment,
                                      fold_normalize=fold)),
                      (EvalConfig(device_augment=device_augment,
                                  fold_normalize=fold),
                       JaxEvalConfig(device_augment=device_augment,
                                     fold_normalize=fold))):
        for dense in (False, True):
            a, b = da.resolve_fold(ours, dense), jda.resolve_fold(ref, dense)
            assert a[0] == b[0] and (a[1] is None) == (b[1] is None)
            if a[1] is not None:
                assert a[1][2] == b[1][2]
                assert np.array_equal(a[1][0], b[1][0])
                assert np.array_equal(a[1][1], b[1][1])
    for ds in ("ucf101", "hmdb51", "k400", "synthetic"):
        for img_dim in (64, 128, 224):
            assert da.dense_test_crop(ds, img_dim) == \
                jda.dense_test_crop(ds, img_dim)
            for task in ("pretrain", "finetune", "test", "test_five"):
                assert da.device_augment_geometry(ds, img_dim, task) == \
                    jda.device_augment_geometry(ds, img_dim, task)
    with pytest.raises(ValueError):
        da.resolve_fold(TrainConfig(fold_normalize="maybe"))


# the draws ----------------------------------------------------------------

def test_draw_statistics():
    """Ranges, and means within 4 sigma over a few thousand draws."""
    gen = torch.Generator().manual_seed(0)
    n, frames, h, w = 4000, 2, 240, 320
    d = da.draw_pretrain(gen, n, frames, h, w, "sized_crop")

    def near(x, mean, sd, count):
        assert abs(float(x.double().mean()) - mean) < 4 * sd / math.sqrt(
            count), (float(x.double().mean()), mean)

    near(d.flip, 0.5, 0.5, n)
    near(d.gray, 0.5, 0.5, n * frames)
    assert set(d.gray_chan.unique().tolist()) == {0, 1, 2}
    near(d.gray_chan, 1.0, math.sqrt(2 / 3), n * frames)
    x0, y0, cw, ch = d.crop.unbind(-1)
    assert (cw >= 8).all() and (cw <= w).all() and (ch <= h).all()
    assert (x0 >= 0).all() and (x0 + cw <= w).all() and (y0 + ch <= h).all()
    fb, fc, fs, fh = d.jitter.unbind(-1)
    for f in (fb, fc, fs):
        assert f.min() >= 0.5 and f.max() <= 1.5
        near(f, 1.0, 1 / math.sqrt(12), n * frames)
    assert fh.abs().max() <= 0.25
    near(fh, 0.0, 0.5 / math.sqrt(12), n * frames)
    area = (cw * ch).double() / (h * w)
    assert 0.45 < float(area.mean()) < 0.8   # area ~ U(0.5, 1), truncated
    v = da.draw_finetune(gen, n, h, w, "val")
    near(v.crop_p, 0.3, math.sqrt(0.21), n)
    near(v.jitter_p, 0.3, math.sqrt(0.21), n)
    assert v.jitter.shape == (n, 1, 4) and v.jitter[..., 3].abs().max() <= .1
    g1 = da.draw_pretrain(torch.Generator().manual_seed(5), 4, 3, h, w)
    g2 = da.draw_pretrain(torch.Generator().manual_seed(5), 4, 3, h, w)
    assert all(torch.equal(getattr(g1, k), getattr(g2, k))
               for k in ("flip", "crop", "gray", "gray_chan", "jitter"))


# the stem's normalize fold ------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_conv3d_input_norm(scale):
    rng = np.random.default_rng(11)
    conv = layers.conv3d(3, 8, (1, 7, 7), (1, 2, 2), (0, 3, 3))
    if scale == 255.0:
        x = rng.integers(0, 256, size=(2, 3, 2, 20, 18)).astype(np.uint8)
    else:
        x = rng.random((2, 3, 2, 20, 18), dtype=np.float32)
    norm = (da.IMAGENET_MEAN, da.IMAGENET_STD, scale)
    got = layers.conv3d_input_norm(conv, _t(x), norm).detach()
    # against normalise-then-conv, in f64 for the reference value
    mean = _t(da.IMAGENET_MEAN).double().view(1, 3, 1, 1, 1)
    std = _t(da.IMAGENET_STD).double().view(1, 3, 1, 1, 1)
    xn = (_t(x).double() / scale - mean) / std
    want = F.conv3d(xn, conv.weight.double(), None, conv.stride,
                    conv.padding)
    assert got.dtype == torch.float32
    rel = float((got.double() - want).abs().max() / want.abs().max())
    assert rel <= 2e-6, rel
    # against dpc_tpu's fold on the same weights (NDHWC × DHWIO there)
    w_jax = np.transpose(conv.weight.detach().numpy(), (2, 3, 4, 1, 0))
    assert np.array_equal(_CONVERT["conv3d"](w_jax),
                          conv.weight.detach().numpy())
    ref = jax_layers.conv3d_input_norm(
        {"w": jnp.asarray(w_jax)}, jnp.asarray(np.moveaxis(x, 1, -1)),
        (1, 2, 2), (0, 3, 3), None, norm)
    ref = np.moveaxis(np.asarray(ref), -1, 1)
    rel = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
    assert rel <= 1e-5, rel
