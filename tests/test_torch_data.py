"""The port's data path against dpc_tpu's: the synthetic clips, the JPEG
codec (decode bit-equal to ``dpc_tpu.native``), every host transform and
recipe, and the frame dataset, with the same ``np.random.Generator`` draws.

The port resizes in numpy with OpenCV's pixel-centre conventions instead of
calling OpenCV, so a bilinear resize may differ by one grey level where
OpenCV's fixed-point rounding lands the other way; after Normalize that is
at most 1/(255·0.224) ≈ 0.0176.  The crop draws must be identical.
"""

import os

import numpy as np
import pytest

from dpc_tpu import native as jax_native
from dpc_tpu.data import augment as jax_augment
from dpc_tpu.data import video_dataset as jax_vd
from dpc_tpu.data.synthetic import SyntheticVideoDataset as JaxSynthetic
from dpc_tpu_torch import native
from dpc_tpu_torch.core import shapes
from dpc_tpu_torch.data import augment, video_dataset
from dpc_tpu_torch.data.frame_tree import write_frame_tree
from dpc_tpu_torch.data.synthetic import SyntheticVideoDataset

ONE_LEVEL = 1.0 / (255.0 * 0.224) + 1e-5


@pytest.mark.parametrize("size,interp", [(32, "bilinear"), (128, "bilinear"),
                                         (48, "nearest")])
def test_resize_matches_opencv(size, interp):
    clip = np.random.default_rng(size).integers(
        0, 256, size=(3, 97, 130, 3)).astype(np.uint8)
    got = augment._resize_clip(clip, (size, size), interp)
    want = jax_augment._resize_clip(clip, (size, size), interp)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_synthetic_clips_match_jax():
    kw = dict(num_videos=4, video_len=64, frame_size=130, num_seq=3,
              seq_len=4, downsample=2)
    ours = SyntheticVideoDataset(transform=augment.Compose([
        augment.RandomSizedCrop(size=32, p=1.0), augment.Normalize()]), **kw)
    ref = JaxSynthetic(transform=jax_augment.Compose([
        jax_augment.RandomSizedCrop(size=32, consistent=True, p=1.0),
        jax_augment.Normalize()]), **kw)
    for i in range(4):
        a = ours.sample(i, np.random.default_rng((0, i)))
        b = ref.sample(i, np.random.default_rng((0, i)))
        assert a.shape == b.shape == (3, 4, 32, 32, 3)
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=ONE_LEVEL)


# ---------------------------------------------------------------------------
# The frame pipeline: codec, transforms and the frame dataset
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_frame_tree(str(tmp_path_factory.mktemp("frames")),
                            num_videos=3, num_frames=40, num_classes=8,
                            train_rows=3, test_rows=6, workers=3)


def _frames(tree):
    d = os.path.join(tree, "ucf101", "frame", "class002",
                     "v_class002_g02_c01")
    return [os.path.join(d, f"image_{i:05d}.jpg") for i in (1, 17, 40)]


def test_decode_is_bit_equal_to_dpc_tpu(tree):
    paths = _frames(tree)
    for p in paths:
        got = native.decode_file(p)
        assert got.shape == (240, 320, 3) and got.dtype == np.uint8
        assert np.array_equal(got, jax_native.decode_file(p))
        for hw in ((128, 171), (100, 100)):  # DCT scaling + bilinear
            assert np.array_equal(native.decode_file(p, hw),
                                  jax_native.decode_file(p, hw))
    buffers = [open(p, "rb").read() for p in paths]
    batch, failures = native.decode_jpeg_batch(buffers, 240, 320, threads=2)
    assert failures == 0
    assert np.array_equal(batch, np.stack([jax_native.decode_file(p)
                                           for p in paths]))
    bad, failures = native.decode_jpeg_batch([b"not a jpeg"], 8, 8)
    assert failures == 1 and not bad.any()
    with pytest.raises(ValueError):
        native.jpeg_dims(b"not a jpeg")


def test_encoder_round_trip():
    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1).astype(np.uint8)
    data = native.encode_jpeg(img, quality=95)
    assert data[:2] == b"\xff\xd8" and native.jpeg_dims(data) == (48, 64)
    back = native.decode_jpeg(data)
    assert np.abs(back.astype(int) - img).mean() < 2.0
    with pytest.raises(ValueError):
        native.encode_jpeg(img.astype(np.float32))


def _clip(seed=0, t=6, h=240, w=320):
    """Smooth moving content with a few near-grey regions (where the hue
    wheel is least stable)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(t):
        r = 128 + 100 * np.sin((xx + 7 * i) / 23.0 + seed)
        g = 128 + 90 * np.cos((yy - 5 * i) / 31.0)
        b = 128 + 60 * np.sin((xx + yy) / 17.0 + i)
        frames.append(np.stack([r, g, b], -1))
    clip = np.stack(frames)
    clip[:, :40, :40] = clip[:, :40, :40].mean(-1, keepdims=True)
    return np.clip(clip, 0, 255).astype(np.uint8)


def _ops(mod):
    """(name, transform) pairs with the same construction in both
    packages."""
    return {
        "padding": mod.Padding(3),
        "scale_fixed": mod.Scale(size=(96, 80)),
        "random_crop": mod.RandomCrop(224, consistent=True),
        "random_crop_per_frame": mod.RandomCrop(200, consistent=False),
        "crop_with_prob": mod.RandomCropWithProb(224, p=0.5),
        "crop_with_prob_per_frame": mod.RandomCropWithProb(
            180, p=0.5, consistent=False),
        "flip": mod.RandomHorizontalFlip(consistent=True),
        "flip_per_frame": mod.RandomHorizontalFlip(consistent=False),
        "gray": mod.RandomGray(consistent=True, p=0.7),
        "gray_per_frame": mod.RandomGray(consistent=False, p=0.5),
        "jitter": mod.ColorJitter(0.5, 0.5, 0.5, 0.25, consistent=True),
        "jitter_per_frame": mod.ColorJitter(0.5, 0.5, 0.5, 0.25,
                                            consistent=False, p=1.0),
        "jitter_val": mod.ColorJitter(0.2, 0.2, 0.2, 0.1, consistent=True,
                                      p=0.3),
    }


def _same_hue(monkeypatch):
    """Put dpc_tpu's OpenCV hue shift in place of the port's.  The port's
    is held to one level of it on every colour by
    test_color_adjustments_match_opencv, but a later contrast or saturation
    step, or a hue taken near grey, can amplify that one level; with the
    hue shared, every other op must match exactly."""
    monkeypatch.setitem(augment._FRAME_OPS, "hue", lambda frames, factors: (
        np.stack([jax_augment.adjust_hue(f, x)
                  for f, x in zip(frames, factors)])))


@pytest.mark.parametrize("name", sorted(_ops(augment)))
def test_transform_matches_dpc_tpu(name, monkeypatch):
    """The same draws in the same order, and the same pixels."""
    _same_hue(monkeypatch)
    ours, ref = _ops(augment)[name], _ops(jax_augment)[name]
    for seed in range(4):
        clip = _clip(seed)
        ra, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        a, b = ours(clip, ra), ref(clip, rj)
        assert ra.bit_generator.state == rj.bit_generator.state
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert np.array_equal(a, b)


@pytest.mark.parametrize("fn", ["brightness", "contrast", "saturation",
                                "hue"])
def test_color_adjustments_match_opencv(fn):
    """One colour in 27 of all 2^24 (every third level per channel, grey
    included) through each adjustment: brightness, contrast and saturation
    equal to dpc_tpu's OpenCV path, the hue shift within one level (its
    float32 sector rounds the other way on about 1 pixel in 10^5)."""
    levels = np.arange(0, 256, 3)
    colours = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                       -1).reshape(len(levels) ** 2, len(levels), 3)
    colours = colours.astype(np.uint8)
    ours = getattr(augment, f"adjust_{fn}")
    ref = getattr(jax_augment, f"adjust_{fn}")
    for factor in ((-0.25, 0.1, 0.49) if fn == "hue" else (0.3, 0.77, 1.4)):
        d = np.abs(ours(colours, factor).astype(int)
                   - ref(colours, factor).astype(int))
        if fn == "hue":
            assert d.max() <= 1 and (d > 0).mean() < 1e-4, (factor, d.max())
        else:
            assert d.max() == 0, factor


@pytest.mark.parametrize("recipe", ["pretrain_ucf101", "pretrain_k400",
                                    "finetune_train", "finetune_val",
                                    "finetune_test"])
def test_recipes_match_dpc_tpu(recipe, monkeypatch):
    """The recipes draw what dpc_tpu's draw.  The hue shift and, where a
    recipe resizes bilinearly ahead of the colour jitter, the resize are
    dpc_tpu's (each held to one level on its own: see _same_hue and
    test_resize_matches_opencv), so the rest must match to Normalize's
    float rounding (dpc_tpu's fused cv2.transform, within 5e-7)."""
    _same_hue(monkeypatch)
    kind, arg = recipe.split("_")
    if kind == "pretrain":
        ours = augment.pretrain_transform(arg, 64)
        ref = jax_augment.pretrain_transform(arg, 64)
    else:
        ours = augment.finetune_transform(64, arg)
        ref = jax_augment.finetune_transform(64, arg)
    if recipe in ("pretrain_k400", "finetune_train", "finetune_val"):
        monkeypatch.setattr(augment, "_resize_clip",
                            jax_augment._resize_clip)
    for seed in range(3):
        clip = _clip(seed)
        ra, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        a, b = ours(clip, ra), ref(clip, rj)
        assert ra.bit_generator.state == rj.bit_generator.state
        assert a.shape == b.shape == (6, 64, 64, 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert augment.frame_consistent(ours) == jax_augment.frame_consistent(ref)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_frame_dataset_matches_dpc_tpu(tree, mode, monkeypatch):
    """make_dataset and FrameClipDataset.sample against dpc_tpu's on the
    same tree: the same records, labels and frame draws, and the same
    decoded and transformed pixels (the hue shift shared, as above)."""
    _same_hue(monkeypatch)
    kw = dict(num_seq=2, seq_len=3, downsample=2)
    if mode == "train":
        tfs = (augment.pretrain_transform("ucf101", 32),
               jax_augment.pretrain_transform("ucf101", 32))
    else:
        tfs = (augment.finetune_transform(32, "test"),
               jax_augment.finetune_transform(32, "test"))
    ours = video_dataset.make_dataset("ucf101", tree, mode, tfs[0],
                                      return_label=True, **kw)
    ref = jax_vd.make_dataset("ucf101", tree, mode, tfs[1],
                              return_label=True, **kw)
    assert [(r.path, r.num_frames, r.label) for r in ours.records] == \
        [(r.path, r.num_frames, r.label) for r in ref.records]
    assert len(ours) == {"train": 3, "val": 2, "test": 6}[mode]
    assert ours.window_stride == ref.window_stride
    for i in range(len(ours)):
        ra, rj = np.random.default_rng(i), np.random.default_rng(i)
        (a, la), (b, lb) = ours.sample(i, ra), ref.sample(i, rj)
        assert ra.bit_generator.state == rj.bit_generator.state
        assert la == lb == ours.records[i].label >= 0
        assert a.shape == b.shape and a.dtype == np.float32
        if mode == "test":
            assert a.shape[1:] == (2, 3, 32, 32, 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The host half of --device_augment: the ROI decode, HostScaleCrop, the
# five-crop ops and the planned dataset sample
# ---------------------------------------------------------------------------


def test_scale_crop_decode_is_bit_equal_to_dpc_tpu(tree):
    paths = _frames(tree)
    buffers = [open(p, "rb").read() for p in paths]
    # scale 1 (the UCF short side), DCT-scaled + bilinear, off-centre
    for short, crop in ((240, (8, 50, 224, 224)), (128, (0, 21, 128, 128)),
                        (150, (3, 40, 120, 150))):
        got, failures = native.decode_jpeg_batch_scale_crop(
            buffers, short, crop, threads=2)
        assert failures == 0 and got.shape == (3, *crop[2:], 3)
        want = np.stack([jax_native.decode_jpeg_scale_crop(b, short, crop)
                         for b in buffers])
        assert np.array_equal(got, want), (short, crop)
        assert np.array_equal(native.decode_jpeg_scale_crop(
            buffers[1], short, crop), want[1])
    full = native.decode_jpeg(buffers[0])
    assert np.array_equal(native.decode_jpeg_scale_crop(
        buffers[0], 240, (8, 50, 224, 224)), full[8:232, 50:274])
    with pytest.raises(ValueError, match="outside"):
        native.decode_jpeg_scale_crop(buffers[0], 240, (20, 0, 224, 224))
    bad, failures = native.decode_jpeg_batch_scale_crop(
        [b"not a jpeg", buffers[0]], 240, (0, 0, 8, 8))
    assert failures == 1 and not bad[0].any() and bad[1].any()


@pytest.mark.parametrize("center", [False, True])
def test_host_scale_crop_matches_dpc_tpu(center):
    for short, win, src in ((240, (224, 224), (240, 320)),
                            (128, (128, 170), (240, 320)),
                            (240, (240, 320), (240, 320)),
                            (240, (224, 224), (320, 200))):  # portrait
        ours = augment.HostScaleCrop(short, win, center=center)
        ref = jax_augment.HostScaleCrop(short, win, center=center)
        for seed in range(3):
            ra, rj = np.random.default_rng(seed), np.random.default_rng(seed)
            assert ours.plan(src, ra) == ref.plan(src, rj)
            assert ra.bit_generator.state == rj.bit_generator.state
    clip = _clip(0)
    ours = augment.HostScaleCrop(240, (224, 224), center=center)
    ref = jax_augment.HostScaleCrop(240, (224, 224), center=center)
    ra, rj = np.random.default_rng(4), np.random.default_rng(4)
    assert np.array_equal(ours(clip, ra), ref(clip, rj))  # scale 1
    small = _clip(1, h=100, w=180)                        # pad + scale
    ra, rj = np.random.default_rng(4), np.random.default_rng(4)
    a = augment.HostScaleCrop(120, (120, 200))(small, ra)
    b = jax_augment.HostScaleCrop(120, (120, 200))(small, rj)
    assert a.shape == b.shape == (6, 120, 200, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert augment.frame_consistent(ours)


def test_five_crop_pad_and_per_crop_match_dpc_tpu():
    clip = _clip(2)
    for ours, ref in ((augment.FiveCrop(200), jax_augment.FiveCrop(200)),
                      (augment.FiveCrop((100, 180)),
                       jax_augment.FiveCrop((100, 180))),
                      (augment.PadTo(260, 330), jax_augment.PadTo(260, 330)),
                      (augment.PadTo(200, 300), jax_augment.PadTo(200, 300)),
                      (augment.Compose([augment.FiveCrop(224), augment.PerCrop(
                          augment.Scale(size=(64, 64)))]),
                       jax_augment.Compose([jax_augment.FiveCrop(224),
                                            jax_augment.PerCrop(
                           jax_augment.Scale(size=(64, 64)))]))):
        a, b = ours(clip, None), ref(clip, None)
        assert a.shape == b.shape and np.array_equal(a, b)
    ours = augment.finetune_transform(64, "test", five_crop=True)
    ref = jax_augment.finetune_transform(64, "test", five_crop=True)
    a, b = ours(clip), ref(clip)
    assert a.shape == b.shape == (5, 6, 64, 64, 3)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert augment.frame_consistent(ours) and jax_augment.frame_consistent(ref)
    with pytest.raises(ValueError):
        augment.FiveCrop(300)(clip)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_planned_sample_matches_full_decode(tree, mode):
    """The ROI-decoded sample of a HostScaleCrop dataset at scale 1 equals
    the full decode plus the numpy geometry, draws included, and dpc_tpu's
    planned sample; the dense test's dedupe and inverse gather too."""
    kw = dict(num_seq=2, seq_len=3, downsample=2)
    host = augment.HostScaleCrop(240, (224, 224), center=mode == "test")
    ours = video_dataset.make_dataset("ucf101", tree, mode, host, **kw)
    ref = jax_vd.make_dataset("ucf101", tree, mode, jax_augment.HostScaleCrop(
        240, (224, 224), center=mode == "test"), **kw)
    for i in range(2):
        a = ours.sample(i, np.random.default_rng(i))
        b = ref.sample(i, np.random.default_rng(i))
        ra = np.random.default_rng(i)
        record = ours.records[i]
        if mode == "test":
            assert a.ndim == 6 and a.shape[1:] == (2, 3, 224, 224, 3)
            idx = shapes.test_time_windows(
                record.num_frames, 2, 3, 2, ours.window_stride)
        else:
            start = shapes.sample_clip_start(ra, record.num_frames, 2, 3, 2)
            idx = shapes.clip_block_indices(start, 2, 3, 2)
        full = host(ours._load_frames(record, idx), ra)
        assert a.dtype == np.uint8 and np.array_equal(a, b)
        assert np.array_equal(a.reshape(full.shape), full)
    assert ours.planned_fallbacks() == {"unplanned": 0, "undecoded": 0}
    # a window the plan declines (it needs the reflect pad) is counted
    tall = augment.HostScaleCrop(240, (250, 224))
    ds = video_dataset.make_dataset("ucf101", tree, "train", tall, **kw)
    assert ds.sample(0, np.random.default_rng(0)).shape[-3:] == (250, 224, 3)
    assert video_dataset.count_fallbacks(ours, ds) == {"unplanned": 1,
                                                       "undecoded": 0}


def test_process_workers_send_their_fallbacks_back(tree):
    """A planned-decode fallback made in a process worker reaches the
    parent dataset's count, one per sample the loader yielded."""
    from dpc_tpu_torch.data.loader import ClipLoader

    tall = augment.HostScaleCrop(240, (250, 224))
    ds = video_dataset.make_dataset("ucf101", tree, "train", tall, num_seq=2,
                                    seq_len=3, downsample=2)
    loader = ClipLoader(ds, 1, num_workers=1, worker_mode="process", seed=0)
    try:
        got = list(loader)
    finally:
        loader.close(wait=True)
    assert len(got) == len(ds) == 3
    assert video_dataset.count_fallbacks(ds) == {"unplanned": 3,
                                                 "undecoded": 0}


def test_loader_fills_batches_in_place_under_contention():
    """More workers than cores and a short switch interval: every batch the
    workers fill in place holds exactly its positions' samples and labels,
    in order, and stopping early returns at once."""
    import sys
    import threading

    from dpc_tpu_torch.data.loader import ClipLoader

    class Items:
        def __len__(self):
            return 96

        def sample(self, i, rng):
            return (np.full((4, 8), i, np.int64)
                    + 1000 * int(rng.integers(0, 1000))), i % 7

    loader = ClipLoader(Items(), 6, num_workers=32, seed=5,
                        prefetch_batches=2)
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        worker = threading.Thread(target=lambda: got.extend(loader))
        worker.start()
        worker.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not worker.is_alive() and len(got) == 16
    order = loader._order()
    for b, (clips, labels) in enumerate(got):
        for slot in range(6):
            pos = b * 6 + slot
            rng = np.random.default_rng((5, 0, pos))
            want, label = Items().sample(int(order[pos]), rng)
            assert np.array_equal(clips[slot], want) and labels[slot] == label
    it = loader.iterate(2)
    clips, _ = next(it)
    assert np.array_equal(clips[0] % 1000, np.full((4, 8), order[12]))
    it.close()  # stops the producer without waiting for its batches
