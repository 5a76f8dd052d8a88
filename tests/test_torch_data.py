"""The port's numpy copies of the synthetic pretraining data path against
dpc_tpu's: the same clips from the same seeds.

The port resizes in numpy with OpenCV's pixel-centre conventions instead of
calling OpenCV, so a bilinear resize may differ by one grey level where
OpenCV's fixed-point rounding lands the other way; after Normalize that is
at most 1/(255·0.224) ≈ 0.0176.  The crop draws must be identical.
"""

import numpy as np
import pytest

from dpc_tpu.data import augment as jax_augment
from dpc_tpu.data.synthetic import SyntheticVideoDataset as JaxSynthetic
from dpc_tpu_torch.data import augment
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
