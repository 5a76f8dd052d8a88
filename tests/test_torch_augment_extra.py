"""The host augment ops no recipe uses, against ``dpc_tpu``'s with the same
``np.random.Generator`` draws: ``RandomRotation`` and ``RandomCrop``'s
optical-flow proposals.

``dpc_tpu`` rotates with ``cv2.warpAffine`` (fixed-point coordinates and
weights); the port's float64 inverse-map warp may round a value one grey
level the other way.  So: equal canvas shapes and draws, every value within
one level, at most 0.1% of the uint8 values off (0.02-0.06% on uniform
noise), and an exact match at 0°.  The flow crop copies windows and must be
exact.
"""

import numpy as np
import pytest

from dpc_tpu.data import augment as jax_augment
from dpc_tpu_torch.data import augment

MAX_OFF = 1e-3   # share of uint8 values one level apart


def _noise(t, h, w, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (t, h, w, 3), dtype=np.uint8)


def _both(make, clip, seed, **kw):
    """The op of each package on ``clip`` from generators seeded alike;
    the outputs and each generator's next draw."""
    out = []
    for mod in (augment, jax_augment):
        rng = np.random.default_rng(seed)
        out.append((make(mod)(clip, rng, **kw), rng.random()))
    return out


@pytest.mark.parametrize("hw", [(64, 80), (240, 320)])
@pytest.mark.parametrize("consistent", [True, False])
def test_rotation_matches_opencv(hw, consistent):
    clip = _noise(4 if consistent else 3, *hw, seed=hw[0])
    for seed in range(4):
        (got, nxt), (want, want_nxt) = _both(
            lambda m: m.RandomRotation(consistent=consistent, degree=15),
            clip, seed)
        assert nxt == want_nxt                       # the same draws
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - want)
        assert diff.max() <= 1
        assert (diff > 0).mean() <= MAX_OFF, (diff > 0).mean()


def test_rotation_exact_at_zero_degrees():
    clip = _noise(3, 64, 80, seed=1)
    got = augment._rotate_expand(clip, 0.0)
    np.testing.assert_array_equal(got, clip)
    # degree=1 draws from [-1, 1): 0 on some seeds
    zero = 0
    for seed in range(6):
        (got, _), (want, _) = _both(
            lambda m: m.RandomRotation(consistent=True, degree=1),
            clip, seed)
        if want.shape == clip.shape:
            np.testing.assert_array_equal(got, want)
            zero += 1
    assert zero


def test_rotation_p_gate_skips_on_the_same_draws():
    clip = _noise(2, 32, 40)
    for seed in range(8):
        (got, nxt), (want, want_nxt) = _both(
            lambda m: m.RandomRotation(consistent=False, degree=10, p=0.5),
            clip, seed)
        assert nxt == want_nxt and got.shape == want.shape
        if want is clip:
            assert got is clip
        else:
            assert np.abs(got.astype(np.int16) - want).max() <= 1


@pytest.mark.parametrize("num_proposals", [1, 3, 8])
def test_flow_guided_crop_exact(num_proposals):
    clip = _noise(5, 64, 72, seed=num_proposals)
    flow = np.zeros((5, 64, 72, 2), np.float32)
    flow[:, 44:, 50:] = 10.0        # one moving corner
    flow[2, :20, :20] = -3.0        # and, on one frame, a weaker one
    for seed in range(3):
        (got, nxt), (want, want_nxt) = _both(
            lambda m: m.RandomCrop(20, consistent=False,
                                   num_proposals=num_proposals),
            clip, seed, flowmap=flow)
        assert nxt == want_nxt
        np.testing.assert_array_equal(got, want)
    with pytest.raises(AssertionError):
        augment.RandomCrop(20, consistent=True)(
            clip, np.random.default_rng(0), flowmap=flow)
