"""Pure shape algebra shared by the model, the data pipeline and the tests.

These are the deterministic, device-free index/shape functions the reference
only exercises implicitly at runtime: the backbone's stride plan
(``backbone/resnet_2d3d.py:211-222``), the derived feature-map extents
(``dpc/model_3d.py:24-25``), and the clip-sampler index lattice
(``dpc/dataset_3d.py:88-95``).
"""

from __future__ import annotations

import math

import numpy as np


def conv_out_len(n: int, kernel: int, stride: int, padding: int) -> int:
    """Output length of a strided convolution / pooling window."""
    return (n + 2 * padding - kernel) // stride + 1


def backbone_out_shape(img_dim: int, seq_len: int) -> tuple[int, int]:
    """(temporal, spatial) extent of the 2d3d-ResNet output.

    Stem: spatial stride 2 (conv k7 s2 p3) then maxpool (1,3,3)/(1,2,2);
    no temporal stride.  Stages: layer2/3/4 spatially stride 2; layer3/4
    (the 3D stages) also stride time by 2.  Net: space /32, time /4 with
    ceil semantics (conv k3 s2 p1 ⇒ ceil(n/2)).
    """
    t = seq_len
    s = img_dim
    s = conv_out_len(s, 7, 2, 3)      # stem conv
    s = conv_out_len(s, 3, 2, 1)      # stem maxpool
    s = conv_out_len(s, 3, 2, 1)      # layer2
    for _ in range(2):                # layer3, layer4: 3D stages
        s = conv_out_len(s, 3, 2, 1)
        t = conv_out_len(t, 3, 2, 1)
    return t, s


def last_duration(seq_len: int) -> int:
    """Matches ``dpc/model_3d.py:24`` — and the true backbone math."""
    return int(math.ceil(seq_len / 4))


def last_size(img_dim: int) -> int:
    """Matches ``dpc/model_3d.py:25`` — and the true backbone math."""
    return int(math.ceil(img_dim / 32))


def clip_block_indices(start: int | np.ndarray, num_seq: int, seq_len: int,
                       downsample: int) -> np.ndarray:
    """Frame-index lattice for one sampled clip.

    ``out[n, s] = start + n*downsample*seq_len + s*downsample`` — ``num_seq``
    back-to-back blocks of ``seq_len`` frames at temporal stride
    ``downsample``.  Reference: ``dpc/dataset_3d.py:92-94``.
    """
    n = np.arange(num_seq)[:, None] * (downsample * seq_len)
    s = np.arange(seq_len)[None, :] * downsample
    return np.asarray(start) + n + s


def clip_span(num_seq: int, seq_len: int, downsample: int) -> int:
    """Number of source frames a clip spans; videos shorter than this are
    filtered out (``dpc/dataset_3d.py:76-82``)."""
    return num_seq * seq_len * downsample


def sample_clip_start(rng: np.random.Generator, vlen: int, num_seq: int,
                      seq_len: int, downsample: int) -> int | None:
    """Uniform random clip start, or None if the video is too short.

    Reference ``idx_sampler`` (``dpc/dataset_3d.py:88-95``) draws
    ``start ∈ [0, vlen − span − 1]`` — ``np.random.choice(range(n))`` is
    end-EXCLUSIVE, and a video of exactly span length returns None, like
    the reference's vlen−span ≤ 0 drop.  (``rng.integers`` below is also
    end-exclusive; "fixing" either to include the endpoint would break
    parity with the reference sampler.)
    """
    span = clip_span(num_seq, seq_len, downsample)
    if vlen - span <= 0:
        return None
    return int(rng.integers(0, vlen - span))


def test_time_windows(vlen: int, num_seq: int, seq_len: int, downsample: int,
                      window_stride: int,
                      tail_window: bool = False) -> np.ndarray:
    """Dense test-time sampling: all frames at stride ``downsample``, chopped
    into non-overlapping seq_len blocks, then overlapping windows of
    ``num_seq`` blocks at ``window_stride`` blocks apart.

    Returns an int array ``[num_windows, num_seq, seq_len]`` of frame
    indices.  Reference: ``eval/dataset_3d_lc.py:76-78,109-125`` (UCF uses
    window_stride=num_seq//2, HMDB 3*num_seq//4).  The reference's window
    starts are exactly ``range(0, num_blocks - num_seq + 1, stride)``
    (``:124`` — no tail window), and the default reproduces that;
    ``tail_window=True`` opts into also evaluating a final window flush
    with the last block so trailing frames are never dropped (PARITY.md
    #11).  The short-video pad path is only reachable when the caller
    keeps videos shorter than one clip span (PARITY.md #10) — the
    reference filters them out of every split (``eval/dataset_3d_lc.py:
    61-67``).
    """
    all_idx = np.arange(0, vlen, downsample)
    num_blocks = len(all_idx) // seq_len
    if num_blocks < num_seq:
        # short video: single window, clamp by repeating the last block
        blocks = all_idx[: num_blocks * seq_len].reshape(num_blocks, seq_len)
        if num_blocks == 0:
            blocks = np.zeros((1, seq_len), dtype=np.int64)
            num_blocks = 1
        pad = np.repeat(blocks[-1:], num_seq - num_blocks, axis=0)
        return np.concatenate([blocks, pad], axis=0)[None]
    blocks = all_idx[: num_blocks * seq_len].reshape(num_blocks, seq_len)
    starts = list(range(0, num_blocks - num_seq + 1, max(1, window_stride)))
    if tail_window and starts[-1] != num_blocks - num_seq:
        starts.append(num_blocks - num_seq)
    return np.stack([blocks[s: s + num_seq] for s in starts])
