"""Multi-temporal-scale clip sampling: index math (numpy only).

The port's own copy of ``lrce_tpu/data/sampling.py``, the same indices for
the same arguments: the sampler is factored into index computation so the
host pipeline decodes only the frames it needs.

For each scale s:
    step        = max(1, max(1, N // frames_per_clip) // s)
    pool        = indices[step//2 :: step]
    inner_step  = (len(pool) - frames_per_clip) // (s - 1)   (0 when s == 1)
    clip i      = pool[i*inner_step : i*inner_step + frames_per_clip]

Output: (sum(scales), frames_per_clip) frame indices.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

# Scale -> row indices into a [1,2,3,4]-sampled clip bank, used by the
# precomputed-frames path.
SCALE_IDX_DICT = {1: [0], 2: [1, 2], 3: [3, 4, 5], 4: [5, 6, 7, 8]}


def build_scale_idx(temporal_scale: Sequence[int]) -> List[int]:
    idx: List[int] = []
    for scale in temporal_scale:
        idx += SCALE_IDX_DICT[scale]
    return idx


def clip_indices(num_frames: int, frames_per_clip: int = 5,
                 temporal_scale: Sequence[int] = (1, 2, 3)) -> np.ndarray:
    """Frame indices for every clip at every scale.

    Raises ValueError when the video is too short.
    """
    if num_frames < frames_per_clip:
        raise ValueError(
            f"Video has {num_frames} frames < frames_per_clip={frames_per_clip}")

    all_clips: List[np.ndarray] = []
    for scale in temporal_scale:
        step = max(1, max(1, num_frames // frames_per_clip) // scale)
        pool = np.arange(step // 2, num_frames, step)
        inner = (len(pool) - frames_per_clip) // (scale - 1) if scale > 1 else 0
        for i in range(scale):
            clip = pool[i * inner:i * inner + frames_per_clip]
            if len(clip) != frames_per_clip:
                raise ValueError(
                    f"Clip length mismatch at scale {scale}: expected "
                    f"{frames_per_clip}, got {len(clip)} (num_frames={num_frames})")
            all_clips.append(clip)
    return np.stack(all_clips, axis=0)


def sample_clips(frames: np.ndarray, frames_per_clip: int = 5,
                 temporal_scale: Sequence[int] = (1, 2, 3)) -> np.ndarray:
    """Gather clips from a decoded (N, H, W, C) frame array ->
    (sum(scales), frames_per_clip, H, W, C)."""
    idx = clip_indices(len(frames), frames_per_clip, temporal_scale)
    return frames[idx]
