"""Host-ingest benchmark: sustained clips/s of the .avi / .mp4 decode path
(MSVD, MSRVTT) on the host.

Counterpart of ``tools/bench_ingest.py``. The reference decodes every frame
of every video on every fetch; ``data/video_decode.get_video_clips``
decodes only the sampled frames, through the native libav* decoder where
it built. Three regimes:

  cold       - first visit: frame count + sampled decode;
  warm-count - the frame count cached (every revisit of a video; the
               Microsoft datasets ask ~10-25 questions per video);
  warm-clip  - a clip LRU hit (``video_decode.ClipCache``): no decode.

It writes MJPG .avi (MSVD-like, intra-only) or mp4v .mp4 (MSRVTT-like,
inter-coded: the native decoder's keyframe-seek plan) files with cv2 and
times one epoch per regime with the training loader's thread count.
``--compare-cv2`` interleaves native and cv2 cold rounds in one process
(the ratio is stable where the host's speed drifts); ``--thread-sweep``
times cold ingest at 1, 2 and 4 threads. Returns the clips/s as a dict.

It needs cv2 (which writes the videos); where the native libav* library
did not build, the decode goes through cv2 as well. The machine with the
card has neither, so the tool does not run there.

    python -m lrce_tpu_torch.tools.bench_ingest [--videos 12] [--frames 60]
        [--questions-per-video 8] [--threads 4] [--codec mjpg|mp4v]
        [--compare-cv2] [--thread-sweep]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lrce_tpu_torch.data import video_decode as VD


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "bench_ingest writes its .avi / .mp4 files with OpenCV (cv2), "
            "which is not installed here; the decode it measures needs cv2 "
            "or the libav* libraries") from e
    return cv2


def make_videos(out_dir: str, n_videos: int, n_frames: int,
                codec: str = "mjpg") -> list:
    cv2 = _cv2()
    fourcc, ext = (("MJPG", "avi") if codec == "mjpg" else ("mp4v", "mp4"))
    rng = np.random.RandomState(0)
    paths = []
    # mp4v is an inter codec: smoothly varying content (not per-pixel
    # noise) gives realistic P-frame chains between keyframes
    base = rng.randint(0, 255, (240, 320, 3), np.uint8)
    for i in range(n_videos):
        path = f"{out_dir}/vid{i:03d}.{ext}"
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25,
                            (320, 240))
        for f in range(n_frames):
            if codec == "mjpg":
                frame = rng.randint(0, 255, (240, 320, 3), np.uint8)
            else:
                frame = np.clip(base.astype(np.int16)
                                + rng.randint(-20, 20, base.shape)
                                + (i * 11 + f) % 64, 0, 255).astype(np.uint8)
            w.write(frame)
        w.release()
        paths.append(path)
    return paths


def run_epoch(paths, questions_per_video: int, threads: int, cache,
              use_native: bool = True) -> float:
    """One simulated epoch: every video fetched questions_per_video times
    (interleaved, as a shuffled question list). Returns clips/s."""
    work = [p for _ in range(questions_per_video) for p in paths]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        clips = list(pool.map(
            lambda p: VD.get_video_clips(p, 5, (1, 2, 3), (224, 224), cache,
                                         use_native=use_native), work))
    dt = time.perf_counter() - t0
    return sum(c.shape[0] for c in clips) / dt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--videos", type=int, default=12)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--questions-per-video", type=int, default=8)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--codec", choices=("mjpg", "mp4v"), default="mjpg",
                    help="mjpg = intra-only .avi (MSVD); mp4v = inter .mp4 "
                         "(MSRVTT, the native keyframe-seek path)")
    ap.add_argument("--compare-cv2", action="store_true",
                    help="interleave native / cv2 cold rounds; report the "
                         "ratio")
    ap.add_argument("--thread-sweep", action="store_true",
                    help="cold ingest at 1 / 2 / 4 threads")
    args = ap.parse_args(argv)
    _cv2()

    with tempfile.TemporaryDirectory(prefix="ingest_") as td:
        paths = make_videos(td, args.videos, args.frames, args.codec)

        if args.compare_cv2:
            rounds = []
            for r in range(3):
                VD._FRAME_COUNT_CACHE.clear()
                nat = run_epoch(paths, 1, args.threads, None)
                VD._FRAME_COUNT_CACHE.clear()
                cv2r = run_epoch(paths, 1, args.threads, None,
                                 use_native=False)
                rounds.append((nat, cv2r))
                print(f"round {r}: native {nat:7.1f}  cv2 {cv2r:7.1f}  "
                      f"ratio {nat / cv2r:.2f}x", flush=True)
            ratios = sorted(n / c for n, c in rounds)
            print(f"cold native-vs-cv2 [{args.codec}]: median ratio "
                  f"{ratios[1]:.2f}x (best {ratios[-1]:.2f}x)")
            return {"rounds": rounds, "median_ratio": ratios[1]}

        if args.thread_sweep:
            results = {1: [], 2: [], 4: []}
            for _ in range(3):
                for t in results:
                    VD._FRAME_COUNT_CACHE.clear()
                    results[t].append(run_epoch(paths, 1, t, None))
            for t, vals in results.items():
                print(f"cold decode [{args.codec}], {t} thread(s): median "
                      f"{sorted(vals)[1]:8.1f} clips/s  (rounds: "
                      + " ".join(f"{v:.0f}" for v in vals) + ")", flush=True)
            return {t: sorted(v)[1] for t, v in results.items()}

        VD._FRAME_COUNT_CACHE.clear()
        cold = run_epoch(paths, 1, args.threads, None)
        print(f"cold decode:        {cold:8.1f} clips/s "
              f"({args.threads} threads)")
        warm_count = run_epoch(paths, args.questions_per_video, args.threads,
                               None)
        print(f"warm frame-count:   {warm_count:8.1f} clips/s")
        cache = VD.ClipCache(max_items=args.videos)
        run_epoch(paths, 1, args.threads, cache)    # fill
        warm_clip = run_epoch(paths, args.questions_per_video, args.threads,
                              cache)
        print(f"warm clip-cache:    {warm_clip:8.1f} clips/s")
        return {"cold": cold, "warm-count": warm_count,
                "warm-clip": warm_clip}


if __name__ == "__main__":
    main()
