"""Synthetic data for the tools, written with numpy alone (no PIL, pandas or
cv2, which the machine with the card lacks):

  - ``write_gif``: a GIF writer with no image library;
  - ``write_tgif_frameqa``: a TGIF-frameqa dataset directory of noise GIFs
    (``chip_smoke.py``'s command-line phases);
  - ``build_dataset``: the counterpart of ``tools/sanity_curve.build_dataset``
    (the sanity curve's and the eval bench's memorisable dataset): the same
    ``RandomState(0)`` draws, rows and ``vocab.txt``, each GIF put on a
    palette of its own by ``palette_frames`` instead of PIL's quantiser;
  - ``table``: rows of dicts as a plain-text table (in place of
    ``pandas.DataFrame.to_string(index=False)``).
"""

from __future__ import annotations

import os
import pathlib
from typing import Dict, Sequence

import numpy as np

# A GIF with a global 256-colour palette, full frames, no transparency, and
# an LZW stream that never compresses. With a minimum code size of 8 every
# literal is a 9-bit code; a decoder adds a table entry for each code after
# the first since the last clear code, and widens its codes to 10 bits when
# the table reaches 512 entries, so a clear code before every 254 literals
# keeps the table at 511 and the width at 9.
GIF_LZW_RUN = 254

# write_tgif_frameqa: (width, height) per GIF (most at 224 x 224, where the
# resize is the identity; one at 320 x 240, where the native resize runs),
# the range of frame counts, and the words of the questions and answers
TGIF_GIFS = ((224, 224), (224, 224), (224, 224), (224, 224), (224, 224),
             (224, 224), (224, 224), (320, 240))
TGIF_FRAMES = (12, 40)
TGIF_SUBJECTS = ("man", "woman", "dog", "cat", "girl", "boy")
TGIF_VERBS = ("doing", "holding", "wearing", "eating")
TGIF_ANSWERS = ("guitar", "hat", "ball", "dance", "red", "food", "phone")

# build_dataset: tools/sanity_curve.py's vocabulary and answers
BASE_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
              "what", "is", "happening", "in", "clip", "the", "?"]
ANSWERS = [f"thing{i}" for i in range(32)]
# palette_frames: levels per channel (7 x 6 x 6 = 252 <= 256 colours)
PALETTE_LEVELS = (7, 6, 6)


def _gif_lzw(indices: np.ndarray) -> bytes:
    """The LZW stream of one frame's palette indices (8-bit minimum code
    size), one literal code per pixel."""
    px = indices.reshape(-1).astype(np.uint16)
    runs = -(-px.size // GIF_LZW_RUN)
    pad = runs * GIF_LZW_RUN - px.size
    body = np.concatenate([px, np.zeros(pad, np.uint16)]).reshape(
        runs, GIF_LZW_RUN)
    codes = np.concatenate([np.full((runs, 1), 256, np.uint16), body],
                           axis=1).reshape(-1)
    codes = np.append(codes[:codes.size - pad], np.uint16(257))  # end code
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1)
    return np.packbits(bits.astype(np.uint8).reshape(-1),
                       bitorder="little").tobytes()


def _gif_blocks(data: bytes) -> bytes:
    """``data`` as GIF sub-blocks of at most 255 bytes, then the
    terminator."""
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)
    return bytes(out)


def write_gif(path: str, frames: np.ndarray, palette: np.ndarray) -> None:
    """``frames``: (n, h, w) uint8 palette indices; ``palette``: (256, 3)
    uint8 RGB. Frame k decodes to ``palette[frames[k]]``."""
    n, h, w = frames.shape
    out = bytearray(b"GIF89a")
    out += np.array([w, h], "<u2").tobytes()
    out += bytes([0xF7, 0, 0])  # global table of 2^(7+1) colours; bg 0
    out += np.ascontiguousarray(palette, np.uint8).tobytes()
    for k in range(n):
        # graphic control: disposal 1 (leave), no transparency, 40 ms
        out += bytes([0x21, 0xF9, 4, 0x04, 4, 0, 0, 0])
        out += b"\x2c" + np.array([0, 0, w, h], "<u2").tobytes() + b"\x00"
        out += bytes([8]) + _gif_blocks(_gif_lzw(frames[k]))
    out += b"\x3b"
    with open(path, "wb") as f:
        f.write(bytes(out))


def palette_frames(rgb: np.ndarray):
    """(n, h, w, 3) uint8 RGB -> ((n, h, w) uint8 indices, (256, 3) uint8
    palette): each channel rounded to the nearest of PALETTE_LEVELS levels
    spread evenly over the frames' own range of that channel."""
    lo = rgb.reshape(-1, 3).min(0).astype(np.float64)
    span = np.maximum(rgb.reshape(-1, 3).max(0) - lo, 1.0)
    steps = np.array(PALETTE_LEVELS, np.float64) - 1
    q = np.rint((rgb - lo) / span * steps).astype(np.int64)
    lv = PALETTE_LEVELS
    indices = (q[..., 0] * lv[1] + q[..., 1]) * lv[2] + q[..., 2]
    grid = np.stack(np.meshgrid(*(np.arange(n) for n in lv), indexing="ij"),
                    axis=-1).reshape(-1, 3)
    palette = np.zeros((256, 3), np.uint8)
    palette[:len(grid)] = np.rint(lo + grid / steps * span).astype(np.uint8)
    return indices.astype(np.uint8), palette


def write_tgif_frameqa(root: str, seed: int, train_questions: int = 400,
                       test_questions: int = 40) -> dict:
    """A TGIF-frameqa dataset directory under ``root``, made from ``seed``:
    ``gifs/`` (one GIF of random palette indices and a random palette per
    (width, height) in TGIF_GIFS, TGIF_FRAMES = (least, most) frames each),
    ``annotations/{Train,Test,Total}_frameqa_question.csv``
    (train_questions and test_questions questions over the GIFs, Total =
    both) and a ``vocab.txt`` of the words used. Returns {"gifs": {gif
    name: (frames, palette)}, "vocab": the vocab's path}."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "gifs"))
    os.makedirs(os.path.join(root, "annotations"))
    written = {}
    for i, (w, h) in enumerate(TGIF_GIFS):
        name = f"tumblr_{i:02d}"
        n = int(rng.integers(TGIF_FRAMES[0], TGIF_FRAMES[1] + 1))
        idx = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
        palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
        write_gif(os.path.join(root, "gifs", f"{name}.gif"), idx, palette)
        written[name] = (idx, palette)
    names = sorted(written)

    def rows(count):
        out = []
        for _ in range(count):
            g = int(rng.integers(len(names)))
            q = (f"what is the "
                 f"{TGIF_SUBJECTS[rng.integers(len(TGIF_SUBJECTS))]}"
                 f" {TGIF_VERBS[rng.integers(len(TGIF_VERBS))]} ?")
            a = TGIF_ANSWERS[rng.integers(len(TGIF_ANSWERS))]
            out.append(f"{names[g]}\t{q}\t{a}\t{g}")
        return out

    header = "gif_name\tquestion\tanswer\tvid_id"
    train, test = rows(train_questions), rows(test_questions)
    for split, body in (("Train", train), ("Test", test),
                        ("Total", train + test)):
        with open(os.path.join(root, "annotations",
                               f"{split}_frameqa_question.csv"), "w") as f:
            f.write("\n".join([header] + body) + "\n")
    vocab = os.path.join(root, "vocab.txt")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "is",
             "the", "?", *TGIF_SUBJECTS, *TGIF_VERBS, *TGIF_ANSWERS]
    with open(vocab, "w") as f:
        f.write("\n".join(words) + "\n")
    return {"gifs": written, "vocab": vocab}


def build_dataset(root, n_videos: int, n_samples: int, frames: int = 12,
                  size=(128, 128)) -> Dict[str, tuple]:
    """The sanity curve's TGIF-frameqa directory under ``root`` (which must
    exist; ``gifs/`` and ``annotations/`` must not): ``tools/
    sanity_curve.build_dataset``'s frames from the same ``RandomState(0)``
    draws, each video's distinct low-frequency content (base colour +
    coarse 4 x 4 blocks + noise), its rows (the answer a function of the
    video, a unique marker word per question; Train = Test = Total) and
    its ``vocab.txt``, byte for byte. The frames reach the GIF through
    ``palette_frames``. Returns {video name: (indices, palette)}."""
    root = pathlib.Path(root)
    gifs = root / "gifs"
    gifs.mkdir()
    rng = np.random.RandomState(0)
    written = {}
    for v in range(n_videos):
        base = np.array([((v * 37) % 256), ((v * 101) % 256),
                         ((v * 193) % 256)], np.uint8)
        coarse = rng.randint(0, 96, (4, 4, 3)).astype(np.float32)
        coarse = np.kron(coarse, np.ones((size[0] // 4, size[1] // 4, 1)))
        ims = []
        for _ in range(frames):
            noise = rng.randint(0, 32, (size[0], size[1], 3))
            ims.append(np.clip(base[None, None].astype(np.float32) * 0.6
                               + coarse + noise, 0, 255).astype(np.uint8))
        indices, palette = palette_frames(np.stack(ims))
        write_gif(str(gifs / f"v{v:03d}.gif"), indices, palette)
        written[f"v{v:03d}"] = (indices, palette)

    rows = ["gif_name\tquestion\tanswer\tvid_id"]
    for s in range(n_samples):
        v = s % n_videos
        ans = ANSWERS[v % len(ANSWERS)]
        rows.append(f"v{v:03d}\twhat is happening in clip q{s}?\t{ans}\t{v}")
    ann = root / "annotations"
    ann.mkdir()
    for split in ("Train", "Test", "Total"):
        (ann / f"{split}_frameqa_question.csv").write_text(
            "\n".join(rows) + "\n")

    vocab = BASE_VOCAB + ANSWERS + [f"q{s}" for s in range(n_samples)]
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return written


def table(rows: Sequence[dict]) -> str:
    """Rows of dicts with the same keys as a plain-text table: a header of
    the keys, one line per row, each column right-aligned to its widest
    cell."""
    keys = list(rows[0])
    cells = [keys] + [[str(r[k]) for k in keys] for r in rows]
    widths = [max(len(c[i]) for c in cells) for i in range(len(keys))]
    return "\n".join(" ".join(c.rjust(w) for c, w in zip(line, widths))
                     for line in cells)
