"""The port's file-based data layer (lrce_tpu_torch: data/tsv.py,
utils/vocab.py, native/, data/tokenizer.py, data/video_decode.py,
data/datasets.py) against lrce_tpu's, on the CPU, on files made here from
numpy seeds (GIFs by PIL, .avi by cv2, tab-separated annotations, JSON, a
vocab.txt).

Tolerance: none. Every dict, token id, decoded byte and dataset item must
be equal, with the same dtype: both sides run the same integer code (the
native decoders are the same C++, the Python paths the same algorithms) and
the float32 clips are the same uint8 bytes over 255.
"""

import json
import math
import os
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from lrce_tpu import native as JN
from lrce_tpu.data import datasets as JD
from lrce_tpu.data import tokenizer as JT
from lrce_tpu.data import video_decode as JV
from lrce_tpu.utils import vocab as JVb
from lrce_tpu_torch import native as PN
from lrce_tpu_torch.data import datasets as PD
from lrce_tpu_torch.data import sampling as PSm
from lrce_tpu_torch.data import tokenizer as PT
from lrce_tpu_torch.data import video_decode as PV
from lrce_tpu_torch.data.tsv import read_tsv
from lrce_tpu_torch.utils import vocab as PVb

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "what", "is", "the", "man", "doing", "play", "##ing", "guitar",
         "a", "dog", "run", "##s", ",", "?", "!", "'", "s", "red", "blue",
         "##uit", "##ar", "gu", "cat", "how", "many", "times", "does",
         "it", "\"", "green", "cafe", "null"]

GIFS = {"g1": (12, 40, 32), "g2": (25, 48, 40), "g3": (8, 30, 24),
        "g4": (17, 64, 48)}          # name: (frames, width, height)
AVIS = {"v1": 23, "v2": 14}          # name: frames
FRAME_SIZE = (40, 48)
SCALES = (1, 2)

# frameqa (oe): tied answers ("red" / "blue" twice each, first seen in
# that order), a quoted question with a tab, a comma and doubled quotes,
# pandas' missing-value strings as answers ("NA", "null" -> NaN), a
# lower-case "none" that stays a string, and a column of missing values
OE_ROWS = [
    "gif_name\tquestion\tanswer\tvid_id\tnote",
    "g1\twhat is the man doing?\tguitar\t0\tNA",
    "g2\ta dog runs!\tred\t1\t",
    "g3\t\"what is \"\"it\"\",\tthe dog doing?\"\tblue\t2\tnull",
    "g4\twhat is the cat doing?\tred\t3\tn/a",
    "g1\thow many dogs?\tblue\t0\tNone",
    "g2\twhat is the man playing?\tNA\t1\t",
    "g3\twhat is the dog?\tnull\t2\t",
    "g4\tthe cat?\tnone\t3\t",
]
MC_ROWS = ["gif_name\tquestion\ta1\ta2\ta3\ta4\ta5\tanswer\tvid_id"] + [
    f"{g}\twhat is the man doing?\tplaying guitar\ta dog runs\tred\tblue"
    f"\tgreen cafe\t{a}\t{i}"
    for i, (g, a) in enumerate([("g1", 0), ("g2", 3), ("g3", 1), ("g4", 4),
                                ("g2", 3)])]
COUNT_ROWS = ["gif_name\tquestion\tanswer\tvid_id"] + [
    f"{g}\thow many times does the dog run?\t{n}\t{i}"
    for i, (g, n) in enumerate([("g1", 3), ("g2", 7), ("g3", 2), ("g4", 5),
                                ("g1", 3)])]
TGIF = {"frameqa": ("oe", OE_ROWS), "action": ("mc", MC_ROWS),
        "count": ("count", COUNT_ROWS)}


def _write_avi(path, n_frames, size=(48, 40)):
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25, size)
    yy, xx = np.mgrid[0:size[1], 0:size[0]].astype(np.float32)
    for t in range(n_frames):
        img = (128 + 100 * np.sin(xx / 9 + t / 2)
               * np.cos(yy / 7 - t / 3)).astype(np.uint8)
        w.write(np.stack([img, np.roll(img, t, 1), 255 - img], -1))
    w.release()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """GIFs and annotations in the TGIF layout, .avi and JSON in the MSVD
    layout, a vocab.txt, and .npy clip banks."""
    from PIL import Image

    root = tmp_path_factory.mktemp("data")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    (root / "gifs").mkdir()
    rng = np.random.RandomState(0)
    for name, (n, w, h) in GIFS.items():
        frames = [Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))
                  for _ in range(n)]
        frames[0].save(root / "gifs" / f"{name}.gif", save_all=True,
                       append_images=frames[1:], duration=50, loop=0)
    ann = root / "annotations"
    ann.mkdir()
    for kind, (_, rows) in TGIF.items():
        body = rows[1:]
        for split, part in (("Train", body[:4]), ("Test", body[3:]),
                            ("Total", body)):
            (ann / f"{split}_{kind}_question.csv").write_text(
                "\n".join([rows[0]] + part) + "\n")

    (root / "video").mkdir()
    if _has_cv2():
        for name, n in AVIS.items():
            _write_avi(root / "video" / f"{name}.avi", n)
    with open(root / "idx-video-mapping.pkl", "wb") as f:
        pickle.dump({10: "v1", 11: "v2"}, f)
    qa = [{"question": "what is the man doing?", "answer": "guitar",
           "video_id": 10},
          {"question": "what is the dog doing?", "answer": "red",
           "video_id": 11},
          {"question": "is it a cat?", "answer": "red", "video_id": 10},
          {"question": "what is it?", "answer": "blue", "video_id": 11}]
    for split, part in (("train", qa[:3]), ("val", qa[1:]), ("test", qa)):
        (root / f"{split}_qa.json").write_text(json.dumps(part))

    (root / "banks").mkdir()
    banks = rng.rand(9, 5, 6, 7, 3).astype(np.float32)
    np.save(root / "banks" / "g1.npy", banks)                        # HWC
    np.save(root / "banks" / "g2.npy", banks.transpose(0, 1, 4, 2, 3))  # CHW
    return root


def _has_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def _assert_same(a, b, what=""):
    """Equal values of the same type; NaN equals NaN."""
    assert type(a) is type(b), (what, a, b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a, b)
        np.testing.assert_array_equal(a, b, err_msg=str(what))
    elif isinstance(a, (float, np.floating)) and math.isnan(a):
        assert math.isnan(b), (what, a, b)
    else:
        assert a == b, (what, a, b)


# ---------------------------------------------------------------------------
# data/tsv.py: pandas' read_csv(delimiter="\t") without pandas
# ---------------------------------------------------------------------------

TSV_CELLS = ["3", " 6", "+3", "-3", "03", "1.0", "1e3", ".5", "5.", "inf",
             "-Infinity", "nan", "NaN", "NA", "N/A", "n/a", "null", "NULL",
             "None", "none", "<NA>", "#N/A", "-nan", "1,000", "0x10", "yes",
             "1_000", "1e400", "", " ", "nan ",
             '"NA"', '"3"', '"a\tb"', '"x""y"']


@pytest.mark.parametrize("other", [None, "4", "x", "", "2.5"])
def test_read_tsv_types_cells_as_pandas(tmp_path, other):
    """Each tricky cell beside another row's cell: the same column type and
    the same value (type included) in every row as ``pd.read_csv``'s
    ``.iloc[row][column]``."""
    for k, cell in enumerate(TSV_CELLS):
        path = tmp_path / f"t{k}.csv"
        path.write_text("a\tb\nx\t" + cell + "\n"
                        + (f"y\t{other}\n" if other is not None else ""))
        df = pd.read_csv(path, delimiter="\t")
        rows = read_tsv(str(path))
        assert len(rows) == len(df)
        for i in range(len(df)):
            for col in df.columns:
                _assert_same(df.iloc[i][col], rows[i][col], (cell, other, col))


def test_read_tsv_layout_as_pandas(tmp_path):
    """Byte-order mark, CRLF, blank lines, a short row, a quoted
    newline."""
    path = tmp_path / "t.csv"
    path.write_bytes("﻿a\tb\tc\r\nx\t1\t2\r\n\r\ny\n\"multi\nline\"\t3\tz\n"
                     .encode())
    df = pd.read_csv(path, delimiter="\t")
    rows = read_tsv(str(path))
    assert list(rows[0]) == list(df.columns) == ["a", "b", "c"]
    for i in range(len(df)):
        for col in df.columns:
            _assert_same(df.iloc[i][col], rows[i][col], (i, col))


@pytest.mark.parametrize("case", ["row_longer_than_header", "repeated_name",
                                  "bool_column", "bool_column_with_na",
                                  "beyond_int64"])
def test_read_tsv_known_differences_from_pandas(tmp_path, case):
    """What ``read_tsv`` does not reproduce (ROADMAP, Queue 3 "Known
    differences"): a row longer than the header raises (pandas makes its
    extra leading cells an index), so do a repeated column name (pandas
    renames it ``a.1``) and a column of true / false (pandas types it
    bool); an integer column beyond int64 stays ``str`` (pandas gives
    uint64)."""
    path = tmp_path / "t.csv"
    raises = {"row_longer_than_header": ("a\tb\nx\ty\tz\n", "3 cells"),
              "repeated_name": ("a\tb\ta\nx\t1\t2\n", "repeats"),
              "bool_column": ("a\tb\nx\tTrue\ny\tfalse\n", "bool"),
              "bool_column_with_na": ("a\tb\nx\tTRUE\ny\tNA\n", "bool")}
    if case in raises:
        text, match = raises[case]
        path.write_text(text)
        df = pd.read_csv(path, delimiter="\t")
        assert {"row_longer_than_header": lambda: df.iloc[0]["a"] == "y",
                "repeated_name": lambda: list(df.columns) == ["a", "b", "a.1"],
                "bool_column": lambda: df["b"].dtype == np.bool_,
                "bool_column_with_na": lambda: df.iloc[0]["b"] is True}[case]()
        with pytest.raises(ValueError, match=match):
            read_tsv(str(path))
    else:
        path.write_text("a\tb\nx\t9223372036854775808\n")
        assert pd.read_csv(path, delimiter="\t")["b"].dtype == np.uint64
        assert read_tsv(str(path))[0]["b"] == "9223372036854775808"


# ---------------------------------------------------------------------------
# utils/vocab.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(TGIF))
def test_parse_tgif_annot_matches_lrce_tpu(data_dir, kind):
    """oe: the top-K answers with ties in first-seen order and the missing
    answers as one NaN key; mc / count: the integer answer column maps to
    itself. The video dicts too, in the same order."""
    task, _ = TGIF[kind]
    path = str(data_dir / "annotations" / f"Total_{kind}_question.csv")
    for k in (2, 1000):
        want = JVb.parse_tgif_annot(path, task, k=k)
        got = PVb.parse_tgif_annot(path, task, k=k)
        for w, g in zip(want, got):
            assert list(w.items()) == list(g.items())
            for (wk, wv), (gk, gv) in zip(w.items(), g.items()):
                assert type(wk) is type(gk) or (
                    isinstance(wk, (int, np.integer))
                    and isinstance(gk, (int, np.integer)))
    if task == "oe":
        answers = list(got[0])
        assert answers[:3] == ["red", "blue", np.nan]


def test_answer_and_video_dicts_match_lrce_tpu(data_dir, tmp_path):
    files = [str(data_dir / "train_qa.json"), str(data_dir / "val_qa.json")]
    for k in (1, 2, 1500):
        for rev in (False, True):
            assert (list(PVb.build_common_answer_dict(files, k, rev).items())
                    == list(JVb.build_common_answer_dict(files, k, rev).items()))
    for rev in (False, True):
        assert (list(PVb.build_answer_dict(files, rev).items())
                == list(JVb.build_answer_dict(files, rev).items()))
    annot = tmp_path / "annot.txt"
    annot.write_text("vid3 a b\nvid1 c\n\nvid3 d\nvid2 e\n")
    for rev in (False, True):
        for start in (0, 5):
            assert (list(PVb.build_video_dict(str(annot), rev, start).items())
                    == list(JVb.build_video_dict(str(annot), rev, start).items()))


# ---------------------------------------------------------------------------
# tokenizer + native WordPiece
# ---------------------------------------------------------------------------

TEXTS = [("What is the man doing?", None, 16, False),
         ("a dog runs!", "playing guitar", 20, False),
         ("Playing GUITAR, what's the cat?", "red", 8, True),
         ("the man's dog", "blue green", 6, True),
         ("unknownword what", None, None, False),
         ("", None, 12, False),
         ("  what   is  ", "  ", 12, False),
         ("a" * 150, None, 8, False),
         ("Café, what?", None, 16, False),          # non-ASCII: Python path
         ("the dog", "guitár", 16, False),
         (" ".join(["playing guitar"] * 200), None, 30, False),  # > 256 ids
         (" ".join(["playing guitar"] * 200), "red", 30, True)]


@pytest.mark.parametrize("case", range(len(TEXTS)))
def test_tokenizer_native_and_python_match_lrce_tpu(data_dir, case):
    """The port's tokenizer with the native path on and off, and
    lrce_tpu's Python path, give the same ids, mask and types: single and
    pair, ASCII and not, with and without truncation, and longer than the
    native buffers' first size (256 ids), which lrce_tpu's native path
    writes past (its wp_encode has no capacity; the port's has)."""
    text, pair, max_length, trunc = TEXTS[case]
    vocab = str(data_dir / "vocab.txt")
    on = PT.BertWordPieceTokenizer(vocab, use_native=True)
    off = PT.BertWordPieceTokenizer(vocab, use_native=False)
    if shutil.which("g++"):
        assert isinstance(on._native, PN.NativeWordPiece)
    assert off._native is None
    want = JT.BertWordPieceTokenizer(vocab, use_native=False).encode(
        text, pair, max_length=max_length, truncation=trunc)
    for tok in (on, off):
        got = tok.encode(text, pair, max_length=max_length, truncation=trunc)
        for x, y in zip(got, want):
            _assert_same(x, y, case)
    if case == len(TEXTS) - 2:
        assert len(want[0]) == 602     # [CLS] + 200 x 3 + [SEP]


def test_load_default_tokenizer_reads_the_vocab_path(data_dir, monkeypatch,
                                                     tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LRCE_TPU_BERT_VOCAB", raising=False)
    with pytest.raises(FileNotFoundError, match="LRCE_TPU_BERT_VOCAB"):
        PT.load_default_tokenizer()
    monkeypatch.setenv("LRCE_TPU_BERT_VOCAB", str(data_dir / "vocab.txt"))
    assert PT.find_bert_vocab() == str(data_dir / "vocab.txt")
    if shutil.which("g++"):
        assert isinstance(PT.load_default_tokenizer()._native,
                          PN.NativeWordPiece)
    # where the native library did not build, the Python path serves
    monkeypatch.setattr(PN, "load_native", lambda: None)
    assert PT.load_default_tokenizer()._native is None


# ---------------------------------------------------------------------------
# native/: the port's own build of the C++ decoders
# ---------------------------------------------------------------------------

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++: the native library cannot build")


@needs_gxx
def test_native_gif_and_resize_match_lrce_tpu(data_dir):
    """gif_probe / gif_decode / resize_bilinear: the same bytes as
    lrce_tpu's native functions, the resize the same as PIL's; the port's
    library is its own build, under lrce_tpu_torch/_build/."""
    from PIL import Image

    built = PN.built(PN.CORE)
    assert built.lib is not None
    assert built.path.parent == REPO / "lrce_tpu_torch" / "_build"
    assert Path(JN._LIB_PATH).resolve() != built.path
    for name in GIFS:
        path = str(data_dir / "gifs" / f"{name}.gif")
        assert PN.gif_probe(path) == JN.gif_probe(path)
        frames = PN.gif_decode(path)
        np.testing.assert_array_equal(frames, JN.gif_decode(path))
        np.testing.assert_array_equal(PN.gif_decode(path, 3),
                                      JN.gif_decode(path, 3))
        for size in ((224, 224), FRAME_SIZE, (16, 16)):
            got = PN.resize_bilinear(frames[1], size)
            np.testing.assert_array_equal(got,
                                          JN.resize_bilinear(frames[1], size))
            pil = np.asarray(Image.fromarray(frames[1]).resize(
                (size[1], size[0]), Image.BILINEAR))
            np.testing.assert_array_equal(got, pil)


def test_native_build_failure_is_logged_and_returns_none(monkeypatch,
                                                         caplog):
    """A library that does not build gives None (callers take the Python
    path) and its compiler output is logged once."""
    spec = PN._Spec("liblrce_broken", ("image.cpp",), ("-lno_such_lib_x",))
    PN._SIGNATURES[spec.name] = {}
    try:
        with caplog.at_level("WARNING"):
            got = PN.built(spec)
            again = PN.built(spec)
        assert got.lib is None and again is got
        warnings = [r for r in caplog.records if spec.name in r.getMessage()]
        assert len(warnings) == 1
        if shutil.which("g++"):
            assert "no_such_lib_x" in warnings[0].getMessage()
    finally:
        del PN._SIGNATURES[spec.name]
        PN._load_once.cache_clear()


# ---------------------------------------------------------------------------
# video_decode.get_video_clips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_get_video_clips_gif_matches_lrce_tpu(data_dir, native, dtype):
    """A PIL-written GIF through the port's native path (or PIL / cv2 with
    use_native off) and through lrce_tpu's native path: the same bytes."""
    if not native:
        pytest.importorskip("cv2")
    for name in GIFS:
        path = str(data_dir / "gifs" / f"{name}.gif")
        want = JV.get_video_clips(path, 5, SCALES, FRAME_SIZE,
                                  out_dtype=dtype)
        got = PV.get_video_clips(path, 5, SCALES, FRAME_SIZE,
                                 out_dtype=dtype, use_native=native)
        _assert_same(got, want, name)


@pytest.mark.parametrize("native", [True, False])
def test_get_video_clips_avi_matches_lrce_tpu(data_dir, native):
    """A cv2 MJPG .avi through the port's libav* path (or cv2 with
    use_native off) and lrce_tpu's: the same bytes. Skips without cv2, or
    without libav* for the native case."""
    pytest.importorskip("cv2")
    if native and not PN.video_available():
        pytest.skip("the native video library did not build (no libav*)")
    cache = PV.ClipCache(4)
    for name in AVIS:
        path = str(data_dir / "video" / f"{name}.avi")
        want = JV.get_video_clips(path, 5, SCALES, FRAME_SIZE,
                                  out_dtype=np.uint8)
        got = PV.get_video_clips(path, 5, SCALES, FRAME_SIZE, cache,
                                 out_dtype=np.uint8, use_native=native)
        _assert_same(got, want, name)
        _assert_same(PV.get_video_clips(path, 5, SCALES, FRAME_SIZE, cache,
                                        use_native=native),
                     got.astype(np.float32) / 255.0, name)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _assert_items_equal(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds)
    for i in range(len(jax_ds)):
        want, got = jax_ds[i], port_ds[i]
        assert len(got) == len(want) == 5
        for f, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, (i, f))


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("kind", sorted(TGIF))
def test_tgif_dataset_items_match_lrce_tpu(data_dir, kind, uint8):
    """Every item of E2ETGIFDataset (oe / mc / count): clips byte-equal in
    uint8 and float32 mode, ids, masks, types and the label (int64, or
    float32 for count), and the answer dict."""
    task, _ = TGIF[kind]
    kw = dict(frames_per_clip=5, temporal_scale=SCALES, frame_size=FRAME_SIZE,
              max_text_token_len=24, uint8_clips=uint8)
    for split in ("Train", "Test"):
        args = dict(
            split_annotation=str(data_dir / "annotations"
                                 / f"{split}_{kind}_question.csv"),
            full_annotation=str(data_dir / "annotations"
                                / f"Total_{kind}_question.csv"),
            videos_path=str(data_dir / "gifs"), task_type=task, **kw)
        vocab = str(data_dir / "vocab.txt")
        want = JD.E2ETGIFDataset(tokenizer=JT.BertWordPieceTokenizer(vocab),
                                 **args)
        got = PD.E2ETGIFDataset(tokenizer=PT.BertWordPieceTokenizer(vocab),
                                **args)
        assert list(got.answer_dict.items()) == list(want.answer_dict.items())
        _assert_items_equal(got, want)


@pytest.mark.parametrize("uint8", [True, False])
def test_microsoft_dataset_items_match_lrce_tpu(data_dir, uint8, monkeypatch):
    """Every item of E2EMicrosoftDataset (MSVD / MSRVTT layout: JSON
    questions, the id -> name mapping, .avi files) in each split, the
    tokenizer found through LRCE_TPU_BERT_VOCAB on both sides."""
    pytest.importorskip("cv2")
    monkeypatch.setenv("LRCE_TPU_BERT_VOCAB", str(data_dir / "vocab.txt"))
    with open(data_dir / "idx-video-mapping.pkl", "rb") as f:
        video_dict = pickle.load(f)
    for split in ("train", "val", "test"):
        args = dict(train_annotation=str(data_dir / "train_qa.json"),
                    val_annotation=str(data_dir / "val_qa.json"),
                    test_annotation=str(data_dir / "test_qa.json"),
                    videos_path=str(data_dir / "video"), video_dict=video_dict,
                    split=split, answer_vocab_k=2, frames_per_clip=5,
                    temporal_scale=SCALES, frame_size=FRAME_SIZE,
                    max_text_token_len=16, uint8_clips=uint8)
        _assert_items_equal(PD.E2EMicrosoftDataset(**args),
                            JD.E2EMicrosoftDataset(**args))


@pytest.mark.parametrize("scales", [(1, 2, 3), (3,)])
def test_frame_extracted_items_match_lrce_tpu(data_dir, scales):
    """The ``is_frame_extracted`` path: per-video .npy banks (HWC, and the
    reference's CHW), the scale rows selected, f32 HWC out."""
    vocab = str(data_dir / "vocab.txt")
    args = dict(
        split_annotation=str(data_dir / "annotations"
                             / "Train_frameqa_question.csv"),
        full_annotation=str(data_dir / "annotations"
                            / "Total_frameqa_question.csv"),
        videos_path=str(data_dir / "banks"), temporal_scale=scales,
        is_frame_extracted=True, max_text_token_len=24)
    want = JD.E2ETGIFDataset(tokenizer=JT.BertWordPieceTokenizer(vocab), **args)
    got = PD.E2ETGIFDataset(tokenizer=PT.BertWordPieceTokenizer(vocab), **args)
    for i in range(2):      # g1 (HWC bank) and g2 (CHW bank)
        for g, w in zip(got[i], want[i]):
            _assert_same(g, w, i)
        assert got[i][0].shape == (sum(scales), 5, 6, 7, 3)


# ---------------------------------------------------------------------------
# chip_smoke's GIF writer and dataset
# ---------------------------------------------------------------------------

def test_chip_smoke_gif_writer_decodes_to_the_frames_written(tmp_path):
    """PIL decodes the GIFs of chip_smoke's dataset writer
    (``tools/synth.py``: uncompressed LZW, a clear code every 254
    literals) to exactly the palette colours written, as does the port's
    native decoder; so phase_cli's byte check of the dataset's clips
    means something."""
    from PIL import Image

    from lrce_tpu_torch.tools import synth

    train_questions = 400
    written = synth.write_tgif_frameqa(str(tmp_path / "tgif"), 3,
                                       train_questions)
    assert len(written["gifs"]) == len(synth.TGIF_GIFS)
    for name, (frames, palette) in written["gifs"].items():
        path = str(tmp_path / "tgif" / "gifs" / f"{name}.gif")
        im = Image.open(path)
        assert im.n_frames == len(frames)
        for k in range(len(frames)):
            im.seek(k)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                          palette[frames[k]])
        if shutil.which("g++"):
            np.testing.assert_array_equal(PN.gif_decode(path),
                                          palette[frames])
    # the phase's check, on the CPU: a 224 x 224 GIF's uint8 clips are the
    # frames written at clip_indices
    ds = PD.E2ETGIFDataset(
        split_annotation=str(tmp_path / "tgif/annotations/"
                             "Train_frameqa_question.csv"),
        full_annotation=str(tmp_path / "tgif/annotations/"
                            "Total_frameqa_question.csv"),
        videos_path=str(tmp_path / "tgif/gifs"), temporal_scale=(3,),
        uint8_clips=True,
        tokenizer=PT.BertWordPieceTokenizer(written["vocab"]))
    assert len(ds) == train_questions
    seen, checked = set(), set()
    for i in range(len(ds)):    # the first question on each GIF
        name = ds.label_file[i]["gif_name"]
        if name in checked:
            continue
        checked.add(name)
        frames, palette = written["gifs"][name]
        clips = ds[i][0]
        assert clips.shape == (3, 5, 224, 224, 3) and clips.dtype == np.uint8
        seen.add(frames.shape[1:])
        if frames.shape[1:] == (224, 224):
            idx = PSm.clip_indices(len(frames), 5, (3,))
            np.testing.assert_array_equal(clips, palette[frames[idx]])
    assert seen == {(224, 224), (240, 320)} and checked == set(written["gifs"])
    assert os.path.getsize(written["vocab"]) > 0
