"""The port's tools (lrce_tpu_torch/tools/) on the CPU, at a tiny model of
lrce_tpu's LRCE_TPU_TINY_MODEL geometry (Swin embed 8, BERT 36 wide, 224 x
224 frames -> 7 x 7 features), dropout and drop-path 0, one torch thread.

The JAX tools build the flagship, so the port's tools are held to the JAX
functions they wrap, at the tiny configuration, with the port's seeded
weights carried across by lrce_tpu's own converter
(``lrce_tpu.utils.torch_io``). Tolerances:
  - the first train step's loss (train_bench, preflight) against
    ``AgentOE.step`` of lrce_tpu: 1e-4 relative, both at f32 (the two
    forwards sum in other orders; tests/test_torch_train.py holds the same
    step to 1e-4);
  - parity_eval's accuracy against lrce_tpu's parity_eval: equal; its loss:
    1e-4 relative (both print it to five decimals);
  - video and text features against ``lrce_tpu.models.e2e.extract_*_
    features`` at f32: max |port - jax| <= 1e-4 x max |jax|;
  - frame banks, synth's annotations and vocab.txt: byte for byte.
"""

import contextlib
import io
import json
import os
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lrce_tpu.models import bert as JB
from lrce_tpu.models import e2e as JE
from lrce_tpu.models import swin3d as JS
from lrce_tpu.train import agent as JA
from lrce_tpu.utils import checkpoint as JCk
from lrce_tpu.utils import torch_io as tio
from lrce_tpu_torch import constants as PC
from lrce_tpu_torch import native as PN
from lrce_tpu_torch.config import parse_arg_eval
from lrce_tpu_torch.models import bert as PB
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.tools import (bench, bench_ingest, calculate_flops,
                                  common, e2e_eval_bench, extract_features,
                                  flops, graft_entry, parity_eval, preflight,
                                  profile, sanity_curve, stage_bench, synth,
                                  train_bench)
from lrce_tpu_torch.utils import checkpoint as PCk

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LOSS_REL = 1e-4
FEATURE_REL = 1e-4
TINY_BERT = dict(hidden_size=36, num_layers=2, num_heads=2,
                 intermediate_size=72, hidden_dropout=0.0,
                 attention_dropout=0.0)
TINY_SWIN = dict(patch_size=(2, 4, 4), embed_dim=8, depths=(2, 2, 2, 2),
                 num_heads=(2, 2, 2, 2), window_size=(8, 7, 7),
                 drop_path_rate=0.0)


def _tiny_kw(num_classes=1000, text_seq_len=32, temporal_scale=(3,)):
    return dict(feature_dim=36, num_classes=num_classes, drop_out_rate=0.0,
                video_feature_res=(7, 7), video_feature_dim=64,
                frame_sample_size=5, temporal_scale=tuple(temporal_scale),
                text_seq_len=text_seq_len, task_type="oe")


def tiny_cfg(**kw) -> PE.E2EConfig:
    return PE.E2EConfig(**_tiny_kw(**kw), bert=PB.BertConfig(**TINY_BERT),
                        swin=PS.SwinConfig(**TINY_SWIN))


def jax_tiny_cfg(**kw) -> JE.E2EConfig:
    return JE.E2EConfig(**_tiny_kw(**kw), bert=JB.BertConfig(**TINY_BERT),
                        swin=JS.SwinConfig(**TINY_SWIN))


def tgif_cfg() -> PE.E2EConfig:
    """The tiny model at tgif-frameqa's classes, text length and scale."""
    a = parse_arg_eval(["--dataset", "tgif-frameqa", "--dataset-dir", ".",
                        "--model-path", "unused"])
    return tiny_cfg(num_classes=a.num_classes, text_seq_len=a.text_seq_len,
                    temporal_scale=a.temporal_scale)


def jax_params(model) -> dict:
    """The port model's weights as lrce_tpu parameters, through lrce_tpu's
    converter of reference-named torch state dicts."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return tio.convert_e2e(sd)


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: under a parallel test run a thread per core in
    every process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# synth: GIFs without PIL, the sanity curve's dataset, tables
# ---------------------------------------------------------------------------

def test_synth_gifs_decode_byte_for_byte(tmp_path):
    """build_dataset's GIFs decode, by the port's native decoder and by
    PIL, to exactly the palette colours of the indices written."""
    from PIL import Image

    written = synth.build_dataset(tmp_path, 3, 5, frames=4, size=(24, 32))
    assert sorted(written) == ["v000", "v001", "v002"]
    for name, (idx, palette) in written.items():
        path = str(tmp_path / "gifs" / f"{name}.gif")
        want = palette[idx]
        assert want.shape == (4, 24, 32, 3)
        if shutil.which("g++"):
            np.testing.assert_array_equal(PN.gif_decode(path), want)
        im = Image.open(path)
        for k in range(len(idx)):
            im.seek(k)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")),
                                          want[k])


def test_synth_palette_keeps_each_channel_within_half_a_level():
    rng = np.random.RandomState(1)
    rgb = rng.randint(10, 200, (2, 8, 8, 3)).astype(np.uint8)
    idx, palette = synth.palette_frames(rgb)
    span = rgb.reshape(-1, 3).max(0) - rgb.reshape(-1, 3).min(0)
    half = span / (np.array(synth.PALETTE_LEVELS) - 1) / 2 + 0.5
    err = np.abs(palette[idx].astype(float) - rgb)
    assert (err <= half).all() and idx.max() < 252


def test_build_dataset_rows_and_vocab_equal_the_jax_tools(tmp_path):
    """tools/sanity_curve.build_dataset (PIL GIFs) and synth.build_dataset
    write the same annotations and vocab.txt, byte for byte, and GIFs of
    the same names and frame counts."""
    from PIL import Image

    from tools.sanity_curve import build_dataset

    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    build_dataset(tmp_path / "jax", 3, 7, frames=4, size=(16, 16))
    synth.build_dataset(tmp_path / "port", 3, 7, frames=4, size=(16, 16))
    files = ["vocab.txt"] + [f"annotations/{s}_frameqa_question.csv"
                             for s in ("Train", "Test", "Total")]
    for f in files:
        assert ((tmp_path / "jax" / f).read_bytes()
                == (tmp_path / "port" / f).read_bytes()), f
    names = sorted(os.listdir(tmp_path / "jax" / "gifs"))
    assert names == sorted(os.listdir(tmp_path / "port" / "gifs"))
    for n in names:
        for d in ("jax", "port"):
            assert Image.open(tmp_path / d / "gifs" / n).n_frames == 4


def test_table_aligns_columns_right():
    text = synth.table([{"token_length": 90, "mflops": 52.7},
                        {"token_length": 180, "mflops": 1388.5}])
    assert text.splitlines() == ["token_length mflops",
                                 "          90   52.7",
                                 "         180 1388.5"]


# ---------------------------------------------------------------------------
# extract_features
# ---------------------------------------------------------------------------

@pytest.fixture
def gif_dir(tmp_path):
    synth.build_dataset(tmp_path, 2, 2, frames=12, size=(24, 24))
    return tmp_path / "gifs"


def test_extract_frames_equal_the_jax_tool(gif_dir, tmp_path):
    from tools.extract_features import main as jax_main

    argv = ["--videos-dir", str(gif_dir), "--scales", "1", "2",
            "--frame-size", "16"]
    jax_main(["frames", "--out-dir", str(tmp_path / "jax")] + argv)
    extract_features.main(["frames", "--out-dir", str(tmp_path / "port")]
                          + argv, device="cpu")
    for name in ("v000.npy", "v001.npy"):
        want = np.load(tmp_path / "jax" / name)
        got = np.load(tmp_path / "port" / name)
        assert got.shape == (3, 5, 16, 16, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_extract_video_and_text_features_match_lrce_tpu(gif_dir, tmp_path,
                                                        monkeypatch):
    """``video`` and ``text`` with tiny Swin / BERT checkpoints (a port
    model's, seed 5) against lrce_tpu's extract_video_features /
    extract_text_features on the same weights and inputs."""
    from lrce_tpu_torch.data.video_decode import get_video_clips

    cfg = tiny_cfg(temporal_scale=(1,))
    src = PE.LRCEModel(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    torch.save(src.video_extractor.swin.state_dict(), tmp_path / "swin.pth")
    torch.save(src.text_extractor.bert.state_dict(), tmp_path / "bert.pt")
    params = jax_params(src)
    jcfg = jax_tiny_cfg(temporal_scale=(1,))

    extract_features.main(
        ["video", "--videos-dir", str(gif_dir), "--out-dir",
         str(tmp_path / "video"), "--scales", "1", "--swin-ckpt",
         str(tmp_path / "swin.pth")], device="cpu", model_cfg=cfg)
    names = ("v000", "v001")
    clips = np.stack([get_video_clips(str(gif_dir / f"{n}.gif"), 5, (1,),
                                      (224, 224)) for n in names])
    want = np.asarray(JE.extract_video_features(
        jax.tree.map(jnp.asarray, params["video_extractor"]),
        jnp.asarray(clips), jcfg))
    for n, w in zip(names, want):
        with open(tmp_path / "video" / f"{n}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got.shape == (1, 3, 49, 64) and got.dtype == np.float32
        assert np.abs(got - w).max() <= FEATURE_REL * np.abs(w).max()

    root = tmp_path / "gifs"
    monkeypatch.setenv("LRCE_TPU_BERT_VOCAB", str(root.parent / "vocab.txt"))
    ann = root.parent / "annotations" / "Test_frameqa_question.csv"
    extract_features.main(
        ["text", "--annotation", str(ann), "--out-dir", str(tmp_path / "text"),
         "--tgif", "--max-len", "12", "--bert-ckpt", str(tmp_path / "bert.pt")],
        device="cpu", model_cfg=cfg)
    from lrce_tpu.data.tokenizer import BertWordPieceTokenizer

    tok = BertWordPieceTokenizer(str(root.parent / "vocab.txt"))
    for vid, q in (("0", "what is happening in clip q0?"),
                   ("1", "what is happening in clip q1?")):
        ids, mask, types = (jnp.asarray(a[None].astype(np.int32))
                            for a in tok.encode(q, max_length=12))
        w = np.asarray(JE.extract_text_features(
            jax.tree.map(jnp.asarray, params["text_extractor"]), ids, mask,
            types, jcfg))[0]
        with open(tmp_path / "text" / f"{vid}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got.shape == (12, 36) and got.dtype == np.float32
        assert np.abs(got - w).max() <= FEATURE_REL * np.abs(w).max()


# ---------------------------------------------------------------------------
# flops
# ---------------------------------------------------------------------------

def test_flops_show_linear_fusion_and_violet_memory(capsys, monkeypatch):
    """The ordering tests/test_tools.py asks of the JAX tool: LRCE's FLOPs
    grow below 2.5x a doubling and below both joint encoders', every memory
    finite, VIOLET's above VQA-T's (its twelve attention maps live). The
    root alias's counterpart runs the same main."""
    assert calculate_flops.main is flops.main
    monkeypatch.setattr(flops, "ITERS", 1)
    rows = flops.main(["--steps", "2", "--feature-dim", "48"], device="cpu")
    lrce = rows["lrce"]
    assert len(lrce) == 2
    lrce_ratio = lrce[1]["mflops"] / lrce[0]["mflops"]
    assert lrce_ratio < 2.5
    for name in ("vqat", "violet"):
        joint = rows[name]
        assert joint[1]["mflops"] / joint[0]["mflops"] > lrce_ratio, name
        assert all(np.isfinite(r["memory_mb"]) for r in joint)
    assert rows["violet"][1]["memory_mb"] > rows["vqat"][1]["memory_mb"]
    out = capsys.readouterr().out
    assert "VIOLET" in out and "token_length mflops runtime_ms memory_mb" in out


# ---------------------------------------------------------------------------
# parity_eval
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parity_run(tmp_path_factory):
    """A tiny checkpoint (a port model, seed 3) in both formats over a
    4-question synthetic TGIF-frameqa set, and lrce_tpu's parity_eval on
    the torch file (its eval CLI on one JAX device, LRCE_TPU_TINY_MODEL,
    starting from the converted weights instead of compiling its
    initialiser)."""
    import eval as jax_eval
    from lrce_tpu.parallel import mesh as JM
    from tools import parity_eval as jax_parity

    root = tmp_path_factory.mktemp("parity")
    data = root / "tgif"
    data.mkdir()
    synth.build_dataset(data, 2, 4, frames=8, size=(32, 32))
    model = PE.LRCEModel(tgif_cfg(), device="cpu",
                         generator=torch.Generator().manual_seed(3))
    files = {"torch": str(root / "port.pt"), "native": str(root / "jax.pt")}
    PCk.save_checkpoint(files["torch"], model.state_dict())
    params = jax_params(model)
    JCk.save_checkpoint(files["native"], params)
    argv = ["--dataset", "tgif-frameqa", "--dataset-dir", str(data),
            "--batch-size", "4", "--num-workers", "1"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LRCE_TPU_BERT_VOCAB", str(data / "vocab.txt"))
        mp.setenv("LRCE_TPU_TINY_MODEL", "1")
        one = JM.make_mesh(1)
        mp.setattr(jax_eval, "make_mesh", lambda: one)
        mp.setattr(jax_eval, "e2e_init_jit", lambda rng, cfg, *a: jax.tree.map(
            jnp.asarray, params))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = jax_parity.main(argv + ["--model-path", files["torch"]])
    assert rc == 0
    return {"argv": argv, "files": files, "data": data,
            "jax": json.loads(out.getvalue().strip().splitlines()[-1])}


@pytest.mark.parametrize("fmt", ["torch", "native"])
def test_parity_eval_matches_lrce_tpu(parity_run, fmt, monkeypatch, capsys):
    monkeypatch.setenv("LRCE_TPU_BERT_VOCAB",
                       str(parity_run["data"] / "vocab.txt"))
    want = parity_run["jax"]
    rc = parity_eval.main(parity_run["argv"] + [
        "--model-path", parity_run["files"][fmt], "--expected-accuracy",
        str(want["measured"] + 0.4)], device="cpu", model_cfg=tgif_cfg())
    got = last_json(capsys)
    assert rc == 0 and got["parity"] is True
    assert got["metric"] == want["metric"] == "accuracy_pct"
    assert got["measured"] == want["measured"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])


def test_parity_eval_exit_codes(parity_run, monkeypatch, capsys, tmp_path):
    """1 when the measured accuracy is further than --tolerance from
    --expected-accuracy (0 when within: test_parity_eval_matches_lrce_tpu),
    2 on a missing checkpoint or dataset directory."""
    monkeypatch.setenv("LRCE_TPU_BERT_VOCAB",
                       str(parity_run["data"] / "vocab.txt"))
    argv = parity_run["argv"] + ["--model-path",
                                 parity_run["files"]["torch"]]
    measured = parity_run["jax"]["measured"]
    assert parity_eval.main(argv + ["--expected-accuracy",
                                    str(measured + 5.0)],
                            device="cpu", model_cfg=tgif_cfg()) == 1
    assert last_json(capsys)["parity"] is False
    missing = str(tmp_path / "none.pt")
    assert parity_eval.main(parity_run["argv"] + ["--model-path", missing],
                            device="cpu") == 2
    assert last_json(capsys) == {"error": f"missing artifact: {missing}"}


# ---------------------------------------------------------------------------
# train_bench and preflight: the first step against lrce_tpu's AgentOE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_first_step():
    """lrce_tpu's AgentOE.step on the tools' batch of one question
    (common.host_batch: the JAX tools' RandomState(0) draws), the tools'
    namespace, f32, from the weights the tools start from (common.flagship
    at seed 0)."""
    cfg = tiny_cfg()
    params = jax_params(common.flagship(torch.device("cpu"), cfg))
    args = common.agent_args("bench", 1)
    agent = JA.AgentOE(jax_tiny_cfg(), jax.tree.map(jnp.asarray, params),
                       args, log_enabled=False, compute_dtype=jnp.float32)
    clips, ids, mask, types, gt = common.host_batch(1, cfg)
    loss, _, _ = agent.step(clips, ids.astype(np.int32),
                            mask.astype(np.int32), types.astype(np.int32),
                            gt.astype(np.int32), is_train=True)
    return float(loss)


def test_train_bench_first_step_matches_jax_agent(jax_first_step, capsys):
    got = train_bench.main(["--batch", "1", "--iters", "1"], device="cpu",
                           model_cfg=tiny_cfg())
    assert abs(got["loss"] - jax_first_step) <= LOSS_REL * jax_first_step
    for regime in ("wall", "prefetch", "device", "lagged"):
        assert got[f"{regime}_ms"] > 0 and got[f"{regime}_clips_s"] > 0
    assert got["clips"] == 3 and "peak_gib" not in got
    out = capsys.readouterr().out
    assert "compile+first step:" in out and "lagged step:" in out


def test_preflight_passes_and_its_train_check_matches_jax_agent(
        jax_first_step, capsys, monkeypatch):
    """On the plain route (``--plain``): the same loss."""
    monkeypatch.setattr(preflight, "BENCH_BATCH", 1)
    rc = preflight.main(["--train-batch", "1", "--plain"],
                        device="cpu", model_cfg=tiny_cfg())
    got = last_json(capsys)
    assert rc == 0 and got["preflight"] == "pass" and got["device"] == "cpu"
    assert got["checks"]["bench_forward"]["ok"]
    loss = got["checks"]["train_step"]["loss"]
    assert abs(loss - jax_first_step) <= LOSS_REL * jax_first_step


def test_preflight_fails_fast_with_a_json_line(capsys, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("non-finite forward output (sum=nan)")

    monkeypatch.setattr(preflight, "bench_forward", broken)
    assert preflight.main([], device="cpu", model_cfg=tiny_cfg()) == 1
    got = last_json(capsys)
    assert got["preflight"] == "fail" and list(got["checks"]) == [
        "bench_forward"]
    assert got["checks"]["bench_forward"] == {
        "ok": False, "error": "non-finite forward output (sum=nan)"}


# ---------------------------------------------------------------------------
# The benches run through at the tiny model
# ---------------------------------------------------------------------------

def test_profile_forward_latency_and_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(profile, "LATENCY_REQUESTS", 2)
    got = profile.main(["--latency", "--iters", "1", "--trace-dir",
                        str(tmp_path)], device="cpu", model_cfg=tiny_cfg())
    assert got["batch"] == 1 and len(got["latency_ms"]) == 2
    assert 0 < got["p50_ms"] <= got["p90_ms"]
    assert got["plain_route_gflop"] > 0
    events = json.loads(Path(got["trace"]).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"lrce.forward", "lrce.swin", "lrce.bert", "lrce.fusion",
            "lrce.fusion.clip"} <= names
    out = capsys.readouterr().out
    assert "plain-route flops:" in out and "per-question latency:" in out


def test_stage_bench_times_both_routes():
    rows = stage_bench.main(["--clips", "1", "--iters", "1", "--stage", "3"],
                            device="cpu", model_cfg=tiny_cfg())
    assert [(r["stage"], r["c"], r["depth"]) for r in rows] == [(3, 64, 2)]
    assert rows[0]["kernel_ms"] > 0 and rows[0]["plain_ms"] > 0
    assert stage_bench.stage_shapes(48, PS.SWIN_BASE) == [
        (48, 3, 56, 56, 128), (48, 3, 28, 28, 256), (48, 3, 14, 14, 512),
        (48, 3, 7, 7, 1024)]


def test_e2e_eval_bench_runs_three_passes(tmp_path, capsys):
    got = e2e_eval_bench.main(
        ["--samples", "4", "--videos", "2", "--batch-size", "4", "--workers",
         "1", "--keep-dir", str(tmp_path)], device="cpu", model_cfg=tgif_cfg())
    printed = last_json(capsys)
    assert printed["samples"] == got["samples"] == 4
    assert all(printed[k] > 0 for k in e2e_eval_bench.PASSES)
    assert np.isfinite(printed["loss"])
    assert (tmp_path / "vocab.txt").exists()


def test_sanity_curve_records_each_epoch(tmp_path, monkeypatch, capsys):
    """The CLI path with the sanity split cut to 4 items (500 items of 224 x
    224 frames take minutes on the CPU): the --samples rule at that size,
    one record per epoch from the agent's "Sanity loss" line, finite
    losses, the trainer returned."""
    monkeypatch.setattr(PC, "SANITY_CHECK_SIZE", 4)
    from lrce_tpu_torch.data import datasets as PD

    monkeypatch.setattr(PD, "SANITY_CHECK_SIZE", 4)
    monkeypatch.setattr(sanity_curve, "NUM_WORKERS", 1)
    with pytest.raises(SystemExit):
        sanity_curve.main(["--samples", "3"], device="cpu")
    got = sanity_curve.main(
        ["--samples", "4", "--videos", "2", "--epochs", "2", "--batch-size",
         "4", "--keep-dir", str(tmp_path)],
        device="cpu", model_cfg=tgif_cfg())
    printed = last_json(capsys)
    assert [r["epoch"] for r in printed["curve"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in printed["curve"])
    assert got["trainer"].counter == 2
    assert printed["curve"][-1]["loss"] == round(
        got["trainer"].last_train_loss, 5)


@pytest.mark.parametrize("mode", [[], ["--compare-cv2"], ["--thread-sweep"],
                                  ["--codec", "mp4v"]])
def test_bench_ingest_regimes(mode):
    pytest.importorskip("cv2")
    got = bench_ingest.main(["--videos", "2", "--frames", "12",
                             "--questions-per-video", "2", "--threads", "1"]
                            + mode)
    values = (got["rounds"][0] if "--compare-cv2" in mode
              else list(got.values()))
    assert all(v > 0 for v in values)


def test_bench_ingest_says_why_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        bench_ingest.main(["--videos", "1"])


def test_graft_entry_is_the_forward(tmp_path):
    fn, args = graft_entry.entry("cpu", tiny_cfg())
    out = fn(*args)
    assert out.shape == (2, 1000) and torch.isfinite(out).all()
    assert graft_entry.dryrun_multichip.__module__ == (
        "lrce_tpu_torch.parallel.dryrun")


def test_bench_prints_one_json_line(monkeypatch, capsys):
    """bench.py's program at the tiny model, its forwards cut from 32
    questions x 20 to 2 x 2 (at 32 one tiny forward takes ~18 s on one CPU
    thread): one line, the four keys, a positive rate, not labelled as a
    card's."""
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setattr(bench, "ITERS", 2)
    got = bench.main([], device="cpu", model_cfg=tiny_cfg())
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == got
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "clips_per_sec_cpu" and line["value"] > 0
    assert line["vs_baseline"] == round(
        line["value"] / bench.A100_BASELINE_CLIPS_PER_SEC, 3)


TOOLS = {
    "bench": lambda p: bench.main([]),
    "preflight": lambda p: preflight.main([]),
    "train_bench": lambda p: train_bench.main([]),
    "profile": lambda p: profile.main([]),
    "stage_bench": lambda p: stage_bench.main([]),
    "e2e_eval_bench": lambda p: e2e_eval_bench.main([]),
    "sanity_curve": lambda p: sanity_curve.main([]),
    "parity_eval": lambda p: parity_eval.main([
        "--dataset", "tgif-frameqa", "--dataset-dir", str(p),
        "--model-path", str(p)]),
    "extract_features video": lambda p: extract_features.main([
        "video", "--videos-dir", str(p), "--out-dir", str(p)]),
    "extract_features text": lambda p: extract_features.main([
        "text", "--annotation", str(p), "--out-dir", str(p)]),
    "flops": lambda p: flops.main([]),
    "graft_entry": lambda p: graft_entry.entry(),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tools_default_to_the_card_and_raise_without_one(tool, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TOOLS[tool](tmp_path)
    assert os.listdir(tmp_path) == []
