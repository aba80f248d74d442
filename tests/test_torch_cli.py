"""The port's one-card command lines (lrce_tpu_torch/cli/train.py, eval.py)
on the CPU, on a TGIF dataset made here (PIL GIFs, tab-separated
questions, a vocab.txt), with a tiny model of the same geometry as
lrce_tpu's LRCE_TPU_TINY_MODEL (Swin embed 8, BERT 36 wide, 224 x 224
frames -> 7 x 7 features).

Parity: lrce_tpu's train CLI trains for four epochs (lr 1e-2) and writes
``best.pt`` (its native pickle) on one JAX device; the port's eval CLI
evaluates that file on the test split. Tolerance: loss within 1e-4
relative of lrce_tpu's eval CLI on the same file, accuracy equal, both at
f32: the two forwards sum in other orders (tests/test_torch_e2e.py holds
their logits to each other), and the loss, a mean of two batch means over
1000 classes, reads the same to five decimals on both sides. The trained
model answers two of the four questions right, so the accuracy can fail
too. A resume with ``--model-path`` from that file holds exactly the
converter's weights.
"""

import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lrce_tpu import config as JC
from lrce_tpu.models import e2e as JE
from lrce_tpu.parallel import mesh as JM
from lrce_tpu.utils import checkpoint as JCk
from lrce_tpu_torch import config as PC
from lrce_tpu_torch.cli import eval as PEv
from lrce_tpu_torch.cli import train as PTr
from lrce_tpu_torch.data import datasets as PD
from lrce_tpu_torch.models import bert as PB
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.utils.convert import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LOSS_REL = 1e-4
# lrce_tpu's train run for the parity tests: long enough, at a high enough
# rate, that its best.pt answers some test questions right
JAX_RUN_ARGS = ["--epoch", "4", "--lr", "1e-2", "1e-2", "1e-2",
                "--ckpt-interval", "10"]

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "what", "is", "the", "man", "doing", "playing", "guitar",
         "a", "dog", "runs", "red", "blue", "green", "cat", "?", "!",
         "how", "many", "times", "does", "run"]
ROWS = ["gif_name\tquestion\tanswer\tvid_id",
        "g1\twhat is the man doing?\tguitar\t0",
        "g2\ta dog runs!\tred\t1",
        "g3\twhat is the dog doing?\tblue\t2",
        "g4\twhat is the cat doing?\tguitar\t3"]
MC_ROWS = ["gif_name\tquestion\ta1\ta2\ta3\ta4\ta5\tanswer\tvid_id"] + [
    f"{g}\twhat is the man doing?\tplaying guitar\ta dog runs\tred\tblue"
    f"\tgreen\t{a}\t{i}"
    for i, (g, a) in enumerate([("g1", 0), ("g2", 3), ("g3", 1), ("g4", 4)])]
COUNT_ROWS = ["gif_name\tquestion\tanswer\tvid_id"] + [
    f"{g}\thow many times does the dog run?\t{n}\t{i}"
    for i, (g, n) in enumerate([("g1", 3), ("g2", 7), ("g3", 2), ("g4", 5)])]
DATASETS = {"tgif-frameqa": [], "tgif-action": ["--use-hinge-loss"],
            "tgif-count": []}


def _make_tgif(root: Path) -> Path:
    from PIL import Image

    (root / "gifs").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for name, n in [("g1", 10), ("g2", 18), ("g3", 8), ("g4", 25)]:
        frames = [Image.fromarray(rng.randint(0, 255, (48, 48, 3), np.uint8))
                  for _ in range(n)]
        frames[0].save(root / "gifs" / f"{name}.gif", save_all=True,
                       append_images=frames[1:], duration=50, loop=0)
    ann = root / "annotations"
    ann.mkdir()
    for kind, rows in (("frameqa", ROWS), ("action", MC_ROWS),
                       ("count", COUNT_ROWS)):
        for split in ("Train", "Test", "Total"):
            (ann / f"{split}_{kind}_question.csv").write_text(
                "\n".join(rows) + "\n")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return root


def tiny_cfg(args) -> PE.E2EConfig:
    """lrce_tpu's LRCE_TPU_TINY_MODEL configuration (its
    models/e2e.config_from_args) as the port's E2EConfig."""
    return PE.E2EConfig(
        feature_dim=36, num_classes=args.num_classes,
        drop_out_rate=getattr(args, "drop_out_rate", 0.1),
        video_feature_res=tuple(args.video_feature_res),
        video_feature_dim=64, frame_sample_size=args.frame_sample_size,
        temporal_scale=tuple(args.temporal_scale),
        text_seq_len=args.text_seq_len, task_type=args.task_type,
        bert=PB.BertConfig(hidden_size=36, num_layers=2, num_heads=2,
                           intermediate_size=72),
        swin=PS.SwinConfig(patch_size=(2, 4, 4), embed_dim=8,
                           depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
                           window_size=(8, 7, 7), drop_path_rate=0.0))


def _train_argv(data, log_dir, dataset="tgif-frameqa", *extra):
    return ["--dataset", dataset, "--dataset-dir", str(data),
            "--log-dir", str(log_dir), "--batch-size", "2", "--epoch", "1",
            "--num-workers", "1", "--lr", "1e-4", "--use-cosine-scheduler",
            "--reg-strength", "0", *DATASETS[dataset], *extra]


def _eval_argv(data, model_path, dataset="tgif-frameqa"):
    return ["--dataset", dataset, "--dataset-dir", str(data),
            "--model-path", str(model_path), "--batch-size", "2",
            "--num-workers", "1"]


def _pattern(name: str) -> str:
    return re.sub(r"\d", "#", name)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the tiny model, which gains nothing from
    more: under a parallel test run, a thread per core in every process
    oversubscribes the cores and slows each epoch several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tgif_dir(tmp_path, monkeypatch):
    data = _make_tgif(tmp_path / "tgif")
    monkeypatch.setenv("LRCE_TPU_BERT_VOCAB", str(data / "vocab.txt"))
    return data


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """lrce_tpu's train CLI (LRCE_TPU_TINY_MODEL, one JAX device, the
    JAX_RUN_ARGS), then its eval CLI on the ``best.pt`` it wrote. The eval
    CLI starts from the train CLI's initial parameters (one compilation of
    the initialiser instead of two) and loads ``best.pt`` over them."""
    import eval as jax_eval
    import train as jax_train

    root = tmp_path_factory.mktemp("jax_cli")
    data = _make_tgif(root / "tgif")
    initial = []

    def init_once(rng, cfg, dtype=jnp.float32):
        if not initial:
            initial.append(jax.tree_util.tree_map(
                np.array, JE.e2e_init_jit(rng, cfg, dtype)))
        return jax.tree_util.tree_map(jnp.asarray, initial[0])

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LRCE_TPU_BERT_VOCAB", str(data / "vocab.txt"))
        mp.setenv("LRCE_TPU_TINY_MODEL", "1")
        one = JM.make_mesh(1)
        mp.setattr(jax_train, "make_train_mesh", lambda fsdp, model: one)
        mp.setattr(jax_eval, "make_mesh", lambda: one)
        mp.setattr(jax_train, "e2e_init_jit", init_once)
        mp.setattr(jax_eval, "e2e_init_jit", init_once)
        args = JC.parse_arg_train(_train_argv(data, root / "runs")
                                  + JAX_RUN_ARGS)
        jax_train.main(args)
        best = os.path.join(args.ckpt_dir, "best.pt")
        evaluator = jax_eval.main(JC.parse_arg_eval(_eval_argv(data, best)))
    return {"data": data, "best": best, "files": sorted(os.listdir(
        args.ckpt_dir)), "loss": evaluator.last_loss,
        "metric": evaluator.last_metric_val}


@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_train_cli_one_epoch(tgif_dir, tmp_path, dataset):
    """One epoch of oe / mc (hinge loss) / count through the port's train
    CLI on the CPU: finite losses, ``config.json`` and ``best.pt`` and the
    epoch checkpoint written under lrce_tpu's names."""
    args = PC.parse_arg_train(_train_argv(tgif_dir, tmp_path / "runs",
                                          dataset))
    trainer = PTr.main(args, device="cpu", model_cfg=tiny_cfg(args))
    assert np.isfinite(trainer.last_train_loss) and np.isfinite(
        trainer.last_loss)
    assert trainer.counter == 2             # 4 questions, batch 2
    assert os.path.isfile(os.path.join(args.log_dir, "config.json"))
    files = sorted(os.listdir(args.ckpt_dir))
    assert [_pattern(f) for f in files] == [
        "best.pt", _pattern(f"epoch01_loss{trainer.last_loss:.4f}_metric"
                            f"{trainer.last_metric_val:.4f}.pt")]
    assert {p.device.type for p in trainer.model.parameters()} == {"cpu"}
    assert trainer.model.dtype == torch.float32


def test_train_cli_names_its_files_as_lrce_tpu(jax_run, tgif_dir, tmp_path):
    args = PC.parse_arg_train(_train_argv(tgif_dir, tmp_path / "runs")
                              + JAX_RUN_ARGS)
    PTr.main(args, device="cpu", model_cfg=tiny_cfg(args))
    assert ([_pattern(f) for f in sorted(os.listdir(args.ckpt_dir))]
            == [_pattern(f) for f in jax_run["files"]])


def test_train_cli_sanity_check(tgif_dir, tmp_path, monkeypatch):
    """``--sanity-check`` runs ``do_sanity_check`` on the first
    SANITY_CHECK_SIZE items (4 here), with no validation and no log
    directory."""
    monkeypatch.setattr(PD, "SANITY_CHECK_SIZE", 4)
    args = PC.parse_arg_train(_train_argv(tgif_dir, tmp_path / "runs") + [
        "--sanity-check"])
    trainer = PTr.main(args, device="cpu", model_cfg=tiny_cfg(args))
    assert trainer.counter == 2 and np.isfinite(trainer.last_train_loss)
    assert trainer.last_loss is None        # no validation pass
    assert not (tmp_path / "runs").exists()


@pytest.mark.parametrize("flag", ["--fsdp", "--tensor-parallel"])
def test_train_cli_refuses_sharding(tgif_dir, tmp_path, flag):
    """On one process a sharded axis of 2 does not divide the one device:
    lrce_tpu's make_train_mesh error (the sharded runs themselves:
    tests/test_torch_cli_ddp.py)."""
    args = PC.parse_arg_train(_train_argv(tgif_dir, tmp_path / "runs") + [
        flag, "2"])
    with pytest.raises(ValueError, match="must divide the device count"):
        PTr.main(args, device="cpu", model_cfg=tiny_cfg(args))


def test_clis_default_to_the_card_and_raise_without_one(tgif_dir, tmp_path):
    assert not torch.cuda.is_available()
    args = PC.parse_arg_train(_train_argv(tgif_dir, tmp_path / "runs"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PTr.main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PEv.main(PC.parse_arg_eval(_eval_argv(tgif_dir, "unused.pt")))


def test_train_cli_exits_on_an_unsupported_task(tgif_dir, tmp_path):
    args = PC.parse_arg_train(_train_argv(tgif_dir, tmp_path / "runs"))
    args.task_type = "xx"
    with pytest.raises(SystemExit):
        PTr.main(args, device="cpu", model_cfg=tiny_cfg(args))


def test_eval_cli_on_lrce_tpu_best_pt_matches_lrce_tpu(jax_run, monkeypatch):
    """The port's eval CLI on the ``best.pt`` lrce_tpu's train CLI wrote:
    lrce_tpu's eval CLI's loss within 1e-4 relative, the same accuracy."""
    monkeypatch.setenv("LRCE_TPU_BERT_VOCAB", str(jax_run["data"] / "vocab.txt"))
    args = PC.parse_arg_eval(_eval_argv(jax_run["data"], jax_run["best"]))
    evaluator = PEv.main(args, device="cpu", model_cfg=tiny_cfg(args))
    assert np.isfinite(jax_run["loss"]) and 0 < jax_run["metric"] < 1
    assert abs(evaluator.last_loss - jax_run["loss"]) <= LOSS_REL * abs(
        jax_run["loss"])
    assert evaluator.last_metric_val == jax_run["metric"]


def test_train_cli_resumes_from_lrce_tpu_best_pt(jax_run, tmp_path,
                                                monkeypatch):
    """``--model-path`` with lrce_tpu's native pickle: the trainer holds
    exactly the weights the converter gives for that file."""
    monkeypatch.setenv("LRCE_TPU_BERT_VOCAB", str(jax_run["data"] / "vocab.txt"))
    args = PC.parse_arg_train(_train_argv(jax_run["data"], tmp_path / "runs")
                              + ["--model-path", jax_run["best"],
                                 "--epoch", "0", "--debug-mode"])
    trainer = PTr.main(args, device="cpu", model_cfg=tiny_cfg(args))
    want = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, JCk.load_checkpoint(jax_run["best"])["model_state_dict"]))
    got = trainer.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    assert not (tmp_path / "runs").exists()     # --debug-mode: no log dir
