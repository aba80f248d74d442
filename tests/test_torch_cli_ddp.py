"""The port's command lines across ranks, its checkpoints under sharding,
the schedulers' decisions across ranks and the dry run, on the CPU over
gloo (processes from ``lrce_tpu_torch.parallel.mesh.spawn``, one torch
thread each, a 60 s process group timeout so that a hung rank fails its
test; the CLIs' runs write no TensorBoard scalars, whose import pulls in
TensorFlow where it is installed, ~15 s in every spawned rank 0).

  - CLIs: the tiny TGIF directory and model of tests/test_torch_cli.py
    (``_make_tgif``, ``tiny_cfg``), one epoch; ``cli.train_ddp`` validates
    on the test split, and at world 2 writes one ``best.pt`` (rank 0's);
    its 2-rank epoch at batch 2 against a 1-rank epoch at batch 4 (the same
    four questions in one global batch, dropout 0): the validation loss
    within 1e-5 relative, the parameters within 1e-5 of each parameter's
    largest magnitude wherever the 1-rank step moved an element by more
    than 0.99 lr (AdamW's first step is lr g / (|g| + eps); a smaller step
    means |g| near eps, where the order of the sums decides the step) and
    within 2 lr everywhere; ``--fsdp 2`` and ``--tensor-parallel 2`` train;
  - checkpoints: written under fsdp 2 x model 2 (4 ranks) they hold the
    one-card state (the parameters as tests/test_torch_parallel.py holds a
    step to the one-card step), load into the one-card port and into
    lrce_tpu with the same tensors, and a run resumed from one (a fresh
    agent in the same ranks) equals the uninterrupted run bit for bit;
  - schedulers: two ranks whose local accuracies are 1 and 0 see the same
    global accuracy and take the same ReduceLROnPlateau decisions as the
    one-card scheduler fed that accuracy;
  - dry run: 2, 4 and 8 ranks.
"""

import os

import numpy as np
import pytest
import torch

from lrce_tpu.utils import checkpoint as JCk
from lrce_tpu_torch import config as PC
from lrce_tpu_torch.cli import eval as PEv
from lrce_tpu_torch.cli import train as PTr
from lrce_tpu_torch.cli import train_ddp as PTd
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.parallel import dryrun as PD
from lrce_tpu_torch.parallel import mesh as PM
from lrce_tpu_torch.parallel import rank_checks as RC
from lrce_tpu_torch.parallel import sharding as PSh
from lrce_tpu_torch.train.schedule import ReduceLROnPlateau
from lrce_tpu_torch.utils import checkpoint as PCk
from lrce_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_cli import _make_tgif, tiny_cfg  # noqa: E402
from test_torch_parallel import (BATCHES, PORT_CFG, RANK_TIMEOUT,  # noqa: E402,F401
                                 assert_params_close, decided, grads,
                                 make_args, make_batch, one_card,
                                 rank_timeout, start)

CLI_LR = 1e-4
VAL_LOSS_REL = 1e-5
PARAM_REL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tgif_dir(tmp_path, monkeypatch):
    data = _make_tgif(tmp_path / "tgif")
    monkeypatch.setenv("LRCE_TPU_BERT_VOCAB", str(data / "vocab.txt"))
    return data


def _argv(data, log_dir, batch, *extra):
    return ["--dataset", "tgif-frameqa", "--dataset-dir", str(data),
            "--log-dir", str(log_dir), "--batch-size", str(batch),
            "--epoch", "1", "--num-workers", "1", "--lr", str(CLI_LR),
            "--reg-strength", "0", "--drop-out-rate", "0",
            "--temporal-scale", "1", *extra]


def _parse(parse, argv):
    """The CLI's namespace for ``argv``, without TensorBoard scalars."""
    args = parse(argv)
    args.tensorboard = False
    return args


def _cfg(args):
    """tests/test_torch_cli.py's tiny model with BERT's dropout 0 too (the
    ranks draw their own masks)."""
    cfg = tiny_cfg(args)
    return cfg._replace(bert=cfg.bert._replace(hidden_dropout=0.0,
                                               attention_dropout=0.0))


def _state(path):
    return {k: v.numpy() for k, v in
            PCk.load_checkpoint(str(path), "cpu")["model_state_dict"].items()}


def _run_dirs(log_dir):
    return sorted(os.listdir(log_dir))


# ---------------------------------------------------------------------------
# Command lines
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def test_train_ddp_validates_on_the_test_split(tgif_dir, tmp_path,
                                               monkeypatch):
    """train_ddp builds its validation set from the test split (the root
    train_ddp.py:29-31), the train CLI from val."""
    seen = []

    def record(args, splits=("train", "val")):
        seen.append(tuple(splits))
        raise _Stop

    monkeypatch.setattr(PTr, "build_datasets", record)
    for cli, parse in ((PTd, PTd.parse_arg_train), (PTr, PC.parse_arg_train)):
        args = _parse(parse, _argv(tgif_dir, tmp_path / "runs", 4))
        with pytest.raises(_Stop):
            cli.main(args, device="cpu", model_cfg=_cfg(args))
    assert seen == [("train", "test"), ("train", "val")]


def test_train_ddp_two_ranks_equal_one_rank_at_twice_the_batch(tgif_dir,
                                                               tmp_path):
    """cli.train_ddp (the legacy parser's temporal scale by default; one
    clip a question here) at world 2, batch 2: one run directory and one
    best.pt (rank 0's), and the epoch of one rank at batch 4 (the same
    four questions in one global batch)."""
    assert PTd.parse_arg_train(["--dataset", "tgif-frameqa", "--dataset-dir",
                                "."]).temporal_scale == [1, 2, 3]
    one = _parse(PTd.parse_arg_train, _argv(tgif_dir, tmp_path / "one", 4))
    trainer = PTd.main(one, device="cpu", model_cfg=_cfg(one))
    two = _parse(PTd.parse_arg_train, _argv(tgif_dir, tmp_path / "two", 2))
    out = PTd.main(two, device="cpu", model_cfg=_cfg(two), world_size=2)
    (run,) = _run_dirs(tmp_path / "two")
    files = os.listdir(tmp_path / "two" / run / "weights")
    assert files.count("best.pt") == 1 and not any(".tmp" in f for f in files)
    assert out.counter == trainer.counter == 1
    np.testing.assert_allclose(out.last_loss, trainer.last_loss,
                               rtol=VAL_LOSS_REL)
    np.testing.assert_allclose(out.last_train_loss, trainer.last_train_loss,
                               rtol=VAL_LOSS_REL)
    assert out.last_metric_val == trainer.last_metric_val
    got = _state(os.path.join(out.ckpt_dir, "best.pt"))
    want = _state(os.path.join(trainer.args.ckpt_dir, "best.pt"))
    start = {k: v.detach().numpy() for k, v in
             PTr.build_model(one, torch.device("cpu"),
                             _cfg(one)).state_dict().items()}
    for name, w in want.items():
        d = np.abs(got[name] - w)
        assert d.max() <= 2 * CLI_LR * 1.001, name
        decided = np.abs(w - start[name]) > 0.99 * CLI_LR
        if decided.any():
            assert d[decided].max() <= PARAM_REL * np.abs(w).max(), name


@pytest.mark.parametrize("flag", ["--fsdp", "--tensor-parallel"])
def test_sharded_cli_trains_and_evaluates(tgif_dir, tmp_path, flag):
    """--fsdp 2 / --tensor-parallel 2 at world 2 train an epoch; rank 0's
    best.pt is a whole one-card state that the one-card eval CLI reads."""
    args = _parse(PC.parse_arg_train, _argv(tgif_dir, tmp_path / "runs", 2,
                                            flag, "2"))
    out = PTr.main(args, device="cpu", model_cfg=_cfg(args),
                   world_size=2)
    assert np.isfinite(out.last_train_loss) and np.isfinite(out.last_loss)
    best = os.path.join(out.ckpt_dir, "best.pt")
    model = PE.LRCEModel(_cfg(args), device="cpu")
    model.load_state_dict(PCk.load_checkpoint(best, "cpu")["model_state_dict"])
    ev = PC.parse_arg_eval(["--dataset", "tgif-frameqa", "--dataset-dir",
                            str(tgif_dir), "--model-path", best,
                            "--batch-size", "2", "--num-workers", "1",
                            "--temporal-scale", "1"])
    evaluator = PEv.main(ev, device="cpu", model_cfg=_cfg(ev))
    assert np.isfinite(evaluator.last_loss)


# ---------------------------------------------------------------------------
# Checkpoints under sharding
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded_run(start, tmp_path_factory):
    """fsdp 2 x model 2 on 4 ranks: a train step, a full-state checkpoint,
    a second step; then, in the same ranks, a fresh agent that resumes from
    the checkpoint and takes the second step."""
    torch.set_num_threads(1)
    ckpt = tmp_path_factory.mktemp("sharded_ckpt")
    path = ckpt / "ckpt.pt"
    out = PM.spawn(RC.agent_run, 4,
                   (PORT_CFG, start["state"], BATCHES, 2, 2, make_args(),
                    [("train", 0), ("save", str(ckpt), False), ("train", 1),
                     ("snapshot",), ("fresh",), ("load", str(path), False),
                     ("train", 1)]), device="cpu", threads=1,
                   timeout=RANK_TIMEOUT)
    return {"whole": out["snapshots"][0], "seen": out["seen"],
            "resumed": out, "path": path}


def test_sharded_checkpoint_holds_the_one_card_step(start, grads,
                                                    sharded_run):
    """The checkpoint's parameters and AdamW moments are the one-card
    step's (the gather put every shard back in its place), the moments
    where the gradient is decided (they hold g and g^2)."""
    ref = one_card(start["state"])
    ref.step(*BATCHES[0], is_train=True)
    want = {k: v.detach().numpy() for k, v in ref.model.state_dict().items()}
    assert_params_close(_state(sharded_run["path"]), want, grads)
    moments = torch.load(sharded_run["path"], weights_only=True)[
        "optimizer_state_dict"]["state"]
    names = PSh.param_names(ref.model, ref.optimizer)
    assert len(moments) == len(names)
    for i, p in enumerate(p for g in ref.optimizer.param_groups
                          for p in g["params"]):
        mask = decided(grads[names[i]])
        for k in ("exp_avg", "exp_avg_sq"):
            m = ref.optimizer.state[p][k].numpy()
            got = moments[i][k].numpy()
            assert got.shape == m.shape, names[i]
            if mask.any():
                assert (np.abs(got - m)[mask].max()
                        <= PARAM_REL * np.abs(m).max()), (names[i], k)


def test_sharded_checkpoint_loads_into_the_one_card_port_and_lrce_tpu(
        sharded_run):
    path = str(sharded_run["path"])
    sd = PCk.load_checkpoint(path, "cpu")["model_state_dict"]
    model = PE.LRCEModel(PORT_CFG, device="cpu")
    model.load_state_dict(sd)
    for name, t in model.state_dict().items():
        assert torch.equal(t, sd[name]), name
    params = JCk.load_checkpoint(path)["model_state_dict"]
    back = state_dict_from_jax(params)
    assert set(back) == set(sd)
    for name, t in back.items():
        assert torch.equal(t, sd[name]), name


def test_resumed_sharded_run_equals_the_uninterrupted_run(sharded_run):
    whole, resumed = sharded_run["whole"], sharded_run["resumed"]
    for seen in sharded_run["seen"]:        # step 2's stats on every rank
        assert seen[1] == seen[2]
    for name, w in whole["state"].items():
        np.testing.assert_array_equal(resumed["state"][name], w, name)
    for i, s in whole["optimizer"].items():
        for k, v in s.items():
            np.testing.assert_array_equal(resumed["optimizer"][i][k], v)


# ---------------------------------------------------------------------------
# Schedulers across ranks
# ---------------------------------------------------------------------------

def test_ranks_take_the_same_plateau_decision(start):
    args = make_args(patience=0, lr_decay_factor=0.5)
    every = PM.spawn(RC.plateau_run, 2,
                     (PORT_CFG, start["state"], make_batch(4, 5), args),
                     device="cpu", threads=1, timeout=RANK_TIMEOUT)
    assert [r["local_accuracy"] for r in every] == [1.0, 0.0]
    assert every[0]["after"] == every[1]["after"]
    sched = ReduceLROnPlateau(list(args.lr), mode="max", factor=0.5,
                              patience=0, min_lr=args.min_lr)
    want = [(0.5, list(sched.step(0.5))) for _ in range(3)]
    assert every[0]["after"] == want
    assert want[-1][1] != list(args.lr)     # the run did decay


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mesh", [
    (2, {"data": 2, "fsdp": 1, "model": 1}),
    (4, {"data": 2, "fsdp": 1, "model": 2}),
    (8, {"data": 2, "fsdp": 2, "model": 2})])
def test_dryrun(n, mesh):
    out = PD.dryrun_multichip(n, "cpu")
    assert out["mesh"] == mesh
    assert np.isfinite(out["loss"]) and np.isfinite(out["eval_loss"])
    assert out["total"] == mesh["data"] * mesh["fsdp"]
    if mesh["fsdp"] > 1:
        (shard, full) = out["word_shard"]
        assert shard[1] * 2 == full[1] and shard[0] == full[0]
