"""The port's host loop (lrce_tpu_torch: data/, utils/checkpoint.py,
pretrained.py, config.py, train/agent.py's do_training and checkpoints)
against lrce_tpu's, on the CPU, the same numpy-seeded data on both sides.

Tolerances:
  - sampler / loader / clip indices, checkpoint names, parsed namespaces:
    exact (the same integer and string code);
  - checkpoint round trips: the logits of a tiny e2e model after the trip
    through the other framework's loader within 5e-4 of the JAX forward on
    the original weights (the composed-forward tolerance of
    tests/test_torch_e2e.py: the weights make the trip bit-exactly, the
    forwards differ in summation order);
  - ``do_training`` for 2 epochs against lrce_tpu's on the same data and
    weights, dropout off: each validation loss within 1e-3 relative.
    AdamW's first steps are about lr * sign(g); the two sides' gradients
    agree to ~1e-4 of their largest value (tests/test_torch_train.py), so
    only gradients that are noise on both sides move differently, by at
    most lr = 3e-4 each.

The tiny model is tests/test_torch_train.py's (Swin embed 8, BERT 36 wide)
at 64 x 64 frames (video_feature_res (2, 2)), which keeps the 2-epoch
parity run under a minute.
"""

import ast
import os
import pickle
import re
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lrce_tpu import config as JC
from lrce_tpu.data import loader as JLd
from lrce_tpu.data import sampling as JSm
from lrce_tpu.models import bert as B
from lrce_tpu.models import e2e as E
from lrce_tpu.models import swin3d as S
from lrce_tpu.train import agent as JA
from lrce_tpu.utils import checkpoint as JCk
from lrce_tpu.utils import torch_io as JIO
from lrce_tpu_torch import config as PC
from lrce_tpu_torch import pretrained as PPre
from lrce_tpu_torch.data import loader as PLd
from lrce_tpu_torch.data import sampling as PSm
from lrce_tpu_torch.data.prefetch import device_prefetch
from lrce_tpu_torch.models import bert as PB
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.train import agent as PA
from lrce_tpu_torch.utils import checkpoint as PCk
from lrce_tpu_torch.utils import convert as PCv
from lrce_tpu_torch.utils.convert import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)
FRAME = 64                      # 64 / 32 = 2: video_feature_res (2, 2)


# ---------------------------------------------------------------------------
# data/: sampler, loader, clip indices, prefetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,replicas,shuffle,seed,epoch", [
    (10, 1, True, 0, 0), (10, 4, True, 3, 2), (7, 3, False, 0, 0),
    (2, 5, True, 1, 0)])
def test_sampler_indices_equal(n, replicas, shuffle, seed, epoch):
    for rank in range(replicas):
        np.testing.assert_array_equal(
            PLd.distributed_sampler_indices(n, replicas, rank, shuffle, seed,
                                            epoch),
            JLd.distributed_sampler_indices(n, replicas, rank, shuffle, seed,
                                            epoch))
    got = PLd.global_batch_indices(n, 3, replicas, shuffle, seed, epoch)
    want = JLd.global_batch_indices(n, 3, replicas, shuffle, seed, epoch)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("frames,per_clip,scales", [
    (40, 5, (1, 2, 3)), (16, 5, (3,)), (100, 5, (4, 1)), (5, 5, (1,))])
def test_clip_indices_equal(frames, per_clip, scales):
    np.testing.assert_array_equal(PSm.clip_indices(frames, per_clip, scales),
                                  JSm.clip_indices(frames, per_clip, scales))
    assert PSm.build_scale_idx(scales) == JSm.build_scale_idx(scales)
    video = np.arange(frames * 2 * 2 * 3).reshape(frames, 2, 2, 3)
    np.testing.assert_array_equal(PSm.sample_clips(video, per_clip, scales),
                                  JSm.sample_clips(video, per_clip, scales))


def test_clip_indices_reject_short_videos():
    with pytest.raises(ValueError, match="frames"):
        PSm.clip_indices(3, 5, (1,))
    with pytest.raises(ValueError, match="frames"):
        JSm.clip_indices(3, 5, (1,))


class _Items:
    """An in-memory dataset: item i is (i * ones(2, 3), i)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 3), i, np.float32), np.int64(i)


@pytest.mark.parametrize("replicas,shuffle", [(1, True), (2, True), (1, False)])
def test_dataloader_batches_equal(replicas, shuffle):
    kw = dict(batch_size=3, num_replicas=replicas, shuffle=shuffle, seed=5,
              num_workers=2)
    ours, ref = PLd.DataLoader(_Items(11), **kw), JLd.DataLoader(_Items(11), **kw)
    assert len(ours) == len(ref)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert len(a) == len(b) == 2
            for u, v in zip(a, b):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


def test_device_prefetch_cpu_yields_batches_in_order():
    batches = [(np.full((2, 4), i, np.uint8), np.arange(3) + i) for i in range(5)]
    for depth in (1, 2, 8):
        out = list(device_prefetch(iter(batches), "cpu", depth=depth))
        assert len(out) == len(batches)
        for got, want in zip(out, batches):
            assert all(torch.is_tensor(t) and t.device.type == "cpu"
                       for t in got)
            for t, a in zip(got, want):
                assert t.dtype == torch.from_numpy(a).dtype
                np.testing.assert_array_equal(t.numpy(), a)
    assert list(device_prefetch(iter([]), "cpu")) == []


def test_entry_points_default_to_the_card_and_raise_without_one(tmp_path):
    """No CUDA here: the defaults must raise, not carry on on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_prefetch(iter([(np.zeros(2),)])))
    path = tmp_path / "x.pt"
    PCk.save_checkpoint(str(path), {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PCk.load_checkpoint(str(path))
    assert torch.equal(PCk.load_checkpoint(str(path), "cpu")
                       ["model_state_dict"]["w"], torch.ones(2))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

TRAIN_ARGV = {
    "defaults": ["--dataset", "msvd-qa-oe", "--dataset-dir", "/d"],
    "cosine": ["--dataset", "tgif-count", "--dataset-dir", "/d",
               "--use-cosine-scheduler", "--lr", "1e-4", "2e-4", "3e-4",
               "--lr-restart-epoch", "3", "--epoch", "7", "--ckpt-steps", "50",
               "--no-async-checkpoint", "--save-full-state"],
    "hinge": ["--dataset", "tgif-action", "--dataset-dir", "/d",
              "--use-hinge-loss", "--margin", "0.5", "--comment", "try",
              "--temporal-scale", "1", "2", "--batch-size", "4",
              "--debug-mode", "--no-uint8-transfer"],
}


@pytest.mark.parametrize("case", list(TRAIN_ARGV))
def test_train_parser_gives_the_same_namespace(case):
    assert vars(PC.parse_arg_train(TRAIN_ARGV[case])) == \
        vars(JC.parse_arg_train(TRAIN_ARGV[case]))


def test_eval_parser_and_model_configs_equal():
    argv = ["--dataset", "tgif-transition", "--dataset-dir", "/d",
            "--model-path", "m.pt", "--batch-size", "8", "--use-hinge-loss"]
    assert vars(PC.parse_arg_eval(argv)) == vars(JC.parse_arg_eval(argv))
    assert PC.DATASET_CHOICES == JC.DATASET_CHOICES
    for name in PC.DATASET_CHOICES:
        assert PC.load_model_config(name) == JC.load_model_config(name)
    assert PC.num_clips([1, 2, 3]) == JC.num_clips([1, 2, 3]) == 6
    # the agents' defaults come from the parser
    d = PA.default_args(lr=[1e-3] * 3)
    assert d.lr == [1e-3] * 3 and d.reg_strength == 0.001
    assert d.patience == 0.5 and not d.use_cosine_scheduler


# ---------------------------------------------------------------------------
# the tiny model
# ---------------------------------------------------------------------------

def tiny_configs(rate: float = 0.0):
    kw = dict(feature_dim=36, num_classes=11, video_feature_res=(2, 2),
              video_feature_dim=64, frame_sample_size=5, temporal_scale=(3,),
              text_seq_len=8, task_type="oe", drop_out_rate=rate)
    bert = dict(hidden_size=36, num_layers=2, num_heads=2,
                intermediate_size=72, hidden_dropout=rate,
                attention_dropout=rate)
    swin = dict(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
                drop_path_rate=rate)
    return (E.E2EConfig(**kw, bert=B.BertConfig(**bert),
                        swin=S.SwinConfig(**swin)),
            PE.E2EConfig(**kw, bert=PB.BertConfig(**bert),
                         swin=PS.SwinConfig(**swin)))


class _QA:
    """An in-memory VideoQA dataset made from a seed: uint8 clips, token
    ids, mask, type ids, label."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.clips = rng.integers(0, 256, (n, 3, 5, FRAME, FRAME, 3),
                                  dtype=np.uint8)
        self.ids = rng.integers(0, 1000, (n, 8))
        self.mask = np.ones((n, 8), np.int64)
        self.mask[:, 6:] = 0
        self.gt = rng.integers(0, 11, (n,))

    def __len__(self):
        return len(self.gt)

    def __getitem__(self, i):
        return (self.clips[i], self.ids[i], self.mask[i],
                np.zeros((8,), np.int64), self.gt[i])


def _jax_logits(jcfg, params, batch):
    clips, ids, mask, types = batch[:4]
    return np.asarray(E.e2e_forward(
        jax.tree.map(jnp.asarray, params), clips, ids.astype(np.int32),
        mask.astype(np.int32), types.astype(np.int32), jcfg))


def _port_logits(model, batch):
    return PE.e2e_forward(model, *(torch.from_numpy(np.asarray(a))
                                   for a in batch[:4])).numpy()


@pytest.fixture(scope="module")
def tiny():
    jcfg, pcfg = tiny_configs()
    params = jax.tree.map(np.asarray, E.e2e_init(jax.random.PRNGKey(0), jcfg))
    batch = PLd.default_collate([_QA(2, 1)[i] for i in range(2)])
    return jcfg, pcfg, params, batch, _jax_logits(jcfg, params, batch)


def _train_args(log_dir, **kw):
    return SimpleNamespace(**{**dict(
        lr=[1e-4, 2e-4, 3e-4], min_lr=1e-8, lr_decay_factor=0.5, patience=1,
        use_cosine_scheduler=False, reg_strength=0.001, use_hinge_loss=False,
        epoch=2, ckpt_interval=1, log_dir=str(log_dir), dataset="msvd-qa-oe",
        async_checkpoint=True, debug_mode=False), **kw})


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_name_equal():
    for args in ((3, 1.23456, 0.5), (12, 0.0, 0.98765), (1, 10.5, 0.0)):
        assert PCk.checkpoint_name(*args) == JCk.checkpoint_name(*args)


def test_port_checkpoint_loads_into_lrce_tpu(tiny, tmp_path):
    jcfg, pcfg, params, batch, want = tiny
    model = PE.LRCEModel(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    path = str(tmp_path / "epoch01_loss0.0000_metric0.0000.pt")
    PCk.save_checkpoint(path, model.state_dict())
    assert os.listdir(tmp_path) == [os.path.basename(path)]     # no .tmp left
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"                               # a torch zip
    loaded = JCk.load_checkpoint(path)["model_state_dict"]
    jax.tree.map(np.testing.assert_array_equal, loaded, params)
    np.testing.assert_allclose(_jax_logits(jcfg, loaded, batch), want,
                               **LOGIT_TOL)
    np.testing.assert_allclose(_port_logits(model, batch), want, **LOGIT_TOL)


def test_lrce_tpu_native_checkpoint_loads_into_port(tiny, tmp_path):
    jcfg, pcfg, params, batch, want = tiny
    path = str(tmp_path / "native.pt")
    JCk.save_checkpoint(path, params, opt_state={"mu": params["fusion_model"]},
                        scheduler_state={"best": 0.25})
    ckpt = PCk.load_checkpoint(path, "cpu")
    assert "optimizer_state_dict" not in ckpt   # each framework's own format
    assert ckpt["scheduler_state_dict"] == {"best": 0.25}
    model = PE.LRCEModel(pcfg, device="cpu",
                         generator=torch.Generator().manual_seed(9))
    model.load_state_dict(ckpt["model_state_dict"])
    np.testing.assert_allclose(_port_logits(model, batch), want, **LOGIT_TOL)


@pytest.mark.parametrize("kind", ["torch-zip", "native-pickle"])
def test_truncated_checkpoint_raises_corruption(tiny, tmp_path, kind):
    _, pcfg, params, _, _ = tiny
    path = str(tmp_path / "cut.pt")
    if kind == "torch-zip":
        PCk.save_checkpoint(path, state_dict_from_jax(params))
    else:
        JCk.save_checkpoint(path, params)
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[:len(data) // 2])
    with pytest.raises(RuntimeError, match="truncated or corrupt"):
        PCk.load_checkpoint(path, "cpu")
    with pytest.raises(FileNotFoundError):
        PCk.load_checkpoint(str(tmp_path / "absent.pt"), "cpu")


def test_pickle_without_model_state_dict_is_refused(tmp_path):
    path = tmp_path / "other.pt"
    with open(path, "wb") as f:
        pickle.dump({"weights": np.zeros(3)}, f, protocol=4)
    with pytest.raises(RuntimeError, match="truncated or corrupt"):
        PCk.load_checkpoint(str(path), "cpu")


def _agent(pcfg, params, args, **kw):
    model = PE.LRCEModel(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return PA.AgentOE(model, args, **kw)


def test_async_save_snapshots_the_state_and_leaves_no_tmp(tiny, tmp_path):
    _, pcfg, params, _, _ = tiny
    agent = _agent(pcfg, params, _train_args(tmp_path))
    assert os.path.isfile(os.path.join(agent.args.log_dir, "config.json"))
    before = {k: v.clone() for k, v in agent.model.state_dict().items()}
    agent.save_checkpoint(1, "best")
    with torch.no_grad():               # the next step, before the writer ends
        for p in agent.model.parameters():
            p.add_(1.0)
    agent.finish_pending_checkpoint()
    assert sorted(os.listdir(agent.args.ckpt_dir)) == ["best.pt"]
    saved = PCk.load_checkpoint(os.path.join(agent.args.ckpt_dir, "best.pt"),
                                "cpu")
    assert set(saved) == {"model_state_dict"}
    for k, v in before.items():
        assert torch.equal(saved["model_state_dict"][k], v), k
    # the epoch's file under the reference's naming, blocking this time
    agent.args.async_checkpoint = False
    agent.last_loss, agent.last_metric_val = 1.5, 0.25
    agent.save_checkpoint(2)
    assert sorted(os.listdir(agent.args.ckpt_dir)) == [
        "best.pt", "epoch02_loss1.5000_metric0.2500.pt"]


def test_failing_checkpoint_writer_raises_at_finish(tiny, tmp_path, monkeypatch):
    _, pcfg, params, _, _ = tiny
    agent = _agent(pcfg, params, _train_args(tmp_path))

    def full_disk(*a, **k):
        raise OSError("no space left on device")

    monkeypatch.setattr(PCk, "save_checkpoint", full_disk)
    agent.save_checkpoint(1, "best")
    with pytest.raises(RuntimeError, match="NOT saved") as info:
        agent.finish_pending_checkpoint()
    assert isinstance(info.value.__cause__, OSError)
    agent.finish_pending_checkpoint()       # raised once, then clear
    agent.save_checkpoint(1, "best")
    with pytest.raises(RuntimeError, match="NOT saved"):
        agent.save_checkpoint(2, "best")    # the next save raises it too
    agent.finish_pending_checkpoint()


def test_full_state_checkpoint_restores_optimizer_and_scheduler(tiny, tmp_path):
    _, pcfg, params, _, _ = tiny
    args = _train_args(tmp_path, save_full_state=True)
    agent = _agent(pcfg, params, args)
    batch = PLd.default_collate([_QA(2, 2)[i] for i in range(2)])
    agent.step(*batch, is_train=True)
    agent.scheduler.step(0.5)
    agent.save_checkpoint(1, "latest")
    agent.finish_pending_checkpoint()
    other = _agent(pcfg, params, _train_args(tmp_path, save_full_state=True),
                   log_enabled=False)
    other.load_checkpoint(os.path.join(agent.args.ckpt_dir, "latest.pt"))
    for a, b in zip(agent.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = agent.optimizer.state_dict(), other.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys() and sa["state"]
    for k in sa["state"]:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])
    assert other.scheduler.state_dict() == agent.scheduler.state_dict()
    # model only: the optimizer of a third agent stays empty
    third = _agent(pcfg, params, _train_args(tmp_path), log_enabled=False)
    third.load_checkpoint(os.path.join(agent.args.ckpt_dir, "latest.pt"))
    assert not third.optimizer.state_dict()["state"]


def test_load_checkpoint_leaves_lrs_as_lrce_tpu_does(tiny, tmp_path):
    """A full-state checkpoint whose scheduler has cut the rates: after
    load_checkpoint, each agent keeps its constructor's rates in ``lrs``
    (until the scheduler next steps) and holds the restored scheduler."""
    jcfg, pcfg, params, _, _ = tiny
    kw = dict(save_full_state=True, async_checkpoint=False)
    saver = _agent(pcfg, params, _train_args(tmp_path / "port", **kw))
    jsaver = JA.AgentOE(jcfg, jax.tree.map(jnp.asarray, params),
                        _train_args(tmp_path / "jax", **kw),
                        compute_dtype=jnp.float32)
    for a in (saver, jsaver):
        for _ in range(4):              # no improvement: patience 1 cuts
            a.scheduler.step(0.5)
        a.save_checkpoint(1, "latest")
    assert saver.scheduler.lrs == jsaver.scheduler.lrs != saver.lrs
    ours = _agent(pcfg, params, _train_args(tmp_path / "port2", **kw),
                  log_enabled=False)
    ours.load_checkpoint(os.path.join(saver.args.ckpt_dir, "latest.pt"))
    ref = JA.AgentOE(jcfg, jax.tree.map(jnp.asarray, params),
                     _train_args(tmp_path / "jax2", **kw), log_enabled=False,
                     compute_dtype=jnp.float32)
    ref.load_checkpoint(os.path.join(jsaver.args.ckpt_dir, "latest.pt"))
    assert list(ours.lrs) == list(ref.lrs) == [1e-4, 2e-4, 3e-4]
    assert ours.scheduler.lrs == ref.scheduler.lrs == saver.scheduler.lrs


class _FailsAt(_Items):
    def __getitem__(self, i):
        if i == 7:
            raise KeyError("item 7 is unreadable")
        return super().__getitem__(i)


@pytest.mark.parametrize("workers", [1, 3])
def test_dataloader_raises_a_dataset_error_instead_of_hanging(workers):
    import threading

    got = {}

    def consume():
        try:
            list(PLd.DataLoader(_FailsAt(11), batch_size=3, shuffle=False,
                                num_workers=workers))
        except KeyError as err:
            got["error"] = err

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(30)      # its own time limit: a hang fails here, not the suite
    assert not t.is_alive(), "the loader hung on a failing item"
    assert "item 7" in str(got.get("error"))


# ---------------------------------------------------------------------------
# pretrained
# ---------------------------------------------------------------------------

def test_load_pretrained_overlays_swin_and_bert(tiny, tmp_path, monkeypatch):
    _, pcfg, _, _, _ = tiny
    donor = PE.LRCEModel(pcfg, device="cpu",
                         generator=torch.Generator().manual_seed(21))
    swin_sd = {f"backbone.{k}": v for k, v in
               donor.video_extractor.swin.state_dict().items()}
    swin_sd["cls_head.fc_cls.weight"] = torch.zeros(3, 64)     # ignored
    bert_sd = {f"bert.{k}": v for k, v in
               donor.text_extractor.bert.state_dict().items()}
    bert_sd["cls.predictions.bias"] = torch.zeros(5)           # ignored
    torch.save({"state_dict": swin_sd}, tmp_path / "swin.pth")
    torch.save(bert_sd, tmp_path / "bert.bin")

    model = PE.LRCEModel(pcfg, device="cpu")
    fusion_before = {k: v.clone() for k, v in
                     model.fusion_model.state_dict().items()}
    out = PPre.load_pretrained(model, str(tmp_path / "swin.pth"),
                               str(tmp_path / "bert.bin"))
    assert out is model
    for part in ("video_extractor", "text_extractor"):
        for (k, a), b in zip(getattr(model, part).state_dict().items(),
                             getattr(donor, part).state_dict().values()):
            assert torch.equal(a, b), k
    for k, v in model.fusion_model.state_dict().items():
        assert torch.equal(v, fusion_before[k])

    # absent files: a warning each, the weights untouched
    monkeypatch.chdir(tmp_path)
    fresh = PE.LRCEModel(pcfg, device="cpu")
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    PPre.load_pretrained(fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, before[k])
    # a 2D Swin file (4-D patch-embed kernel, 13 x 13 bias tables) is
    # inflated on the way in
    sd2d = {k[len("backbone."):]: v for k, v in swin_sd.items()
            if k.startswith("backbone.")}
    sd2d["patch_embed.proj.weight"] = sd2d["patch_embed.proj.weight"][:, :, 0]
    tables = [k for k in sd2d if "relative_position_bias_table" in k]
    for k in tables:
        sd2d[k] = sd2d[k][:13 * 13].clone()
    torch.save(sd2d, tmp_path / "swin2d.pth")
    PPre.load_pretrained(fresh, str(tmp_path / "swin2d.pth"))
    got = fresh.video_extractor.swin.state_dict()
    assert torch.equal(got["patch_embed.proj.weight"],
                       sd2d["patch_embed.proj.weight"][:, :, None]
                       .repeat(1, 1, 2, 1, 1) / 2)
    assert torch.equal(got[tables[0]], sd2d[tables[0]].repeat(15, 1))
    # a file that lacks a tensor is refused
    del swin_sd["backbone.norm.weight"]
    torch.save({"state_dict": swin_sd}, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="lacks"):
        PPre.load_pretrained(fresh, str(tmp_path / "short.pth"))


def test_inflate_swin2d_matches_lrce_tpu():
    rng = np.random.default_rng(4)
    sd = {"patch_embed.proj.weight": rng.normal(size=(8, 3, 4, 4)),
          "layers.0.blocks.0.attn.relative_position_bias_table":
              rng.normal(size=(13 * 13, 2)),          # a 7 x 7 window: as is
          "layers.1.blocks.0.attn.relative_position_bias_table":
              rng.normal(size=(23 * 23, 2)),          # a 12 x 12 window: resized
          "layers.0.blocks.0.attn.relative_position_index":
              rng.integers(0, 9, (49, 49)).astype(np.float64),
          "norm.weight": rng.normal(size=(64,))}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    want = JIO.inflate_swin2d(sd, (8, 7, 7), 2)
    got = PCv.inflate_swin2d({k: torch.from_numpy(v) for k, v in sd.items()},
                             (8, 7, 7), 2)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert got["patch_embed.proj.weight"].shape == (8, 3, 2, 4, 4)
    # load_pretrained inflates a 2D file by itself
    assert PCv.strip_prefix({"backbone.a": 1, "b": 2}, "backbone.") == {"a": 1}


# ---------------------------------------------------------------------------
# do_training against lrce_tpu's
# ---------------------------------------------------------------------------

def _record_validations(agent):
    seen = []
    real = agent.is_metric_val_better

    def wrapped(epoch=None):
        seen.append((epoch, agent.last_loss, agent.last_metric_val))
        return real(epoch)

    agent.is_metric_val_better = wrapped
    return seen


def test_do_training_matches_lrce_tpu(tiny, tmp_path):
    jcfg, pcfg, params, _, _ = tiny
    train, val = _QA(8, 10), _QA(4, 11)
    kw = dict(batch_size=4, shuffle=True, seed=3, num_workers=2)

    jagent = JA.AgentOE(jcfg, jax.tree.map(jnp.asarray, params),
                        _train_args(tmp_path / "jax"), log_enabled=False,
                        compute_dtype=jnp.float32)
    jseen = _record_validations(jagent)
    jagent.do_training(JLd.DataLoader(train, **kw),
                       JLd.DataLoader(val, **{**kw, "shuffle": False}),
                       eval_per_epoch=2)

    agent = _agent(pcfg, params, _train_args(tmp_path / "port"))
    seen = _record_validations(agent)
    train_dl = PLd.DataLoader(train, **kw)
    val_dl = PLd.DataLoader(val, **{**kw, "shuffle": False})
    agent.do_training(train_dl, val_dl, eval_per_epoch=2)

    assert len(seen) == len(jseen) == 4      # 2 epochs x (mid + end)
    assert agent.counter == jagent.counter == 4
    for (e, loss, metric), (je, jloss, jmetric) in zip(seen, jseen):
        assert e == je
        np.testing.assert_allclose(loss, jloss, rtol=1e-3)
        assert metric == jmetric
    assert agent.best_epoch == jagent.best_epoch
    np.testing.assert_allclose(agent.last_train_loss, jagent.last_train_loss,
                               rtol=1e-3)

    # the run's files: config.json, best.pt, one checkpoint per epoch
    files = sorted(os.listdir(agent.args.ckpt_dir))
    assert not [f for f in files if f.endswith(".tmp")]
    assert "best.pt" in files
    assert [f for f in files if f.startswith("epoch01_")]
    assert [f for f in files if f.startswith("epoch02_")]
    assert os.path.isfile(os.path.join(agent.args.log_dir, "config.json"))
    assert agent._ckpt_thread is None

    # best.pt reproduces the validation it was saved at
    best = [s for s in seen if s[0] == agent.best_epoch
            and s[2] == agent.best_metric_val][0]
    fresh = PA.AgentOE(PE.LRCEModel(pcfg, device="cpu"),
                       _train_args(tmp_path / "eval"), log_enabled=False,
                       is_eval=True)
    fresh.load_checkpoint(os.path.join(agent.args.ckpt_dir, "best.pt"))
    fresh.do_evaluation(val_dl)
    np.testing.assert_allclose(fresh.last_loss, best[1], rtol=1e-6)
    assert fresh.last_metric_val == best[2]


def test_sanity_check_and_rolling_checkpoint(tiny, tmp_path):
    _, pcfg, params, _, _ = tiny
    args = _train_args(tmp_path, ckpt_steps=2, async_checkpoint=False,
                       lr=[1e-3] * 3)
    agent = _agent(pcfg, params, args)
    dl = PLd.DataLoader(_QA(4, 12), batch_size=2, shuffle=False, num_workers=1)
    agent.do_sanity_check(dl)
    assert agent.counter == 4 and np.isfinite(agent.last_train_loss)
    assert os.listdir(agent.args.ckpt_dir) == ["latest.pt"]
    empty = PLd.DataLoader(_QA(0, 0), batch_size=2, shuffle=False)
    deque(agent.process_data(empty, True, 0), maxlen=0)
    assert np.isnan(agent.last_train_loss)


# ---------------------------------------------------------------------------
# the port imports neither jax nor lrce_tpu
# ---------------------------------------------------------------------------

def _port_sources():
    return sorted((REPO / "lrce_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_lrce_tpu():
    banned = ("jax", "lrce_tpu", "flax", "optax")
    checked = 0
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, (str(path), name)
        checked += 1
    assert checked > 25


TP_NAMES = re.compile(r"\b(tp_group|reduce_group|copy_to_tp|reduce_from_tp)\b")


def test_lower_layers_know_nothing_of_tensor_parallelism():
    """Tensor parallelism lives behind ``lrce_tpu_torch/parallel/``: no
    module of ops/, models/ or utils/ imports it or names its groups and
    collectives."""
    checked = 0
    for layer in ("ops", "models", "utils"):
        for path in sorted((REPO / "lrce_tpu_torch" / layer).rglob("*.py")):
            text = path.read_text()
            assert not TP_NAMES.search(text), (str(path),
                                               TP_NAMES.search(text)[0])
            for node in ast.walk(ast.parse(text, str(path))):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [f"{node.module}.{a.name}" for a in node.names]
                for name in names:
                    assert not name.startswith("lrce_tpu_torch.parallel"), (
                        str(path), name)
            checked += 1
    assert checked > 15
