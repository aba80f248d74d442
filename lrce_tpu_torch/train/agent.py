"""Training / eval runtime ("agents"), counterpart of
``lrce_tpu/train/agent.py`` on one CUDA device (or the CPU).

What ports:
  - AdamW over three param groups at lr[0..2] (``train/optimizer.py``);
    cosine-warmup-restarts stepped per batch at fractional epochs, or
    ReduceLROnPlateau stepped on the validation metric;
  - loss = task loss + reg_strength * sum ||p||_2 over lrce_tpu's param
    leaves (``utils/pytree.py``);
  - f32 parameters, bf16 compute (the model's ``compute_dtype``);
  - the train step: forward in training mode (dropout, drop-path from the
    agent's generator) + loss + backward + AdamW; the eval step without
    autograd; both return one stacked (loss, metric_num, metric_den)
    device vector;
  - ``dispatch`` enqueues a step and returns that vector unread;
    ``process_data`` reads step i-1's vector after step i is enqueued (the
    one-deep lagged read), so the host's read overlaps the device's work;
  - oe / mc (optional hinge loss) / count (MSE metric, lower is better);
  - the generator-based epoch loop: ``do_training`` (mid-epoch validation,
    best checkpoint, ``ckpt_interval``, the rolling ``latest.pt`` every
    ``ckpt_steps``), ``do_sanity_check``, ``do_evaluation``; batches reach
    the step through ``data/prefetch.device_prefetch``;
  - the log directory ``<log_dir>/<uid>_<dataset>`` with ``config.json``,
    TensorBoard scalars when ``torch.utils.tensorboard`` is importable, and
    ``weights/`` for the checkpoints;
  - checkpoints, blocking or from a writer thread (``async_checkpoint``):
    the loop then pays one device-side copy of the state, and the copy to
    the host, the serialisation and the write overlap later steps. One
    writer at a time; a writer's exception is kept and raised at the next
    save or at ``finish_pending_checkpoint``.

The agent runs where its model lives; ``LRCEModel`` is built on the card
unless its caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from collections import deque
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from lrce_tpu_torch.config import parse_arg_train
from lrce_tpu_torch.data.prefetch import device_prefetch
from lrce_tpu_torch.models.e2e import LRCEModel, e2e_apply
from lrce_tpu_torch.train import losses as L
from lrce_tpu_torch.train import optimizer as O
from lrce_tpu_torch.train.schedule import CosineWarmupRestarts, ReduceLROnPlateau
from lrce_tpu_torch.utils import checkpoint as C
from lrce_tpu_torch.utils.logging import get_logger
from lrce_tpu_torch.utils.pytree import l2_reg, stacked_param_groups


class _StateSnapshot:
    """A device-side copy of every tensor of a nested state (dicts, lists,
    tuples): one ``torch.cat`` per (dtype, device), not one clone per
    tensor, enqueued on the current stream. ``to_host`` rebuilds the state
    with host tensors; it may run on another thread, on its own stream."""

    def __init__(self, tree: Any):
        self.tree = tree                # kept for its structure
        leaves = []
        C.map_tensors(tree, leaves.append)
        groups = {}
        for i, t in enumerate(leaves):
            groups.setdefault((t.dtype, t.device), []).append(i)
        self.flats = {key: (idx, torch.cat([leaves[i].detach().reshape(-1)
                                            for i in idx]))
                      for key, idx in groups.items()}
        self.shapes = [t.shape for t in leaves]
        cuda = [k[1] for k in self.flats if k[1].type == "cuda"]
        self.device = cuda[0] if cuda else None
        self.done = None
        if self.device is not None:
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(self.device))

    def to_host(self) -> Any:
        host = [None] * len(self.shapes)
        stream = (torch.cuda.Stream(self.device) if self.device is not None
                  else None)
        if stream is not None:
            stream.wait_event(self.done)
        for (_, device), (idx, flat) in self.flats.items():
            if device.type == "cuda":
                with torch.cuda.stream(stream):
                    flat.record_stream(stream)
                    flat = flat.cpu()       # waits for the copy on `stream`
            offset = 0
            for i in idx:
                n = self.shapes[i].numel()
                host[i] = flat[offset:offset + n].reshape(self.shapes[i]).clone()
                offset += n
        it = iter(host)
        return C.map_tensors(self.tree, lambda _: next(it))


class AgentBase:
    metric_name = "Accuracy"
    metric_lower_better = False

    def __init__(self, model: LRCEModel, args, *, log_enabled: bool = True,
                 is_eval: bool = False, seed: int = 0):
        """model: an ``LRCEModel`` on its device; args: the namespace of
        ``lrce_tpu_torch.config`` (lr, reg_strength, use_cosine_scheduler,
        log_dir, dataset, ...); log_enabled: make the log directory, write
        ``config.json``, TensorBoard scalars and checkpoints; seed: the
        dropout / drop-path generator's seed."""
        self.model = model
        self.cfg = model.cfg
        self.args = args
        self.log_enabled = log_enabled
        self.is_eval = is_eval
        self.uid = int(time.time())
        self.logger = get_logger(type(self).__name__)
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.reg_strength = float(getattr(args, "reg_strength", 0.0))
        self.reg_groups = stacked_param_groups(model)
        if is_eval:
            self.optimizer = None
            self.scheduler = None
            self.lrs = [0.0, 0.0, 0.0]
        else:
            if getattr(args, "use_cosine_scheduler", False):
                self.scheduler = CosineWarmupRestarts(
                    3, first_cycle_steps=args.lr_restart_epoch,
                    cycle_mult=args.lr_restart_mul, max_lr=args.lr[0],
                    min_lr=args.min_lr, warmup_steps=args.lr_warm_up,
                    gamma=args.lr_decay_factor)
            else:
                self.scheduler = ReduceLROnPlateau(
                    list(args.lr), mode="max", factor=args.lr_decay_factor,
                    patience=args.patience, min_lr=args.min_lr)
            self.lrs = list(self.scheduler.lrs)
            self.optimizer = O.make_optimizer(model, self.lrs)

        self.summary_writer = None
        if log_enabled:
            self.args.log_dir = os.path.join(args.log_dir,
                                             f"{self.uid}_{args.dataset}")
            self.args.ckpt_dir = os.path.join(self.args.log_dir, "weights")
            os.makedirs(self.args.ckpt_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.summary_writer = SummaryWriter(log_dir=self.args.log_dir)
            except Exception:  # noqa: BLE001 - no TensorBoard: no scalars
                self.summary_writer = None
            self.save_config()
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None

        self.last_loss = None
        self.last_metric_val = None
        self.last_train_loss = None
        self.last_train_metric = None
        self.counter = 0
        self.best_epoch = None
        self.best_metric_val = None

    # ---------------------------------------------------------- step pieces
    def _forward(self, clips, ids, mask, types, training: bool):
        return e2e_apply(self.model, clips, ids, mask, types,
                         training=training,
                         generator=self.generator if training else None)

    def _task_loss(self, logits, gt):
        return L.cross_entropy(logits, gt)

    def _metric_pair(self, logits, gt) -> Tuple[torch.Tensor, torch.Tensor]:
        pred = torch.argmax(logits, dim=1)
        return ((pred == gt).sum().float(),
                torch.tensor(float(pred.shape[0]), device=logits.device))

    def _loss(self, logits, gt):
        loss = self._task_loss(logits, gt)
        if self.reg_strength:
            loss = loss + self.reg_strength * l2_reg(self.reg_groups)
        return loss

    def _train_step(self, clips, ids, mask, types, gt) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        logits = self._forward(clips, ids, mask, types, True)
        loss = self._loss(logits, gt)
        loss.backward()
        O.set_lrs(self.optimizer, self.lrs)
        self.optimizer.step()
        with torch.no_grad():
            m0, m1 = self._metric_pair(logits.detach(), gt)
            return torch.stack([loss.detach().float(), m0, m1])

    @torch.no_grad()
    def _eval_step(self, clips, ids, mask, types, gt) -> torch.Tensor:
        logits = self._forward(clips, ids, mask, types, False)
        loss = self._loss(logits, gt)
        m0, m1 = self._metric_pair(logits, gt)
        return torch.stack([loss.float(), m0, m1])

    # ------------------------------------------------------------------ step
    def _put_batch(self, batch: Sequence) -> tuple:
        return tuple(torch.as_tensor(b).to(self.device, non_blocking=True)
                     for b in batch)

    def dispatch(self, *batch, is_train: bool) -> torch.Tensor:
        """Enqueue one batch (clips, ids, mask, types, gt) and return the
        stacked (loss, metric_num, metric_den) device vector unread."""
        batch = self._put_batch(batch)
        return (self._train_step if is_train else self._eval_step)(*batch)

    def step(self, *batch, is_train: bool):
        """One batch -> (loss, metric_num, metric_den), host floats."""
        loss, m0, m1 = self.dispatch(*batch, is_train=is_train).tolist()
        return loss, m0, m1

    # ------------------------------------------------------------ main loop
    def write_summary(self, title, value, step):
        if self.summary_writer is not None:
            self.summary_writer.add_scalar(title, value, step)

    def is_metric_val_better(self, epoch=None) -> bool:
        better = (self.best_metric_val is None
                  or (self.last_metric_val < self.best_metric_val
                      if self.metric_lower_better
                      else self.last_metric_val > self.best_metric_val))
        if better:
            self.best_metric_val = self.last_metric_val
            self.best_epoch = epoch
        return better

    def process_data(self, dl, is_train: bool, epoch: int):
        """Generator over batches; in training yields the batch index after
        each step, then -1 at the end (the reference's protocol). Batches
        come through ``device_prefetch``. Step i's metric vector is read
        after step i+1 is enqueued; its TensorBoard scalars carry the
        counter and learning rates of its own dispatch."""
        if is_train:
            self.logger.info("Training Phase")
        elif not self.is_eval:
            self.logger.info("Validation Phase")
        metric_num = 0.0
        metric_den = 0.0
        batch_losses = []
        n_batches = len(dl)
        pending = None      # (device vector, counter, lrs) of the last step

        def drain(p):
            nonlocal metric_num, metric_den
            out, ctr, lrs = p
            b_loss, m0, m1 = out.tolist()
            if is_train:
                for k, lr in enumerate(lrs):
                    self.write_summary(f"LR Scheduler/{k}", lr, ctr)
                self.write_summary("Training/Batch Loss", b_loss, ctr)
                self.write_summary(f"Training/Batch {self.metric_name}",
                                   m0 / max(m1, 1e-9), ctr)
            metric_num += m0
            metric_den += m1
            batch_losses.append(b_loss)

        for i, batch in enumerate(device_prefetch(dl, self.device)):
            out = self.dispatch(*batch, is_train=is_train)
            lrs_snap = None
            if is_train:
                self.counter += 1
                if getattr(self.args, "use_cosine_scheduler", False):
                    self.lrs = self.scheduler.step(epoch + i / n_batches)
                lrs_snap = list(self.lrs)
            if pending is not None:
                drain(pending)
            pending = (out, self.counter, lrs_snap)
            if is_train:
                every = getattr(self.args, "ckpt_steps", 0)
                if every and self.counter % every == 0:
                    # rolling fault-tolerance checkpoint; tmp + rename keeps
                    # the previous latest.pt whole until the new one is
                    self.save_checkpoint(epoch + 1, "latest")
                yield i
        if pending is not None:
            drain(pending)

        nonzero = [v for v in batch_losses if v != 0]
        avg_loss = float(np.mean(nonzero)) if nonzero else float("nan")
        avg_metric = metric_num / max(metric_den, 1e-9)
        if is_train:
            self.last_train_loss = avg_loss
            self.last_train_metric = avg_metric
            self.write_summary("Training/Loss", avg_loss, epoch)
            self.write_summary(f"Training/{self.metric_name}", avg_metric,
                               epoch)
        else:
            self.last_loss = avg_loss
            self.last_metric_val = avg_metric
            if (not self.is_eval and self.scheduler is not None
                    and not getattr(self.args, "use_cosine_scheduler", False)):
                self.lrs = self.scheduler.step(
                    -avg_metric if self.metric_lower_better else avg_metric)
            self.write_summary("Validation/Loss", avg_loss, epoch)
            self.write_summary(f"Validation/{self.metric_name}", avg_metric,
                               epoch)
        yield -1

    def do_training(self, train_dl, val_dl, eval_per_epoch: int = 1):
        """``args.epoch`` epochs over ``train_dl``; a validation pass over
        ``val_dl`` at each of ``eval_per_epoch`` points of an epoch (the
        last at its end), ``best.pt`` whenever the validation metric
        improves, an epoch checkpoint every ``args.ckpt_interval`` epochs
        and after the last."""
        n = len(train_dl)
        eval_idx = [n // eval_per_epoch * i for i in range(1, eval_per_epoch)]
        for i in range(self.args.epoch):
            self.logger.info(f"Epoch {i + 1}/{self.args.epoch}")
            k = 0
            for step in self.process_data(train_dl, True, i):
                if step in eval_idx or step == -1:
                    deque(self.process_data(val_dl, False,
                                            eval_per_epoch * i + k), maxlen=0)
                    if self.is_metric_val_better(i + 1):
                        self.save_checkpoint(i + 1, "best")
                    k += 1
            if (i + 1) % self.args.ckpt_interval == 0 or i == self.args.epoch - 1:
                self.save_checkpoint(i + 1)
            self.logger.info("Epoch complete\n")
        self.finish_pending_checkpoint()
        self.logger.info(f"Best result was seen in epoch {self.best_epoch}")

    def do_sanity_check(self, dl):
        """Overfit the (truncated) train split, reporting the falling
        loss."""
        for i in range(self.args.epoch):
            self.logger.info(f"Epoch {i + 1}/{self.args.epoch}")
            deque(self.process_data(dl, True, i), maxlen=0)
            if (self.last_train_loss is None
                    or not np.isfinite(self.last_train_loss)):
                # an empty loader yields no train batches (average loss nan)
                self.logger.info("Sanity loss n/a (no train batches)")
                continue
            self.logger.info(
                f"Sanity loss {self.last_train_loss:.5f} "
                f"{self.metric_name} {self.last_train_metric * 100:.2f}%")

    def do_evaluation(self, test_dl):
        deque(self.process_data(test_dl, False, 0), maxlen=0)
        self.logger.info(f"{self.metric_name}: {self.last_metric_val * 100:.5f}%")
        self.logger.info(f"Loss: {self.last_loss:.5f}")

    # ------------------------------------------------------------ checkpoints
    def save_config(self):
        # the reference drops the debug_mode key when it is falsy
        if not getattr(self.args, "debug_mode", True):
            del vars(self.args)["debug_mode"]
        config = dict(vars(self.args))
        self.logger.info("======CONFIGURATIONS======")
        for k, v in config.items():
            self.logger.info(f"{str(k).upper()}: {v}")
        config_path = os.path.join(self.args.log_dir, "config.json")
        with open(config_path, "w") as f:
            json.dump(config, f, default=str)
        self.logger.info(f"Training config saved to {config_path}")

    def save_checkpoint(self, epoch: int, name: str = "",
                        only_model: Optional[bool] = None):
        """``weights/<name>.pt``, or the epoch's file under the reference's
        naming. only_model defaults to not ``args.save_full_state``."""
        if only_model is None:
            only_model = not getattr(self.args, "save_full_state", False)
        if not self.log_enabled:
            return
        if name != "":
            ckpt_path = os.path.join(self.args.ckpt_dir, f"{name}.pt")
        else:
            ckpt_path = os.path.join(
                self.args.ckpt_dir,
                C.checkpoint_name(epoch, self.last_loss or 0.0,
                                  self.last_metric_val or 0.0))
        opt = (None if only_model or self.optimizer is None
               else self.optimizer.state_dict())
        sched = (None if only_model or self.scheduler is None
                 else self.scheduler.state_dict())
        if not getattr(self.args, "async_checkpoint", False):
            C.save_checkpoint(ckpt_path, self.model.state_dict(), opt, sched)
            self.logger.info(f"Checkpoint saved to {ckpt_path}")
            return

        # Async save: the loop pays one device-side copy of the state (the
        # next optimizer step updates the parameters in place); the copy to
        # the host, the serialisation and the write happen on a writer
        # thread while later steps run. One writer at a time: a new save
        # joins the previous one first, and do_training joins the last, so
        # a finished run holds no unfinished file.
        self.finish_pending_checkpoint()
        snap = _StateSnapshot((self.model.state_dict(), opt))

        def _write():
            # a writer's failure (disk full, permissions, serialisation)
            # must not vanish: it is kept and raised on the main thread
            try:
                model_state, opt_state = snap.to_host()
                C.save_checkpoint(ckpt_path, model_state, opt_state, sched)
                self.logger.info(f"Checkpoint saved to {ckpt_path}")
            except BaseException as e:  # noqa: BLE001 - re-raised on join
                self._ckpt_error = e

        self._ckpt_thread = threading.Thread(
            target=_write, name="lrce-ckpt-writer", daemon=True)
        self._ckpt_thread.start()

    def finish_pending_checkpoint(self):
        """Join the checkpoint writer, if one is in flight, and raise what
        it raised."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        if self._ckpt_error is not None:
            err, self._ckpt_error = self._ckpt_error, None
            raise RuntimeError(
                "async checkpoint writer failed; the checkpoint was NOT "
                "saved") from err

    def load_checkpoint(self, ckpt_path: str,
                        only_model: Optional[bool] = None):
        """Load the model, and with ``save_full_state`` (or only_model
        False) the optimizer and scheduler too, onto the agent's device."""
        if only_model is None:
            only_model = not getattr(self.args, "save_full_state", False)
        self.finish_pending_checkpoint()    # the file may still be writing
        ckpt = C.load_checkpoint(ckpt_path, self.device)
        self.model.load_state_dict(ckpt["model_state_dict"])
        if (not only_model and "optimizer_state_dict" in ckpt
                and self.optimizer is not None):
            self.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
            if "scheduler_state_dict" in ckpt and self.scheduler is not None:
                self.scheduler.load_state_dict(ckpt["scheduler_state_dict"])
                self.lrs = list(self.scheduler.lrs)
        self.logger.info(f"Succesfully loaded model in {ckpt_path}")


class AgentOE(AgentBase):
    """Open-ended classification."""


class AgentMC(AgentBase):
    """Multiple choice; optional pairwise hinge loss."""

    def _task_loss(self, logits, gt):
        if getattr(self.args, "use_hinge_loss", False):
            return L.hinge_loss(logits, gt, float(self.args.margin))
        return L.cross_entropy(logits, gt)


class AgentCount(AgentBase):
    """Repetition-count regression: per-sample MSE metric, lower is
    better."""

    metric_name = "MSE"
    metric_lower_better = True

    def _task_loss(self, logits, gt):
        return torch.mean(L.mse(logits, gt))

    def _metric_pair(self, logits, gt):
        per = L.mse(logits, gt)
        return per.sum(), torch.tensor(float(per.shape[0]),
                                       device=logits.device)


def agent_factory(task_type: str):
    return {"oe": AgentOE, "mc": AgentMC, "count": AgentCount}[task_type]


def default_args(dataset: str = "msvd-qa-oe", **overrides
                 ) -> argparse.Namespace:
    """The training defaults of ``lrce_tpu_torch.config`` for ``dataset``
    (plateau scheduler, lr 5e-6 for all three groups, reg 0.001, the
    dataset's model config), with overrides."""
    args = parse_arg_train(["--dataset", dataset, "--dataset-dir", "."])
    for k, v in overrides.items():
        setattr(args, k, v)
    return args
