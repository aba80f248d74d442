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
  - oe / mc (optional hinge loss) / count (MSE metric, lower is better).

Host side that waits for a later slice: checkpoints, TensorBoard scalars,
``do_training``'s best-checkpoint logic and the data prefetcher.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from lrce_tpu_torch.models.e2e import LRCEModel, e2e_apply
from lrce_tpu_torch.train import losses as L
from lrce_tpu_torch.train import optimizer as O
from lrce_tpu_torch.train.schedule import CosineWarmupRestarts, ReduceLROnPlateau
from lrce_tpu_torch.utils.pytree import l2_reg, stacked_param_groups


class AgentBase:
    metric_name = "Accuracy"
    metric_lower_better = False

    def __init__(self, model: LRCEModel, args, *, is_eval: bool = False,
                 seed: int = 0):
        """model: an ``LRCEModel`` on its device; args: the namespace of
        ``lrce_tpu.config`` (lr, reg_strength, use_cosine_scheduler, ...);
        seed: the dropout / drop-path generator's seed."""
        self.model = model
        self.cfg = model.cfg
        self.args = args
        self.is_eval = is_eval
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
        each step, then -1 at the end (the reference's protocol). Step i's
        metric vector is read after step i+1 is enqueued."""
        metric_num = 0.0
        metric_den = 0.0
        batch_losses = []
        n_batches = len(dl)
        pending: Optional[torch.Tensor] = None

        def drain(out):
            nonlocal metric_num, metric_den
            b_loss, m0, m1 = out.tolist()
            metric_num += m0
            metric_den += m1
            batch_losses.append(b_loss)

        for i, batch in enumerate(dl):
            out = self.dispatch(*batch, is_train=is_train)
            if is_train:
                self.counter += 1
                if getattr(self.args, "use_cosine_scheduler", False):
                    self.lrs = self.scheduler.step(epoch + i / n_batches)
            if pending is not None:
                drain(pending)
            pending = out
            if is_train:
                yield i
        if pending is not None:
            drain(pending)

        nonzero = [v for v in batch_losses if v != 0]
        avg_loss = float(np.mean(nonzero)) if nonzero else float("nan")
        avg_metric = metric_num / max(metric_den, 1e-9)
        if is_train:
            self.last_train_loss = avg_loss
            self.last_train_metric = avg_metric
        else:
            self.last_loss = avg_loss
            self.last_metric_val = avg_metric
            if (not self.is_eval and self.scheduler is not None
                    and not getattr(self.args, "use_cosine_scheduler", False)):
                self.lrs = self.scheduler.step(
                    -avg_metric if self.metric_lower_better else avg_metric)
        yield -1


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


def default_args(**overrides) -> SimpleNamespace:
    """The training defaults of ``lrce_tpu/config.py`` (plateau scheduler,
    lr 5e-6 for all three groups, reg 0.001), with overrides."""
    args = SimpleNamespace(lr=[5e-6] * 3, min_lr=1e-8, lr_decay_factor=0.5,
                           patience=0.5, use_cosine_scheduler=False,
                           reg_strength=0.001, use_hinge_loss=False,
                           margin=1.0)
    for k, v in overrides.items():
        setattr(args, k, v)
    return args
