"""Single-device trainer: train step, eval step, epoch loop, validation.

Counterpart of ``cloud_transformers_tpu/train/trainer.py`` on one device.
A task provides ``loss_fn(model, batch) -> (loss, aux_metrics)``; the
trainer moves each numpy batch to the device, runs forward, backward and the
optimizer step, and keeps the metrics on the device until a window of
``show_each`` steps is averaged on the host.  Weights are initialised from
``seed`` through an explicit ``torch.Generator``; the same seed also seeds
PyTorch's generators, which dropout draws from.

Checkpoints, auto-resume, TensorBoard/CSV logging, profiling hooks and the
device mesh of the JAX trainer are not ported yet.
"""

import logging
import time

import numpy as np
import torch

from cloud_transformers_tpu_torch.nn.init import init_model_
from cloud_transformers_tpu_torch.nn.precision import strict_f32
from cloud_transformers_tpu_torch.train.config import experiment_dirs
from cloud_transformers_tpu_torch.train.optim import make_optimizer

logger = logging.getLogger("cloud_transformers_tpu_torch")


class Trainer:
    def __init__(self, model, cfg, exp_name, loss_fn, eval_fn=None,
                 device="cuda", seed=0):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn or loss_fn
        self.device = torch.device(device)
        if self.device.type == "cuda":
            strict_f32()
        self.generator = torch.Generator().manual_seed(seed)
        torch.manual_seed(seed)
        init_model_(model, self.generator)
        self.model = model.to(self.device)
        self.exp_dir, self.writer_dir = experiment_dirs(cfg, exp_name)
        self.optimizer = make_optimizer(cfg["train"],
                                        self.model.named_parameters())
        self.global_step = 0
        self.epoch = 0

    def to_device(self, batch):
        """Numpy batch -> tensors on the device (labels as int64)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if not t.is_floating_point():
                t = t.long()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    # --- steps -----------------------------------------------------------
    def train_step(self, batch):
        """One optimizer step; -> metrics as 0-dim tensors on the device
        (plus ``pred``), not yet synchronised."""
        self.model.train()
        batch = self.to_device(batch)
        self.optimizer.zero_grad()
        loss, aux = self.loss_fn(self.model, batch)
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return {"loss": loss.detach(), **aux}

    @torch.no_grad()
    def eval_step(self, batch):
        self.model.eval()
        loss, aux = self.eval_fn(self.model, self.to_device(batch))
        return {"loss": loss, **aux}

    # --- loop ------------------------------------------------------------
    def fit(self, train_loader, val_loader=None, eval_hook=None,
            num_epochs=None, max_steps=None):
        """The epoch loop: a host-side metric window every ``show_each``
        steps, validation every ``val_step`` epochs, stop after
        ``max_steps`` optimizer steps if given.  -> the model."""
        tcfg = self.cfg["train"]
        num_epochs = num_epochs or int(tcfg.get("num_epochs", 1))
        show_each = int(tcfg.get("show_each", 100))
        val_step = int(tcfg.get("val_step", 1))
        for epoch in range(self.epoch, num_epochs):
            self.epoch = epoch
            train_loader.set_epoch(epoch)
            t0 = time.time()
            window = []
            for batch in train_loader:
                window.append(self.train_step(batch))
                if self.global_step % show_each == 0:
                    host = _window_mean(window)
                    host["steps_per_sec"] = len(window) / (time.time() - t0)
                    window, t0 = [], time.time()
                    logger.info("epoch %d step %d: %s", epoch,
                                self.global_step,
                                {k: round(v, 4) for k, v in host.items()})
                if max_steps and self.global_step >= max_steps:
                    return self.model
            if val_loader is not None and (epoch + 1) % val_step == 0:
                val = self.validate(val_loader, eval_hook)
                logger.info("epoch %d val: %s", epoch,
                            {k: round(float(v), 4) for k, v in val.items()})
        return self.model

    def validate(self, val_loader, eval_hook=None):
        """Average the eval metrics over the loader.  ``eval_hook(batch,
        metrics)`` may accumulate task statistics; if it has ``compute()``,
        its results are merged into (and override) the returned metrics."""
        if eval_hook is not None and hasattr(eval_hook, "reset"):
            eval_hook.reset()
        sums, count = {}, 0
        for batch in val_loader:
            m = self.eval_step(batch)
            if eval_hook is not None:
                eval_hook(batch, m)
            for k, v in m.items():
                if v.dim() == 0:
                    sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        out = {k: v / max(count, 1) for k, v in sums.items()}
        if eval_hook is not None and hasattr(eval_hook, "compute"):
            out.update(eval_hook.compute())
        return out


def _window_mean(window):
    """Mean of each scalar metric over a window of steps, on the host."""
    return {k: float(np.mean([float(m[k]) for m in window]))
            for k in window[0] if window[0][k].dim() == 0}
