"""Optimizer and learning-rate schedule factory from a config's ``train:``.

Counterpart of ``cloud_transformers_tpu/train/optim.py``:

* ``Adam`` adds its ``weight_decay`` to the gradient (L2, not decoupled),
  ``AdamW`` decays the weights themselves, ``SGD`` takes momentum and
  nesterov;
* the schedule is stepped once per optimizer step, not per epoch:
  ``StepLR`` gives ``lr = base * gamma ** (step // step_size)``,
  ``CosineAnnealingLR`` falls from ``base`` to ``eta_min`` over ``T_max``
  steps and stays there; ``ReduceLROnPlateau`` (host-driven) keeps ``base``;
* ``scale_lr`` gives every parameter whose last name is ``scale`` a learning
  rate of its own, on the same schedule;
* ``clip_grad_norm`` clips the global gradient norm before the update.
"""

import math

import torch


def schedule_factor(base_lr, scheduler_cfg):
    """-> ``factor(step)`` with ``lr(step) = base_lr * factor(step)``."""
    stype = (scheduler_cfg or {}).get("type")
    if stype in (None, "ReduceLROnPlateau"):
        return lambda step: 1.0
    if stype == "StepLR":
        gamma = float(scheduler_cfg["gamma"])
        step_size = int(scheduler_cfg["step_size"])
        return lambda step: gamma ** (step // step_size)
    if stype == "CosineAnnealingLR":
        t_max = int(scheduler_cfg["T_max"])
        alpha = (float(scheduler_cfg.get("eta_min", 0.0)) / base_lr
                 if base_lr else 0.0)

        def cosine(step):
            c = 0.5 * (1.0 + math.cos(math.pi * min(step, t_max) / t_max))
            return (1.0 - alpha) * c + alpha
        return cosine
    raise ValueError(f"unknown scheduler type {stype!r}")


def _base_opt(opt_cfg, groups):
    otype = opt_cfg.get("type", "Adam")
    wd = float(opt_cfg.get("weight_decay", 0.0))
    if otype in ("Adam", "AdamW"):
        betas = tuple(float(b) for b in opt_cfg.get("betas", (0.9, 0.999)))
        cls = torch.optim.Adam if otype == "Adam" else torch.optim.AdamW
        return cls(groups, betas=betas, eps=1e-8, weight_decay=wd)
    if otype == "SGD":
        return torch.optim.SGD(groups,
                               momentum=float(opt_cfg.get("momentum", 0.0)),
                               nesterov=bool(opt_cfg.get("nesterov", False)))
    raise ValueError(f"unknown optimizer type {otype!r}")


class Optimizer:
    """A ``torch.optim`` optimizer with its per-step schedule and its
    gradient clipping: ``step()`` clips, updates, then moves the schedule."""

    def __init__(self, optimizer, scheduler, clip_grad_norm=None):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.clip_grad_norm = clip_grad_norm

    @property
    def lrs(self):
        """The learning rate of each parameter group for the next step."""
        return [g["lr"] for g in self.optimizer.param_groups]

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        if self.clip_grad_norm:
            torch.nn.utils.clip_grad_norm_(
                [p for g in self.optimizer.param_groups for p in g["params"]],
                self.clip_grad_norm)
        self.optimizer.step()
        self.scheduler.step()


def make_optimizer(train_cfg, named_params):
    """Build the ``Optimizer`` from a config's ``train:`` section
    (``optimizer``, optional ``scheduler``, ``scale_lr``, ``clip_grad_norm``)
    for ``named_params``, an iterable of (name, parameter) such as
    ``model.named_parameters()``."""
    opt_cfg = train_cfg["optimizer"]
    base_lr = float(opt_cfg.get("lr", 1e-3))
    named_params = list(named_params)
    if "scale_lr" in train_cfg:
        is_scale = [n.rsplit(".", 1)[-1] == "scale" for n, _ in named_params]
        groups = [
            {"params": [p for (_, p), s in zip(named_params, is_scale)
                        if not s], "lr": base_lr},
            {"params": [p for (_, p), s in zip(named_params, is_scale) if s],
             "lr": float(train_cfg["scale_lr"])}]
    else:
        groups = [{"params": [p for _, p in named_params], "lr": base_lr}]
    optimizer = _base_opt(opt_cfg, groups)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, [schedule_factor(g["lr"], train_cfg.get("scheduler"))
                    for g in groups])
    return Optimizer(optimizer, scheduler, train_cfg.get("clip_grad_norm"))
