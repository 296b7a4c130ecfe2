"""The reference's training steps: the task's loss, the gradient, the
global-norm clipping and Adam, written out.

Adam as PyTorch defines it (no weight decay, eps 1e-8): m = b1 m + (1 - b1)
g, v = b2 v + (1 - b2) g^2, p -= lr / (1 - b1^t) m / (sqrt(v) /
sqrt(1 - b2^t) + eps).  Clipping (``clip_grad_norm``): every gradient times
min(1, max_norm / (|g| + 1e-6)), |g| the norm of all of them.  The
learning rate is the base one: the schedule's first step is thousands of
steps away.
"""

import math

import torch

from ctbench.reference.mhct import Net, Ops


def _tensors(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def run_steps(family, model_cfg, train_cfg, weights, buffers, batches,
              seeds, device, tf32=False):
    """Train from ``weights`` and ``buffers`` (name -> tensor, copied) on
    ``batches`` (numpy dicts), seeding PyTorch's generators with
    ``seeds[i]`` before step i.
    -> {"loss": [float a step], "grad": {name: the first step's gradient
    as the update takes it}, "params": {name: the parameters and running
    statistics after the last step}}."""
    params = {k: v.detach().clone().to(device).requires_grad_(True)
              for k, v in weights.items()}
    stats = {k: v.detach().clone().to(device) for k, v in buffers.items()}
    net = Net(params, stats, Ops(tf32), training=True)
    opt = train_cfg["optimizer"]
    lr = float(opt.get("lr", 1e-3))
    b1, b2 = (float(b) for b in opt.get("betas", (0.9, 0.999)))
    clip = train_cfg.get("clip_grad_norm")
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"loss": [], "grad": None}
    for t, (batch, seed) in enumerate(zip(batches, seeds), 1):
        torch.manual_seed(seed)
        for p in params.values():
            p.grad = None
        loss = family.loss(net, _tensors(batch, device), model_cfg,
                           train_cfg)
        loss.backward()
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            live = {k: p for k, p in params.items() if p.grad is not None}
            if clip:
                total = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(p.grad) for p in live.values()]))
                coef = torch.clamp(float(clip) / (total + 1e-6), max=1.0)
                for p in live.values():
                    p.grad.mul_(coef)
            if out["grad"] is None:
                out["grad"] = {k: p.grad.clone() for k, p in live.items()}
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            for k, p in live.items():
                m[k].lerp_(p.grad, 1 - b1)
                v2[k].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(bc2)).add_(1e-8)
                p.addcdiv_(m[k], denom, value=-lr / bc1)
    out["params"] = {**{k: p.detach() for k, p in params.items()}, **stats}
    return out


def eval_net(weights, buffers, device, tf32=False):
    """An eval-mode ``Net`` on copies of ``weights`` and ``buffers``."""
    params = {k: v.detach().clone().to(device) for k, v in weights.items()}
    stats = {k: v.detach().clone().to(device) for k, v in buffers.items()}
    return Net(params, stats, Ops(tf32), training=False)
