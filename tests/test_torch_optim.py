"""Port parity: ``make_optimizer`` and its schedule against the JAX
package's optax factory.  The same numpy gradients go into both for 5
steps; parameters agree within 1e-6.  The learning rates stay at or below
1e-2 for Adam: optax forms Adam's bias correction ``1 - b2 ** t`` in
float32, where it keeps about four digits in the first steps, and PyTorch
forms it in double, so the two differ by about 3e-5 of each update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_transformers_tpu.train.optim import (
    make_optimizer as j_make_optimizer,
    make_schedule,
)
from cloud_transformers_tpu_torch.train.optim import (
    make_optimizer,
    schedule_factor,
)

STEP_LR = {"type": "StepLR", "gamma": 0.7, "step_size": 2}
CASES = {
    "adam": {"optimizer": {"type": "Adam", "lr": 1e-2}},
    "adam_l2": {"optimizer": {"type": "Adam", "lr": 1e-2,
                              "betas": [0.8, 0.99], "weight_decay": 0.1}},
    "adam_clip": {"optimizer": {"type": "Adam", "lr": 1e-2},
                  "clip_grad_norm": 0.5},
    "adam_steplr": {"optimizer": {"type": "Adam", "lr": 1e-2},
                    "scheduler": STEP_LR},
    "adamw": {"optimizer": {"type": "AdamW", "lr": 1e-2,
                            "weight_decay": 0.1}},
    "sgd_nesterov_cosine": {
        "optimizer": {"type": "SGD", "lr": 1e-1, "momentum": 0.9,
                      "nesterov": True},
        "scheduler": {"type": "CosineAnnealingLR", "T_max": 3,
                      "eta_min": 1e-3}},
    "scale_lr": {"optimizer": {"type": "Adam", "lr": 1e-3},
                 "scheduler": STEP_LR, "scale_lr": 1e-2},
}


def _params(rs):
    return {"dense": {"kernel": rs.randn(4, 3).astype(np.float32),
                      "bias": rs.randn(3).astype(np.float32)},
            "bn": {"scale": rs.randn(3).astype(np.float32)}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_optax(case):
    cfg = CASES[case]
    rs = np.random.RandomState(0)
    params = _params(rs)
    grads = [jax.tree_util.tree_map(
        lambda a: rs.randn(*a.shape).astype(np.float32), params)
        for _ in range(5)]

    tx = j_make_optimizer(cfg, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, jp)
        jp = optax.apply_updates(jp, updates)

    named = {f"{m}.{n}": torch.nn.Parameter(torch.from_numpy(a.copy()))
             for m, leaves in params.items() for n, a in leaves.items()}
    opt = make_optimizer(cfg, named.items())
    for g in grads:
        opt.zero_grad()
        for name, p in named.items():
            m, n = name.split(".")
            p.grad = torch.from_numpy(g[m][n].copy())
        opt.step()

    for name, p in named.items():
        m, n = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[m][n]),
                                   rtol=0, atol=1e-6, err_msg=name)
        assert np.abs(p.detach().numpy() - params[m][n]).max() > 1e-4


def test_step_lr_moves_per_optimizer_step():
    cfg = {"optimizer": {"type": "Adam", "lr": 1e-3},
           "scheduler": {"type": "StepLR", "gamma": 0.7, "step_size": 4}}
    p = torch.nn.Parameter(torch.zeros(2))
    opt = make_optimizer(cfg, [("w", p)])
    sched = make_schedule(1e-3, cfg["scheduler"])
    seen = {}
    for step in range(9):
        seen[step] = opt.lrs[0]
        np.testing.assert_allclose(seen[step], float(sched(step)),
                                   rtol=1e-6)
        p.grad = torch.ones(2)
        opt.step()
    # steps 0, step_size - 1, step_size, 2 * step_size
    np.testing.assert_allclose(
        [seen[0], seen[3], seen[4], seen[8]],
        [1e-3, 1e-3, 0.7e-3, 0.49e-3], rtol=1e-9)


def test_scale_lr_group_takes_the_leaves_named_scale():
    cfg = {"optimizer": {"type": "Adam", "lr": 1e-3}, "scale_lr": 1e-1,
           "scheduler": {"type": "StepLR", "gamma": 0.5, "step_size": 1}}
    named = [("a.weight", torch.nn.Parameter(torch.zeros(2))),
             ("a.key_bn.scale", torch.nn.Parameter(torch.zeros(3))),
             ("scale_head.bias", torch.nn.Parameter(torch.zeros(1)))]
    opt = make_optimizer(cfg, named)
    main, scale = opt.optimizer.param_groups
    assert [tuple(p.shape) for p in scale["params"]] == [(3,)]
    assert [tuple(p.shape) for p in main["params"]] == [(2,), (1,)]
    assert opt.lrs == [1e-3, 1e-1]
    for _, p in named:
        p.grad = torch.ones_like(p)
    opt.step()
    np.testing.assert_allclose(opt.lrs, [0.5e-3, 0.5e-1], rtol=1e-9)


def test_schedules_and_unknown_types():
    cos = schedule_factor(1e-1, {"type": "CosineAnnealingLR", "T_max": 10,
                                 "eta_min": 1e-3})
    ref = make_schedule(1e-1, {"type": "CosineAnnealingLR", "T_max": 10,
                               "eta_min": 1e-3})
    for step in (0, 3, 10, 25):                  # stays at eta_min after
        np.testing.assert_allclose(1e-1 * cos(step), float(ref(step)),
                                   rtol=1e-5)
    assert schedule_factor(1e-3, None)(7) == 1.0
    assert schedule_factor(1e-3, {"type": "ReduceLROnPlateau"})(7) == 1.0
    with pytest.raises(ValueError):
        schedule_factor(1e-3, {"type": "OneCycleLR"})
    with pytest.raises(ValueError):
        make_optimizer({"optimizer": {"type": "LBFGS"}},
                       [("w", torch.nn.Parameter(torch.zeros(1)))])
