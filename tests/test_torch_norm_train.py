"""Port parity: train-mode BatchNorm against the JAX package's
``TorchBatchNorm``: the output (batch statistics, biased variance) and the
running ``mean`` and *unbiased* ``var`` after the call, for channel-last
point tensors and for the trunks' channels-first tensors, n = 1 included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.nn.norm import TorchBatchNorm
from cloud_transformers_tpu_torch.nn.norm import BatchNorm

# (input shape, channel axis of the port's input)
CASES = [((2, 40, 6), -1), ((3, 6, 4, 5), 1), ((2, 6, 3, 4, 2), 1),
         ((1, 1, 6), -1), ((1, 6), -1)]


def _variables(c, rs):
    return {"params": {"scale": rs.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rs.randn(c).astype(np.float32)},
            "batch_stats": {"mean": rs.randn(c).astype(np.float32),
                            "var": rs.uniform(0.5, 1.5, c).astype(
                                np.float32)}}


@pytest.mark.parametrize("shape,dim", CASES)
def test_train_mode_matches_jax(shape, dim):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 2 + 1).astype(np.float32)
    c = shape[dim]
    v = _variables(c, rs)
    x_last = np.moveaxis(x, dim, -1)             # JAX: channels last
    ref, updates = TorchBatchNorm(use_running_average=False).apply(
        v, jnp.asarray(x_last), mutable=["batch_stats"])

    bn = BatchNorm(c, dim=dim).train()
    bn.load_state_dict({**{k: torch.from_numpy(a)
                           for k, a in v["params"].items()},
                        **{k: torch.from_numpy(a)
                           for k, a in v["batch_stats"].items()}})
    out = bn(torch.from_numpy(x))
    np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), dim, -1),
                               np.asarray(ref), rtol=0, atol=1e-5)
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(bn, name).numpy(),
            np.asarray(updates["batch_stats"][name]), rtol=0, atol=1e-6,
            err_msg=name)
    n = x.size // c
    batch_var = x_last.reshape(-1, c).var(0)     # biased
    np.testing.assert_allclose(
        bn.var.numpy(),
        0.9 * v["batch_stats"]["var"] + 0.1 * batch_var * n / max(n - 1, 1),
        rtol=0, atol=1e-6)


def test_eval_mode_uses_and_keeps_the_running_statistics():
    rs = np.random.RandomState(1)
    bn = BatchNorm(6).eval()
    v = _variables(6, rs)
    bn.load_state_dict({k: torch.from_numpy(a) for part in v.values()
                        for k, a in part.items()})
    x = torch.from_numpy(rs.randn(2, 10, 6).astype(np.float32))
    before = {k: t.clone() for k, t in bn.state_dict().items()}
    out = bn(x)
    want = ((x - bn.mean) * torch.rsqrt(bn.var + 1e-5) * bn.scale + bn.bias)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    for k, t in bn.state_dict().items():
        assert torch.equal(t, before[k])


def test_train_mode_gradients_flow_through_the_batch_statistics():
    """d(sum of outputs)/dx is zero for a normalized batch, which only
    holds if the batch mean is part of the graph."""
    bn = BatchNorm(4).train()
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    bn(x).sum().backward()
    assert float(x.grad.abs().max()) < 1e-5
    assert bn.scale.grad is not None and bn.bias.grad is not None
    assert not bn.mean.requires_grad
