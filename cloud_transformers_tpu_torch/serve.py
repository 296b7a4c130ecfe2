"""Batched inference engine on one device.

Counterpart of ``cloud_transformers_tpu/serve.py`` with the same bucket,
padding and trimming rules, on one device and no mesh:

* requests are padded up to the nearest (batch, points) bucket, clamped at
  the largest bucket;
* a cloud is padded (or cut) to the point bucket by repeating its own
  points; the batch is padded by repeating the last cloud;
* per-request outputs drop the batch axis, and leaves with a per-point axis
  are cut back to the request's own length.

Example:
    engine = InferenceEngine.from_checkpoint(
        "scanobject_classifier_scales", "ckpt_latest.pt")
    probs = engine.classify([cloud1, cloud2])   # arbitrary-length clouds
"""

from typing import Sequence

import numpy as np
import torch

from cloud_transformers_tpu_torch.convert import load_weights
from cloud_transformers_tpu_torch.models import get_model, registry_name
from cloud_transformers_tpu_torch.nn.init import init_model_
from cloud_transformers_tpu_torch.nn.precision import strict_f32


def _next_bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class InferenceEngine:
    """Bucketed, batched eval-mode inference of a point-cloud model.

    On a CUDA device the engine turns TF32 off process-wide
    (``nn/precision.py``), so the model computes in float32, or, under
    the bf16 operand policy (``model.mxu_dtype: bfloat16``), contracts
    bf16 operands with float32 accumulation."""

    def __init__(self, model, device="cuda", batch_buckets=(1, 4, 8, 16),
                 point_buckets=(1024, 2048, 4096)):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            strict_f32()
        self.model = model.to(self.device).eval()
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.point_buckets = tuple(sorted(point_buckets))

    @classmethod
    def build(cls, model_name, seed=0, device="cuda",
              batch_buckets=(1, 4, 8, 16), point_buckets=(1024, 2048, 4096),
              **model_kwargs):
        """Build the engine with fresh weights from ``seed`` (for
        benchmarks).  For trained JAX weights, pass
        ``convert.load_jax_variables(get_model(...), variables)`` to the
        constructor."""
        model = get_model(model_name, **model_kwargs)
        init_model_(model, torch.Generator().manual_seed(seed))
        return cls(model, device, batch_buckets, point_buckets)

    @classmethod
    def from_checkpoint(cls, model_name, ckpt_path=None, seed=0,
                        device="cuda", batch_buckets=(1, 4, 8, 16),
                        point_buckets=(1024, 2048, 4096), **model_kwargs):
        """Build the engine with weights the port may not have trained: a
        reference ``.t7`` state dict through ``convert.load_reference``,
        any other file (a trainer checkpoint, a ``save_params_only`` file,
        a bare ``state_dict``) through
        ``train/checkpoint.restore_params_only``; without ``ckpt_path``,
        fresh weights from ``seed``, as ``build``."""
        if ckpt_path is None:
            return cls.build(model_name, seed, device, batch_buckets,
                             point_buckets, **model_kwargs)
        model = load_weights(get_model(model_name, **model_kwargs),
                             registry_name(model_name), ckpt_path)
        return cls(model, device, batch_buckets, point_buckets)

    def pad_batch(self, clouds: Sequence[np.ndarray]):
        """-> (batch [b, p, 3] float32 numpy, n, b, p)."""
        n = len(clouds)
        b = _next_bucket(n, self.batch_buckets)
        p = _next_bucket(max(np.asarray(c).shape[0] for c in clouds),
                         self.point_buckets)
        batch = np.zeros((b, p, 3), np.float32)
        for i in range(b):
            c = np.asarray(clouds[min(i, n - 1)], np.float32)
            reps = -(-p // c.shape[0])
            batch[i] = np.tile(c, (reps, 1))[:p]
        return batch, n, b, p

    @torch.no_grad()
    def predict_padded(self, clouds: Sequence[np.ndarray]):
        """-> (raw model outputs at the padded shapes, n, b, p)."""
        batch, n, b, p = self.pad_batch(clouds)
        out = self.model(torch.from_numpy(batch).to(self.device))
        return out, n, b, p

    def predict(self, clouds: Sequence[np.ndarray]):
        """-> one output tree of numpy arrays per request, batch axis
        removed and per-point axes cut to the request's length."""
        out, n, b, p = self.predict_padded(clouds)
        out = _map(lambda t: t.cpu().numpy(), out)
        results = []
        for i, cloud in enumerate(clouds[:n]):
            n_pts = int(np.asarray(cloud).shape[0])

            def trim(leaf, i=i, n_pts=n_pts):
                if leaf.ndim == 0 or leaf.shape[0] != b:
                    return leaf  # no batch axis (scalar stats)
                leaf_i = leaf[i]
                if leaf_i.ndim >= 1 and leaf_i.shape[0] == p:
                    leaf_i = leaf_i[:min(n_pts, p)]
                return leaf_i

            results.append(_map(trim, out))
        return results

    def classify(self, clouds: Sequence[np.ndarray]):
        """-> class probabilities [len(clouds), n_classes] (numpy)."""
        (class_pred, _mask, _stats), n, _b, _p = self.predict_padded(clouds)
        return torch.softmax(class_pred, -1)[:n].cpu().numpy()
