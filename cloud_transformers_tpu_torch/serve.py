"""Batched inference engine on one device, or one replica a device.

Counterpart of ``cloud_transformers_tpu/serve.py`` with the same bucket,
padding and trimming rules:

* requests are padded up to the nearest (batch, points) bucket, clamped at
  the largest bucket;
* a cloud is padded (or cut) to the point bucket by repeating its own
  points; the batch is padded by repeating the last cloud;
* per-request outputs drop the batch axis, and leaves with a per-point axis
  are cut back to the request's own length;
* with ``devices`` (the JAX engine's 'data' mesh), each device holds an
  eval-mode replica, the batch bucket is rounded up to a multiple of the
  replicas, each replica takes its block of rows in order, and the outputs
  are concatenated in order (a leaf without the batch axis, such as a
  block's occupancy, is the replicas' mean).  One device serves as before.

Example:
    engine = InferenceEngine.from_checkpoint(
        "scanobject_classifier_scales", "ckpt_latest.pt")
    probs = engine.classify([cloud1, cloud2])   # arbitrary-length clouds
"""

import copy
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


def _merge(outs, rows, device):
    """The replicas' output trees as one on ``device``: leaves with a batch
    axis (``rows`` long) concatenated in order, the others (statistics)
    averaged."""
    first = outs[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_merge([o[i] for o in outs], rows, device)
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _merge([o[k] for o in outs], rows, device) for k in first}
    parts = [o.to(device) for o in outs]
    if first.dim() and first.shape[0] == rows:
        return torch.cat(parts)
    return torch.stack(parts).mean(0)


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
                 point_buckets=(1024, 2048, 4096), devices=None):
        self.devices = [torch.device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        if any(d.type == "cuda" for d in self.devices):
            strict_f32()
        self.model = model.to(self.device).eval()
        # a replica on each further device, the same weights
        self.replicas = [self.model] + [
            copy.deepcopy(self.model).to(d).eval() for d in self.devices[1:]]
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.point_buckets = tuple(sorted(point_buckets))

    @classmethod
    def build(cls, model_name, seed=0, device="cuda",
              batch_buckets=(1, 4, 8, 16), point_buckets=(1024, 2048, 4096),
              devices=None, **model_kwargs):
        """Build the engine with fresh weights from ``seed`` (for
        benchmarks).  For trained JAX weights, pass
        ``convert.load_jax_variables(get_model(...), variables)`` to the
        constructor."""
        model = get_model(model_name, **model_kwargs)
        init_model_(model, torch.Generator().manual_seed(seed))
        return cls(model, device, batch_buckets, point_buckets, devices)

    @classmethod
    def from_checkpoint(cls, model_name, ckpt_path=None, seed=0,
                        device="cuda", batch_buckets=(1, 4, 8, 16),
                        point_buckets=(1024, 2048, 4096), devices=None,
                        **model_kwargs):
        """Build the engine with weights the port may not have trained: a
        reference ``.t7`` state dict through ``convert.load_reference``,
        any other file (a trainer checkpoint, a ``save_params_only`` file,
        a bare ``state_dict``) through
        ``train/checkpoint.restore_params_only``; without ``ckpt_path``,
        fresh weights from ``seed``, as ``build``."""
        if ckpt_path is None:
            return cls.build(model_name, seed, device, batch_buckets,
                             point_buckets, devices, **model_kwargs)
        model = load_weights(get_model(model_name, **model_kwargs),
                             registry_name(model_name), ckpt_path)
        return cls(model, device, batch_buckets, point_buckets, devices)

    def pad_batch(self, clouds: Sequence[np.ndarray]):
        """-> (batch [b, p, 3] float32 numpy, n, b, p)."""
        n = len(clouds)
        b = _next_bucket(n, self.batch_buckets)
        d = len(self.replicas)
        b = -(-b // d) * d   # every replica gets a block of rows
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
        if len(self.replicas) == 1:
            out = self.model(torch.from_numpy(batch).to(self.device))
            return out, n, b, p
        rows = b // len(self.replicas)
        # every replica's work is queued before any output is read
        outs = [m(torch.from_numpy(batch[i * rows:(i + 1) * rows]).to(dev))
                for i, (m, dev) in enumerate(zip(self.replicas,
                                                 self.devices))]
        return _merge(outs, rows, self.device), n, b, p

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
