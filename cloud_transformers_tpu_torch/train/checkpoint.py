"""Checkpoints on ``torch.save`` with the JAX package's tags.

Counterpart of ``cloud_transformers_tpu/train/checkpoint.py``.  A trainer
checkpoint ``{exp_dir}/ckpt_{tag}.pt`` (``latest``, an epoch, a step count)
is one dictionary of tensors, numbers and lists: the model's ``state_dict``,
the optimizer's and the schedule's, ``meta`` (``global_step``, ``epoch``)
and the states of the random generators, so that a run that was killed
resumes where it stopped.  It is written to a temporary name and renamed,
and read back with ``weights_only=True``.

``restore_params_only`` takes the model's tensors from a trainer checkpoint,
from a ``save_params_only`` file or from a bare ``state_dict`` file, and
leaves optimizer and step alone: the evaluation scripts and fine-tuning use
it.
"""

import os

import torch


class CheckpointManager:
    def __init__(self, exp_dir):
        self.exp_dir = os.path.abspath(exp_dir)
        os.makedirs(self.exp_dir, exist_ok=True)

    def path(self, tag):
        return os.path.join(self.exp_dir, f"ckpt_{tag}.pt")

    def save(self, payload, tag):
        """Write ``payload`` (a dict of tensors, numbers, strings, lists
        and dicts) under ``tag``; -> its path."""
        path = self.path(tag)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def restore(self, tag="latest"):
        return torch.load(self.path(tag), map_location="cpu",
                          weights_only=True)

    def exists(self, tag="latest"):
        return os.path.isfile(self.path(tag))


def restore_params_only(ckpt_path, model):
    """Load the parameters and buffers saved at ``ckpt_path`` into
    ``model`` (strict), whatever kind of file it is; -> the model."""
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state = raw.get("model", raw) if isinstance(raw, dict) else raw
    if not isinstance(state, dict) or not state or not all(
            torch.is_tensor(v) for v in state.values()):
        raise ValueError(
            f"checkpoint at {ckpt_path} holds no model state (top-level "
            f"keys: {list(raw) if isinstance(raw, dict) else type(raw)})")
    model.load_state_dict(state, strict=True)
    return model


def save_params_only(model, path):
    """Save a bare ``{"model": state_dict}`` file (export, conversion)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": model.state_dict()}, path)
