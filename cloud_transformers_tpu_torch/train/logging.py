"""Experiment logging: TensorBoard (where tensorboardX imports), JSONL and
the console.

Counterpart of ``cloud_transformers_tpu/train/logging.py``: on the main
process (rank 0, or the only one) a ``SummaryWriter`` in the experiment's
writer directory, every scalar also appended to ``metrics.jsonl`` there,
the config copied into the experiment directory, per-block occupancy and
key statistics, and point clouds as TensorBoard meshes; on the other ranks
a ``MetricLogger`` writes nothing.
"""

import json
import logging
import os
import shutil
import sys
import time


def setup_logger(name="cloud_transformers_tpu_torch"):
    """The port's logger at INFO.  Where nothing handles log records yet
    (no handler on the logger or on the root logger), it gets a stderr
    handler in the reference's format; records still propagate, so a
    handler configured later (``logging.basicConfig``, pytest) sees them."""
    logger = logging.getLogger(name)
    if not logger.handlers and not logging.getLogger().handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "[%(asctime)s %(name)s]: %(message)s", datefmt="%m/%d %H:%M:%S"))
        logger.addHandler(h)
    if logger.level == logging.NOTSET:
        logger.setLevel(logging.INFO)
    return logger


class MetricLogger:
    """Writes scalars to TensorBoard (if tensorboardX imports) and to
    ``{writer_dir}/metrics.jsonl``; copies the config file into
    ``exp_dir``.  With ``is_main_process`` false it opens and writes
    nothing."""

    def __init__(self, writer_dir, exp_dir=None, config_path=None,
                 is_main_process=True):
        self.is_main = is_main_process
        self.writer = self.jsonl = None
        if not self.is_main:
            return
        os.makedirs(writer_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(writer_dir)
        except Exception:
            self.writer = None
        self.jsonl = open(os.path.join(writer_dir, "metrics.jsonl"), "a")
        if config_path and exp_dir:
            os.makedirs(exp_dir, exist_ok=True)
            shutil.copy(config_path,
                        os.path.join(exp_dir, os.path.basename(config_path)))

    def scalars(self, step, metrics, prefix=""):
        """One JSON line ``{"step", "time", prefix + key: value}`` of the
        metrics that convert to float (others are skipped), and one
        TensorBoard scalar each."""
        if not self.is_main:
            return
        clean = {}
        for k, v in metrics.items():
            try:
                clean[prefix + k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        if self.writer is not None:
            for k, v in clean.items():
                self.writer.add_scalar(k, v, global_step=step)
        self.jsonl.write(json.dumps(
            {"step": int(step), "time": time.time(), **clean}) + "\n")
        self.jsonl.flush()

    def block_stats(self, step, stats_list, prefix="train/"):
        """Per-block occupancy and key statistics (a model's ``stats``)."""
        for i, s in enumerate(stats_list):
            self.scalars(step, {
                f"occupancy/block_{i}": s["occupancy"],
                f"key_mean/block_{i}": s["key_mean"],
                f"key_var/block_{i}": s["key_var"],
            }, prefix=prefix)

    def mesh(self, step, tag, points, colors=None):
        """A batch of point clouds [B, N, 3] as a TensorBoard mesh; nothing
        without tensorboardX or its mesh plugin."""
        if self.writer is None:
            return
        import numpy as np
        try:
            self.writer.add_mesh(tag, vertices=np.asarray(points),
                                 colors=colors, global_step=step)
        except Exception:
            pass   # the mesh plugin is optional

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self.jsonl is not None:
            self.jsonl.close()


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)
