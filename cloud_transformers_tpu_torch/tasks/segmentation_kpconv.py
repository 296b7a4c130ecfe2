"""S3DIS under the KPConv/CloserLook3D protocol: the masked loss, the vote
validation, the metrics at part, sub-cloud and full-cloud granularity, and
the dataset wiring of the command lines.

Counterpart of ``cloud_transformers_tpu/tasks/segmentation_kpconv.py`` (the
reference's ``s3dis_closer_train.py``: the masked cross-entropy, gradient
clipping at 10, the multi-vote validation; ``s3dis_closer_utils.py``: the
IoU with the absent-class substitution and the rebalancing by the
validation set's class proportions).  The metrics and the test-time
augmentation are numpy, the JAX module's arithmetic line for line.
"""

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from cloud_transformers_tpu_torch.data import DataLoader
from cloud_transformers_tpu_torch.data.s3dis_kpconv import S3DISSeg
from cloud_transformers_tpu_torch.parallel.distributed import (
    all_gather_array,
    all_reduce_,
    is_distributed,
    process_rows,
    rank,
    world_size,
)


def dataset_kwargs(cfg, synthetic, num_epochs=None):
    """``S3DISSeg``'s protocol arguments from a config's ``data:`` and
    ``train:`` sections, with the JAX command lines' defaults."""
    d = cfg["data"]
    return dict(
        input_features_dim=d.get("input_features_dim", 4),
        subsampling_parameter=d.get("sampleDl", 0.04),
        in_radius=d.get("in_radius", 2.0),
        num_points=d.get("num_points", 8192),
        num_steps=d.get("num_steps", 2000),
        num_epochs=num_epochs or cfg["train"].get("num_epochs", 600),
        data_root=None if synthetic else d.get("path"))


def make_datasets(cfg, synthetic=False):
    """-> (train set, validation set, train loader, validation loader), as
    the JAX command line makes them: the training items are rotated,
    scaled and jittered through one ``RandomState(0)`` that the loader's
    worker threads share (so its draws follow the order in which the
    threads reach it), with the config's color drop; neither loader
    shuffles (the dataset's schedule is drawn in advance)."""
    d = cfg["data"]

    def train_transform(points, rng=np.random.RandomState(0)):
        return batch_rotate_scale_jitter(points[None], rng)[0]

    common = dataset_kwargs(cfg, synthetic)
    train_ds = S3DISSeg(split="train", color_drop=d.get("color_drop", 0.2),
                        transforms=train_transform, **common)
    val_ds = S3DISSeg(split="val", **common)
    workers = int(d.get("num_workers", 0))
    train_loader = DataLoader(train_ds, d["batch_size"], shuffle=False,
                              num_workers=workers, **process_rows())
    val_loader = DataLoader(val_ds, d.get("batch_size_val", d["batch_size"]),
                            shuffle=False, num_workers=workers,
                            **process_rows())
    return train_ds, val_ds, train_loader, val_loader


def make_loss_fn():
    """-> ``loss_fn(model, batch) -> (loss, aux)``: the cross-entropy
    averaged over the valid (``mask`` 1) points of a batch of tensors
    ``points [B, P, 3]``, ``mask [B, P]``, ``features [B, P, F]`` and
    ``label [B, P]`` (int64), all on the device with no wait for it.
    ``aux``: ``acc`` over the valid points, ``logits [B, P, C]`` and
    ``pred [B, P]``.  The model's mode is the caller's to set.

    Across processes the normaliser is the global batch's valid count
    (all-reduced, not differentiated) over the world size, so that the
    ranks' averaged gradient is the gradient of the JAX package's loss
    over the global ragged batch, and the ranks' mean ``loss`` and ``acc``
    are the global batch's."""
    def loss_fn(model, batch):
        logits, _ = model(batch["points"], batch["mask"], batch["features"])
        labels = batch["label"]
        mask = batch["mask"]
        per_pt = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1),
                                 reduction="none").reshape(labels.shape)
        valid = _valid_count(mask)
        loss = (per_pt * mask).sum() / valid
        with torch.no_grad():
            pred = logits.argmax(-1)
            aux = {"acc": ((pred == labels) * mask).sum() / valid,
                   "logits": logits.detach(), "pred": pred}
        return loss, aux
    return loss_fn


def _valid_count(mask):
    """The masked mean's normaliser: this batch's valid points, or across
    processes the global batch's over the world size, a points axis
    (``parallel/mesh.py``) included: each rank's loss is then its share,
    and the world's mean of the ranks' losses the global batch's (a rank
    whose block holds no valid point adds 0)."""
    valid = mask.sum().detach()
    if not is_distributed():
        return valid.clamp(min=1.0)
    return all_reduce_(valid.clone(), "sum").clamp(min=1.0) / world_size()


# --- metrics (numpy, on the host) ------------------------------------------

def confusion_np(truth, pred, num_classes):
    idx = truth.astype(np.int64) * num_classes + pred.astype(np.int64)
    return np.bincount(idx, minlength=num_classes ** 2).reshape(
        num_classes, num_classes)


def iou_from_confusions(c):
    """Per-class IoU; an absent class gets the mean IoU of the present ones
    substituted, so that the plain mean equals the present-class mean."""
    tp = np.diagonal(c, axis1=-2, axis2=-1).astype(np.float64)
    tp_fn = np.sum(c, axis=-1)
    tp_fp = np.sum(c, axis=-2)
    iou = tp / (tp_fp + tp_fn - tp + 1e-6)
    mask = tp_fn < 1e-3
    counts = np.sum(1 - mask, axis=-1, keepdims=True)
    miou = np.sum(iou, axis=-1, keepdims=True) / (counts + 1e-6)
    iou += mask * miou
    return iou


def part_metrics(num_classes, predictions, targets, val_proportions):
    c = np.zeros((num_classes, num_classes), np.float64)
    for logits, truth in zip(predictions, targets):
        c += confusion_np(truth, np.argmax(logits, axis=-1), num_classes)
    c *= np.expand_dims(val_proportions / (np.sum(c, axis=1) + 1e-6), 1)
    ious = iou_from_confusions(c)
    return ious, float(np.mean(ious))


def sub_metrics(num_classes, vote_logits, sub_labels, val_proportions):
    c = np.zeros((num_classes, num_classes), np.float64)
    for logits, truth in zip(vote_logits, sub_labels):
        c += confusion_np(truth, np.argmax(logits, axis=0), num_classes)
    c *= np.expand_dims(val_proportions / (np.sum(c, axis=1) + 1e-6), 1)
    ious = iou_from_confusions(c)
    return ious, float(np.mean(ious))


def full_metrics(num_classes, vote_logits, projections, full_labels):
    c = np.zeros((num_classes, num_classes), np.float64)
    for logits, proj, truth in zip(vote_logits, projections, full_labels):
        preds = np.argmax(logits[:, proj], axis=0)
        c += confusion_np(truth.reshape(-1), preds, num_classes)
    ious = iou_from_confusions(c)
    return ious, float(np.mean(ious))


def batch_rotate_scale_jitter(points, rng, x_range=0.0, y_range=0.0,
                              z_range=np.pi, scale_low=0.7, scale_high=1.3,
                              std=0.001, clip=0.05,
                              augment_symmetries=(True, False, False)):
    """The vote rounds' test-time augmentation (the reference's
    ``BatchPointcloudRandomRotate`` and ``BatchPointcloudScaleAndJitter``)
    on a numpy batch [B, N, 3]."""
    out = np.empty_like(points)
    for b in range(points.shape[0]):
        ax, ay, az = (rng.uniform(-x_range, x_range),
                      rng.uniform(-y_range, y_range),
                      rng.uniform(-z_range, z_range))
        cx, sx = np.cos(ax), np.sin(ax)
        cy, sy = np.cos(ay), np.sin(ay)
        cz, sz = np.cos(az), np.sin(az)
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        r = (rz @ ry @ rx).astype(np.float32)
        scale = rng.uniform(scale_low, scale_high, 3).astype(np.float32)
        for i, flag in enumerate(augment_symmetries):
            if flag and rng.rand() < 0.5:
                scale[i] = -scale[i]
        noise = np.clip(rng.randn(points.shape[1], 3) * std, -clip,
                        clip).astype(np.float32)
        out[b] = points[b] @ r.T * scale + noise
    return out


def validate_votes(eval_step, dataset: S3DISSeg, loader, num_classes,
                   num_votes=10, input_features_dim=4, test_smooth=0.95,
                   epoch=0, logger=None, seed=0):
    """The vote-accumulating validation (the reference's
    ``s3dis_closer_train.py``).  ``eval_step(batch) -> metrics`` with
    ``logits`` [B, N, C], a tensor on any device (copied to the host once
    a batch); ``mask``, ``input_inds`` and ``cloud_index`` are read from
    the numpy batch.  -> {``part_miou``, ``sub_miou``,
    ``running_sub_miou``, ``miou`` (full cloud), ``ious`` (full cloud,
    per class)} of the last vote.

    Across processes each rank evaluates its rows of every global batch,
    and every rank gathers the global batch and its logits and accumulates
    all of it (the augmentation too is drawn for the global batch), so
    that the votes and the metrics are the single-process run's on every
    rank."""
    rng = np.random.RandomState(seed)
    vote_sum = [np.zeros((num_classes, lbl.shape[0]), np.float32)
                for lbl in dataset.sub_labels]
    vote_cnt = [np.zeros((1, lbl.shape[0]), np.float32) + 1e-6
                for lbl in dataset.sub_labels]
    # EMA-smoothed logits, the reference's 'running sub_mIoU'
    running = [np.zeros((num_classes, lbl.shape[0]), np.float32)
               for lbl in dataset.sub_labels]
    val_proportions = np.array(
        [np.sum([np.sum(lbl == c) for lbl in dataset.clouds_labels])
         for c in range(num_classes)], np.float32)

    results = {}
    for v in range(num_votes):
        dataset.set_epoch((epoch + v) % max(dataset.num_epochs, 1))
        predictions: List[np.ndarray] = []
        targets: List[np.ndarray] = []
        for batch in loader:
            rows = None
            if is_distributed():
                n = len(batch["points"])
                rows = slice(rank() * n, (rank() + 1) * n)
                batch = {k: all_gather_array(np.asarray(a))
                         for k, a in batch.items()}
            if v > 0:
                pts = batch_rotate_scale_jitter(batch["points"], rng)
                batch = dict(batch, points=pts)
                if input_features_dim > 5:
                    colors = batch["features"][..., :input_features_dim - 3]
                    batch["features"] = np.concatenate([colors, pts], -1)
            # [B, N, C], one copy to the host a batch
            mine = batch if rows is None else \
                {k: a[rows] for k, a in batch.items()}
            logits = eval_step(mine)["logits"].cpu().numpy()
            if rows is not None:
                logits = all_gather_array(logits)
            for ib in range(logits.shape[0]):
                mask_i = np.asarray(batch["mask"][ib]).astype(bool)
                lg = logits[ib][mask_i].T  # [C, n]
                inds = np.asarray(batch["input_inds"][ib])[mask_i]
                ci = int(batch["cloud_index"][ib])
                vote_sum[ci][:, inds] += lg
                vote_cnt[ci][:, inds] += 1
                running[ci][:, inds] = (test_smooth * running[ci][:, inds]
                                        + (1 - test_smooth) * lg)
                predictions.append(lg.T)
                targets.append(dataset.sub_labels[ci][inds])
        vote_logits = [s / c for s, c in zip(vote_sum, vote_cnt)]
        _, pmiou = part_metrics(num_classes, predictions, targets,
                                val_proportions)
        _, submiou = sub_metrics(num_classes, vote_logits,
                                 dataset.sub_labels, val_proportions)
        _, run_submiou = sub_metrics(num_classes, running,
                                     dataset.sub_labels, val_proportions)
        ious, miou = full_metrics(num_classes, vote_logits,
                                  dataset.projections, dataset.clouds_labels)
        results = {"part_miou": pmiou, "sub_miou": submiou,
                   "running_sub_miou": run_submiou, "miou": miou,
                   "ious": ious}
        if logger:
            logger.info("vote %d: part %.4f sub %.4f full %.4f",
                        v, pmiou, submiou, miou)
    return results
