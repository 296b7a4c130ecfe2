"""Classification / segmentation metrics from a streaming confusion matrix.

Counterpart of ``cloud_transformers_tpu/utils/metrics.py``: overall
accuracy, mean class accuracy, per-class IoU and mIoU, with absent classes
left out of the means.  The accumulation is on the host in numpy: the
validation loop hands over one small prediction array per batch.
"""

import numpy as np


def confusion_matrix(pred, label, num_classes, valid=None):
    """pred/label int arrays of equal shape -> [C, C] float64 counts (rows =
    true, cols = predicted); entries outside [0, C) are dropped."""
    pred = np.asarray(pred).reshape(-1).astype(np.int64)
    label = np.asarray(label).reshape(-1).astype(np.int64)
    weights = (np.ones(pred.shape, np.float64) if valid is None
               else np.asarray(valid).reshape(-1).astype(np.float64))
    keep = ((pred >= 0) & (pred < num_classes)
            & (label >= 0) & (label < num_classes))
    idx = label[keep] * num_classes + pred[keep]
    cm = np.bincount(idx, weights=weights[keep],
                     minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def iou_from_confusion(cm):
    """cm [C, C] -> dict(oa, macc, miou, iou [C], class_acc [C])."""
    cm = np.asarray(cm, np.float64)
    tp = np.diagonal(cm)
    fn = cm.sum(axis=1) - tp
    fp = cm.sum(axis=0) - tp
    denom = tp + fp + fn
    iou = np.where(denom > 0, tp / np.maximum(denom, 1e-9), 0.0)
    present = cm.sum(axis=1) > 0
    class_acc = np.where(present, tp / np.maximum(cm.sum(axis=1), 1e-9), 0.0)
    n_present = max(int(present.sum()), 1)
    return {
        "oa": tp.sum() / max(cm.sum(), 1e-9),
        "macc": class_acc[present].sum() / n_present,
        "miou": iou[present].sum() / n_present,
        "iou": iou,
        "class_acc": class_acc,
    }


class ConfusionAccumulator:
    """Streaming confusion matrix over batches."""

    def __init__(self, num_classes):
        self.num_classes = num_classes
        self.cm = np.zeros((num_classes, num_classes), np.float64)

    def update(self, pred, label, valid=None):
        self.cm += confusion_matrix(pred, label, self.num_classes, valid)

    def compute(self):
        return {k: np.asarray(v)
                for k, v in iou_from_confusion(self.cm).items()}
