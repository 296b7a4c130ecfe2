"""S3DIS 1x1-protocol segmentation task: loss, metrics, dataset wiring.

Counterpart of ``cloud_transformers_tpu/tasks/segmentation.py``: per-point
cross-entropy (optionally label-smoothed), the accuracy and the mean grid
occupancy beside it, and the confusion-matrix OA / mAcc / IoU / mIoU of a
validation pass.
"""

import torch
import torch.nn.functional as F

from cloud_transformers_tpu_torch.data import DataLoader, Indoor3DSemSeg
from cloud_transformers_tpu_torch.parallel.distributed import (
    all_reduce_array,
    process_rows,
)
from cloud_transformers_tpu_torch.utils.metrics import (
    ConfusionAccumulator,
    iou_from_confusion,
)


def make_loss_fn(n_classes=13, label_smooth=0.0):
    """-> ``loss_fn(model, batch) -> (loss, aux)`` for a batch of tensors
    ``pcd [B, P, 6]`` and ``label [B, P]`` (int64).  With
    ``label_smooth`` the targets are (1 - s) * one_hot + s / n_classes.
    The model's mode (train or eval) is the caller's to set."""
    def loss_fn(model, batch):
        logits, stats = model(batch["pcd"])
        labels = batch["label"]
        loss = F.cross_entropy(logits.reshape(-1, n_classes),
                               labels.reshape(-1),
                               label_smoothing=float(label_smooth))
        with torch.no_grad():
            pred = logits.argmax(-1)
            aux = {"acc": (pred == labels).float().mean(),
                   "occupancy_mean": torch.stack(
                       [s["occupancy"] for s in stats]).mean(),
                   "pred": pred}
        return loss, aux
    return loss_fn


def make_datasets(cfg, synthetic=False):
    """-> (train_loader, val_loader) from a config's ``data:`` section."""
    d = cfg["data"]
    path = None if synthetic else d.get("path")
    kwargs = dict(num_points=d.get("num_points", 4096),
                  test_area=d.get("test_area", "Area_5"))
    train_ds = Indoor3DSemSeg(path, train=True, aug=d.get("aug", True),
                              data_percent=d.get("data_percent", 1.0),
                              aug_elastic=d.get("aug_elastic", False),
                              aug_dropout=d.get("aug_dropout", False),
                              **kwargs)
    val_ds = Indoor3DSemSeg(path, train=False, aug=False, **kwargs)
    workers = int(d.get("num_workers", 0))
    train_loader = DataLoader(train_ds, d["batch_size"], shuffle=True,
                              num_workers=workers, **process_rows())
    val_loader = DataLoader(val_ds, d.get("batch_size_val", d["batch_size"]),
                            shuffle=False, num_workers=workers,
                            **process_rows())
    return train_loader, val_loader


class SegEvalAccumulator:
    """A streaming confusion matrix over a validation pass, as
    ``Trainer.validate``'s eval hook: ``compute()`` -> OA, mAcc, mIoU and
    the IoU of each class."""

    def __init__(self, n_classes=13):
        self.n_classes = n_classes
        self.cm = ConfusionAccumulator(n_classes)

    def reset(self):
        self.cm = ConfusionAccumulator(self.n_classes)

    def __call__(self, batch, metrics):
        pred = metrics["pred"]
        if torch.is_tensor(pred):
            pred = pred.cpu().numpy()
        self.cm.update(pred, batch["label"])

    def compute(self):
        # the counts of every rank's pass
        m = iou_from_confusion(all_reduce_array(self.cm.cm))
        return {"oa": float(m["oa"]), "macc": float(m["macc"]),
                "miou": float(m["miou"]),
                **{f"iou_{i}": float(v) for i, v in enumerate(m["iou"])}}
