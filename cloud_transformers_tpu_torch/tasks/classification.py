"""ScanObjectNN classification task: loss, metrics, dataset wiring.

Counterpart of ``cloud_transformers_tpu/tasks/classification.py``:
loss = (1 - seg_weight) * CE(class) + seg_weight * BCE(per-point mask), with
overall accuracy, mask accuracy and mean grid occupancy beside it.
"""

import torch
import torch.nn.functional as F

from cloud_transformers_tpu_torch.data import DataLoader, ScanObjectNN
from cloud_transformers_tpu_torch.parallel.distributed import (
    all_reduce_array,
    process_rows,
)
from cloud_transformers_tpu_torch.utils.metrics import (
    ConfusionAccumulator,
    iou_from_confusion,
)


def make_loss_fn(seg_weight=0.5):
    """-> ``loss_fn(model, batch) -> (loss, aux)`` for a batch of tensors
    ``pcd [B, P, 3]``, ``label [B]`` (int64), ``mask [B, P]``.  The model's
    mode (train or eval) is the caller's to set."""
    def loss_fn(model, batch):
        class_pred, mask_pred, stats = model(batch["pcd"])
        cls_loss = F.cross_entropy(class_pred, batch["label"])
        seg_loss = F.binary_cross_entropy_with_logits(
            mask_pred[..., 0], batch["mask"])
        loss = (1.0 - seg_weight) * cls_loss + seg_weight * seg_loss
        with torch.no_grad():
            pred = class_pred.argmax(-1)
            aux = {
                "loss_cls": cls_loss.detach(),
                "loss_seg": seg_loss.detach(),
                "cls_acc": (pred == batch["label"]).float().mean(),
                "seg_acc": ((mask_pred[..., 0] > 0)
                            == (batch["mask"] > 0.5)).float().mean(),
                "occupancy_mean": torch.stack(
                    [s["occupancy"] for s in stats]).mean(),
                "pred": pred,
            }
        return loss, aux
    return loss_fn


def make_datasets(cfg, synthetic=False):
    """-> (train_loader, val_loader) from a config's ``data:`` section."""
    d = cfg["data"]
    path = None if synthetic else d.get("path")
    path_val = None if synthetic else d.get("path_val")
    train_ds = ScanObjectNN(path, center=d.get("center", True),
                            normalize=d.get("normalize", True), train=True,
                            num_points=d.get("num_points", 2048))
    val_ds = ScanObjectNN(path_val, center=d.get("center", True),
                          normalize=d.get("normalize", True), train=False,
                          num_points=d.get("num_points", 2048), seed=1)
    workers = int(d.get("num_workers", 0))
    train_loader = DataLoader(train_ds, d["batch_size"], shuffle=True,
                              num_workers=workers, **process_rows())
    val_loader = DataLoader(val_ds, d.get("batch_size_val", d["batch_size"]),
                            shuffle=False, num_workers=workers,
                            **process_rows())
    return train_loader, val_loader


class ClassEvalAccumulator:
    """Per-class accuracy over a validation pass, as ``Trainer.validate``'s
    eval hook: its ``compute()`` replaces the batch-mean cls_acc with the
    pooled overall accuracy and adds m_acc."""

    def __init__(self, n_classes):
        self.n_classes = n_classes
        self.cm = ConfusionAccumulator(n_classes)

    def reset(self):
        self.cm = ConfusionAccumulator(self.n_classes)

    def __call__(self, batch, metrics):
        self.cm.update(metrics["pred"].cpu().numpy(), batch["label"])

    def compute(self):
        # the counts of every rank's pass
        m = iou_from_confusion(all_reduce_array(self.cm.cm))
        return {"cls_acc": float(m["oa"]), "m_acc": float(m["macc"])}
