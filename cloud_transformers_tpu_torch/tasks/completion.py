"""ShapeNet completion task: the EMD (+ Chamfer) loss on 16384-point clouds
and the dataset wiring.

Counterpart of ``cloud_transformers_tpu/tasks/completion.py``: the ground
truth is scaled by 2, the partial cloud becomes the labeled sphere-noise
decoder input (``partial_postprocess``), and the loss is
mean(sqrt(EMD(recon, gt, eps 0.005, 50 rounds))) + ``chamfer_weight`` *
Chamfer; validation uses the EMD at eps 0.004 and up to 3000 rounds.
``make_mesh_hook`` gives ``Trainer.fit`` the periodic point-cloud summaries.
"""

import torch

from cloud_transformers_tpu_torch.core.noise import partial_postprocess
from cloud_transformers_tpu_torch.data import DataLoader
from cloud_transformers_tpu_torch.data.completion import ShapeNetCompletion
from cloud_transformers_tpu_torch.losses import emd_auction, loss_chamfer
from cloud_transformers_tpu_torch.parallel.distributed import (
    process_rows,
)


def make_loss_fn(generator, chamfer_weight=0.0, emd_eps=0.005, emd_iters=50,
                 gt_scale=2.0):
    """-> ``loss_fn(model, batch) -> (loss, aux)`` for a batch of tensors
    ``partial [B, P, 3]`` (zero-padded) and ``gt [B, N, 3]``.  The sphere
    noise and the resampling of each call are drawn from ``generator``.
    The model's mode (train or eval) is the caller's to set."""
    def loss_fn(model, batch):
        gt = batch["gt"] * gt_scale
        parts, noise = partial_postprocess(generator, batch["partial"],
                                           gt.shape[1])
        recon, stats = model(noise, parts)
        dist, _ = emd_auction(recon, gt, eps=emd_eps, iters=emd_iters)
        emd_loss = torch.sqrt(dist + 1e-12).mean()
        loss = emd_loss
        aux = {"loss_emd": emd_loss.detach()}
        if chamfer_weight:
            cham = loss_chamfer(recon, gt)
            loss = loss + chamfer_weight * cham
            aux["loss_chamfer"] = cham.detach()
        aux["occupancy_mean"] = torch.stack(
            [s["occupancy"] for s in stats]).mean()
        return loss, aux
    return loss_fn


def make_mesh_hook(gt_scale=2.0, max_clouds=4):
    """-> ``hook(trainer, batch)`` for ``Trainer.fit``'s ``mesh_hook``: an
    eval-mode forward of the first ``max_clouds`` clouds of the batch, the
    decoder's noise drawn from a generator seeded with the global step,
    and the reconstruction, the ground truth and the partial input logged
    as meshes (``train/recon``, ``train/gt``, ``train/partial_input``).
    The model goes back to training mode afterwards."""
    def hook(trainer, batch):
        model = trainer.model
        dev = trainer.device
        gt = torch.as_tensor(batch["gt"][:max_clouds]).to(dev) * gt_scale
        partial = torch.as_tensor(batch["partial"][:max_clouds]).to(dev)
        gen = torch.Generator(dev).manual_seed(trainer.global_step)
        parts, noise = partial_postprocess(gen, partial, gt.shape[1])
        was_training = model.training
        model.eval()
        with torch.no_grad():
            recon, _ = model(noise, parts)
        model.train(was_training)
        step = trainer.global_step
        trainer.metrics.mesh(step, "train/recon", recon.cpu().numpy())
        trainer.metrics.mesh(step, "train/gt", gt.cpu().numpy())
        trainer.metrics.mesh(step, "train/partial_input",
                             parts[..., :3].cpu().numpy())
    return hook


def make_datasets(cfg, synthetic=False):
    """-> (train_loader, val_loader) from a config's ``data:`` section."""
    d = cfg["data"]
    common = dict(n_input=d.get("input_size", 2048),
                  n_output=d.get("gt_size", 16384))
    paths = () if synthetic else (d.get("category_path"),
                                  d.get("partial_path"), d.get("gt_path"))
    train_ds = ShapeNetCompletion(*paths, split="train",
                                  n_renders=d.get("n_renders", 8), **common)
    val_ds = ShapeNetCompletion(*paths, split="val", **common)
    workers = int(d.get("num_workers", 0))
    train_loader = DataLoader(train_ds, d["batch_size"], shuffle=True,
                              num_workers=workers, **process_rows())
    val_loader = DataLoader(val_ds, d.get("batch_size_val", d["batch_size"]),
                            shuffle=False, num_workers=workers,
                            **process_rows())
    return train_loader, val_loader
