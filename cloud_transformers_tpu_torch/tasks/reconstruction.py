"""Single-view reconstruction task: the EMD loss on the image's cloud and
the dataset wiring.

Counterpart of ``cloud_transformers_tpu/tasks/reconstruction.py``: the
decoder's input is sphere noise with as many points as the ground truth,
the loss is mean(sqrt(EMD(recon, gt, eps 0.005, 50 rounds))), and the
adjusted Chamfer distance is logged beside it without a gradient.
``make_mesh_hook`` gives ``Trainer.fit`` the periodic point-cloud
summaries.  The evaluation (the merged two-pass F-score) is
``eval_reconstruction_f1.py``.
"""

import torch

from cloud_transformers_tpu_torch.core.noise import sphere_noise
from cloud_transformers_tpu_torch.data import DataLoader, ImageToPoint
from cloud_transformers_tpu_torch.losses import emd_auction, loss_chamfer_adj


def make_loss_fn(generator, emd_eps=0.005, emd_iters=50):
    """-> ``loss_fn(model, batch) -> (loss, aux)`` for a batch of tensors
    ``image [B, H, W, 3]`` and ``pcd [B, N, 3]``.  The sphere noise of each
    call is drawn from ``generator``.  The model's mode (train or eval) is
    the caller's to set."""
    def loss_fn(model, batch):
        gt = batch["pcd"]
        noise = sphere_noise(generator, gt.shape[0], gt.shape[1], gt.device)
        recon, stats = model(noise, batch["image"])
        dist, _ = emd_auction(recon, gt, eps=emd_eps, iters=emd_iters)
        loss = torch.sqrt(dist + 1e-12).mean()
        with torch.no_grad():
            cham = loss_chamfer_adj(recon, gt)
        aux = {"loss_chamfer": cham,
               "occupancy_mean": torch.stack(
                   [s["occupancy"] for s in stats]).mean()}
        return loss, aux
    return loss_fn


def make_mesh_hook(max_clouds=4):
    """-> ``hook(trainer, batch)`` for ``Trainer.fit``'s ``mesh_hook``: an
    eval-mode forward of the first ``max_clouds`` images of the batch, the
    noise drawn from a generator seeded with the global step, and the
    reconstruction and the ground truth logged as meshes (``train/recon``,
    ``train/gt``).  The model goes back to training mode afterwards."""
    def hook(trainer, batch):
        model = trainer.model
        dev = trainer.device
        gt = torch.as_tensor(batch["pcd"][:max_clouds]).to(dev)
        image = torch.as_tensor(batch["image"][:max_clouds]).to(dev)
        gen = torch.Generator(dev).manual_seed(trainer.global_step)
        noise = sphere_noise(gen, gt.shape[0], gt.shape[1], dev)
        was_training = model.training
        model.eval()
        with torch.no_grad():
            recon, _ = model(noise, image)
        model.train(was_training)
        step = trainer.global_step
        trainer.metrics.mesh(step, "train/recon", recon.cpu().numpy())
        trainer.metrics.mesh(step, "train/gt", gt.cpu().numpy())
    return hook


def make_datasets(cfg, synthetic=False):
    """-> (train_loader, val_loader) from a config's ``data:`` section."""
    d = cfg["data"]
    path = None if synthetic else d.get("path")
    common = dict(im_size=d.get("im_size", 128),
                  points=d.get("gt_size", 8192))
    train_ds = ImageToPoint(path, split="train", **common)
    val_ds = ImageToPoint(path, split="val", seed=1, **common)
    workers = int(d.get("num_workers", 0))
    train_loader = DataLoader(train_ds, d["batch_size"], shuffle=True,
                              num_workers=workers)
    val_loader = DataLoader(val_ds, d.get("batch_size_val", d["batch_size"]),
                            shuffle=False, num_workers=workers)
    return train_loader, val_loader
