"""The program's ScanObjectNN classification task, as its command line
wires it: ``tasks/classification.make_datasets`` (the synthetic set: no
dataset is in the repository) with the traffic's batch, points and loader
workers, and its loss at the configuration's ``seg_weight``.  The seed
reseeds the loader's shuffle and the set's augmentation draws (jitter and
rotation about y, one stream an item), so every seed trains on the same
256 clouds of 2048 points in another order and pose."""

import os


def trainer_config(config, traffic, exp_root):
    """The configuration as ``Trainer`` and ``make_datasets`` take it."""
    return {
        "experiment": {"root": os.path.join(exp_root, "exp"),
                       "writer_root": os.path.join(exp_root, "runs")},
        "data": dict(config["data"], batch_size=traffic["batch"],
                     num_points=traffic["points"],
                     num_workers=traffic["loader_workers"]),
        "model": dict(config["model"], name=config["registry"]),
        "train": dict(config["train"], auto_resume=False, save=False),
    }


def loss_fn(config):
    from cloud_transformers_tpu_torch.tasks import classification
    return classification.make_loss_fn(float(config["train"]["seg_weight"]))


def loader(cfg, traffic, seed):
    from cloud_transformers_tpu_torch.tasks import classification
    train_loader, _ = classification.make_datasets(cfg, synthetic=True)
    train_loader.seed = int(seed) % 2 ** 31
    train_loader.dataset.seed = int(seed)
    return train_loader


def valid_points(batch):
    """Every cloud's points are real."""
    b, p = batch["pcd"].shape[:2]
    return [p] * b


def launch_shape(traffic):
    """(clouds, points) of every launch of the step."""
    return traffic["batch"], traffic["points"]
