"""The program's S3DIS task under the KPConv protocol, as its command line
wires the training set (``tasks/segmentation_kpconv.make_datasets``'s train
half): ``S3DISSeg`` on the synthetic rooms (no dataset is in the
repository) with the protocol's sphere schedule, radius, voxel size,
colour drop and padding to the traffic's points, the rotation, scaling and
jitter drawn from one generator that the loader's worker threads share,
and the masked cross-entropy.  The schedule (which spheres, so how many
valid points each holds) is the set's own, the same for every seed; the
seed draws each sphere's shuffle, padding and colour drop and the
augmentation's generator."""

import os

import numpy as np


def trainer_config(config, traffic, exp_root):
    """The configuration as ``Trainer`` and ``S3DISSeg`` take it."""
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
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv
    return segmentation_kpconv.make_loss_fn()


def loader(cfg, traffic, seed):
    from cloud_transformers_tpu_torch.data import DataLoader
    from cloud_transformers_tpu_torch.data.s3dis_kpconv import S3DISSeg
    from cloud_transformers_tpu_torch.parallel.distributed import \
        process_rows
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv as sk
    rng = np.random.RandomState(int(seed) % 2 ** 32)

    def train_transform(points):
        return sk.batch_rotate_scale_jitter(points[None], rng)[0]

    d = cfg["data"]
    train_ds = S3DISSeg(split="train", color_drop=d.get("color_drop", 0.2),
                        transforms=train_transform,
                        **sk.dataset_kwargs(cfg, True))
    train_ds.seed = int(seed)
    return DataLoader(train_ds, d["batch_size"], shuffle=False,
                      num_workers=int(d.get("num_workers", 0)),
                      **process_rows())


def valid_points(batch):
    """Each sphere's valid (unpadded) points."""
    return [int(m) for m in np.asarray(batch["mask"]).sum(1)]


def launch_shape(traffic):
    """(spheres, points) of every launch of the step: padded points are
    launched."""
    return traffic["batch"], traffic["points"]
