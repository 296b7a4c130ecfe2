"""Train the S3DIS segmenter under the KPConv/CloserLook3D protocol with
the port.

    python -m cloud_transformers_tpu_torch.train_segmentation_kpconv \\
        EXP_NAME -c configs/s3dis_kpconv.yaml [--synthetic] [--steps N] \\
        [--num-votes 20] [--device cpu]

The command line of the JAX package's ``train_segmentation_kpconv.py``, its
multi-host flags too (``--coordinator host:port --num-processes N
--process-id P``, or ``torchrun --nproc-per-node N``'s environment;
``--dist-backend nccl|gloo``): each process trains on its rows of the global
batch, ``data.batch_size`` a process. Runs on ``cuda`` (``cuda:<local
rank>`` across processes) unless ``--device`` says otherwise. The protocol's
constants are config keys (2000 steps an epoch, ``sampleDl`` 0.04,
``in_radius`` 2.0, 8192 points, 4 feature dimensions, ``clip_grad_norm`` 10
where the config names none); training items are rotated, scaled and
jittered. Each epoch ends with a 2-vote validation (not with ``--steps``,
which stops after N optimizer steps); the run ends with a ``--num-votes``
validation and prints its part, sub-cloud and full-cloud mIoU. A run resumes
from its ``ckpt_latest``.

The training augmentation shares one ``RandomState(0)`` across the
loader's worker threads, as the JAX command line does, so its draws
follow the order in which the threads reach it.
"""

import argparse
import logging

import numpy as np


def main(argv=None):
    from cloud_transformers_tpu_torch.parallel.distributed import (
        add_cli_flags,
        init_from_args,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp_name")
    ap.add_argument("-c", "--config", default="configs/s3dis_kpconv.yaml")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic rooms (no files needed)")
    ap.add_argument("--steps", type=int, default=None,
                    help="stop after N optimizer steps (smoke runs)")
    ap.add_argument("--num-votes", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    add_cli_flags(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    device = init_from_args(args)

    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv as task
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    cfg["train"].setdefault("clip_grad_norm", 10.0)
    model = model_from_config(cfg)
    train_ds, val_ds, train_loader, val_loader = task.make_datasets(
        cfg, synthetic=args.synthetic)
    features = cfg["data"].get("input_features_dim", 4)

    trainer = Trainer(model, cfg, args.exp_name, task.make_loss_fn(),
                      device=device, config_path=args.config)
    n_classes = int(cfg["model"].get("n_classes", 13))

    def epoch_validate(epoch):
        # a 2-vote validation every val_step epochs, as the reference does
        r = task.validate_votes(
            trainer.eval_step, val_ds, val_loader, num_classes=n_classes,
            num_votes=2, input_features_dim=features,
            logger=trainer.logger)
        return {k: v for k, v in r.items() if np.ndim(v) == 0}

    # the schedule is drawn in advance; the dataset indexes it by epoch
    trainer.fit(EpochLoader(train_loader), val_loader=None,
                max_steps=args.steps,
                epoch_hook=None if args.steps else epoch_validate)

    results = task.validate_votes(
        trainer.eval_step, val_ds, val_loader, num_classes=n_classes,
        num_votes=args.num_votes,
        input_features_dim=features, logger=trainer.logger)
    if trainer.is_main:
        print({k: v for k, v in results.items() if k != "ious"})
    return trainer, results


class EpochLoader:
    """The training loader as ``Trainer.fit`` takes it: ``set_epoch``
    reaches the dataset's schedule through ``DataLoader.set_epoch``."""

    def __init__(self, loader):
        self.loader = loader

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        return iter(self.loader)

    def __len__(self):
        return len(self.loader)


if __name__ == "__main__":
    from cloud_transformers_tpu_torch.parallel.distributed import destroy
    try:
        main()
    finally:
        destroy()   # leave the process group, where there is one
