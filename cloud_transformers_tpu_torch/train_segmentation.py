"""Train the S3DIS 1x1-protocol segmenter with the port.

    python -m cloud_transformers_tpu_torch.train_segmentation EXP_NAME \\
        -c configs/s3dis.yaml [--synthetic] [--steps N] [--device cpu]

The command line of the JAX package's ``train_segmentation.py``, its
multi-host flags too (``--coordinator host:port --num-processes N
--process-id P``, or ``torchrun --nproc-per-node N``'s environment;
``--dist-backend nccl|gloo``): each process trains on its rows of the global
batch, ``data.batch_size`` a process. Runs on ``cuda`` (``cuda:<local
rank>`` across processes) unless ``--device`` says otherwise. The loss is
the per-point cross-entropy, label-smoothed by 0.1 where
``train.label_smooth`` is set; each validation reports OA, mAcc, mIoU and
the IoU of each class, and ``ckpt_best`` follows ``train.best_metric``
(``miou`` where the config names none). A run resumes from its
``ckpt_latest``.
"""

import argparse
import logging


def main(argv=None):
    from cloud_transformers_tpu_torch.parallel.distributed import (
        add_cli_flags,
        init_from_args,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp_name")
    ap.add_argument("-c", "--config", default="configs/s3dis.yaml")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic blocks (no files needed)")
    ap.add_argument("--steps", type=int, default=None,
                    help="stop after N optimizer steps (smoke runs)")
    ap.add_argument("--device", default="cuda")
    add_cli_flags(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    device = init_from_args(args)

    from cloud_transformers_tpu_torch.tasks import segmentation
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    model = model_from_config(cfg)
    train_loader, val_loader = segmentation.make_datasets(
        cfg, synthetic=args.synthetic)
    n_classes = int(cfg["model"].get("n_classes", 13))
    loss_fn = segmentation.make_loss_fn(
        n_classes=n_classes,
        label_smooth=0.1 if cfg["train"].get("label_smooth") else 0.0)
    trainer = Trainer(model, cfg, args.exp_name, loss_fn,
                      device=device, config_path=args.config)
    hook = segmentation.SegEvalAccumulator(n_classes)
    # the hook's mIoU gates ckpt_best unless the config names a key, as in
    # the JAX package's CLI
    cfg["train"].setdefault("best_metric", "miou")
    trainer.fit(train_loader, val_loader, eval_hook=hook,
                max_steps=args.steps)
    logging.getLogger("cloud_transformers_tpu_torch").info(
        "done: %d steps", trainer.global_step)
    print(hook.compute())   # the last validation's metrics
    return trainer


if __name__ == "__main__":
    from cloud_transformers_tpu_torch.parallel.distributed import destroy
    try:
        main()
    finally:
        destroy()   # leave the process group, where there is one
