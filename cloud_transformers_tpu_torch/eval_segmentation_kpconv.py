"""Evaluate the KPConv-protocol S3DIS segmenter with the port: a
``--num-votes`` test-time-augmented validation, mIoU at part, sub-cloud
and full-cloud granularity.

    python -m cloud_transformers_tpu_torch.eval_segmentation_kpconv \\
        EXP_NAME -c configs/eval/s3dis_kpconv.yaml [--synthetic] \\
        [--ckpt PATH] [--num-votes 20] [--device cpu]

The command line of the JAX package's ``eval_segmentation_kpconv.py``.
The weights come from ``--ckpt``, else from the config's
``restore.generator``: a port checkpoint through ``restore_params_only``,
or the reference's own state dict (a ``.t7`` file, such as the released
``s3dis_kpconvprotocol.t7``) through ``convert.load_reference``
(``convert.load_weights`` takes either).  Without either the model keeps
a fresh initialisation from seed 0.  Runs on ``cuda`` unless ``--device``
says otherwise.  Prints the results and the IoU of each class.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp_name")
    ap.add_argument("-c", "--config", default="configs/s3dis_kpconv.yaml")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint file (default: cfg restore.generator)")
    ap.add_argument("--num-votes", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from cloud_transformers_tpu_torch.convert import load_weights
    from cloud_transformers_tpu_torch.data import DataLoader, S3DISSeg
    from cloud_transformers_tpu_torch.nn.init import init_model_
    from cloud_transformers_tpu_torch.nn.precision import strict_f32
    from cloud_transformers_tpu_torch.tasks import segmentation_kpconv as task
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
        model_name,
    )
    from cloud_transformers_tpu_torch.train.logging import setup_logger

    cfg = load_config(args.config)
    d = cfg["data"]
    device = torch.device(args.device)
    if device.type == "cuda":
        strict_f32()
    model = model_from_config(cfg)
    ckpt = args.ckpt or cfg.get("restore", {}).get("generator")
    if ckpt:
        load_weights(model, model_name(cfg), ckpt)
    else:
        init_model_(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    logger = setup_logger()

    val_ds = S3DISSeg(split="val",
                      **task.dataset_kwargs(cfg, args.synthetic,
                                            num_epochs=20))
    loader = DataLoader(val_ds, d.get("batch_size_val", d["batch_size"]),
                        shuffle=False)
    loss_fn = task.make_loss_fn()

    @torch.no_grad()
    def eval_step(batch):
        on_device = {k: torch.as_tensor(batch[k]).to(device)
                     for k in ("points", "mask", "features")}
        on_device["label"] = torch.as_tensor(batch["label"]).long().to(
            device)
        return loss_fn(model, on_device)[1]

    results = task.validate_votes(
        eval_step, val_ds, loader,
        num_classes=int(cfg["model"].get("n_classes", 13)),
        num_votes=args.num_votes,
        input_features_dim=d.get("input_features_dim", 4), logger=logger)
    print({k: v for k, v in results.items() if k != "ious"})
    print("per-class IoU:", results["ious"])
    return results


if __name__ == "__main__":
    main()
