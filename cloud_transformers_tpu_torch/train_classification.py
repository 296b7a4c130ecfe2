"""Train the ScanObjectNN classifier with the port.

    python -m cloud_transformers_tpu_torch.train_classification EXP_NAME \\
        -c configs/scanobjectnn.yaml [--synthetic] [--steps N] [--device cpu]

The command line of the JAX package's ``train_classification.py`` without
its multi-host flags.  Runs on ``cuda`` unless ``--device`` says otherwise.
"""

import argparse
import logging


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp_name")
    ap.add_argument("-c", "--config", default="configs/scanobjectnn.yaml")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset (no files needed)")
    ap.add_argument("--steps", type=int, default=None,
                    help="stop after N optimizer steps (smoke runs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    from cloud_transformers_tpu_torch.tasks import classification
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    model = model_from_config(cfg)
    train_loader, val_loader = classification.make_datasets(
        cfg, synthetic=args.synthetic)
    loss_fn = classification.make_loss_fn(
        seg_weight=float(cfg["train"].get("seg_weight", 0.5)))
    trainer = Trainer(model, cfg, args.exp_name, loss_fn,
                      device=args.device, config_path=args.config)
    hook = classification.ClassEvalAccumulator(
        int(cfg.get("model", {}).get("n_classes", 15)))
    # the hook's pooled accuracy and mean class accuracy gate ckpt_best and
    # ckpt_macc_best, as in the JAX package's CLI
    cfg["train"].setdefault("best_metric", "cls_acc")
    cfg["train"].setdefault("best_metrics", ["m_acc"])
    trainer.fit(train_loader, val_loader, eval_hook=hook,
                max_steps=args.steps)
    logging.getLogger("cloud_transformers_tpu_torch").info(
        "done: %d steps", trainer.global_step)


if __name__ == "__main__":
    main()
