"""Train the ShapeNet completion model with the port.

    python -m cloud_transformers_tpu_torch.train_inpainter EXP_NAME \\
        -c configs/inpainting.yaml [--synthetic] [--steps N] [--device cpu]

The command line of the JAX package's ``train_inpainter.py`` without its
multi-host flags.  Runs on ``cuda`` unless ``--device`` says otherwise.
The loss is the auction EMD (eps 0.005, 50 rounds) plus ``chamfer_weight``
times the Chamfer loss; validation uses the EMD at eps 0.004 with
``val_emd_iters`` rounds.  Every ``train.mesh_each`` steps the
reconstruction of a few clouds of the batch goes to TensorBoard as a mesh.
A run resumes from its ``ckpt_latest``.
"""

import argparse
import logging


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp_name")
    ap.add_argument("-c", "--config", default="configs/inpainting.yaml")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset (no files needed)")
    ap.add_argument("--steps", type=int, default=None,
                    help="stop after N optimizer steps (smoke runs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    import torch

    from cloud_transformers_tpu_torch.tasks import completion
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    model = model_from_config(cfg)
    train_loader, val_loader = completion.make_datasets(
        cfg, synthetic=args.synthetic)
    # the noise of the training and of the validation loss
    gens = {"train": torch.Generator(args.device).manual_seed(1),
            "val": torch.Generator(args.device).manual_seed(2)}
    chamfer_weight = float(cfg["train"].get("chamfer_weight", 0.0))
    loss_fn = completion.make_loss_fn(gens["train"], chamfer_weight)
    eval_fn = completion.make_loss_fn(
        gens["val"], chamfer_weight, emd_eps=0.004,
        emd_iters=int(cfg["train"].get("val_emd_iters", 3000)))
    trainer = Trainer(model, cfg, args.exp_name, loss_fn, eval_fn=eval_fn,
                      device=args.device, seed=0, generators=gens,
                      config_path=args.config)
    # point-cloud summaries of the reconstruction, the ground truth and the
    # partial input every train.mesh_each steps
    trainer.fit(train_loader, val_loader, max_steps=args.steps,
                mesh_hook=completion.make_mesh_hook())
    logging.getLogger("cloud_transformers_tpu_torch").info(
        "done: %d steps", trainer.global_step)


if __name__ == "__main__":
    main()
