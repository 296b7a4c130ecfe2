"""Train the single-view reconstructor with the port.

    python -m cloud_transformers_tpu_torch.train_image_reconstruction \\
        EXP_NAME -c configs/reconstruction.yaml [--synthetic] [--steps N] \\
        [--device cpu]

The command line of the JAX package's ``train_image_reconstruction.py``, its
multi-host flags too (``--coordinator host:port --num-processes N
--process-id P``, or ``torchrun --nproc-per-node N``'s environment;
``--dist-backend nccl|gloo``): each process trains on its rows of the global
batch, ``data.batch_size`` a process. Runs on ``cuda`` (``cuda:<local
rank>`` across processes) unless ``--device`` says otherwise. The loss is
the auction EMD (eps 0.005, 50 rounds) between the reconstruction of sphere
noise and the ground-truth cloud, with the adjusted Chamfer distance logged
beside it; validation uses the same loss, and ``ckpt_best`` keeps the lowest
validation loss, as in the JAX trainer. Every ``train.mesh_each`` steps the
reconstruction of a few images of the batch goes to TensorBoard as a mesh. A
run resumes from its ``ckpt_latest``.
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
    ap.add_argument("-c", "--config", default="configs/reconstruction.yaml")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset (no files needed)")
    ap.add_argument("--steps", type=int, default=None,
                    help="stop after N optimizer steps (smoke runs)")
    ap.add_argument("--device", default="cuda")
    add_cli_flags(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    device = init_from_args(args)

    import torch

    from cloud_transformers_tpu_torch.tasks import reconstruction
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config)
    model = model_from_config(cfg)
    train_loader, val_loader = reconstruction.make_datasets(
        cfg, synthetic=args.synthetic)
    # the noise of the training and of the validation loss
    gens = {"train": torch.Generator(device).manual_seed(1),
            "val": torch.Generator(device).manual_seed(2)}
    trainer = Trainer(model, cfg, args.exp_name,
                      reconstruction.make_loss_fn(gens["train"]),
                      eval_fn=reconstruction.make_loss_fn(gens["val"]),
                      device=device, seed=0, generators=gens,
                      config_path=args.config)
    trainer.fit(train_loader, val_loader, max_steps=args.steps,
                mesh_hook=reconstruction.make_mesh_hook())
    logging.getLogger("cloud_transformers_tpu_torch").info(
        "done: %d steps", trainer.global_step)
    return trainer


if __name__ == "__main__":
    from cloud_transformers_tpu_torch.parallel.distributed import destroy
    try:
        main()
    finally:
        destroy()   # leave the process group, where there is one
