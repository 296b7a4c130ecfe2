"""Evaluate single-view reconstruction: F-score@0.01, precision and recall
per class.

    python -m cloud_transformers_tpu_torch.eval_reconstruction_f1 EXP_NAME \\
        -c configs/reconstruction.yaml [--synthetic] [--ckpt FILE] \\
        [--limit N] [--points 10000] [--device cpu]

The command line and protocol of the JAX package's
``eval_reconstruction_f1.py``: the test split with ``--points`` (10000)
ground-truth points; for each batch two independent draws of 8192
sphere-noise points, an eval-mode forward on each, the two predictions
concatenated and resampled to the ground truth's size by one permutation
drawn for the whole batch (``merge_passes``); then the F-score, precision
and recall at 0.01.  The weights come from ``--ckpt`` or the config's
``restore.generator``: a port checkpoint, or the reference's own state dict
(a ``.t7`` file) through ``convert.load_reference``; a fresh
initialisation from seed 0 without either.
Runs on ``cuda`` unless ``--device`` says otherwise.  ``evaluate`` is the
loop behind the command.
"""

import argparse
import time
from collections import defaultdict

import numpy as np

N_HALF = 8192      # points of each of the two forwards
THRESHOLD = 0.01   # the F-score's distance


def merge_passes(r1, r2, points, generator):
    """Concatenate two predictions ``[B, N1, 3]``, ``[B, N2, 3]`` and keep
    ``points`` of the N1 + N2, chosen without replacement by one
    ``torch.randperm`` from ``generator``, the same for every row of the
    batch."""
    import torch
    merged = torch.cat([r1, r2], 1)
    n = merged.shape[1]
    if points > n:
        raise ValueError(f"cannot keep {points} of {n} points")
    idx = torch.randperm(n, generator=generator,
                         device=generator.device)[:points]
    return merged[:, idx.to(merged.device)]


def evaluate(model, loader, generator, device, limit=None):
    """Run ``model`` (eval mode) over ``loader``'s batches, at most
    ``limit`` of them.  The noise and the merge draw from ``generator``.
    -> {class id: {"f": [...], "p": [...], "r": [...], "seconds": [...]}},
    one entry per image; ``seconds`` is its batch's wall time over the
    batch's images."""
    import torch

    from cloud_transformers_tpu_torch.core.noise import sphere_noise
    from cloud_transformers_tpu_torch.losses import f_score

    model.eval()
    per_class = defaultdict(lambda: {"f": [], "p": [], "r": [],
                                     "seconds": []})
    for i, batch in enumerate(loader):
        if limit and i >= limit:
            break
        t0 = time.perf_counter()
        image = torch.as_tensor(batch["image"]).to(device)
        gt = torch.as_tensor(batch["pcd"]).to(device)
        b = image.shape[0]
        with torch.no_grad():
            r1, _ = model(sphere_noise(generator, b, N_HALF, device), image)
            r2, _ = model(sphere_noise(generator, b, N_HALF, device), image)
            merged = merge_passes(r1, r2, gt.shape[1], generator)
            f, p, r = (t.cpu().numpy() for t in
                       f_score(merged, gt, threshold=THRESHOLD))
        seconds = (time.perf_counter() - t0) / b
        for ib in range(b):
            m = per_class[int(batch["class_id"][ib])]
            m["f"].append(float(f[ib]))
            m["p"].append(float(p[ib]))
            m["r"].append(float(r[ib]))
            m["seconds"].append(seconds)
    return dict(per_class)


def format_table(per_class, class_names):
    """The result table: a line per class (name, images, mean F, precision
    and recall), then the mean F over every image."""
    lines = ["class\t#\tF\tprec\trecall"]
    for c, m in sorted(per_class.items()):
        name = class_names[c] if c < len(class_names) else str(c)
        lines.append(f"{name}\t{len(m['f'])}\t{np.mean(m['f']):.4f}"
                     f"\t{np.mean(m['p']):.4f}\t{np.mean(m['r']):.4f}")
    allf = [v for m in per_class.values() for v in m["f"]]
    lines.append(f"mean F: {np.mean(allf):.4f}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp_name")
    ap.add_argument("-c", "--config", default="configs/reconstruction.yaml")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="a port checkpoint or a reference .t7 (default: cfg "
                         "restore.generator)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--points", type=int, default=10000,
                    help="ground-truth points an image")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from cloud_transformers_tpu_torch.convert import load_weights
    from cloud_transformers_tpu_torch.data import DataLoader, ImageToPoint
    from cloud_transformers_tpu_torch.nn.init import init_model_
    from cloud_transformers_tpu_torch.nn.precision import strict_f32
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
        model_name,
    )

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
    model = model.to(device)

    ds = ImageToPoint(None if args.synthetic else d.get("path"),
                      split="test", im_size=d.get("im_size", 128),
                      points=args.points)
    loader = DataLoader(ds, d.get("batch_size_val", 4), shuffle=False,
                        drop_last=False)
    per_class = evaluate(model, loader,
                         torch.Generator(device).manual_seed(1), device,
                         limit=args.limit)
    print(format_table(per_class, ds.class_names))
    return per_class


if __name__ == "__main__":
    main()
