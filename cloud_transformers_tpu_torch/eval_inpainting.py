"""Evaluate ShapeNet completion: F-score@0.01 and Chamfer x 1000 per
category, and the protocol EMD with ``--emd``.

    python -m cloud_transformers_tpu_torch.eval_inpainting EXP_NAME \\
        -c configs/inpainting.yaml [--synthetic] [--ckpt FILE] [--limit N] \\
        [--emd] [--dump-dir DIR] [--device cpu]

The command line of the JAX package's ``eval_inpainting.py``.  GRNet's
metric protocol: the partial cloud goes through the model scaled by 2, the
reconstruction is halved and held against the raw ground truth; the EMD is
taken on the clouds scaled by 2 (eps ``val_emd_eps`` 0.004, up to
``val_emd_iters`` 3000 rounds).  The weights come from ``--ckpt`` or the
config's ``restore.generator``: a port checkpoint, or the reference's own
state dict (a ``.t7`` file) through ``convert.load_reference``.  Runs on
``cuda`` unless ``--device`` says otherwise.  ``evaluate`` is the loop
behind the command.
"""

import argparse
import os
import pickle
import time
from collections import defaultdict

import numpy as np


def evaluate(model, loader, generator, device, limit=None, emd=False,
             emd_eps=0.004, emd_iters=3000, dump_dir=None):
    """Run ``model`` (eval mode) over ``loader`` (batches of one cloud).
    -> {taxonomy: {"f": [...], "cd": [...], "emd": [...], "rounds": [...],
    "seconds": [...]}}, one entry per cloud."""
    import torch

    from cloud_transformers_tpu_torch.core.noise import partial_postprocess
    from cloud_transformers_tpu_torch.losses import (
        chamfer_distance,
        f_score_from_dists,
    )
    from cloud_transformers_tpu_torch.losses.emd import (
        emd_auction_with_rounds,
    )

    model.eval()
    per_cat = defaultdict(lambda: {"f": [], "cd": [], "emd": [],
                                   "rounds": [], "seconds": []})
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
    for i, batch in enumerate(loader):
        if limit and i >= limit:
            break
        t0 = time.perf_counter()
        gt = torch.as_tensor(batch["gt"]).to(device)
        partial = torch.as_tensor(batch["partial"]).to(device) * 2.0
        with torch.no_grad():
            parts, noise = partial_postprocess(generator, partial,
                                               gt.shape[1])
            recon = model(noise, parts)[0] / 2.0
            d1, d2, _, _ = chamfer_distance(recon, gt)
            f, _, _ = f_score_from_dists(d1, d2, threshold=0.01)
            cd = (d1.mean(-1) + d2.mean(-1)) * 1000.0
            m = per_cat[int(batch["taxonomy"][0])]
            m["f"].append(float(f[0]))
            m["cd"].append(float(cd[0]))
            if emd:
                dist, _, rounds = emd_auction_with_rounds(
                    recon * 2.0, gt * 2.0, eps=emd_eps, iters=emd_iters)
                m["emd"].append(float(torch.sqrt(dist + 1e-12).mean(-1)[0]))
                m["rounds"].append(rounds)
        m["seconds"].append(time.perf_counter() - t0)
        if dump_dir:
            with open(f"{dump_dir}/batch_{i:05d}.pkl", "wb") as fh:
                pickle.dump({
                    "noise": noise.cpu().numpy(),
                    "partial": np.asarray(batch["partial"]),
                    "recon": recon.cpu().numpy(),
                    "gt": np.asarray(batch["gt"]),
                    "taxonomy": int(batch["taxonomy"][0]),
                    "f_score": m["f"][-1], "cd": m["cd"][-1],
                    "emd": m["emd"][-1] if emd else None}, fh)
    return dict(per_cat)


def format_table(per_cat, emd=False):
    """The result table, one line per category and ``Overall`` last."""
    lines = ["Taxonomy\t#Sample\tF-Score\tChamferDistance"
             + ("\tEMD" if emd else "")]
    all_f, all_cd, all_emd = [], [], []
    for cat, m in sorted(per_cat.items()):
        row = (f"{cat}\t{len(m['f'])}\t{np.mean(m['f']):.4f}"
               f"\t{np.mean(m['cd']):.4f}")
        if emd:
            row += f"\t{np.mean(m['emd']):.4f}"
            all_emd += m["emd"]
        lines.append(row)
        all_f += m["f"]
        all_cd += m["cd"]
    last = f"Overall\t\t{np.mean(all_f):.4f}\t{np.mean(all_cd):.4f}"
    if emd:
        last += f"\t{np.mean(all_emd):.4f}"
    return "\n".join(lines + [last])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp_name")
    ap.add_argument("-c", "--config", default="configs/inpainting.yaml")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="a port checkpoint or a reference .t7 (default: cfg "
                         "restore.generator)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--emd", action="store_true",
                    help="also compute the protocol EMD (eps 0.004, up to "
                         "3000 rounds)")
    ap.add_argument("--dump-dir", default=None,
                    help="write a pickle per cloud of (noise, partial, "
                         "recon, gt, scores)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from cloud_transformers_tpu_torch.convert import load_weights
    from cloud_transformers_tpu_torch.data import (
        DataLoader,
        ShapeNetCompletion,
    )
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

    ds = ShapeNetCompletion(
        None if args.synthetic else d.get("category_path"),
        d.get("partial_path"), d.get("gt_path"), split="test",
        n_input=d.get("input_size", 2048), n_output=d.get("gt_size", 16384))
    loader = DataLoader(ds, 1, shuffle=False, drop_last=False)
    per_cat = evaluate(
        model, loader, torch.Generator(device).manual_seed(1),
        device, limit=args.limit, emd=args.emd,
        emd_eps=float(cfg["train"].get("val_emd_eps", 0.004)),
        emd_iters=int(cfg["train"].get("val_emd_iters", 3000)),
        dump_dir=args.dump_dir)
    print(format_table(per_cat, args.emd))
    return per_cat


if __name__ == "__main__":
    main()
