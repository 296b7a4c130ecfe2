"""Tiny versions of the cells for the CPU tests: the published widths of
the pools and heads cut down, one union of a 2D and a 3D head group, a
batch of 2 of 128 points, and a run of one second on the CPU."""

import argparse

from ctbench import run as R

TINY_MODEL = dict(model_dim=32, repeats=1,
                  stage_plan=[[[4, 4], [2, 2], [16, 16], [2, 3]]])
# the classifier's pools, Res trunks and heads cut down too
TINY_CLASSIFIER = dict(pool_heads=2, pool_feature_dims=[4, 4],
                       trunk_width=4, class_dim=16, mask_dim=8)
TINY_TRAFFIC = dict(batch=2, points=128, loader_workers=2, warmup_steps=1,
                    profile_steps=1)
SEED = 2 ** 33 + 5   # wider than 32 bits, as the driver's seeds are


def cell(name):
    """(bench, cell, config, traffic, data) of the cell, cut to tiny."""
    bench, c, config, traffic, data = R.load_cell(name)
    extra = TINY_CLASSIFIER if config["family"] == "classifier" else {}
    config = dict(config, model=dict(config["model"], **TINY_MODEL,
                                     **extra))
    traffic = dict(traffic, **{k: v for k, v in TINY_TRAFFIC.items()
                               if k in traffic})
    return bench, c, config, traffic, data


def execute(name, trace=0, seconds=1.0, seed=SEED):
    """One run of the tiny cell on the CPU, past the look for a card."""
    bench, c, config, traffic, data = cell(name)
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds,
                              trace=trace)
    return R.execute(args, bench, c, config, traffic, data, "cpu", "cpu")


def context(name, seed=SEED):
    bench, c, config, traffic, data = cell(name)
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.0,
                              trace=0)
    return R.Context(args, c, config, traffic, data, "cpu")
