"""The shares that the per-layer metrics of several layers read."""

from ctbench.core import peaks
from ctbench.counts.mhct import DEVICE_GROUPS, least_seconds


def mfu(run):
    """The window's model FLOPs over its seconds and the f32 peak of the
    cards it ran on, in %."""
    p = peaks.of(run.get("device_kind"))
    w = run.get("window") or {}
    if p is None or not run.get("flops") or not w.get("seconds"):
        return None
    return 100.0 * run["flops"] / w["seconds"] / (
        p["f32_flop_per_s"] * run.get("chips", 1))


def kernels_roofline(run):
    """The least time of the hand-written kernels' launches in the profiled
    stretch over their device time there, in %."""
    p = peaks.of(run.get("device_kind"))
    prof = run.get("profile")
    if p is None or not prof or not prof.get("kernel_rows"):
        return None
    least = sum(least_seconds(prof["kernel_rows"], p["f32_flop_per_s"],
                              p["hbm_bytes_per_s"]).values())
    kinds = {g for g, _, _ in prof["kernel_rows"]}
    spent = sum(prof["groups"].get(dg, 0.0) for g in kinds
                for dg in DEVICE_GROUPS[g])
    return 100.0 * least / spent if spent > 0 else None


def idle(run):
    """The profiled stretch's share with no operation on the device, in
    %."""
    prof = run.get("profile")
    if not prof or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
