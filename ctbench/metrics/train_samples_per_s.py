"""Samples (clouds or spheres) of the steps completed in the
window over the window's seconds; the window ends at a synchronize after
its last step."""


def read(run):
    w = run.get("window") or {}
    return w["samples"] / w["seconds"] if w.get("samples") else None
