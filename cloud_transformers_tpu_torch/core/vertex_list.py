"""Splat and Slice on vertex lists: the JAX package's core API on
``grid_positions``' (weights, flat indices).

Counterpart of ``splat_max``, ``slice_grid`` and ``splat_conv_slice`` of
``cloud_transformers_tpu/core/splat_slice.py``.  The JAX package runs these
on its sorted segment reduction, outside any Pallas kernel, so the port runs
them on PyTorch's scatter and gather; the models use the mapping forms and
their kernels (``core/splat_slice.py``).  They live in a module of their
own because ``core.splat_slice.splat_max`` is the kernel wrapper that the
autograd Functions there call.

Layouts:
  weights   [B, P, H, S]   bi/trilinear vertex weights (S = 2**dim)
  flat_idx  [B, P, H, S]   flat cell-vertex indices in [0, G)
  values    [B, P, H*F]    point features, channel c = h*F + f
  grid      [B, H, G, F]   flat grids, cells in row-major (x, y[, z]) order

The splat is a scatter-max into a zero grid, so purely negative
contributions clamp to 0; its gradient goes, for each (cell, feature), to
the single lowest-indexed contribution that equals the cell's maximum where
that maximum is above 0 (exact ties included).  A point's vertices lie in
distinct cells, so the lowest contribution is the lowest point.  The
slice's gradient is PyTorch's own: a scatter-add of the cotangents into the
grid, and a product with the gathered rows into the weights.
"""

import torch


def _gather_rows(grid, idx):
    """grid [R, G, F], idx [R, K] -> [R, K, F]."""
    return torch.gather(grid, 1, idx[..., None].expand(-1, -1,
                                                       grid.shape[-1]))


class _SplatCore(torch.autograd.Function):
    """pre [R, K, F], idx [R, K] -> grid [R, G, F]: per-cell max of the
    contributions and 0."""

    @staticmethod
    def forward(ctx, pre, idx, grid_cells):
        r, _, f = pre.shape
        grid = pre.new_zeros((r, grid_cells, f)).scatter_reduce_(
            1, idx[..., None].expand_as(pre), pre, "amax")
        ctx.save_for_backward(pre, idx, grid)
        return grid

    @staticmethod
    def backward(ctx, g):
        pre, idx, grid = ctx.saved_tensors
        winning = _gather_rows(grid, idx)
        win = (pre == winning) & (winning > 0)
        # the lowest winning contribution of each (cell, feature)
        k = pre.shape[1]
        kidx = torch.arange(k, device=pre.device)[None, :, None]
        score = torch.where(win, kidx, k)
        first = torch.full_like(grid, k, dtype=torch.int64).scatter_reduce_(
            1, idx[..., None].expand_as(score), score, "amin")
        win = win & (kidx == _gather_rows(first, idx))
        return torch.where(win, _gather_rows(g, idx), 0.0), None, None


def _rows(flat_idx):
    """[B, P, H, S] -> per-(b, h) rows [B*H, P*S]."""
    b, p, h, s = flat_idx.shape
    return flat_idx.transpose(1, 2).reshape(b * h, p * s).long()


def splat_max(weights, flat_idx, values, heads, grid_cells, pts_mask=None):
    """Rasterize ``values [B, P, H*F]`` into per-head flat grids by
    scatter-max of the weight-modulated features: -> grid [B, H, G, F].
    ``pts_mask [B, P]`` (0: a padded point) zeroes a point's features."""
    b, p, h, s = weights.shape
    if h != heads:
        raise ValueError(f"weights hold {h} heads, not {heads}")
    f = values.shape[-1] // heads
    values = values.reshape(b, p, h, f)
    if pts_mask is not None:
        values = values * pts_mask[:, :, None, None].to(values.dtype)
    pre = weights[..., None] * values[:, :, :, None, :]   # [B, P, H, S, F]
    pre = pre.transpose(1, 2).reshape(b * h, p * s, f)
    grid = _SplatCore.apply(pre, _rows(flat_idx), grid_cells)
    return grid.reshape(b, h, grid_cells, f)


def slice_grid(weights, flat_idx, grid, heads, pts_mask=None):
    """Gather ``grid [B, H, G, F]`` at each point's cell vertices and sum
    them by weight: -> [B, P, H*F].  ``pts_mask [B, P]`` zeroes a padded
    point's output."""
    b, p, h, s = weights.shape
    if h != heads:
        raise ValueError(f"weights hold {h} heads, not {heads}")
    g, f = grid.shape[2], grid.shape[3]
    gathered = _gather_rows(grid.reshape(b * h, g, f), _rows(flat_idx))
    gathered = gathered.reshape(b, h, p, s, f).transpose(1, 2)
    sliced = (gathered * weights[..., None]).sum(3).reshape(b, p, h * f)
    if pts_mask is not None:
        sliced = sliced * pts_mask[:, :, None].to(sliced.dtype)
    return sliced


def splat_conv_slice(weights, flat_idx, values, heads, grid_cells,
                     conv_fn=None, pts_mask=None):
    """splat -> ``conv_fn`` on the grid [B, H, G, F] where given -> slice."""
    grid = splat_max(weights, flat_idx, values, heads, grid_cells, pts_mask)
    if conv_fn is not None:
        grid = conv_fn(grid)
    return slice_grid(weights, flat_idx, grid, heads, pts_mask)
