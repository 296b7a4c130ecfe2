"""Plain reference of the Multi-Headed Cloud Transformer trunk.

Plain PyTorch in float32, written from the model's definition (Cloud
Transformers, arXiv:2007.11679; the reference code's ``MultiHeadUnion``)
and from the parameter names of the program's state dict, which the
benchmark fills with weights of its own.  It imports nothing of the
program.  Every contraction goes through ``Ops``, which either computes in
float32 (TF32 off) or, for the control, rounds each operand of the forward
and of the backward contractions to TF32 (``tf32=True``).

Per head group: a bias-free 1x1 projection to per-head key offsets
(``3 H``) and values (``F H``); a BatchNorm on each; keys = the point plus
its offset, rotated by the head's SO(3) frame ``R^T (p + shift)`` (2D
groups keep x, y), tanh; the keys clipped to +-(1 - 1e-7), moved to grid
units ``(k + 1) (size - 1) / 2`` with the gradient of the unscaled keys;
the values, weighted by each of the 2^dim cell vertices' multilinear
weights, scatter-maxed into a zero grid; a grouped 3^dim 'same'
convolution with bias; the grid read back at the points by the same
weights; BatchNorm and ReLU.  A union concatenates its groups, projects
them bias-free, BatchNorms, ReLUs and adds the input.  A padded point
(``mask`` 0) puts zero values into the splat and reads zeros back.
"""

import math

import torch
import torch.nn.functional as F

KEY_EPS = 1e-7          # the keys' clip below 1
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
SO3_EPS = 1e-4          # the rotation angle's floor in Rodrigues' formula

# the stage plan of the published model: per union, (features, heads,
# grid sizes, grid dims) of its 2D and 3D head groups
STAGE_PLAN = (
    ((4, 4), (16, 16), (128, 32), (2, 3)),
    ((16, 16), (16, 16), (64, 16), (2, 3)),
    ((16, 32), (16, 16), (16, 8), (2, 3)),
)


def tf32_round(x):
    """``x`` (float32) with its mantissa rounded to TF32's 10 bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _TF32(torch.autograd.Function):
    """``fn(a, b)`` of two operands rounded to TF32, and in the backward the
    cotangent rounded to TF32 before it meets them.  Only ``a`` and ``b``
    are kept (autograd holds them already); the rounded copies are made
    again in the backward, so that the control fits where the reference
    does."""

    @staticmethod
    def forward(ctx, fn, a, b):
        ctx.fn = fn
        ctx.save_for_backward(a, b)
        return fn(tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with torch.enable_grad():
            ar = tf32_round(a.detach()).requires_grad_(True)
            br = tf32_round(b.detach()).requires_grad_(True)
            y = ctx.fn(ar, br)
        ga, gb = torch.autograd.grad(y, (ar, br), tf32_round(g))
        return None, ga, gb


class _Balance(torch.autograd.Function):
    """Forward ``x * scale``; backward the gradient of ``x`` unscaled."""

    @staticmethod
    def forward(ctx, x, scale):
        return x * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def _weighted(w, vals):
    """Every vertex's weighted values: [B, H, P*V, F]."""
    b, h, p, v = w.shape
    return (w[..., None] * vals[:, :, :, None, :]).reshape(b, h, p * v, -1)


def _index(idx, f):
    b, h, p, v = idx.shape
    return idx.reshape(b, h, p * v, 1).expand(-1, -1, -1, f)


class _SplatMax(torch.autograd.Function):
    """The splat as PyTorch's ``scatter_reduce(..., "amax",
    include_self=True)`` into a zero grid defines it, gradient included
    (a cell's cotangent split evenly among the values, the grid's zero
    among them, that equal its maximum), keeping only the grid and the
    point-sized inputs for the backward: the [B, H, P*V, F] products are
    made again there, so that a reference step fits on the card."""

    @staticmethod
    def forward(ctx, w, vals, idx, cells):
        b, h, _, f = vals.shape
        grid = torch.zeros(b, h, cells, f, dtype=vals.dtype,
                           device=vals.device)
        grid.scatter_reduce_(2, _index(idx, f), _weighted(w, vals), "amax",
                             include_self=True)
        ctx.save_for_backward(w, vals, idx, grid)
        return grid

    @staticmethod
    def backward(ctx, g):
        w, vals, idx, grid = ctx.saved_tensors
        f = vals.shape[-1]
        index = _index(idx, f)
        won = (_weighted(w, vals) == grid.gather(2, index)).to(g.dtype)
        ties = (grid == 0).to(g.dtype).scatter_add_(2, index, won)
        share = won * (g / ties).gather(2, index)
        share = share.reshape(w.shape + (f,))
        return ((share * vals[:, :, :, None, :]).sum(-1),
                (share * w[..., None]).sum(3), None, None)


class _Slice(torch.autograd.Function):
    """The slice as ``gather`` and a weighted sum define it, keeping only
    the grid and the point-sized inputs for the backward."""

    @staticmethod
    def forward(ctx, grid, w, idx):
        f = grid.shape[-1]
        got = grid.gather(2, _index(idx, f)).reshape(w.shape + (f,))
        ctx.save_for_backward(grid, w, idx)
        return (got * w[..., None]).sum(3)

    @staticmethod
    def backward(ctx, g):
        grid, w, idx = ctx.saved_tensors
        f = grid.shape[-1]
        index = _index(idx, f)
        d_grid = torch.zeros_like(grid).scatter_add_(2, index,
                                                     _weighted(w, g))
        got = grid.gather(2, index).reshape(w.shape + (f,))
        return d_grid, (got * g[:, :, :, None, :]).sum(-1), None


class Ops:
    """The contractions of the reference, in float32 or, with ``tf32``,
    with TF32 operands (the control)."""

    def __init__(self, tf32=False):
        self.tf32 = tf32

    def _contract(self, fn, a, b):
        return fn(a, b) if not self.tf32 else _TF32.apply(fn, a, b)

    def linear(self, x, w, b=None):
        y = self._contract(F.linear, x, w)
        return y if b is None else y + b

    def conv(self, x, w, b=None, padding=0, groups=1):
        conv = F.conv2d if x.dim() == 4 else F.conv3d
        y = self._contract(
            lambda u, v: conv(u, v, None, padding=padding, groups=groups),
            x, w)
        return y if b is None else y + b.view((1, -1) + (1,) * (x.dim() - 2))

    def einsum(self, eq, a, b):
        return self._contract(lambda u, v: torch.einsum(eq, u, v), a, b)


class Net:
    """The parameters (``params``: name -> leaf tensor) and running
    statistics (``buffers``: name -> tensor, updated in place in training)
    of one model, under the program's state-dict names."""

    def __init__(self, params, buffers, ops, training=True):
        self.p, self.b, self.ops, self.training = params, buffers, ops, \
            training

    # --- layers ------------------------------------------------------------
    def bn(self, name, x, dim=-1):
        """BatchNorm over every axis but ``dim``: batch statistics (biased
        variance) in training, which also move the running mean and the
        unbiased running variance by 0.1; the running ones in eval."""
        shape = [1] * x.dim()
        shape[dim] = -1
        if self.training:
            axes = [a for a in range(x.dim()) if a != dim % x.dim()]
            mean = x.mean(axes)
            var = (x - mean.view(shape)).square().mean(axes)
            n = x.numel() // x.shape[dim]
            with torch.no_grad():
                self.b[name + ".mean"].lerp_(mean, BN_MOMENTUM)
                self.b[name + ".var"].lerp_(var * (n / max(n - 1, 1)),
                                            BN_MOMENTUM)
        else:
            mean, var = self.b[name + ".mean"], self.b[name + ".var"]
        inv = torch.rsqrt(var + BN_EPS) * self.p[name + ".scale"]
        return (x - mean.view(shape)) * inv.view(shape) \
            + self.p[name + ".bias"].view(shape)

    def linear(self, name, x):
        return self.ops.linear(x, self.p[name + ".weight"],
                               self.p.get(name + ".bias"))

    def conv(self, name, x, padding, groups):
        return self.ops.conv(x, self.p[name + ".weight"],
                             self.p.get(name + ".bias"), padding, groups)

    # --- the head group ----------------------------------------------------
    def frame(self, name, pcd, dims):
        """``R^T (pcd + shift)`` per head, R = exp(hat(log_R)); [B, P, H, 3]
        -> [B, P, H, dims]."""
        log_r, shift = self.p[name + ".log_R"], self.p[name + ".shift"]
        theta_sq = (log_r * log_r).sum(-1)
        theta = torch.sqrt(torch.clamp(theta_sq, min=SO3_EPS * SO3_EPS))
        x, y, z = log_r.unbind(-1)
        zero = torch.zeros_like(x)
        k = torch.stack([torch.stack([zero, -z, y], -1),
                         torch.stack([z, zero, -x], -1),
                         torch.stack([-y, x, zero], -1)], -2)
        outer = log_r[:, :, None] * log_r[:, None, :]
        a = (torch.sin(theta) / theta)[:, None, None]
        c = ((1.0 - torch.cos(theta)) / (theta * theta))[:, None, None]
        eye = torch.eye(3, dtype=log_r.dtype, device=log_r.device)
        rot = (1.0 - c * (theta * theta)[:, None, None]) * eye + a * k \
            + c * outer
        out = self.ops.einsum("bphc,hcn->bphn", pcd + shift, rot)
        out = out[..., :dims]
        scales = self.p.get(name + ".scales")
        return out if scales is None else out * scales

    def keys_values(self, name, x, pcd, heads, feat, dims):
        """-> (lattice keys in [-1, 1] [B, P, H, dims], values [B, P, H*F])."""
        b, p, _ = x.shape
        kv = self.ops.linear(x, self.p[name + ".keys_values_pred.weight"])
        offsets = self.bn(name + ".key_bn", kv[..., :heads * 3])
        values = self.bn(name + ".values_bn", kv[..., heads * 3:])
        keys = pcd[:, :, None, :] + offsets.reshape(b, p, heads, 3)
        return torch.tanh(self.frame(name + ".transform", keys, dims)), values

    @staticmethod
    def vertices(keys, sizes):
        """Keys [B, P, H, dim] -> (flat cell index [B, H, P, V] int64,
        weights [B, H, P, V]) of the 2^dim cell vertices."""
        keys = torch.clamp(keys.transpose(1, 2), -1.0 + KEY_EPS,
                           1.0 - KEY_EPS)
        half = torch.tensor([(s - 1) * 0.5 for s in sizes], dtype=keys.dtype,
                            device=keys.device)
        scaled = _Balance.apply(keys + 1.0, half)
        base = torch.floor(scaled)
        frac = scaled - base
        base = base.long()
        idx, w = [], []
        for corner in range(2 ** len(sizes)):
            bits = [(corner >> (len(sizes) - 1 - a)) & 1
                    for a in range(len(sizes))]
            flat = torch.zeros_like(base[..., 0])
            weight = None
            for a, (s, bit) in enumerate(zip(sizes, bits)):
                flat = flat * s + base[..., a] + bit
                f = frac[..., a] if bit else 1 - frac[..., a]
                weight = f if weight is None else weight * f
            idx.append(flat)
            w.append(weight)
        return torch.stack(idx, -1), torch.stack(w, -1)

    @staticmethod
    def splat(idx, w, values, heads, cells, mask):
        """Scatter-max of the weighted values into a zero grid: values
        [B, P, H*F] -> grids [B, H, cells, F]."""
        b, p = values.shape[:2]
        if mask is not None:
            values = values * mask[:, :, None]
        vals = values.reshape(b, p, heads, -1).transpose(1, 2)
        return _SplatMax.apply(w, vals, idx, cells)

    @staticmethod
    def slice(idx, w, grid, mask):
        """The grids [B, H, cells, F] read at the points: -> [B, P, H*F]."""
        out = _Slice.apply(grid, w, idx)                  # [B, H, P, F]
        b, h, p, f = out.shape
        out = out.transpose(1, 2).reshape(b, p, h * f)
        return out if mask is None else out * mask[:, :, None]

    def grid_conv(self, name, grid, sizes):
        """The grouped 3^dim 'same' conv with bias on grids [B, H, cells, F]
        (weight [H*F, F, 3, 3(, 3)], groups = H)."""
        b, h, _, f = grid.shape
        x = grid.reshape((b, h) + tuple(sizes) + (f,)).movedim(-1, 2)
        x = x.reshape((b, h * f) + tuple(sizes))
        out = self.conv(name, x, 1, h)
        out = out.reshape((b, h, f) + tuple(sizes)).movedim(2, -1)
        return out.reshape(b, h, -1, f)

    def head(self, name, x, pcd, feat, heads, size, dims, mask):
        """One splat -> conv -> slice head group, before its BatchNorm."""
        sizes = (size,) * dims
        keys, values = self.keys_values(name + ".kv", x, pcd, heads, feat,
                                        dims)
        idx, w = self.vertices(keys, sizes)
        grid = self.splat(idx, w, values, heads, size ** dims, mask)
        grid = self.grid_conv(name + ".conv", grid, sizes)
        return self.slice(idx, w, grid, mask)

    def union(self, name, x, pcd, plan, mask):
        feats, heads, sizes, dims = plan
        outs = []
        for i, (f, h, s, d) in enumerate(zip(feats, heads, sizes, dims)):
            o = self.head(f"{name}.attention_{i}", x, pcd, f, h, s, d, mask)
            outs.append(F.relu(self.bn(f"{name}.attention_{i}.after_bn", o)))
        gathered = self.ops.linear(torch.cat(outs, -1),
                                   self.p[name + ".after_conv.weight"])
        return x + F.relu(self.bn(name + ".after_bn", gathered))

    def trunk(self, name, x, pcd, repeats, mask=None, plan=STAGE_PLAN):
        for r in range(repeats):
            for u, union_plan in enumerate(plan):
                x = self.union(f"{name}.stages.{r}.union_{u}", x, pcd,
                               union_plan, mask)
        return x

    def pool(self, name, x, pcd, feat, heads, size, dims):
        """A splat-only head group -> channels-first grids
        [B, H*F, *sizes]."""
        keys, values = self.keys_values(name + ".kv", x, pcd, heads, feat,
                                        dims)
        idx, w = self.vertices(keys, (size,) * dims)
        grid = self.splat(idx, w, values, heads, size ** dims, None)
        b = grid.shape[0]
        grid = grid.reshape((b, heads) + (size,) * dims + (feat,))
        grid = grid.movedim(-1, 2)
        return grid.reshape((b, heads * feat) + (size,) * dims)

    def res_block(self, name, x, groups):
        res = F.relu(self.bn(name + ".bn1", self.conv(name + ".conv1", x, 1,
                                                      groups), 1))
        res = self.bn(name + ".bn2", self.conv(name + ".conv2", res, 1,
                                               groups), 1)
        if name + ".skip_conv.weight" in self.p:
            x = self.bn(name + ".skip_bn",
                        self.conv(name + ".skip_conv", x, 0, groups), 1)
        return F.relu(res + x)

    def res_trunk(self, name, x, groups, blocks=3):
        """Res blocks with a 2x max pool between them, then the mean over
        the grid."""
        pool = F.max_pool2d if x.dim() == 4 else F.max_pool3d
        for i in range(blocks):
            if i:
                x = pool(x, 2)
            x = self.res_block(f"{name}.{i}", x, groups)
        return x.flatten(2).mean(-1)


def median(values):
    """The median of a list of floats."""
    s = sorted(values)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2]) if n else math.nan
