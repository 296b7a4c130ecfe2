"""The benchmark's weights: made on the device from the seed, in a few
large draws from one ``torch.Generator``, in float32 (the type they are
trained in).

Every convolution or linear weight (a parameter named ``weight`` of two or
more axes) is U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = the product of
its axes after the first, and the ``bias`` beside it the same; every frame
rotation ``log_R`` is N(0, 1).  The rest (BatchNorm scales and biases,
frame shifts and scales, running statistics) keeps its value as built,
which is the model's definition.  The same seed gives the same weights on
every device of one kind.
"""

import torch


def fill_(model, seed, device):
    """Draw the weights of ``model`` (on ``device``) from ``seed`` in place.
    -> (weights, buffers): copies of every parameter and buffer, as the
    reference takes them."""
    params = dict(model.named_parameters())
    uniform, normal = [], []
    for name, p in params.items():
        stem, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if leaf == "weight" and p.dim() >= 2:
            uniform.append((p, p[0].numel() ** -0.5))
            bias = params.get(f"{stem}.bias" if stem else "bias")
            if bias is not None:
                uniform.append((bias, p[0].numel() ** -0.5))
        elif leaf == "log_R":
            normal.append(p)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    with torch.no_grad():
        u = torch.rand(sum(p.numel() for p, _ in uniform), generator=gen,
                       device=device)
        i = 0
        for p, bound in uniform:
            n = p.numel()
            p.copy_(((2 * u[i:i + n] - 1) * bound).view_as(p))
            i += n
        z = torch.randn(sum(p.numel() for p in normal), generator=gen,
                        device=device)
        i = 0
        for p in normal:
            p.copy_(z[i:i + p.numel()].view_as(p))
            i += p.numel()
    weights = {k: v.detach().clone() for k, v in params.items()}
    buffers = {k: v.detach().clone() for k, v in model.named_buffers()}
    return weights, buffers
