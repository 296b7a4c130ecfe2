"""Plain reference of the S3DIS segmenter of the KPConv protocol and its
masked loss.

The network of the program's ``s3dis_segmenter_pad``: a 7 -> ``model_dim``
stem with bias on the points and their 4 features, BatchNorm (over every
point, padded ones too) and ReLU; the MHCT trunk (``reference/mhct.py``)
with the keys from the points and the padding mask (a padded point splats
zeros and reads zeros back); a bias-free 1x1, BatchNorm, ReLU and the
per-point class logits.

Loss: the cross-entropy summed over the valid points over their count.
"""

import torch
import torch.nn.functional as F

from ctbench.reference.mhct import STAGE_PLAN


def forward(net, points, mask, features, model):
    """-> per-point logits [B, P, C]."""
    x = torch.cat([points, features], -1)
    x = F.relu(net.bn("stem_bn", net.linear("stem", x)))
    x = net.trunk("trunk", x, points, model.get("repeats", 4), mask,
                  plan=model.get("stage_plan", STAGE_PLAN))
    x = F.relu(net.bn("final_bn", net.linear("final_conv1", x)))
    return net.linear("final_conv2", x)


def loss(net, batch, model, train):
    """The masked cross-entropy on a batch of tensors (``points``,
    ``mask``, ``features``, ``label``)."""
    mask = batch["mask"]
    logits = forward(net, batch["points"], mask, batch["features"], model)
    per_pt = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             batch["label"].reshape(-1).long(),
                             reduction="none").reshape(mask.shape)
    return (per_pt * mask).sum() / mask.sum().clamp(min=1.0)
