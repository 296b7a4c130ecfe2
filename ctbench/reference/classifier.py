"""Plain reference of the ScanObjectNN classifier and its loss.

The network of the program's ``scanobject_classifier`` (the reference
code's ``classifier.py``): a bias-free 3 -> ``model_dim`` stem with
BatchNorm and ReLU, the MHCT trunk (``reference/mhct.py``), two splat-only
pools (16 heads: 8^3 x 32 and 16^2 x 16) into grouped Res3D/Res2D trunks
(3 blocks each, 2x max pools between, the mean over the grid), the
2048 -> 1024 class vector with BatchNorm and ReLU, the class head, and the
per-point mask head on the point features and the class vector.  The three
dropouts draw, in this order, on the class vector, on the mask head's
input and on its hidden layer, from PyTorch's generator as it stands.

Loss: (1 - seg_weight) CE(class) + seg_weight BCE(per-point mask logits).
"""

import torch
import torch.nn.functional as F

from ctbench.reference.mhct import STAGE_PLAN


def forward(net, pcd, model):
    """pcd [B, P, 3] -> (class logits [B, C], mask logits [B, P])."""
    p = model.get("dropout", 0.5) if net.training else 0.0

    def dropout(x):
        return F.dropout(x, p, net.training)
    heads = model.get("pool_heads", 16)
    f3, f2 = model.get("pool_feature_dims", (32, 16))
    s3, s2 = model.get("pool_sizes", (8, 16))
    x = F.relu(net.bn("backbone.stem_bn", net.linear("backbone.stem", pcd)))
    x = net.trunk("backbone.trunk", x, pcd, model.get("repeats", 4),
                  plan=model.get("stage_plan", STAGE_PLAN))
    to_3d = net.pool("backbone.pool3d", x, pcd, f3, heads, s3, 3)
    to_2d = net.pool("backbone.pool2d", x, pcd, f2, heads, s2, 2)
    pooled = torch.cat([net.res_trunk("backbone.res2d", to_2d, heads),
                        net.res_trunk("backbone.res3d", to_3d, heads)], -1)
    class_vect = F.relu(net.bn("class_vector_bn",
                               net.linear("class_vector", pooled)))
    class_pred = net.linear("class_head", dropout(class_vect))
    b, n, _ = x.shape
    mh = torch.cat([x, class_vect[:, None, :].expand(b, n, -1)], -1)
    mh = net.bn("mask_bn", net.linear("mask_conv1", dropout(mh)))
    mask_pred = net.linear("mask_conv2", dropout(F.relu(mh)))
    return class_pred, mask_pred[..., 0]


def loss(net, batch, model, train):
    """The task's loss on a batch of tensors (``pcd``, ``label``,
    ``mask``)."""
    class_pred, mask_pred = forward(net, batch["pcd"], model)
    w = float(train.get("seg_weight", 0.5))
    return (1.0 - w) * F.cross_entropy(class_pred, batch["label"].long()) \
        + w * F.binary_cross_entropy_with_logits(mask_pred, batch["mask"])

