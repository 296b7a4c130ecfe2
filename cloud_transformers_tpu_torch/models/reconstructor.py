"""Single-view image -> point cloud reconstructor.

Counterpart of ``cloud_transformers_tpu/models/reconstructor.py``: a
ResNet-50 trunk pooled to 2048 features, a mapping to the latent ``z``
(with a ReLU), and the completion model's AdaIN decoder (4 stages of
``DEFAULT_STAGE_PLAN``, 24 head groups) over a sphere-noise cloud
``[B, P, 3]`` whose xyz also drive the decoder's keys; a final 1x1 conv,
AdaIN and a 1x1 conv to xyz, squashed into [0, 1] by a sigmoid.  Unlike the
inpainter's, the noise carries no label channel and the final head does not
see it again.  ``remat_policy`` puts the decoder's stages under a remat
policy, as the JAX package always does; the port's default ``"off"``
keeps every activation (``nn/remat.py``).  Module names follow the JAX
parameter tree so that ``convert.py`` maps it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.models import register
from cloud_transformers_tpu_torch.models.classifier import DEFAULT_STAGE_PLAN
from cloud_transformers_tpu_torch.models.inpainter import AdaInDecoder
from cloud_transformers_tpu_torch.nn import remat as rm
from cloud_transformers_tpu_torch.nn.norm import AdaIn1d
from cloud_transformers_tpu_torch.nn.precision import MXULinear
from cloud_transformers_tpu_torch.nn.resnet import ResNet50Features


@register("image_reconstructor")
class Reconstructor(nn.Module):
    """(noise [B, P, 3], image [B, H, W, 3]) -> (reconstruction [B, P, 3]
    in [0, 1], stats: a list of per-head-group dicts of scalars)."""

    def __init__(self, num_latent=512, model_dim=512, remat_policy=rm.OFF):
        super().__init__()
        self.res50 = ResNet50Features()
        self.mapping = MXULinear(2048, num_latent)
        self.start_conv = MXULinear(3, model_dim, bias=False)
        self.start_adain = AdaIn1d(num_latent, model_dim)
        self.decoder = AdaInDecoder(model_dim, num_latent, 4,
                                    DEFAULT_STAGE_PLAN)
        rm.set_policy(self.decoder, remat_policy)
        self.final_conv1 = MXULinear(model_dim, model_dim, bias=False)
        self.final_adain = AdaIn1d(num_latent, model_dim)
        self.final_conv2 = MXULinear(model_dim, 3)

    def forward(self, noise, image):
        z = F.relu(self.mapping(self.res50(image)))
        x = F.relu(self.start_adain(self.start_conv(noise), z))
        x, stats = self.decoder(x, z, noise)
        x = F.relu(self.final_adain(self.final_conv1(x), z))
        return torch.sigmoid(self.final_conv2(x)), stats
