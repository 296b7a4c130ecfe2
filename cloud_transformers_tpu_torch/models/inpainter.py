"""ShapeNet completion ("inpainter") model.

Counterpart of ``cloud_transformers_tpu/models/inpainter.py``: an encoder
that is the classifier backbone ending in a ``latent_width`` vector, a
mapping to the latent ``z``, and an AdaIN-conditioned decoder of
``decoder_repeats`` stages of the 3-union stage plan over a labeled
sphere-noise cloud ``[B, P, 4]`` (xyz + is-a-real-point label), its keys
driven by the noise xyz.  The decoder's stages are a ``ModuleList`` where
the JAX package scans them.  ``remat_policy`` is the JAX key: there the
decoder is always rematerialized under it and the encoder under
``"point_io"``.  The port's default, ``"off"``, keeps every activation
(``nn/remat.py``); any JAX name turns remat on as in JAX.  Module names
follow the JAX parameter tree so that ``convert.py`` maps it.

Under a points axis (``parallel/mesh.py``) the encoder's points and the
decoder's noise points are split over the points ranks; the pooled latent
``z``, its mapping and the AdaINs' scales and biases are the data row's,
alike on its points ranks (the encoder's ``class_head_bn`` is marked
replicated), and every AdaIN's instance norm takes each cloud's
statistics over the points group (``nn/norm.py``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.models import register
from cloud_transformers_tpu_torch.models.classifier import (
    DEFAULT_STAGE_PLAN,
    ClassifierBackbone,
)
from cloud_transformers_tpu_torch.nn.multihead_adain import (
    MultiHeadUnionAdaIn,
)
from cloud_transformers_tpu_torch.nn import remat as rm
from cloud_transformers_tpu_torch.nn.norm import AdaIn1d, BatchNorm
from cloud_transformers_tpu_torch.nn.precision import MXULinear
from cloud_transformers_tpu_torch.parallel.constrain import mark_replicated


class CompletionEncoder(nn.Module):
    """Backbone -> Linear(pooled, latent_width) + BN + ReLU."""

    def __init__(self, model_dim=512, latent_width=1024, repeats=4,
                 stage_plan=DEFAULT_STAGE_PLAN, pool_heads=16,
                 pool_feature_dims=(32, 16), pool_sizes=(8, 16),
                 trunk_width=64, remat=False):
        super().__init__()
        self.backbone = ClassifierBackbone(
            model_dim, repeats, stage_plan, pool_heads, pool_feature_dims,
            pool_sizes, trunk_width, remat=remat)
        self.class_head = MXULinear(2 * trunk_width * pool_heads,
                                    latent_width)
        self.class_head_bn = BatchNorm(latent_width)
        mark_replicated(self.class_head_bn)

    def forward(self, pcd):
        _, pooled, stats = self.backbone(pcd)
        return self.class_head_bn(self.class_head(pooled), relu=True), stats


class AdaInStage(nn.Module):
    """One repeat of the stage plan: ``union_0 .. union_{n-1}``."""

    remat = None   # "full": the stage is one checkpointed region

    def __init__(self, model_dim, latent_dim, stage_plan):
        super().__init__()
        self.n = len(stage_plan)
        for i, (f, h, s, d) in enumerate(stage_plan):
            self.add_module(f"union_{i}", MultiHeadUnionAdaIn(
                model_dim, latent_dim, features_dims=f, tensor_sizes=s,
                tensor_dims=d, heads=h, model_dim_out=model_dim))

    def forward(self, x, z, keys_xyz):
        return rm.region(self.remat == "full", self._forward, x, z,
                         keys_xyz)

    def _forward(self, x, z, keys_xyz):
        stats = []
        for i in range(self.n):
            x, s = getattr(self, f"union_{i}")(x, z, keys_xyz)
            stats += s
        return x, stats


class AdaInDecoder(nn.Module):
    """``repeats`` AdaIN stages; ``rm.set_policy(decoder, name)`` puts
    them under a remat policy."""

    def __init__(self, model_dim, latent_dim, repeats, stage_plan):
        super().__init__()
        self.stages = nn.ModuleList(
            AdaInStage(model_dim, latent_dim, stage_plan)
            for _ in range(repeats))

    def forward(self, x, z, keys_xyz):
        stats = []
        for stage in self.stages:
            x, s = stage(x, z, keys_xyz)
            stats += s
        return x, stats


@register("completion_inpainter")
class Inpainter(nn.Module):
    """(noise [B, P, 4], partial [B, Pin, 3]) -> (reconstruction [B, P, 3],
    stats: a list of per-head-group dicts of scalars, encoder first)."""

    def __init__(self, num_latent=512, model_dim=512, latent_width=1024,
                 encoder_repeats=4, decoder_repeats=4,
                 stage_plan=DEFAULT_STAGE_PLAN, pool_heads=16,
                 pool_feature_dims=(32, 16), pool_sizes=(8, 16),
                 trunk_width=64, remat_policy=rm.OFF):
        super().__init__()
        on = rm.policy(remat_policy) is not None
        self.encoder = CompletionEncoder(
            model_dim, latent_width, encoder_repeats, stage_plan, pool_heads,
            pool_feature_dims, pool_sizes, trunk_width, remat=on)
        self.mapping = MXULinear(latent_width, num_latent)
        self.start_conv = MXULinear(4, model_dim, bias=False)
        self.start_adain = AdaIn1d(num_latent, model_dim)
        self.decoder = AdaInDecoder(model_dim, num_latent, decoder_repeats,
                                    stage_plan)
        rm.set_policy(self.decoder, remat_policy)
        # the final head takes the noise channels once more
        self.final_conv1 = MXULinear(model_dim + 4, model_dim, bias=False)
        self.final_adain = AdaIn1d(num_latent, model_dim)
        self.final_conv2 = MXULinear(model_dim, 3)

    def forward(self, noise, partial):
        z, enc_stats = self.encoder(partial)
        z = F.relu(self.mapping(z))
        x = F.relu(self.start_adain(self.start_conv(noise), z))
        x, dec_stats = self.decoder(x, z, noise[..., :3])
        x = self.final_conv1(torch.cat([x, noise], -1))
        x = F.relu(self.final_adain(x, z))
        return self.final_conv2(x), enc_stats + dec_stats
