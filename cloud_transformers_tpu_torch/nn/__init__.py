"""nn of the PyTorch port: the MHCT blocks, norms, frames, grouped convs,
the V2V and UNet blocks and the operand policy (see the package
docstring)."""

from cloud_transformers_tpu_torch.nn.conv_blocks import (
    Basic2DBlock,
    Basic3DBlock,
    Pool3DBlock,
    Res2DBlock,
    Res3DBlock,
    Upsample3DBlock,
    V2VModel,
)
from cloud_transformers_tpu_torch.nn.grouped_conv import GroupedConv
from cloud_transformers_tpu_torch.nn.multihead import (
    MultiHead,
    MultiHeadPool,
    MultiHeadUnion,
)
from cloud_transformers_tpu_torch.nn.multihead_adain import (
    MultiHeadAdaIn,
    MultiHeadUnionAdaIn,
)
from cloud_transformers_tpu_torch.nn.norm import AdaIn1d, instance_norm_1d
from cloud_transformers_tpu_torch.nn.transforms import (
    PlaneTransformer,
    VolTransformer,
)
from cloud_transformers_tpu_torch.nn.unet2d import (
    DoubleConv,
    Down,
    GroupCat,
    OutConv,
    UNet,
    Up,
)

__all__ = [
    "AdaIn1d",
    "instance_norm_1d",
    "VolTransformer",
    "PlaneTransformer",
    "MultiHead",
    "MultiHeadUnion",
    "MultiHeadPool",
    "MultiHeadAdaIn",
    "MultiHeadUnionAdaIn",
    "GroupedConv",
    "Basic2DBlock",
    "Basic3DBlock",
    "Res2DBlock",
    "Res3DBlock",
    "Pool3DBlock",
    "Upsample3DBlock",
    "V2VModel",
    "DoubleConv",
    "Down",
    "Up",
    "OutConv",
    "GroupCat",
    "UNet",
]
