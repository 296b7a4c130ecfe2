"""Host-side datasets and loading of the port (counterpart of
``cloud_transformers_tpu/data``); numpy only."""

from cloud_transformers_tpu_torch.data.completion import ShapeNetCompletion
from cloud_transformers_tpu_torch.data.image_point import ImageToPoint
from cloud_transformers_tpu_torch.data.loader import DataLoader, item_rng
from cloud_transformers_tpu_torch.data.s3dis import Indoor3DSemSeg
from cloud_transformers_tpu_torch.data.s3dis_kpconv import S3DISSeg
from cloud_transformers_tpu_torch.data.scanobjectnn import ScanObjectNN

__all__ = ["DataLoader", "ImageToPoint", "Indoor3DSemSeg", "S3DISSeg",
           "ScanObjectNN", "ShapeNetCompletion", "item_rng"]
