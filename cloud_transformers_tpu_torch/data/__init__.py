"""Host-side datasets and loading of the port (counterpart of
``cloud_transformers_tpu/data``); numpy only."""

from cloud_transformers_tpu_torch.data.loader import DataLoader, item_rng
from cloud_transformers_tpu_torch.data.scanobjectnn import ScanObjectNN

__all__ = ["DataLoader", "ScanObjectNN", "item_rng"]
