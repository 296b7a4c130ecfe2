"""Utilities of the port (counterpart of ``cloud_transformers_tpu/utils``)."""
