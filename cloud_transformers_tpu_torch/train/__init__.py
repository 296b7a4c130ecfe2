"""Training harness of the port (counterpart of
``cloud_transformers_tpu/train``): config, optimizer and trainer."""
