"""PyTorch + CUDA port of cloud_transformers_tpu for one NVIDIA H100.

Mirrors the JAX package's module names.  This slice serves the ScanObjectNN
classifier (``models.get_model("scanobject_classifier")``,
``serve.InferenceEngine``); its splat, slice and 3D grid-conv kernels are
hand-written CUDA under ``csrc/``, built on first use (``ops/cuda_build.py``).
"""
