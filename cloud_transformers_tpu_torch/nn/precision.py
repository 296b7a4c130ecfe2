"""Numeric policy of the port: float32 everywhere.

Counterpart of ``cloud_transformers_tpu/nn/precision.py``.  The JAX
package's ``MXUDense``/``MXUConv`` are plain ``nn.Linear``/``nn.Conv{2,3}d``
here; its optional bf16 operand policy is not ported yet.  On the card
PyTorch runs float32 convolutions in TF32 unless told otherwise, which keeps
only about three decimal digits, so ``strict_f32`` turns TF32 off for both
matmuls and cuDNN convolutions.
"""

import torch


def strict_f32():
    """Run float32 matmuls and convolutions in full float32 (no TF32).
    Sets PyTorch's process-wide backend flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
