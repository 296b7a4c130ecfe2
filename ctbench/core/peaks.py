"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM (NVIDIA's H100 data sheet; dense rates, at the full power
limit of 700 W): 67 TFLOP/s in float32 outside the tensor cores (the
configurations' precision: float32 with TF32 off), 3.35 TB/s of HBM3.
"""

PEAKS = {
    "H100": {"f32_flop_per_s": 67e12, "hbm_bytes_per_s": 3.35e12,
             "source": "NVIDIA H100 SXM data sheet"},
}


def of(kind):
    """The peaks of a device by its name (``torch.cuda.get_device_name``),
    or None for a device without a published entry here."""
    for key, peaks in PEAKS.items():
        if key in (kind or ""):
            return peaks
    return None
