"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA's H100 data sheet (SXM part, at its full power limit of 700 W):
3.35 TB/s of HBM3 bandwidth and 67 TFLOP/s in float32 outside the tensor
cores (the port keeps TF32 off). A share of a peak is stated against these,
with the card's power limit printed beside it.
"""

from __future__ import annotations

H100_SXM = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks(kind: str):
    """The peaks of the card named ``kind``, or None for another device."""
    return PEAKS.get(kind)
