"""Published peaks of the cards the benchmark knows, by a part of the
name that ``torch.cuda.get_device_name()`` gives.

H100 SXM (NVIDIA H100 data sheet, 700 W): 67 TFLOP/s fp32 outside the
tensor cores (the port keeps TF32 off) and 3.35 TB/s of HBM3."""

PEAKS = {
    "H100": {"fp32_per_s": 67e12, "bytes_per_s": 3.35e12},
}


def of(device_kind):
    """The peaks of a card, or None for a card not in the table."""
    for part, peak in PEAKS.items():
        if device_kind and part in device_kind:
            return peak
    return None
