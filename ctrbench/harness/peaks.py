"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
H100 SXM, dense, at the 700 W limit). A card not in the table has no peak,
and the roofline and utilization readers then report nothing."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16_flops": 989e12, "float32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str) -> dict | None:
    return PEAKS.get(device_name)
