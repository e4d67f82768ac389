"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates at the full 700 W power limit).  The
program's MLP passes compute float32 on the tensor cores from TF32
terms, so the TF32 rate is their peak."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tf32_flop_per_s": 495e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str) -> dict | None:
    """The peaks of the card named `kind` (torch.cuda.get_device_name),
    or None for a card not in the table."""
    return PEAKS.get(kind)
