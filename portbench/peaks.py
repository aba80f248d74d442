"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates), by a part of the name that ``torch.cuda`` reports.
Each rate assumes the card's full power limit of 700 W."""

from typing import Optional

PEAKS = {
    "H100": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peaks(device_name: str) -> Optional[dict]:
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None
