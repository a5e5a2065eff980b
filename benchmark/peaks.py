"""Published peaks of the cards the benchmark runs on (NVIDIA's H100 SXM
data sheet: dense rates, no sparsity, at the 700 W power limit)."""
from __future__ import annotations

H100 = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

PEAKS = {"NVIDIA H100 80GB HBM3": H100}


def peaks(kind: str) -> dict:
    """The peaks of a card by ``torch.cuda.get_device_name()``."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}")
    return PEAKS[kind]
