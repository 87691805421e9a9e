"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the card's own name and power
limit as ``nvidia-smi`` reads them."""
from __future__ import annotations

import subprocess
from typing import Optional

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def bound_ms(nbytes: int) -> float:
    """The least time ``nbytes`` of HBM traffic can take."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def power_limit() -> Optional[str]:
    """``name, power.limit`` of the first card, or None where nvidia-smi
    cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    line = out.stdout.strip().splitlines()
    return line[0] if out.returncode == 0 and line else None
