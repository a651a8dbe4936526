"""The card's published peaks, and its power limit as ``nvidia-smi`` reads it.

NVIDIA's data sheet for the H100 SXM (80 GB HBM3): 3.35 TB/s of memory
bandwidth, at the full power limit of 700 W. A roofline share is stated
against the published peak, with the card's power limit beside it.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

#: bytes a second of the H100's HBM3
HBM_BYTES_PER_S = 3.35e12


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts, or None where ``nvidia-smi`` cannot
    say."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (subprocess.SubprocessError, ValueError, IndexError):
        return None
