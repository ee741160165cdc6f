#!/usr/bin/env python3
"""Where one tf32-tier measurement's device time goes, on the card.

Runs chip_smoke.py's phase 16 -- examples/tpu_production's tier split: the
fused float32 engine samples 16 walkers and every measurement rebuilds G
from the fields at tf32 (#8 in every fold) -- and profiles one tier
measurement of the 16 walkers (torch.profiler, device activity only):
device busy, idle share and the kernels that take the most time, printed
as phase 16 prints them.  The profile's ~1.3 million device operations
take minutes to aggregate, which is why chip_smoke.py itself skips it.

    python3 scripts/tier_profile.py

To compare kernel versions, run it from two copies of the package in one
call.  Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import phase_tier_split, say  # noqa: E402


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    say(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    phase_tier_split(torch, profile=True)


if __name__ == "__main__":
    main()
