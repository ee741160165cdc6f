#!/usr/bin/env python3
"""End-to-end rates of the submatrix scheme on the card, for one checkout.

Drives the PyTorch port of a checkout (``--root``, by default this one)
through its entry points, with ``chip_smoke.py``'s configurations:

- the stretch configuration (32x32, beta=16, nt=320, n_stab=5, W=4,
  float32) with ``site_update = submatrix`` (#5), one sweep pair through
  ``run_simulation``;
- the headline (16x16, beta=8, nt=160, n_stab=5, W=16, float32) on the
  fused engine with ``fused_update = submatrix`` (#2c) and, beside it,
  with the default delayed scheme: a warm-up pair, three timed pairs, one
  profiled pair;
- examples/basic on the fused engine with ``fused_update = submatrix``
  (phase 13's cut: n_stab = 2, 20 + 4x20 pairs).

To compare two commits on one card, unpack the other one with
``git archive`` into a directory that ``.gitignore`` lists and run both in
one call, in turns::

    python3 scripts/submatrix_rates.py --root old   # the parent
    python3 scripts/submatrix_rates.py              # this checkout
    python3 scripts/submatrix_rates.py
    python3 scripts/submatrix_rates.py --root old

Each prints chip_smoke.py's lines for its cells (walker-sweep-pairs/s over
the timed pairs, device busy time and idle share of the profiled pair),
prefixed with the checkout it ran.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="the checkout whose dqmc_tpu_torch to drive")
    opts = ap.parse_args()
    root = opts.root.resolve()
    if not (root / "dqmc_tpu_torch").is_dir():
        sys.exit(f"{root}: no dqmc_tpu_torch/ there")
    # the driven package first; this checkout's chip_smoke.py (loaded by
    # path: the other checkout has its own) for the cells
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from dqmc_tpu_torch import _cuda
    if Path(_cuda.__file__).resolve().parents[1] != root:
        sys.exit(f"dqmc_tpu_torch came from {_cuda.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _cuda.lib()
    tag = f"[{root.name}]"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip()
    cs.say(f"{tag} {card}")
    cs.run_params(torch, cs.STRETCH + "[simulation]\nsite_update = "
                  "submatrix\n", "stretch, site_update = submatrix (#5), 0 + "
                  "1 pairs", ("cgs2_qr",), f"{tag} stretch")
    cs.headline_pairs(torch, card, f"{tag} headline", "submatrix")
    cs.headline_pairs(torch, card, f"{tag} headline", "delayed")
    text = (REPO / "examples" / "basic" / "parameters.in").read_text()
    cs.run_params(
        torch, text + "[simulation]\nengine = fused\nfused_update = "
        "submatrix\nn_therms = 20\nn_bins = 4\nn_sweeps = 20\nn_stab = 2\n"
        "dtype = float32\n", "examples/basic, fused_update = submatrix (#2c)",
        ("cgs2_qr", "fused_wrap", "fused_sites_sub"), f"{tag} basic")


if __name__ == "__main__":
    main()
