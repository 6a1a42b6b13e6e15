"""Python half of the R-bridge validation for the port
(r/validate_bridge_torch.R).

Runs the fixed 4-point validation grid through ``dpcorr_torch.rbridge``
(the same function the reticulate path calls) and writes the detail table
as ``detail_all.rds`` with the port's RDS writer. The R script readRDS()es
this file and diffs it against the frame it received through reticulate:
any marshalling defect (type coercion, row reordering, NA mangling) shows
up as a non-empty diff, because both sides are the identical computation
(vert-cor.R:534-554 seam).

tests/test_torch_rbridge.py runs this helper directly, so the Python half
is executed evidence where no R runtime is installed:

    python r/validate_bridge_torch_helper.py --out detail_all.rds --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: The validation grid (2 n × 2 ρ × one ε pair) and rep count, shared
#: verbatim with validate_bridge_torch.R.
ROWS = [{"n": 400, "rho": 0.2, "eps1": 1.0, "eps2": 1.0},
        {"n": 400, "rho": 0.6, "eps1": 1.0, "eps2": 1.0},
        {"n": 800, "rho": 0.2, "eps1": 1.0, "eps2": 1.0},
        {"n": 800, "rho": 0.6, "eps1": 1.0, "eps2": 1.0}]
B = 16
SEED = 2025


def run_validation_grid(backend: str = "bucketed", device=None) -> dict:
    from dpcorr_torch import rbridge

    return rbridge.run_design_rows(ROWS, b=B, seed=SEED, backend=backend,
                                   device=device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="detail_all.rds path")
    ap.add_argument("--backend", default="bucketed")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when not given")
    args = ap.parse_args()

    from dpcorr_torch.io.rds_write import write_rds_frame

    detail = run_validation_grid(args.backend, args.device)
    write_rds_frame(args.out, detail)
    print(f"wrote {args.out}: {len(detail['repl'])} rows x "
          f"{len(detail)} cols")


if __name__ == "__main__":
    main()
