"""End-to-end A/B of the Vanka time-solve kernel on the GPU.

Runs bench.py's heat section (16^3, Q4 x dG(2), 32 steps per slab) in one
process with the Triton time-solve kernel off and on, in the order
off, on, on, off, and prints each run's solve time, DoF/s and iteration
count beside the card's name and power limit.

    python scripts/timesolve_ab.py [--slabs 3]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slabs", type=int, default=3)
    args = ap.parse_args(argv)

    import bench
    from stfem_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()
    rows = []
    for kernel in ("0", "1", "1", "0"):
        os.environ["STFEM_PALLAS_TIMESOLVE"] = kernel
        r = bench.run_sections(["heat"],
                               sizes={"heat": {"n_slabs": args.slabs}})[0]
        rows.append(dict(kernel=kernel == "1", solve_s=r["solve_s"],
                         dofs_per_s=r["dofs_per_s"],
                         avg_iters=r["avg_iters"],
                         true_rel=r["true_rel_residual"], gpu=r["gpu"]))
        print(json.dumps(rows[-1]), flush=True)
    for kernel in (True, False):
        sel = [r for r in rows if r["kernel"] == kernel]
        print(f"# kernel={kernel}: solve_s "
              f"{[r['solve_s'] for r in sel]}, DoF/s "
              f"{[r['dofs_per_s'] for r in sel]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
