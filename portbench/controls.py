"""The lower-precision control of a cell: the plain reference put in the
program's place, computed one precision below the configuration's (int4 for
the int8 CaloClusterNet), on the cell's pool, judged as the program's answers
are.

    python3 portbench/controls.py --workload ccn_upgrade.batch4096 \\
        --seeds 11 12 13

prints a JSON line per seed with the compared numbers and the seconds the
reference took. The benchmark's runs do not run it; a limit has to lie below
what it reads.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from portbench import catalog  # noqa: E402


def control_numbers(name: str, seed: int, device="cuda",
                    here=catalog.HERE) -> dict:
    cell = catalog.workloads(here)[name]
    cfg = catalog.configs(here)[cell["config"]]
    model = catalog.adapter(cfg["model"]).Model(cfg, seed, device)
    pool = model.pool(cell["pool"] * cell.get("batch", 1), seed)
    t = time.perf_counter()
    want = model.reference(pool)
    ref_s = time.perf_counter() - t
    got = model.control(pool)
    n = len(next(iter(want.values())))
    return dict(model.numbers(got, want, np.ones(n)), reference_s=ref_s)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args()
    for seed in a.seeds:
        print(json.dumps({"workload": a.workload, "seed": seed,
                          **control_numbers(a.workload, seed)}), flush=True)


if __name__ == "__main__":
    main()
