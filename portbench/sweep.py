"""The knee of an open-loop cell: one deployment, one window at each rate.

    python3 portbench/sweep.py --workload <open-loop cell> --seed 7 \\
        --seconds 5 --rates 2000 2700 3400

prints a JSON line per rate: the rate offered and completed in the window,
latency p50 and p99 from the due time, how late the generator ran (p99), and
the median latency of the window's last fifth against its first fifth (a
growing backlog reads well above 1). The knee is the highest rate whose
releases keep up with the offers and whose backlog does not grow.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reduce import percentile  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args()
    st = harness.prepare(a.workload, a.seed)
    print(json.dumps({"setup_s": time.perf_counter() - T_START}), flush=True)
    for rate in a.rates:
        seen = harness.drive(st, a.seed, a.seconds, False, rate=rate)
        lat = seen.lat
        fifth = max(1, len(lat) // 5)
        print(json.dumps({
            "rate": rate, "offered_per_s": seen.attempted / a.seconds,
            "completed_per_s": seen.completed / (seen.w1 - seen.w0),
            "failed": seen.failed,
            "p50_us": float(percentile(lat, 50)) * 1e6,
            "p99_us": float(percentile(lat, 99)) * 1e6,
            "late_p99_us": float(percentile(seen.late, 99)) * 1e6,
            "growth": float(np.median(lat[-fifth:]) / np.median(lat[:fifth])),
            "queue_wait_us": seen.stats["budget"]["queue_wait_us_mean"],
            "batches": seen.stats["batches"],
            "completed_all": seen.stats["completed"]}),
            flush=True)
        st.svc.drain(timeout=60)
    st.svc.close()


if __name__ == "__main__":
    main()
