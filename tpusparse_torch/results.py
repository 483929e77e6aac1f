"""Tuning-results aggregator (counterpart of ``tpusparse/results.py``;
reference: obtain_result.py).

Reads one or more results.jsonl files written by ``tune``, groups the rows
by (matrix signature, K) and prints the best measurement per group with its
schedule.

Run: python -m tpusparse_torch.results [results.jsonl ...]
     (defaults to <cache_dir>/results.jsonl)
"""

from __future__ import annotations

import json
import os
import sys

from tpusparse_torch.config import get_config


def aggregate(paths=None):
    """({(matrix, k): best row}, rows scanned) over the ``ok`` rows that
    carry ``gflops``; unreadable lines are skipped."""
    if not paths:
        paths = [os.path.join(get_config().cache_dir, "results.jsonl")]
    best: dict[tuple, dict] = {}
    n_rows = 0
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                n_rows += 1
                if not row.get("ok") or "gflops" not in row:
                    continue
                key = (row.get("matrix", "?"), row.get("k", 0))
                if key not in best or row["gflops"] > best[key]["gflops"]:
                    best[key] = row
    return best, n_rows


def main(argv=None):
    best, n_rows = aggregate(argv if argv else None)
    if not best:
        print(f"no successful measurements found ({n_rows} rows scanned)")
        return
    print(f"{n_rows} measurements, {len(best)} (matrix, K) groups; best per group:")
    for (sig, k), row in sorted(best.items()):
        sched = row.get("schedule", {})
        fam = sched.get("family", "?") if isinstance(sched, dict) else sched
        print(f"  {sig} K={k}: {row['gflops']:.2f} GFLOP/s "
              f"({row['seconds']*1e3:.3f} ms, {fam}, pad={row.get('padding_rate', 0):.2f}"
              f", {row.get('device', '?')})")


if __name__ == "__main__":
    main(sys.argv[1:])
