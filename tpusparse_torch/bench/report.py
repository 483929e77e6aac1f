"""Evidence-grid reporter (counterpart of ``tpusparse/bench/report.py``):
the suite's and the zoo's JSON lines as the markdown tables of PERF.md.

The reference's ``obtain_result.py`` (lines 1-85) walks raw per-run
artifacts and prints the best row per workload; here the PERF.md sweep and
zoo tables are regenerated from the port's BENCH_SUITE.jsonl and
BENCH_ZOO.jsonl (under the config cache_dir by default), so a committed
table is a mechanical function of the rows.

For every (bench, K) cell the latest row wins (rows are append-only; a
re-run supersedes).  A cell reads ``raw/norm`` where the row has a twin
normalized to the probe's window (``gflops_norm``), and is starred when
the row is newer than ``fresh_after``.  A third table lists what was not
ok: rows refused or raising, and each tune's failed candidates.

Run: python -m tpusparse_torch.bench.report [--suite PATH] [--zoo PATH]
[--fresh-after TS]
"""

from __future__ import annotations

import json
import os

SWEEP_WORKLOADS = ("powerlaw", "uniform", "banded")
SWEEP_KS = (8, 32, 128)
ZOO_KS = (8, 64)


def _default(name: str) -> str:
    from tpusparse_torch.config import get_config

    return os.path.join(get_config().cache_dir, name)


def latest_rows(path, keyfn):
    """Latest row per key; keyfn returns None to skip a row."""
    out = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                k = keyfn(r)
                if k is None:
                    continue
                if k not in out or r.get("ts", 0) >= out[k].get("ts", 0):
                    out[k] = r
    except FileNotFoundError:
        pass
    return out


def _cell(r, fresh_after, value_key="gflops"):
    if not r:
        return "—"
    star = "*" if r.get("ts", 0) >= fresh_after else ""
    v = r.get(value_key)
    if v is None:
        return "—"
    n = r.get(value_key + "_norm")
    return f"{v:.1f}{'/' + format(n, '.1f') if n is not None else ''}{star}"


def sweep_table(path=None, fresh_after=float("inf")):
    """The SuiteSparse-class sweep table (PERF.md)."""
    rows = latest_rows(path or _default("BENCH_SUITE.jsonl"),
                       lambda r: (r["bench"].split("/", 1)[1], r.get("k"))
                       if r.get("bench", "").startswith("suite/") else None)
    lines = ["| workload | K=8 | K=32 | K=128 | winner (8/32/128) | vs cuSPARSE | pct_roofline |",
             "|---|---|---|---|---|---|---|"]
    for w in SWEEP_WORKLOADS:
        cells, winners, vsc, pr = [], [], [], []
        for k in SWEEP_KS:
            r = rows.get((w, k))
            cells.append(_cell(r, fresh_after))
            if r:
                winners.append(str(r.get("schedule", "?")).replace("_span", ""))
                if r.get("vs_cusparse") is not None:
                    vsc.append(r["vs_cusparse"])
                if r.get("pct_roofline") is not None:
                    pr.append(r["pct_roofline"])
        vs = f"{min(vsc):.2f}–{max(vsc):.2f}x" if vsc else "—"
        roof = f"{min(pr):.1f}–{max(pr):.1f}%" if pr else "—"
        lines.append(f"| {w} | {cells[0]} | {cells[1]} | {cells[2]} | "
                     f"{'/'.join(winners)} | {vs} | {roof} |")
    return "\n".join(lines)


def zoo_table(path=None, fresh_after=float("inf")):
    """The robustness-grid table (PERF.md)."""
    rows = latest_rows(path or _default("BENCH_ZOO.jsonl"),
                       lambda r: (r["case"], r.get("k")) if r.get("case") else None)
    cases = sorted({c for (c, _k) in rows})
    lines = ["| case | K=8 | K=64 | winner (8 / 64) |", "|---|---|---|---|"]
    for c in cases:
        cell, win = [], []
        for k in ZOO_KS:
            r = rows.get((c, k))
            cell.append(_cell(r, fresh_after))
            win.append(str(r.get("schedule", "?")).replace("_span", "") if r else "—")
        lines.append(f"| {c} | {cell[0]} | {cell[1]} | {win[0]} / {win[1]} |")
    return "\n".join(lines)


def not_ok_table(suite_path=None, zoo_path=None):
    """Every row that did not give a result, and every candidate of a tune
    that was not ok, from the latest row of each (bench or case, K): its
    kind (``refused`` by a gate or guard, ``oracle`` miss, ``precondition``
    of a packer, or the row's ``rejected`` or ``error``) and its message."""
    lines = ["| file | bench / case | K | family | kind | error |", "|---|---|---|---|---|---|"]
    for label, path, key in (("suite", suite_path or _default("BENCH_SUITE.jsonl"), "bench"),
                             ("zoo", zoo_path or _default("BENCH_ZOO.jsonl"), "case")):
        rows = latest_rows(path, lambda r, key=key: (r[key], r.get("k")) if r.get(key) else None)
        for (name, k), r in sorted(rows.items(), key=lambda kv: (kv[0][0], kv[0][1] or 0)):
            bad = [(c.get("family"), c.get("kind"), c.get("error")) for c in r.get("not_ok", ())]
            bad += [(r.get("schedule"), f, r[f]) for f in ("rejected", "error") if r.get(f)]
            for fam, kind, err in bad:
                lines.append(f"| {label} | {name} | {k if k is not None else '—'} | "
                             f"{fam or '—'} | {kind} | {str(err).replace('|', '/')} |")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m tpusparse_torch.bench.report")
    ap.add_argument("--suite", default=None, help="the suite's JSON lines")
    ap.add_argument("--zoo", default=None, help="the zoo's JSON lines")
    ap.add_argument("--fresh-after", type=float, default=float("inf"))
    args = ap.parse_args(argv)
    print("## SuiteSparse-class sweep (latest rows; cell = raw/normalized GF/s, * = fresh)")
    print(sweep_table(args.suite, fresh_after=args.fresh_after))
    print()
    print("## Robustness grid (latest rows)")
    print(zoo_table(args.zoo, fresh_after=args.fresh_after))
    print()
    print("## Rows and tune candidates that were not ok (latest rows)")
    print(not_ok_table(args.suite, args.zoo))


if __name__ == "__main__":
    main()
