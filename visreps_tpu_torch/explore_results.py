"""Results dashboard CLI over results.db (port of
``visreps_tpu/explore_results.py``), in ``sqlite3`` and plain Python.

Each query returns a list of row dicts (where the JAX package returns a
DataFrame) or a dict; ``main`` prints an aligned table. The database is
``--db``, else the port's ``core/db.RESULTS_DB_PATH``
(``$VISREPS_RESULTS_DB``, else ./results.db).

Usage:
  python -m visreps_tpu_torch.explore_results summary
  python -m visreps_tpu_torch.explore_results completeness --neural-dataset nsd --analysis rsa
  python -m visreps_tpu_torch.explore_results sql "SELECT ... "
"""
from __future__ import annotations

import argparse
import sqlite3
from contextlib import closing
from pathlib import Path

from visreps_tpu_torch.core import db

_NSD_REGIONS = ["early visual stream", "ventral visual stream",
                "V1", "V2", "V3", "hV4", "FFA", "PPA"]
# Expected anatomy per dataset (the reference's explore_results.py:51-62)
EXPECTED_ANATOMY = {
    "nsd": {"subjects": [str(i) for i in range(8)], "regions": _NSD_REGIONS,
            "seeds": [1, 2, 3]},
    "nsd_synthetic": {"subjects": [str(i) for i in range(8)], "regions": _NSD_REGIONS,
                      "seeds": [1, 2, 3]},
    "tvsd": {"subjects": ["0", "1"], "regions": ["V1", "V4", "IT"], "seeds": [1, 2, 3]},
    "things-behavior": {"subjects": ["N/A"], "regions": ["N/A"], "seeds": [1, 2, 3]},
}


def _path(db_path=None) -> Path:
    return Path(db_path) if db_path else db.RESULTS_DB_PATH


def _connect(db_path=None) -> sqlite3.Connection:
    path = _path(db_path)
    if not path.exists():
        raise FileNotFoundError(f"No results DB at {path}")
    return sqlite3.connect(str(path))


def _rows(query: str, params=(), db_path=None) -> list[dict]:
    """The query's rows as {column: value} dicts."""
    with closing(_connect(db_path)) as conn:
        cur = conn.execute(query, params)
        cols = [c[0] for c in cur.description or ()]
        return [dict(zip(cols, r)) for r in cur.fetchall()]


def summary(db_path=None) -> list[dict]:
    return _rows("""SELECT neural_dataset, analysis, compare_method,
                           COUNT(*) AS rows, COUNT(DISTINCT run_id) AS runs,
                           MIN(score) AS min_score, MAX(score) AS max_score
                    FROM results
                    GROUP BY neural_dataset, analysis, compare_method""", db_path=db_path)


def completeness(neural_dataset: str, analysis: str = "rsa", db_path=None) -> list[dict]:
    """Subjects × regions × seeds presence matrix vs expected anatomy."""
    anatomy = EXPECTED_ANATOMY[neural_dataset]
    have = {(r["subject_idx"], r["region"], r["seed"]) for r in _rows(
        "SELECT DISTINCT subject_idx, region, seed FROM results "
        "WHERE neural_dataset=? AND analysis=?", (neural_dataset, analysis), db_path)}
    rows = []
    for region in anatomy["regions"]:
        for subj in anatomy["subjects"]:
            row = {"region": region, "subject": subj}
            for seed in anatomy["seeds"]:
                row[f"seed{seed}"] = "x" if (subj, region, seed) in have else "."
            rows.append(row)
    total = len(anatomy["regions"]) * len(anatomy["subjects"]) * len(anatomy["seeds"])
    print(f"{neural_dataset}/{analysis}: {len(have)}/{total} (subject, region, seed) cells present")
    return rows


def db_info(db_path=None) -> dict:
    """File size, date range, per-table row counts."""
    path = _path(db_path)
    with closing(_connect(db_path)) as conn:
        info = {"file": str(path), "size_mb": path.stat().st_size / 1e6}
        lo, hi = conn.execute("SELECT MIN(created_at), MAX(created_at) FROM run_configs").fetchone()
        info["date_range"] = (lo, hi)
        names = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        info["tables"] = {t: conn.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
                          for t in names}
    print(f"  File: {info['file']}  ({info['size_mb']:.1f} MB)")
    print(f"  Date range: {lo} → {hi}")
    for t, n in info["tables"].items():
        print(f"  {t:30s} {n:>8,} rows")
    return info


def distinct_values(db_path=None) -> dict:
    """Distinct values of every filterable column."""
    out = {}
    with closing(_connect(db_path)) as conn:
        for col in ("neural_dataset", "analysis", "compare_method", "region",
                    "cfg_id", "seed", "pca_labels_folder", "model_name"):
            out[col] = [str(r[0]) for r in conn.execute(
                f"SELECT DISTINCT {col} FROM results ORDER BY {col}")]
            print(f"  {col:25s} {', '.join(out[col])}")
    return out


def health(db_path=None) -> dict:
    """Cross-table consistency: orphaned results (no run_configs row),
    runs without bootstrap distributions or layer-selection scores, NULL
    scores."""
    def count(query: str) -> int:
        return conn.execute(query).fetchone()[0]

    with closing(_connect(db_path)) as conn:
        checks = {
            "orphaned_results": count(
                """SELECT COUNT(DISTINCT r.run_id) FROM results r
                   LEFT JOIN run_configs rc ON r.run_id = rc.run_id
                   WHERE rc.run_id IS NULL"""),
            "total_runs": count("SELECT COUNT(DISTINCT run_id) FROM results"),
            "runs_without_bootstrap": count(
                """SELECT COUNT(DISTINCT r.run_id) FROM results r
                   LEFT JOIN bootstrap_distributions bd
                     ON r.run_id = bd.run_id AND r.compare_method = bd.compare_method
                   WHERE bd.run_id IS NULL"""),
            "runs_without_layer_selection": count(
                """SELECT COUNT(DISTINCT r.run_id) FROM results r
                   LEFT JOIN (SELECT DISTINCT run_id FROM layer_selection_scores) ls
                     ON r.run_id = ls.run_id
                   WHERE ls.run_id IS NULL"""),
            "null_scores": count("SELECT COUNT(*) FROM results WHERE score IS NULL"),
        }
    for name in ("orphaned_results", "null_scores"):
        status = "OK" if checks[name] == 0 else f"WARN: {checks[name]}"
        print(f"  {name:30s} {status}")
    for name in ("runs_without_bootstrap", "runs_without_layer_selection"):
        print(f"  {name:30s} {checks['total_runs'] - checks[name]}/{checks['total_runs']} covered")
    return checks


def recent(n: int = 10, db_path=None) -> list[dict]:
    """The last ``n`` saved runs with their identity columns."""
    return _rows("""SELECT rc.created_at, r.neural_dataset, r.analysis,
                           r.pca_labels_folder, r.cfg_id, r.seed, r.region, r.subject_idx
                    FROM run_configs rc JOIN results r ON rc.run_id = r.run_id
                    ORDER BY rc.created_at DESC LIMIT ?""", (n,), db_path)


def run_sql(query: str, db_path=None) -> list[dict]:
    return _rows(query, db_path=db_path)


def format_table(rows: list[dict]) -> str:
    """Rows as a table: a header of the columns, each column as wide as
    its widest cell, numbers right-aligned."""
    if not rows:
        return "(no rows)"
    cols = list(rows[0])
    cells = [[str(r[c]) for c in cols] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells)) for i, c in enumerate(cols)]
    numeric = [all(isinstance(r[c], (int, float)) for r in rows) for c in cols]

    def line(vals):
        return "  ".join(v.rjust(w) if num else v.ljust(w)
                         for v, w, num in zip(vals, widths, numeric)).rstrip()

    return "\n".join([line(cols), *(line(row) for row in cells)])


def main(argv=None):
    parser = argparse.ArgumentParser(description="Explore results.db")
    parser.add_argument("command", choices=[
        "summary", "completeness", "sql", "info", "distinct", "health", "recent", "all"])
    parser.add_argument("query", nargs="?", default=None)
    parser.add_argument("--neural-dataset", default="nsd")
    parser.add_argument("--analysis", default="rsa")
    parser.add_argument("--recent-n", type=int, default=10)
    parser.add_argument("--db", default=None)
    args = parser.parse_args(argv)

    if args.command == "summary":
        print(format_table(summary(args.db)))
    elif args.command == "completeness":
        print(format_table(completeness(args.neural_dataset, args.analysis, args.db)))
    elif args.command == "info":
        db_info(args.db)
    elif args.command == "distinct":
        distinct_values(args.db)
    elif args.command == "health":
        health(args.db)
    elif args.command == "recent":
        print(format_table(recent(args.recent_n, args.db)))
    elif args.command == "all":
        print("== DATABASE INFO ==")
        db_info(args.db)
        print("\n== DISTINCT VALUES ==")
        distinct_values(args.db)
        print("\n== SUMMARY ==")
        print(format_table(summary(args.db)))
        print("\n== HEALTH ==")
        health(args.db)
        print(f"\n== RECENT ({args.recent_n}) ==")
        print(format_table(recent(args.recent_n, args.db)))
    else:
        if not args.query:
            raise SystemExit("sql command requires a query argument")
        print(format_table(run_sql(args.query, args.db)))


if __name__ == "__main__":
    main()
