"""SQLite results store (copy of ``visreps_tpu/core/db.py``).

Same 4 tables, UNIQUE constraints, INSERT OR REPLACE semantics and
SHA256[:12] run_id over the same 15 identity fields, so ``plotters/``
read rows written by either package.
"""
from __future__ import annotations

import hashlib
import json
import os
import sqlite3
from pathlib import Path

from visreps_tpu_torch.core.logging import rprint

RESULTS_DB_PATH = Path(os.environ.get("VISREPS_RESULTS_DB", "results.db"))

IDENTITY_FIELDS = (
    "seed", "epoch", "region", "subject_idx", "neural_dataset", "cfg_id",
    "pca_labels", "pca_n_classes", "pca_labels_folder", "checkpoint_dir",
    "analysis", "compare_method", "reconstruct_from_pcs", "pca_k", "model_name",
)


def compute_run_id(cfg) -> str:
    """Deterministic hash of the experiment identity fields."""
    identity = {f: cfg.get(f) for f in IDENTITY_FIELDS}
    identity["subject_idx"] = str(identity.get("subject_idx"))
    raw = json.dumps(identity, sort_keys=True)
    return hashlib.sha256(raw.encode()).hexdigest()[:12]


def init_db(db_path: Path | str | None = None) -> sqlite3.Connection:
    db_path = Path(db_path) if db_path is not None else RESULTS_DB_PATH
    db_path.parent.mkdir(parents=True, exist_ok=True)
    conn = sqlite3.connect(str(db_path), timeout=10)
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA busy_timeout=10000")
    conn.execute("""
        CREATE TABLE IF NOT EXISTS results (
            run_id              TEXT NOT NULL,
            compare_method      TEXT NOT NULL,
            layer               TEXT NOT NULL,
            score               REAL,
            ci_low              REAL,
            ci_high             REAL,
            analysis            TEXT NOT NULL,
            seed                INTEGER NOT NULL,
            epoch               INTEGER NOT NULL,
            region              TEXT,
            subject_idx         TEXT,
            neural_dataset      TEXT NOT NULL,
            cfg_id              INTEGER,
            pca_labels          BOOLEAN NOT NULL,
            pca_n_classes       INTEGER,
            pca_labels_folder   TEXT,
            model_name          TEXT NOT NULL,
            checkpoint_dir      TEXT,
            reconstruct_from_pcs BOOLEAN DEFAULT 0,
            pca_k               INTEGER DEFAULT 1,
            UNIQUE(run_id, compare_method, layer)
        )
    """)
    conn.execute("""
        CREATE TABLE IF NOT EXISTS run_configs (
            run_id      TEXT PRIMARY KEY,
            config_json TEXT NOT NULL,
            created_at  TEXT DEFAULT (datetime('now'))
        )
    """)
    conn.execute("""
        CREATE TABLE IF NOT EXISTS layer_selection_scores (
            run_id          TEXT NOT NULL,
            compare_method  TEXT NOT NULL,
            layer           TEXT NOT NULL,
            score           REAL,
            UNIQUE(run_id, compare_method, layer)
        )
    """)
    conn.execute("""
        CREATE TABLE IF NOT EXISTS bootstrap_distributions (
            run_id          TEXT NOT NULL,
            compare_method  TEXT NOT NULL,
            scores          TEXT,
            UNIQUE(run_id, compare_method)
        )
    """)
    conn.commit()
    return conn


def _get_float(row: dict, col: str):
    val = row.get(col)
    if val is None:
        return None
    try:
        f = float(val)
    except (TypeError, ValueError):
        return None
    return None if f != f else f  # NaN guard


def save_results(rows, cfg, db_path: Path | str | None = None) -> str:
    """Persist result rows (list of dicts) in the long format: one row
    per (run_id, compare_method, layer), INSERT OR REPLACE."""
    run_id = compute_run_id(cfg)
    db_path = Path(db_path) if db_path is not None else RESULTS_DB_PATH
    conn = init_db(db_path)
    try:
        cfg_dict = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        conn.execute(
            "INSERT OR REPLACE INTO run_configs (run_id, config_json) VALUES (?, ?)",
            (run_id, json.dumps(cfg_dict)),
        )
        for row in rows:
            method = row.get("compare_method", cfg.get("compare_method", "spearman"))
            score = _get_float(row, "score")
            if score is None:
                continue
            conn.execute(
                """INSERT OR REPLACE INTO results
                   (run_id, compare_method, layer, score, ci_low, ci_high,
                    analysis, seed, epoch, region, subject_idx,
                    neural_dataset, cfg_id, pca_labels, pca_n_classes, pca_labels_folder,
                    model_name, checkpoint_dir, reconstruct_from_pcs, pca_k)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)""",
                (
                    run_id, method, row.get("layer"), score,
                    _get_float(row, "ci_low"), _get_float(row, "ci_high"),
                    row.get("analysis", cfg.get("analysis")),
                    int(cfg.get("seed")),
                    int(cfg.get("epoch", 0)),
                    cfg.get("region"),
                    str(cfg.get("subject_idx")),
                    cfg.get("neural_dataset"),
                    cfg.get("cfg_id"),
                    bool(cfg.get("pca_labels")),
                    cfg.get("pca_n_classes"),
                    cfg.get("pca_labels_folder"),
                    cfg.get("model_name"),
                    cfg.get("checkpoint_dir"),
                    bool(cfg.get("reconstruct_from_pcs", False)),
                    cfg.get("pca_k", 1),
                ),
            )
            for entry in row.get("layer_selection_scores") or []:
                conn.execute(
                    """INSERT OR REPLACE INTO layer_selection_scores
                       (run_id, compare_method, layer, score) VALUES (?, ?, ?, ?)""",
                    (run_id, method, entry["layer"], float(entry["score"])),
                )
            bs = row.get("bootstrap_scores")
            if bs is not None:
                conn.execute(
                    """INSERT OR REPLACE INTO bootstrap_distributions
                       (run_id, compare_method, scores) VALUES (?, ?, ?)""",
                    (run_id, method, json.dumps(list(bs))),
                )
        conn.commit()
    finally:
        conn.close()
    rprint(f"Saved {len(rows)} results to {db_path} (run_id={run_id})", style="success")
    return str(db_path)
