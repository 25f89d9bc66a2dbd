"""Shared data and drawing helpers of the paper's figure scripts (port of
``experiments/neurips_2025/figutils.py``), without pandas or seaborn.

The JAX package's figure scripts read their long results CSVs with
pandas and reshape them with its groupby, pivot and filters. The card's
machine has no pandas, so this module holds a small column table with
the same semantics, on the standard library and numpy:

  * ``read_csv`` / ``from_records`` type each column as pandas does: all
    integers → int64 (float64 with a blank), numbers → float64, True /
    False → bool (object with a blank), anything else → str; pandas'
    missing-value strings ("", "N/A", "NA", "None", "nan", …) are missing.
  * Comparisons, ``astype(str)``, ``astype(bool)``, ``isin`` and
    ``.str.lower()`` follow pandas 3 on those types (a str column equals
    no number; astype(str) keeps a missing value missing; a missing
    value is True as a bool).
  * Groupby keys are sorted, missing keys dropped (or last with
    ``dropna=False``). Numbers are read by Python's correctly rounded
    ``float`` and reduced by numpy (``nanmean``, ``nanstd``): pandas' C
    parser and its compensated group sums may differ in the last bits, so
    the series equal pandas' to about 1e-12 relative, with the same keys,
    order and missing values.

Also the port's copy of ``plotters/plotter_utils.py``'s
``split_and_select_df``, ``_avg_over`` and ``avg_over_seed``, the
condition data of the bar plots (``mean_per_seed``,
``assemble_conditions``), and the three drawing helpers
(``condition_barplot``, ``layer_comparison_plot``,
``reconstructed_rsa_plot``), which import matplotlib when called; the
blue and green palettes are the matplotlib colormap samples seaborn's
``color_palette(name, n)`` takes. ``draw_or_report`` runs a drawing
function where matplotlib imports and otherwise prints one line naming
the figure not drawn; ``write_series`` writes a figure's data as JSON.
"""
from __future__ import annotations

import csv
import json
import math
import os
import re
from pathlib import Path

import numpy as np

from visreps_tpu_torch.core.logging import rprint

UNTRAINED_C, THOUSAND_C, INITIAL_C = "#AAAAAA", "#FFA500", "#7f8c8d"
PCA_SIZES = [2, 4, 8, 16, 32, 64]

# pandas.read_csv's default missing-value strings
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"^\s*[+-]?\d+\s*$")


# ── the column table ────────────────────────────────────────────────

class Table:
    """Named columns of one length: int64, float64 or bool numpy arrays,
    or object arrays (str, or bool beside a missing value) whose missing
    values are None."""

    def __init__(self, columns: dict):
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        lengths = {len(v) for v in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of different lengths: {lengths}")

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __contains__(self, name) -> bool:
        return name in self.columns

    def __getitem__(self, name) -> np.ndarray:
        return self.columns[name]

    @property
    def empty(self) -> bool:
        return len(self) == 0 or not self.columns

    def take(self, rows) -> "Table":
        """The rows a boolean mask or an index array selects, in order."""
        rows = np.asarray(rows)
        if rows.dtype != bool:
            rows = rows.astype(np.int64)
        return Table({k: v[rows] for k, v in self.columns.items()})

    def select(self, names) -> "Table":
        return Table({k: self.columns[k] for k in names})


def _py(v):
    """A numpy scalar as the Python value (None stays None)."""
    return v.item() if isinstance(v, np.generic) else v


def _obj(values) -> np.ndarray:
    values = list(values)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


_FLOAT = re.compile(r"^\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*$")
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-infinity": -math.inf}


def parse_float(s: str):
    """A number's text (what pandas' parser takes as one) as a float;
    None where the text is not a number."""
    m = _FLOAT.match(s)
    if m is None or not (m.group(2) or m.group(3)):
        return _INF.get(s.strip().lower())
    return float(s)


def _is_float(s: str) -> bool:
    return parse_float(s) is not None


def infer_column(raw) -> np.ndarray:
    """One CSV column (strings) typed as ``pandas.read_csv`` types it."""
    vals = [None if s is None or s in NA_STRINGS else s for s in raw]
    present = [s for s in vals if s is not None]
    missing = len(present) < len(vals)
    if not present:
        return np.full(len(vals), np.nan)
    if all(_INT.match(s) for s in present):
        if not missing:
            return np.array([int(s) for s in vals], dtype=np.int64)
        return np.array([np.nan if s is None else float(int(s)) for s in vals])
    if all(s in _TRUE or s in _FALSE for s in present):
        if not missing:
            return np.array([s in _TRUE for s in vals], dtype=bool)
        return _obj(None if s is None else s in _TRUE for s in vals)
    if all(_is_float(s) for s in present):
        return np.array([np.nan if s is None else parse_float(s) for s in vals])
    return _obj(vals)


def read_csv(path) -> Table:
    """A CSV file as a Table typed as pandas' ``read_csv`` types it."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    return Table({name: infer_column([r[i] if i < len(r) else "" for r in rows])
                  for i, name in enumerate(header)})


def _infer_objects(values: list) -> np.ndarray:
    """Python values (an SQL column) typed as a pandas frame built from
    records types them: ints → int64, numbers with a None → float64,
    strings → str (None missing)."""
    present = [v for v in values if v is not None]
    if present and all(isinstance(v, (int, float)) and not isinstance(v, bool)
                       for v in present):
        if all(isinstance(v, int) for v in present) and len(present) == len(values):
            return np.array(values, dtype=np.int64)
        return np.array([np.nan if v is None else float(v) for v in values])
    if not present:
        return np.full(len(values), np.nan)
    return _obj(values)


def from_records(rows, names) -> Table:
    """Tuples (an SQL result) as a Table with pandas' typing."""
    cols = list(zip(*rows)) if rows else [() for _ in names]
    return Table({n: _infer_objects(list(c)) for n, c in zip(names, cols)})


# ── pandas' column operations ───────────────────────────────────────

def isna(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "O":
        return np.array([v is None for v in col], dtype=bool)
    return np.zeros(len(col), dtype=bool)


def str_lower(col: np.ndarray) -> np.ndarray:
    """``.str.lower()``: only a column of strings has the accessor."""
    if col.dtype.kind != "O" or any(v is not None and not isinstance(v, str) for v in col):
        raise AttributeError("Can only use .str accessor with string values!")
    return _obj(None if v is None else v.lower() for v in col)


def eq(col: np.ndarray, value) -> np.ndarray:
    """``col == value``: a str column equals no number and a numeric
    column no string; missing values equal nothing."""
    if col.dtype.kind == "O":
        return np.array([v is not None and isinstance(v, str) == isinstance(value, str)
                         and v == value for v in col], dtype=bool)
    if isinstance(value, str):
        return np.zeros(len(col), dtype=bool)
    return np.asarray(col == value, dtype=bool)


def astype_str(col: np.ndarray) -> np.ndarray:
    """``astype(str)``: numbers as Python prints them, missing stays missing."""
    kind = col.dtype.kind
    if kind == "f":
        return _obj(None if math.isnan(v) else repr(float(v)) for v in col)
    if kind in "ib":
        return _obj(str(_py(v)) for v in col)
    return _obj(None if v is None else str(v) for v in col)


def astype_bool(col: np.ndarray) -> np.ndarray:
    """``astype(bool)``: non-zero numbers, non-empty strings and missing
    values are True."""
    if col.dtype.kind == "b":
        return col.copy()
    if col.dtype.kind in "if":
        return np.asarray(col != 0, dtype=bool)
    return np.array([True if v is None else bool(v) for v in col], dtype=bool)


def astype_int(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f" and np.isnan(col).any():
        raise ValueError("Cannot convert non-finite values (NA or inf) to integer")
    if col.dtype.kind == "O":
        return np.array([int(v) for v in col], dtype=np.int64)
    return col.astype(np.int64)


def isin(col: np.ndarray, values) -> np.ndarray:
    """``isin``: numbers match numbers by value (64.0 is in [64]),
    strings match strings; missing values match nothing."""
    values = list(values)
    if col.dtype.kind in "ifb":
        nums = [float(v) for v in values
                if isinstance(v, (int, float, np.number)) and not isinstance(v, str)]
        return np.isin(col.astype(np.float64), nums) & ~isna(col)
    return np.array([v is not None and v in values for v in col], dtype=bool)


def to_numeric(col: np.ndarray) -> np.ndarray:
    """``pd.to_numeric(col, errors="coerce")``."""
    if col.dtype.kind in "ifb":
        return col
    parsed = []
    for v in col:
        if v is None:
            parsed.append(None)
        elif isinstance(v, bool):
            parsed.append(int(v))
        elif _INT.match(v):
            parsed.append(int(v))
        elif _is_float(v):
            parsed.append(parse_float(v))
        else:
            parsed.append(None)
    if all(isinstance(v, int) for v in parsed):
        return np.array(parsed, dtype=np.int64)
    return np.array([np.nan if v is None else float(v) for v in parsed])


# ── pandas' reductions ──────────────────────────────────────────────

def _present(values) -> np.ndarray:
    v = np.asarray(values, dtype=np.float64)
    return v[~np.isnan(v)]


def nanmean(values) -> float:
    """``Series.mean()`` / ``GroupBy.mean()``: the mean of the non-missing
    values (NaN when there are none)."""
    v = _present(values)
    return float(v.mean()) if v.size else float("nan")


def nanstd(values, ddof: int = 1) -> float:
    """``Series.std(ddof)`` / ``GroupBy.std(ddof)`` of the non-missing
    values (NaN when ddof leaves none)."""
    v = _present(values)
    return float(v.std(ddof=ddof)) if v.size > ddof else float("nan")


def group_count(values) -> float:
    """``GroupBy.count()`` of one group: its non-missing values."""
    return float(_present(values).size)


def _factorize(col: np.ndarray, dropna: bool):
    """(codes, sorted unique values); a missing value's code is -1 when
    ``dropna``, else one past the last unique (sorted last)."""
    miss = isna(col)
    present = col[~miss]
    if col.dtype.kind == "O":
        uniques = sorted(set(present.tolist()))
        index = {u: i for i, u in enumerate(uniques)}
        codes = np.array([-1 if m else index[v] for v, m in zip(col.tolist(), miss)],
                         dtype=np.int64)
    else:
        uniques = np.unique(present).tolist()
        codes = np.full(len(col), -1, dtype=np.int64)
        codes[~miss] = np.searchsorted(np.asarray(uniques, dtype=col.dtype), present)
    if not dropna and miss.any():
        codes[miss] = len(uniques)
        uniques = [*uniques, None if col.dtype.kind == "O" else float("nan")]
    return codes, uniques


def groups(table: Table, keys, dropna: bool = True) -> list:
    """``groupby(keys)``: [(key values, row indices in row order)], keys
    sorted as pandas sorts them."""
    keys = [keys] if isinstance(keys, str) else list(keys)
    factored = [_factorize(table[k], dropna) for k in keys]
    members: dict = {}
    for i, codes in enumerate(zip(*(c for c, _ in factored))):
        if min(codes, default=0) >= 0:
            members.setdefault(codes, []).append(i)
    return [(tuple(u[c] for c, (_, u) in zip(codes, factored)), np.asarray(rows))
            for codes, rows in sorted(members.items())]


def _key_column(values: list, like: np.ndarray) -> np.ndarray:
    if like.dtype.kind == "O":
        return _obj(values)
    if any(isinstance(v, float) and math.isnan(v) for v in values):
        return np.array(values, dtype=np.float64)
    return np.array(values, dtype=like.dtype)


def group_agg(table: Table, keys, value: str = "score", dropna: bool = True,
              aggs=(("score", nanmean),)) -> Table:
    """``groupby(keys)[value].agg(...).reset_index()``: the key columns
    (sorted groups) and one column per (name, function of the group's
    values)."""
    keys = [keys] if isinstance(keys, str) else list(keys)
    grouped = groups(table, keys, dropna)
    cols = {k: _key_column([g[0][i] for g in grouped], table[k]) for i, k in enumerate(keys)}
    for name, fn in aggs:
        cols[name] = np.array([fn(table[value][rows]) for _, rows in grouped], dtype=np.float64)
    return Table(cols)


def group_idxmax(table: Table, keys, value: str = "score") -> np.ndarray:
    """``groupby(keys)[value].idxmax()``: each sorted group's first row of
    its largest non-missing value."""
    out = []
    for _, rows in groups(table, keys):
        vals = np.asarray(table[value][rows], dtype=np.float64)
        out.append(rows[int(np.nanargmax(vals))])
    return np.asarray(out, dtype=np.int64)


# ── plotters/plotter_utils.py's frame utilities (the port's copy) ──

_SKIP_ALWAYS = {"log_interval", "checkpoint_interval", "cfg_id", "score"}
_PCA_COLS = ("pca_labels", "pca_n_classes")


def _avg_over(df: Table, collapse: str, retain: str) -> Table:
    """Mean score over ``collapse`` within every other column's values
    (plotter_utils ``_avg_over``): layer, score, ``retain`` where it holds
    a value, and the PCA columns."""
    if df.empty or collapse not in df:
        return Table(dict(df.columns))
    d = Table({**df.columns, collapse: to_numeric(df[collapse])})
    d = d.take(~isna(d[collapse]))
    if d.empty:
        return d
    group_cols = [c for c in d.columns if c not in (_SKIP_ALWAYS | {collapse})]
    out = group_agg(d, group_cols, dropna=False)
    keep = ["layer", "score"]
    if retain in out and not isna(out[retain]).all():
        keep.append(retain)
    keep += [c for c in _PCA_COLS if c in out]
    return out.select([c for c in keep if c in out])


def avg_over_seed(df: Table) -> Table:
    """Collapse seed; keep subject_idx + PCA columns."""
    return _avg_over(df, "seed", "subject_idx")


def split_and_select_df(df: Table, *, epoch=None, dataset=None, metric=None, region=None,
                        subject_idx=None, layers=None, pca_n_classes=None,
                        reconstruct_from_pcs=None, pca_k=None):
    """(pca_df, full_df) after the optional filters; rows split on
    ``pca_labels`` read as a lower-case string ("true"/"1" vs
    "false"/"0")."""
    mask = np.ones(len(df), dtype=bool)
    if dataset is not None:
        mask &= eq(str_lower(df["neural_dataset"]), dataset.lower())
    if metric is not None and "compare_method" in df:
        mask &= eq(df["compare_method"], metric)
    if region is not None:
        mask &= eq(df["region"], region)
    if epoch is not None:
        mask &= eq(astype_str(df["epoch"]), str(epoch))
    if subject_idx is not None:
        mask &= isin(astype_str(df["subject_idx"]), [str(s) for s in subject_idx])
    if layers is not None:
        mask &= isin(df["layer"], layers)
    if pca_n_classes is not None:
        mask &= isin(df["pca_n_classes"], pca_n_classes)
    if reconstruct_from_pcs is not None:
        mask &= astype_int(df["reconstruct_from_pcs"]) == int(reconstruct_from_pcs)
    if pca_k is not None:
        mask &= eq(df["pca_k"], pca_k)
    filt = df.take(mask)
    flag = str_lower(astype_str(filt["pca_labels"]))
    return filt.take(isin(flag, ("true", "1"))), filt.take(isin(flag, ("false", "0")))


# ── condition data of the bar plots ─────────────────────────────────

def mean_per_seed(df: Table) -> list:
    """One mean score per seed (sorted), subjects collapsed."""
    return group_agg(df, "seed")["score"].tolist()


def assemble_conditions(df: Table, pc_layer: str, k1k_layer: str,
                        pca_classes=PCA_SIZES) -> dict:
    """{condition label: per-seed scores}: untrained (epoch 0) and
    1000-class (epoch 20, no PCA labels) at ``k1k_layer``, each PCA
    granularity (epoch 20) at ``pc_layer``."""
    layer = str_lower(df["layer"])
    pc_mask = eq(layer, pc_layer.lower())
    k1k_mask = eq(layer, k1k_layer.lower())
    pca_flag = astype_bool(df["pca_labels"])

    out = {"Untrained": mean_per_seed(df.take(k1k_mask & eq(df["epoch"], 0)))}
    pca = group_agg(df.take(pc_mask & eq(df["epoch"], 20) & pca_flag
                            & isin(df["pca_n_classes"], pca_classes)),
                    ["pca_n_classes", "seed"])
    for n in pca_classes:
        rows = eq(pca["pca_n_classes"], n)
        if rows.any():
            out[f"{n} Classes"] = pca["score"][rows].tolist()
        else:
            rprint(f"Warning: missing PCA scores for {n}-class model.", style="warning")
    out["1000 Classes"] = mean_per_seed(df.take(k1k_mask & eq(df["epoch"], 20) & ~pca_flag))
    return out


# ── output: data always, the figure where matplotlib imports ────────

def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, np.ndarray)):
        return [_jsonable(v) for v in (obj.tolist() if isinstance(obj, np.ndarray) else obj)]
    if isinstance(obj, Table):
        return {k: _jsonable(v) for k, v in obj.columns.items()}
    obj = _py(obj)
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def write_series(out_png: str, series) -> str:
    """The figure's data as JSON beside its image (``.json`` for
    ``.png``; missing and non-finite values as null)."""
    path = str(Path(out_png).with_suffix(".json"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(_jsonable(series), f, indent=1)
    return path


def matplotlib_available() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def draw_or_report(prog: str, out_png: str, draw, *args, **kwargs) -> bool:
    """``draw(*args, **kwargs)`` where matplotlib imports; else one line
    saying which figure was not drawn. Returns whether it drew."""
    if not matplotlib_available():
        print(f"{prog}: matplotlib is not installed; {out_png} not drawn", flush=True)
        return False
    draw(*args, **kwargs)
    return True


# ── drawing (matplotlib imported when called) ───────────────────────

def _blues(n, name="Blues"):
    """seaborn's ``color_palette(name, n + 1)[1:]``: ``name``'s matplotlib
    colormap at n + 1 evenly spaced inner points, the lightest dropped."""
    import matplotlib

    k = max(n, 1) + 1
    cmap = matplotlib.colormaps[name]
    return [tuple(float(c) for c in rgba[:3]) for rgba in cmap(np.linspace(0, 1, k + 2)[1:-1])][1:]


def _hide_zero(x, pos):
    return "" if np.isclose(x, 0) else f"{x:.1f}"


def condition_barplot(scores_by_cond: dict, out_png: str,
                      ylabel: str = "Brain Similarity (RSA)",
                      palette_name: str = "Blues"):
    """Rounded bars, mean ± sd per condition."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt
    from matplotlib.ticker import AutoMinorLocator, FuncFormatter, MultipleLocator

    cats = list(scores_by_cond)
    means = [float(np.mean(v)) for v in scores_by_cond.values()]
    errs = [float(np.std(v, ddof=1)) if len(v) > 1 else 0.0
            for v in scores_by_cond.values()]
    pca_cats = [c for c in cats if c not in ("Untrained", "1000 Classes")]
    blues = _blues(len(pca_cats), palette_name)
    palette = {c: (UNTRAINED_C if c == "Untrained" else THOUSAND_C
                   if c == "1000 Classes" else blues[pca_cats.index(c)])
               for c in cats}
    hatches = {c: ("" if c in ("Untrained", "1000 Classes") else "/") for c in cats}

    fig, ax = plt.subplots(figsize=(8, 5))
    old_hatch = plt.rcParams.get("hatch.color")
    plt.rcParams["hatch.color"] = "grey"
    positions = np.arange(len(cats))
    for i, cat in enumerate(cats):
        rect = mpatches.FancyBboxPatch(
            (positions[i] - 0.35, 0), 0.7, means[i],
            boxstyle=mpatches.BoxStyle("Round", pad=0.02, rounding_size=0.1),
            facecolor=palette[cat], edgecolor="black", linewidth=0.8,
            hatch=hatches[cat], mutation_aspect=0.05)
        ax.add_patch(rect)
        if errs[i] > 0:
            ax.errorbar(positions[i], means[i], yerr=errs[i], fmt="none",
                        ecolor="black", elinewidth=1.0, capsize=4, capthick=1.0)
    ax.set_xticks(positions)
    ax.set_xticklabels(cats, rotation=45, ha="right", fontsize=10)
    ax.yaxis.set_major_locator(MultipleLocator(0.1))
    ax.yaxis.set_minor_locator(AutoMinorLocator(2))
    ax.yaxis.set_major_formatter(FuncFormatter(_hide_zero))
    ymax = max(means) if means else 0
    ax.set_ylim(0, ymax + 0.02 if ymax > 0 else 0.1)
    ax.set_xlim(-0.5, len(cats) - 0.5)
    ax.set_ylabel(ylabel, fontsize=14, labelpad=10)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("bottom", "left"):
        ax.spines[side].set_linewidth(1.5)
    plt.tight_layout(pad=1.0)
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    plt.savefig(out_png, dpi=300, bbox_inches="tight")
    plt.close(fig)
    if old_hatch is not None:
        plt.rcParams["hatch.color"] = old_hatch
    rprint(f"Plot saved → {out_png}", style="success")


def layer_comparison_plot(initial_scores, final_scores, pca_scores: dict,
                          layer_order, out_png: str,
                          ylabel: str = "RSA (Spearman)",
                          colors: str = "Blues",
                          min_y=None, max_y=None):
    """Per-layer lines: untrained / 1000-way / coarse granularities."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pca_sizes = sorted(pca_scores)
    pal = dict(zip(pca_sizes, _blues(len(pca_sizes), colors)))
    x = np.arange(len(layer_order))

    def series(d):
        return np.array([d.get(l, np.nan) for l in layer_order], float)

    fig, ax = plt.subplots(figsize=(6, 5.5))
    if initial_scores:
        ax.plot(x, series(initial_scores), color=INITIAL_C, marker="x",
                label="Untrained", zorder=3, linewidth=2.2)
    for n in pca_sizes:
        ax.plot(x, series(pca_scores[n]), color=pal[n], marker="s",
                label=f"{n} Classes", zorder=2, linewidth=2.2)
    if final_scores:
        ax.plot(x, series(final_scores), color=THOUSAND_C, marker="o",
                label="1000 Classes", zorder=3, linewidth=2.6)
    ax.set_xticks(x)
    ax.set_xticklabels(layer_order, rotation=45, ha="right")
    ax.set_ylabel(ylabel)
    if min_y is not None or max_y is not None:
        ax.set_ylim(min_y, max_y)
    ax.grid(True, linestyle="--", alpha=0.7)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    ax.legend(frameon=True, facecolor="white", fontsize=9, loc="best")
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    plt.savefig(out_png, dpi=300, bbox_inches="tight")
    plt.close(fig)
    rprint(f"Plot saved → {out_png}", style="success")


def reconstructed_rsa_plot(recon_by_seed: np.ndarray, out_png: str,
                           untrained=None, best_pc=None,
                           best_pc_n_classes: int = 64,
                           ylabel: str = "RSA (Spearman)"):
    """RSA vs #PCs with horizontal baseline bands. recon_by_seed: (S, K)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.ticker import AutoMinorLocator, MultipleLocator

    recon = np.asarray(recon_by_seed, float)
    ks = np.arange(1, recon.shape[1] + 1)
    mean, std = recon.mean(axis=0), recon.std(axis=0)

    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(ks, mean, marker="^", color=THOUSAND_C,
            label="1000 classes (reconstructed)", markersize=6, linewidth=2,
            markeredgecolor="white", markeredgewidth=0.5, zorder=3)
    ax.fill_between(ks, mean - std, mean + std, alpha=0.3, color=THOUSAND_C,
                    zorder=2)
    if best_pc is not None:
        m, s = best_pc
        pal = dict(zip(PCA_SIZES, _blues(len(PCA_SIZES))))
        c = pal.get(best_pc_n_classes, "#808080")
        ax.axhline(m, color=c, linestyle="--", linewidth=2.3,
                   label=f"{best_pc_n_classes} classes (full)", zorder=2)
        ax.fill_between(ks, m - s, m + s, color=c, alpha=0.25, zorder=1)
    if untrained is not None:
        m, s = untrained
        ax.axhline(m, color=INITIAL_C, linestyle=":", linewidth=2.3,
                   label="Untrained (full)", zorder=2)
        ax.fill_between(ks, m - s, m + s, color=INITIAL_C, alpha=0.2, zorder=1)
    ax.set_xlabel("Number of PCs for Reconstruction")
    ax.set_ylabel(ylabel)
    ax.xaxis.set_major_locator(MultipleLocator(5))
    ax.xaxis.set_minor_locator(AutoMinorLocator(5))
    ax.set_xlim(0.5, recon.shape[1] + 0.5)
    ax.grid(True, which="major", linestyle="--", linewidth=0.5, alpha=0.7)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    ax.legend(frameon=True, facecolor="white", edgecolor="black", fontsize=8)
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    plt.savefig(out_png, dpi=300)
    plt.close(fig)
    rprint(f"Plot saved → {out_png}", style="success")
