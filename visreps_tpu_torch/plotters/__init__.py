"""The paper's results.db figures (port of ``plotters/``): queries and
summaries on ``sqlite3`` and numpy without pandas, the coarseness bars
and per-subject boxes of every neural dataset, and the label-source
comparison. Each figure's data is written as JSON beside it; the figure
is drawn only where matplotlib imports."""
