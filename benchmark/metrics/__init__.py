"""Per-layer metric readers, one file per metric, named as the metric:
`read(run)` returns the metric's value from the traced run
(`run.timeline`, `run.spans_ms`, `run.work`, `run.counts`, `run.cell`), or
None where the run holds nothing to read."""
