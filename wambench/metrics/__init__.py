"""Per-layer metrics, one reader module a metric, found by the metric's
name in BENCHMARK.json.  Each holds ``UNIT``, ``MOVES`` (the end-to-end
metric it should move) and ``read(trace, shape)``, which returns the
metric's value or None where the traced window holds nothing to read.

``trace`` is a `wambench.trace.Trace`; ``shape`` a `wambench.run.Shape`:
the cell's flows, paths, links, lanes a flow, routing entries, deepest
link and the card's largest SM clock."""
