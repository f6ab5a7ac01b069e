"""Per-layer metrics, one reader a metric, found by the metric's name:
`read(trace)` takes a trace.Trace of the cell's traced window and returns
the number, or None where the window holds nothing to read (the harness
then leaves the metric out of the line)."""
