"""Per-layer metric readers, one file a metric named as in
BENCHMARK.json (each exposes read(ctx) -> a number, or None where the run
has nothing to read), and the arithmetic they share."""
