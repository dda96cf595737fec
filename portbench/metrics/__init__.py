"""Per-layer metrics, one module a metric, named as in ``BENCHMARK.json``.
Each has ``read(record)``: the metric from a traced run's record, or
None when the record holds nothing to read (the harness then leaves the
metric out)."""
