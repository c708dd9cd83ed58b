"""One reader a metric: ``metrics/<name>.py`` holds ``read(ctx)``, which
returns the metric's value from ``harness.Context`` or None where the
run has nothing to read for it (the harness then leaves it out)."""
