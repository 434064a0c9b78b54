"""One reader a per-layer metric, found by the metric's name."""
