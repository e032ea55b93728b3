"""Model evaluation: sliced metrics and the blessing gate's thresholds."""
