"""Metrics registry and Prometheus exposition."""
