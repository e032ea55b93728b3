"""Export and load of serving payloads, and serving-dtype helpers."""
