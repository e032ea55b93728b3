"""Model server, micro-batcher, serving fleet, captured serving steps and
the serving CLI."""
