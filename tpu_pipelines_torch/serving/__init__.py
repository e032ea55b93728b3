"""Model server, micro-batcher and the serving CLI."""
