"""Test seams of the port: the serving fleet's fault injection."""
