"""Test seams of the port: the runner's and the serving fleet's fault injection."""
