"""User modules for port payloads."""
