"""Helpers copied from the reference, with no JAX in them."""
