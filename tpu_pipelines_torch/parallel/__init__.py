"""Attention without a mesh: the plain ``dense_attention``."""
