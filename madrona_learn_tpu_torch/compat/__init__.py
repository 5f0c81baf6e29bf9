"""Conversion of the JAX package's state into the port's (numpy only)."""
