"""Numeric ops of the port; kernels live in ``ops.cuda``."""
