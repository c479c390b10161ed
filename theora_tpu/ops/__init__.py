"""Pixel/transform kernels.

Each op has a numpy host implementation (the bit-exactness reference used by
tests) and a JAX device implementation (the production path), validated
against each other.
"""
