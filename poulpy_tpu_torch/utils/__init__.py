"""Interoperation with the JAX package."""
