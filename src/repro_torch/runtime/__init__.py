"""Fault models: a framework-free copy of the JAX package's
``runtime/fault.py``."""
