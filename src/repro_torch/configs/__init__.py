"""Configuration dataclasses of the port (own copies: ``repro.configs``
imports jax when its package is imported)."""
