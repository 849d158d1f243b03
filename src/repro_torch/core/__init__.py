"""Copy of the JAX package's Nezha store (``repro.core``) that the
training slice reaches: ``Cluster`` and ``Metrics`` with what they import.
"""
