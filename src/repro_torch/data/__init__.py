"""Synthetic data and the non-IID client partition (NumPy copies of
``repro.data.synthetic`` and ``repro.data.sharding``)."""
