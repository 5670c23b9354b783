"""Synthetic tabular data (a numpy copy of the JAX package's
``data/tabular.py``) and the LM data pipeline (``pipeline``)."""
