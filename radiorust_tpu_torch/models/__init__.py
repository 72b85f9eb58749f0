"""Composed receive chains (PyTorch port of ``radiorust_tpu.models``)."""
