"""Signal-processing blocks (PyTorch port of ``radiorust_tpu.blocks``)."""
