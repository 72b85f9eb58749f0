"""Device ops: the hand-written CUDA kernels' wrappers and their plain
PyTorch versions."""
