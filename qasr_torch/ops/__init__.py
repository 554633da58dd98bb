"""Plain PyTorch quaternion ops and the hand-written kernels (``kernels``)."""
