"""The benchmark of the PyTorch and CUDA port, ``qasr_torch`` (see ``harness.py``)."""
