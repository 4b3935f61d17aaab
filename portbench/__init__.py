"""The benchmark of ``repro_torch``, the PyTorch/CUDA port (run: ``python3 portbench/run.py``)."""
