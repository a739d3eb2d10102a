"""Plain float32 PyTorch references of the benchmark's models, and the
runner's training loop.  They import nothing of the program under test:
``inraudio_tpu_torch`` is checked against them, never the other way."""
