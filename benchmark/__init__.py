"""The benchmark of the PyTorch and CUDA port (``inraudio_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything a cell needs is found by name: its configuration
in ``configs/<config>.json`` (with the plain reference named there under
``reference/``), its traffic in ``traffic/<mix>.json`` (read by the driver
named there, under ``drivers/``), the limits of its comparison in
``limits/<cell>.json``, and each per-layer metric's reader in
``metrics/<metric>.py``.  Nothing here imports JAX or the JAX package.
"""
