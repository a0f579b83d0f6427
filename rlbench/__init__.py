"""The benchmark of ``renderloom_torch`` on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json`` once and prints one
JSON line (``python -m rlbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``).  Everything a cell needs is found by
name: its configuration in ``configs/``, the models the configuration
is built into in ``builds/``, its traffic mix in ``traffic/``, its
correctness limits in ``cells/`` and each per-layer metric's reader in
``metrics/``.  ``reference/`` is a plain float32 PyTorch copy of the
served and trained functions that imports nothing of the program.
"""
