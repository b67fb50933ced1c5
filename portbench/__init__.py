"""The benchmark of ``gfe_mamba_torch`` on one NVIDIA GPU.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Every piece is
found by name: a configuration in ``configs/<name>.json``, a traffic mix
in ``traffic/<name>.json`` (whose ``entry`` names the driver in
``entries/<entry>.py``), a per-layer metric's reader in
``metrics/<name>.py`` and a cell's correctness limits in
``limits/<cell>.json``.  ``reference/`` holds the plain PyTorch models
that decide ``correct``; it imports nothing of the program.
"""
