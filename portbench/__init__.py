"""The benchmark of the PyTorch and CUDA port (``repro_torch``): a harness
driven by ``BENCHMARK.json`` at the root of the repository, with one file
for each configuration (``configs/``), traffic mix (``traffic/``) and
per-layer metric (``metrics/``).  Run a cell with
``python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1``.
"""
