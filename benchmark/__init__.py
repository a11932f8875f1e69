"""The benchmark of helen_tpu_torch on an NVIDIA GPU.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. Everything that
belongs to one configuration, traffic mix, per-layer metric or cell lives in
a file of its own, found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (read by the task ``tasks/<task>.py`` it names),
``metrics/<metric>.py`` and ``limits/<cell>.json``. ``reference/`` holds the
plain PyTorch reference that decides ``correct``; it imports nothing of the
program.
"""
