"""Run one cell of the benchmark of helen_tpu_torch on an NVIDIA GPU.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and metrics
are found by name through ``BENCHMARK.json``. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``compared``: each number that decided ``correct`` beside its limit. The
same numbers end standard error. Without a CUDA GPU it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.lib import cells, harness  # noqa: E402


def main(argv=None) -> int:
    process_start = time.perf_counter() - harness.process_age()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = cells.load_benchmark()
    chips = cells.cell(bench, args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA GPU(s); this machine has "
              f"{found} visible to torch", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, run = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                   bool(args.trace), device, process_start,
                                   log=lambda m: print(m, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}; the benchmark runs the port "
              "without JAX or helen_tpu", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
