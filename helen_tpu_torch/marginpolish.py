"""MarginPolish passthrough wrapper (port of helen_tpu/marginpolish.py).

Equivalent of the reference's bundled-binary wrapper
(helen/marginpolish.py:9-15): the reference builds MarginPolish v1.3.0 from
source at install time and ships the binary (marginpolish.cmake:7-13,
setup.py:82-90). The port, like helen_tpu, does not rebuild that external C
program; this wrapper execs a ``marginPolish`` binary found via
$HELEN_TPU_MARGINPOLISH or $PATH, passing all arguments through, so
existing pipelines keep working. For hermetic tests and development,
helen_tpu_torch.io.synthetic generates image files in the same HDF5 schema.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys


def find_marginpolish() -> str:
    """Locate the marginPolish binary or raise with guidance.

    Search order: $HELEN_TPU_MARGINPOLISH, a bundled copy next to the
    package (``helen_tpu_torch/bin/marginPolish`` — where the Docker image's
    pinned v1.3.0 build can be placed, mirroring the reference's
    ``helen/bin`` bundling, setup.py:82-90), then $PATH."""
    candidate = os.environ.get("HELEN_TPU_MARGINPOLISH")
    if candidate and os.path.isfile(candidate) and os.access(candidate, os.X_OK):
        return candidate
    bundled = os.path.join(os.path.dirname(__file__), "bin", "marginPolish")
    if os.path.isfile(bundled) and os.access(bundled, os.X_OK):
        return bundled
    for name in ("marginPolish", "marginpolish"):
        path = shutil.which(name)
        if path:
            return path
    raise FileNotFoundError(
        "marginPolish binary not found. Install MarginPolish "
        "(github.com/UCSC-nanopore-cgl/MarginPolish) and put it on $PATH, or "
        "set HELEN_TPU_MARGINPOLISH to the binary path."
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        binary = find_marginpolish()
    except FileNotFoundError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 127
    return subprocess.call([binary] + argv)


if __name__ == "__main__":
    sys.exit(main())
