"""Hand-written CUDA kernels of the port, with their bindings and plain
versions (ops.gru_window).

Each kernel module counts its kernels' launches in ``launch_counts``;
:func:`reset_launch_counts` and :func:`launch_counts` act on all of them."""
from __future__ import annotations

import importlib
from typing import Dict

#: the modules whose ``launch_counts`` count kernel launches
COUNTED = ("gru_window", "gru_window_bwd", "gru_window_wgrad", "gru_window_xp",
           "gru_window_xp_bwd", "gru_window_proj")


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in COUNTED:
        importlib.import_module(f"{__name__}.{name}").reset_launch_counts()


def launch_counts() -> Dict[str, int]:
    """The kernels launched since the last reset, with their counts."""
    return {k: v for name in COUNTED
            for k, v in importlib.import_module(f"{__name__}.{name}").launch_counts.items()
            if v}
