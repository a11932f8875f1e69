"""Hand-written CUDA kernels of the port, with their bindings and plain
versions.

The modules form layers, and each imports only modules of the layers below
it: ``library`` (the build, the loading, the entry points' declaration, the
checked arguments, the card's limits); the forward families
(``gru_window_smem``, ``gru_window_xp_grid``, ``gru_window_proj``,
``gru_window``, ``gru_window_xp``, ``gru_window_encdec``); the backward
families (``gru_window_bwd_smem``, ``gru_window_xp_bwd_grid``,
``gru_window_wgrad``, ``gru_window_bwd``, ``gru_window_xp_bwd``); then
``gru_window_autograd``. Each family declares its own C entries to
``library`` (``ENTRIES``, ``check_fit``).

Each kernel module counts its kernels' launches in ``launch_counts``;
:func:`reset_launch_counts` and :func:`launch_counts` act on all of them."""
from __future__ import annotations

from typing import Dict

from helen_tpu_torch.ops import (
    gru_window,
    gru_window_bwd,
    gru_window_proj,
    gru_window_wgrad,
    gru_window_xp,
    gru_window_xp_bwd,
)

_COUNTED = (gru_window, gru_window_bwd, gru_window_wgrad, gru_window_xp, gru_window_xp_bwd,
            gru_window_proj)
#: the modules whose ``launch_counts`` count kernel launches
COUNTED = tuple(m.__name__.rsplit(".", 1)[-1] for m in _COUNTED)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for module in _COUNTED:
        module.reset_launch_counts()


def launch_counts() -> Dict[str, int]:
    """The kernels launched since the last reset, with their counts."""
    return {k: v for module in _COUNTED for k, v in module.launch_counts.items() if v}
