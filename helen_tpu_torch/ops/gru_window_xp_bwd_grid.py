"""Pass 1 of the xp-stream backward (K4) as a grid-wide recurrence with
``W_hh`` spread over the SMs' shared memory: the kernel's binding, its fit
rule, its launch and its plain version.

The hand-written CUDA kernel ``bigru_window_xp_bwd_rec_grid``
(``ops/csrc/gru_window_xp_bwd_grid.cu``, in the kernel library of
ops.library) carries pass 1 of :func:`ops.gru_window_xp_bwd.bigru_window_xp_bwd`
in its ``"grid"`` design, after the gate pass ``bigru_window_bwd_hp``
(ops.gru_window_bwd_smem: ``hp = h_prev @ W_hh`` without ``b_hh``, over the
whole window). One persistent grid of ``2 C`` blocks, ``C = ceil(H / U)``
per direction, all co-resident (a cooperative launch), block ``c`` holding
the ``W_hh`` rows of its ``U`` hidden units in shared memory for all T
steps, one grid barrier per direction and step. It writes pass 2's scratch
``dxp (2, T, B, 3H)`` and ``dhp_n (2, T, B, H)``, and ``dh0`` per direction.
Its carry product is register-tiled: each thread holds :func:`grid_tile`'s
rows x 2 units of sums, in blocks of 256 threads.

:func:`grid_units` is the fit rule: the smallest ``U`` whose ``2 C`` blocks
fit the card's SMs, one block each, if its shared memory
(:func:`grid_smem_bytes`) fits the card's opt-in budget; else none, and
the one-launch ``xp_bwd_rec_kernel`` takes the shape. It is a rule of the
shape and the card, read once from the device (``library.card_limits``).

Every sum is taken in the order of ``xp_bwd_rec_kernel``
(``csrc/gru_window_xp_bwd.cu``), whose cotangent lines it shares
(``gru_cell_bwd``), so on the card the two designs give the same bits. Its
wrapper, ``gru_window_xp_bwd.bigru_window_xp_bwd_rec_grid``, computes the
plain version on a CPU tensor and launches the kernel on a CUDA one.
Chained, ``bwd_hp_plain`` and :func:`xp_bwd_rec_grid_plain` are
``gru_window_xp_bwd.bigru_window_xp_bwd_rec_plain`` to the bit.
"""
from __future__ import annotations

from ctypes import c_int as i, c_longlong as ll, c_void_p as p
from typing import Dict, Optional

import torch

from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.gru_window_bwd_smem import RecOutputs, h_prev_of, unwind_gates
from helen_tpu_torch.ops.library import GRID_COUNTERS, Layer, empty, get_lib, raise_on, stream

# csrc/gru_window_xp_bwd_grid.cu's constants: unit groups (a warp is 8 unit
# groups x 4 row groups), unit slots per thread, row groups (8 x 32 = 256
# threads at every tile), k per chunk (twice that at row blocks of at most 64
# rows), the ring's floats, the most units per block; the tiles the entry
# has (rows per thread)
BG_UG, BG_UPT, BG_RG, BG_KC, BG_RING = 8, 2, 32, 16, 8192
GRID_MAX_UNITS = 16
GRID_TILES = (4, 2)


def grid_smem_bytes(h: int, u: int) -> int:
    """Dynamic shared memory of one block of the grid recurrence at hidden
    size ``h`` and ``u`` units per block, at any tile: its ``u`` ``W_hh``
    rows (each ``3h`` rounded up to 32 floats plus 4) and the ring's 8192
    floats of dhp, float32; csrc/gru_window_xp_bwd_grid.cu ``grid_smem``."""
    stride = -(-3 * h // 32) * 32 + 4
    return 4 * (u * stride + BG_RING)


def grid_tile(b: int) -> int:
    """The carry product's rows per thread at batch ``b``, each thread that
    many rows x 2 units in blocks of 256 threads: 2 where 64 rows hold the
    batch (the wide train's 64: one row block of 64 rows), else 4 (row blocks
    of 128 rows, 6 loads to 32 FMAs against 4 to 16)."""
    return 2 if b <= 64 else 4


def grid_units(h: int, sms: int, budget: int) -> Optional[int]:
    """The grid recurrence's hidden units per block at hidden size ``h`` on a
    card of ``sms`` SMs and ``budget`` bytes of opt-in shared memory per
    block: the smallest ``U`` with ``2 ceil(h / U) <= sms`` (one block per
    SM, both directions), if its shared memory fits ``budget`` and it is at
    most :data:`GRID_MAX_UNITS`; else None. A larger ``U`` only takes more
    shared memory, so no other ``U`` fits where this one does not. On the
    H100 SXM: U=16 at H=1024, 12 at 768, 10 at 640, 2 at 128."""
    if h < 1 or sms < 2:
        return None
    u = -(-h // (sms // 2))
    if u > GRID_MAX_UNITS or grid_smem_bytes(h, u) > budget:
        return None
    return u


#: the C entries of csrc/gru_window_xp_bwd_grid.cu
ENTRIES = {"bigru_window_xp_bwd_rec_grid": (i, [p] * 20 + [i, i, i, i, i, p]),
           "bigru_window_xp_bwd_grid_smem_bytes": (ll, [i, i])}


def check_fit(lib) -> None:
    """Raise where :func:`grid_smem_bytes` disagrees with the source's."""
    if any(lib.bigru_window_xp_bwd_grid_smem_bytes(h, u) != grid_smem_bytes(h, u)
           for h in (1, 37, 128, 160, 640, 1000, 1024) for u in (1, 2, 3, 10, 16)):
        raise RuntimeError("the grid recurrence's fit disagrees with "
                           "csrc/gru_window_xp_bwd_grid.cu")


library.register(ENTRIES, check_fit)


# ---------------------------------------------------------------------------
# plain version (CPU path, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

def xp_bwd_rec_grid_plain(xp_f, xp_b, hp: torch.Tensor, h0_f, h0_b, out_f, out_b, dout_f,
                          dout_b, dh_f, dh_b, layer: Layer) -> RecOutputs:
    """The recurrence given ``xp`` per direction (``b_ih`` added) and ``hp``
    ``(2, T, B, 3H)`` (without ``b_hh``): ``gru_window_bwd_smem.unwind_gates``
    per direction. Returns ``(dxp, dhp_n, dh0_f, dh0_b)``."""
    res = [unwind_gates(xp, hp[k] + layer[d]["b_hh"], h_prev_of(out, h0, rev), dout, dh,
                        layer[d]["w_hh"], rev)
           for k, (d, xp, out, h0, dout, dh, rev) in enumerate(
               (("fwd", xp_f, out_f, h0_f, dout_f, dh_f, False),
                ("bwd", xp_b, out_b, h0_b, dout_b, dh_b, True)))]
    return (torch.stack([r[0] for r in res]), torch.stack([r[1] for r in res]),
            res[0][2], res[1][2])


# ---------------------------------------------------------------------------
# binding and launch (the arguments checked by the caller)
# ---------------------------------------------------------------------------

def launch_rec_grid(xp_f, xp_b, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b,
                    layer: Layer, units: int, counts: Dict[str, int], dev) -> RecOutputs:
    """One launch of the grid recurrence at ``units`` hidden units per block
    in :func:`grid_tile`'s tile, counted in
    ``counts["bigru_window_xp_bwd_rec_grid"]`` and under its tile,
    ``..._grid_r{rpt}``; raises on a refused launch (a grid the card cannot
    hold at once among them)."""
    T, B, H = out_f.shape
    rpt = grid_tile(B)
    dxp, dhpn = empty(dev, 2, T, B, 3 * H), empty(dev, 2, T, B, H)
    dh0_f, dh0_b = empty(dev, B, H), empty(dev, B, H)
    arrive = torch.zeros(GRID_COUNTERS, dtype=torch.int32, device=dev)
    w = [layer[d][k] for d in ("fwd", "bwd") for k in ("w_hh", "b_hh")]
    with torch.cuda.device(dev):
        err = get_lib().bigru_window_xp_bwd_rec_grid(
            *(t.data_ptr() for t in (xp_f, xp_b, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b,
                                     dh_f, dh_b, *w, dxp, dhpn, dh0_f, dh0_b, arrive)),
            T, B, H, units, rpt, stream(dev))
    raise_on(err, "bigru_window_xp_bwd_rec_grid")
    counts["bigru_window_xp_bwd_rec_grid"] += 1
    counts[f"bigru_window_xp_bwd_rec_grid_r{rpt}"] += 1
    return dxp, dhpn, dh0_f, dh0_b
