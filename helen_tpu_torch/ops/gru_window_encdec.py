"""The fused encoder+decoder window: the kernels' binding, their design
rule and fit functions, their plain versions and helen_tpu's library entry.

K5 runs one transducer window of a model with one encoder and one decoder
bi-GRU layer in one launch, in one of two designs (:func:`encdec_design`, a
fixed rule of the shape):

* ``"cluster"`` (``ops/csrc/gru_window_smem.cu`` and ``gru_window_fast.cu``,
  shared parts in ``gru_window_cluster.cuh``): one cluster of two CTAs per
  group of :func:`ops.gru_window_smem.rec_block_rows` batch rows, CTA rank 0
  the forward direction, rank 1 the backward one, each running its
  direction's encoder layer, then its decoder layer. Its consumer warps run
  the recurrence step of the chain's own recurrence (``W_hh`` in shared
  memory in parity, as bf16 ``mma.sync`` A fragments in the fast tier);
  its producer warps project the layer's input a chunk of 32 rows ahead
  (the chain's projection arithmetic) into a ring the consumers read. The
  encoder's outputs (the boundary) go to a per-cluster slice of device
  memory; the two CTAs meet on the cluster's barrier before either decoder
  reads them. Taken where :func:`ops.gru_window_smem.takes_smem_design`
  holds and the cluster fits (:func:`cluster_fits`): the flagship's H=128
  at every batch, in both tiers.
* ``"onepass"`` (``ops/csrc/gru_window_encdec.cu``): one block per few
  batch rows holding both directions and the boundary in shared memory
  (:func:`encdec_block_rows`); the other shapes that fit
  (:func:`encdec_fits_smem`).

:func:`transducer_window_encdec` (K5, replaces helen_tpu's
``_kernel_fused_encdec``, ``helen_tpu/ops/gru_pallas.py:756``) reads the
``(B, L, F)`` uint8 image at column ``start``; :func:`transducer_window_encdec_fast`
(K5f) is the same with ``fast=True``, on the layers' bf16 ``w_ih``/``w_hh``
(io.checkpoint.fast_layer), the boundary rounded to bf16 where K2f rounds
its input. Both return the DECODER's ``(out_f (T, B, H), out_b (T, B, H),
h_f (B, H), h_b (B, H))``. In parity both designs take every sum in the
order of K1 -> K2 (their cell steps are the chain's), so on the card they
equal the chain, and each other, bit for bit; in the fast tier the cluster
design sums as the two-launch K1f -> K2f, the one-pass design as the
one-launch K1f -> K2f.

On a CPU tensor K5 and K5f compute their plain versions (the chained plain
layers of ops.gru_window); on a CUDA tensor they launch the design's kernel
or raise: nothing falls back to the chained kernels. Each call adds one to
``ops.gru_window.launch_counts`` under its own name, and one under the name
of the kernel that ran (``transducer_window_encdec_cluster``/``_onepass``,
``_fast`` in the fast tier). :func:`transducer_window_encdec_cluster` and
``_cluster_fast`` are the cluster kernel's own wrappers: on a CPU tensor its
plain version (:func:`transducer_window_encdec_cluster_plain`, the
projection and the recurrence of ops.gru_window_smem for each layer), on a
CUDA tensor the kernel alone.

The kernels are on no dispatch path: ``models.transducer.forward`` runs K5
only for ``route="encdec"`` (library only, inference only), as helen_tpu
keeps its fused kernel off its own dispatch.
"""
from __future__ import annotations

import threading
from ctypes import c_int as i, c_longlong as ll, c_void_p as p

import torch

from helen_tpu_torch.io.checkpoint import fast_layer
from helen_tpu_torch.models.gru import bf16_round
from helen_tpu_torch.ops import gru_window_smem as gs
from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.gru_window import (
    MAX_H,
    bigru_window_in1_fast_plain,
    bigru_window_in1_plain,
    bigru_window_in2_fast_plain,
    bigru_window_in2_plain,
    launch_counts,
)
from helen_tpu_torch.ops.library import (
    HOPPER_SMEM_OPTIN,
    Layer,
    Outputs,
    check,
    cuda_device,
    device_smem_budget,
    get_lib,
    layer_args,
    outputs,
    raise_on,
    stream,
)

#: the batch rows per block the one-pass kernel is built for, most first
BLOCK_ROWS = (4, 2, 1)
#: K5's designs: the two-CTA cluster, and the one-pass kernel (gru_window_encdec.cu)
DESIGNS = ("cluster", "onepass")
#: the cluster design's constants (csrc/gru_window_cluster.cuh EC_ROWS,
#: EC_STAGES and its mbarriers' bytes; gru_window_smem.cu ECP_PROD,
#: ECP_CONS_MAX, ECP_N, ECP_BK; gru_window_fast.cu ECF_PROD, ECF_MAX_KT x 16,
#: ECF_KS): the rows of one projected chunk, the ring's chunks, the producer
#: threads, the most consumer threads, the widest 3H and the k stage of the
#: parity producer's tile, the fast tier's producer threads, its largest H
#: (the consumers' A fragments) and its k stage
CLUSTER_ROWS, CLUSTER_STAGES, CLUSTER_BAR_BYTES = 32, 2, 32
CLUSTER_PROD, CLUSTER_CONS_MAX, CLUSTER_N, CLUSTER_BK = 192, 256, 384, 8
CLUSTER_FAST_PROD, CLUSTER_FAST_MAX_H, CLUSTER_FAST_KS = 128, 128, 32


def encdec_max_threads(bt: int) -> int:
    """The most threads (2H, both directions) a block of ``bt`` rows takes:
    1024 at up to 2 rows (64 registers per thread), 512 at 4 (128 registers
    for its 24 accumulators); csrc/gru_window_encdec.cu ``encdec_max_threads``."""
    return MAX_H if bt >= 4 else 2 * MAX_H


def encdec_smem_bytes(h: int, bt: int, d: int, t: int, fast: bool) -> int:
    """Dynamic shared memory of one K5 block of ``bt`` batch rows: h of both
    directions, double-buffered (and its bf16 operand copy in the fast
    tier), the encoder's double-buffered input rows of width ``d``, and the
    boundary, both directions' ``(t, bt, h)`` encoder outputs: float32, or
    bf16 in the fast tier, which stores them already rounded (exact: K2f
    rounds the same values the same way). The counterpart of helen_tpu's
    ``fused_encdec_vmem_bytes`` (``gru_pallas.py:865``) for this card;
    csrc/gru_window_encdec.cu ``encdec_smem``."""
    return 4 * 4 * bt * (h * (2 if fast else 1) + d) + 2 * t * bt * h * (2 if fast else 4)


def encdec_block_rows(h: int, d: int, t: int, fast: bool, budget: int = 0) -> int:
    """The most batch rows per block (4, 2 or 1) whose K5 block fits
    ``budget`` bytes of shared memory (default :data:`HOPPER_SMEM_OPTIN`)
    and the block's thread limit, or 0 if none does: the counterpart of
    helen_tpu's ``_pick_block_fused_target`` (``gru_pallas.py:878``)."""
    budget = budget or HOPPER_SMEM_OPTIN
    for bt in BLOCK_ROWS:
        if 2 * h <= encdec_max_threads(bt) and encdec_smem_bytes(h, bt, d, t, fast) <= budget:
            return bt
    return 0


def encdec_fits_smem(h: int, d: int, t: int, fast: bool, budget: int = 0) -> bool:
    """Whether K5 takes hidden size ``h``, input width ``d`` and window ``t``
    (helen_tpu's ``fused_encdec_fits_vmem``, ``gru_pallas.py:891``)."""
    return encdec_block_rows(h, d, t, fast, budget) > 0


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def cluster_consumers(h: int, rows: int, fast: bool) -> int:
    """The cluster kernel's consumer threads: the chain's recurrence block
    rounded up to whole warps (2 threads a unit at 2 rows and more in
    parity; a warp per 16 units in the fast tier)."""
    if fast:
        return _up(h, 16) // 16 * 32
    return _up((2 if rows >= 2 else 1) * h, 32)


def cluster_threads(h: int, rows: int, fast: bool) -> int:
    """Threads of one cluster CTA: its consumers, then its producers."""
    return cluster_consumers(h, rows, fast) + (CLUSTER_FAST_PROD if fast else CLUSTER_PROD)


def cluster_smem_bytes(h: int, rows: int, fast: bool) -> int:
    """Dynamic shared memory of one cluster CTA. Parity: the ring's
    mbarriers, the chain recurrence's h and ``W_hh``
    (``gru_window_smem.rec_smem_bytes``, rounded up to 16 bytes) and the
    producer's double-buffered A (8 x 36) and ``W_ih`` (8 x 384) stages,
    float32; csrc/gru_window_smem.cu ``ecp_smem``. Fast: the mbarriers, the
    bf16 h tile (2 x 8 rows of ``h`` rounded up to 32, plus 8) and one
    region that holds ``W_hh``'s bf16 staging area while the consumers load
    their fragments, then the producers' ring (2 x 32 rows of 3h rounded up
    to 32, plus 4, float32), ``W_ih`` stages (2 x 32 rows) and A stages (2 x
    32 x 40); csrc/gru_window_fast.cu ``ecf_smem``."""
    if not fast:
        return (CLUSTER_BAR_BYTES + _up(gs.rec_smem_bytes(h, rows), 16)
                + 4 * 2 * CLUSTER_BK * (CLUSTER_ROWS + 4 + CLUSTER_N))
    up, kp = _up(h, 16), _up(h, 32)
    ntw = 2 * ((6 * (kp // 16) + 7) // 8)
    staging = 2 * kp * (3 * up + 8)
    producer = (4 * CLUSTER_STAGES * CLUSTER_ROWS * (_up(3 * h, 32) + 4)
                + 2 * 2 * CLUSTER_FAST_KS * (32 * ntw + 8)
                + 2 * 2 * CLUSTER_ROWS * (CLUSTER_FAST_KS + 8))
    return CLUSTER_BAR_BYTES + 2 * 2 * 8 * (kp + 8) + max(staging, producer)


def cluster_scratch_bytes(h: int, b: int, t: int, rows: int, fast: bool) -> int:
    """The device memory the wrapper passes the cluster kernel: the
    boundary, both directions' encoder outputs ``(t, rows, h)`` per cluster
    (float32, or bf16 in the fast tier), and in parity the xp ring, 2 x 32
    rows of 3h float32 per CTA."""
    clusters = -(-b // rows)
    if fast:
        return 2 * clusters * 2 * t * rows * h
    return 4 * clusters * (2 * t * rows * h + 2 * CLUSTER_STAGES * CLUSTER_ROWS * 3 * h)


def cluster_fits(h: int, rows: int, fast: bool, budget: int = 0) -> bool:
    """Whether the cluster kernel takes hidden size ``h`` at ``rows`` batch
    rows per cluster: its shared memory within ``budget`` bytes (default
    :data:`HOPPER_SMEM_OPTIN`), and in parity 3h within the producer's
    384-column tile and the consumers within 256 threads (h <= 128 at 2
    rows and more), in the fast tier h <= 128 (the consumers' 96 registers
    of A fragments beside the producers' accumulators)."""
    if h < 1 or rows not in (1, 2, 4, 8):
        return False
    if fast:
        ok = h <= CLUSTER_FAST_MAX_H
    else:
        ok = 3 * h <= CLUSTER_N and cluster_consumers(h, rows, False) <= CLUSTER_CONS_MAX
    return ok and cluster_smem_bytes(h, rows, fast) <= (budget or HOPPER_SMEM_OPTIN)


def encdec_design(H: int, B: int, fast: bool = False, design=None) -> str:
    """K5's (K5f's) design at hidden size ``H`` and batch ``B``:
    ``"cluster"`` where ``gru_window_smem.takes_smem_design`` holds (the
    chain's recurrence takes the shape) and the cluster fits at
    ``rec_block_rows(B)`` rows (:func:`cluster_fits`), else ``"onepass"``.
    ``design`` forces one; ``"cluster"`` raises where the rule does not
    hold."""
    fits = gs.takes_smem_design(H, B, fast) and cluster_fits(H, gs.rec_block_rows(B), fast)
    if design is None:
        return "cluster" if fits else "onepass"
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} is not one of {DESIGNS}")
    if design == "cluster" and not fits:
        raise ValueError(f"design 'cluster' does not take H={H}, B={B}"
                         + (" in the fast tier" if fast else ""))
    return design


_active_lock = threading.Lock()
_active: dict = {}


def cluster_active(H: int, B: int, fast: bool) -> int:
    """How many of the cluster kernel's clusters the current card holds at
    once at hidden size ``H`` and batch ``B`` (read from the card once per
    shape): ``ceil(B / rec_block_rows(B))`` or more runs them in one wave."""
    rows = gs.rec_block_rows(B)
    key = (torch.cuda.current_device(), H, rows, fast)
    with _active_lock:
        if key not in _active:
            lib = get_lib()
            n = (lib.transducer_window_encdec_cluster_fast_active(H) if fast
                 else lib.transducer_window_encdec_cluster_active(H, rows))
            if n < 0:
                raise_on(-n, "transducer_window_encdec_cluster" + ("_fast" if fast else ""))
            _active[key] = n
        return _active[key]


#: K5's arguments: K1's, both layers' weights, the outputs
_K5 = [p, ll, ll, i, i, p, p] + [p] * 16 + [p] * 4
#: the C entries of csrc/gru_window_encdec.cu (K5/K5f's one-pass design: T,
#: B, H and the block's batch rows) and of the cluster design's in
#: csrc/gru_window_smem.cu and csrc/gru_window_fast.cu (the same, then the
#: scratch), with their fit queries
ENTRIES = {
    "transducer_window_encdec": (i, _K5 + [i, i, i, i, p]),
    "transducer_window_encdec_fast": (i, _K5 + [i, i, i, i, p]),
    "transducer_window_encdec_smem": (ll, [i] * 5),
    "transducer_window_encdec_max_threads": (i, [i]),
    "transducer_window_encdec_cluster": (i, _K5 + [i, i, i, i, p, p]),
    "transducer_window_encdec_cluster_fast": (i, _K5 + [i, i, i, i, p, p]),
    "transducer_window_encdec_cluster_smem": (ll, [i, i]),
    "transducer_window_encdec_cluster_threads": (i, [i, i]),
    "transducer_window_encdec_cluster_active": (i, [i, i]),
    "transducer_window_encdec_cluster_scratch": (ll, [i] * 4),
    "transducer_window_encdec_cluster_fast_smem": (ll, [i]),
    "transducer_window_encdec_cluster_fast_threads": (i, [i]),
    "transducer_window_encdec_cluster_fast_active": (i, [i]),
    "transducer_window_encdec_cluster_fast_max_h": (i, []),
    "transducer_window_encdec_cluster_fast_scratch": (ll, [i] * 4),
}


def check_fit(lib) -> None:
    """Raise where the cluster design's fit disagrees with the sources'."""
    if (lib.transducer_window_encdec_cluster_fast_max_h() != CLUSTER_FAST_MAX_H
            or any(lib.transducer_window_encdec_cluster_smem(h, r)
                   != cluster_smem_bytes(h, r, False)
                   or lib.transducer_window_encdec_cluster_threads(h, r)
                   != cluster_threads(h, r, False)
                   or lib.transducer_window_encdec_cluster_fast_smem(h)
                   != cluster_smem_bytes(h, r, True)
                   or lib.transducer_window_encdec_cluster_fast_threads(h)
                   != cluster_threads(h, r, True)
                   or lib.transducer_window_encdec_cluster_scratch(h, 300, 100, r)
                   != cluster_scratch_bytes(h, 300, 100, r, False)
                   or lib.transducer_window_encdec_cluster_fast_scratch(h, 300, 100, r)
                   != cluster_scratch_bytes(h, 300, 100, r, True)
                   for h in (1, 37, 64, 100, 128) for r in gs.BLOCK_ROWS)):
        raise RuntimeError("K5's cluster fit disagrees with csrc/gru_window_smem.cu "
                           "or gru_window_fast.cu")


library.register(ENTRIES, check_fit)


# ---------------------------------------------------------------------------
# plain versions (CPU path, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

def transducer_window_encdec_plain(image: torch.Tensor, start: int, T: int,
                                   h0_f: torch.Tensor, h0_b: torch.Tensor,
                                   enc: Layer, dec: Layer) -> Outputs:
    """K5's plain version: K1's plain layer on the window, then K2's on its
    halves, seeded with its final states."""
    of, ob, hf, hb = bigru_window_in1_plain(image, start, T, h0_f, h0_b, enc)
    return bigru_window_in2_plain(of, ob, hf, hb, dec)


def transducer_window_encdec_fast_plain(image: torch.Tensor, start: int, T: int,
                                        h0_f: torch.Tensor, h0_b: torch.Tensor,
                                        enc: Layer, dec: Layer) -> Outputs:
    """K5f's plain version: K1f's plain layer, then K2f's."""
    of, ob, hf, hb = bigru_window_in1_fast_plain(image, start, T, h0_f, h0_b, enc)
    return bigru_window_in2_fast_plain(of, ob, hf, hb, dec)


def transducer_window_encdec_cluster_plain(image: torch.Tensor, start: int, T: int,
                                           h0_f: torch.Tensor, h0_b: torch.Tensor,
                                           enc: Layer, dec: Layer) -> Outputs:
    """The cluster kernel's plain version, parity: for each layer the
    projection summed in k order (``gru_window_smem.window_proj_plain``),
    then the recurrence (``window_rec_plain``); the decoder on the encoder's
    halves from its final states."""
    return _cluster_plain(image, start, T, h0_f, h0_b, enc, dec, False)


def transducer_window_encdec_cluster_fast_plain(image: torch.Tensor, start: int, T: int,
                                                h0_f: torch.Tensor, h0_b: torch.Tensor,
                                                enc: Layer, dec: Layer) -> Outputs:
    """The cluster kernel's plain version in the fast tier: each layer's
    input rounded to bf16 (the image exactly), projected in k order, then
    the fast recurrence (bf16 ``w_hh``)."""
    return _cluster_plain(image, start, T, h0_f, h0_b, enc, dec, True)


def _cluster_plain(image, start, T, h0_f, h0_b, enc, dec, fast) -> Outputs:
    def layer(x, h0f, h0b, params):
        xp = gs.window_proj_plain(bf16_round(x) if fast else x, params)
        return gs.window_rec_plain(xp, h0f, h0b, params)

    of, ob, hf, hb = layer(gs.image_window(image, start, T), h0_f, h0_b, enc)
    return layer(torch.cat([of, ob], dim=-1), hf, hb, dec)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_args(name: str, fast: bool, image, start, T, h0_f, h0_b, enc, dec) -> list:
    """The kernel's arguments checked on the card: the pointers of h0 and of
    both layers' weights."""
    if image.dtype != torch.uint8 or image.dim() != 3 or image.stride(2) != 1:
        raise ValueError(f"{name} takes a (B, L, F) uint8 image with unit feature stride")
    dev = image.device
    B, L, F = image.shape
    H = h0_f.shape[-1]
    if not (0 <= start and start + T <= L and T > 0):
        raise ValueError(f"window [{start}, {start + T}) of {L} columns")
    check("h0_f", h0_f, (B, H), torch.float32, dev)
    check("h0_b", h0_b, (B, H), torch.float32, dev)
    wdtype = torch.bfloat16 if fast else torch.float32
    return ([image.data_ptr(), image.stride(0), image.stride(1), start, F,
             h0_f.data_ptr(), h0_b.data_ptr()]
            + layer_args(enc, F, H, dev, wdtype) + layer_args(dec, 2 * H, H, dev, wdtype))


def _launch_cluster(fast: bool, image, start, T, h0_f, h0_b, enc, dec) -> Outputs:
    """One launch of the cluster kernel (the shape already checked by
    :func:`encdec_design`), counted under its name."""
    name = "transducer_window_encdec_cluster" + ("_fast" if fast else "")
    args = _check_args(name, fast, image, start, T, h0_f, h0_b, enc, dec)
    dev = image.device
    B, H = image.shape[0], h0_f.shape[-1]
    rows = gs.rec_block_rows(B)
    if not cluster_active(H, B, fast):
        raise RuntimeError(f"{name}: the card holds no cluster of two "
                           f"{cluster_threads(H, rows, fast)}-thread CTAs with "
                           f"{cluster_smem_bytes(H, rows, fast)} bytes of shared memory each")
    scratch = torch.empty(cluster_scratch_bytes(H, B, T, rows, fast), dtype=torch.uint8,
                          device=dev)
    outs = outputs(T, B, H, dev)
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            *args, *[o.data_ptr() for o in outs], T, B, H, rows, scratch.data_ptr(), stream(dev))
    raise_on(err, name)
    launch_counts[name] += 1
    return outs


def _launch_onepass(name: str, fast: bool, image, start, T, h0_f, h0_b, enc, dec) -> Outputs:
    """One launch of the one-pass kernel at :func:`encdec_block_rows` rows
    per block, counted under ``<name>`` with ``_onepass`` before ``_fast``."""
    args = _check_args(name, fast, image, start, T, h0_f, h0_b, enc, dec)
    dev = image.device
    B, _, F = image.shape
    H = h0_f.shape[-1]
    bt = encdec_block_rows(H, F, T, fast, device_smem_budget())
    outs = outputs(T, B, H, dev)
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            *args, *[o.data_ptr() for o in outs], T, B, H, bt, stream(dev))
    raise_on(err, name)
    launch_counts["transducer_window_encdec_onepass" + ("_fast" if fast else "")] += 1
    return outs


def _encdec(name: str, fast: bool, image, start, T, h0_f, h0_b, enc, dec,
            design=None) -> Outputs:
    on_cuda = image.device.type == "cuda"
    if not on_cuda and image.device.type != "cpu":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {image.device}")
    F, H = image.shape[-1], h0_f.shape[-1]
    chosen = encdec_design(H, image.shape[0], fast, design)
    if chosen == "onepass":
        budget = device_smem_budget() if on_cuda else HOPPER_SMEM_OPTIN
        if not encdec_block_rows(H, F, T, fast, budget):
            raise ValueError(
                f"{name}: H={H}, T={T}, F={F} does not fit one block's {budget} bytes of "
                f"shared memory ({encdec_smem_bytes(H, 1, F, T, fast)} at 1 row) or "
                f"{encdec_max_threads(1)} threads; the chained kernels take it: "
                'route="inproj"')
    if not on_cuda:
        plain = transducer_window_encdec_fast_plain if fast else transducer_window_encdec_plain
        return plain(image, start, T, h0_f, h0_b, enc, dec)
    if chosen == "cluster":
        outs = _launch_cluster(fast, image, start, T, h0_f, h0_b, enc, dec)
    else:
        outs = _launch_onepass(name, fast, image, start, T, h0_f, h0_b, enc, dec)
    launch_counts[name] += 1
    return outs


def transducer_window_encdec(image: torch.Tensor, start: int, T: int,
                             h0_f: torch.Tensor, h0_b: torch.Tensor,
                             enc: Layer, dec: Layer, design=None) -> Outputs:
    """K5: the encoder layer ``enc`` over the window ``image[:, start:start+T]``
    of a ``(B, L, F)`` uint8 image from ``h0_f``/``h0_b``, then the decoder
    layer ``dec`` on its halves from its final states, in one launch, in the
    design :func:`encdec_design` picks (``design`` forces one). Returns the
    decoder's outputs. See the module docstring."""
    return _encdec("transducer_window_encdec", False, image, start, T, h0_f, h0_b, enc, dec,
                   design)


def transducer_window_encdec_fast(image: torch.Tensor, start: int, T: int,
                                  h0_f: torch.Tensor, h0_b: torch.Tensor,
                                  enc: Layer, dec: Layer, design=None) -> Outputs:
    """K5f: K5 in the fast tier, with both layers' bf16 ``w_ih``/``w_hh``."""
    return _encdec("transducer_window_encdec_fast", True, image, start, T, h0_f, h0_b,
                   enc, dec, design)


def _cluster(fast: bool, image, start, T, h0_f, h0_b, enc, dec) -> Outputs:
    name = "transducer_window_encdec_cluster" + ("_fast" if fast else "")
    if image.device.type == "cpu":
        plain = (transducer_window_encdec_cluster_fast_plain if fast
                 else transducer_window_encdec_cluster_plain)
        return plain(image, start, T, h0_f, h0_b, enc, dec)
    cuda_device(image, name)
    encdec_design(h0_f.shape[-1], image.shape[0], fast, "cluster")
    return _launch_cluster(fast, image, start, T, h0_f, h0_b, enc, dec)


def transducer_window_encdec_cluster(image: torch.Tensor, start: int, T: int,
                                     h0_f: torch.Tensor, h0_b: torch.Tensor,
                                     enc: Layer, dec: Layer) -> Outputs:
    """The cluster kernel of K5 alone: its plain version on a CPU tensor,
    one launch on a CUDA tensor (raising where :func:`encdec_design` does
    not take the shape)."""
    return _cluster(False, image, start, T, h0_f, h0_b, enc, dec)


def transducer_window_encdec_cluster_fast(image: torch.Tensor, start: int, T: int,
                                          h0_f: torch.Tensor, h0_b: torch.Tensor,
                                          enc: Layer, dec: Layer) -> Outputs:
    """The cluster kernel of K5f alone, as :func:`transducer_window_encdec_cluster`."""
    return _cluster(True, image, start, T, h0_f, h0_b, enc, dec)


def transducer_apply_fused_encdec(enc_params: Layer, dec_params: Layer, x: torch.Tensor,
                                  h0_fwd: torch.Tensor, h0_bwd: torch.Tensor,
                                  fast: bool = False, exact_input: bool = False) -> Outputs:
    """helen_tpu's ``transducer_apply_fused_encdec`` (``gru_pallas.py:1005``),
    with its signature: one window of a 1-layer transducer, ``x`` ``(T, B, D)``
    time-major (uint8 on the card), through K5 (K5f with ``fast``; float32
    layers are cast by :func:`io.checkpoint.fast_layer`). ``x`` reaches the
    kernel as a strided ``(B, T, D)`` view, not a copy. ``exact_input`` is
    helen_tpu's promise that ``x`` is exact in bf16, which its TPU
    projection needs; the port's projection is float32 FMA, exact for such
    values either way, so it changes nothing here. Returns the decoder's
    ``(out_f, out_b, hf, hb)``."""
    del exact_input
    image = x.permute(1, 0, 2)
    if fast:
        enc_params, dec_params = (p if p["fwd"]["w_hh"].dtype == torch.bfloat16
                                  else fast_layer(p) for p in (enc_params, dec_params))
        return transducer_window_encdec_fast(image, 0, x.shape[0], h0_fwd, h0_bwd,
                                             enc_params, dec_params)
    return transducer_window_encdec(image, 0, x.shape[0], h0_fwd, h0_bwd, enc_params,
                                    dec_params)
