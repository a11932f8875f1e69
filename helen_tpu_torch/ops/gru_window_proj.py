"""The xp route's input projection: binding, launch counters and plain
version.

:func:`bigru_window_xp_proj` computes, for one bi-GRU layer over one window,
both directions' input projections ``xp[d] = x @ W_ih[d] + b_ih[d]`` in one
launch of ``csrc/gru_window_proj.cu`` (built into the one kernel library
with the other window kernels, ``library.build_kernels``), into one
``(2, T, B, 3H)`` buffer whose two halves K3 (``ops.gru_window_xp``) takes
as they are. It replaces no Pallas body: helen_tpu leaves this product to
XLA's dot (``bigru_apply_fused``), and the port had it as two float32
``torch.matmul`` calls, their bias adds and the cat or cast of the layer's
input.

The layer's input ``src`` is read where it lies (:data:`Source`):
the ``(B, L, F)`` uint8 image at column ``start + t`` (a float32 image the
same way), or the pair ``(xa, xb)`` of the previous layer's ``(T, B, H)``
halves, row ``[xa | xb]``, with no ``torch.cat``.

The kernel's product is 3xTF32 on the tensor cores (``wgmma``): each
product is ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` with ``hi`` the value
rounded to TF32 (nearest, ties away) and ``lo`` the rest rounded likewise,
about fp32's accuracy and never single-pass TF32's; the uint8 image is
exact in TF32 (``lo = 0``), so layer 0 runs two products. Each chunk of
:data:`CHUNK` columns of the sum is taken in the tensor cores from zero and
added to float32 running sums rounded to nearest; the bias is added once,
at the end, as ``x @ w + b`` adds it. Its order of sums is not
``torch.matmul``'s (cuBLAS's order is unspecified too), so it is held to a
float64 product by its error, not to a plain version by its bits
(tests/test_torch_cuda.py).

The weights reach the kernel split: :func:`split_weights` keeps W_ih's hi
and lo parts for both directions side by side, K-major ``(2, 6H, KP)``
(``tf32`` ``wgmma`` takes both operands K-major), ``KP`` a whole number of
chunks with zero rows at each half's pad (:func:`proj_rows`). One launch of
``bigru_window_xp_proj_split`` makes them; they are cached on the forward
direction's ``w_ih`` tensor, keyed by both tensors and their version
counters, so inference splits once per weights and a training step's
in-place Adam update makes the next window split again, into the same
buffer.

On a CPU tensor :func:`bigru_window_xp_proj` computes its plain version,
:func:`bigru_window_xp_proj_plain`, today's expression of the route (the
layer input as :func:`window_input` makes it, ``@ w_ih + b_ih``
per direction), so CPU results are what they were; on a CUDA tensor it
launches the kernel or raises. Each launch adds one to
:data:`launch_counts` under its name, each split under its own.
"""
from __future__ import annotations

from ctypes import c_int as i, c_longlong as ll, c_void_p as p
from typing import Dict, List, Tuple, Union

import torch

from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.library import Layer, check, cuda_device, empty, get_lib, raise_on, stream

#: a window layer's input: the ``(B, L, F)`` image read at column ``start``
#: (layer 0), or the pair ``(xa, xb)`` of the previous layer's ``(T, B, H)``
#: halves
Source = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]

#: columns of the sum per chunk (csrc/gru_window_proj.cu XJ_BK): the split
#: weights' rows come in whole chunks
CHUNK = 32
#: the kernel's source kinds (csrc/gru_window_proj.cu XJ_U8, XJ_F32, XJ_PAIR)
U8, F32, PAIR = 0, 1, 2
#: launches since the last reset_launch_counts() — counted where the kernel
#: is launched and nowhere else
launch_counts: Dict[str, int] = {"bigru_window_xp_proj": 0,
                                 "bigru_window_xp_proj_split": 0}
#: the attribute of the forward direction's ``w_ih`` that caches the split
_CACHE = "_xp_proj_split"
#: the C entries of csrc/gru_window_proj.cu: the projection (the source, the
#: split weights, the biases, the output), the split, the chunk
ENTRIES = {"bigru_window_xp_proj": (i, [i, p, p, ll, ll, i, ll, p, i] + [p] * 3 + [i] * 4
                                    + [p]),
           "bigru_window_xp_proj_split": (i, [p, p] + [i] * 4 + [p, p]),
           "bigru_window_xp_proj_chunk": (i, [])}


def check_fit(lib) -> None:
    """Raise where :data:`CHUNK` disagrees with the source's."""
    if lib.bigru_window_xp_proj_chunk() != CHUNK:
        raise RuntimeError("CHUNK disagrees with csrc/gru_window_proj.cu")


library.register(ENTRIES, check_fit)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def window_input(src: Source, start: int, T: int, dtype) -> torch.Tensor:
    """The layer's time-major input ``(T, B, D)`` as a float tensor."""
    if isinstance(src, tuple):
        return torch.cat([src[0], src[1]], dim=-1).to(dtype)
    return src[:, start:start + T].to(dtype).transpose(0, 1)


def bigru_window_xp_proj_plain(src: Source, start: int, T: int, layer: Layer,
                               dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projection as plain torch ops: ``x @ w_ih + b_ih`` per direction,
    ``x`` the layer's ``(T, B, D)`` input in ``dtype``."""
    x = window_input(src, start, T, dtype)
    f, b = layer["fwd"], layer["bwd"]
    return x @ f["w_ih"] + f["b_ih"], x @ b["w_ih"] + b["b_ih"]


def proj_rows(D: int, H: int, pair: bool) -> List[int]:
    """The row of ``W_ih`` (D, 3H) behind each row ``k`` of the split
    weights' ``KP``, or -1 at a pad: a pair's halves each padded to whole
    chunks, any other input once at its end."""
    def padded(rows):
        return rows + [-1] * (-len(rows) % CHUNK)

    if pair:
        return padded(list(range(H))) + padded(list(range(H, 2 * H)))
    return padded(list(range(D)))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32, nearest with ties away from zero: half a
    TF32 ulp added to the bits, the 13 bits TF32 drops cleared
    (csrc/gru_window_common.cuh ``tf32_rna``)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_weights_plain(layer: Layer, pair: bool) -> torch.Tensor:
    """The kernel's weights as plain torch ops, bit for bit
    ``bigru_window_xp_proj_split``'s: ``(2, 6H, KP)`` float32, ``[hi, lo]``,
    row ``col`` the column of ``[W_f | W_b]``, its ``KP`` entries the rows
    :func:`proj_rows` names (zeros at a pad)."""
    f, b = layer["fwd"]["w_ih"], layer["bwd"]["w_ih"]
    D, H3 = f.shape
    w = torch.cat([f, b], dim=1)
    w = torch.cat([w, w.new_zeros(1, 2 * H3)])[proj_rows(D, H3 // 3, pair)]
    wt = w.t().contiguous()
    hi = tf32_rna(wt)
    return torch.stack([hi, tf32_rna(wt - hi)])


def split_weights(layer: Layer, pair: bool, device) -> torch.Tensor:
    """The split weights of ``layer`` on the card, made by one launch of
    ``bigru_window_xp_proj_split`` unless the cache on the forward
    direction's ``w_ih`` holds them for these tensors at these versions.
    Where only the versions moved (an in-place update), the launch writes
    the cached buffer again: the launches that read it are on the same
    stream, before it."""
    f, b = layer["fwd"]["w_ih"], layer["bwd"]["w_ih"]
    tensors = (pair, f.data_ptr(), b.data_ptr())
    cached = f.__dict__.get(_CACHE)
    if cached is not None and cached[0] == (*tensors, f._version, b._version):
        return cached[1]
    D, H3 = f.shape
    H = H3 // 3
    kp = len(proj_rows(D, H, pair))
    shape = (2, 2 * H3, kp)
    if cached is not None and cached[0][:3] == tensors and cached[1].shape == shape:
        out = cached[1]
    else:
        out = empty(device, *shape)
    name = "bigru_window_xp_proj_split"
    with torch.cuda.device(device):
        err = get_lib().bigru_window_xp_proj_split(
            f.data_ptr(), b.data_ptr(), D, H, int(pair), kp, out.data_ptr(), stream(device))
    raise_on(err, name)
    launch_counts[name] += 1
    f.__dict__[_CACHE] = ((*tensors, f._version, b._version), out)
    return out


def _source_args(src: Source, start: int, T: int, H: int, dev) -> tuple:
    """(kind, a0, a1, sb, sl, extent, B, D) of the kernel's source, checked."""
    if isinstance(src, tuple):
        xa, xb = src
        if xa.dim() != 3:
            raise ValueError(f"xa must be (T, B, H), got {tuple(xa.shape)}")
        B = xa.shape[1]
        check("xa", xa, (T, B, H), torch.float32, dev)
        check("xb", xb, (T, B, H), torch.float32, dev)
        return PAIR, xa.data_ptr(), xb.data_ptr(), 0, 0, 0, B, 2 * H
    if src.dim() != 3 or src.stride(2) != 1 or src.dtype not in (torch.uint8, torch.float32):
        raise ValueError("the image must be (B, L, F) uint8 or float32 with unit feature "
                         f"stride, got {tuple(src.shape)} {src.dtype}")
    if src.device != dev:
        raise ValueError(f"the image is on {src.device}, expected {dev}")
    B, L, D = src.shape
    if not (0 <= start and start + T <= L):
        raise ValueError(f"window [{start}, {start + T}) of {L} columns")
    storage = src.untyped_storage()
    if storage.data_ptr() % 16:
        raise ValueError("the image's storage must be 16-byte aligned")
    extent = storage.nbytes() - src.storage_offset() * src.element_size()
    kind = U8 if src.dtype == torch.uint8 else F32
    return kind, src.data_ptr(), None, src.stride(0), src.stride(1), extent, B, D


def bigru_window_xp_proj(src: Source, start: int, T: int, layer: Layer,
                         dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xp_f, xp_b)``, each ``(T, B, 3H)``: the layer's input projections.
    On the CPU the plain version in ``dtype``; on a CUDA device one launch
    of the kernel (float32 only), the two outputs the halves of one
    ``(2, T, B, 3H)`` buffer. ``layer`` holds ``{"fwd", "bwd"}`` of ``w_ih
    (D, 3H)`` and ``b_ih (3H,)`` float32; ``src``, ``start``, ``T`` as in
    :func:`window_input`. See the module docstring."""
    first = src[0] if isinstance(src, tuple) else src
    if first.device.type == "cpu":
        return bigru_window_xp_proj_plain(src, start, T, layer, dtype)
    name = "bigru_window_xp_proj"
    dev = cuda_device(first, name)
    if dtype != torch.float32:
        raise TypeError(f"{name} computes in float32, not {dtype}")
    H3 = layer["fwd"]["w_ih"].shape[-1]
    if H3 % 3:
        raise ValueError(f"w_ih must be (D, 3H), got {tuple(layer['fwd']['w_ih'].shape)}")
    H = H3 // 3
    kind, a0, a1, sb, sl, extent, B, D = _source_args(src, start, T, H, dev)
    for d in ("fwd", "bwd"):
        check(f"{d}.w_ih", layer[d]["w_ih"], (D, H3), torch.float32, dev)
        check(f"{d}.b_ih", layer[d]["b_ih"], (H3,), torch.float32, dev)
    w = split_weights(layer, kind == PAIR, dev)
    out = empty(dev, 2, T, B, H3)
    with torch.cuda.device(dev):
        err = get_lib().bigru_window_xp_proj(
            kind, a0, a1, sb, sl, start, extent, w.data_ptr(), w.shape[-1],
            layer["fwd"]["b_ih"].data_ptr(), layer["bwd"]["b_ih"].data_ptr(),
            out.data_ptr(), T, B, D, H, stream(dev))
    raise_on(err, name)
    launch_counts[name] += 1
    return out[0], out[1]
