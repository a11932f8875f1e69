"""The transducer: bi-GRU encoder -> bi-GRU decoder -> two linear heads.

Port of helen_tpu/models/transducer.py, as plain functions on the param tree
of tensors that io.checkpoint.params_to_torch builds: ``encoder`` and
``decoder`` stacks (layer 0 under {"fwd", "bwd"}, deeper layers under "l1",
"l2", ...), ``base_head`` and ``rle_head`` ({"w" (2H, C), "b" (C,)}).

Every bi-GRU window runs through the window kernels (backend ``"cuda"``)
or their plain versions (backend ``"torch"``). The ``"cuda"`` backend has
two routes, chosen by :func:`kernel_route` from the hidden size:

* ``"inproj"`` (H <= MAX_H = 512): the in-projection kernels of
  ops.gru_window. Layer 0 of the encoder reads the window straight from the
  uint8 image (K1), every later layer — deeper encoder layers and the whole
  decoder — reads the previous layer's two output halves (K2), so no concat
  or projection array is built between layers;
* ``"xp"`` (MAX_H < H <= XP_MAX_H = 1024, the wide models): each layer's
  input projection is one float32 matrix product per direction in torch,
  and only the recurrence runs in a kernel (K3, ops.gru_window_xp), as
  helen_tpu's xp-stream kernels do.

A third family, ``"encdec"`` (ops.gru_window_encdec: K5, and K5f in the
fast tier), runs the whole window of a model with one encoder and one
decoder layer in one launch, the encoder's outputs held on chip. No rule
picks it: only ``route="encdec"`` does (library only, inference only), as
helen_tpu keeps its fused kernel off its dispatch (its
``models/transducer.py:168-175``).

The windows go through the autograd Functions of ops.gru_window_autograd,
so the same ``forward`` trains: its backward is the hand-written backward
kernel of the route (ops.gru_window_bwd, ops.gru_window_xp_bwd). On
``"torch"`` torch's autograd differentiates the plain ops.

The fast tier (helen_tpu's ``pallas_fast``; inference only) is backend
``"cuda_fast"``, with the same two routes: K1f/K2f (ops.gru_window) up to
H=512, the fast xp layer (projection GEMMs, K3f; ops.gru_window_xp) up to
1024; ``"torch_fast"`` runs their plain versions. Both take the bf16 weight
copies of io.checkpoint.fast_weights, made once per consensus call; the
heads and the softmax vote stay float32 on every backend.

Hidden-state contract (the reference's "transducer windowing",
predict_gpu.py:99-129): the hidden is (B, 2L, H), layer-major (slot 2l is
layer l's forward direction, 2l+1 its backward one); the encoder's final
states seed the decoder layer for layer, and the decoder's final states
seed the next window's encoder. :func:`consensus_probs` replays the
reference's sliding-window loop and sums the per-column softmax votes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from helen_tpu_torch.config import MODEL, WINDOW, ModelConfig, WindowConfig
from helen_tpu_torch.io.checkpoint import fast_weights
from helen_tpu_torch.ops.gru_window import (
    MAX_H,
    XP_MAX_H,
    bigru_window_in1_fast,
    bigru_window_in1_fast_plain,
    bigru_window_in1_plain,
    bigru_window_in2_fast,
    bigru_window_in2_fast_plain,
    bigru_window_in2_plain,
)
from helen_tpu_torch.ops.gru_window_autograd import window_in1, window_in2, window_xp
from helen_tpu_torch.ops.gru_window_encdec import (
    transducer_window_encdec,
    transducer_window_encdec_fast,
)
from helen_tpu_torch.ops.gru_window_xp import window_xp_fast, window_xp_fast_plain

Params = Dict[str, Any]

#: resolved backends: the window kernels and their plain versions, in the
#: parity tier and in the fast (bf16) tier
BACKENDS = ("cuda", "torch", "cuda_fast", "torch_fast")
FAST_BACKENDS = ("cuda_fast", "torch_fast")
#: helen_tpu's backend names on each surface (``helen_tpu/cli.py:34-36``,
#: ``transducer.py:427-428``) and what they mean in the port: "auto" is the
#: kernels on a CUDA device and the plain versions on the CPU, "fast" the
#: same in the fast tier
INFER_ALIASES = {"xla": "torch", "pallas": "auto", "pallas_fast": "fast"}
TRAIN_ALIASES = {"xla": "torch", "pallas_train": "cuda"}
#: the kernel families of the "cuda" backend and the largest hidden size
#: each takes ("encdec": 2H threads per block; its shared memory bounds H
#: further, by the window, ops.gru_window_encdec.encdec_fits_smem)
ROUTES = {"inproj": MAX_H, "xp": XP_MAX_H, "encdec": MAX_H}


def set_fp32_precision() -> None:
    """Keep every float32 product in true fp32 on the card: the parity tier
    never runs single-pass TF32 (its ~3 decimal digits flip near-tie votes —
    the Hopper form of helen_tpu's "fp32 parity trap")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_fp32_precision(device) -> None:
    """Refuse to run a float32 product of the parity tier on the card under
    TF32: the xp route moves each layer's input projection into
    ``torch.matmul``, so every entry that reaches it calls
    :func:`set_fp32_precision` first."""
    if torch.device(device).type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on for float32 matmuls, and the xp route's "
                           "projections must run in true fp32: call "
                           "set_fp32_precision() first")


def kernel_route(hidden_size: int, route: Optional[str] = None) -> str:
    """THE dispatch predicate of the ``"cuda"`` backend, shared by
    :func:`forward` (which acts on it), :func:`engaged_kernel` (which
    records it) and :func:`resolve_backend` (which refuses what it
    refuses): ``"inproj"`` for H <= MAX_H, ``"xp"`` for MAX_H < H <=
    XP_MAX_H. ``route`` forces one family (library only, for testing;
    ``"encdec"`` only ever by this argument); a hidden size the family
    does not take raises, past XP_MAX_H naming ``--backend torch``.
    Nothing falls back."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {tuple(ROUTES)}")
    chosen = route or ("inproj" if hidden_size <= MAX_H else "xp")
    if not 0 < hidden_size <= ROUTES[chosen]:
        if chosen == "encdec":
            raise ValueError(f"hidden_size {hidden_size} exceeds the encdec kernel's maximum "
                             f"{MAX_H} (2H threads per block)")
        family = "window kernels'" if route is None else f"{route} window kernels'"
        raise ValueError(f"hidden_size {hidden_size} exceeds the {family} maximum "
                         f"{ROUTES[chosen]} (forward and backward); use --backend torch")
    return chosen


def engaged_kernel(params: Params, backend: str, route: Optional[str] = None) -> str:
    """Which kernel family :func:`forward` runs for ``(params, backend,
    route)`` (helen_tpu's ``engaged_kernel``, ``transducer.py:431``):
    ``"torch"`` (the plain versions), ``"cuda_inproj"`` (K1/K2 and their
    backward), ``"cuda_xp"`` (projection GEMMs, K3/K4), ``"cuda_encdec"``
    (K5, forced only), and in the fast tier ``"cuda_fast_inproj"``
    (K1f/K2f), ``"cuda_fast_xp"`` (projection GEMMs, K3f),
    ``"cuda_fast_encdec"`` (K5f) or ``"torch_fast"`` (their plain
    versions). The backend must be resolved already
    (:func:`resolve_backend`). ``"encdec"`` takes one encoder and one
    decoder layer, as helen_tpu's fused entry does
    (``gru_pallas.py:1019-1020``); a deeper model raises."""
    if backend in ("torch", "torch_fast"):
        if route is not None:
            raise ValueError("route selects the kernels of backend 'cuda' or 'cuda_fast'")
        return backend
    if backend not in ("cuda", "cuda_fast"):
        raise ValueError(f"unresolved backend {backend!r}")
    chosen = kernel_route(model_geometry(params).hidden_size, route)
    if chosen == "encdec":
        layers = (len(_stack_layers(params["encoder"])), len(_stack_layers(params["decoder"])))
        if layers != (1, 1):
            raise ValueError(f"route 'encdec' takes one encoder and one decoder layer, "
                             f"got {layers[0]} and {layers[1]}; the chained kernels take "
                             'them: route="inproj"')
    return f"{backend}_{chosen}"


def _stack_layers(stack: Params) -> List[Params]:
    """Per-layer [{"fwd", "bwd"}, ...] view of one GRU stack's params."""
    layers = [{"fwd": stack["fwd"], "bwd": stack["bwd"]}]
    i = 1
    while f"l{i}" in stack:
        layers.append(stack[f"l{i}"])
        i += 1
    return layers


def model_geometry(params: Params) -> ModelConfig:
    """Model dimensions recovered from the param shapes (helen_tpu
    transducer.py:79)."""
    enc = params["encoder"]
    return ModelConfig(
        hidden_size=int(enc["fwd"]["w_hh"].shape[0]),
        gru_layers=len(_stack_layers(enc)),
        input_features=int(enc["fwd"]["w_ih"].shape[0]),
        num_base_classes=int(params["base_head"]["w"].shape[-1]),
        num_rle_classes=int(params["rle_head"]["w"].shape[-1]),
    )


def init_params(generator: torch.Generator, cfg: ModelConfig = MODEL) -> Params:
    """A fresh param tree in float32 on the CPU, with the distributions of
    helen_tpu's ``init_params``: every GRU tensor uniform(-1/sqrt(H),
    1/sqrt(H)) (``models/gru.py:33-43``, torch's nn.GRU init), each head
    uniform(-1/sqrt(in), 1/sqrt(in)) with in = 2H (``transducer.py:30-66``).
    Draws come from ``generator`` in a fixed order; the values differ from
    ``jax.random``'s."""
    if not cfg.bidirectional or cfg.gru_layers < 1:
        raise ValueError("the transducer is a stack of >= 1 bidirectional GRUs")
    h = cfg.hidden_size

    def uniform(k: float, *shape) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (u * 2.0 - 1.0) * k

    def bigru(input_dim: int) -> Params:
        k = 1.0 / h ** 0.5
        return {d: {"w_ih": uniform(k, input_dim, 3 * h), "w_hh": uniform(k, h, 3 * h),
                    "b_ih": uniform(k, 3 * h), "b_hh": uniform(k, 3 * h)}
                for d in ("fwd", "bwd")}

    def stack(input_dim: int) -> Params:
        s = bigru(input_dim)
        for i in range(1, cfg.gru_layers):
            s[f"l{i}"] = bigru(2 * h)
        return s

    def linear(out_dim: int) -> Params:
        k = 1.0 / (2 * h) ** 0.5
        return {"w": uniform(k, 2 * h, out_dim), "b": uniform(k, out_dim)}

    return {"encoder": stack(cfg.input_features), "decoder": stack(2 * h),
            "base_head": linear(cfg.num_base_classes),
            "rle_head": linear(cfg.num_rle_classes)}


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The param tensors in sorted key-path order — jax's tree_leaves order
    for a dict tree, so optimizer state lines up with helen_tpu's."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    return [params]


def num_params(params: Params) -> int:
    return sum(int(p.numel()) for p in param_leaves(params))


def init_hidden(batch_size: int, cfg: ModelConfig, device=None) -> torch.Tensor:
    """Zero hidden state (B, 2L, H) in the layer-major layout."""
    return torch.zeros((batch_size, 2 * cfg.gru_layers, cfg.hidden_size),
                       dtype=torch.float32, device=device)


def _apply_heads(params: Params, dec_out: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both classifier heads as one fused (2H, nb+nr) product, split after
    (helen_tpu transducer.py:109; each output column is independent, so
    this equals two separate products)."""
    wb, wr = params["base_head"]["w"], params["rle_head"]["w"]
    nb = wb.shape[1]
    w = torch.cat([wb, wr], dim=1)
    b = torch.cat([params["base_head"]["b"], params["rle_head"]["b"]])
    both = dec_out @ w + b
    return both[..., :nb], both[..., nb:]


def resolve_backend(requested: Optional[str], device: torch.device,
                    params: Optional[Params] = None, kind: str = "infer") -> str:
    """Resolve a --backend value to one of :data:`BACKENDS`: ``"cuda"``
    (the window kernels), ``"torch"`` (their plain versions), or the fast
    tier's ``"cuda_fast"``/``"torch_fast"``.

    ``None``/``"auto"`` picks the kernels on a CUDA device and the plain
    versions on the CPU; ``"fast"`` does the same in the fast tier. The
    inference surface takes helen_tpu's names (:data:`INFER_ALIASES`:
    ``xla`` is ``torch``, ``pallas`` is ``auto``, ``pallas_fast`` is
    ``fast``), the train surface its own (:data:`TRAIN_ALIASES`); the fast
    tier is not a train backend, as in helen_tpu. A kernel backend off a
    CUDA device, or on a geometry its kernels do not take, raises: nothing
    falls back, to another tier or to another device.

    With ``params``, a kernel backend also needs a hidden size the kernels
    take (:func:`kernel_route`: up to ``XP_MAX_H``, forward and backward)."""
    if kind not in ("infer", "train"):
        raise ValueError(f"kind must be 'infer' or 'train', got {kind!r}")
    fast = INFER_ALIASES.get(requested, requested) in ("fast",) + FAST_BACKENDS
    if kind == "train" and fast:
        raise ValueError(f"backend {requested!r} is not a train backend: the fast "
                         "(bf16) tier is inference only")
    aliases = INFER_ALIASES if kind == "infer" else TRAIN_ALIASES
    requested = aliases.get(requested, requested)
    allowed = ("auto", "cuda", "torch") + (("fast",) + FAST_BACKENDS if kind == "infer"
                                           else ())
    if requested not in (None,) + allowed:
        raise ValueError(f"backend {requested!r} is not one of {allowed + tuple(aliases)}")
    on_cuda = torch.device(device).type == "cuda"
    if requested in (None, "auto", "fast"):
        requested = ("cuda" if on_cuda else "torch") + ("_fast" if fast else "")
    if requested in ("cuda", "cuda_fast"):
        if not on_cuda:
            raise ValueError(f"backend {requested!r} needs a CUDA device, got {device}")
        if params is not None:
            kernel_route(model_geometry(params).hidden_size)
    return requested


#: the layer functions of each kernel family: (layer 0 on the image, later
#: layers on the previous layer's halves), or (both kinds, None) on an xp
#: route
_LAYERS = {
    "torch": (bigru_window_in1_plain, bigru_window_in2_plain),
    "cuda_inproj": (window_in1, window_in2),
    "cuda_xp": (window_xp, None),
    "cuda_fast_inproj": (bigru_window_in1_fast, bigru_window_in2_fast),
    "cuda_fast_xp": (window_xp_fast, None),
    "torch_fast_inproj": (bigru_window_in1_fast_plain, bigru_window_in2_fast_plain),
    "torch_fast_xp": (window_xp_fast_plain, None),
}


def forward(
    params: Params,
    x: torch.Tensor,
    hidden: torch.Tensor,
    backend: str = "torch",
    start: int = 0,
    window: Optional[int] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One window of the transducer.

    :param x: (B, L, F) image, uint8 or float; the window is columns
        ``[start, start + window)`` (``window`` defaults to all L columns,
        so a (B, W, F) window with the defaults is helen_tpu's ``forward``)
    :param hidden: (B, 2L, H) carried hidden, layer-major
    :param backend: ``"cuda"`` (window kernels, differentiable through the
        backward kernels), ``"torch"`` (plain ops, differentiated by torch),
        or the fast tier's ``"cuda_fast"``/``"torch_fast"`` (inference
        only: they raise with grad enabled; a float32 ``params`` tree is
        cast by :func:`io.checkpoint.fast_weights` in each call, so pass a
        fast tree to call this per window)
    :param route: the kernel family of ``"cuda"``/``"cuda_fast"``,
        ``"inproj"``, ``"xp"`` or ``"encdec"`` (the whole window in one
        launch, inference only: it raises with grad enabled, and for a
        window its shared memory does not hold); None takes
        :func:`kernel_route`'s rule, which never picks ``"encdec"``
    :returns: (base logits (B, W, nb), rle logits (B, W, nr), new hidden
        (B, 2L, H))
    """
    kernels = engaged_kernel(params, backend, route)
    if backend in FAST_BACKENDS:
        if torch.is_grad_enabled():
            raise RuntimeError(f"backend {backend!r} is inference only (the fast tier "
                               "has no backward): run it under torch.no_grad()")
        params = fast_weights(params)
        if kernels == "torch_fast":
            # the plain versions of the kernels the rule picks, with no upper
            # limit on H
            kernels += "_inproj" if model_geometry(params).hidden_size <= MAX_H else "_xp"
    T = x.shape[1] - start if window is None else window

    def h0(li):
        return hidden[:, 2 * li].contiguous(), hidden[:, 2 * li + 1].contiguous()

    if kernels.endswith("_encdec"):
        if torch.is_grad_enabled():
            raise RuntimeError("route 'encdec' is inference only (helen_tpu's fused kernel "
                               "has no backward): run it under torch.no_grad()")
        fused = (transducer_window_encdec_fast if backend in FAST_BACKENDS
                 else transducer_window_encdec)
        of, ob, hf, hb = fused(x, start, T, *h0(0), _stack_layers(params["encoder"])[0],
                               _stack_layers(params["decoder"])[0])
        return _window_out(params, of, ob, [(hf, hb)])
    if kernels.endswith("_xp"):
        require_fp32_precision(x.device)
    in1, in2 = _LAYERS[kernels]
    if in2 is None:  # an xp route: one layer function for both layer kinds
        in2 = lambda xa, xb, h0f, h0b, lp: in1(  # noqa: E731
            (xa, xb), 0, xa.shape[0], h0f, h0b, lp)
    enc = _stack_layers(params["encoder"])
    of, ob, hf, hb = in1(x, start, T, *h0(0), enc[0])
    enc_finals = [(hf, hb)]
    for li, lp in enumerate(enc[1:], start=1):
        of, ob, hf, hb = in2(of, ob, *h0(li), lp)
        enc_finals.append((hf, hb))
    dec_finals = []
    for li, lp in enumerate(_stack_layers(params["decoder"])):
        of, ob, hf, hb = in2(of, ob, *enc_finals[li], lp)
        dec_finals.append((hf, hb))
    return _window_out(params, of, ob, dec_finals)


def _window_out(params: Params, of: torch.Tensor, ob: torch.Tensor,
                dec_finals: List[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The heads on the decoder's time-major (T, B, 2H) output, logits moved
    to (B, T, C), and the new hidden from the decoder's final states."""
    base, rle = _apply_heads(params, torch.cat([of, ob], dim=-1))
    new_hidden = torch.stack([h for pair in dec_finals for h in pair], dim=1)
    return base.transpose(0, 1), rle.transpose(0, 1), new_hidden


def consensus_probs(
    params: Params,
    images: torch.Tensor,
    window_cfg: WindowConfig = WINDOW,
    backend: str = "torch",
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-image consensus: sliding windows + softmax-sum overlap voting.

    Replays the reference inference loop (predict_gpu.py:114-149): windows
    start at 0, jump, 2*jump, ... while start + window <= L; the decoder
    hidden carries between windows; each window's per-column softmax is
    added, in window order and in fp32, to (B, L, C) vote tensors.

    :param images: (B, L, F) uint8 (the in-projection kernels take uint8
        only; the plain route also takes float)
    :param route: as in :func:`forward`
    :returns: (base votes (B, L, nb), rle votes (B, L, nr))

    On a fast backend the bf16 weight copies are made here, once for all
    windows, unless ``params`` holds them already (ConsensusStep makes them
    once per run). The heads, softmax and vote stay float32: helen_tpu's
    ``pallas_fast`` leaves the heads at its default precision, which is
    float32 off the TPU and single-pass bf16 only on it, a TPU artefact the
    port does not copy.
    """
    if backend in FAST_BACKENDS:
        params = fast_weights(params)
    B, L, _ = images.shape
    W = window_cfg.window
    geom = model_geometry(params)
    base_acc = torch.zeros((B, L, geom.num_base_classes), dtype=torch.float32,
                           device=images.device)
    rle_acc = torch.zeros((B, L, geom.num_rle_classes), dtype=torch.float32,
                          device=images.device)
    hidden = init_hidden(B, geom, images.device)
    for start in window_cfg.starts(L):
        base, rle, hidden = forward(params, images, hidden, backend,
                                    start=start, window=W, route=route)
        base_acc[:, start:start + W] += torch.softmax(base, dim=-1)
        rle_acc[:, start:start + W] += torch.softmax(rle, dim=-1)
    return base_acc, rle_acc


def consensus_labels(
    params: Params,
    images: torch.Tensor,
    window_cfg: WindowConfig = WINDOW,
    backend: str = "torch",
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vote then argmax -> uint8 labels. ``torch.argmax`` returns the first
    maximal index, the same tie-break as ``jnp.argmax`` and ``torch.max``."""
    base_probs, rle_probs = consensus_probs(params, images, window_cfg, backend, route)
    return (torch.argmax(base_probs, dim=-1).to(torch.uint8),
            torch.argmax(rle_probs, dim=-1).to(torch.uint8))


def consensus_labels_and_quality(
    params: Params,
    images: torch.Tensor,
    window_cfg: WindowConfig = WINDOW,
    backend: str = "torch",
    route: Optional[str] = None,
    max_q: int = 60,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Labels plus a per-column phred-scaled confidence (uint8, capped),
    helen_tpu's ``consensus_labels_and_quality``: the normalised winning
    vote of both heads becomes q = -10 log10(1 - p_base * p_rle), clipped to
    [0, max_q] and rounded half to even. The labels are
    :func:`consensus_labels`' (the same vote, the same argmax)."""
    base_probs, rle_probs = consensus_probs(params, images, window_cfg, backend, route)
    p_base = base_probs.amax(dim=-1) / torch.clamp(base_probs.sum(dim=-1), min=1e-12)
    p_rle = rle_probs.amax(dim=-1) / torch.clamp(rle_probs.sum(dim=-1), min=1e-12)
    err = torch.clamp(1.0 - p_base * p_rle, 10.0 ** (-(max_q / 10.0)), 1.0)
    q = torch.clamp(-10.0 * torch.log10(err), 0.0, float(max_q))
    return (torch.argmax(base_probs, dim=-1).to(torch.uint8),
            torch.argmax(rle_probs, dim=-1).to(torch.uint8),
            torch.round(q).to(torch.uint8))
