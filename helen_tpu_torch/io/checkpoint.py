"""Checkpoint I/O for the port: params, and the Adam state of training.

Reads the two formats helen_tpu reads (helen_tpu/io/checkpoint.py):

* the native ``.npz``: every parameter leaf under ``params/<key path>``
  plus a JSON ``__meta__`` blob (model dims, epoch, format version), and
  in a training checkpoint the optimizer state under ``opt/%05d`` in
  optax's flatten order (``count``, then the ``mu`` leaves, then the ``nu``
  leaves, each in sorted key-path order) — a checkpoint from either
  package resumes in the other;
* the reference torch ``.pkl`` ``{model_state_dict, hidden_size,
  gru_layers, epochs, ...}`` (reference ModelHander.py:127-133), mapped onto
  the same param tree: torch nn.GRU / nn.Linear weights transposed for
  right-multiplication, DDP ``module.`` prefixes stripped.

Params load as a nested dict of numpy arrays — the same tree helen_tpu
builds — and :func:`params_to_torch` is the weight bridge that turns that
tree into the port's tensors on a device, and :func:`fast_weights` adds
the bf16 weight copies of the fast tier to such a tree, once per run. The
tests hand both packages identical weights through it;
:func:`opt_state_to_torch` and :func:`opt_state_to_numpy` do the same for
the Adam state (``{"count", "mu", "nu"}``).
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

FORMAT_VERSION = 1


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(flatten_tree(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = _to_numpy(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _to_numpy(leaf: Any) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor, on any device
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def opt_leaves(opt_state: Dict[str, Any]) -> list:
    """The Adam state's leaves in optax's flatten order: ``count`` (int32),
    the ``mu`` leaves, the ``nu`` leaves. optax's
    ``chain(add_decayed_weights, scale_by_adam)`` state has the same leaves
    (its first element is empty)."""
    return ([np.asarray(_to_numpy(opt_state["count"]), dtype=np.int32)]
            + list(flatten_tree(opt_state["mu"]).values())
            + list(flatten_tree(opt_state["nu"]).values()))


def save_checkpoint(path: str, params: Any,
                    meta: Optional[Dict[str, Any]] = None,
                    opt_state: Optional[Dict[str, Any]] = None) -> None:
    """Atomically write params (numpy arrays or torch tensors) and, when
    given, the Adam state ``{"count", "mu", "nu"}`` to ``path`` in the
    native .npz layout, readable by helen_tpu too."""
    arrays = {f"params/{k}": v for k, v in flatten_tree(params).items()}
    if opt_state is not None:
        for i, leaf in enumerate(opt_leaves(opt_state)):
            arrays[f"opt/{i:05d}"] = leaf
    meta = dict(meta or {})
    meta["format_version"] = FORMAT_VERSION
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
             **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)  # atomic: a preempted writer never corrupts the file


def load_checkpoint(path: str, with_opt_state: bool = False):
    """Load (params, meta) from a native .npz; with ``with_opt_state``,
    (params, meta, opt_state), where opt_state is the numpy
    ``{"count", "mu", "nu"}`` or None when the file holds none."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        params_flat = {
            k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")
        }
        opt = [data[k] for k in sorted(k for k in data.files if k.startswith("opt/"))]
    params = unflatten_tree(params_flat)
    if not with_opt_state:
        return params, meta
    if not opt:
        return params, meta, None
    keys = list(flatten_tree(params))
    n = len(keys)
    if len(opt) != 1 + 2 * n:
        raise ValueError(f"{path}: {len(opt)} optimizer leaves, expected 1 + 2 x "
                         f"{n} (count, mu, nu of the Adam state)")
    state = {"count": np.asarray(opt[0], dtype=np.int32).reshape(()),
             "mu": unflatten_tree(dict(zip(keys, opt[1:1 + n]))),
             "nu": unflatten_tree(dict(zip(keys, opt[1 + n:])))}
    return params, meta, state


_GRU_MAP = {"gru_encoder": "encoder", "gru_decoder": "decoder"}
_HEAD_MAP = {"dense1_base": "base_head", "dense2_rle": "rle_head"}


def _strip_ddp(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def params_from_torch_state_dict(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a reference TransducerGRU state dict into the param tree.

    Handles any gru_layers the reference supports (torch nn.GRU names deeper
    layers ``weight_ih_l<k>[_reverse]``); layer 0 lands in the stack's
    {"fwd", "bwd"} keys, layer k >= 1 under "l<k>"."""
    sd = {k: np.asarray(v, dtype=np.float32) for k, v in _strip_ddp(state_dict).items()}
    params: Dict[str, Any] = {}
    for torch_name, ours in _GRU_MAP.items():

        def dir_params(k: int, suffix: str) -> Dict[str, Any]:
            return {
                # torch stores (3H, D); we right-multiply so transpose
                "w_ih": sd[f"{torch_name}.weight_ih_l{k}{suffix}"].T.copy(),
                "w_hh": sd[f"{torch_name}.weight_hh_l{k}{suffix}"].T.copy(),
                "b_ih": sd[f"{torch_name}.bias_ih_l{k}{suffix}"].copy(),
                "b_hh": sd[f"{torch_name}.bias_hh_l{k}{suffix}"].copy(),
            }

        stack: Dict[str, Any] = {
            "fwd": dir_params(0, ""), "bwd": dir_params(0, "_reverse")
        }
        k = 1
        while f"{torch_name}.weight_ih_l{k}" in sd:
            stack[f"l{k}"] = {
                "fwd": dir_params(k, ""), "bwd": dir_params(k, "_reverse")
            }
            k += 1
        params[ours] = stack
    for torch_name, ours in _HEAD_MAP.items():
        params[ours] = {
            "w": sd[f"{torch_name}.weight"].T.copy(),
            "b": sd[f"{torch_name}.bias"].copy(),
        }
    return params


def import_torch_checkpoint(pkl_path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a reference ``.pkl`` model and return (params, meta)."""
    import torch

    ckpt = torch.load(pkl_path, map_location="cpu", weights_only=False)
    state_dict = {k: v.numpy() for k, v in ckpt["model_state_dict"].items()}
    params = params_from_torch_state_dict(state_dict)
    meta = {
        "hidden_size": int(ckpt.get("hidden_size", 128)),
        "gru_layers": int(ckpt.get("gru_layers", 1)),
        "epochs": int(ckpt.get("epochs", 0)),
        "source": os.path.basename(pkl_path),
    }
    return params, meta


def export_torch_state_dict(params: Any) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_torch_state_dict` (numpy arrays, torch
    layout); ``params`` may hold numpy arrays or tensors."""
    sd: Dict[str, np.ndarray] = {}
    for torch_name, ours in _GRU_MAP.items():
        stack = params[ours]
        layers = [{"fwd": stack["fwd"], "bwd": stack["bwd"]}]
        while f"l{len(layers)}" in stack:
            layers.append(stack[f"l{len(layers)}"])
        for k, layer in enumerate(layers):
            for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
                d = layer[direction]
                sd[f"{torch_name}.weight_ih_l{k}{suffix}"] = _to_numpy(d["w_ih"]).T.copy()
                sd[f"{torch_name}.weight_hh_l{k}{suffix}"] = _to_numpy(d["w_hh"]).T.copy()
                sd[f"{torch_name}.bias_ih_l{k}{suffix}"] = _to_numpy(d["b_ih"]).copy()
                sd[f"{torch_name}.bias_hh_l{k}{suffix}"] = _to_numpy(d["b_hh"]).copy()
    for torch_name, ours in _HEAD_MAP.items():
        sd[f"{torch_name}.weight"] = _to_numpy(params[ours]["w"]).T.copy()
        sd[f"{torch_name}.bias"] = _to_numpy(params[ours]["b"]).copy()
    return sd


def export_torch_checkpoint(path: str, params: Any, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a reference-format ``.pkl`` checkpoint (ModelHander.py:127-133
    layout) so models trained here remain usable with the reference tooling
    (helen_tpu's ``export_torch_checkpoint``)."""
    import torch

    from helen_tpu_torch.models.transducer import model_geometry

    meta = dict(meta or {})
    geom = model_geometry(params)  # authoritative: shapes, not metadata
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_torch_state_dict(params).items()}
    torch.save(
        {
            "model_state_dict": sd,
            "model_optimizer": {},
            "hidden_size": geom.hidden_size,
            "gru_layers": geom.gru_layers,
            "epochs": int(meta.get("epochs", 0)),
        },
        path,
    )


def load_model_any(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load either a native .npz checkpoint or a reference torch .pkl."""
    if path.endswith(".npz"):
        return load_checkpoint(path)
    # both npz and torch checkpoints are zip archives; probe for our marker
    try:
        with np.load(path) as data:
            is_native = "__meta__" in data.files
    except (OSError, ValueError, zipfile.BadZipFile):
        is_native = False
    if is_native:
        return load_checkpoint(path)
    return import_torch_checkpoint(path)


def params_to_torch(params_np: Dict[str, Any], device, fast: bool = False) -> Dict[str, Any]:
    """The weight bridge: a param tree of numpy arrays (as helen_tpu or
    :func:`load_model_any` hold it) -> the same tree of contiguous float32
    torch tensors on ``device``; with ``fast``, passed through
    :func:`fast_weights`."""
    import torch

    if fast:
        return fast_weights(params_to_torch(params_np, device))
    if isinstance(params_np, dict):
        return {k: params_to_torch(v, device) for k, v in params_np.items()}
    # torch.tensor copies: the tensors never alias the caller's arrays
    return torch.tensor(np.asarray(params_np, dtype=np.float32), device=device)


def opt_state_to_torch(state_np: Dict[str, Any], device) -> Dict[str, Any]:
    """The Adam-state bridge: numpy ``{count, mu, nu}`` (as helen_tpu's
    optax state flattens, or :func:`load_checkpoint` returns it) -> the
    port's state: ``count`` a Python int, ``mu``/``nu`` float32 tensors on
    ``device``."""
    return {"count": int(np.asarray(state_np["count"])),
            "mu": params_to_torch(state_np["mu"], device),
            "nu": params_to_torch(state_np["nu"], device)}


def opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's Adam state -> numpy ``{count (int32), mu, nu}``."""
    return {"count": np.asarray(int(state["count"]), dtype=np.int32),
            "mu": unflatten_tree(flatten_tree(state["mu"])),
            "nu": unflatten_tree(flatten_tree(state["nu"]))}


def is_fast(params: Dict[str, Any]) -> bool:
    """Whether a torch param tree holds the fast tier's bf16 weights."""
    import torch

    return params["encoder"]["fwd"]["w_hh"].dtype == torch.bfloat16


def fast_layer(layer: Dict[str, Any]) -> Dict[str, Any]:
    """One bi-GRU layer ``{"fwd", "bwd"}`` of float32 tensors in the fast
    tier's form: ``w_ih`` and ``w_hh`` as bf16 copies, rounded to nearest
    even as helen_tpu's ``astype(jnp.bfloat16)`` rounds them
    (``ops/gru_pallas.py:533``); ``w_ih_f32``, the same bf16 values widened
    to float32 for the xp route's float32 projection GEMM; the biases as
    they were (float32)."""
    import torch

    def direction(p):
        w_ih = p["w_ih"].to(torch.bfloat16)
        return {"w_ih": w_ih, "w_hh": p["w_hh"].to(torch.bfloat16),
                "b_ih": p["b_ih"], "b_hh": p["b_hh"], "w_ih_f32": w_ih.float()}

    return {d: direction(layer[d]) for d in ("fwd", "bwd")}


def fast_weights(params: Dict[str, Any]) -> Dict[str, Any]:
    """The fast tier's param tree from a float32 torch tree: every GRU layer
    through :func:`fast_layer`, the heads as they were (float32). Built once
    per run, not per window: a cast per window would add launches and weight
    traffic to every window. A tree that is fast already comes back as it
    is."""
    if is_fast(params):
        return params
    out = dict(params)
    for stack in ("encoder", "decoder"):
        s = params[stack]
        out[stack] = {**fast_layer(s), **{k: fast_layer(v) for k, v in s.items()
                                          if k not in ("fwd", "bwd")}}
    return out
