"""On-card numerics validation of the CUDA kernels: a recordable artifact.

The port's counterpart of helen_tpu/tools/tpu_validation.py, under its
check names and bars. The CPU tests run each kernel's plain version only
(there is no card and no nvcc there), so this tool runs the load-bearing
numeric claims ON the card and emits one JSON document
(``--json_out F``):

  * parity_vs_xla_votes: the window kernels (backend ``cuda``) against
    their plain versions (``torch``, helen_tpu's ``xla``) in true fp32:
    max |vote delta| and label flips over a uint8 batch;
  * fast_vs_xla_votes: the fast tier (``cuda_fast``, bf16) against
    ``torch``;
  * inproj_vs_classic_kernels: the two kernel families of the ``cuda``
    backend at the flagship, ``route="inproj"`` (K1/K2) against
    ``route="xp"`` (the projection kernel and K3): the same contract, two
    independent kernels, so agreement localizes a regression to one family;
  * geom_l2_h128, geom_h256, geom_h160_padded: a stacked 2-layer, an H=256
    and an H=160 model through ``cuda`` against ``torch``;
  * train_kernel_vs_scan: one 19-window TBPTT batch (gradient plus Adam per
    window) through the kernels and their backward against the plain
    route's autograd.

Each check reports helen_tpu's fields and the kernel family it engaged.
The last line printed is ``{"all_passed": ...}``; the exit code is 1 when
any check fails, so it can gate a deploy. Without a CUDA device it refuses
to run, naming the platform it found.

Usage (on a card):  python -m helen_tpu_torch.tools.gpu_validation [--batch 64]
    [--json_out out.json]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

import numpy as np

#: helen_tpu's bars (tools/tpu_validation.py): max |vote delta| and label
#: flips as a share of the labels per head, for the parity and fast tiers
PARITY_BARS = (1e-4, 1e-4)
FAST_BARS = (0.05, 0.02)
#: the TBPTT batch's rows and learning rate
TRAIN_ROWS, TRAIN_LR = 16, 1e-3


def consensus_votes(params, images, backend: str, route: Optional[str] = None):
    """(base votes, rle votes) of ``consensus_probs`` on ``backend`` and
    ``route``, as numpy arrays."""
    import torch

    from helen_tpu_torch.models.transducer import consensus_probs

    with torch.no_grad():
        return tuple(v.cpu().numpy() for v in consensus_probs(params, images, backend=backend,
                                                              route=route))


def compare_votes(got, want, bars: Tuple[float, float] = PARITY_BARS) -> dict:
    """helen_tpu's vote check: the max |vote delta| over both heads, the
    label flips (argmax, first max wins) over both, and whether both stay
    within ``bars`` (a delta, and flips as a share of one head's labels)."""
    delta = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    flips = sum(int((g.argmax(-1) != w.argmax(-1)).sum()) for g, w in zip(got, want))
    labels = int(np.prod(got[0].shape[:-1]))
    return {"passed": delta < bars[0] and flips <= labels * bars[1],
            "max_vote_delta": delta, "label_flips": flips, "labels": 2 * labels}


def check_votes(params, images, backend: str, reference: str, route: Optional[str] = None,
                reference_route: Optional[str] = None,
                bars: Tuple[float, float] = PARITY_BARS) -> dict:
    """:func:`compare_votes` of ``backend`` (on ``route``) against
    ``reference`` (on ``reference_route``), the images on their device."""
    return compare_votes(consensus_votes(params, images, backend, route),
                         consensus_votes(params, images, reference, reference_route), bars)


def tbptt_batch(params, images, yb, yr, backend: str, lr: float = TRAIN_LR):
    """One TBPTT batch (``train.train_loop.tbptt_step``, a fresh Adam at
    weight decay 0) from a copy of ``params`` on ``backend``: (the loss
    summed over the windows, the params after it as numpy leaves)."""
    import torch

    from helen_tpu_torch.models.transducer import param_leaves
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    def copy(tree):
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        return tree.detach().clone().requires_grad_(True)

    params = copy(params)
    adam = Adam(0.0)
    tot, _, _ = tbptt_step(params, adam, adam.init(params), lr, images, yb.long(), yr.long(),
                           images.shape[0], backend)
    return float(tot), [p.detach().cpu().numpy() for p in param_leaves(params)]


def compare_tbptt(got, want, lr: float, windows: int) -> dict:
    """helen_tpu's training check of two :func:`tbptt_batch` results: the
    loss sums within 5e-3 relative, and no param further apart than half
    the step budget (``windows`` Adam steps of ``lr``: Adam normalizes each
    update to about lr whatever the gradient's size, so ulp-level gradient
    differences can flip a small-moment coordinate's direction)."""
    (loss, leaves), (loss_ref, leaves_ref) = got, want
    dl = abs(loss - loss_ref)
    dp = max(float(np.abs(a - b).max()) for a, b in zip(leaves, leaves_ref))
    budget = windows * lr
    return {"passed": dl < 5e-3 * abs(loss_ref) and dp < 0.5 * budget,
            "loss_sum_delta": dl, "loss_sum": loss_ref, "max_param_delta_after_step": dp,
            "step_budget": budget}


def check_tbptt(params, images, yb, yr, backend: str, reference: str,
                lr: float = TRAIN_LR) -> dict:
    """:func:`compare_tbptt` of one batch on ``backend`` against
    ``reference``, from the same params."""
    from helen_tpu_torch.config import WINDOW

    return compare_tbptt(tbptt_batch(params, images, yb, yr, backend, lr),
                         tbptt_batch(params, images, yb, yr, reference, lr), lr,
                         WINDOW.num_windows(images.shape[1]))


def check_kernel_families(params, images, device) -> dict:
    """inproj_vs_classic_kernels: ``route="inproj"`` against ``route="xp"``
    on the ``cuda`` backend, with helen_tpu's two guards against a vacuous
    comparison: the two routes must engage two kernel families, and the
    launch counts must show K1/K2 and no K3 on one side, K3 and no K1/K2 on
    the other."""
    from helen_tpu_torch import ops
    from helen_tpu_torch.models.transducer import engaged_kernel

    families = [engaged_kernel(params, "cuda", route) for route in ("inproj", "xp")]
    if families != ["cuda_inproj", "cuda_xp"]:
        raise RuntimeError(f"the routes engage {families}, not two kernel families: "
                           "the kernel-family comparison would be vacuous")
    votes, launches = {}, {}
    for route in ("inproj", "xp"):
        ops.reset_launch_counts()
        votes[route] = consensus_votes(params, images, "cuda", route)
        launches[route] = ops.launch_counts()
    k3 = [launches[r].get("bigru_window_xp", 0) for r in ("inproj", "xp")]
    k12 = [launches[r].get("bigru_window_in1", 0) + launches[r].get("bigru_window_in2", 0)
           for r in ("inproj", "xp")]
    if device.type == "cuda" and not (k12[0] and not k3[0] and k3[1] and not k12[1]):
        raise RuntimeError(f"launches {launches}: K1/K2 did not run on route 'inproj' "
                           "alone and K3 on route 'xp' alone")
    return {**compare_votes(votes["inproj"], votes["xp"]), "kernel": "/".join(families),
            "launches": {"inproj": k12[0], "xp": k3[1]}}


def card():
    """(the first CUDA device, its name); without one it refuses, naming
    the platform it found: the checks never fall back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gpu_validation needs a CUDA GPU (found platform 'cpu': "
                         "no CUDA device is visible)")
    device = torch.device("cuda", torch.cuda.current_device())
    return device, torch.cuda.get_device_name(device)


def run(batch: int = 64) -> dict:
    """Every check on the card (:func:`card`), at ``batch`` images."""
    import torch

    from helen_tpu_torch.config import ModelConfig
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import (
        engaged_kernel,
        init_params,
        set_fp32_precision,
    )
    from helen_tpu_torch.obs import card_label

    device, kind = card()
    set_fp32_precision()
    label = card_label()
    results = {
        "platform": "gpu",
        "device_kind": kind,
        "power_limit": label.rpartition(",")[2].strip() if label else None,
        "batch": batch,
        "checks": {},
    }

    def check(name, fields):
        passed = fields.pop("passed")
        results["checks"][name] = {"passed": bool(passed), **fields}
        print(f"{'PASS' if passed else 'FAIL'} {name}: {fields}", flush=True)

    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.integers(0, 40, size=(batch, 1000, 90)).astype(np.uint8)).to(device)

    # ---- flagship geometry: parity and fast against the fp32 plain route
    params = params_to_torch(init_params(torch.Generator().manual_seed(0)), device)
    check("parity_vs_xla_votes", {**check_votes(params, images, "cuda", "torch"),
                                  "kernel": engaged_kernel(params, "cuda")})
    check("fast_vs_xla_votes", {**check_votes(params, images, "cuda_fast", "torch",
                                              bars=FAST_BARS),
                                "kernel": engaged_kernel(params, "cuda_fast")})

    # ---- the two kernel families of the cuda backend
    check("inproj_vs_classic_kernels", check_kernel_families(params, images, device))

    # ---- other geometries: stacked 2-layer, H=256, H=160
    for name, cfg in (("geom_l2_h128", ModelConfig(gru_layers=2)),
                      ("geom_h256", ModelConfig(hidden_size=256)),
                      ("geom_h160_padded", ModelConfig(hidden_size=160))):
        p2 = params_to_torch(init_params(torch.Generator().manual_seed(1), cfg), device)
        check(name, {**check_votes(p2, images, "cuda", "torch"),
                     "kernel": engaged_kernel(p2, "cuda")})

    # ---- training: one 19-window TBPTT batch, kernels against autograd
    tb = min(TRAIN_ROWS, batch)
    yb = torch.from_numpy(rng.integers(0, 5, size=(tb, 1000)).astype(np.int32))
    yr = torch.from_numpy(rng.integers(0, 11, size=(tb, 1000)).astype(np.int32))
    check("train_kernel_vs_scan", {**check_tbptt(params, images[:tb], yb.to(device),
                                                 yr.to(device), "cuda", "torch"),
                                   "kernel": engaged_kernel(params, "cuda")})

    results["all_passed"] = all(c["passed"] for c in results["checks"].values())
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="on-card numerics validation of the kernels")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--json_out", default=None)
    args = ap.parse_args(argv)
    results = run(args.batch)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"all_passed": results["all_passed"]}))
    return 0 if results["all_passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
