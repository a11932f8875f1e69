"""Hyperband hyper-parameter search (port of helen_tpu/train/hyperband.py).

Equivalent of the reference's successive-halving search
(models/hyperband.py + hyperbandInterface.py — present in the reference but
not wired into its CLI; here it is reachable via ``python -m
helen_tpu_torch hyperband``, ``python -m helen_tpu_torch.train.hyperband``
and the library API). Every trial trains through the port's ``Trainer``: on
a CUDA device through the window kernels, forward and backward. Searches over
(learning_rate, weight_decay) drawn log-uniformly (the reference's hyperopt
space, hyperbandInterface.py:39-44) and allocates epochs with the standard
Hyperband successive-halving schedule (Li et al. 2018).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from helen_tpu_torch.config import TRAIN
from helen_tpu_torch.obs import get_logger
from helen_tpu_torch.utils.filesystem import ensure_output_dir

log = get_logger("hyperband")


@dataclasses.dataclass
class TrialResult:
    params: Dict[str, float]
    loss: float
    epochs: int


def sample_config(rng: np.random.Generator) -> Dict[str, float]:
    """Log-uniform lr in [1e-5, 1e-2], decay in [1e-7, 1e-3] (reference
    hyperbandInterface.py:39-44 draws both via hp.loguniform)."""
    return {
        "learning_rate": float(10 ** rng.uniform(-5, -2)),
        "weight_decay": float(10 ** rng.uniform(-7, -3)),
    }


class Hyperband:
    """Successive halving across brackets; ``run_trial(config, epochs,
    prev_state)`` must return (loss, state) where state lets a survivor
    continue training (checkpoint path or params).

    ``epochs`` is the ADDITIONAL training to run on top of ``prev_state``:
    rung allocations are the deltas to each rung's cumulative budget r_i
    (a survivor resumed from the 1-epoch rung gets 2 more to reach r=3,
    then 6 more to reach r=9), so total spend matches the Li et al.
    schedule instead of inflating ~eta/(eta-1)x."""

    def __init__(
        self,
        run_trial: Callable,
        max_epochs: int = 9,
        eta: int = 3,
        seed: int = 0,
    ):
        self.run_trial = run_trial
        self.max_epochs = max_epochs
        self.eta = eta
        self.rng = np.random.default_rng(seed)
        if eta < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        # largest s with eta**s <= max_epochs, by integer multiplication —
        # float log ratios land just below integers (log(243)/log(3) =
        # 4.999...) and int() would drop the most exploratory bracket
        s_max = 0
        while eta ** (s_max + 1) <= max_epochs:
            s_max += 1
        self.s_max = s_max
        self.B = (self.s_max + 1) * max_epochs
        self.results: List[TrialResult] = []

    def run(self) -> TrialResult:
        for s in range(self.s_max, -1, -1):
            n = int(math.ceil(self.B / self.max_epochs / (s + 1) * self.eta ** s))
            r = self.max_epochs * self.eta ** (-s)
            # (config, resume state, cumulative epochs trained, last loss)
            trials: List[Tuple[Dict[str, float], Optional[object], int, float]] = [
                (sample_config(self.rng), None, 0, float("inf")) for _ in range(n)
            ]
            log.info("bracket s=%d: %d configs, %g initial epochs", s, n, r)
            for i in range(s + 1):
                n_i = int(n * self.eta ** (-i))
                r_i = max(1, int(round(r * self.eta ** i)))
                scored = []
                for cfg, state, done, _ in trials[:n_i]:
                    # add > 0 always: eta >= 2 and r >= 1 make the rung
                    # budgets r_i strictly increasing
                    add = r_i - done
                    loss, state = self.run_trial(cfg, add, state)
                    scored.append((loss, cfg, state, r_i))
                    self.results.append(TrialResult(cfg, loss, r_i))
                    log.info("  cfg lr=%.2e decay=%.2e epochs=%d (+%d) -> loss %.6f",
                             cfg["learning_rate"], cfg["weight_decay"], r_i,
                             max(0, add), loss)
                scored.sort(key=lambda t: t[0])
                keep = max(1, int(n_i / self.eta))
                trials = [(cfg, st, ep, ls) for ls, cfg, st, ep in scored[:keep]]
        best = min(self.results, key=lambda t: t.loss)
        log.info("best: lr=%.2e decay=%.2e (loss %.6f)",
                 best.params["learning_rate"], best.params["weight_decay"], best.loss)
        return best


def hyperband_interface(
    train_dir: str,
    test_dir: str,
    output_dir: str = "./hyperband_out/",
    batch_size: int = 32,
    max_epochs: int = 9,
    eta: int = 3,
    num_workers: int = 4,
    seed: int = 0,
    device: str = "cuda",
) -> TrialResult:
    """Search (lr, decay) by training real models on the given image dirs,
    on ``device`` (the Trainer's default backend: the window kernels on a
    CUDA device). Trial k trains in
    ``<output_dir>/trial_<k>``; ``hyperband_results.json`` there lists each
    trial's config, cumulative epochs, loss and checkpoint, in order, and
    the best."""
    import json

    from helen_tpu_torch.infer.consensus import resolve_device
    from helen_tpu_torch.train.train_loop import Trainer
    from helen_tpu_torch.utils.filesystem import list_image_files

    resolve_device(device)  # refuse before making the output directory

    output_dir = ensure_output_dir(output_dir)
    train_files = list_image_files(train_dir)
    test_files = list_image_files(test_dir)
    trial_no = [0]
    trials: List[Dict[str, object]] = []

    def run_trial(cfg, epochs, state):
        trial_no[0] += 1
        tdir = os.path.join(output_dir, f"trial_{trial_no[0]:03d}")
        cfg_full = dataclasses.replace(
            TRAIN,
            batch_size=batch_size,
            learning_rate=cfg["learning_rate"],
            weight_decay=cfg["weight_decay"],
            seed=seed,
        )
        trainer = Trainer(
            train_files, test_files, cfg_full,
            model_dir=os.path.join(tdir, "models"),
            stats_dir=os.path.join(tdir, "stats"),
            num_workers=num_workers,
            retrain_model_path=state,
            device=device,
        )
        history = trainer.run(int(epochs))
        last_epoch = history[-1].epoch if history else 0
        ckpt = os.path.join(tdir, "models", f"HELEN_epoch_{last_epoch}_checkpoint.npz")
        loss = history[-1].test_loss if history else float("inf")
        trials.append({"trial": os.path.basename(tdir), "params": cfg, "epochs": last_epoch,
                       "added_epochs": int(epochs), "resumed_from": state, "loss": loss,
                       "checkpoint": ckpt if os.path.exists(ckpt) else None})
        return loss, (ckpt if os.path.exists(ckpt) else None)

    hb = Hyperband(run_trial, max_epochs=max_epochs, eta=eta, seed=seed)
    best = hb.run()
    with open(os.path.join(output_dir, "hyperband_results.json"), "w") as f:
        json.dump({"max_epochs": max_epochs, "eta": eta, "seed": seed, "trials": trials,
                   "best": trials[hb.results.index(best)]}, f, indent=1)
    return best


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Hyperband search for helen_tpu_torch")
    ap.add_argument("--train_image_dir", required=True)
    ap.add_argument("--test_image_dir", required=True)
    ap.add_argument("-o", "--output_dir", default="./hyperband_out/")
    ap.add_argument("-b", "--batch_size", type=int, default=32)
    ap.add_argument("--max_epochs", type=int, default=9)
    ap.add_argument("--eta", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    hyperband_interface(
        args.train_image_dir, args.test_image_dir, args.output_dir,
        args.batch_size, args.max_epochs, args.eta, seed=args.seed, device=args.device,
    )
