"""Training loop: truncated-BPTT multi-task training of the transducer.

Port of helen_tpu/train/train_loop.py on one process and one device. The
reference semantics are kept (train.py:144-250):

* each 1000-column labeled image is processed as 19 overlapping 100-column
  windows; each window is its own optimization step (forward, backward,
  Adam update) with the recurrent hidden state carried forward DETACHED
  (truncated BPTT; the reference detaches it, train.py:212);
* loss = mean CE(base) + class-weighted CE(rle), both over the batch's
  real rows only (the last batch is padded to the batch size);
* Adam (lr 1e-4, weight decay 0 by default, L2 added to the gradient
  before the moments, torch's convention) with the step size applied
  outside, so the plateau scheduler can change it between batches;
* ReduceLROnPlateau('min') stepped on the held-out loss each epoch;
* per epoch: evaluation, a checkpoint with optimizer and scheduler state
  (never pruned), the train/test CSVs and a confusion-matrix log.

On the ``"cuda"`` backend each window's bi-GRU layers run forward and
backward through hand-written kernels (ops.gru_window_autograd): K1/K2 and
the in-projection backward up to H=512, the projection GEMMs with K3/K4
for the wide models; on ``"torch"`` torch's autograd differentiates the
plain ops. The data order (the per-epoch permutation),
the checkpoints and the CSVs are byte-compatible with helen_tpu's, so a run
of either package resumes in the other.
"""
from __future__ import annotations

import csv
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from helen_tpu_torch.config import IMAGE, MODEL, TRAIN, WINDOW, ModelConfig, TrainConfig
from helen_tpu_torch.infer.consensus import resolve_device
from helen_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_model_any,
    opt_state_to_torch,
    params_to_torch,
    save_checkpoint,
)
from helen_tpu_torch.io.images import MarginPolishDataset, batched_image_iterator
from helen_tpu_torch.models.transducer import (
    Params,
    engaged_kernel,
    forward,
    init_hidden,
    init_params,
    model_geometry,
    num_params,
    param_leaves,
    resolve_backend,
    set_fp32_precision,
)
from helen_tpu_torch.obs import Throughput, get_logger
from helen_tpu_torch.train.evaluate import evaluate
from helen_tpu_torch.train.loss import (
    masked_cross_entropy_parts,
    masked_weighted_cross_entropy_parts,
)
from helen_tpu_torch.utils.filesystem import ensure_output_dir, list_image_files, timestamped_dir

log = get_logger("train")


class PlateauScheduler:
    """ReduceLROnPlateau('min') with torch defaults: factor 0.1, patience 10,
    relative threshold 1e-4 (reference train.py:113)."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.min_lr, self.lr * self.factor)
                self.num_bad = 0
                log.info("plateau: reducing lr to %g", self.lr)
        return self.lr

    def state_dict(self) -> Dict[str, float]:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: Dict[str, float]) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad = int(d["num_bad"])


class Adam:
    """The counterpart of helen_tpu's ``make_optimizer`` (``optax.scale_by_adam``,
    b1 0.9, b2 0.999, eps 1e-8, eps_root 0; with ``weight_decay > 0`` the L2
    term ``wd * param`` is added to the gradient before the moments), as
    plain torch ops on the param tree. The state is ``{"count", "mu",
    "nu"}``: mu and nu are the raw moments (optax keeps them so), count the
    number of updates. :meth:`update` changes params and state in place."""

    def __init__(self, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0):
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params: Params) -> Dict:
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            return torch.zeros_like(tree, requires_grad=False)

        return {"count": 0, "mu": zeros(params), "nu": zeros(params)}

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: Dict, lr: float) -> None:
        """One step: ``params`` and ``grads`` in :func:`param_leaves` order."""
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        for p, g, mu, nu in zip(params, grads, param_leaves(state["mu"]),
                                param_leaves(state["nu"])):
            if self.weight_decay:
                g = g + self.weight_decay * p
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root) + self.eps)
            p.add_(-lr * u)
        state["count"] = count


def tbptt_step(params: Params, adam: Adam, opt_state: Dict, lr: float,
               images: torch.Tensor, label_base: torch.Tensor,
               label_rle: torch.Tensor, valid: int, backend: str,
               route: Optional[str] = None):
    """One batch of truncated BPTT (helen_tpu ``build_tbptt_fn``,
    ``train_loop.py:89-177``): 19 windows, each a forward, a backward and an
    Adam update of ``params`` (leaf tensors with ``requires_grad``) in place.

    :param images: (B, L, F) uint8 on the device; labels (B, L) int
    :param valid: number of real rows; rows >= valid are padding and are
        masked out of both losses
    :param route: the ``"cuda"`` backend's kernel family (library only;
        ``models.transducer.forward``); ``"encdec"`` has no backward and
        is refused
    :returns: device scalars (loss sum, base loss sum, rle loss sum) over
        the windows, each window's loss a mean over its real rows
    """
    if route == "encdec":
        raise ValueError("route 'encdec' is inference only (helen_tpu's fused kernel has "
                         "no backward): train on route 'inproj' or 'xp'")
    W = WINDOW.window
    B, L, _ = images.shape
    dev = images.device
    geom = model_geometry(params)
    rle_w = torch.tensor(TRAIN.rle_class_weights, dtype=torch.float32, device=dev)
    row_mask = (torch.arange(B, device=dev) < valid).to(torch.float32)
    leaves = param_leaves(params)
    hidden = init_hidden(B, geom, dev)
    tot = torch.zeros((), device=dev)
    tot_b = torch.zeros((), device=dev)
    tot_r = torch.zeros((), device=dev)
    for start in WINDOW.starts(L):
        base, rle, hidden_new = forward(params, images, hidden, backend,
                                        start=start, window=W, route=route)
        nb, db = masked_cross_entropy_parts(base, label_base[:, start:start + W],
                                            row_mask)
        nr, dr = masked_weighted_cross_entropy_parts(
            rle, label_rle[:, start:start + W], rle_w, row_mask)
        lb = nb / torch.clamp(db, min=1.0)
        lr_ = nr / torch.clamp(dr, min=1e-12)
        loss = lb + lr_
        grads = torch.autograd.grad(loss, leaves)
        adam.update(leaves, grads, opt_state, lr)
        hidden = hidden_new.detach()
        tot = tot + loss.detach()
        tot_b = tot_b + lb.detach()
        tot_r = tot_r + lr_.detach()
    return tot, tot_b, tot_r


@dataclass
class EpochStats:
    epoch: int
    train_loss: float
    test_loss: float
    base_accuracy: float
    rle_accuracy: float


class Trainer:
    """Single-process trainer on one device (helen_tpu's ``Trainer`` with
    ``data_parallel=False``). ``pack`` reads the training images from a
    packed cache (io.packed), ``<cache_dir or model_dir>/train_images_cache.h5``,
    built once with labels and reused while the image files are unchanged.
    Data-parallel, multi-process and model-parallel training are not yet
    ported (ROADMAP queue A)."""

    def __init__(
        self,
        train_files: Sequence[str],
        test_files: Sequence[str],
        cfg: TrainConfig = TRAIN,
        model_dir: str = "./model_out/models",
        stats_dir: str = "./model_out/stats",
        num_workers: int = 8,
        retrain_model_path: Optional[str] = None,
        checkpoint_every_batches: int = 200,
        backend: str = "auto",
        model_cfg: ModelConfig = MODEL,
        device: str = "cuda",
        pack: bool = False,
        cache_dir: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        set_fp32_precision()
        self.cfg = cfg
        self.train_files = list(train_files)
        self.test_files = list(test_files)
        self.model_dir = ensure_output_dir(model_dir)
        self.stats_dir = ensure_output_dir(stats_dir)
        self.num_workers = num_workers
        self.checkpoint_every_batches = max(1, checkpoint_every_batches)
        self.adam = Adam(cfg.weight_decay)
        self.start_epoch = 0
        self.start_batch = 0
        self.scheduler = PlateauScheduler(
            cfg.learning_rate, cfg.plateau_factor, cfg.plateau_patience)
        opt_np = None
        if retrain_model_path:
            if retrain_model_path.endswith(".npz"):
                params_np, meta, opt_np = load_checkpoint(retrain_model_path,
                                                          with_opt_state=True)
                if "scheduler" in meta:
                    self.scheduler.load_state_dict(meta["scheduler"])
                    log.info("restored LR scheduler state: lr=%g", self.scheduler.lr)
            else:
                params_np, meta = load_model_any(retrain_model_path)
            self.start_epoch = int(meta.get("epochs", 0))
            self.start_batch = int(meta.get("batch_in_epoch", 0))
            log.info("retraining from %s (epoch %d)", retrain_model_path,
                     self.start_epoch)
        else:
            params_np = init_params(torch.Generator().manual_seed(cfg.seed), model_cfg)
        self.params = params_to_torch(params_np, self.device)
        for p in param_leaves(self.params):
            p.requires_grad_(True)
        self.opt_state = (opt_state_to_torch(opt_np, self.device) if opt_np is not None
                          else self.adam.init(self.params))
        self.model_cfg = model_geometry(self.params)
        self.backend = resolve_backend(backend, self.device, self.params, kind="train")
        log.info("model parameters: %d (hidden %d, %d gru layer(s)), backend %s "
                 "(kernels: %s) on %s", num_params(self.params),
                 self.model_cfg.hidden_size, self.model_cfg.gru_layers, self.backend,
                 engaged_kernel(self.params, self.backend), self.device)
        self.dataset = MarginPolishDataset(self.train_files, IMAGE, with_labels=True)
        if len(self.dataset) == 0:
            raise ValueError("no labeled training images found")
        # packed training cache: group-per-image HDF5 reads repeat EVERY
        # epoch; one slab-readable cache (reused across runs via cache_dir)
        # removes that. Packed indices equal dataset indices (pack_images
        # writes in index order), so the epoch permutation — and a
        # mid-epoch resume — replay the same batches on either path
        self.packed_train = None
        if pack:
            from helen_tpu_torch.io.packed import PackedDataset, cache_is_fresh, pack_images

            cache_path = os.path.join(cache_dir or model_dir, "train_images_cache.h5")
            if not cache_is_fresh(cache_path, self.train_files, with_labels=True):
                log.info("building packed training cache %s", cache_path)
                pack_images(self.train_files, cache_path, IMAGE, with_labels=True,
                            dataset=self.dataset)
            self.packed_train = PackedDataset(cache_path, with_labels=True)
            if len(self.packed_train) != len(self.dataset):
                raise RuntimeError(f"{cache_path} holds {len(self.packed_train)} images, "
                                   f"the training files {len(self.dataset)}")
        self.test_dataset = MarginPolishDataset(self.test_files, IMAGE, with_labels=True)
        log.info("training on %d images, evaluating on %d files",
                 len(self.dataset), len(self.test_files))

    def _epoch_indices(self, epoch: int) -> list:
        """Deterministic per-epoch shuffle (seed + epoch), helen_tpu's exact
        data order, so a mid-epoch resume re-derives it."""
        return np.random.default_rng(self.cfg.seed + epoch).permutation(
            len(self.dataset)).tolist()

    def _meta(self, epochs: int, **extra) -> Dict:
        return {"epochs": epochs, **extra,
                "hidden_size": self.model_cfg.hidden_size,
                "gru_layers": self.model_cfg.gru_layers,
                "scheduler": self.scheduler.state_dict()}

    def _save_latest(self, epoch: int, batch_in_epoch: int) -> None:
        save_checkpoint(os.path.join(self.model_dir, "HELEN_latest_checkpoint.npz"),
                        self.params, meta=self._meta(epoch, batch_in_epoch=batch_in_epoch),
                        opt_state=self.opt_state)

    def train_one_epoch(self, epoch: int, skip_batches: int = 0) -> float:
        indices = self._epoch_indices(epoch)
        bs = self.cfg.batch_size
        total_loss = 0.0
        total_images = 0
        n_windows = WINDOW.num_windows(IMAGE.seq_length)
        tp = Throughput(unit="windows")
        tp.start()
        if skip_batches:
            indices = indices[skip_batches * bs:]
            log.info("mid-epoch resume: skipping %d already-trained batches",
                     skip_batches)
        if self.packed_train is not None:
            from helen_tpu_torch.io.packed import packed_batch_iterator, prefetch_iterator

            batches = prefetch_iterator(packed_batch_iterator(
                self.packed_train, bs, indices=indices, pad_final=True))
        else:
            batches = batched_image_iterator(self.dataset, bs, self.num_workers,
                                             indices=indices, pad_final=True)
        with open(os.path.join(self.stats_dir, "train_loss.csv"), "a", newline="") as f:
            writer = csv.writer(f)
            for bi, batch in enumerate(batches, start=skip_batches):
                to_dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
                tot, _, _ = tbptt_step(
                    self.params, self.adam, self.opt_state, self.scheduler.lr,
                    to_dev(batch.images), to_dev(batch.labels_base).long(),
                    to_dev(batch.labels_rle).long(), batch.valid, self.backend)
                total_loss += float(tot)
                total_images += batch.valid * n_windows
                tp.add(batch.valid * n_windows)
                avg = total_loss / max(1, total_images)
                writer.writerow([epoch + 1, bi + 1, avg])
                if (bi + 1) % self.checkpoint_every_batches == 0:
                    self._save_latest(epoch, bi + 1)
                if bi % 20 == 0:
                    log.info("epoch %d batch %d: avg loss %.6f | %s",
                             epoch + 1, bi + 1, avg, tp)
        tp.stop()
        self.epoch_throughput = tp
        return total_loss / max(1, total_images)

    def run(self, epochs: int) -> List[EpochStats]:
        history: List[EpochStats] = []
        test_csv = os.path.join(self.stats_dir, "test_loss.csv")
        cm_log = os.path.join(self.stats_dir, "confusion_matrix.txt")
        for epoch in range(self.start_epoch, self.start_epoch + epochs):
            t0 = time.time()
            skip = self.start_batch if epoch == self.start_epoch else 0
            train_loss = self.train_one_epoch(epoch, skip_batches=skip)
            tp = self.epoch_throughput
            t_eval = time.time()
            stats = evaluate(self.params, self.test_files, self.cfg.batch_size,
                             self.num_workers, backend=self.backend,
                             dataset=self.test_dataset)
            eval_seconds = time.time() - t_eval
            self.scheduler.step(stats["loss"])
            ckpt = os.path.join(self.model_dir, f"HELEN_epoch_{epoch + 1}_checkpoint.npz")
            save_checkpoint(ckpt, self.params, meta=self._meta(epoch + 1),
                            opt_state=self.opt_state)
            self._save_latest(epoch + 1, 0)
            with open(test_csv, "a", newline="") as f:
                csv.writer(f).writerow([epoch + 1, stats["loss"], stats["base_accuracy"]])
            with open(cm_log, "a") as f:
                f.write(f"{epoch + 1}\n{stats['base_confusion_matrix'].astype(np.int64)}\n")
            # the port's own record of each epoch: both confusion matrices
            # and the epoch's timings, for `test` to be held against
            with open(os.path.join(self.stats_dir, "epochs.jsonl"), "a") as f:
                f.write(json.dumps({
                    "epoch": epoch + 1, "train_loss": train_loss,
                    "test_loss": stats["loss"],
                    "base_accuracy": stats["base_accuracy"],
                    "rle_accuracy": stats["rle_accuracy"],
                    "base_confusion_matrix": stats["base_confusion_matrix"].tolist(),
                    "rle_confusion_matrix": stats["rle_confusion_matrix"].tolist(),
                    "train_seconds": tp.elapsed, "train_windows": tp.total,
                    "eval_seconds": eval_seconds, "device": str(self.device),
                    "backend": self.backend}) + "\n")
            log.info("epoch %d done in %.1fs: train loss %.6f | test loss %.6f | "
                     "base acc %.2f%% | rle acc %.2f%% | saved %s",
                     epoch + 1, time.time() - t0, train_loss, stats["loss"],
                     stats["base_accuracy"], stats["rle_accuracy"], ckpt)
            history.append(EpochStats(epoch + 1, train_loss, stats["loss"],
                                      stats["base_accuracy"], stats["rle_accuracy"]))
        return history


def train_interface(
    train_dir: str,
    test_dir: str,
    batch_size: int = 100,
    epochs: int = 10,
    num_workers: int = 16,
    output_dir: str = "./model_out/",
    retrain_model_path: Optional[str] = None,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.0,
    seed: int = 42,
    backend: str = "auto",
    hidden_size: int = MODEL.hidden_size,
    gru_layers: int = MODEL.gru_layers,
    device: str = "cuda",
    pack: bool = False,
) -> List[EpochStats]:
    """CLI entry: timestamped model/stats dirs like the reference
    (TrainInterface.py + FileManager.py:25-48). hidden_size/gru_layers pick
    the geometry of a fresh model; retraining follows the checkpoint's.
    ``pack``: the packed training cache, kept in ``output_dir`` itself (not
    the run's timestamped dir) so later runs reuse it."""
    import dataclasses as _dc

    cfg = _dc.replace(TRAIN, batch_size=batch_size, learning_rate=learning_rate,
                      weight_decay=weight_decay, seed=seed)
    model_cfg = _dc.replace(MODEL, hidden_size=hidden_size, gru_layers=gru_layers)
    resolve_device(device)  # refuse before making the run directory
    run_dir = timestamped_dir(output_dir, "trained_models")
    trainer = Trainer(
        train_files=list_image_files(train_dir),
        test_files=list_image_files(test_dir),
        cfg=cfg,
        model_dir=os.path.join(run_dir, "models"),
        stats_dir=os.path.join(run_dir, "stats"),
        num_workers=num_workers,
        retrain_model_path=retrain_model_path,
        backend=backend,
        model_cfg=model_cfg,
        device=device,
        pack=pack,
        cache_dir=ensure_output_dir(output_dir),
    )
    return trainer.run(epochs)
