"""Model evaluation: windowed loss and confusion matrices (port of
helen_tpu/train/evaluate.py, one device per process).

The reference test module (models/test.py:39-167, TestInterface.py:90-139):
the 19-window sweep with the hidden state carried, 5x5 base and 11x11 RLE
confusion matrices (rows truth, columns prediction), and the loss summed
per window and normalised by images-per-window. Padded rows are masked out
of the loss and the matrices, padded columns of short images out of the
matrices (as helen_tpu does). The forward is the inference one (on the
``"cuda"`` backend K1/K2, or K3 for the wide models) under
``torch.no_grad()``. In a multi-process job (parallel.multihost) each
process scores its block of the images and the sums are taken over the
processes, the same on every one.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from helen_tpu_torch.config import IMAGE, TRAIN, WINDOW
from helen_tpu_torch.infer.consensus import resolve_device
from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
from helen_tpu_torch.io.images import MarginPolishDataset, batched_image_iterator
from helen_tpu_torch.models.transducer import (
    engaged_kernel,
    forward,
    init_hidden,
    model_geometry,
    resolve_backend,
    set_fp32_precision,
)
from helen_tpu_torch.obs import get_logger
from helen_tpu_torch.train.loss import masked_cross_entropy, masked_weighted_cross_entropy
from helen_tpu_torch.utils.filesystem import ensure_output_dir, list_image_files

log = get_logger("eval")


@torch.no_grad()
def eval_batch(params, images: torch.Tensor, label_base: torch.Tensor,
               label_rle: torch.Tensor, col_mask: torch.Tensor, valid: int,
               backend: str):
    """One batch on its device: (loss sum over the windows, base confusion
    (nb, nb), rle confusion (nr, nr)), the matrices as float64 numpy."""
    B, L, _ = images.shape
    dev = images.device
    W = WINDOW.window
    geom = model_geometry(params)
    nb, nr = geom.num_base_classes, geom.num_rle_classes
    rle_w = torch.tensor(TRAIN.rle_class_weights, dtype=torch.float32, device=dev)
    row_mask = (torch.arange(B, device=dev) < valid).to(torch.float32)
    hidden = init_hidden(B, geom, dev)
    loss_sum = torch.zeros((), device=dev)
    cm_b = torch.zeros(nb * nb, dtype=torch.float64, device=dev)
    cm_r = torch.zeros(nr * nr, dtype=torch.float64, device=dev)
    for start in WINDOW.starts(L):
        base, rle, hidden = forward(params, images, hidden, backend,
                                    start=start, window=W)
        yb = label_base[:, start:start + W]
        yr = label_rle[:, start:start + W]
        loss = (masked_cross_entropy(base, yb, row_mask)
                + masked_weighted_cross_entropy(rle, yr, rle_w, row_mask))
        loss_sum = loss_sum + loss
        w = col_mask[:, start:start + W].reshape(-1).to(torch.float64)
        # integer counts: exact in float64 whatever order the sums take
        cm_b += torch.bincount((yb * nb + base.argmax(-1)).reshape(-1), weights=w,
                               minlength=nb * nb)
        cm_r += torch.bincount((yr * nr + rle.argmax(-1)).reshape(-1), weights=w,
                               minlength=nr * nr)
    return (float(loss_sum), cm_b.reshape(nb, nb).cpu().numpy(),
            cm_r.reshape(nr, nr).cpu().numpy())


def accuracy_from_cm(cm: np.ndarray) -> float:
    denom = max(1.0, float(cm.sum()))
    return 100.0 * float(np.trace(cm)) / denom


def evaluate(params, test_files, batch_size: int = 100, num_workers: int = 8,
             backend: Optional[str] = None,
             dataset: Optional[MarginPolishDataset] = None) -> Dict[str, object]:
    """Evaluate ``params`` (tensors on the device to run on) over labeled
    images; returns loss, accuracies and confusion matrices. Pass a prebuilt
    ``dataset`` to skip re-indexing the files (the Trainer evaluates every
    epoch).

    In a multi-process job each process scores its contiguous block of the
    images (parallel.multihost.host_image_shard); the image count and the
    confusion matrices are summed exactly over the processes, the loss in
    float32 in rank order, so every process returns the same loss, bit for
    bit (helen_tpu's ``shard_across_hosts``, ``evaluate.py:145-195``)."""
    from helen_tpu_torch.parallel import multihost

    leaf = params["base_head"]["w"]
    backend = resolve_backend(backend, leaf.device, params)
    if dataset is None:
        dataset = MarginPolishDataset(test_files, IMAGE, with_labels=True)
    if len(dataset) == 0:
        raise ValueError("no labeled images found for evaluation")
    multi = multihost.process_count() > 1
    indices = multihost.host_image_shard(len(dataset)) if multi else None
    n_windows = WINDOW.num_windows(IMAGE.seq_length)
    geom = model_geometry(params)
    total_loss = 0.0
    total_images = 0
    cm_base = np.zeros((geom.num_base_classes,) * 2)
    cm_rle = np.zeros((geom.num_rle_classes,) * 2)
    for batch in batched_image_iterator(dataset, batch_size, num_workers, pad_final=True,
                                        indices=indices):
        B, L = batch.images.shape[:2]
        col_mask = np.zeros((B, L), dtype=np.float32)
        for i, rec in enumerate(batch.records):  # records cover real rows only
            col_mask[i] = rec.position[:, 0] >= 0
        to_dev = lambda a: torch.from_numpy(a).to(leaf.device)  # noqa: E731
        loss_sum, cb, cr = eval_batch(
            params, to_dev(batch.images), to_dev(batch.labels_base).long(),
            to_dev(batch.labels_rle).long(), to_dev(col_mask), batch.valid, backend)
        # reference accounting: loss summed per window, normalised by
        # images-per-window counts (test.py:124-125,154)
        total_loss += loss_sum
        total_images += batch.valid * n_windows
        cm_base += cb
        cm_rle += cr
    if multi:
        # the loss in float32, rounded the same way on every process (what
        # the scheduler's lockstep needs); the counts exactly
        total_loss = float(multihost.allsum_hosts(
            np.asarray([total_loss], dtype=np.float64))[0])
        counts = multihost.allsum_hosts_exact(np.concatenate([
            np.asarray([total_images], dtype=np.float64), cm_base.ravel(), cm_rle.ravel()]))
        total_images = int(counts[0])
        nb2 = cm_base.size
        cm_base = counts[1:1 + nb2].reshape(cm_base.shape).astype(np.float64)
        cm_rle = counts[1 + nb2:].reshape(cm_rle.shape).astype(np.float64)
    avg_loss = total_loss / total_images if total_images else 0.0
    return {
        "loss": float(avg_loss),
        "base_accuracy": accuracy_from_cm(cm_base),
        "rle_accuracy": accuracy_from_cm(cm_rle),
        "accuracy": accuracy_from_cm(cm_base),
        "base_confusion_matrix": cm_base,
        "rle_confusion_matrix": cm_rle,
    }


def save_confusion_png(cm: np.ndarray, title: str, path: str) -> Optional[str]:
    """Confusion-matrix heatmap (reference TestInterface.py:24-87); skipped
    with a warning where matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        log.warning("matplotlib unavailable; skipping confusion PNG")
        return None
    fig, ax = plt.subplots(figsize=(6, 5))
    norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1.0)
    im = ax.imshow(norm, cmap="viridis", vmin=0.0, vmax=1.0)
    ax.set_xlabel("predicted")
    ax.set_ylabel("truth")
    ax.set_title(title)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, f"{int(cm[i, j])}", ha="center", va="center",
                    color="white" if norm[i, j] < 0.5 else "black", fontsize=7)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def test_interface(test_dir: str, model_path: str, batch_size: int = 100,
                   num_workers: int = 8, output_dir: str = "./test_out/",
                   device: str = "cuda", backend: Optional[str] = None,
                   debug_mismatches: bool = False) -> Dict[str, object]:
    """CLI entry: evaluate a model, write the confusion artifacts
    (``confusion_matrix.txt``, the PNGs, and ``test_stats.json`` with the
    loss and both matrices). In a multi-process job the images are sharded
    over the processes (:func:`evaluate`), every process returns the
    summed stats, and process 0 writes the artifacts. ``debug_mismatches``
    also writes ``mismatches.txt`` (eval.debug.dump_mismatches over all
    the images, by process 0)."""
    from helen_tpu_torch.parallel import multihost

    dev = resolve_device(device)
    set_fp32_precision()
    params_np, _ = load_model_any(model_path)
    params = params_to_torch(params_np, dev)
    backend = resolve_backend(backend, dev, params)
    files = list_image_files(test_dir)
    stats = evaluate(params, files, batch_size, num_workers, backend=backend)
    if multihost.process_index() != 0:
        return stats
    ensure_output_dir(output_dir)
    log.info("test loss %.6f | base acc %.3f%% | rle acc %.3f%% (backend %s, "
             "kernels: %s)", stats["loss"], stats["base_accuracy"],
             stats["rle_accuracy"], backend, engaged_kernel(params, backend))
    np.set_printoptions(linewidth=200)
    with open(os.path.join(output_dir, "confusion_matrix.txt"), "w") as f:
        f.write("base confusion matrix (rows=truth)\n")
        f.write(str(stats["base_confusion_matrix"].astype(np.int64)) + "\n")
        f.write("rle confusion matrix (rows=truth)\n")
        f.write(str(stats["rle_confusion_matrix"].astype(np.int64)) + "\n")
    with open(os.path.join(output_dir, "test_stats.json"), "w") as f:
        json.dump({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in stats.items()}, f)
    save_confusion_png(stats["base_confusion_matrix"], "base classes",
                       os.path.join(output_dir, "base_confusion.png"))
    save_confusion_png(stats["rle_confusion_matrix"], "RLE classes",
                       os.path.join(output_dir, "rle_confusion.png"))
    if debug_mismatches:
        from helen_tpu_torch.eval.debug import dump_mismatches

        dump_mismatches(params, files, os.path.join(output_dir, "mismatches.txt"),
                        batch_size=batch_size, num_workers=num_workers, backend=backend)
    return stats
