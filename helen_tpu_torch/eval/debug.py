"""Debug evaluation: per-position mismatch dump with feature rendering (port
of helen_tpu/eval/debug.py).

Equivalent of the reference debug test path (models/test_debug.py:39-205),
which documents the pileup feature layout by rendering each mismatching
column's 90 features split as A/C/G/T x 22 (11 run-lengths x 2 strands) plus
the 2 gap features (test_debug.py:144-151). The labels are the consensus
vote over the windows (``models.transducer.consensus_labels``), on the
backend the caller resolved: K1/K2 (or K3 for the wide models) on a CUDA
device, their plain versions on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from helen_tpu_torch.config import IMAGE, LABEL_DECODER
from helen_tpu_torch.io.images import MarginPolishDataset, batched_image_iterator
from helen_tpu_torch.obs import get_logger

log = get_logger("debug")

_BLOCKS = (("A", 0, 22), ("C", 22, 44), ("G", 44, 66), ("T", 66, 88), ("*", 88, 90))


def render_feature_column(features: np.ndarray) -> str:
    """Human-readable rendering of one 90-feature pileup column."""
    parts = []
    for name, lo, hi in _BLOCKS:
        block = features[lo:hi]
        if block.max() == 0:
            continue
        if name == "*":
            parts.append(f"*:[{block[0]},{block[1]}]")
        else:
            runs = []
            for r in range(11):
                fwd, rev = int(block[2 * r]), int(block[2 * r + 1])
                if fwd or rev:
                    runs.append(f"{r + 1}x({fwd},{rev})")
            parts.append(f"{name}:{','.join(runs)}")
    return " ".join(parts) if parts else "(empty)"


@torch.no_grad()
def dump_mismatches(
    params,
    files: Sequence[str],
    output_path: str,
    batch_size: int = 64,
    num_workers: int = 4,
    max_records: int = 10000,
    backend: Optional[str] = None,
) -> int:
    """Evaluate and write every mismatching position with its features.
    ``params`` are tensors on the device to run on; ``backend`` as
    ``models.transducer.resolve_backend`` takes it.

    Returns the number of mismatches written.
    """
    from helen_tpu_torch.models.transducer import consensus_labels, resolve_backend

    dev = params["base_head"]["w"].device
    backend = resolve_backend(backend, dev, params)
    dataset = MarginPolishDataset(files, IMAGE, with_labels=True)
    written = 0
    with open(output_path, "w") as out:
        for batch in batched_image_iterator(dataset, batch_size, num_workers):
            pb, pr = consensus_labels(params, torch.from_numpy(batch.images).to(dev),
                                      backend=backend)
            pb, pr = pb.cpu().numpy(), pr.cpu().numpy()
            for j in range(batch.valid):
                rec = batch.records[j]
                # mask zero-padded columns of short images (position rows are
                # (-1,-1,-1)): the model's guess on an all-zero pileup column
                # vs the 0-padded label is not a real mismatch
                real = rec.position[:, 0] >= 0
                mism = np.nonzero(
                    ((pb[j] != rec.label_base) | (pr[j] != rec.label_rle)) & real
                )[0]
                for pos in mism:
                    if written >= max_records:
                        log.warning("mismatch dump truncated at %d records", max_records)
                        return written
                    out.write(
                        f"{rec.contig}:{rec.position[pos, 0]} "
                        f"true={LABEL_DECODER.get(int(rec.label_base[pos]), '?')}"
                        f"x{int(rec.label_rle[pos])} "
                        f"pred={LABEL_DECODER.get(int(pb[j, pos]), '?')}x{int(pr[j, pos])} | "
                        f"{render_feature_column(rec.image[pos])}\n"
                    )
                    written += 1
    log.info("wrote %d mismatches to %s", written, output_path)
    return written
