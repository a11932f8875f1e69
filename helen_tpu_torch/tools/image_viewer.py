"""ASCII renderer for MarginPolish pileup images.

Equivalent of the reference's tensor_analyzer.py: prints each column's
position, labels (when present) and the active weight cells of the
90-feature vector decoded as base x run-length x strand.
"""
from __future__ import annotations

import argparse

from helen_tpu_torch.config import LABEL_DECODER
from helen_tpu_torch.eval.debug import render_feature_column
from helen_tpu_torch.io.images import MarginPolishDataset


def render_image(record, start: int = 0, end: int = None, out=None) -> None:
    import sys

    out = out or sys.stdout
    end = end if end is not None else record.image.shape[0]
    out.write(
        f"# {record.contig}:{record.contig_start}-{record.contig_end} "
        f"chunk {record.chunk_id} ({record.filename})\n"
    )
    for i in range(start, min(end, record.image.shape[0])):
        pos = record.position[i]
        if pos[0] < 0:
            continue
        label = ""
        if record.label_base is not None:
            label = (
                f" true={LABEL_DECODER.get(int(record.label_base[i]), '?')}"
                f"x{int(record.label_rle[i])}"
            )
        out.write(
            f"{int(pos[0]):>9}.{int(pos[1])}.{int(pos[2])}{label} | "
            f"{render_feature_column(record.image[i])}\n"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="render pileup images as text")
    ap.add_argument("-i", "--image_file", required=True)
    ap.add_argument("--index", type=int, default=0, help="image index in the file")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=50)
    ap.add_argument("--labels", action="store_true", help="read label datasets too")
    args = ap.parse_args(argv)
    ds = MarginPolishDataset([args.image_file], with_labels=args.labels)
    if args.index >= len(ds):
        ap.error(f"file has only {len(ds)} images")
    render_image(ds.load(args.index), args.start, args.end)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
