"""Command-line interface for helen_tpu_torch.

Subcommands and flags mirror helen_tpu/cli.py, so one command line runs
either package: ``polish``, ``call_consensus``, ``stitch``, ``train``,
``test``, ``devices`` and ``version``. The model subcommands run on the GPU
by default (``--device cuda``, an error when there is none) and take
``--device cpu``, or helen_tpu's top-level ``--platform cpu``.
The single-host I/O flags run as in helen_tpu (``--pack``, ``--writers``,
``--resume``, ``--fastq``/``--qualities``). Flags and subcommands of
helen_tpu paths that are not ported yet (multi-process jobs,
``--model_parallel > 1``, ``--debug_mismatches``, ``download_models``,
``convert``, ``hyperband``, ``assess``) are accepted and raise a "not yet
ported" error instead of doing something else.

Run as ``python -m helen_tpu_torch`` or via the ``helen_tpu_torch`` console
script.
"""
from __future__ import annotations

import argparse
import sys


def _add_common_consensus_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-i", "--image_dir", required=True,
                   help="directory of MarginPolish image files (*.h5)")
    p.add_argument("-m", "--model_path", required=True,
                   help="trained model (.pkl reference checkpoint or .npz native)")
    p.add_argument("-b", "--batch_size", type=int, default=512)
    p.add_argument("-w", "--num_workers", type=int, default=8,
                   help="host threads for image loading")
    p.add_argument("-o", "--output_dir", default="./output/")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="compute device (default cuda: an error without a GPU)")
    p.add_argument("--backend", default=None,
                   choices=["auto", "cuda", "torch", "xla", "pallas", "pallas_fast"],
                   help="auto: the CUDA window kernels on the GPU, their plain "
                        "torch versions on the CPU; cuda: the kernels; torch: "
                        "the plain versions; helen_tpu's names: xla = torch, "
                        "pallas = auto, pallas_fast = the fast (bf16) tier")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace (trace.json) here")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="device batches in flight: host->device transfer of "
                        "batch k+1 overlaps compute of batch k and readback "
                        "of batch k-1")
    p.add_argument("--no_data_parallel", action="store_true",
                   help="accepted for helen_tpu compatibility; the port runs "
                        "on one device")
    p.add_argument("--fast", action="store_true",
                   help="the fast tier (--backend pallas_fast): bf16 operands, "
                        "float32 sums, gates and state; labels can flip on "
                        "near-tie votes")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run: skip every record already "
                        "in the prediction stores (polish: the newest "
                        "predictions_* directory of the output dir)")
    p.add_argument("--pack", action="store_true",
                   help="build/reuse a packed contiguous image cache for "
                        "slab-read streaming (images_cache.h5 in the output dir)")
    p.add_argument("--writers", type=int, default=1,
                   help="prediction-writer processes, each writing one shard "
                        "file (stitch merges them)")
    p.add_argument("--host_shard", default="image", choices=["image", "file"],
                   help="multi-host work partition; one host takes every image "
                        "(multi-host jobs: not yet ported)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="helen_tpu_torch",
        description="GPU assembly polisher: the PyTorch/CUDA port of helen_tpu",
    )
    parser.add_argument("--platform", choices=["auto", "cpu"], default="auto",
                        help="cpu = --device cpu for the model subcommands; auto "
                             "keeps --device (default cuda)")
    # multi-process jobs are not ported yet: these raise when given
    parser.add_argument("--distributed", action="store_true",
                        help="(multi-process jobs: not yet ported)")
    parser.add_argument("--coordinator_address", default=None,
                        help="(not yet ported)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="(not yet ported)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="(not yet ported)")
    sub = parser.add_subparsers(dest="command")

    p = sub.add_parser("polish", help="images -> consensus -> stitch -> polished FASTA")
    _add_common_consensus_args(p)
    p.add_argument("-t", "--threads", type=int, default=4, help="stitch process count")
    p.add_argument("-p", "--output_prefix", default="HELEN_prediction")
    p.add_argument("--fastq", action="store_true",
                   help="emit <prefix>.fq with per-base phred qualities from the "
                        "consensus vote")
    p.add_argument("--barrier_timeout", type=float, default=86400.0,
                   help="multi-host barrier timeout in seconds; unused on one host "
                        "(multi-host jobs: not yet ported)")
    p.add_argument("--no_stream_stitch", action="store_true",
                   help="stitch after consensus from the prediction store "
                        "instead of overlapping the two (byte-identical)")

    p = sub.add_parser("call_consensus", help="run model inference, write prediction HDF5")
    _add_common_consensus_args(p)
    p.add_argument("-p", "--output_prefix", default="helen_predictions")
    p.add_argument("--qualities", action="store_true",
                   help="store a per-column phred quality beside the labels (for "
                        "stitch --fastq)")

    p = sub.add_parser("stitch", help="stitch prediction HDF5 files into FASTA")
    p.add_argument("-i", "--input_dir", required=True,
                   help="directory containing prediction (*.hdf) files")
    p.add_argument("-o", "--output_dir", default="./output/")
    p.add_argument("-p", "--output_prefix", default="HELEN_prediction")
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("--fastq", action="store_true",
                   help="emit FASTQ (requires a --qualities prediction store)")

    p = sub.add_parser("train", help="train the transducer model")
    p.add_argument("--train_image_dir", required=True)
    p.add_argument("--test_image_dir", required=True)
    p.add_argument("-b", "--batch_size", type=int, default=100)
    p.add_argument("-e", "--epoch_size", type=int, default=10, help="epochs to run")
    p.add_argument("-w", "--num_workers", type=int, default=16)
    p.add_argument("-o", "--model_out", default="./model_out/",
                   help="output dir for checkpoints and stats")
    p.add_argument("--retrain_model_path", default=None,
                   help="checkpoint to continue training from")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--decay", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="compute device (default cuda: an error without a GPU)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cuda", "torch", "xla", "pallas_train"],
                   help="auto: the CUDA window kernels (forward and backward) on "
                        "the GPU, plain torch on the CPU; helen_tpu's xla and "
                        "pallas_train are aliases of torch and cuda")
    p.add_argument("--hidden_size", type=int, default=128,
                   help="GRU hidden size for a FRESH model (retraining "
                        "follows the checkpoint's geometry)")
    p.add_argument("--gru_layers", type=int, default=1,
                   help="stacked GRU layers per encoder/decoder for a FRESH model")
    p.add_argument("--pack", action="store_true",
                   help="build/reuse a packed cache of the labeled training images "
                        "(train_images_cache.h5 in the output dir)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel width (> 1 not yet ported)")

    p = sub.add_parser("test", help="evaluate a model on labeled images")
    p.add_argument("--test_image_dir", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-b", "--batch_size", type=int, default=100)
    p.add_argument("-w", "--num_workers", type=int, default=8)
    p.add_argument("-o", "--output_dir", default="./test_out/")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="compute device (default cuda: an error without a GPU)")
    p.add_argument("--debug_mismatches", action="store_true", help="(not yet ported)")

    # helen_tpu's other subcommands, with its arguments: not ported yet
    p = sub.add_parser("download_models", help="(not yet ported)")
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--manifest_url", default=None)

    p = sub.add_parser("convert", help="(not yet ported)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("hyperband", help="(not yet ported)")
    p.add_argument("--train_image_dir", required=True)
    p.add_argument("--test_image_dir", required=True)
    p.add_argument("-o", "--output_dir", default="./hyperband_out/")
    p.add_argument("-b", "--batch_size", type=int, default=32)
    p.add_argument("--max_epochs", type=int, default=9)
    p.add_argument("--eta", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("assess", help="(not yet ported)")
    p.add_argument("-t", "--truth", required=True)
    p.add_argument("-p", "--polished", required=True)
    p.add_argument("--max_band", type=int, default=1 << 20)
    p.add_argument("--json", action="store_true")
    p.add_argument("-b", "--bed", default=None)

    sub.add_parser("devices", help="show the CUDA devices torch sees")
    sub.add_parser("version", help="print version")
    return parser


def cmd_devices() -> None:
    import torch

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        print(f"  cuda:{i}: {props.name} ({props.total_memory / 2**30:.0f} GiB, "
              f"sm_{props.major}{props.minor}, {props.multi_processor_count} SMs)")
    print(f"cuda devices: {n}")


#: helen_tpu subcommands that parse and then raise "not yet ported"
UNPORTED_COMMANDS = ("download_models", "convert", "hyperband", "assess")


def _unported(args):
    """The first subcommand or flag given whose helen_tpu path is not
    ported, or None. ``--host_shard`` and ``--barrier_timeout`` matter only
    to a multi-process job, which the first check refuses."""
    checks = [
        (f"the {args.command} subcommand", args.command in UNPORTED_COMMANDS),
        ("multi-process jobs (--distributed/--coordinator_address/"
         "--num_processes/--process_id)",
         args.distributed or args.coordinator_address is not None
         or args.num_processes is not None or args.process_id is not None),
        ("--model_parallel > 1", getattr(args, "model_parallel", 1) > 1),
        ("--debug_mismatches", getattr(args, "debug_mismatches", False)),
    ]
    return next((what for what, given in checks if given), None)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    unported = _unported(args)
    if unported:
        parser.error(f"{unported} is not yet ported to helen_tpu_torch "
                     "(ROADMAP.md, queue A); use helen_tpu")
    if args.platform == "cpu" and hasattr(args, "device"):
        args.device = "cpu"
    if getattr(args, "fast", False):
        if args.backend:
            parser.error("--fast and --backend are mutually exclusive "
                         "(--fast means --backend pallas_fast)")
        args.backend = "pallas_fast"
    if args.command in ("polish", "call_consensus", "train", "test"):
        from helen_tpu_torch.infer.consensus import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as exc:  # --device cuda without a GPU
            parser.error(str(exc))

    if args.command == "version":
        from helen_tpu_torch.version import __version__

        print(f"helen_tpu_torch {__version__}")
        return 0

    if args.command == "devices":
        cmd_devices()
        return 0

    if args.command == "polish":
        from helen_tpu_torch.infer.polish import polish

        fasta = polish(
            image_dir=args.image_dir,
            model_path=args.model_path,
            output_dir=args.output_dir,
            batch_size=args.batch_size,
            num_workers=args.num_workers,
            threads=args.threads,
            output_prefix=args.output_prefix,
            resume=args.resume,
            profile_dir=args.profile_dir,
            backend=args.backend,
            pack=args.pack,
            num_writers=args.writers,
            pipeline_depth=args.pipeline_depth,
            fastq=args.fastq,
            stream_stitch=not args.no_stream_stitch,
            device=args.device,
        )
        print(fasta)
        return 0

    if args.command == "call_consensus":
        from helen_tpu_torch.infer.consensus import call_consensus

        files = call_consensus(
            image_dir=args.image_dir,
            model_path=args.model_path,
            output_dir=args.output_dir,
            batch_size=args.batch_size,
            num_workers=args.num_workers,
            output_prefix=args.output_prefix,
            resume=args.resume,
            profile_dir=args.profile_dir,
            backend=args.backend,
            pack=args.pack,
            num_writers=args.writers,
            qualities=args.qualities,
            pipeline_depth=args.pipeline_depth,
            device=args.device,
        )
        for f in files:
            print(f)
        return 0

    if args.command == "train":
        from helen_tpu_torch.train.train_loop import train_interface

        train_interface(
            train_dir=args.train_image_dir,
            test_dir=args.test_image_dir,
            batch_size=args.batch_size,
            epochs=args.epoch_size,
            num_workers=args.num_workers,
            output_dir=args.model_out,
            retrain_model_path=args.retrain_model_path,
            learning_rate=args.lr,
            weight_decay=args.decay,
            seed=args.seed,
            backend=args.backend,
            hidden_size=args.hidden_size,
            gru_layers=args.gru_layers,
            device=args.device,
            pack=args.pack,
        )
        return 0

    if args.command == "test":
        from helen_tpu_torch.train import evaluate

        evaluate.test_interface(
            test_dir=args.test_image_dir,
            model_path=args.model_path,
            batch_size=args.batch_size,
            num_workers=args.num_workers,
            output_dir=args.output_dir,
            device=args.device,
        )
        return 0

    if args.command == "stitch":
        from helen_tpu_torch.infer.polish import perform_stitch

        print(perform_stitch(
            input_directory=args.input_dir,
            output_dir=args.output_dir,
            output_prefix=args.output_prefix,
            threads=args.threads,
            fastq=args.fastq,
        ))
        return 0

    parser.error(f"unknown command {args.command}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
