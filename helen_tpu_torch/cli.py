"""Command-line interface for helen_tpu_torch.

Subcommands and flags mirror helen_tpu/cli.py, so one command line runs
either package: ``polish``, ``call_consensus``, ``stitch``, ``train``
(``--model_parallel N``: data x tensor parallel over this process's
devices), ``test`` (``--debug_mismatches``), ``hyperband``, ``convert``
(``.npz``, ``.pkl``, ``.onnx``), ``download_models``, ``assess`` (``--bed``),
``devices`` and ``version``. The model subcommands run on the GPU by
default (``--device cuda``, an error when there is none) and take
``--device cpu``, or helen_tpu's top-level ``--platform cpu``; ``convert``
uses the device only for an ``.onnx`` file's self-check.
The single-host I/O flags run as in helen_tpu (``--pack``, ``--writers``,
``--resume``, ``--fastq``/``--qualities``), and so do multi-process jobs
(``--coordinator_address``/``--num_processes``/``--process_id``, or
``--distributed`` under torchrun; parallel.multihost, gloo). With none of
those flags, ``polish``, ``call_consensus``, ``train`` and ``test`` on a
host with several visible GPUs run one worker process per GPU
(``--no_data_parallel``: one process on one GPU; ``--model_parallel`` > 1
also keeps one process).

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
                   help="one process on one GPU, where several are visible "
                        "(default: one worker process per visible GPU)")
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
                   help="multi-process work partition: image = contiguous "
                        "equal-count image blocks, file = round-robin whole files")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="helen_tpu_torch",
        description="GPU assembly polisher: the PyTorch/CUDA port of helen_tpu",
    )
    parser.add_argument("--platform", choices=["auto", "cpu"], default="auto",
                        help="cpu = --device cpu for the model subcommands; auto "
                             "keeps --device (default cuda)")
    # multi-process jobs on torch.distributed with gloo (parallel.multihost)
    parser.add_argument("--distributed", action="store_true",
                        help="join a multi-process job from torchrun's environment "
                             "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    parser.add_argument("--coordinator_address", default=None,
                        help="process 0's host:port (with --num_processes and "
                             "--process_id; alternative to --distributed)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    sub = parser.add_subparsers(dest="command")

    p = sub.add_parser("polish", help="images -> consensus -> stitch -> polished FASTA")
    _add_common_consensus_args(p)
    p.add_argument("-t", "--threads", type=int, default=4, help="stitch process count")
    p.add_argument("-p", "--output_prefix", default="HELEN_prediction")
    p.add_argument("--fastq", action="store_true",
                   help="emit <prefix>.fq with per-base phred qualities from the "
                        "consensus vote")
    p.add_argument("--barrier_timeout", type=float, default=86400.0,
                   help="multi-process barrier timeout in seconds (processes "
                        "park behind process 0's stitch; default 24 h)")
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
                   help="tensor-parallel width: > 1 trains data x tensor parallel "
                        "over this process's devices (GRU units and head inputs "
                        "split over the model axis; the plain recurrence)")

    p = sub.add_parser("test", help="evaluate a model on labeled images")
    p.add_argument("--test_image_dir", required=True)
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-b", "--batch_size", type=int, default=100)
    p.add_argument("-w", "--num_workers", type=int, default=8)
    p.add_argument("-o", "--output_dir", default="./test_out/")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="compute device (default cuda: an error without a GPU)")
    p.add_argument("--debug_mismatches", action="store_true",
                   help="also write every mismatching position with its "
                        "features (mismatches.txt)")

    p = sub.add_parser("download_models", help="download released HELEN models")
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--manifest_url", default=None)

    p = sub.add_parser(
        "convert",
        help="convert checkpoints between reference .pkl and native .npz, or "
             "export .onnx",
    )
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True,
                   help="output path; .npz, .pkl or .onnx decides the format")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where an .onnx export checks itself against the port's "
                        "forward (default cuda: an error without a GPU)")

    p = sub.add_parser("hyperband", help="successive-halving (lr, decay) search")
    p.add_argument("--train_image_dir", required=True)
    p.add_argument("--test_image_dir", required=True)
    p.add_argument("-o", "--output_dir", default="./hyperband_out/")
    p.add_argument("-b", "--batch_size", type=int, default=32)
    p.add_argument("--max_epochs", type=int, default=9)
    p.add_argument("--eta", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="compute device (default cuda: an error without a GPU)")

    p = sub.add_parser("assess", help="polished-vs-truth error rate / Q "
                       "(native banded edit distance; helen_tpu extension)")
    p.add_argument("-t", "--truth", required=True)
    p.add_argument("-p", "--polished", required=True)
    p.add_argument("--max_band", type=int, default=1 << 20)
    p.add_argument("--json", action="store_true")
    p.add_argument("-b", "--bed", default=None,
                   help="masked-regions BED (truth-space): SSW-anchored "
                        "masking of both fastas before assessing")

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


#: the subcommands that run as a multi-process job
JOB_COMMANDS = ("polish", "call_consensus", "train", "test")


def _local_devices(args):
    """The devices of one worker process each, when this command runs as a
    job of local workers: ``--device cuda``, no job flags, no
    ``--no_data_parallel``, no ``--model_parallel`` > 1 (one process drives
    its devices' mesh) and more than one visible GPU; else None."""
    if (args.command not in JOB_COMMANDS or args.device != "cuda"
            or getattr(args, "no_data_parallel", False)
            or getattr(args, "model_parallel", 1) > 1):
        return None
    import torch

    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n > 1 else None


def main(argv=None) -> int:
    parser = build_parser()
    argv = sys.argv[1:] if argv is None else [str(a) for a in argv]
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    if args.platform == "cpu" and hasattr(args, "device"):
        args.device = "cpu"
    if getattr(args, "fast", False):
        if args.backend:
            parser.error("--fast and --backend are mutually exclusive "
                         "(--fast means --backend pallas_fast)")
        args.backend = "pallas_fast"
    if args.command in JOB_COMMANDS:
        from helen_tpu_torch.infer.consensus import resolve_device
        from helen_tpu_torch.parallel import multihost

        missing = multihost.missing_flags(args.distributed, args.coordinator_address,
                                          args.num_processes, args.process_id)
        if missing:
            parser.error(missing)
        try:
            resolve_device(args.device)
        except RuntimeError as exc:  # --device cuda without a GPU
            parser.error(str(exc))
        if args.distributed or args.coordinator_address is not None:
            multihost.initialize(
                coordinator_address=args.coordinator_address,
                num_processes=args.num_processes,
                process_id=args.process_id,
                auto=args.distributed,
                timeout_s=getattr(args, "barrier_timeout",
                                  multihost.DEFAULT_BARRIER_TIMEOUT_S),
            )
            try:
                return _run(args, parser)
            finally:
                multihost.shutdown()
        devices = _local_devices(args)
        if devices:
            return multihost.launch_local(argv, devices)
    return _run(args, parser)


def _run(args, parser) -> int:
    """Run the parsed command in this process."""
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
            host_shard=args.host_shard,
            barrier_timeout_s=args.barrier_timeout,
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
            host_shard=args.host_shard,
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
            model_parallel=args.model_parallel,
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
            debug_mismatches=args.debug_mismatches,
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

    if args.command == "hyperband":
        from helen_tpu_torch.infer.consensus import resolve_device
        from helen_tpu_torch.train.hyperband import hyperband_interface

        try:
            resolve_device(args.device)
        except RuntimeError as exc:  # --device cuda without a GPU
            parser.error(str(exc))
        best = hyperband_interface(
            args.train_image_dir, args.test_image_dir, args.output_dir,
            args.batch_size, args.max_epochs, args.eta, seed=args.seed,
            device=args.device,
        )
        print(f"best lr={best.params['learning_rate']:.3e} "
              f"decay={best.params['weight_decay']:.3e} loss={best.loss:.6f}")
        return 0

    if args.command == "download_models":
        from helen_tpu_torch.io.download import download_models

        download_models(args.output_dir, args.manifest_url)
        return 0

    if args.command == "convert":
        from helen_tpu_torch.io.checkpoint import (
            export_torch_checkpoint,
            load_model_any,
            save_checkpoint,
        )

        params, meta = load_model_any(args.input)
        if args.output.endswith(".pkl"):
            export_torch_checkpoint(args.output, params, meta)
        elif args.output.endswith(".onnx"):
            # the reference's CPU path exports ONNX (predict_cpu.py:224-239);
            # export verifies itself by parsing the bytes back and running a
            # batch through the numpy evaluator against the port's forward
            from helen_tpu_torch.infer.consensus import resolve_device
            from helen_tpu_torch.io.onnx_export import export_onnx

            try:
                resolve_device(args.device)
            except RuntimeError as exc:  # --device cuda without a GPU
                parser.error(str(exc))
            export_onnx(params, args.output, device=args.device)
        else:
            save_checkpoint(args.output, params, meta=meta)
        print(args.output)
        return 0

    if args.command == "assess":
        from helen_tpu_torch.tools.assess_polish import main as assess_main

        argv = ["-t", args.truth, "-p", args.polished, "--max_band", str(args.max_band)]
        if args.json:
            argv.append("--json")
        if args.bed:
            argv += ["-b", args.bed]
        return assess_main(argv)

    parser.error(f"unknown command {args.command}")
    return 2


if __name__ == "__main__":
    sys.exit(main())
