"""helen_tpu's command lines through the port's CLI, on the CPU.

``--platform cpu`` (helen_tpu's top-level flag) selects ``--device cpu``;
helen_tpu's single-host defaults ``--host_shard image`` and
``--barrier_timeout 86400`` run when given; an incomplete multi-process job
is an argparse error naming what it lacks; helen_tpu's subcommands that the
port lacks parse with helen_tpu's arguments and exit with "not yet ported",
not with argparse's "invalid choice".
"""
import hashlib

import pytest
import torch

from torch_port_fixtures import golden, stage_golden_images

torch.set_num_threads(2)


def cli(*argv):
    from helen_tpu_torch.cli import main

    return main([str(a) for a in argv])


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def device_cpu_fasta(tmp_path_factory):
    """The FASTA of ``polish --device cpu`` on the golden images."""
    tmp = tmp_path_factory.mktemp("device_cpu")
    images = stage_golden_images(tmp / "images")
    assert cli("polish", "-i", images, "-m", golden("golden_model.pkl"), "-o", tmp / "out",
               "--device", "cpu", "-t", 2) == 0
    return sha256(tmp / "out" / "HELEN_prediction.fa")


@pytest.mark.parametrize("argv", [
    ["--platform", "cpu", "polish"],
    ["polish", "--device", "cpu", "--host_shard", "image"],
    ["polish", "--device", "cpu", "--host_shard", "file"],
    ["polish", "--device", "cpu", "--barrier_timeout", "86400"],
], ids=["platform_cpu", "host_shard_image", "host_shard_file", "barrier_timeout"])
def test_helen_tpu_single_host_flags_polish_like_device_cpu(tmp_path, device_cpu_fasta,
                                                           argv):
    images = stage_golden_images(tmp_path / "images")
    assert cli(*argv, "-i", images, "-m", golden("golden_model.pkl"), "-o", tmp_path / "out",
               "-t", 2) == 0
    assert sha256(tmp_path / "out" / "HELEN_prediction.fa") == device_cpu_fasta
    assert device_cpu_fasta == sha256(golden("golden.fa"))


def test_platform_flag_sets_the_device():
    from helen_tpu_torch.cli import build_parser

    parser = build_parser()
    assert parser.parse_args(["polish", "-i", "i", "-m", "m"]).platform == "auto"
    args = parser.parse_args(["--platform", "cpu", "train", "--train_image_dir", "a",
                              "--test_image_dir", "b"])
    assert (args.platform, args.device) == ("cpu", "cuda")  # main() applies it
    with pytest.raises(SystemExit):
        parser.parse_args(["--platform", "tpu", "version"])


def test_platform_auto_keeps_the_gpu_default(capsys):
    """``--platform auto`` leaves ``--device cuda``: without a GPU the model
    subcommands refuse to run, as they do with no flag."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: --device cuda would run")
    with pytest.raises(SystemExit) as exc:
        cli("--platform", "auto", "call_consensus", "-i", "imgs", "-m", "model.pkl")
    assert exc.value.code == 2
    assert "not yet ported" not in capsys.readouterr().err


def test_call_consensus_takes_host_shard_image(tmp_path):
    images = stage_golden_images(tmp_path / "images")
    assert cli("--platform", "cpu", "call_consensus", "-i", images, "-m",
               golden("golden_model.pkl"), "-o", tmp_path / "out",
               "--host_shard", "image") == 0


@pytest.mark.parametrize("argv", [
    ["download_models", "-o", "models"],
    ["convert", "-i", "model.pkl", "-o", "model.npz"],
    ["hyperband", "--train_image_dir", "tr", "--test_image_dir", "te"],
    ["assess", "-t", "truth.fa", "-p", "polished.fa", "--json"],
], ids=["download_models", "convert", "hyperband", "assess"])
def test_unported_subcommands_say_not_yet_ported(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli(*argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and f"the {argv[0]} subcommand" in err
    assert "invalid choice" not in err


@pytest.mark.parametrize("argv,missing", [
    (["--num_processes", "2", "polish", "--host_shard", "image"],
     "--num_processes also needs --coordinator_address and --process_id"),
    (["--coordinator_address", "localhost:1234", "polish", "--barrier_timeout", "60"],
     "--coordinator_address also needs --num_processes and --process_id"),
], ids=["host_shard", "barrier_timeout"])
def test_multi_host_flags_raise_with_a_multi_process_job(argv, missing, capsys):
    """Multi-process jobs run (tests/test_torch_multihost.py); one whose
    flags are incomplete is an argparse error naming what it lacks."""
    with pytest.raises(SystemExit) as exc:
        cli(*argv, "-i", "imgs", "-m", "model.pkl", "--device", "cpu")
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert missing in err and "not yet ported" not in err
