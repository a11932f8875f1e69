"""helen_tpu's command lines through the port's CLI, on the CPU.

``--platform cpu`` (helen_tpu's top-level flag) selects ``--device cpu``;
helen_tpu's single-host defaults ``--host_shard image`` and
``--barrier_timeout 86400`` run when given; an incomplete multi-process job
is an argparse error naming what it lacks; helen_tpu's other subcommands
(``download_models``, ``convert``, ``hyperband``, ``assess``) run with
helen_tpu's arguments.
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
def test_unported_subcommands_say_not_yet_ported(argv, tmp_path, capsys, monkeypatch):
    """helen_tpu's subcommands that the port once refused with "not yet
    ported" now run with helen_tpu's arguments: ``download_models`` over a
    ``file://`` manifest, ``convert`` of the golden ``.pkl``, ``hyperband``
    (``--max_epochs 1``: one trial, one epoch) on the CPU, ``assess`` of
    the golden FASTA against itself."""
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    monkeypatch.chdir(tmp_path)
    extra = []
    if argv[0] == "download_models":
        (tmp_path / "m.csv").write_text(f"golden_model.pkl,file://{golden('golden_model.pkl')}\n")
        monkeypatch.setenv("HELEN_TPU_MODEL_MANIFEST", f"file://{tmp_path / 'm.csv'}")
    elif argv[0] == "convert":
        argv = ["convert", "-i", golden("golden_model.pkl"), "-o", "model.npz"]
    elif argv[0] == "hyperband":
        for name, bp in (("tr", 1200), ("te", 900)):
            (tmp_path / name).mkdir()
            write_image_file(str(tmp_path / name / "i.h5"),
                             {name: random_sequence(bp, seed=bp)}, region_cols=1000,
                             overlap_cols=0, noise=0.05)
        extra = ["--max_epochs", "1", "-b", "4", "--device", "cpu"]
    else:
        argv = ["assess", "-t", golden("golden.fa"), "-p", golden("golden.fa"), "--json"]
    assert cli(*argv, *extra) == 0
    captured = capsys.readouterr()
    assert "not yet ported" not in captured.err + captured.out
    if argv[0] == "download_models":
        assert (tmp_path / "models" / "golden_model.pkl").read_bytes() == open(
            golden("golden_model.pkl"), "rb").read()
    elif argv[0] == "convert":
        assert (tmp_path / "model.npz").exists()
    elif argv[0] == "hyperband":
        assert (tmp_path / "hyperband_out" / "hyperband_results.json").exists()
    else:
        assert '"total_edits": 0' in captured.out


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
