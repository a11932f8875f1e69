"""End to end on the CPU: ``python -m helen_tpu_torch polish --device cpu``.

The golden images polish to a FASTA whose sha256 equals the one recorded by
the reference torch code, with the streaming stitch and with the classic
one; the trained checkpoint polishes an unseen sequence to the truth; the
port's prediction store stitches to the same FASTA in helen_tpu. The CLI
(polish, call_consensus, train, test) refuses to fall back to the CPU, and
refuses flags of paths not yet ported.
"""
import hashlib
import os

import pytest
import torch

from torch_port_fixtures import TRAINED_NPZ, golden, stage_golden_images

torch.set_num_threads(2)


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def cli(*argv):
    from helen_tpu_torch.cli import main

    return main([str(a) for a in argv])


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "classic"])
def test_polish_reproduces_golden_fasta(tmp_path, stream):
    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "out"
    extra = [] if stream else ["--no_stream_stitch"]
    assert cli("polish", "-i", images, "-m", golden("golden_model.pkl"), "-o", out,
               "--device", "cpu", "-t", 2, *extra) == 0
    assert sha256(out / "HELEN_prediction.fa") == sha256(golden("golden.fa"))


def test_trained_checkpoint_polishes_unseen_sequence(tmp_path):
    from helen_tpu_torch.io.fasta import read_fasta
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    seq = random_sequence(20000, seed=555)
    os.makedirs(tmp_path / "images")
    write_image_file(str(tmp_path / "images" / "img.h5"), {"unseen_ctg": seq},
                     region_cols=1000, overlap_cols=80, noise=0.1, seed=556)
    assert cli("polish", "-i", tmp_path / "images", "-m", TRAINED_NPZ, "-o",
               tmp_path / "out", "--device", "cpu", "-t", 2) == 0
    assert dict(read_fasta(str(tmp_path / "out" / "HELEN_prediction.fa"))) == {
        "unseen_ctg": seq}


def test_stages_separately_and_store_stitches_in_helen_tpu(tmp_path):
    """call_consensus then stitch, through the port's CLI; helen_tpu's
    stitch reads the port's prediction store to the same FASTA."""
    from helen_tpu.infer.polish import perform_stitch as jax_stitch

    images = stage_golden_images(tmp_path / "images")
    preds = tmp_path / "preds"
    assert cli("call_consensus", "-i", images, "-m", golden("golden_h160.pkl"), "-o",
               preds, "--device", "cpu", "--backend", "torch") == 0
    assert os.listdir(preds) == ["helen_predictions_0.hdf"]
    assert cli("stitch", "-i", preds, "-o", tmp_path / "out", "-t", 1) == 0
    want = sha256(golden("golden_h160.fa"))
    assert sha256(tmp_path / "out" / "HELEN_prediction.fa") == want
    assert sha256(jax_stitch(str(preds), str(tmp_path / "ref"), threads=1)) == want


def test_cuda_is_the_default_and_never_falls_back_to_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    from helen_tpu_torch.infer.polish import polish

    images = stage_golden_images(tmp_path / "images")
    with pytest.raises(SystemExit) as exc:
        cli("polish", "-i", images, "-m", golden("golden_model.pkl"), "-o", tmp_path / "o")
    assert exc.value.code == 2
    assert "needs a CUDA GPU" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        polish(images, golden("golden_model.pkl"), str(tmp_path / "o2"))
    assert not os.path.exists(tmp_path / "o") and not os.path.exists(tmp_path / "o2")


@pytest.mark.parametrize("argv", [
    ["train", "--train_image_dir", "tr", "--test_image_dir", "te"],
    ["test", "--test_image_dir", "te", "-m", "model.npz"],
], ids=["train", "test"])
def test_train_and_test_need_a_gpu_or_device_cpu(argv, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable here")
    with pytest.raises(SystemExit) as exc:
        cli(*argv, "-o", tmp_path / "o")
    assert exc.value.code == 2
    assert "needs a CUDA GPU" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o")


UNPORTED = [
    ("--fast", ["polish", "--fast"]),
    ("pallas_fast", ["polish", "--backend", "pallas_fast"]),
    ("--pack", ["polish", "--pack"]),
    ("--resume", ["call_consensus", "--resume"]),
    ("--writers", ["polish", "--writers", "2"]),
    ("--fastq", ["polish", "--fastq"]),
    ("--qualities", ["call_consensus", "--qualities"]),
    ("--host_shard", ["polish", "--host_shard", "image"]),
    ("--num_processes", ["--num_processes", "2", "polish"]),
]
TRAIN_ARGS = ["--train_image_dir", "tr", "--test_image_dir", "te", "--device", "cpu"]
TEST_ARGS = ["--test_image_dir", "te", "-m", "model.npz", "--device", "cpu"]
UNPORTED_TRAIN = [
    ("train--pack", ["train", "--pack", *TRAIN_ARGS]),
    ("train--model_parallel", ["train", "--model_parallel", "2", *TRAIN_ARGS]),
    ("train--distributed", ["--distributed", "train", *TRAIN_ARGS]),
    ("test--debug_mismatches", ["test", "--debug_mismatches", *TEST_ARGS]),
]


@pytest.mark.parametrize("argv", [a for _, a in UNPORTED], ids=[i for i, _ in UNPORTED])
def test_unported_flags_are_refused(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli(*argv, "-i", "imgs", "-m", "model.pkl", "--device", "cpu")
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [a for _, a in UNPORTED_TRAIN],
                         ids=[i for i, _ in UNPORTED_TRAIN])
def test_unported_train_flags_are_refused(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli(*argv)
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def test_version_and_devices(capsys):
    assert cli("version") == 0
    assert cli("devices") == 0
    out = capsys.readouterr().out
    assert "helen_tpu_torch" in out and "cuda devices:" in out
