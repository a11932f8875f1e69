"""End to end on the CPU: ``python -m helen_tpu_torch polish --device cpu``.

The golden images polish to a FASTA whose sha256 equals the one recorded by
the reference torch code, with the streaming stitch and with the classic
one; the trained checkpoint polishes an unseen sequence to the truth; the
port's prediction store stitches to the same FASTA in helen_tpu. The CLI
(polish, call_consensus, train, test) refuses to fall back to the CPU, and
refuses flags of paths not yet ported; the I/O flags ported since run.
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


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_helen_tpu_backend_names_run(backend, tmp_path):
    """``--backend xla`` and ``--backend pallas`` run as in helen_tpu: on
    the CPU both are the plain float32 path, which reproduces the golden
    FASTA."""
    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "out"
    assert cli("polish", "-i", images, "-m", golden("golden_model.pkl"), "-o", out,
               "--device", "cpu", "-t", 2, "--backend", backend) == 0
    assert sha256(out / "HELEN_prediction.fa") == sha256(golden("golden.fa"))


FAST = [
    ("--fast", ["polish", "--fast"]),
    ("pallas_fast", ["polish", "--backend", "pallas_fast"]),
]


@pytest.fixture(scope="module")
def golden_fast_labels(tmp_path_factory):
    """{"contig-start-end-chunk": (bases, rles)}: the golden images' labels
    from the library's fast tier (``consensus_labels(backend="torch_fast")``,
    all images in one batch)."""
    import numpy as np

    from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.models.transducer import consensus_labels

    images = stage_golden_images(tmp_path_factory.mktemp("golden_fast"))
    ds = MarginPolishDataset([os.path.join(images, "golden_images.h5")])
    recs = [ds.load(i) for i in range(len(ds))]
    params, _ = load_model_any(golden("golden_model.pkl"))
    with torch.no_grad():
        base, rle = consensus_labels(params_to_torch(params, "cpu", fast=True),
                                     torch.from_numpy(np.stack([r.image for r in recs])),
                                     backend="torch_fast")
    return {f"{r.contig}-{r.contig_start}-{r.contig_end}-{r.chunk_id}":
            (base[j].numpy(), rle[j].numpy()) for j, r in enumerate(recs)}


@pytest.mark.parametrize("argv", [a for _, a in FAST], ids=[i for i, _ in FAST])
def test_fast_tier_polishes_on_cpu(argv, tmp_path, golden_fast_labels):
    """``polish --fast`` and ``--backend pallas_fast`` run the fast tier
    (its plain versions with ``--device cpu``): the stored labels are the
    library's fast-tier labels of the same images, and within 1 flip per
    100 per head of the recorded float32 ones (the golden model's weights
    are random, so many of its votes are near ties; the tier's flips
    against helen_tpu's own fast tier are held in tests/test_torch_fast.py)."""
    import glob

    import numpy as np

    from torch_port_fixtures import store_labels

    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "out"
    assert cli(*argv, "-i", images, "-m", golden("golden_model.pkl"), "-o", out,
               "--device", "cpu", "-t", 2) == 0
    assert os.path.getsize(out / "HELEN_prediction.fa") > 0
    got = store_labels(glob.glob(str(out / "predictions_*" / "*.hdf"))[0])
    assert sorted(got) == sorted(golden_fast_labels)
    want = np.load(golden("golden_labels.npz"))
    n = sum(b.size for b, _ in got.values())
    for i, head in enumerate(("base", "rle")):
        for k, v in got.items():
            np.testing.assert_array_equal(v[i], golden_fast_labels[k][i], err_msg=k)
        flips = sum(int((v[i] != want[f"{head}/{k}"]).sum()) for k, v in got.items())
        assert flips <= 1e-2 * n, (head, flips, n)


def test_fast_and_backend_together_are_refused(capsys):
    with pytest.raises(SystemExit) as exc:
        cli("polish", "--fast", "--backend", "pallas", "-i", "imgs", "-m", "model.pkl",
            "--device", "cpu")
    assert exc.value.code == 2
    assert "mutually exclusive" in capsys.readouterr().err


# helen_tpu's flags whose paths the port lacked: the multi-process ones
# are still refused; the single-host I/O flags (True) are ported and run
UNPORTED = [
    ("--pack", ["polish", "--pack"], True),
    ("--resume", ["call_consensus", "--resume"], True),
    ("--writers", ["polish", "--writers", "2"], True),
    ("--fastq", ["polish", "--fastq"], True),
    ("--qualities", ["call_consensus", "--qualities"], True),
    # --host_shard is helen_tpu's default on one host; a multi-host job raises
    ("--host_shard", ["--distributed", "polish", "--host_shard", "file"], False),
    ("--num_processes", ["--num_processes", "2", "polish"], False),
]
TRAIN_ARGS = ["--train_image_dir", "tr", "--test_image_dir", "te", "--device", "cpu"]
TEST_ARGS = ["--test_image_dir", "te", "-m", "model.npz", "--device", "cpu"]
UNPORTED_TRAIN = [
    ("train--pack", ["train", "--pack", *TRAIN_ARGS], True),
    ("train--model_parallel", ["train", "--model_parallel", "2", *TRAIN_ARGS], False),
    ("train--distributed", ["--distributed", "train", *TRAIN_ARGS], False),
    ("test--debug_mismatches", ["test", "--debug_mismatches", *TEST_ARGS], False),
]


@pytest.mark.parametrize("argv,ported", [a[1:] for a in UNPORTED],
                         ids=[a[0] for a in UNPORTED])
def test_unported_flags_are_refused(argv, ported, tmp_path, capsys):
    """A multi-process flag exits 2 with "not yet ported". An I/O flag,
    ported since it was listed here, runs on the golden images: its FASTA
    (or the FASTQ's sequences, or the store stitched) is the golden one."""
    from helen_tpu_torch.infer.polish import perform_stitch
    from helen_tpu_torch.io.fasta import read_fasta, read_fastq

    if not ported:
        with pytest.raises(SystemExit) as exc:
            cli(*argv, "-i", "imgs", "-m", "model.pkl", "--device", "cpu")
        assert exc.value.code == 2
        assert "not yet ported" in capsys.readouterr().err
        return
    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "out"
    extra = ["-t", 2] if argv[0] == "polish" else []
    assert cli(*argv, "-i", images, "-m", golden("golden_model.pkl"), "-o", out,
               "--device", "cpu", *extra) == 0
    assert "not yet ported" not in capsys.readouterr().err
    fastq = "--fastq" in argv or "--qualities" in argv
    if argv[0] == "call_consensus":
        out = perform_stitch(str(out), str(tmp_path / "st"), threads=1, fastq=fastq)
    else:
        out = str(out / ("HELEN_prediction.fq" if fastq else "HELEN_prediction.fa"))
    got = [r[:2] for r in read_fastq(out)] if fastq else list(read_fasta(out))
    assert got == list(read_fasta(golden("golden.fa")))


@pytest.mark.parametrize("argv,ported", [a[1:] for a in UNPORTED_TRAIN],
                         ids=[a[0] for a in UNPORTED_TRAIN])
def test_unported_train_flags_are_refused(argv, ported, tmp_path, capsys):
    """As above for train and test: ``train --pack``, ported, trains one
    epoch of a fresh H=16 model from its packed cache."""
    if not ported:
        with pytest.raises(SystemExit) as exc:
            cli(*argv)
        assert exc.value.code == 2
        assert "not yet ported" in capsys.readouterr().err
        return
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    for name, bp in (("tr", 6000), ("te", 2500)):
        os.makedirs(tmp_path / name)
        write_image_file(str(tmp_path / name / "i.h5"), {name: random_sequence(bp, seed=bp)},
                         region_cols=1000, overlap_cols=0, noise=0.05)
    argv = [str(tmp_path / a) if a in ("tr", "te") else a for a in argv]
    assert cli(*argv, "-b", 4, "-e", 1, "-w", 2, "--hidden_size", 16, "-o",
               tmp_path / "out") == 0
    assert "not yet ported" not in capsys.readouterr().err
    assert os.path.exists(tmp_path / "out" / "train_images_cache.h5")


def test_version_and_devices(capsys):
    assert cli("version") == 0
    assert cli("devices") == 0
    out = capsys.readouterr().out
    assert "helen_tpu_torch" in out and "cuda devices:" in out
