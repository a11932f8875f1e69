"""``--fastq``/``--qualities`` in the port against helen_tpu.

``consensus_labels_and_quality`` gives helen_tpu's labels and, within 1,
its qualities; ``polish --fastq`` of the golden images has the sequences of
the recorded golden FASTA and quality lines within 1 per character of
helen_tpu's ``polish --fastq``; ``call_consensus --qualities`` then ``stitch
--fastq`` gives the same FASTQ; an oracle store stitches to its constant
quality; a store without qualities is a clear error.
"""
import os

import numpy as np
import pytest
import torch

from torch_port_fixtures import FIXTURES, golden, stage_golden_images

torch.set_num_threads(2)


def golden_images(tmp_path):
    from helen_tpu_torch.io.images import MarginPolishDataset

    d = stage_golden_images(tmp_path / "images")
    ds = MarginPolishDataset([os.path.join(d, "golden_images.h5")])
    return np.stack([ds.load(i).image for i in range(len(ds))])


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_qualities_match_helen_tpu(fixture, tmp_path):
    import jax.numpy as jnp

    from helen_tpu.io.checkpoint import load_model_any as jax_load
    from helen_tpu.models.transducer import consensus_labels_and_quality as jax_q

    from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
    from helen_tpu_torch.models.transducer import consensus_labels, consensus_labels_and_quality

    images = golden_images(tmp_path)
    ckpt = golden(FIXTURES[fixture][0])
    jp, _ = jax_load(ckpt)
    jb, jr, jq = (np.asarray(x) for x in jax_q(jp, jnp.asarray(images, jnp.float32)))
    params = params_to_torch(load_model_any(ckpt)[0], "cpu")
    with torch.no_grad():
        b, r, q = (x.numpy() for x in consensus_labels_and_quality(
            params, torch.from_numpy(images)))
        pb, pr = (x.numpy() for x in consensus_labels(params, torch.from_numpy(images)))
    assert q.dtype == np.uint8 and q.shape == images.shape[:2] and q.max() <= 60
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(b, pb)
    np.testing.assert_array_equal(r, pr)
    diff = np.abs(q.astype(np.int16) - jq.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999, (diff != 0).sum()


def test_trained_checkpoint_is_confident(tmp_path):
    """The trained checkpoint on its own kind of images votes with
    confidence: the median column at q >= 25 (p_base * p_rle >= 0.997)."""
    from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file
    from helen_tpu_torch.models.transducer import consensus_labels_and_quality

    from torch_port_fixtures import TRAINED_NPZ

    path = str(tmp_path / "img.h5")
    write_image_file(path, {"c": random_sequence(6000, seed=3)}, region_cols=1000,
                     overlap_cols=80, noise=0.1, seed=4)
    ds = MarginPolishDataset([path])
    images = torch.from_numpy(np.stack([ds.load(i).image for i in range(len(ds))]))
    params = params_to_torch(load_model_any(TRAINED_NPZ)[0], "cpu")
    with torch.no_grad():
        _, _, q = consensus_labels_and_quality(params, images)
    assert np.median(q.numpy()) >= 25


def test_polish_fastq_matches_golden_and_helen_tpu(tmp_path):
    from helen_tpu.infer.polish import polish as jax_polish

    from helen_tpu_torch.cli import main
    from helen_tpu_torch.io.fasta import read_fasta, read_fastq

    images = stage_golden_images(tmp_path / "images")
    assert main(["polish", "-i", str(images), "-m", golden("golden_model.pkl"), "-o",
                 str(tmp_path / "out"), "--device", "cpu", "-t", "2", "--fastq"]) == 0
    ours = list(read_fastq(str(tmp_path / "out" / "HELEN_prediction.fq")))
    assert [(n, s) for n, s, _ in ours] == list(read_fasta(golden("golden.fa")))
    theirs = list(read_fastq(jax_polish(str(images), golden("golden_model.pkl"),
                                        str(tmp_path / "ref"), batch_size=8, num_workers=2,
                                        threads=1, fastq=True)))
    assert [(n, s) for n, s, _ in theirs] == [(n, s) for n, s, _ in ours]
    for (_, _, qa), (_, _, qb) in zip(ours, theirs):
        a = np.frombuffer(qa.encode(), np.uint8).astype(int)
        b = np.frombuffer(qb.encode(), np.uint8).astype(int)
        assert len(a) == len(b) and np.abs(a - b).max() <= 1


def test_qualities_store_then_stitch_fastq(tmp_path):
    """``call_consensus --qualities --writers 2`` then ``stitch --fastq``:
    the FASTQ of ``polish --fastq``."""
    from helen_tpu_torch.cli import main

    images = stage_golden_images(tmp_path / "images")
    assert main(["call_consensus", "-i", str(images), "-m", golden("golden_model.pkl"), "-o",
                 str(tmp_path / "preds"), "--device", "cpu", "--qualities",
                 "--writers", "2"]) == 0
    assert main(["stitch", "-i", str(tmp_path / "preds"), "-o", str(tmp_path / "st"),
                 "-t", "1", "--fastq"]) == 0
    assert main(["polish", "-i", str(images), "-m", golden("golden_model.pkl"), "-o",
                 str(tmp_path / "out"), "--device", "cpu", "-t", "2", "--fastq"]) == 0
    with open(tmp_path / "st" / "HELEN_prediction.fq") as a, \
            open(tmp_path / "out" / "HELEN_prediction.fq") as b:
        assert a.read() == b.read()


def test_oracle_fastq_stitch(tmp_path):
    """Oracle predictions with a constant q40 stitch to the exact sequence
    with a quality string of the same length and value."""
    from helen_tpu_torch.infer.polish import perform_stitch
    from helen_tpu_torch.io.fasta import read_fastq
    from helen_tpu_torch.io.synthetic import random_sequence, write_prediction_file

    seq = random_sequence(20000, seed=11)
    preds = tmp_path / "preds"
    preds.mkdir()
    write_prediction_file(str(preds / "p_0.hdf"), {"chr_q": seq}, region_cols=900,
                          overlap_cols=80, qual=40)
    out = perform_stitch(str(preds), str(tmp_path), "polished", threads=2, fastq=True)
    assert out.endswith(".fq")
    ((name, got_seq, got_qual),) = list(read_fastq(out))
    assert (name, got_seq) == ("chr_q", seq)
    assert got_qual == chr(40 + 33) * len(seq)


def test_fastq_without_quals_is_a_clear_error(tmp_path):
    from helen_tpu_torch.cli import main
    from helen_tpu_torch.io.synthetic import random_sequence, write_prediction_file

    preds = tmp_path / "preds"
    preds.mkdir()
    write_prediction_file(str(preds / "p_0.hdf"), {"c": random_sequence(3000, seed=1)},
                          region_cols=600, overlap_cols=60)
    with pytest.raises(ValueError, match="--qualities"):
        main(["stitch", "-i", str(preds), "-o", str(tmp_path), "-t", "1", "--fastq"])
