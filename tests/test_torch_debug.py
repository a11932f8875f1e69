"""``test --debug_mismatches`` of the port (eval/debug.py) against
helen_tpu's on the CPU: the same mismatch records, byte for byte, from the
same checkpoint and labeled images, through the library and the CLI."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def labeled_dir(tmp_path_factory):
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    d = tmp_path_factory.mktemp("torch_debug_data")
    # a noisy pileup, so the trained model gets some columns wrong; one
    # short image (padded columns) besides the full ones
    write_image_file(str(d / "a.h5"), {"c_a": random_sequence(2600, seed=51)},
                     region_cols=1000, overlap_cols=0, noise=0.45, seed=52)
    write_image_file(str(d / "b.h5"), {"c_b": random_sequence(700, seed=53)},
                     region_cols=1000, overlap_cols=0, noise=0.45, seed=54)
    return str(d)


def test_render_feature_column_matches_helen_tpu():
    from helen_tpu.eval.debug import render_feature_column as ref

    from helen_tpu_torch.eval.debug import render_feature_column

    rng = np.random.default_rng(5)
    for density in (0.0, 0.05, 0.5):
        col = (rng.random(90) < density) * rng.integers(1, 60, 90)
        assert render_feature_column(col.astype(np.uint8)) == ref(col.astype(np.uint8))


def test_dump_matches_helen_tpu_byte_for_byte(labeled_dir, tmp_path):
    from helen_tpu.eval.debug import dump_mismatches as jdump
    from helen_tpu.io.checkpoint import load_model_any as jload

    from helen_tpu_torch.eval.debug import dump_mismatches
    from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
    from helen_tpu_torch.utils.filesystem import list_image_files

    ckpt = os.path.join(GOLDEN, "trained_synth30mb.npz")
    files = list_image_files(labeled_dir)
    jparams, _ = jload(ckpt)
    n_ref = jdump(jax.tree_util.tree_map(jnp.asarray, jparams), files,
                  str(tmp_path / "ref.txt"), batch_size=2, num_workers=2)
    params, _ = load_model_any(ckpt)
    n = dump_mismatches(params_to_torch(params, "cpu"), files, str(tmp_path / "got.txt"),
                        batch_size=2, num_workers=2)
    got = (tmp_path / "got.txt").read_bytes()
    assert n == n_ref > 0
    assert got == (tmp_path / "ref.txt").read_bytes()
    # a truncated dump stops at the same record
    assert dump_mismatches(params_to_torch(params, "cpu"), files, str(tmp_path / "cut.txt"),
                           batch_size=2, num_workers=2, max_records=3) == 3
    assert (tmp_path / "cut.txt").read_bytes() == b"".join(got.splitlines(True)[:3])


def test_cli_debug_mismatches_matches_helen_tpu(labeled_dir, tmp_path):
    """``test --debug_mismatches`` through both CLIs: mismatches.txt byte
    for byte, beside the port's usual test artifacts."""
    from helen_tpu.cli import main as jmain

    from helen_tpu_torch.cli import main

    ckpt = os.path.join(GOLDEN, "trained_synth30mb.npz")
    args = ["--test_image_dir", labeled_dir, "-m", ckpt, "-b", "2", "-w", "2",
            "--debug_mismatches"]
    assert main(["test", "--device", "cpu", *args, "-o", str(tmp_path / "p")]) == 0
    assert jmain(["--platform", "cpu", "test", *args, "-o", str(tmp_path / "j")]) == 0
    got = (tmp_path / "p" / "mismatches.txt").read_bytes()
    assert got and got == (tmp_path / "j" / "mismatches.txt").read_bytes()
    assert (tmp_path / "p" / "test_stats.json").exists()
