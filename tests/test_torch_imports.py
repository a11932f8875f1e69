"""helen_tpu_torch stands alone: it imports neither JAX, nor h5py, nor
helen_tpu.

An AST scan of every module of the port (and of chip_smoke.py, which drives
it on the GPU) fails on any import of ``jax``, ``h5py`` or ``helen_tpu``;
subprocesses with ``jax`` and ``h5py`` blocked import the package and polish
the golden images (also with ``--pack --writers 2 --fastq``), and train and
test a small model (also with ``--pack``), on the CPU.
"""
import ast
import glob
import os
import subprocess
import sys

import pytest

from torch_port_fixtures import GOLDEN_DIR, golden, stage_golden_images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "helen_tpu_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "h5py", "helen_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def imported_names(path: str):
    """Every module name a file imports: import statements, and
    importlib.import_module / __import__ calls on a constant."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_port_has_modules():
    assert len(PORT_FILES) > 20
    for mod in ("gru_window", "gru_window_bwd", "gru_window_autograd", "gru_window_xp",
                "gru_window_xp_bwd", "gru_window_encdec", "gru_window_smem"):
        assert f"helen_tpu_torch/ops/{mod}.py" in PORT_FILES
    for mod in ("hdf5", "prediction_store", "writer_pool", "packed", "images"):
        assert f"helen_tpu_torch/io/{mod}.py" in PORT_FILES


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_or_helen_tpu_import(rel):
    bad = sorted({n for n in imported_names(os.path.join(ROOT, rel)) if _forbidden(n)})
    assert not bad, f"{rel} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom helen_tpu.config import IMAGE\n"
                   "def f():\n    import jax.numpy\n"
                   "    importlib.import_module('helen_tpu.io')\n")
    assert sorted(n for n in imported_names(str(src)) if _forbidden(n)) == [
        "helen_tpu.config", "helen_tpu.io", "jax.numpy"]
    src.write_text("import h5py\nfrom helen_tpu_torch.io import hdf5\n")
    assert [n for n in imported_names(str(src)) if _forbidden(n)] == ["h5py"]


def _run(code: str, timeout: int = 120):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=timeout)


def test_package_root_does_not_import_torch():
    """The spawned stitch workers import the package: its root stays light."""
    proc = _run("import sys, helen_tpu_torch\n"
                "assert 'torch' not in sys.modules, 'torch imported'\n"
                "print(helen_tpu_torch.__version__)")
    assert proc.returncode == 0, proc.stderr


def test_polishes_on_cpu_with_jax_and_h5py_blocked(tmp_path):
    """The port's whole CPU path (checkpoint, images, consensus, store,
    streaming stitch, FASTA) with ``import jax`` and ``import h5py`` made to
    fail; the FASTA must equal the recorded golden one."""
    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "out"
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['h5py'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from helen_tpu_torch.cli import main\n"
        f"rc = main(['polish', '-i', {images!r}, '-m', {golden('golden_model.pkl')!r},"
        f" '-o', {str(out)!r}, '--device', 'cpu', '-t', '2'])\n"
        "assert not any(m in ('jax', 'helen_tpu') or m.startswith(('jax.', 'helen_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "sys.exit(rc)\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out / "HELEN_prediction.fa", "rb") as a, \
            open(os.path.join(GOLDEN_DIR, "golden.fa"), "rb") as b:
        assert a.read() == b.read()


def test_io_flags_run_on_cpu_with_jax_and_h5py_blocked(tmp_path):
    """``polish --pack --writers 2 --fastq`` twice (the second run reads the
    cache the first wrote through) then ``--resume``, and ``train --pack``,
    with ``import jax`` and ``import h5py`` made to fail: the FASTQ's
    sequences are the golden FASTA's."""
    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "out"
    code = (
        "import glob, os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['h5py'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from helen_tpu_torch.cli import main\n"
        "from helen_tpu_torch.io.fasta import read_fasta, read_fastq\n"
        "from helen_tpu_torch.io.synthetic import random_sequence, write_image_file\n"
        "if __name__ == '__main__':\n"
        "    for extra in ([], [], ['--resume']):\n"
        f"        assert main(['polish', '-i', {images!r}, '-m', {golden('golden_model.pkl')!r},"
        f" '-o', {str(out)!r}, '--device', 'cpu', '-t', '2', '--pack', '--writers', '2',"
        " '--fastq'] + extra) == 0\n"
        f"        fq = [r[:2] for r in read_fastq(os.path.join({str(out)!r}, 'HELEN_prediction.fq'))]\n"
        f"        assert fq == list(read_fasta({os.path.join(GOLDEN_DIR, 'golden.fa')!r}))\n"
        f"    root = {str(tmp_path)!r}\n"
        "    for name, bp in (('tr', 6000), ('te', 2500)):\n"
        "        os.makedirs(os.path.join(root, name))\n"
        "        write_image_file(os.path.join(root, name, 'i.h5'),\n"
        "                         {name: random_sequence(bp, seed=bp)}, region_cols=1000,\n"
        "                         overlap_cols=0, noise=0.05)\n"
        "    assert main(['train', '--train_image_dir', os.path.join(root, 'tr'),\n"
        "                 '--test_image_dir', os.path.join(root, 'te'), '-b', '4', '-e', '1',\n"
        "                 '-w', '2', '-o', os.path.join(root, 'tout'), '--device', 'cpu',\n"
        "                 '--hidden_size', '16', '--pack']) == 0\n"
        "    assert not any(m in ('jax', 'h5py', 'helen_tpu') or m.startswith(('jax.', 'helen_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = _run(code, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.path.exists(out / "images_cache.h5")


def test_trains_and_tests_on_cpu_with_jax_and_h5py_blocked(tmp_path):
    """``train --device cpu`` (one epoch, a fresh H=16 model on labeled
    synthetic images written by the port) then ``test`` of its latest
    checkpoint, with ``import jax`` and ``import h5py`` made to fail; the
    test run reproduces the epoch's test loss."""
    code = (
        "import glob, json, os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['h5py'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from helen_tpu_torch.cli import main\n"
        "from helen_tpu_torch.io.synthetic import random_sequence, write_image_file\n"
        f"root = {str(tmp_path)!r}\n"
        "for name, bp in (('tr', 6000), ('te', 2500)):\n"
        "    os.makedirs(os.path.join(root, name))\n"
        "    write_image_file(os.path.join(root, name, 'i.h5'), {name: random_sequence(bp, seed=bp)},\n"
        "                     region_cols=1000, overlap_cols=0, noise=0.05)\n"
        "out = os.path.join(root, 'out')\n"
        "assert main(['train', '--train_image_dir', os.path.join(root, 'tr'), '--test_image_dir',\n"
        "             os.path.join(root, 'te'), '-b', '4', '-e', '1', '-w', '2', '-o', out,\n"
        "             '--device', 'cpu', '--hidden_size', '16']) == 0\n"
        "run = glob.glob(os.path.join(out, 'trained_models_*'))[0]\n"
        "epoch = json.loads(open(os.path.join(run, 'stats', 'epochs.jsonl')).read())\n"
        "assert main(['test', '--test_image_dir', os.path.join(root, 'te'), '-m',\n"
        "             os.path.join(run, 'models', 'HELEN_latest_checkpoint.npz'), '-b', '4',\n"
        "             '-o', os.path.join(root, 'tout'), '--device', 'cpu']) == 0\n"
        "stats = json.load(open(os.path.join(root, 'tout', 'test_stats.json')))\n"
        "assert stats['loss'] == epoch['test_loss'], (stats['loss'], epoch['test_loss'])\n"
        "assert stats['rle_confusion_matrix'] == epoch['rle_confusion_matrix']\n"
        "assert not any(m in ('jax', 'helen_tpu') or m.startswith(('jax.', 'helen_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = _run(code, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
