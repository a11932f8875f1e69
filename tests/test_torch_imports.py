"""helen_tpu_torch stands alone: it imports neither JAX, nor h5py, nor
helen_tpu.

An AST scan of every module of the port (and of chip_smoke.py, which drives
it on the GPU) fails on any import of ``jax``, ``h5py`` or ``helen_tpu``;
subprocesses with ``jax`` and ``h5py`` blocked import the package and polish
the golden images (also in HDF5's newest format, and with ``--pack
--writers 2 --fastq``), and train and test a small model (also with
``--pack``), on the CPU.

The kernel layer ``helen_tpu_torch/ops`` is held to its order: each module
imports only modules below it in :data:`OPS_ORDER`, at module level, and no
name starting with ``_`` crosses a module line; every C entry a family
declares is in the sources, in one family's table only.
"""
import ast
import ctypes
import glob
import importlib
import os
import re
import shutil
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
    assert "helen_tpu_torch/parallel/multihost.py" in PORT_FILES
    for rel in ("parallel/mesh.py", "parallel/sharding.py", "eval/debug.py",
                "train/hyperband.py", "io/onnx_export.py", "io/download.py",
                "marginpolish.py", "tools/assess_polish.py", "tools/assess_summary.py",
                "tools/bed_mask.py", "tools/quast_sv_extractor.py", "tools/loss_curves.py",
                "tools/image_viewer.py", "tools/compare_images.py",
                "tools/vcf_remove_phase.py", "tools/pairwise_alignment.py"):
        assert f"helen_tpu_torch/{rel}" in PORT_FILES


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


OPS_DIR = os.path.join(ROOT, "helen_tpu_torch", "ops")
OPS_PACKAGE = "helen_tpu_torch.ops"
#: the ops layer's modules, lowest first: the library, the forward families,
#: the backward families, the autograd Functions, then the package itself
OPS_ORDER = ("library",
             "gru_window_smem", "gru_window_xp_grid", "gru_window_proj", "gru_window",
             "gru_window_xp", "gru_window_encdec",
             "gru_window_bwd_smem", "gru_window_xp_bwd_grid", "gru_window_wgrad",
             "gru_window_bwd", "gru_window_xp_bwd",
             "gru_window_autograd",
             "__init__")
OPS_MODULES = sorted(os.path.splitext(os.path.basename(p))[0]
                     for p in glob.glob(os.path.join(OPS_DIR, "*.py")))


def ops_imports(path: str):
    """``(line, ops module imported, names taken from it, inside a
    function)`` for each import of a module of ``helen_tpu_torch.ops`` in
    ``path``, and ``(line, ops module, attributes read)`` for each attribute
    read through a name bound to an ops module."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    imports, aliases = [], {}

    def visit(node, inside):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            inside = True
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level:
                module = ".".join([OPS_PACKAGE] + ([module] if module else []))
            if module == OPS_PACKAGE:
                for a in node.names:
                    if a.name in OPS_MODULES:
                        imports.append((node.lineno, a.name, (), inside))
                        aliases[a.asname or a.name] = a.name
                    else:
                        imports.append((node.lineno, "__init__", (a.name,), inside))
            elif module.startswith(OPS_PACKAGE + "."):
                imports.append((node.lineno, module.split(".")[2],
                                tuple(a.name for a in node.names), inside))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(OPS_PACKAGE + "."):
                    imports.append((node.lineno, a.name.split(".")[2], (), inside))
                    if a.asname:
                        aliases[a.asname] = a.name.split(".")[2]
        elif (isinstance(node, ast.Call) and node.args
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                imports.append((node.lineno, "<computed>", (), inside))
            elif arg.value.startswith(OPS_PACKAGE + "."):
                imports.append((node.lineno, arg.value.split(".")[2], (), inside))
        for child in ast.iter_child_nodes(node):
            visit(child, inside)

    visit(tree, False)
    reads = [(node.lineno, aliases[node.value.id], (node.attr,)) for node in ast.walk(tree)
             if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
             and node.value.id in aliases]
    return imports, reads


def ops_violations(module: str, path: str):
    """Each way ``path`` (the ops module ``module``) breaks the layer order."""
    rank = OPS_ORDER.index(module)
    imports, reads = ops_imports(path)
    bad = []
    for line, target, names, inside in imports:
        where = f"{module}.py:{line}"
        if target not in OPS_ORDER:
            bad.append(f"{where} imports {target}, which has no place in the order")
            continue
        if OPS_ORDER.index(target) >= rank:
            bad.append(f"{where} imports {target}, which is not below it")
        if inside:
            bad.append(f"{where} imports {target} inside a function")
        bad += [f"{where} takes {target}.{n}" for n in names if n.startswith("_")]
    bad += [f"{module}.py:{line} takes {target}.{n}" for line, target, names in reads
            for n in names if n.startswith("_") and target != module]
    return bad


def test_ops_order_names_every_module():
    assert sorted(OPS_ORDER) == OPS_MODULES


@pytest.mark.parametrize("module", OPS_MODULES)
def test_ops_imports_point_one_way(module):
    """The module imports only modules below it in the order, all at module
    level (so the graph, function-level imports counted, has no cycle), and
    takes no ``_`` name from another; ``library`` imports none."""
    path = os.path.join(OPS_DIR, f"{module}.py")
    assert not ops_violations(module, path)
    if module == "library":
        assert ops_imports(path) == ([], [])


def test_ops_import_scan_catches_each_violation(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("from helen_tpu_torch.ops import gru_window as gw\n"
                   "from helen_tpu_torch.ops.library import _card, check\n"
                   "def f():\n"
                   "    from helen_tpu_torch.ops import library\n"
                   "    return gw._bidir\n")
    assert sorted(ops_violations("gru_window_smem", str(src))) == [
        "gru_window_smem.py:1 imports gru_window, which is not below it",
        "gru_window_smem.py:2 takes library._card",
        "gru_window_smem.py:4 imports library inside a function",
        "gru_window_smem.py:5 takes gru_window._bidir"]


def c_entries():
    """The names of the functions each ``extern "C"`` block of
    ``ops/csrc/*.cu`` defines, by source."""
    out = {}
    for path in sorted(glob.glob(os.path.join(OPS_DIR, "csrc", "*.cu"))):
        with open(path) as f:
            text = f.read()
        names = []
        for block in re.findall(r'^extern "C" \{\n(.*?)^\}  // extern "C"', text, re.M | re.S):
            names += re.findall(r"^[A-Za-z][\w \*]*?\b(\w+)\(", block, re.M)
        out[os.path.basename(path)] = names
    return out


def test_every_declared_entry_is_in_the_sources():
    """Every name in a family's ``ENTRIES`` is a C entry of the sources, in
    no other table, with a ctypes result type and argument types; only
    ``library`` sets a ctypes function's ``restype``/``argtypes``."""
    sources = {n for names in c_entries().values() for n in names}
    assert {"bigru_window_in1", "bigru_window_wgrad_split_in", "gru_window_error_string"} \
        <= sources
    owner = {}
    for module in OPS_MODULES:
        table = getattr(importlib.import_module(f"{OPS_PACKAGE}.{module}"), "ENTRIES", {})
        for name, (restype, argtypes) in table.items():
            assert name in sources, f"{module}.ENTRIES declares {name}, which no source defines"
            assert name not in owner, f"{name} is declared by {owner.get(name)} and {module}"
            owner[name] = module
            for t in (restype, *argtypes):
                assert isinstance(t, type) and issubclass(t, ctypes._SimpleCData), (name, t)
    assert len(owner) > 50
    for module in OPS_MODULES:
        with open(os.path.join(OPS_DIR, f"{module}.py")) as f:
            tree = ast.parse(f.read())
        sets = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                and isinstance(n.ctx, ast.Store) and n.attr in ("restype", "argtypes")]
        assert module == "library" or not sets, (module, sets)


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


def test_polishes_the_newest_format_with_jax_and_h5py_blocked(tmp_path):
    """The golden images in HDF5's newest format (``libver="latest"``: a
    dense group, chunked shuffle+gzip datasets, fletcher32, variable-length
    strings; tests/torch_hdf5_variants/) polish to the golden FASTA through
    the port's own reader, with ``import jax`` and ``import h5py`` made to
    fail."""
    images = tmp_path / "images"
    images.mkdir()
    shutil.copy(os.path.join(ROOT, "tests", "torch_hdf5_variants", "images_latest.h5"),
                images / "images_latest.h5")
    out = tmp_path / "out"
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['h5py'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from helen_tpu_torch.cli import main\n"
        f"rc = main(['polish', '-i', {str(images)!r}, '-m', {golden('golden_model.pkl')!r},"
        f" '-o', {str(out)!r}, '--device', 'cpu', '-t', '2'])\n"
        "assert not any(m in ('jax', 'h5py', 'helen_tpu') or m.startswith(('jax.', 'helen_tpu.'))"
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


def test_new_subcommands_run_with_jax_and_h5py_blocked(tmp_path):
    """``convert`` (to ``.pkl`` and ``.onnx``, its self-check on the CPU),
    ``download_models`` over ``file://``, ``assess --bed``, ``test
    --debug_mismatches`` and ``train --model_parallel 2`` with ``import
    jax`` and ``import h5py`` made to fail."""
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    for name, bp in (("tr", 2000), ("te", 1200)):
        (tmp_path / name).mkdir()
        write_image_file(str(tmp_path / name / "i.h5"), {name: random_sequence(bp, seed=bp)},
                         region_cols=1000, overlap_cols=0, noise=0.05)
    (tmp_path / "m.csv").write_text(f"g.pkl,file://{golden('golden_model.pkl')}\n")
    (tmp_path / "m.bed").write_text("gA\t100\t200\n")
    fa = os.path.join(GOLDEN_DIR, "golden.fa")
    t = str(tmp_path)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['h5py'] = None\n"
        "import glob, torch\n"
        "torch.set_num_threads(2)\n"
        "from helen_tpu_torch.cli import main\n"
        f"t = {t!r}\n"
        f"assert main(['convert', '-i', {golden('golden_model.pkl')!r}, '-o', t + '/m.npz']) == 0\n"
        "assert main(['convert', '-i', t + '/m.npz', '-o', t + '/m.pkl']) == 0\n"
        "assert main(['convert', '--device', 'cpu', '-i', t + '/m.pkl', '-o', t + '/m.onnx']) == 0\n"
        "assert main(['download_models', '-o', t + '/dl', '--manifest_url', "
        "'file://' + t + '/m.csv']) == 0\n"
        f"assert main(['assess', '-t', {fa!r}, '-p', {fa!r}, '-b', t + '/m.bed']) == 0\n"
        "assert main(['train', '--device', 'cpu', '--train_image_dir', t + '/tr', "
        "'--test_image_dir', t + '/te', '-b', '4', '-e', '1', '-w', '2', "
        "'--hidden_size', '8', '--model_parallel', '2', '-o', t + '/out']) == 0\n"
        "ck = glob.glob(t + '/out/trained_models_*/models/HELEN_epoch_1_checkpoint.npz')[0]\n"
        "assert main(['test', '--device', 'cpu', '--test_image_dir', t + '/te', '-m', ck, "
        "'-b', '4', '-w', '2', '--debug_mismatches', '-o', t + '/tout']) == 0\n"
        "assert not any(m in ('jax', 'h5py', 'helen_tpu') or m.startswith(('jax.', 'helen_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = _run(code, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "tout" / "mismatches.txt").exists()
    assert (tmp_path / "dl" / "g.pkl").exists() and (tmp_path / "m.onnx").exists()
