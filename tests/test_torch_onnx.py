"""``convert`` and the ONNX export of the port (io/onnx_export.py,
io/checkpoint.py's ``export_torch_checkpoint``) on the CPU: helen_tpu's
tests/test_onnx.py and tests/test_convert.py cases run through the port,
and the port's files against helen_tpu's.

The exported ModelProto decodes back structurally; its numpy evaluation
matches the port's ``forward`` and the torch replica of the reference
model (the evaluator implements the ONNX GRU spec independently of the
exporter's gate reordering); its graph and initializers equal helen_tpu's
export of the same params; ``.npz`` -> ``.pkl`` -> ``.npz`` is exact and
each package reads the other's ``.pkl``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.torch_reference import TorchTransducer

torch.set_num_threads(2)


def _params(hidden=64, layers=1, seed=0):
    """A numpy param tree from the port's init_params."""
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import flatten_tree, unflatten_tree
    from helen_tpu_torch.models.transducer import init_params

    cfg = dataclasses.replace(MODEL, hidden_size=hidden, gru_layers=layers)
    return unflatten_tree(flatten_tree(init_params(torch.Generator().manual_seed(seed), cfg)))


def _forward(params, x, hid):
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import forward

    with torch.no_grad():
        out = forward(params_to_torch(params, "cpu"), torch.from_numpy(x),
                      torch.from_numpy(hid), "torch")
    return [o.numpy() for o in out]


def test_parse_roundtrip_structure():
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.onnx_export import build_onnx, parse_onnx

    model = parse_onnx(build_onnx(_params()))
    assert model["inputs"] == ["input_image", "input_hidden"]
    assert model["outputs"] == ["output_pred", "output_rle", "output_hidden"]
    ops = [n["op"] for n in model["nodes"]]
    assert ops.count("GRU") == 2  # encoder + decoder (1 layer each)
    gru = next(n for n in model["nodes"] if n["op"] == "GRU")
    assert gru["attrs"]["direction"] == "bidirectional"
    assert int(gru["attrs"]["linear_before_reset"]) == 1
    assert int(gru["attrs"]["hidden_size"]) == 64
    w = model["inits"]["encoder0_W"]
    assert w.shape == (2, 3 * 64, MODEL.input_features)


@pytest.mark.parametrize("hidden,layers", [(64, 1), (48, 2)])
def test_onnx_matches_port_forward(hidden, layers):
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.onnx_export import build_onnx, run_onnx

    params = _params(hidden, layers, seed=1)
    data = build_onnx(params, seq_len=20)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 20, MODEL.input_features)).astype(np.float32)
    hid = rng.standard_normal((3, 2 * layers, hidden)).astype(np.float32)
    got = run_onnx(data, {"input_image": x, "input_hidden": hid})
    base, rle, hout = _forward(params, x, hid)
    np.testing.assert_allclose(got["output_pred"], base, atol=1e-4)
    np.testing.assert_allclose(got["output_rle"], rle, atol=1e-4)
    np.testing.assert_allclose(got["output_hidden"], hout, atol=1e-4)


@pytest.mark.parametrize("hidden,layers", [(32, 1), (32, 2)])
def test_onnx_matches_torch_model(hidden, layers):
    """A model that originated as torch weights: the ONNX evaluation
    against torch's own nn.GRU forward."""
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import params_from_torch_state_dict
    from helen_tpu_torch.io.onnx_export import build_onnx, run_onnx

    torch.manual_seed(7)
    model = TorchTransducer(hidden=hidden, gru_layers=layers)
    model.eval()
    params = params_from_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    data = build_onnx(params, seq_len=12)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, MODEL.input_features)).astype(np.float32)
    hid = rng.standard_normal((2, 2 * layers, hidden)).astype(np.float32)
    got = run_onnx(data, {"input_image": x, "input_hidden": hid})
    with torch.no_grad():
        base, rle, hout = model(torch.from_numpy(x), torch.from_numpy(hid))
    np.testing.assert_allclose(got["output_pred"], base.numpy(), atol=1e-4)
    np.testing.assert_allclose(got["output_rle"], rle.numpy(), atol=1e-4)
    np.testing.assert_allclose(got["output_hidden"], hout.numpy(), atol=1e-4)


@pytest.mark.parametrize("hidden,layers", [(32, 1), (16, 2)])
def test_graph_equals_helen_tpu_export(hidden, layers):
    """The same params exported by both packages: the same nodes, inputs,
    outputs and initializers (the producer name differs)."""
    from helen_tpu.io.onnx_export import build_onnx as jbuild

    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.io.onnx_export import build_onnx, parse_onnx

    params = _params(hidden, layers, seed=3)
    got = parse_onnx(build_onnx(params_to_torch(params, "cpu")))
    want = parse_onnx(jbuild(jax.tree_util.tree_map(np.asarray, params)))
    for key in ("inputs", "outputs", "nodes"):
        assert got[key] == want[key]
    assert sorted(got["inits"]) == sorted(want["inits"])
    for k in got["inits"]:
        np.testing.assert_array_equal(got["inits"][k], want["inits"][k])


def test_export_onnx_self_verify(tmp_path):
    """export_onnx(verify=True) writes the file only after the parsed bytes
    reproduce the port's forward on the named device; default seq_len is
    the inference window. A wrong model fails the check."""
    from helen_tpu_torch.config import WINDOW
    from helen_tpu_torch.io import onnx_export
    from helen_tpu_torch.io.onnx_export import export_onnx, parse_onnx

    params = _params(hidden=32)
    path = export_onnx(params, str(tmp_path / "m.onnx"), device="cpu")
    model = parse_onnx(open(path, "rb").read())
    assert model["inputs"] == ["input_image", "input_hidden"]
    assert WINDOW.window == 100
    real = onnx_export.build_onnx
    try:
        onnx_export.build_onnx = lambda p, seq_len=None: real(_params(hidden=32, seed=9),
                                                               seq_len)
        with pytest.raises(AssertionError, match="ONNX verify failed"):
            export_onnx(params, str(tmp_path / "bad.onnx"), device="cpu")
    finally:
        onnx_export.build_onnx = real
    assert not (tmp_path / "bad.onnx").exists()


def test_export_onnx_checks_itself_on_the_gpu_by_default(tmp_path):
    """Without ``device`` the self-check runs on the GPU: where none is
    visible export_onnx raises, naming the CPU's flag, and writes nothing
    (it never carries on on the CPU)."""
    import torch

    from helen_tpu_torch.io.onnx_export import export_onnx

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default runs there")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        export_onnx(_params(hidden=32), str(tmp_path / "m.onnx"))
    assert not (tmp_path / "m.onnx").exists()


def test_convert_cli_exports_onnx(tmp_path):
    from helen_tpu_torch.cli import main
    from helen_tpu_torch.io.checkpoint import save_checkpoint
    from helen_tpu_torch.io.onnx_export import parse_onnx

    ckpt = str(tmp_path / "m.npz")
    save_checkpoint(ckpt, _params(hidden=32), meta={"hidden_size": 32, "gru_layers": 1})
    out = str(tmp_path / "m.onnx")
    assert main(["convert", "--device", "cpu", "-i", ckpt, "-o", out]) == 0
    model = parse_onnx(open(out, "rb").read())
    assert model["outputs"] == ["output_pred", "output_rle", "output_hidden"]


def test_convert_npz_to_pkl_and_back(tmp_path, capsys, rng):
    from helen_tpu_torch.cli import main
    from helen_tpu_torch.io.checkpoint import flatten_tree, load_model_any, save_checkpoint

    params = _params(hidden=128, seed=7)
    npz = str(tmp_path / "m.npz")
    save_checkpoint(npz, params, meta={"epochs": 5, "hidden_size": 128, "gru_layers": 1})
    pkl = str(tmp_path / "m.pkl")
    assert main(["convert", "-i", npz, "-o", pkl]) == 0
    npz2 = str(tmp_path / "m2.npz")
    assert main(["convert", "-i", pkl, "-o", npz2]) == 0
    assert capsys.readouterr().out.split() == [pkl, npz2]
    p2, meta2 = load_model_any(npz2)
    assert meta2["epochs"] == 5
    a, b = flatten_tree(params), flatten_tree(p2)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])  # bit for bit
    x = rng.standard_normal((2, 50, 90)).astype(np.float32)
    h = np.zeros((2, 2, 128), np.float32)
    np.testing.assert_array_equal(_forward(params, x, h)[0], _forward(p2, x, h)[0])
    ckpt = torch.load(pkl, map_location="cpu", weights_only=False)
    assert ckpt["hidden_size"] == 128
    assert "gru_encoder.weight_ih_l0" in ckpt["model_state_dict"]


def test_pkl_crosses_between_the_packages(tmp_path):
    """Each package reads the other's ``.pkl``: the same params, and the
    same torch state dict written."""
    from helen_tpu.io.checkpoint import export_torch_checkpoint as jexport
    from helen_tpu.io.checkpoint import load_model_any as jload

    from helen_tpu_torch.io.checkpoint import (
        export_torch_checkpoint,
        flatten_tree,
        load_model_any,
        params_to_torch,
    )

    params = _params(hidden=48, layers=2, seed=4)
    ours, theirs = str(tmp_path / "p.pkl"), str(tmp_path / "j.pkl")
    export_torch_checkpoint(ours, params_to_torch(params, "cpu"), {"epochs": 3})
    jexport(theirs, jax.tree_util.tree_map(np.asarray, params), {"epochs": 3})
    a = torch.load(ours, map_location="cpu", weights_only=False)
    b = torch.load(theirs, map_location="cpu", weights_only=False)
    assert {k: v for k, v in a.items() if k != "model_state_dict"} == {
        k: v for k, v in b.items() if k != "model_state_dict"}
    assert sorted(a["model_state_dict"]) == sorted(b["model_state_dict"])
    for k in a["model_state_dict"]:
        assert torch.equal(a["model_state_dict"][k], b["model_state_dict"][k])
    for load, path in ((jload, ours), (load_model_any, theirs)):
        got = flatten_tree(load(path)[0])
        for k, v in flatten_tree(params).items():
            np.testing.assert_array_equal(np.asarray(got[k]), v)


def test_convert_stacked_pkl_roundtrip(tmp_path, rng):
    """A 2-layer / hidden-64 reference checkpoint imports, runs as the
    reference model does, and round-trips through the convert CLI."""
    from helen_tpu_torch.cli import main
    from helen_tpu_torch.io.checkpoint import load_model_any

    torch.manual_seed(3)
    model = TorchTransducer(hidden=64, gru_layers=2)
    pkl = str(tmp_path / "stacked.pkl")
    torch.save({"model_state_dict": model.state_dict(), "model_optimizer": {},
                "hidden_size": 64, "gru_layers": 2, "epochs": 1}, pkl)
    params, meta = load_model_any(pkl)
    assert meta["gru_layers"] == 2 and meta["hidden_size"] == 64
    x = rng.standard_normal((2, 100, 90)).astype(np.float32)
    h = np.zeros((2, 4, 64), np.float32)
    with torch.no_grad():
        tb, _, th = model(torch.from_numpy(x), torch.from_numpy(h))
    pb, _, ph = _forward(params, x, h)
    np.testing.assert_allclose(pb, tb.numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ph, th.numpy(), atol=2e-5, rtol=1e-4)
    npz = str(tmp_path / "stacked.npz")
    assert main(["convert", "-i", pkl, "-o", npz]) == 0
    pkl2 = str(tmp_path / "stacked2.pkl")
    assert main(["convert", "-i", npz, "-o", pkl2]) == 0
    sd2 = torch.load(pkl2, map_location="cpu", weights_only=False)
    assert sd2["gru_layers"] == 2 and sd2["hidden_size"] == 64
    model2 = TorchTransducer(hidden=64, gru_layers=2)
    model2.load_state_dict(sd2["model_state_dict"])
