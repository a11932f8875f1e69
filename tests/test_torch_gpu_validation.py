"""helen_tpu_torch.tools.gpu_validation, the port's counterpart of
helen_tpu/tools/tpu_validation.py, on the CPU.

The tool refuses to run without a CUDA device, naming the platform; its
check functions give 0 delta and 0 flips on the plain route against itself,
stay within helen_tpu's fast bars on the plain fast route; the plain
route's votes equal helen_tpu's ``xla`` votes within 1e-5 on the flagship
and the three geometries (the port's params converted, the same images),
and its TBPTT batch stays within the tool's bars of helen_tpu's ``xla``
step; a failing check makes ``main`` return 1 and write
``all_passed: false``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMS = {"flagship": {}, "geom_l2_h128": {"gru_layers": 2}, "geom_h256": {"hidden_size": 256},
         "geom_h160_padded": {"hidden_size": 160}}


def port_params(seed, **cfg):
    from helen_tpu_torch.config import ModelConfig
    from helen_tpu_torch.models.transducer import init_params

    return init_params(torch.Generator().manual_seed(seed), ModelConfig(**cfg))


def to_jax(params):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()), params)


def images(batch, length=1000):
    return np.random.default_rng(0).integers(0, 40, size=(batch, length, 90)).astype(np.uint8)


def test_refuses_without_a_cuda_device_naming_the_platform(monkeypatch):
    from helen_tpu_torch.tools import gpu_validation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA GPU.*platform 'cpu'"):
        gpu_validation.main([])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    done = subprocess.run([sys.executable, "-m", "helen_tpu_torch.tools.gpu_validation"],
                          capture_output=True, text=True, env=env, timeout=120)
    assert done.returncode != 0 and "platform 'cpu'" in done.stderr
    assert "all_passed" not in done.stdout


def test_the_check_functions_on_plain_backends():
    """Against itself the plain route gives 0 delta, 0 flips and the same
    TBPTT step; the plain fast route stays within helen_tpu's fast bars;
    the kernel families' check (plain versions here) agrees within the
    parity bars, naming both families."""
    from helen_tpu_torch.tools import gpu_validation as gv

    params = port_params(0)
    x = torch.from_numpy(images(2))
    same = gv.check_votes(params, x, "torch", "torch")
    assert same == {"passed": True, "max_vote_delta": 0.0, "label_flips": 0, "labels": 4000}
    fast = gv.check_votes(params, x, "torch_fast", "torch", bars=gv.FAST_BARS)
    assert fast["passed"] and 0 < fast["max_vote_delta"] < gv.FAST_BARS[0]
    assert fast["label_flips"] <= 2000 * gv.FAST_BARS[1]
    rng = np.random.default_rng(1)
    yb = torch.from_numpy(rng.integers(0, 5, (2, 200)).astype(np.int32))
    yr = torch.from_numpy(rng.integers(0, 11, (2, 200)).astype(np.int32))
    step = gv.check_tbptt(params, x[:, :200], yb, yr, "torch", "torch")
    assert step["passed"] and step["loss_sum_delta"] == 0.0
    assert step["max_param_delta_after_step"] == 0.0 and step["step_budget"] == 3 * gv.TRAIN_LR
    families = gv.check_kernel_families(params, x, torch.device("cpu"))
    assert families["passed"] and families["kernel"] == "cuda_inproj/cuda_xp"
    assert families["max_vote_delta"] < gv.PARITY_BARS[0]


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_plain_votes_equal_helen_tpus_xla(geom):
    from helen_tpu.models.transducer import consensus_probs

    from helen_tpu_torch.tools import gpu_validation as gv

    params = port_params(0 if geom == "flagship" else 1, **GEOMS[geom])
    x = images(2)
    want = tuple(np.asarray(v) for v in consensus_probs(
        to_jax(params), jnp.asarray(x, jnp.float32), backend="xla"))
    got = gv.consensus_votes(params, torch.from_numpy(x), "torch")
    check = gv.compare_votes(got, want, bars=(1e-5, 0.0))
    assert check["passed"], check
    assert check["label_flips"] == 0 and check["max_vote_delta"] < 1e-5


def test_tbptt_check_holds_the_plain_step_to_helen_tpus_xla_step():
    from helen_tpu.train.train_loop import build_tbptt_fn, make_optimizer

    from helen_tpu_torch.tools import gpu_validation as gv

    params = port_params(0)
    rng = np.random.default_rng(2)
    B, L = 4, 200
    x = images(B, L)
    yb = rng.integers(0, 5, (B, L)).astype(np.int32)
    yr = rng.integers(0, 11, (B, L)).astype(np.int32)
    tx = make_optimizer(0.0)
    jp = to_jax(params)
    fn = jax.jit(build_tbptt_fn(tx, image_len=L, backend="xla"))
    jp, _, tot, _, _ = fn(jp, tx.init(jp), jnp.float32(gv.TRAIN_LR), jnp.asarray(x),
                          jnp.asarray(yb), jnp.asarray(yr), B)
    want = (float(tot), [np.asarray(a) for a in jax.tree_util.tree_leaves(jp)])
    got = gv.tbptt_batch(params, torch.from_numpy(x), torch.from_numpy(yb),
                         torch.from_numpy(yr), "torch")
    check = gv.compare_tbptt(got, want, gv.TRAIN_LR, 3)
    assert check["passed"], check
    assert check["loss_sum_delta"] <= 1e-5 * check["loss_sum"]


def test_a_failing_check_makes_main_return_1(tmp_path, monkeypatch, capsys):
    """Every check through ``main`` on the plain versions (the card
    replaced by the CPU), the fast one made to fail: exit code 1, and the
    document and the last line say ``all_passed: false``."""
    from helen_tpu_torch.tools import gpu_validation as gv

    real = gv.check_votes

    def failing_fast(params, x, backend, reference, *args, **kwargs):
        out = real(params, x, backend, reference, *args, **kwargs)
        return {**out, "passed": out["passed"] and backend != "cuda_fast"}

    monkeypatch.setattr(gv, "card", lambda: (torch.device("cpu"), "cpu"))
    monkeypatch.setattr(gv, "check_votes", failing_fast)
    path = str(tmp_path / "validation.json")
    assert gv.main(["--batch", "2", "--json_out", path]) == 1
    assert capsys.readouterr().out.strip().splitlines()[-1] == '{"all_passed": false}'
    with open(path) as f:
        doc = json.load(f)
    assert doc["all_passed"] is False and doc["platform"] == "gpu" and doc["batch"] == 2
    assert sorted(doc["checks"]) == sorted([
        "parity_vs_xla_votes", "fast_vs_xla_votes", "inproj_vs_classic_kernels",
        "geom_l2_h128", "geom_h256", "geom_h160_padded", "train_kernel_vs_scan"])
    assert [n for n, c in doc["checks"].items() if not c["passed"]] == ["fast_vs_xla_votes"]
    assert doc["checks"]["geom_h256"]["kernel"] == "cuda_inproj"
    assert doc["checks"]["train_kernel_vs_scan"]["step_budget"] == 19 * gv.TRAIN_LR
