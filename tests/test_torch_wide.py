"""The xp route past H=1024 (the widest models) on the CPU: the chain
designs' rows-per-block rule, the design each kernel takes on the H100,
and the port's plain route at H=1056 against helen_tpu's ``xla`` route.

The chain designs of K3/K3f (``xp_window_kernel``) and of K4's pass 1
(``xp_bwd_rec_kernel``) keep their batch rows' state in shared memory:
``2 R H`` floats (K3), ``4 R H`` (K3f: the bf16 operand copy in a float
slot), ``5 R H`` (pass 1). The rule takes the largest R of 8, 4, 2, 1 that
fits the card's opt-in shared memory. The card's limits are set by hand
(132 SMs, 232,448 bytes: the H100 SXM), so nothing here needs a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

F = 90
H100 = (132, 232_448)


@pytest.fixture
def h100(monkeypatch):
    from helen_tpu_torch.ops import library

    monkeypatch.setattr(library, "_card", {0: H100})


# H: (K3 design, its units or rows), (K3f ...), (K4 pass 1 ...); units for
# "grid", rows per block for "chain"
RULE = {
    1024: (("grid", 16), ("grid", 16), ("grid", 16)),
    1056: (("chain", 8), ("grid", 16), ("chain", 8)),
    1088: (("chain", 8), ("grid", 17), ("chain", 8)),
    1152: (("chain", 8), ("chain", 8), ("chain", 8)),
    2048: (("chain", 8), ("chain", 4), ("chain", 4)),
    4096: (("chain", 4), ("chain", 2), ("chain", 2)),
}


@pytest.mark.parametrize("H", sorted(RULE))
def test_design_and_rows_per_block_on_the_h100(h100, H):
    """Each kernel's design and its rows per block (or grid units) at H,
    as the shared-memory arithmetic says: the grid where W_hh spread over
    the SMs fits, else the chain at the largest row count whose state
    fits."""
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg
    from helen_tpu_torch.ops import gru_window_xp_grid as xg

    sms, budget = H100
    k3, k3f, k4 = RULE[H]
    for (design, n), fast in ((k3, False), (k3f, True)):
        assert gx.xp_fwd_design(H, 64, fast=fast) == design
        if design == "grid":
            assert xg.grid_units(H, sms, budget, fast) == n
            assert xg.grid_smem_bytes(H, n, fast) <= budget
        else:
            assert xg.grid_units(H, sms, budget, fast) is None
            assert gx.chain_rows(H, budget, fast) == n
            # the largest count that fits: twice the rows would not
            slot = 4 * 2 * (2 if fast else 1)
            assert gx.chain_smem_bytes(H, n, fast) == slot * n * H <= budget
            assert n == 8 or slot * 2 * n * H > budget
    design, n = k4
    assert gxb.xp_bwd_design(H, 64) == design
    if design == "grid":
        assert gg.grid_units(H, sms, budget) == n
    else:
        assert gg.grid_units(H, sms, budget) is None
        assert gxb.bwd_chain_rows(H, budget) == n
        assert gxb.bwd_chain_smem_bytes(H, n) == 20 * n * H <= budget
        assert n == 8 or 20 * 2 * n * H > budget


def test_the_rule_refuses_only_past_one_row(h100):
    """A width whose state does not fit one row per block is refused by
    the design rule, naming ``--backend torch``; one unit narrower runs
    the chain at one row. Forcing the grid where it does not fit raises
    too."""
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    for widest, design in ((29_056, lambda h: gx.xp_fwd_design(h, 8)),
                           (14_528, lambda h: gx.xp_fwd_design(h, 8, fast=True)),
                           (11_622, lambda h: gxb.xp_bwd_design(h, 8))):
        assert design(widest) == "chain"
        with pytest.raises(ValueError, match="use --backend torch"):
            design(widest + 1)
    with pytest.raises(ValueError, match="design 'grid' does not take H=1056"):
        gx.xp_fwd_design(1056, 64, design="grid")
    with pytest.raises(ValueError, match="design 'grid' does not take H=1152"):
        gx.xp_fwd_design(1152, 64, design="grid", fast=True)
    with pytest.raises(ValueError, match="design 'grid' does not take H=1056"):
        gxb.xp_bwd_design(1056, 64, design="grid")


def test_chain_rows_are_the_sources_instantiations():
    """The rows per block the rule may pick are the ones both chain
    kernels instantiate, and their shared memory is the sources' own
    arithmetic."""
    import os
    import re

    from helen_tpu_torch.ops import gru_window_xp as gx

    csrc = os.path.join(os.path.dirname(gx.__file__), "csrc")
    for name, launcher in (("gru_window_xp.cu", "launch_xp_rows<FAST, "),
                           ("gru_window_xp_bwd.cu", "launch_bwd_rows<")):
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        cases = re.findall(r"case (\d+): return " + re.escape(launcher) + r"(\d+)>", src)
        assert [int(a) for a, b in cases] == list(gx.CHAIN_ROWS)
        assert all(a == b for a, b in cases)
    with open(os.path.join(csrc, "gru_window_xp.cu")) as f:
        assert "sizeof(float) * 2 * (size_t)R * H * (fast ? 2 : 1)" in f.read()
    with open(os.path.join(csrc, "gru_window_xp_bwd.cu")) as f:
        assert "sizeof(float) * 5 * (size_t)R * H" in f.read()


def test_plain_route_at_h1056_matches_helen_tpu_xla():
    """An H=1056 model, carried across from helen_tpu's params, through the
    port's ``consensus_probs`` on the cuda backend (the xp route; on CPU
    tensors the plain K3) and on ``torch``, against helen_tpu's
    ``consensus_probs(backend="xla")`` at B=2, T=8: votes within 1e-5,
    labels equal."""
    from helen_tpu.config import ModelConfig
    from helen_tpu.config import WindowConfig as JaxWindow
    from helen_tpu.models.transducer import consensus_probs as jax_probs
    from helen_tpu.models.transducer import init_params

    from helen_tpu_torch.config import WindowConfig
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import consensus_probs, engaged_kernel

    params = jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(1056),
                                ModelConfig(hidden_size=1056, gru_layers=1)))
    rng = np.random.default_rng(1056)
    images = rng.integers(0, 40, size=(2, 16, F), dtype=np.uint8)
    jb, jr = jax_probs(jax.tree_util.tree_map(jnp.asarray, params),
                       jnp.asarray(images, jnp.float32), JaxWindow(window=8, jump=4),
                       backend="xla")
    tp = params_to_torch(params, "cpu")
    assert engaged_kernel(tp, "cuda") == "cuda_xp"
    for backend in ("cuda", "torch"):
        with torch.no_grad():
            tb, tr = consensus_probs(tp, torch.from_numpy(images),
                                     WindowConfig(window=8, jump=4), backend=backend)
        for got, want in ((tb, jb), (tr, jr)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
            np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                          np.asarray(want).argmax(-1))
