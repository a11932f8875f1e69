"""K5/K5f's cluster design on the CPU: its design rule, its fit functions
against the kernel sources' constants, and its plain version.

The cluster kernels (``transducer_window_encdec_cluster`` and ``_fast``:
two CTAs per group of batch rows, producer warps projecting a chunk ahead
while consumer warps run the recurrence) run only on a CUDA device
(tests/test_torch_cuda.py, chip_smoke.py phase 11). Here their wrappers take
their plain version on CPU tensors: for each layer the projection summed in
k order, then the recurrence (``window_proj_plain``, ``window_rec_plain``).
It is held against the chained plain K5/K5f (parity within 1e-5: BLAS sums
the chain's projection in another order; fast to the bit: both sum in k
order on bf16-valued operands) and against helen_tpu's
``transducer_apply_fused_encdec`` in interpret mode (parity 1e-5, fast 1e-3,
the tolerances of tests/test_torch_encdec.py).
"""
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

F = 90


def helen_layers(H, seed, w_ih_scale=1.0):
    """An encoder (D=90) and a decoder (D=2H) layer from helen_tpu's
    ``bigru_init``, as numpy; the encoder's ``w_ih`` times ``w_ih_scale``."""
    from helen_tpu.models.gru import bigru_init

    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    enc = to_np(bigru_init(jax.random.PRNGKey(seed), F, H))
    for d in enc.values():
        d["w_ih"] = d["w_ih"] * np.float32(w_ih_scale)
    return enc, to_np(bigru_init(jax.random.PRNGKey(seed + 1), 2 * H, H))


def to_torch(tree):
    from helen_tpu_torch.io.checkpoint import params_to_torch

    return params_to_torch(tree, "cpu")


def window_case(T, B, H, seed, fast):
    from helen_tpu_torch.io.checkpoint import fast_layer

    enc, dec = (to_torch(layer) for layer in helen_layers(H, seed))
    if fast:
        enc, dec = fast_layer(enc), fast_layer(dec)
    rng = np.random.default_rng(seed)
    image = torch.from_numpy(rng.integers(0, 256, (B, T + 9, F), dtype=np.uint8))
    h0 = [torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)) for _ in range(2)]
    return image, h0, enc, dec


@pytest.mark.parametrize("H,B,fast,want", [
    (128, 512, False, "cluster"),   # the flagship at the polish batch: 8 rows per cluster
    (128, 256, False, "cluster"),   # and at the train batch: 4 rows
    (128, 512, True, "cluster"),
    (128, 256, True, "cluster"),
    (128, 300, False, "cluster"),   # a ragged batch: 8 rows, the last cluster part-filled
    (128, 300, True, "cluster"),
    (40, 5, False, "cluster"),      # 1 row per cluster, consumers not a whole warp
    (37, 67, True, "cluster"),
    (160, 512, False, "onepass"),   # the golden h160 fixture: W_hh past the smem design
    (160, 512, True, "onepass"),    # past the fast cluster's 128
    (129, 64, False, "onepass"),    # 3H past the producer's 384 columns
    (600, 512, False, "onepass"),   # too large for any recurrence block
    (600, 512, True, "onepass"),
])
def test_encdec_design_rule(H, B, fast, want):
    from helen_tpu_torch.ops.gru_window_encdec import encdec_design

    assert encdec_design(H, B, fast) == want


@pytest.mark.parametrize("fast", [False, True])
def test_forced_design_is_checked(fast):
    """``design="cluster"`` raises where the rule does not hold (parity
    H=160: the golden h160 fixture), ``"onepass"`` is taken as it is, and
    another name raises."""
    from helen_tpu_torch.ops.gru_window_encdec import encdec_design

    with pytest.raises(ValueError, match="does not take H=160"):
        encdec_design(160, 512, fast, "cluster")
    assert encdec_design(128, 512, fast, "onepass") == "onepass"
    assert encdec_design(128, 512, fast, "cluster") == "cluster"
    with pytest.raises(ValueError, match="not one of"):
        encdec_design(128, 512, fast, "chain")


def test_cluster_design_only_where_the_chain_recurrence_fits():
    """Over a sweep of H and B the cluster design is taken only where the
    chain's recurrence (ops.gru_window_smem.takes_smem_design) takes the
    shape, and at every H up to 128 in parity (at 2 rows and more) and in
    the fast tier."""
    from helen_tpu_torch.ops import gru_window_smem as gs
    from helen_tpu_torch.ops.gru_window_encdec import encdec_design

    for fast in (False, True):
        for B in (1, 3, 64, 100, 256, 300, 512):
            for H in range(1, 200, 7):
                got = encdec_design(H, B, fast)
                if got == "cluster":
                    assert gs.takes_smem_design(H, B, fast), (H, B, fast)
                if H <= 128:
                    assert got == "cluster", (H, B, fast)


def test_cluster_fit_numbers():
    """The flagship's shared memory, threads and scratch: parity 231,712
    bytes at 8 rows (W_hh and h 204,800 of them) in 448 threads; fast
    159,008 in 384; the boundary 52.4 MB in fp32 (26.2 MB in bf16) at
    B=512, T=100, and the parity ring 12.6 MB."""
    from helen_tpu_torch.ops import gru_window_encdec as ge
    from helen_tpu_torch.ops.gru_window_smem import rec_smem_bytes
    from helen_tpu_torch.ops import library

    assert rec_smem_bytes(128, 8) == 204_800
    assert ge.cluster_smem_bytes(128, 8, False) == 231_712 <= library.HOPPER_SMEM_OPTIN
    assert ge.cluster_smem_bytes(128, 4, False) == 227_616
    assert ge.cluster_smem_bytes(128, 8, True) == 159_008
    assert ge.cluster_threads(128, 8, False) == 448
    assert ge.cluster_threads(128, 4, True) == 384
    assert ge.cluster_threads(40, 1, False) == 64 + 192
    boundary = 2 * 100 * 512 * 128
    assert ge.cluster_scratch_bytes(128, 512, 100, 8, True) == 2 * boundary
    ring = 128 * 2 * 32 * 384 * 4
    assert ge.cluster_scratch_bytes(128, 512, 100, 8, False) == 4 * boundary + ring
    assert not ge.cluster_fits(128, 8, False, budget=231_711)
    assert ge.cluster_fits(128, 8, True, budget=159_008)


def read_csrc(name):
    from helen_tpu_torch.ops import library

    with open(os.path.join(library.CSRC, name)) as f:
        return f.read()


def csrc_int(text, name):
    m = re.search(rf"constexpr int {name} = ([^;]*);", text)
    assert m, name
    return m.group(1)


def test_python_constants_mirror_the_sources():
    """The constants the Python fit functions use are the kernel sources'
    (the library checks the sizes themselves against the built kernels on
    the card, in gru_window_encdec.check_fit when the library loads)."""
    from helen_tpu_torch.ops import gru_window_encdec as ge

    cluster = read_csrc("gru_window_cluster.cuh")
    assert int(csrc_int(cluster, "EC_ROWS")) == ge.CLUSTER_ROWS
    assert int(csrc_int(cluster, "EC_STAGES")) == ge.CLUSTER_STAGES
    assert csrc_int(cluster, "EC_BAR_BYTES") == "2 * EC_STAGES * 8"
    assert 2 * ge.CLUSTER_STAGES * 8 == ge.CLUSTER_BAR_BYTES
    smem = read_csrc("gru_window_smem.cu")
    assert int(csrc_int(smem, "ECP_PROD")) == ge.CLUSTER_PROD
    assert int(csrc_int(smem, "ECP_CONS_MAX")) == ge.CLUSTER_CONS_MAX
    assert int(csrc_int(smem, "ECP_N")) == ge.CLUSTER_N
    assert csrc_int(smem, "ECP_BK") == "PJ_BK"
    assert int(csrc_int(read_csrc("gru_window_smem.cuh"), "PJ_BK")) == ge.CLUSTER_BK
    fast = read_csrc("gru_window_fast.cu")
    assert int(csrc_int(fast, "ECF_PROD")) == ge.CLUSTER_FAST_PROD
    assert int(csrc_int(fast, "ECF_MAX_KT")) * 16 == ge.CLUSTER_FAST_MAX_H
    assert int(csrc_int(fast, "ECF_KS")) == ge.CLUSTER_FAST_KS
    # the kernels' launch bounds hold their largest blocks
    assert "__launch_bounds__(ECP_CONS_MAX + ECP_PROD, 1)" in smem
    assert ge.cluster_threads(128, 8, False) == ge.CLUSTER_CONS_MAX + ge.CLUSTER_PROD
    assert "__launch_bounds__(ECF_MAX_KT * 32 + ECF_PROD, 1)" in fast
    assert ge.cluster_threads(128, 8, True) == 8 * 32 + ge.CLUSTER_FAST_PROD


@pytest.mark.parametrize("T,B,H", [(6, 5, 40), (9, 8, 128), (5, 3, 37)])
@pytest.mark.parametrize("fast", [False, True])
def test_cluster_plain_matches_the_chained_plain(T, B, H, fast):
    """The cluster kernel's plain version against K5's (K5f's) plain
    version, the chained plain layers: parity within 1e-5 (the projection
    summed in k order against BLAS's order), fast to the bit (both sum in k
    order on the same bf16 values)."""
    from helen_tpu_torch.ops import gru_window_encdec as ge

    image, h0, enc, dec = window_case(T, B, H, seed=T + B + H, fast=fast)
    plain = (ge.transducer_window_encdec_cluster_fast_plain if fast
             else ge.transducer_window_encdec_cluster_plain)
    chained = (ge.transducer_window_encdec_fast_plain if fast
               else ge.transducer_window_encdec_plain)
    got = plain(image, 4, T, *h0, enc, dec)
    want = chained(image, 4, T, *h0, enc, dec)
    tol = 0.0 if fast else 1e-5
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        assert g.dtype == torch.float32 and g.shape == w.shape, what
        torch.testing.assert_close(g, w, rtol=0, atol=tol, msg=what)


@pytest.mark.parametrize("fast,tol", [(False, 1e-5), (True, 1e-3)])
def test_cluster_plain_matches_helen_tpu(fast, tol):
    """The cluster kernel's plain version against helen_tpu's
    ``transducer_apply_fused_encdec`` (``interpret=True``) on its own test's
    inputs (``tests/test_pallas.py:507``: T=7, B=8, H=128, uint8 x in [0,
    40), standard-normal h0), the encoder's ``w_ih`` scaled by 1/64 as in
    tests/test_torch_encdec.py (helen_tpu's TPU product keeps 16 bits of
    each float32 weight)."""
    from helen_tpu.ops.gru_pallas import transducer_apply_fused_encdec as jax_fused
    from helen_tpu_torch.io.checkpoint import fast_layer
    from helen_tpu_torch.ops import gru_window_encdec as ge

    T, B, H = 7, 8, 128
    enc, dec = helen_layers(H, 10, 1 / 64)
    rng = np.random.default_rng(10)
    x = rng.integers(0, 40, size=(T, B, F)).astype(np.uint8)
    h0f, h0b = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    to_jax = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    want = jax_fused(to_jax(enc), to_jax(dec), jnp.asarray(x), jnp.asarray(h0f),
                     jnp.asarray(h0b), fast=fast, exact_input=True, interpret=True)
    te, td = to_torch(enc), to_torch(dec)
    if fast:
        te, td = fast_layer(te), fast_layer(td)
    kernel = (ge.transducer_window_encdec_cluster_fast if fast
              else ge.transducer_window_encdec_cluster)
    got = kernel(torch.from_numpy(x).permute(1, 0, 2), 0, T, torch.from_numpy(h0f),
                 torch.from_numpy(h0b), te, td)
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("fast", [False, True])
def test_cpu_wrappers_count_no_launch(fast):
    """On CPU tensors the cluster kernel's wrapper is its plain version to
    the bit, and K5 (K5f) in either forced design is the chained plain
    version; nothing is counted."""
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_encdec as ge

    T, B, H = 6, 5, 40
    image, h0, enc, dec = window_case(T, B, H, seed=3, fast=fast)
    sfx = "_fast" if fast else ""
    gw.reset_launch_counts()
    got = getattr(ge, "transducer_window_encdec_cluster" + sfx)(image, 4, T, *h0, enc, dec)
    want = getattr(ge, f"transducer_window_encdec_cluster{sfx}_plain")(image, 4, T, *h0, enc,
                                                                       dec)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    chained = getattr(ge, f"transducer_window_encdec{sfx}_plain")(image, 4, T, *h0, enc, dec)
    for design in ("cluster", "onepass"):
        got = getattr(ge, "transducer_window_encdec" + sfx)(image, 4, T, *h0, enc, dec,
                                                           design=design)
        for g, w in zip(got, chained):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert not any(gw.launch_counts.values())


def test_cluster_wrapper_refuses_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window_encdec as ge

    T, B, H = 3, 2, 16
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    for kernel in (ge.transducer_window_encdec_cluster, ge.transducer_window_encdec_cluster_fast):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            kernel(meta(B, 10, F, dt=torch.uint8), 0, T, meta(B, H), meta(B, H), {}, {})


def test_encdec_variants_edit_the_shipped_sources():
    """helen_tpu_torch.obs.encdec_variants (the measurement of the producers'
    and the consumers' share of a cluster layer) edits the shipped sources:
    every text it replaces is there once, and off the card it refuses."""
    from helen_tpu_torch.obs import encdec_variants as ev
    from helen_tpu_torch.obs.grid_variants import variant_source

    for source, variants in ev.VARIANTS.items():
        src = read_csrc(source)
        for name, (consts, edits) in variants.items():
            for text, _ in edits:
                assert src.count(text) == 1, (source, name)
            out = variant_source(src, consts, edits, source)
            assert (out == src) == (name == "shipped"), name
    assert ev.main(["--iters", "1"]) == 1
