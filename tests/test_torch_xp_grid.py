"""K3 and K3f in their "grid" design (ops.gru_window_xp_grid): their plain
versions against helen_tpu's ``_kernel`` and ``_fwd_kernel`` (interpret
mode) at the grid's ragged shapes, the rule that picks the design, the
mirror of the kernels' shared-memory formula, K3's thread-tile rule, the
wrappers off the card, and a CPU emulation of the grid's block
decomposition down to each thread's (row, unit) pairs.

helen_tpu's window kernels take hidden sizes on the 128-lane grid;
``bigru_apply_fused`` zero-pads any other H per gate block (its
``_pad_dir_params``: the real lanes compute the same values to the last
ulp) and slices the outputs back. :func:`pallas_window` pads the same way
around ``fused_bigru_window(interpret=True)``, so H=40, 48 and 160 reach
the Pallas body. Tolerances: 1e-5 for the parity tier (the Pallas body's
bf16x3 product against the plain version's fp32 ``h @ W_hh``), 1e-3 for
the fast tier (an h rounded to bf16 one ulp, 2^-8 relative, apart where the
sums run in another order). The kernels run only on a CUDA device
(tests/test_torch_cuda.py, where K3's two designs are equal bit for bit,
and chip_smoke.py phases 9a and 10b).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TOL = 1e-5
FAST_TOL = 1e-3


def make_layer(rng, d, h):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {dr: {"w_ih": u(d, 3 * h), "w_hh": u(h, 3 * h), "b_ih": u(3 * h),
                 "b_hh": u(3 * h)} for dr in ("fwd", "bwd")}


def case(T, B, H, seed):
    """Projected streams of a unit-range input, an h0 pair and the numpy
    layer."""
    rng = np.random.default_rng(seed)
    layer = make_layer(rng, 2 * H, H)
    x = rng.uniform(-1, 1, (T, B, 2 * H)).astype(np.float32)
    xp_f, xp_b = (x @ layer[d]["w_ih"] + layer[d]["b_ih"] for d in ("fwd", "bwd"))
    h0f, h0b = (rng.uniform(-1, 1, (B, H)).astype(np.float32) for _ in range(2))
    return xp_f, xp_b, h0f, h0b, layer


def torch_layer(layer, fast=False):
    from helen_tpu_torch.io.checkpoint import fast_layer, params_to_torch

    t = params_to_torch(layer, "cpu")
    return fast_layer(t) if fast else t


def pad_gates(a, h, hp):
    """(..., 3h) -> (..., 3hp): each gate block [r|z|n] gets its own zero
    tail, as helen_tpu pads an H off the 128-lane grid."""
    a3 = a.reshape(*a.shape[:-1], 3, h)
    a3 = np.pad(a3, [(0, 0)] * (a3.ndim - 1) + [(0, hp - h)])
    return a3.reshape(*a.shape[:-1], 3 * hp)


def pallas_window(fn, xp_f, xp_b, h0f, h0b, layer, fast=False):
    """helen_tpu's window (``fn``: ``fused_bigru_window`` or
    ``fused_bigru_window_train_fwd``) in interpret mode on H zero-padded to
    the next multiple of 128, the outputs sliced back; ``fast``: bf16
    streams and ``w_hh`` (``_kernel`` with ``fast=True``)."""
    H = h0f.shape[-1]
    hp = -(-H // 128) * 128
    bf = jnp.bfloat16

    def w(d):
        a = jnp.asarray(pad_gates(np.pad(layer[d]["w_hh"], ((0, hp - H), (0, 0))), H, hp))
        return a.astype(bf) if fast else a

    def xp(a):
        a = jnp.asarray(pad_gates(a, H, hp))
        return a.astype(bf) if fast else a

    h0 = [jnp.asarray(np.pad(h, ((0, 0), (0, hp - H)))) for h in (h0f, h0b)]
    bh = [jnp.asarray(pad_gates(layer[d]["b_hh"], H, hp)[None]) for d in ("fwd", "bwd")]
    out = fn(xp(xp_f), xp(xp_b), *h0, w("fwd"), w("bwd"), *bh, interpret=True)
    return [np.asarray(o)[..., :H] for o in out]


def close(got, want, what, tol):
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0, err_msg=what)


# the grid's ragged widths (U=1, 1, 3 units per block on the H100's 132 SMs;
# 40 and 160 leave the last block short at 114 SMs) at ragged batches
@pytest.mark.parametrize("H", [40, 48, 160])
@pytest.mark.parametrize("B", [1, 7, 13])
@pytest.mark.parametrize("tier", ["parity", "fast"])
def test_plain_matches_pallas_kernel(H, B, tier):
    """K3's plain version against ``fused_bigru_window(interpret=True)``
    (``_kernel``, bf16x3 products) and K3f's against its ``fast=True``
    form (bf16 streams and ``w_hh``, the same bf16 values on both sides)."""
    from helen_tpu.ops.gru_pallas import fused_bigru_window

    from helen_tpu_torch.ops import gru_window_xp as gx

    T = 5
    xp_f, xp_b, h0f, h0b, layer = case(T, B, H, seed=11 * H + B)
    fast = tier == "fast"
    want = pallas_window(fused_bigru_window, xp_f, xp_b, h0f, h0b, layer, fast)
    streams = [torch.from_numpy(a) for a in (xp_f, xp_b)]
    h0 = [torch.from_numpy(a) for a in (h0f, h0b)]
    if fast:
        got = gx.bigru_window_xp_fast_plain(*(s.to(torch.bfloat16) for s in streams), *h0,
                                            torch_layer(layer, fast=True))
    else:
        got = gx.bigru_window_xp_plain(*streams, *h0, torch_layer(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        close(g, w, what, FAST_TOL if fast else TOL)


@pytest.mark.parametrize("H,B", [(40, 13), (48, 1), (160, 7)])
def test_plain_matches_pallas_train_forward(H, B):
    """K3's plain version against ``fused_bigru_window_train_fwd(
    interpret=True)``, helen_tpu's ``_fwd_kernel``: the same function."""
    from helen_tpu.ops.gru_pallas_train import fused_bigru_window_train_fwd

    from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp_plain

    T = 4
    xp_f, xp_b, h0f, h0b, layer = case(T, B, H, seed=13 * H + B)
    want = pallas_window(fused_bigru_window_train_fwd, xp_f, xp_b, h0f, h0b, layer)
    got = bigru_window_xp_plain(*(torch.from_numpy(a) for a in (xp_f, xp_b, h0f, h0b)),
                                torch_layer(layer))
    for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
        close(g, w, what, TOL)


# ---------------------------------------------------------------------------
# a CPU emulation of the grid's block decomposition
# ---------------------------------------------------------------------------

def block_columns(w_hh: torch.Tensor, c: int, U: int) -> torch.Tensor:
    """Block ``c``'s slice of ``W_hh`` as the kernel stages it: ``3 U``
    columns, gate-major (column ``g U + u`` is ``W_hh[:, g H + c U + u]``),
    zero columns for the units past H."""
    H = w_hh.shape[0]
    sl = torch.zeros(H, 3 * U, dtype=w_hh.dtype)
    for g in range(3):
        for u in range(U):
            if c * U + u < H:
                sl[:, g * U + u] = w_hh[:, g * H + c * U + u]
    return sl


def thread_pairs(B, Uc, rpt):
    """The (row, unit) pairs of one block's threads in the tile of ``rpt``
    rows per thread, as the kernel assigns them: 8 unit groups x ``RG`` row
    groups (ops.gru_window_xp_grid.grid_threads); thread ``tid`` is ``(ug,
    rg) = (tid % 8, tid // 8)`` and holds units ``ug + 8 q``, q < 2, and
    rows ``r0 + rg + p RG``, p < ``rpt``, of each row block of ``RG rpt``
    rows; the pairs past B or past the block's ``Uc`` units are not
    written. Rows and units as (n,) index tensors, one entry per write."""
    from helen_tpu_torch.ops import gru_window_xp_grid as xg

    threads = xg.grid_threads(B, rpt)
    rg_n = threads // xg.XG_UG
    tid = torch.arange(threads)
    ug, rg = tid % xg.XG_UG, tid // xg.XG_UG
    p, q = torch.arange(rpt), torch.arange(xg.XG_UPT)
    rows, units = [], []
    for r0 in range(0, B, rg_n * rpt):
        b = r0 + rg[:, None, None] + p[None, :, None] * rg_n
        u = ug[:, None, None] + q[None, None, :] * xg.XG_UG
        b, u = torch.broadcast_tensors(b, u)
        keep = (b < B) & (u < Uc)
        rows.append(b[keep])
        units.append(u[keep])
    return torch.cat(rows), torch.cat(units)


def grid_emulation(xp_f, xp_b, h0_f, h0_b, layer, U, rpt=None):
    """K3's grid design on the CPU: ``C = ceil(H / U)`` blocks per direction,
    block ``c`` owning units ``[c U, (c + 1) U)`` and its slice of ``W_hh``
    (:func:`block_columns`); at each step every block reads the whole h_prev
    from ``out``'s row tt -/+ 1 (h0 at step 0), forms its units' gates and
    its threads write their (row, unit) pairs of ``out[tt]``
    (:func:`thread_pairs`, the tile of ``rpt`` rows per thread, by default
    the one ``grid_tile`` picks), each pair once; hn is the last written
    row.

    The block's product is its slice scattered back into a zero ``(H, 3H)``
    matrix, ``h_prev @ that``: the CPU's matmul gives a column the same bits
    whatever the other columns hold at one shape, not at another, and the
    kernel's own order (one fmaf chain over k) is the card's to check
    (tests/test_torch_cuda.py)."""
    from helen_tpu_torch.ops import gru_window_xp_grid as xg

    T, B, H3 = xp_f.shape
    H = H3 // 3
    C = -(-H // U)
    rpt = xg.grid_tile(B) if rpt is None else rpt
    outs = []
    for d, xp, h0, rev in (("fwd", xp_f, h0_f, False), ("bwd", xp_b, h0_b, True)):
        w, bh = layer[d]["w_hh"], layer[d]["b_hh"]
        mats, pairs = [], []
        for c in range(C):
            sl = block_columns(w, c, U)
            full = torch.zeros_like(w)
            for g in range(3):
                for u in range(min(U, H - c * U)):
                    full[:, g * H + c * U + u] = sl[:, g * U + u]
            mats.append(full)
            rows, units = thread_pairs(B, min(U, H - c * U), rpt)
            pairs.append((rows, c * U + units))
        out = torch.full((T, B, H), float("nan"), dtype=xp.dtype)
        for s in range(T):
            tt = T - 1 - s if rev else s
            hprev = h0 if s == 0 else out[tt + 1 if rev else tt - 1]
            for c in range(C):
                hp = hprev @ mats[c] + bh
                r = torch.sigmoid(xp[tt][:, :H] + hp[:, :H])
                z = torch.sigmoid(xp[tt][:, H:2 * H] + hp[:, H:2 * H])
                n = torch.tanh(xp[tt][:, 2 * H:] + r * hp[:, 2 * H:])
                hnew = (1.0 - z) * n + z * hprev
                rows, cols = pairs[c]
                assert out[tt][rows, cols].isnan().all(), "a pair written twice"
                out[tt][rows, cols] = hnew[rows, cols]
        outs.append(out)
    return outs[0], outs[1], outs[0][-1], outs[1][0]


# a ragged last block (40 = 13 x 3 + 1; 37 = 7 x 5 + 2), one unit per block,
# exact blocks (48 = 3 x 16), the H100's U at H=160 (3) and at 132 / 114 SMs'
# U for H=128 (2, 3); one step, ragged batches; each at the tile the rule
# picks and at every tile
@pytest.mark.parametrize("T,B,H,U", [(5, 13, 40, 3), (4, 7, 37, 5), (3, 1, 48, 16),
                                     (6, 7, 48, 1), (4, 13, 160, 3), (1, 7, 128, 2),
                                     (5, 1, 128, 3)])
def test_grid_emulation_equals_plain_to_the_bit(T, B, H, U):
    from helen_tpu_torch.ops import gru_window_xp_grid as xg
    from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp_plain

    xp_f, xp_b, h0f, h0b, layer = case(T, B, H, seed=T * B + H + U)
    args = (*(torch.from_numpy(a) for a in (xp_f, xp_b, h0f, h0b)), torch_layer(layer))
    want = bigru_window_xp_plain(*args)
    for rpt in (None, *xg.XG_TILES):
        got = grid_emulation(*args, U, rpt)
        for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
            assert torch.equal(g, w), f"{what}, tile {rpt}: max diff {float((g - w).abs().max())}"


# the 8-row tile's batches (ragged row blocks of 128 rows: 300 = 2 x 128 +
# 44, 129 = 128 + 1) and the 4-row tile's B=64, at U=16 (8 unit groups, the
# H100's U at H=1024), an odd U (11: a zero unit column) and a short last
# block (70 = 4 x 16 + 6; 40 = 3 x 11 + 7)
@pytest.mark.parametrize("T,B,H,U", [(2, 300, 48, 16), (2, 129, 70, 16), (2, 64, 48, 16),
                                     (3, 200, 40, 11), (2, 77, 33, 11)])
def test_grid_emulation_at_the_wide_tiles_equals_plain_to_the_bit(T, B, H, U):
    from helen_tpu_torch.ops import gru_window_xp_grid as xg
    from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp_plain

    xp_f, xp_b, h0f, h0b, layer = case(T, B, H, seed=T * B + H + U)
    args = (*(torch.from_numpy(a) for a in (xp_f, xp_b, h0f, h0b)), torch_layer(layer))
    want = bigru_window_xp_plain(*args)
    for rpt in xg.XG_TILES:
        got = grid_emulation(*args, U, rpt)
        for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
            assert torch.equal(g, w), f"{what}, tile {rpt}: max diff {float((g - w).abs().max())}"


@pytest.mark.parametrize("B", [1, 13, 64, 127, 128, 300, 512])
@pytest.mark.parametrize("U", [1, 2, 3, 10, 11, 16])
def test_thread_tiles_cover_each_pair_once(B, U):
    """Every tile's threads write each (row, unit) pair of a block exactly
    once, for a full block and a short last one; a warp's 32 threads are 8
    unit groups x 4 whole row groups, so the rows a warp reads are its own."""
    from helen_tpu_torch.ops import gru_window_xp_grid as xg

    for rpt in xg.XG_TILES:
        for Uc in {U, max(1, U // 2)}:
            rows, units = thread_pairs(B, Uc, rpt)
            got = sorted(zip(rows.tolist(), units.tolist()))
            assert got == [(b, u) for b in range(B) for u in range(Uc)], (rpt, Uc)


def test_block_columns_are_gate_major_with_zero_units():
    """Each block's slice holds the r, z, n columns of its units in order and
    zeros past H; the slices cover every column of W_hh once."""
    H, U = 10, 4
    w = torch.arange(H * 3 * H, dtype=torch.float32).reshape(H, 3 * H)
    seen = []
    for c in range(-(-H // U)):
        sl = block_columns(w, c, U)
        for g in range(3):
            for u in range(U):
                col = sl[:, g * U + u]
                if c * U + u < H:
                    assert torch.equal(col, w[:, g * H + c * U + u])
                    seen.append(g * H + c * U + u)
                else:
                    assert not col.any()
    assert sorted(seen) == list(range(3 * H))


# ---------------------------------------------------------------------------
# the rule that picks the design, and the shared-memory mirror
# ---------------------------------------------------------------------------

# the H100 SXM: 132 SMs, 232,448 bytes of opt-in shared memory per block
@pytest.mark.parametrize("H,units,smem,fast_smem", [
    (1024, 16, 229_376, 172_800), (768, 12, 180_224, 148_224), (640, 10, 155_648, 135_936),
    (512, 8, 131_072, 98_688), (160, 3, 63_488, 83_328), (128, 2, 57_344, 80_256),
])
def test_grid_units_on_the_h100(H, units, smem, fast_smem):
    """The smallest U whose 2 ceil(H / U) blocks fit the 132 SMs, in both
    tiers, and its shared memory: parity, at any U, H rounded up to 16 rows
    of 3 x 16 fp32 weights (k-major) and the ring's 8192 floats;
    fast, 3 x U rounded up to 8 bf16
    columns of H rounded up to 64 plus 8 and two stages of 256 x 72 bf16."""
    from helen_tpu_torch.ops import gru_window_xp_grid as xg

    for fast, want in ((False, smem), (True, fast_smem)):
        assert xg.grid_units(H, 132, 232_448, fast) == units
        assert xg.grid_smem_bytes(H, units, fast) == want <= 232_448
    assert 2 * -(-H // units) <= 132 < 2 * -(-H // (units - 1))


# B -> (rows per thread, threads): the 8-row tile above B=128 (32 row groups
# of 8 unit groups), 4 rows below, at 16 row groups up to B=64
@pytest.mark.parametrize("B,rpt,threads", [
    (512, 8, 256), (300, 8, 256), (129, 8, 256), (128, 4, 256), (120, 4, 256), (65, 4, 256),
    (64, 4, 128), (13, 4, 128), (1, 4, 128),
])
def test_grid_tile_rule(B, rpt, threads):
    from helen_tpu_torch.ops import gru_window_xp_grid as xg

    assert xg.grid_tile(B) == rpt
    assert xg.grid_threads(B, rpt) == threads
    # the launch bound holds every tile's threads, whole warps of whole row
    # groups, a row block of at most 256 rows
    assert threads <= xg.XG_MAX_THREADS and threads % 32 == 0 and 32 % xg.XG_UG == 0
    assert threads // xg.XG_UG * rpt <= 256


@pytest.fixture
def card(monkeypatch):
    """Set the card the rule reads (SMs, opt-in shared memory per block)."""
    from helen_tpu_torch.ops import library

    return lambda sms, budget: monkeypatch.setattr(library, "_card", {0: (sms, budget)})


@pytest.mark.parametrize("H", [128, 160, 512, 640, 768, 1024])
@pytest.mark.parametrize("B", [64, 512, 1])
@pytest.mark.parametrize("fast", [False, True])
def test_xp_fwd_design_takes_every_xp_width_on_the_h100(card, H, B, fast):
    from helen_tpu_torch.ops import gru_window_xp as gx

    card(132, 232_448)
    assert gx.xp_fwd_design(H, B, fast=fast) == "grid"
    assert gx.xp_fwd_design(H, B, design="chain", fast=fast) == "chain"


@pytest.mark.parametrize("H,sms,budget,parity,fast", [
    # fewer SMs: a larger U, until the parity tier's 16 units per block
    (1024, 114, 232_448, None, 18), (768, 114, 232_448, 14, 14), (640, 114, 232_448, 12, 12),
    (128, 114, 232_448, 3, 3),
    # a smaller budget: the fp32 slice (16 columns a gate at any U) is the
    # first not to fit, then the fast tier's
    (1024, 132, 200_000, None, 16), (1024, 132, 170_000, None, None),
    (640, 132, 160_000, 10, 10), (640, 132, 140_000, None, 10), (640, 132, 130_000, None, None),
    (640, 132, 110_000, None, None),
    # a card too small for the most units per block
    (1024, 60, 10**9, None, None),
])
def test_grid_units_follow_the_card(card, H, sms, budget, parity, fast):
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_grid as xg

    card(sms, budget)
    for tier, want in ((False, parity), (True, fast)):
        assert xg.grid_units(H, sms, budget, tier) == want
        assert gx.xp_fwd_design(H, 64, fast=tier) == ("chain" if want is None else "grid")


def test_forced_grid_design_is_checked(card):
    from helen_tpu_torch.ops import gru_window_xp as gx

    card(132, 232_448)
    assert gx.xp_fwd_design(1024, 64, design="grid") == "grid"
    with pytest.raises(ValueError, match="not one of"):
        gx.xp_fwd_design(1024, 64, design="smem")
    card(114, 232_448)
    with pytest.raises(ValueError, match="does not take H=1024"):
        gx.xp_fwd_design(1024, 64, design="grid")
    assert gx.xp_fwd_design(1024, 64, design="grid", fast=True) == "grid"
    card(132, 170_000)
    with pytest.raises(ValueError, match="does not take H=1024, B=64 in the fast tier"):
        gx.xp_fwd_design(1024, 64, design="grid", fast=True)


def test_smem_mirror_matches_the_source():
    """grid_smem_bytes mirrors csrc/gru_window_xp_grid.cu's xg_smem and
    xf_smem (the library checks the two agree when it is bound, on the
    card): the constants it reads are the source's, and its byte count is
    the layout's, counted here element by element."""
    from helen_tpu_torch.ops import gru_window_xp_grid as xg
    from helen_tpu_torch.ops import library

    with open(os.path.join(library.CSRC, "gru_window_xp_grid.cu")) as f:
        src = f.read()
    const = {m.group(1): m.group(2) for m in
             re.finditer(r"constexpr int (X[GF]_[A-Z_]+) = ([^;]+);", src)}
    assert const["XG_UG"] == str(xg.XG_UG) and const["XG_UPT"] == str(xg.XG_UPT)
    assert const["XG_MAX_THREADS"] == str(xg.XG_MAX_THREADS)
    assert const["XG_KC"] == str(xg.XG_KC) and const["XG_RING"] == str(xg.XG_RING)
    assert const["XG_MAX_UNITS"] == str(xg.MAX_UNITS[False])
    assert const["XF_KC"] == str(xg.XF_KC) and const["XF_KS"] == "XF_KC + 8"
    assert const["XF_STAGES"] == str(xg.XF_STAGES)
    assert const["XF_MAX_UNITS"] == str(xg.MAX_UNITS[True])
    assert int(const["XF_WARPS"]) * int(const["XF_MT"]) * 16 == xg.XF_ROWS
    # the entry point launches one instance per tile, and nothing else
    cases = re.findall(r"(case \d+|default):\s+return launch_cooperative\("
                       r"xp_grid_kernel<(\d+), (\d+)>", src)
    assert sorted({int(r) for _, r, _ in cases}, reverse=True) == list(xg.XG_TILES)
    for a, r, rg in cases:
        assert a in ("default", f"case {100 * int(r) + int(rg)}")
        # every (tile, batch) the rule picks has its instance
        assert any(xg.grid_threads(b, int(r)) == 8 * int(rg) for b in range(1, 600))
    assert {(r, xg.grid_threads(b, r) // 8) for b in range(1, 600) for r in xg.XG_TILES} == {
        (int(r), int(rg)) for _, r, rg in cases}
    for h in (1, 37, 40, 128, 160, 610, 640, 1000, 1024):
        for u in (1, 2, 3, 10, 16, 24):
            k = -(-h // 16) * 16
            w32 = k * 3 * 16                              # [k][8 ug x 2 units x 3 gates]
            ring32 = 8192                                 # [S][32 RPT rows][8]
            assert k >= h
            assert xg.grid_smem_bytes(h, u) == 4 * (w32 + ring32)
            k = -(-h // 64) * 64
            w16 = 3 * (-(-u // 8) * 8) * (k + 8)          # [3 U8][k + 8] bf16
            ring16 = 2 * 256 * (64 + 8)                   # [2][256 rows][72] bf16
            assert xg.grid_smem_bytes(h, u, fast=True) == 2 * (w16 + ring16)


# ---------------------------------------------------------------------------
# the wrappers off the card
# ---------------------------------------------------------------------------

def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    """On CPU tensors K3 and K3f, in every forced design, run their plain
    versions, and no counter moves; the counters name every kernel."""
    from helen_tpu_torch.ops import gru_window_xp as gx

    xp_f, xp_b, h0f, h0b, layer = case(4, 3, 40, seed=5)
    args = [torch.from_numpy(a) for a in (xp_f, xp_b, h0f, h0b)]
    fargs = [a.to(torch.bfloat16) for a in args[:2]] + args[2:]
    tl, fl = torch_layer(layer), torch_layer(layer, fast=True)
    gx.reset_launch_counts()
    want = gx.bigru_window_xp_plain(*args, tl)
    fwant = gx.bigru_window_xp_fast_plain(*fargs, fl)
    for design in (None, *gx.DESIGNS):
        for g, w in zip(gx.bigru_window_xp(*args, tl, design=design), want):
            assert torch.equal(g, w)
        for g, w in zip(gx.bigru_window_xp_fast(*fargs, fl, design=design), fwant):
            assert torch.equal(g, w)
    assert set(gx.launch_counts.values()) == {0}
    assert set(gx.launch_counts) == {
        "bigru_window_xp", "bigru_window_xp_fast", "bigru_window_xp_grid",
        "bigru_window_xp_chain", "bigru_window_xp_fast_grid", "bigru_window_xp_fast_chain",
        *(f"bigru_window_xp{t}_chain_r{r}" for t in ("", "_fast") for r in (8, 4, 2, 1))}


def test_wrappers_raise_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window_xp as gx

    T, B, H = 3, 2, 32
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    layer = {d: {"w_hh": meta(H, 3 * H), "b_hh": meta(3 * H)} for d in ("fwd", "bwd")}
    x, v = meta(T, B, 3 * H), meta(B, H)
    for design in (None, "grid", "chain"):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            gx.bigru_window_xp(x, x, v, v, layer, design=design)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            gx.bigru_window_xp_fast(x.to(torch.bfloat16), x.to(torch.bfloat16), v, v, layer,
                                    design=design)


def test_source_is_built_with_the_others():
    """build_kernels compiles every ops/csrc/*.cu: gru_window_xp_grid.cu with
    its entry points, a cooperative launch and bf16 mma.sync tiles; both
    designs take their gates from gru_gates, and both grid sources share
    the barrier of gru_window_grid.cuh."""
    import glob

    from helen_tpu_torch.ops import library

    names = {os.path.basename(p) for p in glob.glob(os.path.join(library.CSRC, "*.cu"))}
    assert "gru_window_xp_grid.cu" in names
    read = lambda n: open(os.path.join(library.CSRC, n)).read()  # noqa: E731
    text = read("gru_window_xp_grid.cu")
    for fn in ("bigru_window_xp_grid", "bigru_window_xp_fast_grid",
               "bigru_window_xp_grid_smem_bytes"):
        assert f" {fn}(" in text, fn
    # the bf16 mma.sync tiles, through the helpers it shares with K1f/K2f
    assert '#include "gru_window_mma.cuh"' in text and "mma_bf16(" in text
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in read("gru_window_mma.cuh")
    assert "launch_cooperative(" in text and "grid_barrier(" in text
    assert text.count("gru_gates<") == 2
    assert "gru_gates<FAST>(" in read("gru_window_xp.cu")
    header = read("gru_window_grid.cuh")
    assert "cudaLaunchCooperativeKernel(" in header and "__trap()" in header
    for n in ("gru_window_xp_grid.cu", "gru_window_xp_bwd_grid.cu"):
        assert '#include "gru_window_grid.cuh"' in read(n), n
        assert "grid_barrier(" in read(n), n


def test_forward_grid_variants_edit_the_shipped_source():
    """helen_tpu_torch.obs.grid_variants --kernel fwd (the measurement of where
    K3's and K3f's time goes) edits the shipped source: every constant and
    every cut text it replaces is there, and off the card it refuses."""
    from helen_tpu_torch.obs import grid_variants as gv
    from helen_tpu_torch.ops import library

    with open(os.path.join(library.CSRC, gv.FWD_SOURCE)) as f:
        src = f.read()
    for name, (consts, edits) in gv.FWD_VARIANTS.items():
        out = gv.variant_source(src, consts, edits, gv.FWD_SOURCE)
        assert (out == src) == (name == "shipped"), name
    assert gv.main(["--kernel", "fwd", "--batch", "8"]) == 1


def fused_sums_reference(x, w, acc0):
    """``models.gru.mma_product``'s rule, one output at a time in exact
    rationals: per chunk of 16 k the accumulator and the nonzero products,
    each at its scale (a product ``2^(ea + eb)``, the accumulator
    ``2^(ec + 1)``, from ``frexp``), truncated toward zero to multiples of
    2^-27 of the largest scale, summed exactly, the sum truncated toward
    zero to float32."""
    import math
    from fractions import Fraction

    def to_f32_toward_zero(v):
        f = np.float32(float(v))  # float(v) is exact: v has under 53 bits
        if abs(Fraction(float(f))) > abs(v):
            f = np.nextafter(f, np.float32(0))
        return f

    M, K = x.shape
    out = np.zeros((M, w.shape[1]), np.float32)
    for i in range(M):
        for j in range(w.shape[1]):
            acc = np.float32(acc0[i, j])
            for k0 in range(0, K, 16):
                terms = []
                if acc != 0:
                    terms.append((Fraction(float(acc)), math.frexp(float(acc))[1] + 1))
                for k in range(k0, min(k0 + 16, K)):
                    a, b = float(x[i, k]), float(w[k, j])
                    if a != 0 and b != 0:
                        terms.append((Fraction(a) * Fraction(b),
                                      math.frexp(a)[1] + math.frexp(b)[1]))
                if not terms:
                    continue
                q = Fraction(2) ** (max(e for _, e in terms) - 27)
                acc = to_f32_toward_zero(sum(int(t / q) * q for t, _ in terms))
            out[i, j] = acc
    return out


@pytest.mark.parametrize("K,spread,zeros,cscale", [(16, 8, 0.0, 4.0), (40, 3, 0.2, 0.0),
                                                    (64, 0, 0.0, 64.0), (96, 2, 0.1, 1 / 64)])
def test_mma_product_is_the_tensor_cores_fused_sums(K, spread, zeros, cscale):
    """K3f's grid-order step product against an exact-rational statement of
    the same rule, on bf16 operands over 2^-spread .. 2^spread with some
    exact zeros, from accumulators of several sizes, K off the chunk of 16
    included; and it is not the k-order chain."""
    from helen_tpu_torch.models.gru import mma_product, ordered_product

    rng = np.random.default_rng(K + spread)
    x = rng.standard_normal((6, K)) * 2.0 ** rng.integers(-spread, spread + 1, (6, K))
    x[rng.random((6, K)) < zeros] = 0.0
    w = rng.standard_normal((K, 5)) / 8
    c = (rng.standard_normal((6, 5)) * cscale).astype(np.float32)
    xt, wt = (torch.from_numpy(a).float().to(torch.bfloat16).float() for a in (x, w))
    got = mma_product(xt, wt, torch.from_numpy(c))
    want = fused_sums_reference(xt.numpy(), wt.numpy(), c)
    assert np.array_equal(got.numpy(), want)
    # the same sums from 0.0, batched over a leading axis
    both = mma_product(torch.stack([xt, xt.flip(0)]), torch.stack([wt, wt]))
    assert torch.equal(both[0], mma_product(xt, wt))
    assert torch.equal(both[1], mma_product(xt.flip(0), wt))
    assert (mma_product(xt, wt) - xt.double().matmul(wt.double()).float()).abs().max() < 1e-4
    assert not torch.equal(mma_product(xt, wt), ordered_product(xt, wt)) or K == 16


@pytest.mark.parametrize("H,B", [(40, 7), (160, 3)])
def test_fast_plain_takes_the_order_of_the_design(H, B):
    """K3f's plain version sums in the order of the design it is asked for:
    k order for ``"chain"`` (the default on the CPU, bit for bit), the
    tensor cores' for ``"grid"``; both within the fast tier's tolerance of
    helen_tpu's fast ``_kernel`` (interpret mode), and apart from each other
    (an h rounded to bf16 one ulp apart)."""
    from helen_tpu.ops.gru_pallas import fused_bigru_window

    from helen_tpu_torch.ops import gru_window_xp as gx

    T = 5
    xp_f, xp_b, h0f, h0b, layer = case(T, B, H, seed=3 * H + B)
    want = pallas_window(fused_bigru_window, xp_f, xp_b, h0f, h0b, layer, True)
    args = ([torch.from_numpy(a).to(torch.bfloat16) for a in (xp_f, xp_b)]
            + [torch.from_numpy(a) for a in (h0f, h0b)] + [torch_layer(layer, fast=True)])
    default = gx.bigru_window_xp_fast_plain(*args)
    chain = gx.bigru_window_xp_fast_plain(*args, design="chain")
    grid = gx.bigru_window_xp_fast_plain(*args, design="grid")
    assert all(torch.equal(a, b) for a, b in zip(default, chain))
    assert not all(torch.equal(a, b) for a, b in zip(grid, chain))
    for got in (chain, grid):
        for g, w, what in zip(got, want, ("out_f", "out_b", "h_f", "h_b")):
            close(g, w, what, FAST_TOL)
    with pytest.raises(ValueError, match="not one of"):
        gx.bigru_window_xp_fast_plain(*args, design="mma")
