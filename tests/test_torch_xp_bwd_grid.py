"""Pass 1 of the xp-stream backward (K4) in its "grid" design
(ops.gru_window_xp_bwd_grid): its plain pieces against helen_tpu's
``_bwd_kernel`` (interpret mode) and against the one-launch design's plain
version, the rule that picks the design, and the wrappers off the card.

The design's plain version is ``bwd_hp_plain`` (the gate pass, ``h_prev @
W_hh`` without ``b_hh``), then :func:`xp_bwd_rec_grid_plain` (the recurrence
given xp and hp: ``unwind_gates`` per direction). Chained with pass 2's
plain version they are held against ``fused_bigru_window_train_bwd(...,
interpret=True)`` at 1e-5 (scaled by the magnitude, at least 1, for the
weight cotangents, which are sums over the window's T*B rows), as
tests/test_torch_gru_window_xp.py holds the one-launch plain version;
chained alone they equal ``bigru_window_xp_bwd_rec_plain`` exactly (the
same torch ops in the same order). The kernel runs only on a CUDA device
(tests/test_torch_cuda.py, where the two designs are equal bit for bit,
and chip_smoke.py phase 9b).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TOL = 1e-5


def make_layer(rng, d, h):
    k = 1.0 / np.sqrt(h)
    u = lambda *s: rng.uniform(-k, k, s).astype(np.float32)  # noqa: E731
    return {dr: {"w_ih": u(d, 3 * h), "w_hh": u(h, 3 * h), "b_ih": u(3 * h),
                 "b_hh": u(3 * h)} for dr in ("fwd", "bwd")}


def case(T, B, H, seed):
    """The inputs of one K4 launch, torch on the CPU: projected streams of a
    unit-range input, the plain forward's outputs, nonzero h0, dout and
    final-state cotangents (a zero cotangent would hide an off-by-one in the
    h_prev shift); and the numpy layer."""
    from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp_plain

    rng = np.random.default_rng(seed)
    layer = make_layer(rng, 2 * H, H)
    lt = {d: {k: torch.from_numpy(v) for k, v in p.items()} for d, p in layer.items()}
    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))  # noqa: E731
    x = r(T, B, 2 * H)
    xp_f, xp_b = (x @ lt[d]["w_ih"] + lt[d]["b_ih"] for d in ("fwd", "bwd"))
    h0f, h0b, dhf, dhb = (r(B, H) for _ in range(4))
    dof, dob = r(T, B, H), r(T, B, H)
    of, ob, _, _ = bigru_window_xp_plain(xp_f, xp_b, h0f, h0b, lt)
    return (xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt), layer


def chained(xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt):
    """The grid design's plain pieces in the order the wrapper launches them:
    (dxp, dhp_n, dh0_f, dh0_b)."""
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, lt)
    return gxb.bigru_window_xp_bwd_rec_grid(xp_f, xp_b, hp, h0f, h0b, of, ob, dof, dob, dhf,
                                            dhb, lt)


def close(got, want, what, scaled=False):
    want = np.asarray(want)
    tol = TOL * max(1.0, float(np.abs(want).max())) if scaled else TOL
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("T,B,H", [(5, 8, 128), (4, 8, 256)])
def test_chained_plain_matches_pallas_train_backward(T, B, H):
    """The grid design's plain pieces, then pass 2's plain version, against
    helen_tpu's ``_bwd_kernel`` in interpret mode: dxp, dh0, dW_hh and
    db_hh of both directions."""
    from helen_tpu.ops.gru_pallas_train import fused_bigru_window_train_bwd

    from helen_tpu_torch.ops.gru_window_xp_bwd import bigru_window_xp_bwd_wgrad_plain

    args, layer = case(T, B, H, seed=7 * T + H)
    xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt = args
    dxp, dhpn, dh0f, dh0b = chained(*args)
    g = bigru_window_xp_bwd_wgrad_plain(h0f, h0b, of, ob, dxp, dhpn)
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    f, b = layer["fwd"], layer["bwd"]
    want = fused_bigru_window_train_bwd(
        J(xp_f), J(xp_b), J(of), J(ob), J(h0f), J(h0b), J(dof), J(dob), J(dhf), J(dhb),
        jnp.asarray(f["w_hh"]), jnp.asarray(b["w_hh"]), jnp.asarray(f["b_hh"][None]),
        jnp.asarray(b["b_hh"][None]), interpret=True)
    wdxp_f, wdxp_b, wdh0_f, wdh0_b, dw_f, dw_b, db_f, db_b = want
    close(dxp[0], wdxp_f, "dxp_f")
    close(dxp[1], wdxp_b, "dxp_b")
    close(dh0f, wdh0_f, "dh0_f")
    close(dh0b, wdh0_b, "dh0_b")
    close(g["fwd"]["w_hh"], dw_f, "fwd.w_hh", scaled=True)
    close(g["bwd"]["w_hh"], dw_b, "bwd.w_hh", scaled=True)
    close(g["fwd"]["b_hh"], np.asarray(db_f)[0], "fwd.b_hh", scaled=True)
    close(g["bwd"]["b_hh"], np.asarray(db_b)[0], "bwd.b_hh", scaled=True)


# an even batch, ragged ones, one step, a width that is no multiple of 4
@pytest.mark.parametrize("T,B,H", [(6, 8, 32), (5, 13, 64), (1, 7, 48), (1, 1, 40),
                                   (4, 3, 37)])
def test_chained_plain_equals_one_launch_plain(T, B, H):
    """The grid design's plain pieces chained against
    bigru_window_xp_bwd_rec_plain: dxp, dhp_n, dh0 equal to the bit."""
    from helen_tpu_torch.ops.gru_window_xp_bwd import bigru_window_xp_bwd_rec_plain

    args, _ = case(T, B, H, seed=T * B + H)
    got = chained(*args)
    want = bigru_window_xp_bwd_rec_plain(*args)
    for g, w, what in zip(got, want, ("dxp", "dhp_n", "dh0_f", "dh0_b")):
        assert g.shape == w.shape, what
        assert torch.equal(g, w), f"{what}: max diff {float((g - w).abs().max())}"


# ---------------------------------------------------------------------------
# a CPU emulation of the grid's carry decomposition
# ---------------------------------------------------------------------------

def thread_pairs(B, Uc, rpt):
    """The (row, unit) pairs of one block's threads in the tile of ``rpt``
    rows per thread, as the kernel assigns them, in the gates and in the
    carry: 8 unit groups x 32 row groups (``RG``); thread
    ``tid`` is ``(ug, rg) = (tid % 8, tid // 8)`` and holds unit slots ``ug
    + 8 q``, q < 2, and rows ``r0 + rg + p RG``, p < ``rpt``, of each row
    block of ``RG rpt`` rows; the pairs past B or past the block's ``Uc``
    units are not written. Rows, units and the thread of each write, as
    (n,) index tensors."""
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    rg_n = gg.BG_RG
    tid = torch.arange(gg.BG_UG * rg_n)
    ug, rg = tid % gg.BG_UG, tid // gg.BG_UG
    p, q = torch.arange(rpt), torch.arange(gg.BG_UPT)
    rows, units, tids = [], [], []
    for r0 in range(0, B, rg_n * rpt):
        b = r0 + rg[:, None, None] + p[None, :, None] * rg_n
        u = ug[:, None, None] + q[None, None, :] * gg.BG_UG
        t = tid[:, None, None].expand(-1, rpt, gg.BG_UPT)
        b, u = torch.broadcast_tensors(b, u)
        keep = (b < B) & (u < Uc)
        rows.append(b[keep])
        units.append(u[keep])
        tids.append(t[keep])
    return torch.cat(rows), torch.cat(units), torch.cat(tids)


def fill_slots(rpt):
    """Each warp's fills of one ring chunk, as the kernel assigns them: NF =
    KC / 4 float4 of dhp per row (KC = 32 k at row blocks of at most 64 rows,
    else 16), NSLOT = WR NF / 32 float4 per lane (WR = 4 ``rpt`` row slots a
    warp); lane l fills float4 l % NF of slots l // NF + n (32 // NF), n <
    NSLOT, slot a + 4 p being row 4 w + a + p RG of the row block, at the
    ring's float4 slot NF + (f ^ swz(slot)). {warp: [(slot, f, row, at)]}."""
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    rg_n, wr = gg.BG_RG, 4 * rpt
    nf = (2 * gg.BG_KC if rg_n * rpt <= 64 else gg.BG_KC) // 4
    nslot = wr * nf // 32
    assert nslot * 32 == wr * nf
    got = {}
    for w in range(gg.BG_UG * rg_n // 32):
        for ln in range(32):
            f = ln % nf
            for n in range(nslot):
                sl = ln // nf + n * (32 // nf)
                row = 4 * w + sl % 4 + sl // 4 * rg_n
                at = sl * nf + (f ^ (sl * nf // 8 % nf))
                got.setdefault(w, []).append((sl, f, row, at))
    return got


def fill_rows(B, rpt):
    """The rows each warp fills into its ring (:func:`fill_slots`), over
    every row block of a batch of ``B``: {warp: set of rows}."""
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    got = {}
    for w, fills in fill_slots(rpt).items():
        rows = {r0 + row for r0 in range(0, B, gg.BG_RG * rpt) for _, _, row, _ in fills
                if r0 + row < B}
        if rows:
            got[w] = rows
    return got


def grid_emulation(xp_f, xp_b, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b,
                   layer, U, rpt=None):
    """K4's grid recurrence on the CPU: ``C = ceil(H / U)`` blocks per
    direction, block ``c`` owning units ``[c U, (c + 1) U)`` and their rows
    of ``W_hh``; at each step every block writes the gates of its threads'
    (row, unit) pairs (:func:`thread_pairs`, the tile of ``rpt`` rows per
    thread, by default the one ``grid_tile`` picks), each pair once, then,
    after the barrier, reads the whole step's dhp and adds its units' carry
    product to the dh z that the same pairs wrote (``__fadd_rn``: one
    float32 add, last). Returns ``(dxp, dhp_n, dh0_f, dh0_b)``.

    The block's product is ``dhp @ rows.T``, its rows of ``W_hh`` scattered
    back into a zero ``(H, 3H)`` matrix: the CPU's matmul gives a column the
    same bits whatever the other rows hold at one shape, not at another, and
    the kernel's own order (one fmaf chain over k) is the card's to check
    (tests/test_torch_cuda.py)."""
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    T, B, H = out_f.shape
    C = -(-H // U)
    rpt = gg.grid_tile(B) if rpt is None else rpt
    res = []
    for i, (d, xp, out, h0, dout, dhf, rev) in enumerate(
            (("fwd", xp_f, out_f, h0_f, dout_f, dh_f, False),
             ("bwd", xp_b, out_b, h0_b, dout_b, dh_b, True))):
        w = layer[d]["w_hh"]
        hpb = hp[i] + layer[d]["b_hh"]
        h_prev = gbs.h_prev_of(out, h0, rev)
        r = torch.sigmoid(xp[..., :H] + hpb[..., :H])
        z = torch.sigmoid(xp[..., H:2 * H] + hpb[..., H:2 * H])
        hp_n = hpb[..., 2 * H:]
        n = torch.tanh(xp[..., 2 * H:] + r * hp_n)
        mats, pairs = [], []
        for c in range(C):
            full = torch.zeros_like(w)
            full[c * U:(c + 1) * U] = w[c * U:(c + 1) * U]
            mats.append(full)
            rows, units, _ = thread_pairs(B, min(U, H - c * U), rpt)
            pairs.append((rows, c * U + units))
        nan = lambda *s: torch.full(s, float("nan"), dtype=xp.dtype)  # noqa: E731
        dxp, dhpn, carry = nan(T, B, 3 * H), nan(T, B, H), dhf
        for t in (range(T) if rev else range(T - 1, -1, -1)):
            dh = dout[t] + carry
            dz = dh * (h_prev[t] - n[t])
            da = dh * (1.0 - z[t]) * (1.0 - n[t] * n[t])
            dr = da * hp_n[t]
            drpre = dr * r[t] * (1.0 - r[t])
            dzpre = dz * z[t] * (1.0 - z[t])
            dn = da * r[t]
            dhz = dh * z[t]
            for rows, cols in pairs:
                assert dhpn[t][rows, cols].isnan().all(), "a gate pair written twice"
                for g, v in enumerate((drpre, dzpre, da)):
                    dxp[t][rows, g * H + cols] = v[rows, cols]
                dhpn[t][rows, cols] = dn[rows, cols]
            dhp = torch.cat([dxp[t][:, :2 * H], dhpn[t]], dim=-1)
            carry = torch.full_like(dhz, float("nan"))
            for c, (rows, cols) in enumerate(pairs):
                prod = dhp @ mats[c].T
                assert carry[rows, cols].isnan().all(), "a carry pair written twice"
                carry[rows, cols] = dhz[rows, cols] + prod[rows, cols]
        res.append((dxp, dhpn, carry))
    return (torch.stack([res[0][0], res[1][0]]), torch.stack([res[0][1], res[1][1]]),
            res[0][2], res[1][2])


# per U, a width whose last block is short (40 = 2 x 16 + 8 = 3 x 11 + 7; 36
# = 3 x 10 + 6; 5 = 2 x 2 + 1): the H100's U at H=1024 (16), at H=700 (11)
# and H=640 (10), and at the forced route's H=128 (2)
EMULATION_H = {16: 40, 11: 40, 10: 36, 2: 5}


# one row, a ragged batch, the wide train's 64, one row past a 64-row block,
# and ragged 128-row blocks (300 = 2 x 128 + 44), each at the tile the rule
# picks and at every tile the entry has
@pytest.mark.parametrize("B", [1, 13, 64, 65, 300])
@pytest.mark.parametrize("U", [16, 11, 10, 2])
def test_grid_emulation_equals_plain_to_the_bit(B, U):
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    H = EMULATION_H[U]
    args, _ = case(3, B, H, seed=B + 100 * U)
    xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, lt = args
    hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, lt)
    rest = (h0f, h0b, of, ob, dof, dob, dhf, dhb, lt)
    want = gg.xp_bwd_rec_grid_plain(xp_f, xp_b, hp, *rest)
    for rpt in (None, *gg.GRID_TILES):
        got = grid_emulation(xp_f, xp_b, hp, *rest, U, rpt)
        for g, w, what in zip(got, want, ("dxp", "dhp_n", "dh0_f", "dh0_b")):
            assert torch.equal(g, w), f"{what}, tile {rpt}: max diff {float((g - w).abs().max())}"


@pytest.mark.parametrize("B", [1, 13, 64, 65, 127, 128, 300, 512])
@pytest.mark.parametrize("U", [1, 2, 3, 10, 11, 16])
def test_thread_tiles_cover_each_pair_once(B, U):
    """Every tile's threads hold each (row, unit) pair of a block exactly
    once, for a full block and a short last one; a warp's 32 threads are 8
    unit groups x 4 whole row groups, and the rows a warp fills into its
    ring are the rows its threads read."""
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    for rpt in gg.GRID_TILES:
        for Uc in {U, max(1, U // 2)}:
            rows, units, tids = thread_pairs(B, Uc, rpt)
            got = sorted(zip(rows.tolist(), units.tolist()))
            assert got == [(b, u) for b in range(B) for u in range(Uc)], (rpt, Uc)
        rows, _, tids = thread_pairs(B, 16, rpt)
        read = {}
        for b, t in zip(rows.tolist(), tids.tolist()):
            read.setdefault(t // 32, set()).add(b)
        assert fill_rows(B, rpt) == read, rpt


@pytest.mark.parametrize("rpt", [2, 4])
def test_each_warp_fills_each_float4_of_its_chunk_once(rpt):
    """A warp's lanes write every (row slot, float4) pair of a ring chunk
    exactly once, each to its own float4 of the chunk (the swizzle is a
    permutation of each slot's float4), and slot a + 4 p is the row its
    threads read at p; the formulas are the source's."""
    import os

    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg
    from helen_tpu_torch.ops import library

    with open(os.path.join(library.CSRC, "gru_window_xp_bwd_grid.cu")) as f:
        src = f.read()
    for line in ("return s * nf / 8 % nf;", "const int sl = ln / NF + n * (32 / NF);",
                 "frow[n] = warp * BG_RGW + sl % BG_RGW + sl / BG_RGW * RG;",
                 "foff[n] = 4 * (sl * NF + (ln % NF ^ swz(sl, NF)));"):
        assert line in src, line
    assert rpt in gg.GRID_TILES
    wr = 4 * rpt
    nf = (2 * gg.BG_KC if gg.BG_RG * rpt <= 64 else gg.BG_KC) // 4
    for w, fills in fill_slots(rpt).items():
        assert sorted((sl, f) for sl, f, _, _ in fills) == [
            (sl, f) for sl in range(wr) for f in range(nf)], w
        assert sorted(at for *_, at in fills) == list(range(wr * nf)), w
        assert {(sl, row) for sl, _, row, _ in fills} == {
            (a + 4 * p, 4 * w + a + p * gg.BG_RG) for a in range(4) for p in range(rpt)}, w


# B -> (rows per thread, rows per row block): 2 rows x 2 units up to B=64
# (one row block of 64 rows), 4 rows x 2 units above (128-row blocks), in
# 256 threads at every tile
@pytest.mark.parametrize("B,rpt,rows", [
    (512, 4, 128), (300, 4, 128), (128, 4, 128), (65, 4, 128), (64, 2, 64), (13, 2, 64),
    (1, 2, 64),
])
def test_grid_tile_rule(B, rpt, rows):
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    assert gg.grid_tile(B) == rpt and rpt in gg.GRID_TILES
    assert gg.BG_RG * rpt == rows
    # whole warps of whole row groups, two warps an SM quarter
    threads = gg.BG_UG * gg.BG_RG
    assert threads == 256 and 32 % gg.BG_UG == 0 and gg.BG_RG % (32 // gg.BG_UG) == 0
    assert gg.BG_UG * gg.BG_UPT == gg.GRID_MAX_UNITS


def test_smem_mirror_matches_the_source():
    """grid_smem_bytes, the thread layout and the tiles mirror
    csrc/gru_window_xp_bwd_grid.cu (the library checks the byte counts when
    it is bound, on the card): the constants are the source's, the entry
    launches one instance per tile the rule can pick and refuses the rest,
    and the byte count is the layout's, counted here element by element."""
    import os
    import re

    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg
    from helen_tpu_torch.ops import library

    with open(os.path.join(library.CSRC, "gru_window_xp_bwd_grid.cu")) as f:
        src = f.read()
    const = {m.group(1): m.group(2) for m in
             re.finditer(r"constexpr int (BG_[A-Z_]+) = ([^;]+);", src)}
    assert const["BG_UG"] == str(gg.BG_UG) and const["BG_UPT"] == str(gg.BG_UPT)
    assert const["BG_RG"] == str(gg.BG_RG)
    assert const["BG_KC"] == str(gg.BG_KC) and const["BG_RING"] == str(gg.BG_RING)
    assert const["BG_MAX_UNITS"] == str(gg.GRID_MAX_UNITS)
    cases = re.findall(r"case (\d+): return launch_cooperative\("
                       r"xp_bwd_rec_grid_kernel<(\d+)>", src)
    assert [int(r) for _, r in cases] == sorted(gg.GRID_TILES)
    assert all(key == r for key, r in cases)
    assert "default: return (int)cudaErrorInvalidValue;" in src
    # every tile the entry has is one the rule picks
    assert {gg.grid_tile(b) for b in range(1, 600)} == set(gg.GRID_TILES)
    for h in (1, 37, 40, 128, 160, 610, 640, 1000, 1024):
        for u in (1, 2, 3, 10, 16):
            stride = -(-3 * h // 32) * 32 + 4
            assert stride >= 3 * h and stride % 32 == 4
            assert gg.grid_smem_bytes(h, u) == 4 * (u * stride + 8192)


# the H100 SXM: 132 SMs, 232,448 bytes of opt-in shared memory per block
@pytest.mark.parametrize("H,units,blocks,smem", [
    (1024, 16, 64, 229_632), (1000, 16, 63, 225_536), (768, 12, 64, 143_552),
    (640, 10, 64, 109_728), (160, 3, 54, 38_576), (128, 2, 64, 35_872),
])
def test_grid_units_on_the_h100(H, units, blocks, smem):
    """The smallest U whose 2 ceil(H / U) blocks fit the 132 SMs, and its
    shared memory: W_hh's U rows (3H rounded up to 32 floats plus 4) and
    the ring's 8192 floats of dhp."""
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    assert gg.grid_units(H, 132, 232_448) == units
    assert -(-H // units) == blocks and 2 * blocks <= 132
    assert -(-H // (units - 1)) * 2 > 132  # one unit fewer needs more SMs
    assert gg.grid_smem_bytes(H, units) == smem <= 232_448


@pytest.fixture
def card(monkeypatch):
    """Set the card the rule reads (SMs, opt-in shared memory per block)."""
    from helen_tpu_torch.ops import library

    return lambda sms, budget: monkeypatch.setattr(library, "_card", {0: (sms, budget)})


@pytest.mark.parametrize("H", [128, 160, 640, 768, 1024])
@pytest.mark.parametrize("B", [64, 300, 1])
def test_xp_bwd_design_takes_every_xp_width_on_the_h100(card, H, B):
    """"grid" at every width of the xp route (640-1024) and at the forced
    route's H=128 and 160, for any batch, on the H100 SXM."""
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    card(132, 232_448)
    assert gxb.xp_bwd_design(H, B) == "grid"
    assert gxb.xp_bwd_design(H, B, design="chain") == "chain"


@pytest.mark.parametrize("H,sms,budget,want", [
    # fewer SMs: a larger U, until its W_hh rows no longer fit
    (640, 114, 232_448, 12), (768, 114, 232_448, 14), (128, 114, 232_448, 3),
    (1024, 114, 232_448, None),
    # a smaller budget: H=1024's 16 rows no longer fit, H=640's 10 do
    (1024, 132, 200_000, None), (640, 132, 120_000, 10), (640, 132, 109_000, None),
    # a card too small for 16 units per block
    (1024, 60, 10**9, None),
])
def test_grid_units_follow_the_card(card, H, sms, budget, want):
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    assert gg.grid_units(H, sms, budget) == want
    card(sms, budget)
    assert gxb.xp_bwd_design(H, 64) == ("chain" if want is None else "grid")


def test_forced_grid_design_is_checked(card):
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    card(132, 232_448)
    assert gxb.xp_bwd_design(1024, 64, design="grid") == "grid"
    with pytest.raises(ValueError, match="not one of"):
        gxb.xp_bwd_design(1024, 64, design="smem")
    card(114, 232_448)
    with pytest.raises(ValueError, match="does not take H=1024"):
        gxb.xp_bwd_design(1024, 64, design="grid")
    card(132, 109_000)
    with pytest.raises(ValueError, match="does not take H=640"):
        gxb.xp_bwd_design(640, 64, design="grid")


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    """On CPU tensors every wrapper, in either forced design, runs its plain
    version, and no counter moves; the counters name every kernel."""
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    args, _ = case(4, 3, 32, seed=5)
    gxb.reset_launch_counts()
    gb.reset_launch_counts()
    want = gxb.bigru_window_xp_bwd_plain(*args)
    want_rec = gxb.bigru_window_xp_bwd_rec_plain(*args)
    for design in gxb.DESIGNS:
        for g, w in zip(gxb.bigru_window_xp_bwd_rec(*args, design=design), want_rec):
            assert torch.equal(g, w)
        got = gxb.bigru_window_xp_bwd(*args, design=design)
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g, w)
        for d in ("fwd", "bwd"):
            for k in ("w_hh", "b_hh"):
                assert torch.equal(got[4][d][k], want[4][d][k])
    for g, w in zip(chained(*args), want_rec):
        assert torch.equal(g, w)
    assert set(gxb.launch_counts.values()) == {0}
    assert set(gb.launch_counts.values()) == {0}
    assert set(gxb.launch_counts) == {
        "bigru_window_xp_bwd_rec", "bigru_window_xp_bwd_wgrad", "bigru_window_xp_bwd_hp",
        "bigru_window_xp_bwd_rec_grid", "bigru_window_xp_bwd_rec_grid_r4",
        "bigru_window_xp_bwd_rec_grid_r2", "bigru_window_xp_bwd_rec_chain",
        *(f"bigru_window_xp_bwd_rec_chain_r{r}" for r in (8, 4, 2, 1))}


def test_wrappers_raise_off_cpu_and_cuda():
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    T, B, H = 3, 2, 32
    meta = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")  # noqa: E731
    layer = {d: {"w_hh": meta(H, 3 * H), "b_hh": meta(3 * H)} for d in ("fwd", "bwd")}
    x, s, v = meta(T, B, 3 * H), meta(T, B, H), meta(B, H)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gxb.bigru_window_xp_bwd_rec_grid(x, x, meta(2, T, B, 3 * H), v, v, s, s, s, s, v, v,
                                         layer)
    for design in (None, "grid", "chain"):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            gxb.bigru_window_xp_bwd_rec(x, x, v, v, s, s, s, s, v, v, layer, design=design)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            gxb.bigru_window_xp_bwd(x, x, v, v, s, s, s, s, v, v, layer, design=design)


def test_source_is_built_with_the_others():
    """build_kernels compiles every ops/csrc/*.cu: gru_window_xp_bwd_grid.cu
    with its entry points and a cooperative launch, and both designs share
    gru_cell_bwd."""
    import glob
    import os

    from helen_tpu_torch.ops import library

    names = {os.path.basename(p) for p in glob.glob(os.path.join(library.CSRC, "*.cu"))}
    assert "gru_window_xp_bwd_grid.cu" in names
    with open(os.path.join(library.CSRC, "gru_window_xp_bwd_grid.cu")) as f:
        text = f.read()
    for fn in ("bigru_window_xp_bwd_rec_grid", "bigru_window_xp_bwd_grid_smem_bytes",
               "gru_window_sm_count"):
        assert f" {fn}(" in text, fn
    # the cooperative launch and the barrier are the shared grid header's
    assert "gru_cell_bwd(" in text and "launch_cooperative(" in text
    assert '#include "gru_window_grid.cuh"' in text and "grid_barrier(" in text
    with open(os.path.join(library.CSRC, "gru_window_grid.cuh")) as f:
        assert "cudaLaunchCooperativeKernel(" in f.read()
    with open(os.path.join(library.CSRC, "gru_window_xp_bwd.cu")) as f:
        assert "gru_cell_bwd(" in f.read()


def test_grid_variants_edit_the_shipped_source():
    """helen_tpu_torch.obs.grid_variants (the measurement of where the grid
    recurrence's time goes) edits the shipped source: every constant and
    every cut text it replaces is there, and off the card it refuses."""
    import os

    from helen_tpu_torch.obs import grid_variants as gv
    from helen_tpu_torch.ops import library

    with open(os.path.join(library.CSRC, gv.SOURCE)) as f:
        src = f.read()
    for name, (consts, edits) in gv.VARIANTS.items():
        out = gv.variant_source(src, consts, edits)
        assert (out == src) == (name == "shipped"), name
    assert gv.main(["--hidden", "64"]) == 1
