"""The work arithmetic against counts made by hand from the shapes."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib import work  # noqa: E402


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def _by_hand(h, training):
    """2 FLOP a multiply-add; per layer 2 directions x 100 steps."""
    enc_ih, enc_hh = 2 * 2 * 100 * 90 * 3 * h, 2 * 2 * 100 * h * 3 * h
    dec_ih, dec_hh = 2 * 2 * 100 * 2 * h * 3 * h, enc_hh
    heads = 2 * 100 * 2 * h * 16
    if not training:
        return enc_ih + enc_hh + dec_ih + dec_hh + heads
    # no input gradient for the image; everything else forward + 2 backward
    return 2 * enc_ih + 3 * enc_hh + 3 * dec_ih + 3 * dec_hh + 3 * heads


@pytest.mark.parametrize("name,h,infer", [("helen_h128", 128, 93.2864e6),
                                          ("helen_h1024", 1024, 5.1503104e9)])
def test_window_flop(name, h, infer):
    cfg = _cfg(name)
    assert work.window_flop(cfg, False) == pytest.approx(infer, rel=1e-12)
    assert work.window_flop(cfg, False) == _by_hand(h, False)
    assert work.window_flop(cfg, True) == _by_hand(h, True)


def test_flagship_and_wide_window_sizes():
    assert work.window_flop(_cfg("helen_h128"), False) == pytest.approx(93.3e6, rel=1e-3)
    assert work.window_flop(_cfg("helen_h1024"), False) == pytest.approx(5.15e9, rel=1e-3)
    assert work.window_flop(_cfg("helen_h1024"), True) == pytest.approx(15.34e9, rel=1e-3)


@pytest.mark.parametrize("name,params", [("helen_h128", 2 * (90 + 128 + 2) * 384 +
                                          2 * (256 + 128 + 2) * 384 + 257 * 16),
                                         ("helen_h1024", 25_776_144)])
def test_num_params(name, params):
    assert work.num_params(_cfg(name)) == params


def test_least_time_takes_the_larger_bound():
    assert work.least_seconds(work.PEAK_FLOPS, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 2 * work.PEAK_BYTES_PER_S) == pytest.approx(2.0)
    # the flagship's layer-windows at B=512 are bound by their products
    cfg = _cfg("helen_h128")
    for flop, nbytes in work.window_parts(cfg, 512, False)[:2]:
        assert flop / work.PEAK_FLOPS > nbytes / work.PEAK_BYTES_PER_S


def test_layer_window_bytes_by_hand():
    # the flagship's encoder window at B=512: the uint8 window, both
    # directions' weights and biases, h0 and hn, both output halves
    B, T, D, H = 512, 100, 90, 128
    nbytes = B * T * D + 2 * 4 * ((D + H) * 3 * H + 6 * H) + 2 * (2 * 4 * B * H) \
        + 2 * 4 * B * T * H
    assert work.layer_window(B, T, D, H, 1, True, False)[1] == nbytes
    assert work.adam_window(_cfg("helen_h1024")) == (0.0, 7 * 4 * 25_776_144)
