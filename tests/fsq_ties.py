"""The near-tie rule for FSQ codes (NeuCodec's distill encode and XCodec2's
encode), shared by the CPU tests and the card's. Imports no JAX.

Two f32 encodes that sum in other orders may round a bounded digit the
other way where it sits at a rounding boundary. So the codes' base-4
digits must be equal, or at most max(2, digits / 50) may differ, each where
the f64 bounded latent of the reference side is within 1e-3 of a half
(the rule of tests/test_xcodec2_parity.py's and
tests/test_neucodec_encode_parity.py's full-size gates).
"""

import math

import numpy as np

CB_DIM = 8


def bounded64(z) -> np.ndarray:
    """The FSQ bound applied twice, in f64, to a latent [..., 8]."""
    z = np.asarray(z, np.float64)
    half_l = 3.0 * (1 + 1e-3) / 2.0
    shift = math.atanh(0.5 / half_l)
    return half_l * np.tanh(half_l * np.tanh(z + shift) - 0.5 + shift) - 0.5


def digits(codes) -> np.ndarray:
    """int codes [T] or [T, 1] → their base-4 digits [T, 8]."""
    c = np.asarray(codes).reshape(-1).astype(np.int64)
    return (c[:, None] // 4 ** np.arange(CB_DIM)) % 4


def assert_fsq_codes(got, want, z) -> int:
    """got, want: int32 codes [T, 1]; z: the reference side's latent
    [T, 8] before the bound. → how many digits differ (each at a tie)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.int32, \
        (got.shape, want.shape, got.dtype)
    gd, wd = digits(got), digits(want)
    bad = np.argwhere(gd != wd)
    assert len(bad) <= max(2, gd.size // 50), \
        f"{len(bad)}/{gd.size} FSQ digits differ: not tie noise"
    zb = bounded64(z)
    for fr, d in bad:
        frac = abs(zb[fr, d] - np.floor(zb[fr, d]) - 0.5)
        assert frac < 1e-3, f"frame {fr} digit {d}: |frac - 0.5| = {frac:.2e}"
    return len(bad)


def level_digits(codes, levels) -> np.ndarray:
    """Mixed-radix FSQ codes [..., G] (NeMo's: digit i of a code is
    (code // Π levels[:i]) % levels[i]) → digits [..., G, d]."""
    lv = np.asarray(levels, np.int64)
    base = np.concatenate([[1], np.cumprod(lv[:-1])])
    return (np.asarray(codes, np.int64)[..., None] // base) % lv


def assert_level_codes(got, want, x1, levels) -> int:
    """got, want: int32 codes [T, G] of a mixed-radix FSQ; x1: the
    reference side's value before the round [T, G, d] (f64). The digits
    are equal, or at most max(2, digits / 50) differ, each where x1 lies
    within 1e-3 of a half. → how many digits differ."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.int32, \
        (got.shape, want.shape, got.dtype)
    gd, wd = level_digits(got, levels), level_digits(want, levels)
    bad = np.argwhere(gd != wd)
    assert len(bad) <= max(2, gd.size // 50), \
        f"{len(bad)}/{gd.size} FSQ digits differ: not tie noise"
    for fr, g, d in bad:
        v = float(x1[fr, g, d])
        frac = abs(v - np.floor(v) - 0.5)
        assert frac < 1e-3, f"frame {fr} group {g} digit {d}: |frac - 0.5| = {frac:.2e}"
    return len(bad)
