"""The near-tie rule for encode codes, shared by the CPU tests
(tests/test_torch_encode.py) and the card's (tests/test_torch_cuda.py).

Two f32 searches that sum in other orders may pick other rows where two
rows are a float near-tie. So codes must be equal, or at most max(2, T/100)
frames may differ, and each such frame's first differing level must be a
near-tie: the two picks' distances, recomputed in f64 from the port's
latent through the reference codes' prefix, differ by less than 1e-4
relative (the rule of tests/test_mimi_fullsize.py,
tests/test_dac_fullsize.py and tests/test_snac_parity.py). Imports no JAX.
"""

import numpy as np
import torch

from codec_tpu_torch.models import dac, mimi, snac

MARGIN = 1e-4


def assert_codes(got, want, margin_fn):
    """got, want [T, Q] int32; margin_fn(frame, level) → the f64 relative
    margin of got's pick over want's at that frame's first differing
    level."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.int32, \
        (got.shape, want.shape, got.dtype)
    diff = got != want
    frames = np.where(diff.any(axis=1))[0]
    assert len(frames) <= max(2, want.shape[0] // 100), \
        f"{len(frames)}/{want.shape[0]} frames differ: not tie noise"
    for fr in frames:
        q = int(diff[fr].argmax())
        m = margin_fn(int(fr), q)
        assert abs(m) < MARGIN, f"frame {fr} level {q}: margin {m:.2e}"


def f64(t):
    return np.asarray(t.detach().cpu().double() if torch.is_tensor(t) else t,
                      np.float64)


def euclid_margin(r, cb, prefix, got_v, want_v):
    """Euclidean RVQ: r [D] minus cb[lvl][c] for each prefix code, then the
    two picks' relative distance margin at the next level."""
    for lvl, c in enumerate(prefix):
        r = r - cb[lvl][c]
    d = ((r[None] - cb[len(prefix)]) ** 2).sum(-1)
    return (d[got_v] - d[want_v]) / max(d[want_v], 1e-12)


def _cosine_margin(z, cb, got_v, want_v):
    zn = z / max(np.linalg.norm(z), 1e-12)
    cbn = cb / np.maximum(np.linalg.norm(cb, axis=1, keepdims=True), 1e-12)
    d = ((zn[None] - cbn) ** 2).sum(-1)
    return (d[got_v] - d[want_v]) / max(d[want_v], 1e-12)


def mimi_margin(params, cfg, pcm, want, got):
    """margin_fn for one Mimi encode: pcm [n] f32, codes [T, Q]."""
    with torch.inference_mode():
        lat = f64(mimi.mimi_encode_latent_fn(
            params, torch.from_numpy(pcm)[None].to(params["sem_ip"].device),
            cfg)[0])

    def margin(fr, q):
        sem = q < cfg.n_sem
        ip, cb = ((params["sem_ip"], params["cb_sem"]) if sem
                  else (params["acu_ip"], params["cb_acu"]))
        base = 0 if sem else cfg.n_sem
        return euclid_margin(lat[fr] @ f64(ip).T, f64(cb), want[fr, base:q],
                             got[fr, q], want[fr, q])
    return margin


def dac_margin(params, cfg, pcm, want, got):
    """margin_fn for one DAC encode (cosine search in the projected space,
    raw-codebook residual updates)."""
    with torch.inference_mode():
        lat = f64(dac.dac_encode_latent_fn(
            params, torch.from_numpy(pcm)[None].to(params["vq"]["cb"].device),
            cfg)[0])
    vq = {k: f64(v) for k, v in params["vq"].items()}

    def margin(fr, q):
        r = lat[fr]
        for lvl in range(q):
            r = r - (vq["out_w"][lvl] @ vq["cb"][lvl][want[fr, lvl]]
                     + vq["out_b"][lvl])
        return _cosine_margin(vq["in_w"][q] @ r + vq["in_b"][q], vq["cb"][q],
                              got[fr, q], want[fr, q])
    return margin


def snac_margin(params, cfg, pcm, want, got):
    """margin_fn for one SNAC encode: pcm [n] already padded to pad_to,
    codes [T, 3] in the Orpheus packing."""
    with torch.inference_mode():
        lat = f64(snac.snac_encode_latent_fn(
            params, torch.from_numpy(pcm)[None].to(params["vq"]["cb"].device),
            cfg)[0])
    vq = {k: f64(v) for k, v in params["vq"].items()}

    def margin(fr, q):
        residual = lat
        for lvl in range(q):
            s = cfg.vq_strides[lvl]
            zq = vq["cb"][lvl][want[::s, lvl]] @ vq["out_w"][lvl].T \
                + vq["out_b"][lvl]
            residual = residual - np.repeat(zq, s, axis=0)
        s = cfg.vq_strides[q]
        pooled = residual.reshape(-1, s, residual.shape[-1]).mean(axis=1)
        return _cosine_margin(vq["in_w"][q] @ pooled[fr // s] + vq["in_b"][q],
                              vq["cb"][q], got[fr, q], want[fr, q])
    return margin


def model_margin(model, pcm, want, got):
    """margin_fn for a loaded model of any of the three archs; pcm [n] as
    the model encodes it (SNAC: padded to pad_to)."""
    fn = {"mimi": mimi_margin, "dac": dac_margin, "snac": snac_margin}
    return fn[model.arch](model.params, model.cfg, pcm, want, got)
