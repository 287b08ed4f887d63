"""Plain float64 reference of the port's intra decision bank.

What the port computes (``models/intra_frame.frame_intra_analysis``, its
stated precision float32 with TF32 off) is, for every S x S block of the
luma plane edge-padded to a multiple of S: the 35 HEVC intra predictions
from the block's 4S+1 neighbouring SOURCE samples (edge-replicated past
the picture, the reference smoothing folded in), as linear maps
(``intra_matrix.intra_weight_matrices``, frozen copy beside this file);
each mode's cost = SATD of (prediction - source) over 8x8 Hadamard tiles
/ 4, + a mode bias (planar 0, DC 2 lambda, angular 4 lambda), + psy x
|AC energy of the source - AC energy of the prediction| (the same
transform without each tile's DC term). The block's decision is the
first mode of least cost, and its cost that minimum.

Here the same semantics are computed again from the benchmark's own
source plane, in float64, in blocks of rows, on any torch device.
"""
from __future__ import annotations

import numpy as np
import torch

from encbench.reference.intra_matrix import intra_weight_matrices

FAST_MODES = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 34)


def _hadamard8() -> np.ndarray:
    h = np.array([[1.0]])
    while h.shape[0] < 8:
        h = np.block([[h, h], [h, -h]])
    return h


def block_refs(y: np.ndarray, S: int) -> np.ndarray:
    """[nB, 4S+1] float64: left column bottom-up, corner, top row; each of
    2S samples, clamped into the (S-padded) plane."""
    H, W = y.shape
    ph, pw = -(-H // S) * S, -(-W // S) * S
    yp = np.pad(y.astype(np.float64), ((0, ph - H), (0, pw - W)), mode="edge")
    by = np.arange(ph // S) * S
    bx = np.arange(pw // S) * S
    o = np.arange(2 * S)
    cy = lambda r: np.clip(r, 0, ph - 1)       # noqa: E731
    cx = lambda c: np.clip(c, 0, pw - 1)       # noqa: E731
    top = yp[cy(by - 1)[:, None, None], cx(bx[None, :, None] + o)]
    left = yp[cy(by[:, None, None] + o), cx(bx - 1)[None, :, None]]
    corner = yp[cy(by - 1)[:, None], cx(bx - 1)[None, :]]
    refs = np.concatenate([left[..., ::-1], corner[..., None], top], axis=-1)
    return refs.reshape(-1, 4 * S + 1), yp


def mode_costs(y: np.ndarray, S: int, psy: float, fast: bool,
               lambda_bits: float = 2.0, device="cpu",
               rows: int = 1024) -> np.ndarray:
    """[nB, nm] float64 cost of every candidate mode of every block."""
    refs, yp = block_refs(y, S)
    ph, pw = yp.shape
    modes = list(FAST_MODES) if fast else list(range(35))
    Wm = np.asarray(intra_weight_matrices(S), np.float64)[modes]
    nm = len(modes)
    dev = torch.device(device)
    Wt = torch.from_numpy(Wm.reshape(nm * S * S, -1).T.copy()).to(dev)
    h = torch.from_numpy(_hadamard8()).to(dev)
    blocks = (yp.reshape(ph // S, S, pw // S, S).transpose(0, 2, 1, 3)
              .reshape(-1, S * S))
    bias = np.full(nm, 4.0 * lambda_bits)
    bias[0], bias[1] = 0.0, 2.0 * lambda_bits
    bias_t = torch.from_numpy(bias).to(dev)
    t = S // 8

    def tiles(x):                          # [..., S*S] -> [..., t, t, 8, 8]
        return x.reshape(*x.shape[:-1], t, 8, t, 8).transpose(-3, -2)

    def had_abs(x):                        # |H x H| per 8x8 tile
        return (h @ tiles(x) @ h).abs()

    out = []
    for i in range(0, refs.shape[0], rows):
        r = torch.from_numpy(refs[i:i + rows]).to(dev)
        src = torch.from_numpy(blocks[i:i + rows].astype(np.float64)).to(dev)
        pred = (r @ Wt).reshape(-1, nm, S * S)
        a = had_abs(pred - src[:, None, :])
        cost = a.sum(dim=(-1, -2, -3, -4)) / 4.0 + bias_t
        if psy > 0:
            def ac(x):
                tt = had_abs(x)
                return (tt.sum(dim=(-1, -2, -3, -4))
                        - tt[..., 0, 0].sum(dim=(-1, -2))) / 4.0
            cost = cost + psy * (ac(src)[:, None] - ac(pred)).abs()
        out.append(cost.cpu().numpy())
    return np.concatenate(out)


def decision_gap(costs: np.ndarray, modes, port_mode: np.ndarray,
                 port_cost: np.ndarray) -> float:
    """The widest relative gap of the port's answer from the reference's,
    over the blocks: how far the port's reported cost lies from the least
    reference cost, and how far the reference cost of the port's chosen
    mode lies above that least cost; each over max(least cost, 1)."""
    best = costs.min(axis=1)
    pos = {m: k for k, m in enumerate(modes)}
    col = np.array([pos.get(int(m), -1) for m in port_mode])
    if (col < 0).any():
        return float("inf")
    chosen = costs[np.arange(costs.shape[0]), col]
    scale = np.maximum(best, 1.0)
    g = np.maximum(np.abs(port_cost.astype(np.float64) - best),
                   chosen - best) / scale
    return float(g.max()) if g.size else 0.0
