"""Lookahead-lite: lowres frame complexity estimation for rate control
(x265 analog: Lookahead/slicetype.cpp estimateFrameCost:3056 +
Lowres::init lowres.cpp:259 + the frameInitLowres primitive).

Half-res downscale + per-8x8 min(intra, inter) cost on the device: the
complexity signal that drives CRF/ABR/VBV (ratecontrol.cpp
rateEstimateQscale's m_currentSatd), the scenecut test and cuTree.

The intra cost is the SATD kernel (engine.me.satd8_batched) of the
DC-removed 8x8 blocks; the inter cost is the fused SAD sweep + argmin
kernel (ops.cuda_kernels.sad_sweep_argmin) over the +-R integer window
against the previous lowres plane, with no mv cost. Both are integer,
so the costs and mvs equal the JAX package's exactly. The B-frame
slicetype search (batched pair costs, slicetype_split) is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from x265_tpu_torch.engine.me import satd8_batched
from x265_tpu_torch.engine.planes import pad_dev
from x265_tpu_torch.ops.cuda_kernels import sad_sweep_argmin
from x265_tpu_torch.utils.device import resolve_device


def lowres_downscale(y: torch.Tensor) -> torch.Tensor:
    """Half-res by 2x2 mean (frameInitLowres analog), int32."""
    H, W = y.shape
    y = y.to(torch.int32)
    s = y.reshape(H // 2, 2, W // 2, 2).sum(dim=(1, 3), dtype=torch.int32)
    return (s + 2) >> 2


def _downscale_and_costs(y: torch.Tensor, prev: torch.Tensor, lh: int,
                         lw: int, R: int = 4):
    """Downscale, edge-pad to (lh, lw), then the lowres costs against
    prev -> (low, icost, mcost, mv)."""
    low = lowres_downscale(y)
    low = pad_dev(low, (0, lh - low.shape[0], 0, lw - low.shape[1]))
    icost, mcost, mv = _lowres_costs(low, prev, R)
    return low, icost, mcost, mv


def _lowres_costs(low: torch.Tensor, prev: torch.Tensor, R: int = 4):
    """Per-8x8-block (intra_cost, inter_cost, best_mv) on the lowres plane.

    intra: SA8D energy after DC removal (lowresIntraEstimate proxy);
    inter: min over the (2R+1)^2 integer window of block SAD vs prev
    (estimateCUCost's hex search collapsed to a dense sweep); best_mv is
    the winning displacement (cuTree propagation needs it).
    """
    H, W = low.shape
    nby, nbx = H // 8, W // 8
    blocks = low.reshape(nby, 8, nbx, 8).permute(0, 2, 1, 3)
    # the mean of 64 non-negative integers, truncated: sum >> 6
    dc = blocks.sum(dim=(2, 3), keepdim=True, dtype=torch.int32) >> 6
    flat = (blocks - dc).reshape(-1, 8, 8).contiguous()
    icost = satd8_batched(flat, torch.zeros_like(flat)).reshape(nby, nbx)

    n = 2 * R + 1
    prev_pad = pad_dev(prev, (R, R, R, R), torch.int16)
    mvcost = torch.zeros((n * n,), dtype=torch.float32, device=low.device)
    # first minimum over d = dy*n + dx, as the JAX package's scan
    idx, cost = sad_sweep_argmin(low.to(torch.int16).contiguous(),
                                 prev_pad, mvcost, 8, R)
    idx = idx.to(torch.int32)
    mvx = idx % n - R
    mvy = torch.div(idx, n, rounding_mode="floor") - R
    return (icost.to(torch.int32), cost.to(torch.int32),
            torch.stack([mvx, mvy], dim=-1).to(torch.int32))


class Lookahead:
    """Per-frame complexity costs in display order."""

    def __init__(self, width: int, height: int, bit_depth: int = 8,
                 device=None):
        # pad lowres to multiples of 8
        self.lw = (width // 2 + 7) // 8 * 8
        self.lh = (height // 2 + 7) // 8 * 8
        self.bd = bit_depth
        self.device = resolve_device(device)
        self.last_low = None
        self.last_blocks = None

    def _src_dev(self, y):
        """The shared device upload of the source plane (one per frame
        across lookahead, analysis, motion search and residual)."""
        from x265_tpu_torch.utils import devcache
        yw = np.asarray(y)
        if yw.dtype not in (np.uint8, np.int16, np.uint16):
            yw = yw.astype(np.int16)
        return devcache.src_plane(yw, self.bd, self.device)

    def frame_costs(self, y: np.ndarray, is_intra: bool):
        """(cost, intra_cost, inter_cost) of one display-order frame; the
        inter cost is vs the previous frame (the slicetype/scenecut
        signal, slicetype.cpp:2186). Per-block arrays are kept in
        self.last_blocks for cuTree propagation; the lowres planes stay
        on the device."""
        ydev = self._src_dev(y)
        first = self.last_low is None
        prev = self.last_low
        if first:
            low0 = lowres_downscale(ydev)
            lh0, lw0 = low0.shape
            prev = pad_dev(low0, (0, self.lh - lh0, 0, self.lw - lw0))
        low_dev, icost, mcost, mv = _downscale_and_costs(
            ydev, prev, self.lh, self.lw)
        icost = icost.cpu().numpy()
        mcost2 = mcost.cpu().numpy() * 2
        self.last_blocks = {"icost": icost, "mcost": mcost2,
                            "mv": mv.cpu().numpy()}
        self.last_low = low_dev
        icost_sum = float(icost.sum())
        pcost_sum = float(np.minimum(icost, mcost2).sum())
        if first or is_intra:
            cost = icost_sum
        else:
            cost = pcost_sum
        return (max(1.0, cost), max(1.0, icost_sum),
                icost_sum if first else max(1.0, pcost_sum))


def cutree_propagate(records, ctb_log2: int, qcompress: float = 0.6,
                     max_off: int = 4) -> np.ndarray:
    """cuTree (x265 analog: Lookahead::cuTree/estimateCUPropagate +
    the propagateCost primitive, slicetype.cpp:2479).

    records: per-frame dicts {icost, mcost, mv} in DISPLAY order; each
    frame's lowres inter costs/MVs reference the PREVIOUS frame. Costs of
    well-predicted blocks are propagated backward to the blocks they
    reference; the first frame (the upcoming anchor's reference chain
    root) receives the accumulated propagation and yields per-CTB QP
    offsets: -strength * log2(1 + propagate/intra).
    """
    if not records:
        return None
    shape = records[0]["icost"].shape
    propagate = np.zeros(shape, dtype=np.float64)
    for rec in reversed(records[1:]):
        icost = rec["icost"].astype(np.float64) + 1.0
        mcost = np.minimum(rec["mcost"], rec["icost"]).astype(np.float64)
        fraction = np.clip(1.0 - mcost / icost, 0.0, 1.0)
        amount = (icost + propagate) * fraction
        # splat to the referenced block (integer lowres-block MV splat;
        # x265 does bilinear over 4 neighbors — 8x8 blocks, MV in pels)
        nby, nbx = shape
        by, bx = np.mgrid[0:nby, 0:nbx]
        ty = np.clip(by + np.round(rec["mv"][..., 1] / 8.0).astype(int),
                     0, nby - 1)
        tx = np.clip(bx + np.round(rec["mv"][..., 0] / 8.0).astype(int),
                     0, nbx - 1)
        nxt = np.zeros(shape, dtype=np.float64)
        np.add.at(nxt, (ty.ravel(), tx.ravel()), amount.ravel())
        propagate = nxt
    root = records[0]
    icost = root["icost"].astype(np.float64) + 1.0
    strength = 5.0 * (1.0 - qcompress)
    off = -strength * np.log2(1.0 + propagate / icost)
    # lowres 8x8 blocks -> CTB grid (ctb/2 lowres pels per CTB)
    blocks_per_ctb = max(1, (1 << ctb_log2) // 16)
    nby, nbx = shape
    cy = -(-nby // blocks_per_ctb)
    cx = -(-nbx // blocks_per_ctb)
    pad_y = cy * blocks_per_ctb - nby
    pad_x = cx * blocks_per_ctb - nbx
    offp = np.pad(off, ((0, pad_y), (0, pad_x)), mode="edge")
    ctb_off = offp.reshape(cy, blocks_per_ctb, cx,
                           blocks_per_ctb).mean(axis=(1, 3))
    # FLOAT offsets: the encoder sums AQ + cuTree + ROI as doubles and
    # rounds once (x265 qpCuTreeOffset stays double, slicetype.cpp:712)
    return np.clip(ctb_off, -float(max_off), 0.0)
