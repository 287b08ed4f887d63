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
so the costs and mvs equal the JAX package's exactly.

The B-frame slice-type search (slicetype_split) costs pairs of lowres
planes with the same two kernels at a wider window (R=8), then runs its
dynamic program on the host in float64 over the block maps, summed with
the reference's own numpy calls, so its sums are exact.
"""
from __future__ import annotations

from collections import OrderedDict

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

    def frame_cost(self, y: np.ndarray, is_intra: bool) -> float:
        """SATD-domain complexity of one frame (x265 m_currentSatd)."""
        return self.frame_costs(y, is_intra)[0]

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


def _batched_pair_fn(cur, ref):
    """One (cur, ref) lowres pair -> its per-block min(icost, 2*mcost)
    int32 map (slicetype.cpp estimateFrameCost). The JAX package vmaps
    this over a padded batch of pairs; here it is one pair a call (one
    SATD and one SAD-sweep launch)."""
    # wider window than the per-frame sweep: anchors sit up to bframes
    # frames away, so accumulated motion exceeds R=4
    ic, mc, _ = _lowres_costs(cur, ref, R=8)
    return torch.minimum(ic, mc * 2).to(torch.int32)


# pair-cost memo across slicetype_split calls: the b-adapt window SLIDES
# one mini-GOP at a time, so ~3/4 of each window's (cur, ref) pairs were
# already costed last call. Keyed by plane identity with the planes
# pinned (a recycled id cannot alias a dead frame).
_PAIR_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_BCOST_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_PAIR_CACHE_MAX = 512


def _as_low(a, device):
    """A lowres plane as a device tensor (the encoder's already are)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def batched_pair_costs(pairs, device=None):
    """pairs: list of (cur_low, ref_low) planes of one shape (device
    tensors or numpy). Returns the per-pair min(icost, 2*mcost) block maps
    as host int32 arrays. Only pairs not in the sliding-window memo are
    costed."""
    if not pairs:
        return []
    device = resolve_device(device)
    out = [None] * len(pairs)
    for i, (cur, ref) in enumerate(pairs):
        key = (id(cur), id(ref))
        ent = _PAIR_CACHE.get(key)
        if ent is not None and ent[0] is cur and ent[1] is ref:
            _PAIR_CACHE.move_to_end(key)
            out[i] = ent[2]
            continue
        blk = _batched_pair_fn(_as_low(cur, device),
                               _as_low(ref, device)).cpu().numpy()
        out[i] = blk
        _PAIR_CACHE[key] = (cur, ref, blk)
    while len(_PAIR_CACHE) > _PAIR_CACHE_MAX:
        _PAIR_CACHE.popitem(last=False)
    return out


def slicetype_split(anchor_low, queue_lows, max_bs=4,
                    b_discount=0.9, device=None):
    """Windowed slice-type decision (x264/x265 b-adapt 2 slicetypePath
    analog, slicetype.cpp): dynamic program over anchor placements in the
    lookahead window. Every path covers the same frames, so raw lowres
    SATD sums compare directly; B frames get a small discount for the
    bi-average prediction gain the single-ref lowres sweep cannot see.
    Returns the queue index of the FIRST anchor on the best path (the
    window re-optimises as it slides, like the reference). The block maps
    come to the host and are summed there in float64 with the
    reference's numpy calls, so every sum is the reference's exactly."""
    n = len(queue_lows)
    if n <= 1:
        return 0
    lows = [anchor_low] + list(queue_lows)   # lows[i+1] == queue[i]
    maxlen = max_bs + 1                      # frames per mini-GOP
    pairs = []
    idx = {}

    def want(cur, ref):
        key = (cur, ref)
        if key not in idx:
            idx[key] = len(pairs)
            pairs.append((lows[cur], lows[ref]))

    for a in range(0, n):                    # a = previous anchor position
        for m in range(a + 1, min(a + maxlen, n) + 1):
            want(m, a)                       # fwd: frame m from anchor a
    for j in range(2, n + 1):                # j = next anchor position
        for m in range(max(1, j - max_bs), j):
            want(m, j)                       # bwd: frame m from anchor j
    costs = batched_pair_costs(pairs, device)

    def blk(cur, ref):
        return costs[idx[(cur, ref)]]

    sums = {}

    def psum(cur, ref):
        key = (cur, ref)
        if key not in sums:
            sums[key] = float(blk(cur, ref).sum())
        return sums[key]

    def bcost(m, a, j):
        """Per-block B estimate: best of fwd, bwd and the bi average
        (averaging two decent predictions beats either — the
        0.72 factor is the noise-variance gain of the mean)."""
        f = blk(m, a)
        b = blk(m, j)
        key = (id(f), id(b))
        ent = _BCOST_CACHE.get(key)
        if ent is not None and ent[0] is f and ent[1] is b:
            _BCOST_CACHE.move_to_end(key)
            return ent[2]
        ff = f.astype(np.float64)
        bb = b.astype(np.float64)
        v = float(np.minimum(np.minimum(ff, bb), 0.36 * (ff + bb)).sum())
        _BCOST_CACHE[key] = (f, b, v)
        while len(_BCOST_CACHE) > _PAIR_CACHE_MAX:
            _BCOST_CACHE.popitem(last=False)
        return v

    INF = float("inf")
    dp = [INF] * (n + 1)
    dp[0] = 0.0
    prev = [0] * (n + 1)
    for j in range(1, n + 1):
        for a in range(max(0, j - maxlen), j):
            if dp[a] == INF:
                continue
            total = dp[a] + psum(j, a)               # the anchor's P cost
            for m in range(a + 1, j):                # its B frames
                total += b_discount * bcost(m, a, j)
            if total < dp[j]:
                dp[j] = total
                prev[j] = a
    j = n
    while prev[j] != 0:
        j = prev[j]
    return j - 1
