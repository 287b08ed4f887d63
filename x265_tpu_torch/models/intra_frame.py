"""Batched whole-frame intra mode analysis — the device compute graph.

This is the re-imagining of x265's Analysis::compressIntraCU +
Search::estIntraPredQT serial RDO loop as dense tensor computation:
prediction neighbors are taken from the source, so EVERY block's mode
search is independent — the whole frame becomes two contractions:

    preds[nB, 35, S²] = einsum('mpr,br->bmp', W, refs)      (prediction bank)
    satd  = |H8 · resid · H8ᵀ|                              (cost transform)

followed by an argmin over the mode axis. No wavefront needed. The serial
CABAC finalizer re-derives normative integer predictions, so these
decisions only steer RD — any outcome is a legal bitstream.

All of it is fp32 (TF32 off package-wide). A different summation order
than another backend's can flip an argmin between two modes of near
equal cost; that changes bits, never conformance.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from x265_tpu_torch.ops.intra_matrix import intra_weight_matrices
from x265_tpu_torch.utils.device import resolve_device


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


@lru_cache(maxsize=8)
def _hadamard_dev(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_hadamard(n).astype(np.float32)).to(device)


def first_argmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """argmin that returns the FIRST minimal index on ties, on every
    device (numpy/jnp semantics, spelled out instead of relied upon)."""
    n = x.shape[dim]
    m = x.amin(dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = n
    ar = torch.arange(n, device=x.device).reshape(shape)
    return torch.where(x == m, ar, n).amin(dim=dim)


def extract_block_refs(y: torch.Tensor, S: int,
                       halo: bool = False) -> torch.Tensor:
    """Reference vectors [nB, 4S+1] for every SxS block of a padded frame.

    Edge-replication stands in for the spec's unavailable-sample
    substitution (decision-only approximation; the finalizer is exact).
    Layout matches ops.ref.intra: left bottom-up, corner, top.
    With halo, y is a band of a frame that carries the row above its
    blocks and the S rows below them (all a block reads there:
    parallel/tiles.mesh_intra_decisions); only its columns are padded.
    """
    from x265_tpu_torch.engine.planes import pad_dev
    H, W = y.shape
    if halo:
        H -= 1 + S
        yp = pad_dev(y, (0, 0, 1, 2 * S))
    else:
        yp = pad_dev(y, (1, 2 * S, 1, 2 * S))
    nby, nbx = H // S, W // S
    dev = y.device
    by = torch.arange(nby, device=dev) * S
    bx = torch.arange(nbx, device=dev) * S

    # top rows: yp[by, bx+1 : bx+1+2S]  (row above each block, 2S wide)
    offs = torch.arange(2 * S, device=dev)
    top = yp[by[:, None, None], (bx[None, :, None] + 1 + offs[None, None, :])]
    # left cols: yp[by+1 : by+1+2S, bx]
    left = yp[(by[:, None, None] + 1 + offs[None, None, :]), bx[None, :, None]]
    corner = yp[by[:, None], bx[None, :]]

    left_rev = left.flip(2)                        # bottom-up
    refs = torch.cat([left_rev, corner[:, :, None], top], dim=-1)
    return refs.reshape(nby * nbx, 4 * S + 1)


# --fast-intra (x265 param.bEnableFastIntra): coarse angular scan —
# planar/DC + every 4th angle (intrapred "allangs" subset idea)
_FAST_MODES = np.array([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 34], np.int32)


@lru_cache(maxsize=8)
def _weights_dev(S: int, fast: bool, device: str) -> torch.Tensor:
    Wm = np.asarray(intra_weight_matrices(S), np.float32)   # [35, S², R]
    if fast:
        Wm = Wm[_FAST_MODES]
    return torch.from_numpy(np.ascontiguousarray(Wm)).to(device)


@lru_cache(maxsize=8)
def _fast_modes_dev(device: str) -> torch.Tensor:
    return torch.from_numpy(_FAST_MODES).to(device)


def frame_intra_analysis(y: torch.Tensor, S: int = 16,
                         lambda_bits: float = 2.0,
                         fast: bool = False,
                         psy: float = 0.0, halo: bool = False):
    """y: [H, W] (multiples of S) integer/float tensor -> (best mode per
    block [nB] int32, its cost [nB] float32). With halo, y is
    [1 + H + S, W]: the band's blocks with the rows extract_block_refs
    reads above and below them, and the blocks' results are those of the
    whole frame.

    psy > 0 adds the psychovisual energy term to every candidate: the
    AC-energy difference |E(source) - E(prediction)| weighted by psy-rd
    (x265 applies calcPsyRdCost in every intra mode comparison,
    rdcost.h:48 / search.cpp:2112)."""
    H, W = y.shape
    dev = y.device
    yf = y.to(torch.float32)
    refs = extract_block_refs(yf, S, halo)                   # [nB, R]
    if halo:
        H -= 1 + S
        yf = yf[1:1 + H]
    Wm = _weights_dev(S, bool(fast), str(dev))               # [nm, S², R]
    nm = Wm.shape[0]
    nB = refs.shape[0]

    # prediction bank: one big contraction
    preds = torch.matmul(refs, Wm.reshape(nm * S * S, -1).t())
    preds = preds.reshape(nB, nm, S * S)

    # source blocks [nB, S²]
    nby, nbx = H // S, W // S
    blocks = (yf.reshape(nby, S, nbx, S).permute(0, 2, 1, 3)
              .reshape(-1, S * S))

    resid = preds - blocks[:, None, :]                       # [nB, nm, S²]
    # SATD over 8x8 tiles via Hadamard matmuls
    k = 8 if S >= 8 else 4
    h = _hadamard_dev(k, str(dev))

    def had(x, lead):
        r = x.reshape((-1,) + lead + (S // k, k, S // k, k))
        r = r.transpose(-3, -2)                              # [..., k, k]
        return torch.matmul(torch.matmul(h, r), h)

    t = had(resid, (nm,))
    norm = 4.0 if k == 8 else 2.0
    satd = t.abs().sum(dim=(-1, -2, -3, -4)) / norm

    # rough mode-bit bias: non-MPM modes cost ~4 extra bins
    bias = torch.full((nm,), 4.0 * lambda_bits, dtype=torch.float32,
                      device=dev)
    bias[0] = 0.0
    bias[1] = 2.0 * lambda_bits
    cost = satd + bias[None, :]
    if psy > 0:
        def ac_energy(x, lead):
            tt = had(x, lead)
            dc = tt[..., 0, 0].abs().sum(dim=(-1, -2))
            return (tt.abs().sum(dim=(-1, -2, -3, -4)) - dc) / norm
        e_src = ac_energy(blocks, ())                        # [nB]
        e_pred = ac_energy(preds, (nm,))                     # [nB, nm]
        cost = cost + psy * (e_src[:, None] - e_pred).abs()
    best = first_argmin(cost, 1)
    if fast:
        best = _fast_modes_dev(str(dev))[best]
    return best.to(torch.int32), cost.amin(dim=1)


def _batched_analysis(S: int, fast: bool = False, psy: float = 0.0):
    """The analysis of a stack of frames [K, H, W] -> (modes [K, nB],
    costs [K, nB]). The JAX package vmaps one compiled graph over the
    frames; eager PyTorch has no compile to share, so this is one
    frame_intra_analysis per frame."""
    def run(ys):
        outs = [frame_intra_analysis(y, S=S, fast=fast, psy=psy) for y in ys]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    return run


def submit_intra_analysis_batch(srcs, width: int, height: int,
                                cu_log2: int = 4, fast: bool = False,
                                psy: float = 0.0, device=None):
    """The analysis of a whole batch of frames (a chunk of the all-intra
    path, the leaf B pictures of a mini-GOP); returns one
    submit_intra_analysis handle per frame. Everything is enqueued and
    nothing waits for the device: the batch's luma planes cross the bus
    in one copy from page-locked memory (a copy from pageable memory would
    first wait for the work already queued), and every constant the
    analysis needs is cached on the device."""
    from x265_tpu_torch.engine.planes import pad_dev
    device = resolve_device(device)
    S = 1 << cu_log2
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    wire = np.uint8 if max(int(np.asarray(s_).max(initial=0))
                           for s_ in srcs) < 256 else np.int16
    host = torch.from_numpy(np.stack([np.asarray(s_, dtype=wire)
                                      for s_ in srcs]))
    if device.type == "cuda":
        host = host.pin_memory()
    planes = host.to(device, non_blocking=True).to(torch.int16)
    ys = [pad_dev(y, (0, ph - height, 0, pw - width)) for y in planes]
    modes_dev, cost_dev = _batched_analysis(S, fast, float(psy))(ys)
    return [(modes_dev[i], cost_dev[i], cu_log2, width, height)
            for i in range(len(srcs))]


def submit_intra_analysis(src_y: np.ndarray, width: int, height: int,
                          cu_log2: int = 4, fast: bool = False,
                          psy: float = 0.0, device=None):
    """Enqueue the batched analysis; returns an opaque handle whose device
    tensors complete asynchronously (frame-pipeline building block: the
    device computes while the CPU finalizer writes another frame)."""
    from x265_tpu_torch.engine.planes import pad_dev
    from x265_tpu_torch.utils import devcache
    device = resolve_device(device)
    S = 1 << cu_log2
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    # shared upload: the source plane is consumed by the motion search
    # and the residual pipeline too — the identity-keyed device cache
    # uploads it ONCE per frame, and the S-padding happens on device
    arr = np.asarray(src_y)
    bd = 8 if arr.dtype == np.uint8 else 10
    ydev = devcache.src_plane(arr, bd, device)
    yp = pad_dev(ydev, (0, ph - height, 0, pw - width))
    modes_dev, cost_dev = frame_intra_analysis(yp, S=S, fast=fast,
                                               psy=float(psy))
    return (modes_dev, cost_dev, cu_log2, width, height)


def finish_intra_analysis(handle) -> "FrameDecisions":
    """Materialize a submit_intra_analysis result into decision maps."""
    modes_dev, _cost, cu_log2, width, height = handle
    S = 1 << cu_log2
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    modes = modes_dev.cpu().numpy()
    return _build_decisions(modes, cu_log2, width, height, ph, pw)


def decide_intra_frame_tpu(src_y: np.ndarray, width: int, height: int,
                           cu_log2: int = 4,
                           fast: bool = False,
                           psy: float = 0.0, device=None) -> "FrameDecisions":
    """Drop-in replacement for engine.mode_decision.decide_intra_frame:
    batched device analysis at S=2^cu_log2 with 8x8 boundary fallback.
    (The name is the JAX package's, kept so the counterpart is found.)"""
    return finish_intra_analysis(
        submit_intra_analysis(src_y, width, height, cu_log2, fast, psy,
                              device))


def decide_intra_frame_tpu_with_cost(src_y: np.ndarray, width: int,
                                     height: int, cu_log2: int = 4,
                                     fast: bool = False, psy: float = 0.0,
                                     device=None):
    """Like decide_intra_frame_tpu but also returns the per-block intra
    cost grid [ph/S, pw/S] — one pass serves both the mode decisions
    and the inter/intra comparator (the analysis already computed it)."""
    h = submit_intra_analysis(src_y, width, height, cu_log2, fast,
                              psy, device)
    dec = finish_intra_analysis(h)
    S = 1 << cu_log2
    ph = -(-height // S) * S
    pw = -(-width // S) * S
    icost = h[1].cpu().numpy().reshape(ph // S, pw // S)
    return dec, icost


def _build_decisions(modes, cu_log2, width, height, ph, pw):
    from x265_tpu_torch.engine.ctu_writer import FrameDecisions

    S = 1 << cu_log2
    nby, nbx = ph // S, pw // S
    h8, w8 = height >> 3, width >> 3
    rep = S >> 3
    luma_mode8 = np.repeat(np.repeat(modes.reshape(nby, nbx), rep, axis=0),
                           rep, axis=1)[:h8, :w8].astype(np.int32)
    # boundary: fall back to 8x8 CUs where an S-block crosses the pic edge
    cu_log2_map = np.full((h8, w8), cu_log2, dtype=np.int32)
    bx8 = np.arange(w8)
    by8 = np.arange(h8)
    x0 = (bx8 >> (cu_log2 - 3)) << cu_log2
    y0 = (by8 >> (cu_log2 - 3)) << cu_log2
    cross = (y0[:, None] + S > height) | (x0[None, :] + S > width)
    cu_log2_map[cross] = 3
    return FrameDecisions(cu_log2_map=cu_log2_map, luma_mode8=luma_mode8)
