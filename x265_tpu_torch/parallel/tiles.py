"""Tile-parallel frame analysis over a device mesh — the counterpart of
x265_tpu/parallel/tiles.py, the re-imagining of x265's intra-frame
parallelism:

  WPP rows / slices  -> CTU-row bands, one a tile of the mesh's `tile`
                        axis; analysis is neighbour-free batched math.
  frame threads      -> reference-row halos: each band's motion search
                        needs R rows of the reference band above and
                        below, copied from the neighbouring tiles (the
                        JAX package's ppermute; the m_reconRowFlag wait,
                        frameencoder.cpp:860).
  rate-control state -> the bands' costs summed to one frame cost (psum;
                        the rateControlStart input).

JAX runs one program on every tile (shard_map, GSPMD); here a Python
loop runs each band's work on its tile's device. A band on the device
that holds its neighbour reads the halo rows as a view: nothing is
copied on a mesh that names one card several times.
"""
from __future__ import annotations

import numpy as np
import torch

from x265_tpu_torch.engine.planes import pad_dev
from x265_tpu_torch.models.intra_frame import (_build_decisions,
                                               frame_intra_analysis)
from x265_tpu_torch.ops.cuda_kernels import sad_sweep_argmin
from x265_tpu_torch.parallel import mesh as _mesh
from x265_tpu_torch.parallel.mesh import Mesh
from x265_tpu_torch.utils import devcache


def make_tile_mesh(n_devices: int, devices=None) -> Mesh:
    """A `tile` mesh of n_devices tiles: the first n CUDA devices
    (mesh.make_tile_mesh, which raises with fewer), or the devices given.
    devices may name one device several times (e.g.
    [torch.device("cuda")] * 4: four tiles on one card, or ["cpu"] * 4),
    the counterpart of XLA's virtual host devices."""
    if devices is None:
        return _mesh.make_tile_mesh(n_devices)
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for {n_devices} tiles")
    return Mesh(list(devices), ("tile",))


def _halos(ref_bands, R):
    """(above, below) per band: the R reference rows of the neighbouring
    bands on the band's own device (the JAX package's two ppermutes). At
    the frame's top and bottom the ring's wrap is replaced by the band's
    edge row repeated (extendPicBorder semantics)."""
    n = len(ref_bands)
    above, below = [], []
    for i, band in enumerate(ref_bands):
        W = band.shape[1]
        above.append(band[:1].expand(R, W) if i == 0
                     else ref_bands[i - 1][-R:].to(band.device))
        below.append(band[-1:].expand(R, W) if i == n - 1
                     else ref_bands[i + 1][:R].to(band.device))
    return above, below


def _band_step(y_band, ref_band, above, below, S, R):
    """One band's work: the band-local intra analysis and the dense
    min-SAD of its blocks against the reference band extended by the
    halo rows and edge-padded by R columns.

    As in the reference, the intra analysis sees the band alone: the
    blocks next to a band edge read edge-replicated rows where the
    whole-frame analysis reads the neighbour's (their modes and costs
    may differ from frame_intra_analysis of the frame).

    The min-SAD is kernel 5's fused sweep (ops.cuda_kernels
    .sad_sweep_argmin) with a zero mv cost: its cost is float32(min SAD),
    exact for S*S*maxv < 2^24; the argmin's index is not used.
    Returns (modes [nB], icost [nB], mcost [nby, nbx] int32, band cost)."""
    H, W = y_band.shape
    nby, nbx = H // S, W // S
    modes, icost = frame_intra_analysis(y_band, S=S)
    ref_ext = torch.cat([above, ref_band, below])           # [H+2R, W]
    ref_pad = pad_dev(ref_ext, (0, 0, R, R))
    n = 2 * R + 1
    zero_cost = torch.zeros((n * n,), dtype=torch.float32,
                            device=y_band.device)
    _, best = sad_sweep_argmin(y_band, ref_pad, zero_cost, S, R)
    mcost = best.to(torch.int32)
    band_cost = torch.minimum(icost.reshape(nby, nbx),
                              mcost.to(torch.float32) * 2).sum()
    return modes, icost, mcost, band_cost


def _as_samples(a, name):
    """int16 samples of a host plane, refused outside 12 bits (the SAD
    kernel's float32 cost is exact only below 2^24 a block)."""
    a = np.asarray(a)
    if a.size and (a.min() < 0 or a.max() > 4095):
        raise ValueError(f"{name}: samples outside [0, 4095]")
    return np.ascontiguousarray(a, dtype=np.int16)


def sharded_frame_analysis(mesh: Mesh, y: np.ndarray, ref: np.ndarray,
                           S: int = 16, R: int = 8):
    """Analyze one frame with CTU-row bands over the mesh's tiles.

    y, ref: [H, W] integer samples with H a multiple of S * n_tiles.
    Returns (modes [nB], icost [nB], mcost [nby, nbx] int32, frame_cost
    scalar), tensors on the mesh's first device."""
    devs = list(mesh.devices.flat)
    n_tiles = len(devs)
    H, W = np.shape(y)
    assert H % (S * n_tiles) == 0, (H, S, n_tiles)
    Hb = H // n_tiles
    y = _as_samples(y, "y")
    ref = _as_samples(ref, "ref")
    y_bands = [torch.from_numpy(y[i * Hb:(i + 1) * Hb]).to(d)
               for i, d in enumerate(devs)]
    ref_bands = [torch.from_numpy(ref[i * Hb:(i + 1) * Hb]).to(d)
                 for i, d in enumerate(devs)]
    above, below = _halos(ref_bands, R)
    outs = [_band_step(y_bands[i], ref_bands[i], above[i], below[i], S, R)
            for i in range(n_tiles)]
    home = devs[0]
    modes, icost, mcost = (torch.cat([o[k].to(home) for o in outs])
                           for k in range(3))
    # the psum: every band's cost on the first tile, summed in band order
    frame_cost = torch.stack([o[3].to(home) for o in outs]).sum()
    return modes, icost, mcost, frame_cost


def mesh_intra_decisions(mesh: Mesh, y: np.ndarray, width: int, height: int,
                         cu_log2: int = 4, fast: bool = False,
                         psy: float = 0.0):
    """Whole-frame intra analysis with the frame in CTU-row bands over
    the mesh's tiles: the decisions of the single-device analysis
    (models.intra_frame.decide_intra_frame_tpu_with_cost), exactly. In
    the JAX package GSPMD partitions the single-device graph and supplies
    the rows a band reads across its edges; here each band carries them
    itself: a halo of the row above and the S rows below its blocks
    (what extract_block_refs reads), edge-replicated only at the frame's
    top and bottom.

    Returns (FrameDecisions, icost grid [ceil(height/S), pw/S]) like
    decide_intra_frame_tpu_with_cost."""
    S = 1 << cu_log2
    devs = list(mesh.devices.flat)
    home = devs[0]
    n = len(devs)
    ph = -(-height // (S * n)) * (S * n)   # band-divisible padding
    pw = -(-width // S) * S
    # the source plane's shared upload (the motion search reads it too),
    # edge-padded on the first tile's device
    arr = np.asarray(y)
    src = devcache.src_plane(arr, 8 if arr.dtype == np.uint8 else 10, home)
    yp = pad_dev(src, (0, ph - height, 0, pw - width))
    Hb = ph // n
    modes, cost = [], []
    for i, d in enumerate(devs):
        rows = torch.arange(i * Hb - 1, (i + 1) * Hb + S,
                            device=yp.device).clamp_(0, ph - 1)
        m, c = frame_intra_analysis(yp[rows].to(d), S=S, fast=fast,
                                    psy=float(psy), halo=True)
        modes.append(m.to(home))
        cost.append(c.to(home))
    modes = torch.cat(modes).cpu().numpy()
    dec = _build_decisions(modes, cu_log2, width, height, ph, pw)
    # crop to the single-device grid (band padding may add rows)
    ph1 = -(-height // S) * S
    icost = torch.cat(cost).cpu().numpy().reshape(ph // S, pw // S)
    return dec, icost[:ph1 // S]
