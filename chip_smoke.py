#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc and g++; nothing else (no network, no JAX).
Builds every kernel from the sources in this checkout, holds each against
its plain PyTorch version on the card (exact equality: they are integer
kernels), also at the lookahead's shapes, encodes small clips, decodes
them back and compares the records of the golden cases (the stream's
digest, QP maps, picture types and QPs, ...) with the committed ones,
then drives the main paths through Encoder.encode — at
1920x1080 the low-latency I/P encode (ultrafast + zerolatency), the
filtered one (fast + zerolatency: deblock, SAO, AQ, weightp, 3 refs), the
live one (medium + zerolatency under CRF 23 and a 6000 kbps VBV buffer:
the lookahead, scenecut, cuTree and rd 3, on a clip with a scene cut),
x265's default, bench.py's config 3 (medium without a tune at 4000 kbps
ABR, 25 fps: B frames placed by b-adapt 2, the B-pyramid, bi-prediction)
and x265's slow preset under the same rate control (RDOQ, rd 4, the
explicit inter RQT, the dense star search over four references); at
1280x720 bench.py's config 1 (all-intra lossless, the pipelined path),
decoded back to the source itself; at 3840x2160 BASELINE config 4
(Main10 under the slow preset with the default scaling lists and the
HDR10 and HDR10+ metadata); then the encodes steered from outside at
1080p: bench.py config 3 in two passes, config 3 saved and loaded again
through --analysis-save/--analysis-load with the --scale-factor 2 chain
beside it, and an ABR ladder of three renditions scaled on the card;
then the stream-structure options: small encodes with WPP, slices,
transform skip, noise reduction, frame-dup with the histogram scene cut
and intra refresh (decoded by the port's decoder and by libde265 where
the system has it), the assertion mode (X265TPU_CHECKIFY=1) on the card,
and at 1080p the live encode with the robustness options and config 3 in
four slices with transform skip and noise reduction; then the JAX
package's reference switches (the numpy intra analysis, the Python
oracle writer with its NxN CUs, the native walk quantizing every TB: small
encodes at 416x240, and config 3 at 1080p without the device residual,
which must give encode_1080p_medium's stream), the standalone motion
API (engine/me.motion_decide at merange 16 and 57 with its bundle
functions) and the batched intra prediction at 1080p, and BASELINE
config 5: an ABR ladder from 3840x2160 to 2160p/1080p/720p in one
process and across two processes sharing the card (the same streams);
then parallel/: the band step at 1088x1920 over four tiles of the card
(kernel 5 a band, the halos, the summed frame cost) and config 3 without
the device residual under a mesh of four tiles, which must give
encode_1080p_medium's stream —
and checks that each went through every kernel of its path. Every kernel is held on 8-bit and on 10-bit samples. One JSON line per phase; any failure ends the
run with a non-zero exit code and no result line.
"""
import contextlib
import ctypes
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

from x265_tpu_torch.api.encoder import Encoder
from x265_tpu_torch.api import ladder
from x265_tpu_torch.api import params as api_params
from x265_tpu_torch.api.params import param_default_preset, param_parse
from x265_tpu_torch.decoder.decoder import HEVCDecoder
from x265_tpu_torch.engine import lookahead, me
from x265_tpu_torch.models import inter_residual, intra_frame, loopfilter, rdo
from x265_tpu_torch.ops import cuda_build, cuda_kernels, cuda_mc
from x265_tpu_torch.hevc.bitstream import NAL_TRAIL_R, split_annexb
from x265_tpu_torch.hevc.rate_model import rdoq_rate_consts
from x265_tpu_torch.hevc.sei import (SEI_CONTENT_LIGHT_LEVEL,
                                     SEI_MASTERING_DISPLAY)
from x265_tpu_torch.io.scaler import scale_frame
from x265_tpu_torch.utils import devcache, profiling, testclip
from x265_tpu_torch.utils.convert import interp_filters
from x265_tpu_torch.utils.testclip import (clip_crowd1080, clip_pan,
                                            lift10, make_clip, make_cut_clip,
                                            make_ramp_clip)
from x265_tpu_torch import native

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
INT_OPS_PER_S = 67e12          # non-tensor-core 32-bit rate, same sheet
W, H = 1920, 1080
W4K, H4K = 3840, 2160
FAR = [1 << 20, -(1 << 20), -1, 5]    # origins far outside a plane


T0 = time.time()


def emit(phase, **kw):
    """One JSON line a phase; "at_s" is the seconds since the script
    started (where the run's time went)."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": round(time.time() - T0, 1)}), flush=True)


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


_spin_cycles_per_ms = None


def hold_device(ms=2.0):
    """Keep the device spinning for about `ms`, so that what the host
    queues next starts back to back when the spin ends: a wrapper call
    costs the host tens of microseconds, more than some kernels run. The
    spin counts clock cycles; how many make a millisecond on this card at
    this moment is measured once, from a spin of ten million."""
    global _spin_cycles_per_ms
    if _spin_cycles_per_ms is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)              # clocks up
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        torch.cuda.synchronize()
        _spin_cycles_per_ms = 10_000_000 / a.elapsed_time(b)
    torch.cuda._sleep(int(ms * _spin_cycles_per_ms))


def time_ms(fn, reps=20):
    """Device time of one call: CUDA events around `reps` calls that the
    host queued while the device was held, inputs hot in L2."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    hold_device()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_cold_ms(fn, reps=10):
    """Device time of one call that finds L2 cold: before every call a
    256 MB write replaces what the 50 MB L2 holds (and keeps the device
    busy while the host queues the call). The median of `reps` calls."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    times = []
    for _ in range(reps + 2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[2:]))


def calibration_phase():
    """The yardsticks of csrc/calib.cu, measured on this card in this run:
    the time of an empty kernel with mc_gather_interp's grid at its timed
    shape (1,005 blocks of 256 threads, 20,608 bytes of shared memory),
    and the rate at which the card executes vabsdiff4 with accumulate (four
    byte differences an instruction: the SAD kernels' byte path) and the
    scalar __sad (their int16 path), as absolute differences a second."""
    lib = cuda_build.get_lib()
    stream = torch.cuda.current_stream().cuda_stream
    grid = (1005, 256, 20608)

    def empty(*g):
        cuda_build.check_launch(lib.x265_calib_empty_grid(*g, stream),
                                "calib_empty_grid")
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 256, 256
    out = torch.empty(blocks * threads, dtype=torch.int32, device=DEV)
    chains = ctypes.c_int(0)

    def run_chains(kind):
        cuda_build.check_launch(lib.x265_calib_sad_rate(
            out.data_ptr(), kind, blocks, threads, iters,
            ctypes.byref(chains), stream), "calib_sad_rate")
    rate = {}
    for kind in (4, 1):
        ms = time_ms(lambda: run_chains(kind), 3)
        rate[kind] = blocks * threads * iters * chains.value * kind / (
            ms * 1e-3)
    cal = {"empty_grid": list(grid),
           "empty_grid_ms": time_ms(lambda: empty(*grid)),
           "empty_one_block_ms": time_ms(lambda: empty(1, 32, 0)),
           "sad4_differences_per_s": rate[4],
           "sad_differences_per_s": rate[1]}
    emit("calibration", **cal)
    return cal


def slice_params(w, h):
    p = param_default_preset("ultrafast", "zerolatency")
    for k, v in (("qp", "30"), ("scenecut", "0"), ("ref", "1")):
        param_parse(p, k, v)
    p.width, p.height = w, h
    return p


def filtered_params(w, h):
    """fast + zerolatency as it is: ctu 64, ref 3, rd 2, subme 2, hex,
    deblock, sao, aq-mode 2, weightp."""
    p = param_default_preset("fast", "zerolatency")
    for k, v in (("qp", "30"), ("scenecut", "0")):
        param_parse(p, k, v)
    p.width, p.height = w, h
    return p


def live_params(w, h):
    """medium + zerolatency as a live streamer runs it: CRF 23 under a
    6000 kbps / 6000 kbit VBV buffer, with the defaults kept: scenecut 40,
    cu_tree, rd 3, ref 3, subme 2, hex, deblock, sao, aq-mode 2, weightp."""
    p = param_default_preset("medium", "zerolatency")
    for k, v in (("crf", "23"), ("vbv-maxrate", "6000"),
                 ("vbv-bufsize", "6000")):
        param_parse(p, k, v)
    p.width, p.height = w, h
    return p


def medium_params(w, h):
    """bench.py config 3 (its primary metric): x265's default preset,
    medium, with no tune, ABR at 4000 kbps, 25 fps: bframes 4, b-adapt 2,
    b-pyramid, rc-lookahead 20, frame-threads 2, ref 3, rd 3, subme 2,
    hex, deblock, sao, aq-mode 2, cu-tree, weightp."""
    p = param_default_preset("medium")
    param_parse(p, "bitrate", "4000")
    p.width, p.height = w, h
    p.fps_num, p.fps_den = 25, 1
    return p


def steered_params(opts, kbps=4000):
    """bench.py config 3 (medium_params) at kbps with more options
    through param_parse: a function of (w, h), as main_path takes it."""
    def build(w, h):
        p = medium_params(w, h)
        p.bitrate = kbps
        for k, v in opts.items():
            param_parse(p, k, v)
        return p
    return build


# the --scale-factor 2 chain runs where the JAX package's chain is sound
# (ROADMAP Queue 3): 32x32 CTUs (a saved 32x32 intra CU would become a
# 64x64 intra CU), no AQ and no cuTree (the saved per-CTB QP map is of
# the half-size grid), fixed mini-GOPs (each picture loads the decisions
# of the picture of the same type)
SF2_OPTS = {"ctu": "32", "aq-mode": "0", "cutree": "0", "b-adapt": "0",
            "scenecut": "0"}


def slow_params(w, h):
    """x265's slow preset under bench.py config 3's rate control (ABR at
    4000 kbps, 25 fps): rdoq-level 2 (psy-RDOQ), rd 4, tu-inter-depth 2,
    me star (the dense integer search, merange 57), subme 3, ref 4,
    bframes 4, b-adapt 2, rc-lookahead 25, deblock, sao, aq-mode 2,
    cu-tree, weightp."""
    p = param_default_preset("slow")
    param_parse(p, "bitrate", "4000")
    p.width, p.height = w, h
    p.fps_num, p.fps_den = 25, 1
    return p


def main10_params(w, h, dhdr10_path):
    """BASELINE config 4: x265's slow preset at output-depth 10 (Main10)
    with the default scaling lists, --hdr10 (BT.2020, PQ), --hdr10-opt
    (AQ's luma-banded bias), the mastering display and content light
    level of tests/test_hdr10.py, HDR10+ metadata from a file with
    --dhdr10-opt, 25 fps; rate control at the preset's default (CRF 28)."""
    p = param_default_preset("slow")
    for k, v in (("output-depth", "10"), ("scaling-list", "default"),
                 ("hdr10", "1"), ("hdr10-opt", "1"),
                 ("master-display", testclip.MASTER_DISPLAY),
                 ("max-cll", "1000,400"), ("dhdr10-info", dhdr10_path),
                 ("dhdr10-opt", "1")):
        param_parse(p, k, v)
    p.width, p.height = w, h
    p.fps_num, p.fps_den = 25, 1
    return p


def live_robust_params(w, h):
    """live_params with the live streamer's robustness options: WPP
    substreams, the intra-refresh column sweep, the luma-histogram scene
    cut and dropped duplicates (--frame-dup)."""
    p = live_params(w, h)
    for k in ("wpp", "intra-refresh", "hist-scenecut", "frame-dup"):
        param_parse(p, k, "1")
    return p


def medium_slices_params(w, h):
    """bench.py config 3 (medium_params) as a broadcaster slices it: four
    slices a picture, transform skip for graphics, and DCT-domain noise
    reduction of inter blocks at 400 for a noisy camera."""
    p = medium_params(w, h)
    for k, v in (("slices", "4"), ("tskip", "1"), ("nr-inter", "400")):
        param_parse(p, k, v)
    return p


def lossless_params(w, h):
    """bench.py config 1 exactly: ultrafast, lossless, keyint 1 (every
    picture an IDR through the all-intra pipelined path)."""
    p = param_default_preset("ultrafast")
    param_parse(p, "lossless")
    param_parse(p, "keyint", "1")
    p.width, p.height = w, h
    return p


@contextlib.contextmanager
def plain_versions():
    """Rebind, for the duration, the names through which the engine
    reaches the kernels' wrappers to the plain versions, so a whole
    encode on the card can be held against the kernels' encode. The
    package itself has no such switch."""
    saved = (inter_residual.tile_gather, inter_residual.mc_gather_interp,
             me.tile_gather_planes, me.tile_gather_planes_satd,
             me._satd_kernel, me.sad_sweep_argmin, me.sad_local_argmin,
             lookahead.sad_sweep_argmin, lookahead.satd_intra,
             loopfilter.deblock_bs, rdo.rd_tb_cost)
    # models/rdo.py and models/intra_rdo.py reach kernels 1 and 2 through
    # inter_residual and the TB cost chain through rdo; engine/lookahead.py
    # reaches kernel 4's intra entry and kernel 5 itself; me._bi_satd
    # reaches kernels 3 and 4 through me; models/loopfilter.py reaches the
    # boundary strengths' kernel
    inter_residual.tile_gather = cuda_mc.tile_gather_plain
    inter_residual.mc_gather_interp = cuda_mc.mc_gather_interp_plain
    me.tile_gather_planes = cuda_mc.tile_gather_planes_plain
    me.tile_gather_planes_satd = cuda_mc.tile_gather_planes_satd_plain
    me._satd_kernel = cuda_kernels.satd_plain
    me.sad_sweep_argmin = cuda_kernels.sad_sweep_argmin_plain
    me.sad_local_argmin = cuda_kernels.sad_local_argmin_plain
    lookahead.sad_sweep_argmin = cuda_kernels.sad_sweep_argmin_plain
    lookahead.satd_intra = cuda_kernels.satd_intra_plain
    loopfilter.deblock_bs = cuda_kernels.deblock_bs_plain
    rdo.rd_tb_cost = cuda_kernels.rd_tb_cost_plain
    try:
        yield
    finally:
        (inter_residual.tile_gather, inter_residual.mc_gather_interp,
         me.tile_gather_planes, me.tile_gather_planes_satd,
         me._satd_kernel, me.sad_sweep_argmin,
         me.sad_local_argmin, lookahead.sad_sweep_argmin,
         lookahead.satd_intra, loopfilter.deblock_bs,
         rdo.rd_tb_cost) = saved


def to_dev(a):
    """A numpy integer array as a contiguous int32 tensor on the card."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(DEV)


def rnd_i32(rng, lo, hi, n):
    return to_dev(rng.integers(lo, hi, n))


# ------------------------------------------------------------- kernel cases

def gather_bytes(plane_elems, N, side, out_elems, n_index_arrays):
    """Least traffic: the windows' int16s (or the whole plane when the
    windows cover more than it), the per-lane indices, the int32 output."""
    return (min(plane_elems, N * side * side) * 2
            + n_index_arrays * N * 4 + out_elems * 4)


def intra_blocks(rng, n, maxv):
    """n DC-removed 8x8 lowres blocks as the lookahead hands them to
    satd_intra: int16 in [-maxv, maxv], the first three at the extremes
    (all +maxv, all -maxv, a +-maxv checkerboard)."""
    a = rng.integers(-maxv, maxv + 1, (n, 8, 8)).astype(np.int16)
    yy, xx = np.mgrid[0:8, 0:8]
    for i, blk in enumerate((np.full((8, 8), maxv), np.full((8, 8), -maxv),
                             np.where((yy + xx) % 2, maxv, -maxv))[:n]):
        a[i] = blk
    return torch.from_numpy(a).to(DEV)


def sweep_planes(rng, P, h, w, R, maxv):
    """P current planes [P, h, w] int16, each its reference [P, h+2R,
    w+2R] moved by (1, -2) plus noise: interior minima, near-ties."""
    ref = torch.from_numpy(rng.integers(
        0, maxv + 1, (P, h + 2 * R, w + 2 * R)).astype(np.int16)).to(DEV)
    noise = torch.from_numpy(
        rng.integers(-2, 3, (P, h, w)).astype(np.int16)).to(DEV)
    cur = (ref[:, R + 1:R + 1 + h, R - 2:R - 2 + w] + noise).clamp_(
        0, maxv).contiguous()
    return cur, ref


def check_equal(name, got, want):
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: shape/dtype {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if err != 0:
        fail(f"{name}: kernel differs from plain version, max abs {err}")
    return err


def edge_planes(rng, P, hp, wp, maxv, shift):
    """[P, hp, wp] int16 planes whose first element lies `shift` int16s
    past a 16-byte boundary (a view into a larger buffer)."""
    buf = torch.from_numpy(rng.integers(
        0, maxv + 1, P * hp * wp + 8).astype(np.int16)).to(DEV)
    return buf[shift:shift + P * hp * wp].view(P, hp, wp)


def edge_lanes(rng, L, P, hp, wp, n):
    """Lane arrays with the corners, origins far outside the planes, odd
    and even x, and plane indices -1 and P among random lanes."""
    ridx = rnd_i32(rng, 0, P, L)
    oy = rnd_i32(rng, 0, hp - n + 1, L)
    ox = rnd_i32(rng, 0, wp - n + 1, L)
    ys = [0, hp - n, 0, hp - n] + FAR + [1, 2]
    xs = [0, wp - n, wp - n, 0] + FAR[::-1] + [1, 2]
    m = min(L, len(ys))
    oy[:m] = torch.tensor(ys[:m], device=DEV)
    ox[:m] = torch.tensor(xs[:m], device=DEV)
    if L >= 12:
        ridx[10:12] = torch.tensor([-1, P], device=DEV)
    elif L == 1:
        ridx[0] = -1
    return ridx, oy, ox


def gather_edge_cases(rng):
    """tile_gather, tile_gather_planes and tile_gather_planes_satd against
    their plain versions (exact) over every tile size the kernels treat
    differently, odd and even plane pitch, a planes pointer off the
    16-byte grid, and lane counts of 1, 1003 and a multiple of any group."""
    P, hp = 3, 200
    pl = edge_planes(rng, P, hp, 334, 255, 0)
    ridx, oy, ox = edge_lanes(rng, 37, P, hp, 334, 100)
    for call in (lambda: cuda_mc.tile_gather(pl[1], oy, ox, 100),
                 lambda: cuda_mc.tile_gather_planes(pl, ridx, oy, ox, 100)):
        try:
            call()
        except ValueError:
            continue
        fail("a 100x100 tile (too large to stage) was not refused")
    for wp, shift in ((334, 0), (333, 3)):
        pl = edge_planes(rng, P, hp, wp, 255, shift)
        for n in (4, 7, 8, 16, 23, 30, 32, 64, 78):
            for N in ((37,) if n == 78 else (1, 1003, 1024)):
                ridx, oy, ox = edge_lanes(rng, N, P, hp, wp, n)
                what = f"edge n={n} N={N} pitch={wp}"
                check_equal("tile_gather " + what,
                            cuda_mc.tile_gather(pl[1], oy, ox, n),
                            cuda_mc.tile_gather_plain(pl[1], oy, ox, n))
                check_equal(
                    "tile_gather_planes " + what,
                    cuda_mc.tile_gather_planes(pl, ridx, oy, ox, n),
                    cuda_mc.tile_gather_planes_plain(pl, ridx, oy, ox, n))
        for maxv in (255, 1023):                    # 8-bit and 10-bit samples
            pl = edge_planes(rng, P, hp, wp, maxv, shift)
            for S in (8, 16, 32):
                for K in (1, 9):
                    for N in (1, 1003, 64):
                        ridx, oy, ox = edge_lanes(rng, K * N, P, hp, wp, S)
                        cur = rnd_i32(rng, 0, maxv + 1,
                                      N * S * S).reshape(N, S, S)
                        a = (pl, ridx, oy, ox, cur, S)
                        check_equal(
                            f"tile_gather_planes_satd edge S={S} K={K} "
                            f"N={N} pitch={wp} max={maxv}",
                            cuda_mc.tile_gather_planes_satd(*a),
                            cuda_mc.tile_gather_planes_satd_plain(*a))
                # a block scored against its own window: SATD 0
                ridx, oy, ox = edge_lanes(rng, 1003, P, hp, wp, S)
                cur = cuda_mc.tile_gather_planes_plain(pl, ridx, oy, ox, S)
                got = cuda_mc.tile_gather_planes_satd(pl, ridx, oy, ox,
                                                      cur, S)
                torch.cuda.synchronize()
                if int(got.abs().max()) != 0:
                    fail(f"tile_gather_planes_satd S={S}: cur == window "
                         "must give 0")


def coherent_lanes(rng, R):
    """Lanes as the encoder makes them at 1080p: the 16x16 blocks in raster
    order around a smooth motion field. For tile_gather the 30x30 search
    patches at the integer vectors (plane padded by R); for the subpel
    round the 9 half-pel candidates of every block (phase planes padded by
    R + 2). The timed rows use random origins; these show what the order
    of the lanes is worth."""
    Nb = 68 * 120
    by, bx = np.divmod(np.arange(Nb), 120)
    mv = (rng.integers(-3, 4, (Nb, 2)) + np.array([9, -6])).astype(np.int64)
    patch = (to_dev(by * 16 + (mv[:, 1] >> 2) + R - 7),
             to_dev(bx * 16 + (mv[:, 0] >> 2) + R - 7))
    cand = mv[None] * 4 + me._HALF_OFFS.astype(np.int64)[:, None]  # [9,Nb,2]
    subpel = (to_dev(((cand[..., 1] & 3) * 4 + (cand[..., 0] & 3)).ravel()),
              to_dev(((cand[..., 1] >> 2) + by * 16 + R + 2).ravel()),
              to_dev(((cand[..., 0] >> 2) + bx * 16 + R + 2).ravel()))
    return patch, subpel


def adopt_lanes(rng, nby=68, nbx=120):
    """The merge adoption's configurations at 1080p (models/rdo.py
    _adopt_costs; 135 x 240 blocks at 2160p): every 16x16 block of the
    frame under its own motion and reference, then under each of four
    frame-dominant tuples; lanes are configuration-major, blocks in raster
    order. Returns (x, y, mv [L,2] quarter-pel, ref) as numpy arrays."""
    by, bx = np.divmod(np.arange(nby * nbx), nbx)
    own = rng.integers(-6, 7, (nby * nbx, 2)) + np.array([37, -22])
    tuples = ([37, -22, 0], [36, -20, 0], [0, 0, 1], [40, -24, 2])
    mv = np.concatenate([own] + [np.tile(t[:2], (nby * nbx, 1))
                                 for t in tuples])
    ref = np.concatenate([rng.integers(0, 3, nby * nbx)]
                         + [np.full(nby * nbx, t[2]) for t in tuples])
    k = 1 + len(tuples)
    return np.tile(bx * 16, k), np.tile(by * 16, k), mv, ref


def promo_lanes(rng, n):
    """The n x n promotion's one-CU lanes at 1080p: every n-aligned group
    fully inside the picture at a group-wide motion."""
    gy, gx = np.divmod(np.arange((H // n) * (W // n)), W // n)
    mv = rng.integers(-6, 7, (len(gy), 2)) + np.array([37, -22])
    return gx * n, gy * n, mv, rng.integers(0, 3, len(gy))


def mc_lanes(x, y, mv, ref, pad, chroma):
    """mc_gather_interp's lane arrays for blocks at luma (x, y), as
    models/inter_residual._mc_gather forms them (chroma at half geometry,
    the same vector in eighth-pel units)."""
    taps, fb = (4, 3) if chroma else (8, 2)
    if chroma:
        x, y, pad = x >> 1, y >> 1, pad >> 1
    mask = (1 << fb) - 1
    return (to_dev(ref), to_dev(pad + y + (mv[:, 1] >> fb) - taps // 2 + 1),
            to_dev(pad + x + (mv[:, 0] >> fb) - taps // 2 + 1),
            to_dev(mv[:, 0] & mask), to_dev(mv[:, 1] & mask))


def check_local(name, args):
    """sad_local_argmin against its plain version: index and cost exact."""
    gd, gc = cuda_kernels.sad_local_argmin(*args)
    wd, wc = cuda_kernels.sad_local_argmin_plain(*args)
    err = check_equal(f"sad_local_argmin idx {name}", gd, wd)
    if not torch.equal(gc, wc):
        fail(f"sad_local_argmin cost {name}: kernel differs from plain")
    return gd, err


def local_args(rng, ref, y0s, x0s, centers, S, W_r, lam=2.8284, maxv=255,
               flat=False):
    """Arguments of the window search: every current block is the patch's
    content at displacement (W_r + 1, W_r - 2) plus noise (flat: the
    constant 99), so minima are interior and near-ties are common."""
    hp, wp = ref.shape
    side = S + 2 * W_r
    N = y0s.shape[0]
    if flat:
        cur = torch.full((N, S, S), 99, dtype=torch.int32, device=DEV)
    else:
        cy = y0s.clamp(0, hp - side) + min(W_r + 1, 2 * W_r)
        cx = x0s.clamp(0, wp - side) + max(W_r - 2, 0)
        noise = rnd_i32(rng, -2, 3, N * S * S).reshape(N, S, S)
        cur = (cuda_mc.tile_gather_plain(ref, cy, cx, S) + noise).clamp_(
            0, maxv).contiguous()
    return (cur, ref, y0s, x0s, centers,
            torch.tensor(lam, dtype=torch.float32, device=DEV), S, W_r)


def local_edge_cases(rng):
    """The window entry on every S and a smaller window, one block and a
    ragged count, origins far outside (clipped), odd and even pitch, a
    crop of a larger plane, flat content with and without an mv cost,
    8-bit samples at 255 and 10-bit samples at 1023."""
    for S, W_r, N, maxv, hp, wp in (
            (8, 7, 1003, 255, 200, 333), (16, 7, 1003, 255, 200, 334),
            (32, 7, 77, 255, 200, 333), (64, 7, 37, 255, 200, 334),
            (16, 3, 1003, 255, 120, 131), (8, 0, 64, 255, 64, 70),
            (16, 7, 1, 255, 64, 64), (16, 7, 1003, 1023, 200, 333),
            (32, 2, 77, 1023, 200, 334)):
        side = S + 2 * W_r
        ref = edge_planes(rng, 1, hp, wp, maxv, wp & 3)[0]
        ref[:side, :side] = maxv                   # samples at the maximum
        y0s = rnd_i32(rng, 0, hp - side + 1, N)
        x0s = rnd_i32(rng, 0, wp - side + 1, N)
        m = min(N, 10)
        y0s[:m] = torch.tensor(([0, hp - side, 0, hp - side] + FAR
                                + [1, 2])[:m], device=DEV)
        x0s[:m] = torch.tensor(([0, wp - side, wp - side, 0] + FAR[::-1]
                                + [1, 2])[:m], device=DEV)
        centers = rnd_i32(rng, -50, 51, 2 * N).reshape(N, 2)
        what = f"edge S={S} W_r={W_r} N={N} max={maxv}"
        check_local(what, local_args(rng, ref, y0s, x0s, centers, S, W_r,
                                     maxv=maxv))
        check_local(what + " flat", local_args(rng, ref.fill_(99), y0s, x0s,
                                               centers, S, W_r, flat=True))
        gd, _ = check_local(what + " flat lam=0", local_args(
            rng, ref, y0s, x0s, centers, S, W_r, lam=0.0, flat=True))
        if int(gd.abs().max()) != 0:
            fail(f"sad_local_argmin {what}: first displacement must win")
    # a crop of a larger plane, as the encoder's reference is; what lies
    # around the crop is above 255 and must not be read as a sample
    big = edge_planes(rng, 1, 160, 212, 255, 1)[0]
    ref = big[6:-6, 6:-6]
    keep = ref.clone()
    big.fill_(1023)
    ref.copy_(keep)
    N, S, W_r = 513, 16, 7
    y0s = rnd_i32(rng, 0, ref.shape[0] - 29, N)
    x0s = rnd_i32(rng, 0, ref.shape[1] - 29, N)
    y0s[:4] = torch.tensor([0, ref.shape[0] - 30, 0, 1 << 20], device=DEV)
    x0s[:4] = torch.tensor([0, ref.shape[1] - 30, 1 << 20, 0], device=DEV)
    centers = rnd_i32(rng, -50, 51, 2 * N).reshape(N, 2)
    check_local("crop", local_args(rng, ref, y0s, x0s, centers, S, W_r))


def local_main_case(rng):
    """Main-path shape: the 8,160 16x16 blocks of a 1080p frame, +-7
    around centres clamped to +-(R - 7), R = 57. The reference is what
    the encoder passes: a crop, 6 samples in on every side, of a plane
    padded by R + 6 (row pitch 2,046, the crop's first sample off the
    16-byte grid)."""
    S, W_r, R = 16, 7, 57
    nby, nbx = 68, 120
    N = nby * nbx
    Hr, Wr = nby * S + 2 * R, nbx * S + 2 * R
    by, bx = np.divmod(np.arange(N), nbx)
    lim = R - W_r

    def cropped_plane(maxv):
        big = torch.from_numpy(rng.integers(
            0, maxv + 1, (Hr + 12, Wr + 12)).astype(np.int16)).to(DEV)
        return big[6:-6, 6:-6]

    def args_for(ref, mv, maxv=255):
        mv = np.clip(mv, -lim, lim)
        return local_args(rng, ref, to_dev(by * S + mv[:, 1] + R - W_r),
                          to_dev(bx * S + mv[:, 0] + R - W_r), to_dev(mv),
                          S, W_r, maxv=maxv)
    ref = cropped_plane(255)
    rnd = rng.integers(-lim, lim + 1, (N, 2))
    rnd[:4] = [[-lim, -lim], [lim, lim], [-lim, lim], [lim, -lim]]
    a = args_for(ref, rnd)
    c = args_for(ref, rng.integers(-3, 4, (N, 2)) + np.array([9, -6]))
    w = args_for(cropped_plane(1023), rnd, maxv=1023)   # the int16 path
    _, err = check_local("main path, random centres", a)
    check_local("main path, coherent centres", c)
    _, err10 = check_local("main path, 10-bit samples", w)
    # me._local_search on the card is this one launch and nothing else
    cuda_mc.reset_launches()
    mv, _ = me._local_search(a[0], ref, a[4], to_dev(np.stack([bx, by], 1)),
                             a[5], S, W_r, R)
    wd, _ = cuda_kernels.sad_local_argmin_plain(*a)
    n = 2 * W_r + 1
    check_equal("me._local_search", mv - a[4], torch.stack(
        [wd % n - W_r, torch.div(wd, n, rounding_mode="floor") - W_r], -1))
    if cuda_mc.launches != {**{k: 0 for k in cuda_mc.launches},
                            "sad_local_argmin": 1}:
        fail("me._local_search launched other than the window entry, once: "
             f"{cuda_mc.launches}")
    side = S + 2 * W_r
    return dict(
        shape=(f"cur[{N},16,16] i32 ref_pad[{Hr},{Wr}] i16 (a crop, "
               f"pitch {Wr + 12}) W_r=7"),
        max_abs_err=err, max_abs_err_10bit=err10,
        ms=time_ms(lambda: cuda_kernels.sad_local_argmin(*a)),
        cold_l2_ms=time_cold_ms(lambda: cuda_kernels.sad_local_argmin(*a)),
        coherent_ms=time_ms(lambda: cuda_kernels.sad_local_argmin(*c)),
        wide_ms=time_ms(lambda: cuda_kernels.sad_local_argmin(*w)),
        diffs=n * n * N * S * S,
        plain_ms=time_ms(
            lambda: cuda_kernels.sad_local_argmin_plain(*a), 3),
        # least traffic: the plane (smaller than the windows), the current
        # blocks, origins and centres, two values out a block
        bytes=(min(Hr * Wr, N * side * side) * 2 + N * S * S * 4
               + 4 * N * 4 + N * 8),
        ops=3 * n * n * N * S * S + 2 * n * n * N, library_ms=None)


def rd_blocks(rng, N, S, bd, spread, qp):
    """rd_tb_cost's (src, pred, qp) on the card: predictions over the whole
    sample range, sources within +-spread of them, one QP (or a vector)."""
    maxv = (1 << bd) - 1
    pred = rnd_i32(rng, 0, maxv + 1, N * S * S).reshape(N, S, S)
    src = (pred + rnd_i32(rng, -spread, spread + 1, N * S * S)
           .reshape(N, S, S)).clamp_(0, maxv)
    qv = (torch.full((N,), qp, dtype=torch.int32, device=DEV)
          if isinstance(qp, int) else qp)
    return src, pred, qv


def rd_rate_row(is_intra, qp):
    return to_dev(np.array(rdoq_rate_consts(0 if is_intra else 2, qp)[0]))


def check_rd(name, args):
    """rd_tb_cost against its plain version: all four outputs exact."""
    got = cuda_kernels.rd_tb_cost(*args)
    want = cuda_kernels.rd_tb_cost_plain(*args)
    return max(check_equal(f"{name} {k}", g, w)
               for k, g, w in zip(("sse", "rate", "psy", "cbf"), got, want))


def rd_cost_edge_cases(rng):
    """Ragged batches (1003 TBs) of every size, flag set and bit depth,
    whose first TBs are an all-zero residual and residuals at +-(2^bd - 1)
    at QP 0 (levels at 32767 at 32x32 and 10 bits), the rest at random
    QPs and amplitudes."""
    for S in (8, 16, 32):
        for bd in (8, 10):
            maxv = (1 << bd) - 1
            qp = rnd_i32(rng, 0, 52 + 6 * (bd - 8), 1003)
            src, pred, _ = rd_blocks(rng, 1003, S, bd, maxv, 0)
            src[0] = pred[0]
            src[1], pred[1] = maxv, 0
            src[2], pred[2] = 0, maxv
            qp[1:3] = 0
            for flags in ((False, True, False, False, True),
                          (True, True, True, True, True),
                          (False, False, True, True, False),
                          (True, False, False, False, False)):
                is_intra, sdh, do_rdoq, scaling, want_psy = flags
                check_rd(f"rd_tb_cost edge S={S} bd={bd} flags={flags}",
                         (src, pred, qp, rd_rate_row(is_intra, 30),
                          is_intra, bd, sdh, do_rdoq, scaling, want_psy))


def rd_cost_main_case(rng):
    """rd_tb_cost at the RD passes' 1080p shapes (medium's flags: SBH and
    psy on the luma, no RDOQ) and slow's and config 4's: the main row is
    rd_promote32's one-CU luma TBs, one a 32-aligned group of the
    picture. Bound: the larger of the bytes (src and pred in, 4 int64
    out) and two operations a multiply-add of the four transform passes
    and the psy Hadamards at the data sheet's scalar rate."""
    def shape(N, S, bd, rdoq, scaling, psy, spread=24, qp=32):
        src, pred, qv = rd_blocks(rng, N, S, bd, spread, qp)
        args = (src, pred, qv, rd_rate_row(False, qp), False, bd, True,
                rdoq, scaling, psy)
        macs = N * (4 * S * S * S + (2 * 2 * 8 * S * S if psy else 0))
        row = dict(
            shape=f"src,pred[{N},{S},{S}] int32 {bd}-bit, qp {qp}, sdh"
                  + ", rdoq" * rdoq + ", scaling lists" * scaling
                  + ", psy" * psy,
            max_abs_err=check_rd(f"rd_tb_cost [{N},{S},{S}]", args),
            ms=time_ms(lambda: cuda_kernels.rd_tb_cost(*args)),
            plain_ms=time_ms(lambda: cuda_kernels.rd_tb_cost_plain(*args),
                             1),
            bytes=N * (2 * S * S * 4 + 4 + 32), ops=2 * macs,
            library_ms=None)
        if bd == 8:
            a10 = rd_blocks(rng, N, S, 10, 4 * spread, qp)
            row["max_abs_err_10bit"] = check_rd(
                f"rd_tb_cost [{N},{S},{S}] 10-bit", a10 + args[3:5] + (10,)
                + args[6:])
        return row
    groups = (W // 32) * (H // 32)               # rd_promote32's groups
    blocks = (W // 16) * ((H + 15) // 16)        # rd_adopt16's blocks
    blocks4k = (W4K // 16) * (H4K // 16)
    row = shape(groups, 32, 8, False, False, True)
    # rd_promote at n=64: each group's four 32x32 quads in one batch
    row["rd_promote64"] = shape(4 * (W // 64) * (H // 64), 32, 8, False,
                                False, True)
    # rd_adopt16: the blocks under their own motion and four candidates
    row["rd_adopt_luma"] = shape(5 * blocks, 16, 8, False, False, True)
    row["rd_adopt_chroma"] = shape(5 * blocks, 8, 8, False, False, False)
    # slow: the same promotion with RDOQ
    row["rd_promote32_rdoq"] = shape(groups, 32, 8, True, False, True)
    # config 4 at 2160p: Main10, default scaling lists, RDOQ
    row["rd_adopt_luma_2160p_main10"] = shape(5 * blocks4k, 16, 10, True,
                                              True, True, spread=96)
    row["rd_adopt_chroma_2160p_main10"] = shape(5 * blocks4k, 8, 10, True,
                                                True, False, spread=96)
    return row


def kernel_phase():
    rng = np.random.default_rng(7)
    rows = {}
    luma, chroma = interp_filters(DEV)

    # --- mc_gather_interp: padded 1080p reference planes -----------------
    Hp, Wp = H + 160, W + 160
    planes_y = torch.from_numpy(
        rng.integers(0, 256, (2, Hp, Wp)).astype(np.int16)).to(DEV)
    planes_c = planes_y[:, :H // 2 + 80, :W // 2 + 80].contiguous()
    for (n, taps) in ((8, 8), (16, 8), (32, 8), (64, 8), (4, 4), (8, 4),
                      (16, 4), (32, 4)):
        pl, filt = (planes_y, luma) if taps == 8 else (planes_c, chroma)
        R_, hp, wp = pl.shape
        side = n + taps - 1
        N = 1003                                   # not a multiple of 8
        ridx = rnd_i32(rng, 0, R_, N)
        oy = rnd_i32(rng, 0, hp - side + 1, N)
        ox = rnd_i32(rng, 0, wp - side + 1, N)
        oy[:4] = torch.tensor([0, hp - side, 0, hp - side], device=DEV)
        ox[:4] = torch.tensor([0, wp - side, wp - side, 0], device=DEV)
        oy[4:8] = torch.tensor(FAR, device=DEV)      # clipped, never read
        ox[4:8] = torch.tensor(FAR[::-1], device=DEV)
        ridx[8:10] = torch.tensor([-3, 99], device=DEV)
        nph = filt.shape[0]
        xf = (torch.arange(N, device=DEV, dtype=torch.int32) % nph)
        yf = (torch.arange(N, device=DEV, dtype=torch.int32) // nph) % nph
        a = (ridx, oy, ox, xf.contiguous(), yf.contiguous(), filt, n, taps, 8)
        check_equal(f"mc_gather_interp edge n={n} taps={taps}",
                    cuda_mc.mc_gather_interp(pl, *a),
                    cuda_mc.mc_gather_interp_plain(pl, *a))
    # main-path shape: every 16x16 luma CU of a 1080p P frame
    n, taps, side = 16, 8, 23
    N = (W // 16) * (H // 16)
    ridx = torch.zeros(N, dtype=torch.int32, device=DEV)
    oy = rnd_i32(rng, 0, Hp - side + 1, N)
    ox = rnd_i32(rng, 0, Wp - side + 1, N)
    xf = rnd_i32(rng, 0, 4, N)
    yf = rnd_i32(rng, 0, 4, N)
    a = (ridx, oy, ox, xf, yf, luma, n, taps, 8)
    nbytes = gather_bytes(Hp * Wp, N, side, N * n * n, 5) + luma.numel() * 4
    nops = N * 2 * taps * (side * n + n * n)
    err = check_equal("mc_gather_interp",
                      cuda_mc.mc_gather_interp(planes_y, *a),
                      cuda_mc.mc_gather_interp_plain(planes_y, *a))
    # every timed shape is held on 10-bit samples too (bd=10: the first
    # pass shifted by bd - 8)
    planes_y10 = torch.from_numpy(
        rng.integers(0, 1024, (2, Hp, Wp)).astype(np.int16)).to(DEV)
    a10 = a[:-1] + (10,)
    err10 = check_equal("mc_gather_interp, 10-bit samples",
                        cuda_mc.mc_gather_interp(planes_y10, *a10),
                        cuda_mc.mc_gather_interp_plain(planes_y10, *a10))
    del planes_y10
    # the same lanes as the encoder orders them: blocks in raster order
    # around a smooth quarter-pel field (plane padded by 80)
    by, bx = np.divmod(np.arange(N), W // 16)
    mvq = rng.integers(-6, 7, (N, 2)) + np.array([37, -22])
    ac = (ridx, to_dev(by * 16 + 80 + (mvq[:, 1] >> 2) - 3),
          to_dev(bx * 16 + 80 + (mvq[:, 0] >> 2) - 3), to_dev(mvq[:, 0] & 3),
          to_dev(mvq[:, 1] & 3), luma, n, taps, 8)
    check_equal("mc_gather_interp, coherent lanes",
                cuda_mc.mc_gather_interp(planes_y, *ac),
                cuda_mc.mc_gather_interp_plain(planes_y, *ac))
    rows["mc_gather_interp"] = dict(
        shape=f"planes[2,{Hp},{Wp}] N={N} n=16 taps=8", max_abs_err=err,
        max_abs_err_10bit=err10,
        ms=time_ms(lambda: cuda_mc.mc_gather_interp(planes_y, *a)),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_mc.mc_gather_interp(planes_y, *a)),
        coherent_ms=time_ms(
            lambda: cuda_mc.mc_gather_interp(planes_y, *ac)),
        plain_ms=time_ms(
            lambda: cuda_mc.mc_gather_interp_plain(planes_y, *a), 5),
        bytes=nbytes, ops=nops, library_ms=None)

    # the RD passes' shapes (models/rdo.py): the merge adoption predicts
    # every 16x16 block under five configurations from three reference
    # planes (luma n=16, chroma n=8); the 64x64 promotion one 64 CU per
    # group (luma n=64, chroma n=32) and four 32 CUs (luma n=32)
    refs_y = torch.from_numpy(
        rng.integers(0, 256, (3, Hp, Wp)).astype(np.int16)).to(DEV)
    refs_c = torch.from_numpy(rng.integers(
        0, 256, (3, H // 2 + 80, W // 2 + 80)).astype(np.int16)).to(DEV)
    refs10 = (torch.from_numpy(rng.integers(
        0, 1024, (3, Hp, Wp)).astype(np.int16)).to(DEV),
        torch.from_numpy(rng.integers(
            0, 1024, (3, H // 2 + 80, W // 2 + 80)).astype(np.int16)).to(DEV))
    ax, ay, amv, aref = adopt_lanes(rng)
    px, py, pmv, pref = promo_lanes(rng, 64)
    qq = np.arange(4)
    p4 = (np.repeat(px, 4) + np.tile(qq % 2, len(px)) * 32,
          np.repeat(py, 4) + np.tile(qq // 2, len(px)) * 32,
          np.repeat(pmv, 4, axis=0) + rng.integers(-2, 3, (4 * len(px), 2)),
          np.repeat(pref, 4))
    for key, lanes, n, is_c in (
            ("rd_adopt_luma", (ax, ay, amv, aref), 16, False),
            ("rd_adopt_chroma", (ax, ay, amv, aref), 16, True),
            ("rd_promote64", (px, py, pmv, pref), 64, False),
            (None, (px, py, pmv, pref), 64, True),
            (None, p4, 32, False)):
        pl, filt, taps = (refs_c, chroma, 4) if is_c else (refs_y, luma, 8)
        n_ = n // 2 if is_c else n
        a = (*mc_lanes(*lanes, 80, is_c), filt, n_, taps, 8)
        N_, side = len(lanes[0]), n_ + taps - 1
        err = check_equal(f"mc_gather_interp {key or 'rd_promote'} n={n_} "
                          f"taps={taps}", cuda_mc.mc_gather_interp(pl, *a),
                          cuda_mc.mc_gather_interp_plain(pl, *a))
        pl10, a10 = refs10[int(is_c)], a[:-1] + (10,)
        err10 = check_equal(f"mc_gather_interp {key or 'rd_promote'} "
                            f"n={n_} taps={taps}, 10-bit samples",
                            cuda_mc.mc_gather_interp(pl10, *a10),
                            cuda_mc.mc_gather_interp_plain(pl10, *a10))
        if key is None:
            continue
        rows["mc_gather_interp"][key] = dict(
            shape=f"planes[3,{pl.shape[1]},{pl.shape[2]}] N={N_} n={n_} "
                  f"taps={taps}", max_abs_err=err, max_abs_err_10bit=err10,
            ms=time_ms(lambda: cuda_mc.mc_gather_interp(pl, *a)),
            cold_l2_ms=time_cold_ms(lambda: cuda_mc.mc_gather_interp(pl, *a)),
            plain_ms=time_ms(lambda: cuda_mc.mc_gather_interp_plain(pl, *a),
                             5),
            bytes=(gather_bytes(pl.numel(), N_, side, N_ * n_ * n_, 5)
                   + filt.numel() * 4),
            ops=N_ * 2 * taps * (side * n_ + n_ * n_))
    # a B picture's residual (models/inter_residual.py): the list-1 stack
    # holds one reference; every 16x16 block of the frame reads it (the L1
    # and bi lanes of a B picture whose CUs all predict from both lists),
    # around the opposite motion of the list-0 side; chroma held too
    by, bx = np.divmod(np.arange(N), W // 16)
    bmv = rng.integers(-6, 7, (N, 2)) + np.array([-37, 22])
    for is_c in (False, True):
        pl, filt, taps = ((refs_c[2:3].contiguous(), chroma, 4) if is_c
                          else (refs_y[2:3].contiguous(), luma, 8))
        n_ = 8 if is_c else 16
        a = (*mc_lanes(bx * 16, by * 16, bmv, np.zeros(N, np.int64), 80,
                       is_c), filt, n_, taps, 8)
        side = n_ + taps - 1
        err = check_equal(f"mc_gather_interp bi_residual n={n_}",
                          cuda_mc.mc_gather_interp(pl, *a),
                          cuda_mc.mc_gather_interp_plain(pl, *a))
        if is_c:
            continue
        rows["mc_gather_interp"]["bi_residual"] = dict(
            shape=f"planes[1,{pl.shape[1]},{pl.shape[2]}] (list 1) N={N} "
                  f"n={n_} taps={taps}", max_abs_err=err,
            ms=time_ms(lambda: cuda_mc.mc_gather_interp(pl, *a)),
            cold_l2_ms=time_cold_ms(lambda: cuda_mc.mc_gather_interp(pl, *a)),
            plain_ms=time_ms(lambda: cuda_mc.mc_gather_interp_plain(pl, *a),
                             5),
            bytes=(gather_bytes(pl.numel(), N, side, N * n_ * n_, 5)
                   + filt.numel() * 4),
            ops=N * 2 * taps * (side * n_ + n_ * n_))
    del refs_y, refs_c, refs10
    # BASELINE config 4's merge adoption at 2160p on 10-bit planes: every
    # 16x16 luma block of the frame under five configurations (162,000
    # lanes) from three reference planes padded by 80, bd=10
    nby4, nbx4 = H4K // 16, W4K // 16
    refs4k = torch.from_numpy(rng.integers(
        0, 1024, (3, H4K + 160, W4K + 160)).astype(np.int16)).to(DEV)
    lanes4k = adopt_lanes(rng, nby4, nbx4)
    a = (*mc_lanes(*lanes4k, 80, False), luma, 16, 8, 10)
    N_, side = len(lanes4k[0]), 23
    err = check_equal("mc_gather_interp rd_adopt_luma_2160p_main10",
                      cuda_mc.mc_gather_interp(refs4k, *a),
                      cuda_mc.mc_gather_interp_plain(refs4k, *a))
    rows["mc_gather_interp"]["rd_adopt_luma_2160p_main10"] = dict(
        shape=f"planes[3,{H4K + 160},{W4K + 160}] 10-bit N={N_} n=16 "
              "taps=8 bd=10", max_abs_err=err,
        ms=time_ms(lambda: cuda_mc.mc_gather_interp(refs4k, *a)),
        cold_l2_ms=time_cold_ms(lambda: cuda_mc.mc_gather_interp(refs4k, *a)),
        plain_ms=time_ms(lambda: cuda_mc.mc_gather_interp_plain(refs4k, *a),
                         3),
        bytes=(gather_bytes(refs4k.numel(), N_, side, N_ * 256, 5)
               + luma.numel() * 4),
        ops=N_ * 2 * 8 * (side * 16 + 256))
    del refs4k, a

    # --- the two gathers and the fused gather + SATD: edge cases --------
    gather_edge_cases(rng)

    # --- tile_gather: 30x30 search patches, random and coherent ---------
    R = 57
    Hr, Wr = 1088 + 2 * R, W + 2 * R
    plane = torch.from_numpy(
        rng.integers(0, 256, (Hr, Wr)).astype(np.int16)).to(DEV)
    n, N = 30, 68 * 120
    oy = rnd_i32(rng, 0, Hr - n + 1, N)
    ox = rnd_i32(rng, 0, Wr - n + 1, N)
    check_equal("tile_gather n=30", cuda_mc.tile_gather(plane, oy, ox, n),
                cuda_mc.tile_gather_plain(plane, oy, ox, n))
    (coy, cox), co3 = coherent_lanes(rng, R)
    check_equal("tile_gather n=30, coherent lanes",
                cuda_mc.tile_gather(plane, coy, cox, n),
                cuda_mc.tile_gather_plain(plane, coy, cox, n))

    # --- tile_gather: the merge adoption's source tiles (the largest call
    # on the live path): every 16x16 luma / 8x8 chroma block of the source
    # picture once per configuration, clipped at the bottom edge
    for key, (hs, ws), n, sh in ((None, (H, W), 16, 0),
                                 ("rd_adopt_chroma", (H // 2, W // 2), 8, 1)):
        src = torch.from_numpy(
            rng.integers(0, 256, (hs, ws)).astype(np.int16)).to(DEV)
        oy, ox = to_dev(ay >> sh), to_dev(ax >> sh)
        N = len(ay)
        err = check_equal(f"tile_gather rd_adopt n={n}",
                          cuda_mc.tile_gather(src, oy, ox, n),
                          cuda_mc.tile_gather_plain(src, oy, ox, n))
        src10 = torch.from_numpy(
            rng.integers(0, 1024, (hs, ws)).astype(np.int16)).to(DEV)
        err10 = check_equal(f"tile_gather rd_adopt n={n}, 10-bit samples",
                            cuda_mc.tile_gather(src10, oy, ox, n),
                            cuda_mc.tile_gather_plain(src10, oy, ox, n))
        idx = cuda_mc._window_index(oy, ox, n, hs, ws)
        flat = src.reshape(-1)
        row = dict(
            shape=f"plane[{hs},{ws}] N={N} n={n}", max_abs_err=err,
            max_abs_err_10bit=err10,
            ms=time_ms(lambda: cuda_mc.tile_gather(src, oy, ox, n)),
            cold_l2_ms=time_cold_ms(
                lambda: cuda_mc.tile_gather(src, oy, ox, n)),
            plain_ms=time_ms(lambda: cuda_mc.tile_gather_plain(src, oy, ox, n)),
            bytes=gather_bytes(hs * ws, N, n, N * n * n, 2), ops=0,
            library_ms=time_ms(lambda: torch.take(flat, idx)))
        del idx
        if key is None:
            rows["tile_gather"] = row
        else:
            rows["tile_gather"][key] = row

    # --- tile_gather_planes: one subpel refine round (9 candidates) ------
    margin = R + 2
    Hm, Wm = 1088 + 2 * margin, W + 2 * margin
    pp = torch.from_numpy(
        rng.integers(0, 256, (16, Hm, Wm)).astype(np.int16)).to(DEV)
    n, Nb, K = 16, 68 * 120, 9
    N = K * Nb
    ridx = rnd_i32(rng, 0, 16, N)
    oy = rnd_i32(rng, 0, Hm - n + 1, N)
    ox = rnd_i32(rng, 0, Wm - n + 1, N)
    err = check_equal("tile_gather_planes",
                      cuda_mc.tile_gather_planes(pp, ridx, oy, ox, n),
                      cuda_mc.tile_gather_planes_plain(pp, ridx, oy, ox, n))
    pp10 = torch.from_numpy(
        rng.integers(0, 1024, (16, Hm, Wm)).astype(np.int16)).to(DEV)
    err10 = check_equal(
        "tile_gather_planes, 10-bit samples",
        cuda_mc.tile_gather_planes(pp10, ridx, oy, ox, n),
        cuda_mc.tile_gather_planes_plain(pp10, ridx, oy, ox, n))
    idx = (cuda_mc._window_index(oy, ox, n, Hm, Wm)
           + ridx.long()[:, None, None] * (Hm * Wm))
    flat = pp.reshape(-1)
    check_equal("tile_gather_planes, coherent lanes",
                cuda_mc.tile_gather_planes(pp, *co3, n),
                cuda_mc.tile_gather_planes_plain(pp, *co3, n))
    rows["tile_gather_planes"] = dict(
        shape=f"planes[16,{Hm},{Wm}] N={N} n=16", max_abs_err=err,
        max_abs_err_10bit=err10,
        ms=time_ms(lambda: cuda_mc.tile_gather_planes(pp, ridx, oy, ox, n)),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_mc.tile_gather_planes(pp, ridx, oy, ox, n)),
        coherent_ms=time_ms(
            lambda: cuda_mc.tile_gather_planes(pp, *co3, n)),
        plain_ms=time_ms(
            lambda: cuda_mc.tile_gather_planes_plain(pp, ridx, oy, ox, n)),
        bytes=gather_bytes(16 * Hm * Wm, N, n, N * n * n, 3), ops=0,
        library_ms=time_ms(lambda: torch.take(flat, idx)))
    del idx
    # me._bi_satd: one block per 16x16 of the frame at its refined vector
    # on one reference's phase planes (the entry runs twice a B picture,
    # once a list), lanes in raster order around a smooth field
    by, bx = np.divmod(np.arange(Nb), 120)
    mvb = rng.integers(-6, 7, (Nb, 2)) + np.array([37, -22])
    bi = (to_dev((mvb[:, 1] & 3) * 4 + (mvb[:, 0] & 3)),
          to_dev((mvb[:, 1] >> 2) + by * 16 + margin),
          to_dev((mvb[:, 0] >> 2) + bx * 16 + margin))
    err_b = check_equal("tile_gather_planes bi_satd",
                        cuda_mc.tile_gather_planes(pp, *bi, n),
                        cuda_mc.tile_gather_planes_plain(pp, *bi, n))
    idx = (cuda_mc._window_index(bi[1], bi[2], n, Hm, Wm)
           + bi[0].long()[:, None, None] * (Hm * Wm))
    rows["tile_gather_planes"]["bi_satd"] = dict(
        shape=f"planes[16,{Hm},{Wm}] N={Nb} n=16", max_abs_err=err_b,
        ms=time_ms(lambda: cuda_mc.tile_gather_planes(pp, *bi, n)),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_mc.tile_gather_planes(pp, *bi, n)),
        plain_ms=time_ms(
            lambda: cuda_mc.tile_gather_planes_plain(pp, *bi, n)),
        bytes=gather_bytes(16 * Hm * Wm, Nb, n, Nb * n * n, 3), ops=0,
        library_ms=time_ms(lambda: torch.take(flat, idx)))
    del idx

    # --- tile_gather_planes_satd: the same round, scored, nothing written
    cur_b = rnd_i32(rng, 0, 256, Nb * n * n).reshape(Nb, n, n)
    fa = (pp, ridx, oy, ox, cur_b, n)
    fc = (pp, *co3, cur_b, n)
    err = check_equal("tile_gather_planes_satd",
                      cuda_mc.tile_gather_planes_satd(*fa),
                      cuda_mc.tile_gather_planes_satd_plain(*fa))
    check_equal("tile_gather_planes_satd, coherent lanes",
                cuda_mc.tile_gather_planes_satd(*fc),
                cuda_mc.tile_gather_planes_satd_plain(*fc))
    f10 = (pp10, ridx, oy, ox,
           rnd_i32(rng, 0, 1024, Nb * n * n).reshape(Nb, n, n), n)
    err10 = check_equal("tile_gather_planes_satd, 10-bit samples",
                        cuda_mc.tile_gather_planes_satd(*f10),
                        cuda_mc.tile_gather_planes_satd_plain(*f10))
    del pp10, f10
    # least traffic: the windows, three index arrays, the current blocks
    # once, one int32 a lane; per 8x8 block the operations of the SATD row
    rows["tile_gather_planes_satd"] = dict(
        shape=f"planes[16,{Hm},{Wm}] cur[{Nb},16,16] i32 K={K} n=16",
        max_abs_err=err, max_abs_err_10bit=err10,
        ms=time_ms(lambda: cuda_mc.tile_gather_planes_satd(*fa)),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_mc.tile_gather_planes_satd(*fa)),
        coherent_ms=time_ms(lambda: cuda_mc.tile_gather_planes_satd(*fc)),
        plain_ms=time_ms(
            lambda: cuda_mc.tile_gather_planes_satd_plain(*fa), 5),
        bytes=(min(16 * Hm * Wm, N * n * n) * 2 + 3 * N * 4
               + Nb * n * n * 4 + N * 4),
        ops=N * 4 * (64 + 384 + 64), library_ms=None)

    # --- satd: the same round's SATD -------------------------------------
    # ragged counts too: the last warp of S=8 and S=16 part-filled, and
    # the one-CTA-a-block form at S=24, 32 and 64
    for S, N_ in ((8, 1003), (16, 1003), (32, 77), (8, 1), (8, 3),
                  (16, 3), (24, 5), (64, 3)):
        a_ = rnd_i32(rng, 0, 256, N_ * S * S).reshape(N_, S, S)
        b_ = rnd_i32(rng, 0, 256, N_ * S * S).reshape(N_, S, S)
        check_equal(f"satd edge S={S}", cuda_kernels.satd(a_, b_),
                    cuda_kernels.satd_plain(a_, b_))
    S = 16
    a_ = rnd_i32(rng, 0, 256, N * S * S).reshape(N, S, S)
    b_ = rnd_i32(rng, 0, 256, N * S * S).reshape(N, S, S)
    err = check_equal("satd8x8", cuda_kernels.satd(a_, b_),
                      cuda_kernels.satd_plain(a_, b_))
    a10 = rnd_i32(rng, 0, 1024, N * S * S).reshape(N, S, S)
    b10 = rnd_i32(rng, 0, 1024, N * S * S).reshape(N, S, S)
    err10 = check_equal("satd8x8, 10-bit samples",
                        cuda_kernels.satd(a10, b10),
                        cuda_kernels.satd_plain(a10, b10))
    del a10, b10
    # per 8x8 block: 64 subtractions, 2*8*24 butterfly adds, 64 abs-adds
    rows["satd8x8"] = dict(
        shape=f"a,b[{N},16,16] int32", max_abs_err=err,
        max_abs_err_10bit=err10,
        ms=time_ms(lambda: cuda_kernels.satd(a_, b_)),
        plain_ms=time_ms(lambda: cuda_kernels.satd_plain(a_, b_), 5),
        bytes=2 * N * S * S * 4 + N * 4, ops=N * 4 * (64 + 384 + 64),
        library_ms=None)
    # the lookahead's intra cost: the DC-removed 8x8 blocks of the 544x960
    # lowres plane against zeros (negative samples)
    nl = (544 // 8) * (960 // 8)
    la_ = rnd_i32(rng, -128, 128, nl * 64).reshape(nl, 8, 8)
    la_[0] = -128
    lb_ = torch.zeros_like(la_)
    # me._bi_satd's SATD: the current blocks against the averaged
    # predictions, [8160,16,16]
    a_b = rnd_i32(rng, 0, 256, Nb * 256).reshape(Nb, 16, 16)
    b_b = rnd_i32(rng, 0, 256, Nb * 256).reshape(Nb, 16, 16)
    rows["satd8x8"]["bi_satd"] = dict(
        shape=f"a,b[{Nb},16,16] int32",
        max_abs_err=check_equal("satd8x8 bi_satd",
                                cuda_kernels.satd(a_b, b_b),
                                cuda_kernels.satd_plain(a_b, b_b)),
        ms=time_ms(lambda: cuda_kernels.satd(a_b, b_b)),
        plain_ms=time_ms(lambda: cuda_kernels.satd_plain(a_b, b_b), 5),
        bytes=2 * Nb * 256 * 4 + Nb * 4, ops=Nb * 4 * (64 + 384 + 64),
        library_ms=None)
    rows["satd8x8"]["lookahead"] = dict(
        shape=f"a[{nl},8,8] int32 in [-128, 127], b zeros",
        max_abs_err=check_equal("satd8x8 lookahead",
                                cuda_kernels.satd(la_, lb_),
                                cuda_kernels.satd_plain(la_, lb_)),
        ms=time_ms(lambda: cuda_kernels.satd(la_, lb_)),
        plain_ms=time_ms(lambda: cuda_kernels.satd_plain(la_, lb_), 5),
        bytes=2 * nl * 64 * 4 + nl * 4, ops=nl * (64 + 384 + 64))

    # --- satd_intra: the lookahead's intra cost, one int16 operand ----
    for N_ in (1, 3, 5, 1003):
        for m in (255, 1023):
            a_ = intra_blocks(rng, N_, m)
            check_equal(f"satd8x8_intra edge N={N_} max {m}",
                        cuda_kernels.satd_intra(a_),
                        cuda_kernels.satd_intra_plain(a_))
    a_ = intra_blocks(rng, nl, 255)
    err = check_equal("satd8x8_intra lookahead",
                      cuda_kernels.satd_intra(a_),
                      cuda_kernels.satd_intra_plain(a_))
    check_equal("satd8x8_intra == satd8x8 against zeros",
                cuda_kernels.satd_intra(a_),
                cuda_kernels.satd(a_.to(torch.int32),
                                  torch.zeros_like(a_, dtype=torch.int32)))
    a10 = intra_blocks(rng, nl, 1023)
    err10 = check_equal("satd8x8_intra lookahead, 10-bit samples",
                        cuda_kernels.satd_intra(a10),
                        cuda_kernels.satd_intra_plain(a10))
    # per 8x8 block: 2*8*24 butterfly adds, 64 abs-adds (no subtraction)
    rows["satd8x8_intra"] = dict(
        shape=f"a[{nl},8,8] int16 in [-255, 255] (the lookahead's "
              "DC-removed 544x960 lowres blocks), against zero",
        max_abs_err=err, max_abs_err_10bit=err10,
        ms=time_ms(lambda: cuda_kernels.satd_intra(a_)),
        plain_ms=time_ms(lambda: cuda_kernels.satd_intra_plain(a_), 5),
        bytes=nl * 64 * 2 + nl * 4, ops=nl * (384 + 64), library_ms=None)
    del a10

    # --- sad_sweep / sad_sweep_argmin: the dense integer search ----------
    def sweep_case(name, h, w, S, R, flat=False, zero_cost=False, maxv=255,
                   dark_cols=0):
        """dark_cols: the reference's first columns below 256 (a dark
        region of a 10-bit picture: the CTAs there take the byte path)."""
        n = 2 * R + 1
        if flat:
            cur = torch.full((h, w), 99, dtype=torch.int16, device=DEV)
            ref = torch.full((h + 2 * R, w + 2 * R), 99, dtype=torch.int16,
                             device=DEV)
        else:
            ref = torch.from_numpy(rng.integers(
                0, maxv + 1, (h + 2 * R, w + 2 * R)).astype(np.int16)).to(DEV)
            ref[:, :dark_cols] %= 250
            # the current plane is the reference moved by (1, -2) plus
            # noise, so minima are interior and near-ties are common
            noise = torch.from_numpy(
                rng.integers(-2, 3, (h, w)).astype(np.int16)).to(DEV)
            cur = (ref[R + 1:R + 1 + h, R - 2:R - 2 + w] + noise).clamp_(
                0, maxv).contiguous()
        dys, dxs = np.mgrid[-R:R + 1, -R:R + 1]
        mvc = np.float32(2.8284) * (me._mv_bits(4 * dxs.ravel())
                                    + me._mv_bits(4 * dys.ravel()))
        mvc = torch.from_numpy(mvc.astype(np.float32)).to(DEV)
        if zero_cost:
            mvc.zero_()
        e1 = check_equal(f"sad_sweep {name}",
                         cuda_kernels.sad_sweep(cur, ref, S, R),
                         cuda_kernels.sad_sweep_plain(cur, ref, S, R))
        gi, gc = cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R)
        wi, wc = cuda_kernels.sad_sweep_argmin_plain(cur, ref, mvc, S, R)
        e2 = check_equal(f"sad_sweep_argmin idx {name}", gi, wi)
        if not torch.equal(gc, wc):
            fail(f"sad_sweep_argmin cost {name}: kernel differs from plain")
        if zero_cost and flat and int(gi.abs().max()) != 0:
            fail(f"sad_sweep_argmin {name}: first displacement must win")
        return cur, ref, mvc, n, e1, e2

    for name, h, w, S, R, kw in (
            ("S=16 R=24 1088x1920", 1088, W, 16, 24, {}),
            ("S=8 R=3", 64, 104, 8, 3, {}),
            ("single block", 16, 16, 16, 7, {}),
            ("flat", 64, 96, 8, 29, {"flat": True}),
            ("flat, mvcost=0", 64, 96, 8, 9, {"flat": True,
                                              "zero_cost": True}),
            ("mvcost=0", 48, 80, 16, 12, {"zero_cost": True}),
            ("S=4 odd block count", 28, 44, 4, 6, {}),
            ("S=32 R=8", 96, 160, 32, 8, {})):
        sweep_case(name, h, w, S, R, **kw)
    # main-path shape: the HME level of a 1080p P frame
    h, w, S, R = 544, 960, 8, 29
    cur, ref, mvc, n, e1, e2 = sweep_case("HME 544x960", h, w, S, R)
    cur_w, ref_w, _m, _n, e1w, e2w = sweep_case(
        "HME 544x960, 10-bit samples", h, w, S, R, maxv=1023)  # int16 path
    nb = (h // S) * (w // S)
    planes_bytes = (cur.numel() + ref.numel()) * 2
    # per absolute difference: a subtract, an absolute value, an add
    sweep_ops = 3 * n * n * h * w
    shape = f"cur[{h},{w}] ref_pad[{h + 2 * R},{w + 2 * R}] i16 S=8 R=29"
    rows["sad_sweep"] = dict(
        shape=shape, max_abs_err=e1,
        ms=time_ms(lambda: cuda_kernels.sad_sweep(cur, ref, S, R), 5),
        plain_ms=time_ms(
            lambda: cuda_kernels.sad_sweep_plain(cur, ref, S, R), 2),
        wide_ms=time_ms(lambda: cuda_kernels.sad_sweep(cur_w, ref_w, S, R), 5),
        max_abs_err_10bit=e1w, diffs=n * n * h * w,
        bytes=planes_bytes + n * n * nb * 4, ops=sweep_ops, library_ms=None)
    rows["sad_sweep_argmin"] = dict(
        shape=shape + f" mvcost[{n * n}] f32", max_abs_err=e2,
        max_abs_err_10bit=e2w,
        ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R),
                   10),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R)),
        wide_ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin(
            cur_w, ref_w, mvc, S, R), 10),
        diffs=n * n * h * w,
        plain_ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin_plain(
            cur, ref, mvc, S, R), 2),
        bytes=planes_bytes + n * n * 4 + nb * 8,
        ops=sweep_ops + 2 * n * n * nb, library_ms=None)

    # the lookahead's inter cost: lowres 544x960 against the previous
    # lowres plane edge-padded by 4, S=8, no mv cost (first minimum over
    # d = dy*9 + dx: two overlapping runs of eight dy)
    h, w, S, R = 544, 960, 8, 4
    sweep_case("lookahead flat, mvcost=0", 64, 96, S, R, flat=True,
               zero_cost=True)
    cur, ref, mvc, n, _e1, e2 = sweep_case("lookahead 544x960", h, w, S, R,
                                           zero_cost=True)
    e10 = sweep_case("lookahead 544x960, 10-bit samples", h, w, S, R,
                     zero_cost=True, maxv=1023)[5]
    nb = (h // S) * (w // S)
    rows["sad_sweep_argmin"]["lookahead"] = dict(
        shape=f"cur[{h},{w}] ref_pad[{h + 2 * R},{w + 2 * R}] i16 S=8 R=4 "
              f"mvcost[{n * n}] zeros",
        max_abs_err=e2, max_abs_err_10bit=e10,
        ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R),
                   10),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R)),
        plain_ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin_plain(
            cur, ref, mvc, S, R), 3),
        diffs=n * n * h * w,
        bytes=(cur.numel() + ref.numel()) * 2 + n * n * 4 + nb * 8,
        ops=3 * n * n * h * w + 2 * n * n * nb)

    # the slice-type search's pair costs (lookahead._batched_pair_fn): a
    # lowres plane against another up to bframes + 1 pictures away,
    # edge-padded by 8, S=8, no mv cost (n = 17: runs of eight dy at 0, 8
    # and 9)
    h, w, S, R = 544, 960, 8, 8
    sweep_case("slicetype flat, mvcost=0", 64, 96, S, R, flat=True,
               zero_cost=True)
    cur, ref, mvc, n, _e1, e2 = sweep_case("slicetype 544x960", h, w, S, R,
                                           zero_cost=True)
    e10 = sweep_case("slicetype 544x960, 10-bit samples", h, w, S, R,
                     zero_cost=True, maxv=1023)[5]
    nb = (h // S) * (w // S)
    rows["sad_sweep_argmin"]["slicetype"] = dict(
        shape=f"cur[{h},{w}] ref_pad[{h + 2 * R},{w + 2 * R}] i16 S=8 R=8 "
              f"mvcost[{n * n}] zeros",
        max_abs_err=e2, max_abs_err_10bit=e10,
        ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R),
                   10),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R)),
        plain_ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin_plain(
            cur, ref, mvc, S, R), 3),
        diffs=n * n * h * w,
        bytes=(cur.numel() + ref.numel()) * 2 + n * n * 4 + nb * 8,
        ops=3 * n * n * h * w + 2 * n * n * nb)

    # the batch axis of the argmin entry (the slice-type search's pair
    # pass): P planes in one launch against P single-plane calls and the
    # plain version; a stack of one equals the 2-D call
    for P_, h, w, R, m in ((3, 64, 96, 8, 255), (5, 40, 56, 8, 1023),
                           (2, 544, 960, 8, 255), (2, 544, 960, 8, 1023),
                           (1, 64, 104, 4, 255)):
        cur, ref = sweep_planes(rng, P_, h, w, R, m)
        mvc = torch.zeros(((2 * R + 1) ** 2,), dtype=torch.float32,
                          device=DEV)
        gi, gc = cuda_kernels.sad_sweep_argmin(cur, ref, mvc, 8, R)
        wi, wc = cuda_kernels.sad_sweep_argmin_plain(cur, ref, mvc, 8, R)
        name = f"sad_sweep_argmin batch P={P_} {h}x{w} R={R} max {m}"
        check_equal(name, gi, wi)
        if not torch.equal(gc, wc):
            fail(f"{name}: cost differs from plain")
        for p_ in range(P_):
            si, sc = cuda_kernels.sad_sweep_argmin(cur[p_], ref[p_], mvc,
                                                   8, R)
            if not (torch.equal(si, gi[p_]) and torch.equal(sc, gc[p_])):
                fail(f"{name}: plane {p_} differs from its own launch")
    del cur, ref

    # the slow preset's dense integer search (--me star): the whole
    # 1088x1920 picture at S=16, R=57 (n = 115: fourteen runs of eight dy
    # and one at 107) against the crop of a reference padded by R+6,
    # with the encoder's mv cost; on flat content with zero cost the first
    # displacement, d = 0, must win
    h, w, S, R = 1088, W, 16, 57
    sweep_case("dense flat, mvcost=0", 64, 96, S, R, flat=True,
               zero_cost=True)
    cur, ref, mvc, n, _e1, e2 = sweep_case("dense 1088x1920", h, w, S, R)
    e10 = sweep_case("dense 1088x1920, 10-bit samples", h, w, S, R,
                     maxv=1023)[5]
    nb = (h // S) * (w // S)
    rows["sad_sweep_argmin"]["dense"] = dict(
        shape=f"cur[{h},{w}] ref_pad[{h + 2 * R},{w + 2 * R}] i16 S=16 "
              f"R=57 mvcost[{n * n}] f32 (a crop of the reference padded "
              f"by R+6 to [{h + 2 * R + 12},{w + 2 * R + 12}])",
        max_abs_err=e2, max_abs_err_10bit=e10,
        ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R),
                   5),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R), 5),
        plain_ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin_plain(
            cur, ref, mvc, S, R), 1),
        diffs=n * n * h * w,
        bytes=(cur.numel() + ref.numel()) * 2 + n * n * 4 + nb * 8,
        ops=3 * n * n * h * w + 2 * n * n * nb)
    del cur, ref

    # the standalone motion API's dense search (engine.me.motion_decide at
    # merange 16, phase motion_api_1080p): the 1088x1920 picture at S=16,
    # R=16 (n = 33) against the reference edge-padded by R
    h, w, S, R = 1088, W, 16, 16
    cur, ref, mvc, n, _e1, e2 = sweep_case("motion_decide 1088x1920 R=16",
                                           h, w, S, R)
    e10 = sweep_case("motion_decide 1088x1920 R=16, 10-bit samples", h, w,
                     S, R, maxv=1023)[5]
    nb = (h // S) * (w // S)
    rows["sad_sweep_argmin"]["motion_decide_r16"] = dict(
        shape=f"cur[{h},{w}] ref_pad[{h + 2 * R},{w + 2 * R}] i16 S=16 "
              f"R=16 mvcost[{n * n}] f32",
        max_abs_err=e2, max_abs_err_10bit=e10,
        ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R),
                   10),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R), 5),
        plain_ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin_plain(
            cur, ref, mvc, S, R), 2),
        diffs=n * n * h * w,
        bytes=(cur.numel() + ref.numel()) * 2 + n * n * 4 + nb * 8,
        ops=3 * n * n * h * w + 2 * n * n * nb)
    del cur, ref

    # parallel/tiles._band_step's dense min-SAD: one 1080p band of four
    # tiles (phase tiles_1080p), the band's 272 rows against the band
    # extended by the R=8 halo rows above and below and padded by R
    # columns, with a zero mv cost (only the minimum's value is used)
    h, w, S, R = 1088 // 4, W, 16, 8
    cur, ref, mvc, n, _e1, e2 = sweep_case("tiles band 272x1920 R=8", h, w,
                                           S, R, zero_cost=True)
    e10 = sweep_case("tiles band 272x1920 R=8, 10-bit samples", h, w, S, R,
                     zero_cost=True, maxv=1023)[5]
    nb = (h // S) * (w // S)
    rows["sad_sweep_argmin"]["tiles_band"] = dict(
        shape=f"cur[{h},{w}] ref_pad[{h + 2 * R},{w + 2 * R}] i16 S=16 "
              f"R=8 mvcost[{n * n}] f32 zero",
        max_abs_err=e2, max_abs_err_10bit=e10,
        ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R),
                   20),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R), 10),
        plain_ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin_plain(
            cur, ref, mvc, S, R), 5),
        diffs=n * n * h * w,
        bytes=(cur.numel() + ref.numel()) * 2 + n * n * 4 + nb * 8,
        ops=3 * n * n * h * w + 2 * n * n * nb)
    del cur, ref

    # BASELINE config 4's dense search at 2160p on 10-bit planes (S=16,
    # R=57). Each CTA takes the byte path when every sample it stages is
    # below 256 (dark PQ regions) and the int16 path otherwise: held and
    # timed on a plane whose left half is dark (ms, cold_l2_ms) and on an
    # all-bright one (wide_ms, against wide_bound_sad_ms)
    h, w, S, R = 2176, W4K, 16, 57
    cur, ref, mvc, n, _e1, e2 = sweep_case(
        "dense 2176x3840 10-bit, left half dark", h, w, S, R, maxv=1023,
        dark_cols=w // 2)
    cur_w, ref_w, _mvc, _n, _e1w, e2w = sweep_case(
        "dense 2176x3840 10-bit, bright", h, w, S, R, maxv=1023)
    nb = (h // S) * (w // S)
    rows["sad_sweep_argmin"]["dense_2160p_main10"] = dict(
        shape=f"cur[{h},{w}] ref_pad[{h + 2 * R},{w + 2 * R}] i16 10-bit "
              f"(left half below 256; wide_ms: all bright) S=16 R=57 "
              f"mvcost[{n * n}] f32",
        max_abs_err=max(e2, e2w),
        ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R),
                   3),
        cold_l2_ms=time_cold_ms(
            lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R), 3),
        wide_ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin(
            cur_w, ref_w, mvc, S, R), 3),
        plain_ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin_plain(
            cur, ref, mvc, S, R), 1),
        diffs=n * n * h * w,
        bytes=(cur.numel() + ref.numel()) * 2 + n * n * 4 + nb * 8,
        ops=3 * n * n * h * w + 2 * n * n * nb)
    del cur, ref, cur_w, ref_w

    # --- sad_local_argmin: the window search around the HME centres ------
    local_edge_cases(rng)
    rows["sad_local_argmin"] = local_main_case(rng)

    # --- rd_tb_cost: the RD passes' TB cost chain ------------------------
    rd_cost_edge_cases(rng)
    rows["rd_tb_cost"] = rd_cost_main_case(rng)
    return rows


META = {
    "mc_gather_interp": ("x265_tpu_torch/csrc/mc_gather.cu",
                         "x265_tpu/ops/pallas_mc.py:121"),
    "tile_gather": ("x265_tpu_torch/csrc/tile_gather.cu",
                    "x265_tpu/ops/pallas_mc.py:205"),
    "tile_gather_planes": ("x265_tpu_torch/csrc/tile_gather.cu",
                           "x265_tpu/ops/pallas_mc.py:275"),
    "tile_gather_planes_satd": ("x265_tpu_torch/csrc/tile_gather.cu",
                                "x265_tpu/ops/pallas_mc.py:275"),
    "satd8x8": ("x265_tpu_torch/csrc/satd.cu",
                "x265_tpu/ops/pallas_kernels.py:58"),
    "satd8x8_intra": ("x265_tpu_torch/csrc/satd.cu",
                      "x265_tpu/ops/pallas_kernels.py:58"),
    "sad_sweep": ("x265_tpu_torch/csrc/sad_sweep.cu",
                  "x265_tpu/ops/pallas_kernels.py:127"),
    "sad_sweep_argmin": ("x265_tpu_torch/csrc/sad_sweep.cu",
                         "x265_tpu/ops/pallas_kernels.py:127"),
    "sad_local_argmin": ("x265_tpu_torch/csrc/sad_sweep.cu",
                         "x265_tpu/ops/pallas_kernels.py:127"),
    "rd_tb_cost": ("x265_tpu_torch/csrc/rd_cost.cu",
                   "none: the TB cost chain of x265_tpu/models/rdo.py and "
                   "intra_rdo.py, left to XLA"),
}


# the entries a main path does not launch: sad_sweep returns what the TPU
# kernel returns (every path calls the fused entries of the same kernel
# instead); tile_gather_planes, the blocks entry of kernel 3, serves
# me._bi_satd, which only B pictures run
LOW_LATENCY_OFF_PATH = ("sad_sweep", "tile_gather_planes",
                        # CQP without scene cuts runs no lookahead
                        "satd8x8_intra",
                        # rd 2 runs no RD pass
                        "rd_tb_cost")
# ultrafast (the first slice) does not deblock
OFF_PATH_UNFILTERED = LOW_LATENCY_OFF_PATH + ("deblock_bs",)
# the dense search of the slow preset replaces the two-level search, so
# its path never runs the window entry
OFF_PATH = {"encode_1080p": OFF_PATH_UNFILTERED,
            "encode_1080p_filtered": LOW_LATENCY_OFF_PATH,
            # the live encode's only SATD is the lookahead's intra cost
            # (the one-operand entry): no B pictures, no motion tuples
            "encode_1080p_live": ("sad_sweep", "tile_gather_planes",
                                  "satd8x8"),
            "encode_1080p_medium": ("sad_sweep",),
            "encode_1080p_slow": ("sad_sweep", "sad_local_argmin"),
            "encode_2160p_main10_hdr10": ("sad_sweep", "sad_local_argmin"),
            # the steered paths run config 3's medium preset (the loaded
            # encodes skip the motion search: their save encodes run it)
            "encode_1080p_twopass": ("sad_sweep",),
            "encode_1080p_analysis_reuse": ("sad_sweep",),
            "ladder_1080p": ("sad_sweep",),
            # --frame-dup makes zerolatency's queue two deep, so the live
            # robust path codes B pictures too (ROADMAP Queue 3)
            "encode_1080p_live_robust": ("sad_sweep",),
            "encode_1080p_medium_slices": ("sad_sweep",),
            # the reference switches: the numpy analysis still searches
            # motion on the card, the Python writer still runs the
            # device's RD passes; config 3 without the device residual
            # keeps the RD passes' gathers; the ladder is config 3's
            "reference_switches": ("sad_sweep",),
            "encode_1080p_medium_cpu_residual": ("sad_sweep",),
            "ladder_2160p_2proc": ("sad_sweep",),
            # the motion API runs no RD pass and no residual
            "motion_api_1080p": ("sad_sweep", "mc_gather_interp",
                                 "tile_gather", "satd8x8_intra",
                                 "deblock_bs", "rd_tb_cost"),
            # config 3 without the device residual under a mesh of four
            # tiles: encode_1080p_medium_cpu_residual's kernels
            "encode_1080p_medium_mesh4": ("sad_sweep",),
            # the band step: kernel 5's fused entry, a launch a band
            "tiles_1080p": tuple(k for k in META
                                 if k != "sad_sweep_argmin")
            + ("deblock_bs",)}
# the kernels of the motion search, which an encode that loads its
# decisions must not launch
MOTION_KERNELS = ("tile_gather_planes", "tile_gather_planes_satd",
                  "sad_local_argmin")


# the extra shapes a kernel is held and timed at, beside its main row
SHAPES_ON_PATH = ("lookahead", "rd_adopt_luma", "rd_adopt_chroma",
                  "rd_promote64", "bi_residual", "bi_satd", "slicetype",
                  "dense", "rd_adopt_luma_2160p_main10", "dense_2160p_main10",
                  "motion_decide_r16", "slicetype_batch", "tiles_band",
                  "rd_promote32_rdoq", "rd_adopt_chroma_2160p_main10")
# the path whose dense-search launches each dense shape reports
DENSE_PATH = {"dense": "encode_1080p_slow",
              "dense_2160p_main10": "encode_2160p_main10_hdr10",
              "motion_decide_r16": "motion_api_1080p",
              "tiles_band": "tiles_1080p"}
# the main paths whose every integer search is the dense S=16 R=57 sweep
DENSE_R57_PATHS = ("encode_1080p_slow", "encode_2160p_main10_hdr10")


def bounds(r, cal):
    """bound_ms: the larger of the bytes at the memory rate and the
    operations at the data sheet's scalar rate. For an SAD sweep
    (`diffs` absolute differences) that rate charges a difference three
    operations, more than the card needs for one, so two more bounds
    charge it the instruction the kernel's path runs on, at the rate this
    card ran it in the calibration phase: a quarter of a vabsdiff4 for
    samples that fit a byte (bound_sad4_ms, against `ms`), one __sad
    otherwise (wide_bound_sad_ms, against `wide_ms`); or the bytes, if
    they take longer."""
    t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = r["ops"] / INT_OPS_PER_S * 1e3
    b = {"bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if "diffs" in r:
        b["bound_sad4_ms"] = max(
            t_bytes, r["diffs"] / cal["sad4_differences_per_s"] * 1e3)
        if "wide_ms" in r:
            b["wide_bound_sad_ms"] = max(
                t_bytes, r["diffs"] / cal["sad_differences_per_s"] * 1e3)
    return b


def encode_and_decode(what, params, frames):
    """Encode on the card, decode with the port's decoder, and require
    the decoded pictures to equal the encoder's recon exactly. Both in
    display order: B pictures finish out of order, and a picture coded
    again under VBV reports twice (the last report is the one in the
    stream)."""
    devcache.clear()
    enc = Encoder(params)
    got = {}
    enc.recon_sink = lambda idx, planes: got.__setitem__(idx, planes)
    t0 = time.time()
    stream = enc.encode(frames)
    t_enc = time.time() - t0
    recons = [got[i] for i in sorted(got)]
    pics = HEVCDecoder().decode(stream)
    if len(pics) != len(frames) or len(recons) != len(frames):
        fail(f"{what}: {len(pics)} pictures decoded, "
             f"{len(recons)} recons, {len(frames)} frames")
    for i, (pic, rec) in enumerate(zip(pics, recons)):
        for a, b in zip((pic.y, pic.cb, pic.cr), rec):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                fail(f"{what}: decoded picture {i} != encoder recon")
    return enc, stream, t_enc


def check_filtered(enc, what):
    """The filtered path took its new branches in the last picture."""
    sp = enc._last_sao
    sao_ctus = int(((sp.type_y != 0) | (sp.type_c != 0)).sum()) \
        if sp is not None else 0
    if sao_ctus == 0:
        fail(f"{what}: no CTU carries SAO parameters")
    qmap = enc._last_analysis.qp_map
    qp = enc.frame_stats[-1]["qp"]
    if qmap is None or not (qmap != qp).any():
        fail(f"{what}: no qp_map entry differs from the slice QP")
    if enc._last_weights is None or enc._last_weights[0] is None:
        fail(f"{what}: weighted prediction found no weight on a ramp")
    return {"sao_ctus_last_frame": sao_ctus,
            "qp_map_range_last_frame": [int(qmap.min()), int(qmap.max())],
            "weights_last_frame": [list(enc._last_weights[0]),
                                   [list(c) for c in enc._last_weights[1]]
                                   if enc._last_weights[1] else None]}


def golden_phase():
    """Encode the golden cases (with the golden ladder's renditions) on
    the card and hold their records (testclip.golden_record: the stream's
    digest, its QP maps, picture types and QPs, ...) against the JAX
    package's (golden_streams.json). Cases without AQ are integer
    paths behind an fp32 analysis whose sums are exact in any order: a
    mismatch is a fault. The AQ case goes through host float64 (libm's
    pow): a mismatch there is reported with the number of CTUs whose QP
    differs, and is a fault only when no QP differs. Where the stream
    is the JAX package's, every other field of the record must be too."""
    gold = testclip.golden_digests()
    records = {}
    for name in testclip.GOLDEN_CASES:
        devcache.clear()
        frames = testclip.golden_clip(name)
        with tempfile.TemporaryDirectory() as tmp:     # fixture files
            enc = Encoder(testclip.golden_params(name, api_params, tmp,
                                                 encoder=Encoder))
            records[name] = testclip.golden_record(
                enc, name, frames, mesh=testclip.golden_mesh(name, DEV),
                lookahead=lookahead)[1]
    devcache.clear()
    records.update(testclip.golden_ladder(ladder)[1])
    for name, record in records.items():
        differ = testclip.golden_mismatch(name, record)
        same = not {"sha256", "bytes"} & set(differ)
        flips = None
        if not same:
            want = gold[name].get("qp_maps")
            if want and any(q is not None for q in want):
                flips = int(sum(
                    (np.asarray(a) != np.asarray(b)).sum()
                    for a, b in zip(record["qp_maps"], want)
                    if b is not None))
            if not flips:
                fail(f"golden {name}: stream digest {record['sha256']} "
                     f"({record['bytes']} bytes) != {gold[name]['sha256']} "
                     f"({gold[name]['bytes']} bytes), and no AQ QP differs")
        elif differ:
            fail(f"golden {name}: the stream is the JAX package's, its "
                 f"{', '.join(differ)} not")
        emit("golden", case=name, bytes=record["bytes"],
             equals_jax_stream=same, ctus_with_other_qp=flips,
             fields_differing=differ)


def first_slices(stream):
    """The NAL types of a stream's pictures: its VCL NAL units that start
    a picture (first_slice_segment_in_pic_flag, the slice header's first
    bit)."""
    return [(n[0] >> 1) & 0x3F for n in split_annexb(stream)
            if ((n[0] >> 1) & 0x3F) < 32 and n[2] & 0x80]


def check_b_structure(phase, enc, stream):
    """Frame types in encode order: I first, at least two P and four B,
    and wherever a mini-GOP holds three or more B pictures, the first one
    coded after its P anchor is the pyramid's referenced B (a TRAIL_R
    slice). Returns the types and the slices' NAL types."""
    types = "".join(s["type"] for s in enc.frame_stats)
    vcl = first_slices(stream)
    if len(vcl) != len(types):
        fail(f"{phase}: {len(vcl)} slices for {len(types)} pictures")
    if (types[0] != "I" or types.count("P") < 2 or types.count("B") < 4):
        fail(f"{phase}: frame types {types}: expected I first, at least "
             "two P and four B")
    i = 0
    while i < len(types):
        j = i + 1
        while j < len(types) and types[j] == "B":
            j += 1
        if j - i - 1 >= 3 and vcl[i + 1] != NAL_TRAIL_R:
            fail(f"{phase}: the mini-GOP at picture {i} of {types} holds "
                 f"{j - i - 1} B pictures and no referenced B first")
        i = j
    return types, vcl


def attribute_launches(enc):
    """Count, per kind of picture, the launches made inside the encoder
    calls that code it: P anchors (_encode_p_frame, VBV re-encodes
    included), I pictures (_encode_intra_frame) and B pictures (the
    pyramid's referenced B, the leaf-B batch analysis and the B pipeline).
    What falls outside (the lookahead, the slice-type search) is the
    total less these. Returns {kind: {kernel: launches}}."""
    acc = {k: dict.fromkeys(cuda_mc.launches, 0) for k in "PIB"}

    def wrap(kind, fn):
        def run(*a, **kw):
            before = dict(cuda_mc.launches)
            try:
                return fn(*a, **kw)
            finally:
                for k, v in cuda_mc.launches.items():
                    acc[kind][k] += v - before[k]
        return run
    for kind, names in (("P", ("_encode_p_frame",)),
                        ("I", ("_encode_intra_frame",)),
                        ("B", ("_encode_b_frame", "_precompute_b_batch",
                               "_run_b_pipeline"))):
        for name in names:
            setattr(enc, name, wrap(kind, getattr(enc, name)))
    return acc


@contextlib.contextmanager
def int_stage_launches(sink):
    """Count the sad_sweep_argmin launches made inside me._int_stage (the
    integer search: the dense sweep, or the hierarchical search's coarse
    level) and note its (S, R) shapes. The counts are the wrapper's own,
    read around each call."""
    orig = me._int_stage

    def run(cur, ref_R, mvcost, S, R):
        before = cuda_mc.launches["sad_sweep_argmin"]
        try:
            return orig(cur, ref_R, mvcost, S, R)
        finally:
            sink["launches"] += cuda_mc.launches["sad_sweep_argmin"] - before
            sink["shapes"].add((S, R))
    me._int_stage = run
    try:
        yield
    finally:
        me._int_stage = orig


def switched(enc, attrs):
    """The encoder with the given Encoder attributes (the reference
    switches: use_tpu_analysis, use_native, use_tpu_residual) set."""
    for k, v in (attrs or {}).items():
        setattr(enc, k, v)
    return enc


def plain_first_minigop(params_fn, frames, size, attrs=None):
    """The plain versions' stream up to the first mini-GOP that holds a B
    picture: headers, every frame through encode_frame (the I picture
    codes at once, the rest wait in b-adapt's window, which holds the
    whole clip), then flush_step until a B picture is coded. A shorter
    clip would place other mini-GOPs."""
    enc = switched(Encoder(params_fn(*size)), attrs)
    if min(enc.param.rc_lookahead, 32) < len(frames):
        fail("the first mini-GOP check needs the whole clip in b-adapt's "
             "window")
    stream = enc.headers()
    for f in frames:
        stream += enc.encode_frame(*f)
    while enc.pending and not any(s["type"] == "B"
                                  for s in enc.frame_stats):
        stream += enc.flush_step()
    return stream, len(enc.frame_stats)


# fps and stage seconds of each main path of this run, and its stream
# (main_path fills them)
PATH_NUMBERS = {}
PATH_STREAMS = {}


def plain_check(phase, params_fn, frames, size, attrs, stream, plain,
                prefix):
    """main_path's frames again with the plain versions forced on the
    card: the same stream over the whole clip (plain="whole"), up to the
    first mini-GOP ("first_minigop") or over the first `prefix` frames
    ("prefix"). Returns the pictures compared and the seconds."""
    plain_frames = len(frames) if plain != "prefix" else prefix
    t0 = time.time()
    with plain_versions():
        cuda_mc.reset_launches()
        if plain == "first_minigop":
            plain_stream, plain_frames = plain_first_minigop(
                params_fn, frames, size, attrs)
        else:
            plain_stream = switched(Encoder(params_fn(*size)), attrs).encode(
                frames[:plain_frames])
        if any(cuda_mc.launches.values()):
            fail(f"{phase}: the plain-version run launched a kernel")
    t_plain = time.time() - t0
    if plain == "whole":
        if stream != plain_stream:
            fail(f"{phase}: kernel stream != plain-version stream over the "
                 f"whole clip ({len(stream)} vs {len(plain_stream)} bytes)")
    elif not stream.startswith(plain_stream):
        fail(f"{phase}: kernel stream != plain-version stream over the "
             f"first {plain_frames} pictures")
    return plain_frames, t_plain


def main_path(phase, params_fn, frames, card, types_want, stages_want=(),
              plain="prefix", size=(W, H), check=None, setup=None,
              prefix=3, attrs=None):
    """One main path: the frames through Encoder.encode with the launch
    counts set to 0 just before and read just after; then the frames
    again with the plain versions, which must give the same bytes: the
    first 3 frames (plain="prefix", a prefix of the stream) or, for a
    path with B frames, whose GOPs a shorter clip changes, the whole clip
    ("whole") or the pictures up to the first mini-GOP ("first_minigop");
    prefix: the number of frames of "prefix"; plain=None runs no plain
    versions (for a path whose stream a check holds equal to another
    main path's, itself held against them).
    types_want: the frame types in encode order, or None for the B-frame
    checks of check_b_structure. size: (width, height); check: a function
    of (encoder, stream) whose dict joins the phase's line (it calls fail
    itself); setup: a function called with the encoder before it encodes
    (to attach the spies a check reads); attrs: Encoder attributes (the
    reference switches) set on the kernels' encoder and on the plain
    versions' alike. Returns the launch counts and the launches of the
    integer search; the fps and stage seconds go into PATH_NUMBERS, the
    stream into PATH_STREAMS."""
    devcache.clear()
    enc = switched(Encoder(params_fn(*size)), attrs)
    if setup is not None:
        setup(enc)
    by_kind = attribute_launches(enc)
    int_stage = {"launches": 0, "shapes": set()}
    profiling.reset()
    profiling.set_sync(True)
    cuda_mc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    with int_stage_launches(int_stage):
        stream = enc.encode(frames)
    torch.cuda.synchronize()
    t_enc = time.time() - t0
    launches = dict(cuda_mc.launches)
    profiling.set_sync(False)
    missing = [k for k, v in launches.items()
               if v == 0 and k not in OFF_PATH[phase]]
    if missing:
        fail(f"{phase}: kernels never launched: {missing}")
    nal_types = [(n[0] >> 1) & 0x3F for n in split_annexb(stream)[:3]]
    if not stream or nal_types != [32, 33, 34]:
        fail(f"{phase}: stream does not start with VPS/SPS/PPS: "
             f"{nal_types}")
    types = "".join(s["type"] for s in enc.frame_stats)
    extra = {}
    if types_want is None:
        types, vcl = check_b_structure(phase, enc, stream)
        extra["slice_nal_types"] = vcl
    elif types != types_want:
        fail(f"{phase}: frame types {types}, expected {types_want}")
    inter_pct = float(enc._last_analysis.inter8.astype(bool).mean())
    report = profiling.report()
    stages = {k: round(v["seconds"], 4) for k, v in report.items()}
    for st in stages_want:
        if not report.get(st, {}).get("calls"):
            fail(f"{phase}: stage {st} never ran")
    if phase in ("encode_1080p_live", "encode_1080p_medium",
                 "encode_1080p_slow", "encode_2160p_main10_hdr10",
                 "encode_1080p_twopass"):
        extra.update({"frame_qps": [s["qp"] for s in enc.frame_stats],
                      "frame_pocs": [s["poc"] for s in enc.frame_stats],
                      "vbv_reencodes": enc.vbv_reencodes,
                      "scenecut_frames": sorted(enc._scenecut_frames),
                      "stage_calls": {st: report[st]["calls"]
                                      for st in stages_want}})
    elif phase == "encode_1080p_filtered":
        extra = check_filtered(enc, phase)
    if phase != "encode_1080p":
        cl = enc._last_analysis.cu_log2_map
        extra["cu_size_share_last_frame"] = {
            str(1 << lg): float((cl == lg).mean()) for lg in (3, 4, 5, 6)}
    if check is not None:
        extra.update(check(enc, stream))
    if phase in DENSE_R57_PATHS:
        if int_stage["shapes"] != {(16, 57)}:
            fail(f"{phase}: the integer search ran at {int_stage['shapes']}"
                 ", not only the dense S=16 R=57 sweep")
        extra["dense_launches"] = int_stage["launches"]
    # the same frames with the plain versions forced on the card
    devcache.clear()
    plain_frames, t_plain = 0, 0.0
    if plain:
        plain_frames, t_plain = plain_check(phase, params_fn, frames, size,
                                            attrs, stream, plain, prefix)
    per_type = {f"launches_per_{t.lower()}_frame": {
        k: v / types.count(t) for k, v in by_kind[t].items()}
        for t in "PB" if types.count(t)}
    per_type["launches_outside_pictures"] = {
        k: v - sum(by_kind[t][k] for t in "PIB") for k, v in launches.items()}
    PATH_STREAMS[phase] = stream
    PATH_NUMBERS[phase] = {"fps": len(frames) / t_enc, "seconds": t_enc,
                           "frames": len(frames), "pictures": len(types),
                           "stage_seconds": stages}
    emit(phase, card=card, frames=len(frames), types=types,
         bytes=len(stream), seconds=t_enc, fps=len(frames) / t_enc,
         stage_seconds=stages, launches=launches, **per_type,
         inter_cu_share_last_frame=inter_pct,
         kernel_stream_equals_plain_stream=bool(plain),
         plain_pictures=plain_frames, plain_seconds=t_plain,
         bits=[s["bits"] for s in enc.frame_stats], **extra)
    return launches, int_stage["launches"]


@contextlib.contextmanager
def pair_passes(log):
    """Record, for every pass of the slice-type search's pair costs,
    (distinct current planes, pairs): the shapes of its one intra launch
    and its one batched sweep launch."""
    fn = lookahead._batched_pair_fn

    def spy(curs, refs, cur_of):
        log.append((int(curs.shape[0]), int(refs.shape[0])))
        return fn(curs, refs, cur_of)
    lookahead._batched_pair_fn = spy
    try:
        yield
    finally:
        lookahead._batched_pair_fn = fn


def pair_window_phase(card, rows, passes):
    """Kernel 4's intra entry and kernel 5's batched argmin at the shapes
    of config 3's first pair pass (U distinct current planes, P pairs of
    544x960 lowres planes, S=8, R=8, no mv cost), held against the plain
    versions at 8 and 10 bits and timed; beside them the P one-plane
    launches the pass replaced."""
    U, P = passes[0]
    rng = np.random.default_rng(12)
    h, w, S, R = 544, 960, 8, 8
    n, nl = 2 * R + 1, (h // 8) * (w // 8)
    a_ = intra_blocks(rng, U * nl, 255)
    e = check_equal("satd8x8_intra window", cuda_kernels.satd_intra(a_),
                    cuda_kernels.satd_intra_plain(a_))
    a10 = intra_blocks(rng, U * nl, 1023)
    e10 = check_equal("satd8x8_intra window, 10-bit samples",
                      cuda_kernels.satd_intra(a10),
                      cuda_kernels.satd_intra_plain(a10))
    del a10
    rows["satd8x8_intra"]["slicetype"] = dict(
        shape=f"a[{U}*{nl},8,8] int16 in [-255, 255]: the {U} distinct "
              "current planes of config 3's first pair pass",
        max_abs_err=e, max_abs_err_10bit=e10,
        ms=time_ms(lambda: cuda_kernels.satd_intra(a_)),
        plain_ms=time_ms(lambda: cuda_kernels.satd_intra_plain(a_), 3),
        bytes=U * nl * (64 * 2 + 4), ops=U * nl * (384 + 64))
    mvc = torch.zeros((n * n,), dtype=torch.float32, device=DEV)
    errs = []
    for m in (1023, 255):              # the 8-bit planes are then timed
        cur, ref = sweep_planes(rng, P, h, w, R, m)
        gi, gc = cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S, R)
        wi, wc = cuda_kernels.sad_sweep_argmin_plain(cur, ref, mvc, S, R)
        errs.append(check_equal(f"sad_sweep_argmin window max {m}", gi, wi))
        if not torch.equal(gc, wc):
            fail(f"sad_sweep_argmin window max {m}: cost differs")
    nb = (h // S) * (w // S)
    rows["sad_sweep_argmin"]["slicetype_batch"] = dict(
        shape=f"cur[{P},{h},{w}] ref_pad[{P},{h + 2 * R},{w + 2 * R}] i16 "
              f"S=8 R=8 mvcost[{n * n}] zeros: config 3's first pair pass",
        max_abs_err=errs[1], max_abs_err_10bit=errs[0],
        ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin(cur, ref, mvc, S,
                                                         R), 5),
        plain_ms=time_ms(lambda: cuda_kernels.sad_sweep_argmin_plain(
            cur, ref, mvc, S, R), 1),
        diffs=P * n * n * h * w,
        bytes=(cur.numel() + ref.numel()) * 2 + n * n * 4 + P * nb * 8,
        ops=P * (3 * n * n * h * w + 2 * n * n * nb))

    def singles():
        for p_ in range(P):
            cuda_kernels.sad_sweep_argmin(cur[p_], ref[p_], mvc, S, R)
    single_ms = time_ms(singles, 3)
    emit("pair_window", card=card, passes=passes,
         distinct_current_planes=U, pairs=P,
         satd8x8_intra_ms=rows["satd8x8_intra"]["slicetype"]["ms"],
         sad_sweep_argmin_ms=rows["sad_sweep_argmin"]["slicetype_batch"][
             "ms"],
         sad_sweep_argmin_one_plane_launches_ms=single_ms)


def check_main10_hdr10(phase, n):
    """The checks of BASELINE config 4's stream: the SPS says Main10 with
    the default scaling lists and BT.2020/PQ, the first access unit
    carries the mastering-display and content-light SEIs of the options,
    and every picture the HDR10+ SEI that --dhdr10-opt dictates for the
    n entries of testclip.write_dhdr10_json."""
    def check(enc, stream):
        sps, first, lums = testclip.stream_hdr10(stream)
        if not (sps.bit_depth == 10 and sps.ptl.profile_idc == 2
                and sps.scaling_list_enabled
                and sps.scaling_list_data is None):
            fail(f"{phase}: the SPS is not Main10 with the default scaling "
                 "lists")
        if (sps.colour_primaries, sps.transfer_characteristics,
                sps.matrix_coeffs) != (9, 16, 9):
            fail(f"{phase}: the VUI is not BT.2020 / PQ")
        md = first.get(SEI_MASTERING_DISPLAY)
        cll = first.get(SEI_CONTENT_LIGHT_LEVEL)
        if md is None or cll is None or struct.unpack(
                ">6H2H2I", md) != (13250, 34500, 7500, 3000, 34000, 16000,
                                   15635, 16450, 10000000, 1) \
                or struct.unpack(">2H", cll) != (1000, 400):
            fail(f"{phase}: mastering-display or content-light SEI wrong "
                 "or missing")
        types = [st["type"] for st in enc.frame_stats]
        pocs = [st["poc"] for st in enc.frame_stats]
        want = testclip.dhdr10_expected(types, pocs, n)
        if types.count("I") != 1 or lums != want:
            fail(f"{phase}: HDR10+ SEIs {lums}, --dhdr10-opt dictates "
                 f"{want}")
        return {"main10_scaling_lists_hdr10_checked": True,
                "hdr10plus_luminance_by_picture": lums,
                "decoded": "not decoded: the port's Python decoder takes "
                           "about 8 s a 720p picture (PERF.md section 5)"}
    return check


def lossless_path(card):
    """bench.py config 1 (its second timed configuration): 12 frames of
    its 720p pan, ultrafast, lossless, keyint 1, through Encoder.encode's
    all-intra pipelined path. Every chunk's intra analysis must run on the
    card; the host time of each submit (enqueue only, if nothing waits for
    the device) is reported beside the device time of the work it queued.
    The stream is decoded by the port's decoder and every plane must
    equal the SOURCE. No stage synchronises: the analysis of the next
    chunk overlaps the writer as in an encode, so the stage seconds are
    host time. Returns the launch counts (none of the kernels is on this
    path)."""
    phase = "encode_720p_lossless"
    w, h = 1280, 720
    frames = list(clip_pan(w, h, 12, seed=10))
    devcache.clear()
    enc = Encoder(lossless_params(w, h))
    chunks = []
    submit = intra_frame.submit_intra_analysis_batch

    def submit_timed(srcs, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t0 = time.perf_counter()
        handles = submit(srcs, *a, **kw)
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        chunks.append((len(srcs), host_ms, ev,
                       sorted({hd[0].device.type for hd in handles})))
        return handles
    intra_frame.submit_intra_analysis_batch = submit_timed
    profiling.reset()
    cuda_mc.reset_launches()
    torch.cuda.synchronize()
    try:
        t0 = time.time()
        stream = enc.encode(frames)
        torch.cuda.synchronize()
        t_enc = time.time() - t0
    finally:
        intra_frame.submit_intra_analysis_batch = submit
    launches = dict(cuda_mc.launches)
    if not chunks or any(c[3] != ["cuda"] for c in chunks):
        fail(f"{phase}: the intra analysis ran on {[c[3] for c in chunks]}")
    types = "".join(s["type"] for s in enc.frame_stats)
    if types != "I" * len(frames):
        fail(f"{phase}: frame types {types}, expected all I")
    if not enc.pps.transquant_bypass_enabled:
        fail(f"{phase}: transquant bypass is not signalled")
    t0 = time.time()
    pics = HEVCDecoder().decode(stream)
    t_dec = time.time() - t0
    if len(pics) != len(frames):
        fail(f"{phase}: {len(pics)} pictures decoded of {len(frames)}")
    for i, (pic, src) in enumerate(zip(pics, frames)):
        for a, b in zip((pic.y, pic.cb, pic.cr), src):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                fail(f"{phase}: decoded picture {i} != source (lossless)")
    stages = {k: round(v["seconds"], 4)
              for k, v in profiling.report().items()}
    emit(phase, card=card, frames=len(frames), types=types,
         bytes=len(stream), seconds=t_enc, fps=len(frames) / t_enc,
         stage_seconds=stages, stage_seconds_are="host time (no stage "
         "synchronises on this path)", launches=launches,
         analysis_chunks=[{"frames": c[0], "submit_host_ms": c[1],
                           "queued_device_ms": c[2][0].elapsed_time(c[2][1]),
                           "device": c[3][0]} for c in chunks],
         decoded_equals_source=True, decode_seconds=t_dec)
    return launches

def timed_encode(params, frames):
    """One encode through Encoder.encode with the launch counts and the
    stage timers set to 0 just before and read just after, every stage
    ending in a synchronise. Returns (encoder, stream, seconds,
    launches, stage seconds)."""
    devcache.clear()
    enc = Encoder(params)
    profiling.reset()
    profiling.set_sync(True)
    cuda_mc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    stream = enc.encode(frames)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    profiling.set_sync(False)
    stages = {k: round(v["seconds"], 4)
              for k, v in profiling.report().items()}
    return enc, stream, seconds, dict(cuda_mc.launches), stages


def encode_numbers(enc, stream, seconds, kbps_target=None):
    """fps, bytes, kbps (against the target), types and QPs of an encode."""
    n = len(enc.frame_stats)
    fps_src = enc.param.fps_num / max(1, enc.param.fps_den)
    out = {"frames": n, "seconds": seconds, "fps": n / seconds,
           "bytes": len(stream), "kbps": len(stream) * 8 * fps_src / n / 1e3,
           "types": "".join(s["type"] for s in enc.frame_stats),
           "frame_qps": [s["qp"] for s in enc.frame_stats]}
    if kbps_target:
        out["kbps_target"] = kbps_target
        out["kbps_error"] = out["kbps"] / kbps_target - 1.0
    return out


def twopass_path(card, frames):
    """bench.py config 3 in two passes: --pass 1 writes the stats file (in
    a temporary directory) when the encode closes, then main_path drives
    --pass 2, which plans from it; the plain versions must give pass 2's
    bytes up to its first mini-GOP. Pass 2 must plan from what pass 1
    wrote: a record a picture, typed as pass 1's rate control recorded
    them, each taken by one rate-control start of pass 2."""
    phase = "encode_1080p_twopass"
    with tempfile.TemporaryDirectory() as tmp:
        stats = os.path.join(tmp, "config3.log")
        enc1, s1, t1, l1, st1 = timed_encode(
            steered_params({"pass": "1", "stats": stats})(W, H), frames)
        pass1 = {**encode_numbers(enc1, s1, t1, 4000), "launches": l1,
                 "stage_seconds": st1}
        missing = [k for k, v in l1.items()
                   if v == 0 and k not in OFF_PATH[phase]]
        if missing:
            fail(f"{phase}: pass 1 never launched {missing}")

        def check(enc, stream):
            with open(stats) as f:
                recs = [json.loads(line) for line in f if line.strip()]
            written = [r["type"] for r in enc1.rc.pass1_records]
            if ([r["type"] for r in recs] != written
                    or len(recs) != len(enc.frame_stats)
                    or enc.rc.pass2_qp is None
                    or len(enc.rc.pass2_qs) != len(recs)
                    or enc.rc.pass2_idx != len(recs)):
                fail(f"{phase}: pass 2 did not plan from pass 1's stats "
                     f"({len(recs)} records typed "
                     f"{''.join(r['type'] for r in recs)}, pass 1 wrote "
                     f"{''.join(written)}; {len(enc.frame_stats)} pictures, "
                     f"{enc.rc.pass2_idx} records consumed)")
            two = encode_numbers(enc, stream, 1.0, 4000)
            return {"pass1": pass1, "kbps": two["kbps"],
                    "stats_types": "".join(written),
                    "kbps_error": two["kbps_error"],
                    "pass1_kbps_error": pass1["kbps_error"],
                    "stats_records": len(recs),
                    "stats_records_with_cutree": sum("cutree" in r
                                                     for r in recs)}
        return main_path(phase, steered_params({"pass": "2",
                                                "stats": stats}),
                         frames, card, None,
                         ("slicetype", "lookahead", "motion", "rd_adopt",
                          "rd_promote", "loopfilter", "finalize"),
                         plain="first_minigop", size=(W, H), check=check)


def analysis_reuse_path(card, frames):
    """(a) bench.py config 3 with --analysis-save, then with
    --analysis-load of that file: the load must give the save's stream
    byte for byte and run no motion search and no RD pass. (b) x265's
    chain: a save at half size from the source area-scaled on the card, a
    load at full size with --scale-factor 2 (SF2_OPTS), checked by its
    SPS geometry, its types and the plain versions' first mini-GOP. Half
    of 1080 lines is 540, which the encoder does not code (it writes no
    conformance window: both sizes must be multiples of 8), so the chain
    runs on the clip's top 1072 lines: 960x536 -> 1920x1072. The path's
    launches are the four encodes', each counted from 0."""
    phase = "encode_1080p_analysis_reuse"
    total = dict.fromkeys(cuda_mc.launches, 0)
    line = {}
    hc = H - H % 16                     # 1072: half of it is 536
    crop = [(y[:hc], cb[:hc // 2], cr[:hc // 2]) for (y, cb, cr) in frames]
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "config3.dat"), os.path.join(tmp, "half.dat")
        runs = {}
        for key, params, clip in (
                ("save", steered_params({"analysis-save": a})(W, H),
                 frames),
                ("load", steered_params({"analysis-load": a})(W, H),
                 frames),
                ("save_half", steered_params(
                    {**SF2_OPTS, "analysis-save": b}, 1200)(W // 2, hc // 2),
                 [scale_frame(f, hc // 2, W // 2) for f in crop]),
                ("load_scale_factor_2", steered_params(
                    {**SF2_OPTS, "analysis-load": b,
                     "scale-factor": "2"})(W, hc), crop)):
            enc, stream, t, launches, stages = timed_encode(params, clip)
            runs[key] = (enc, stream)
            for k, v in launches.items():
                total[k] += v
            line[key] = {**encode_numbers(enc, stream, t),
                         "stage_seconds": stages, "launches": launches}
            if key.startswith("load"):
                ran = [st for st in ("motion", "rd_adopt", "rd_promote")
                       if st in stages]
                moved = [k for k in MOTION_KERNELS if launches[k]]
                if ran or moved or not launches["mc_gather_interp"]:
                    fail(f"{phase}: the {key} encode ran stages {ran} and "
                         f"kernels {moved}, mc_gather_interp "
                         f"{launches['mc_gather_interp']} times")
        if runs["load"][1] != runs["save"][1]:
            fail(f"{phase}: the load stream ({len(runs['load'][1])} bytes)"
                 f" != the save stream ({len(runs['save'][1])} bytes)")
        enc, stream = runs["load_scale_factor_2"]
        sps = enc.sps
        if (sps.width, sps.height) != (W, hc) or enc.param.scale_factor != 2:
            fail(f"{phase}: the chain's SPS is {sps.width}x{sps.height}")
        t_half = line["save_half"]["types"]
        if line["load_scale_factor_2"]["types"] != t_half:
            fail(f"{phase}: the chain's types "
                 f"{line['load_scale_factor_2']['types']} != the saved "
                 f"encode's {t_half}")
        check_b_structure(phase, enc, stream)
        devcache.clear()
        t0 = time.time()
        with plain_versions():
            cuda_mc.reset_launches()
            plain, n_plain = plain_first_minigop(steered_params(
                {**SF2_OPTS, "analysis-load": b, "scale-factor": "2"}),
                crop, (W, hc))
            if any(cuda_mc.launches.values()):
                fail(f"{phase}: the plain-version run launched a kernel")
        if not stream.startswith(plain):
            fail(f"{phase}: the chain's kernel stream != its plain-version "
                 f"stream over the first {n_plain} pictures")
    missing = [k for k, v in total.items()
               if v == 0 and k not in OFF_PATH[phase]]
    if missing:
        fail(f"{phase}: kernels never launched: {missing}")
    emit(phase, card=card, **line, load_equals_save_stream=True,
         chain_plain_pictures=n_plain,
         chain_plain_seconds=time.time() - t0,
         load_wall_share_of_save=line["load"]["seconds"]
         / line["save"]["seconds"], launches=total)
    return total


# bench.py config 3's source into three medium renditions: 1080p at 4000
# kbps, 720p at 2400 (the polyphase ratio 2/3) and 360p at 800 (the area
# ratio 3; the area ratio 2 gives 540 lines, which the encoder does not
# code: no conformance window, so sizes are multiples of 8)
LADDER_1080P = [(1920, 1080, 4000), (1280, 720, 2400), (640, 360, 800)]


def ladder_path(card, frames):
    """api/ladder.AbrLadder on the card: every source frame scaled and
    encoded into each rendition, one after another. The scaler is held
    against its CPU result on the first frame's planes at both ratios
    (the area ratio exact; the polyphase bank's float32 products with
    their mismatch count), and every rendition's stream against the
    plain versions' up to its first mini-GOP."""
    phase = "ladder_1080p"
    scaler = {}
    for (w, h, _k) in LADDER_1080P[1:]:
        card_planes = scale_frame(frames[0], h, w)
        cpu_planes = scale_frame(frames[0], h, w, device="cpu")
        diff = [np.abs(a.astype(np.int32) - b.astype(np.int32))
                for a, b in zip(card_planes, cpu_planes)]
        kind = "area" if W % w == 0 else "polyphase"
        scaler[f"{w}x{h}"] = {
            "method": kind, "samples": int(sum(d.size for d in diff)),
            "mismatches": int(sum((d > 0).sum() for d in diff)),
            "max_abs_err": int(max(d.max() for d in diff))}
        if kind == "area" and scaler[f"{w}x{h}"]["mismatches"]:
            fail(f"{phase}: the area scaler on the card != the CPU's")
    devcache.clear()
    rends = [ladder.Rendition(w, h, k) for (w, h, k) in LADDER_1080P]
    lad = ladder.AbrLadder(W, H, rends)
    secs = dict.fromkeys(lad.encoders, 0.0)
    for i, enc in lad.encoders.items():
        # each rendition's time: its scale and its encoder calls
        for name in ("encode_frame", "flush"):
            def timed(*a, _f=getattr(enc, name), _i=i, **kw):
                t = time.time()
                out = _f(*a, **kw)
                torch.cuda.synchronize()
                secs[_i] += time.time() - t
                return out
            setattr(enc, name, timed)
    scale = ladder.scale_frame

    def timed_scale(frame, oh, ow, device=None):
        t = time.time()
        out = scale(frame, oh, ow, device=device)
        secs[[r.height for r in rends].index(oh)] += time.time() - t
        return out
    ladder.scale_frame = timed_scale
    cuda_mc.reset_launches()
    torch.cuda.synchronize()
    try:
        t0 = time.time()
        for f in frames:
            lad.push(f)
        out = lad.finish()
        torch.cuda.synchronize()
        t_all = time.time() - t0
    finally:
        ladder.scale_frame = scale
    launches = dict(cuda_mc.launches)
    missing = [k for k, v in launches.items()
               if v == 0 and k not in OFF_PATH[phase]]
    if missing:
        fail(f"{phase}: kernels never launched: {missing}")
    stats = lad.stats()
    per = []
    for i, (w, h, kbps) in enumerate(LADDER_1080P):
        enc = lad.encoders[i]
        if (enc.sps.width, enc.sps.height) != (w, h):
            fail(f"{phase}: rendition {i} is {enc.sps.width}x"
                 f"{enc.sps.height}")
        types, _vcl = check_b_structure(f"{phase} {w}x{h}", enc, out[i])
        devcache.clear()
        clip = [scale_frame(f, h, w) for f in frames]
        with plain_versions():
            cuda_mc.reset_launches()
            plain, n_plain = plain_first_minigop(
                steered_params({}, kbps), clip, (w, h))
            if any(cuda_mc.launches.values()):
                fail(f"{phase}: the plain-version run launched a kernel")
        if not out[i].startswith(plain):
            fail(f"{phase}: rendition {w}x{h} != its plain-version stream "
                 f"over the first {n_plain} pictures")
        per.append({"size": f"{w}x{h}", **encode_numbers(
            enc, out[i], secs[i], kbps), "share_of_seconds": secs[i] / t_all,
            "plain_pictures": n_plain,
            "stats_bitrate_kbps": stats[i]["bitrate_kbps"]})
    emit(phase, card=card, source_frames=len(frames), seconds=t_all,
         source_fps=len(frames) / t_all, renditions=per, scaler=scaler,
         launches=launches)
    return launches


def small_steered_phases():
    """The steered encodes at 416x240, decoded back by the port's decoder
    to the encoder's recon: two passes of medium ABR, a qpfile (a forced
    CRA, an IDR, QPs) with q= and b= zones, and a two-rendition ladder at
    the area ratio 2 (416x240 and 208x120)."""
    frames = list(clip_crowd1080(416, 240, 11, seed=40))
    with tempfile.TemporaryDirectory() as tmp:
        stats = os.path.join(tmp, "small.log")
        for n in (1, 2):
            enc, stream, t = encode_and_decode(
                f"encode_small twopass {n}", steered_params(
                    {"pass": str(n), "stats": stats}, 400)(416, 240),
                frames)
            emit("encode_small", config=f"twopass pass {n}",
                 decoded_equals_recon=True,
                 **encode_numbers(enc, stream, t, 400))
        qpfile = os.path.join(tmp, "qp.txt")
        with open(qpfile, "w") as f:
            f.write(testclip.GOLDEN_QPFILE)
        enc, stream, t = encode_and_decode(
            "encode_small qpfile_zones", steered_params(
                {"qpfile": qpfile, "zones": "0,2,b=1.5/8,10,q=33"})(416, 240),
            frames)
    qps = [s["qp"] for s in enc.frame_stats]
    types = "".join(s["type"] for s in enc.frame_stats)
    if types.count("I") != 3 or not {27, 24, 38, 33} <= set(qps):
        fail(f"encode_small qpfile_zones: types {types}, QPs {qps}: the "
             "qpfile's keyframes or QPs or the q= zone are missing")
    emit("encode_small", config="qpfile_zones", decoded_equals_recon=True,
         **encode_numbers(enc, stream, t))
    lad = ladder.AbrLadder(416, 240, [ladder.Rendition(416, 240, 400),
                                      ladder.Rendition(208, 120, 150)])
    recons = {i: {} for i in lad.encoders}
    for i, enc in lad.encoders.items():
        enc.recon_sink = (lambda idx, planes, _r=recons[i]:
                          _r.__setitem__(idx, planes))
    for f in frames:
        lad.push(f)
    out = lad.finish()
    for i, stream in out.items():
        pics = HEVCDecoder().decode(stream)
        rec = [recons[i][k] for k in sorted(recons[i])]
        w, h = lad.renditions[i].width, lad.renditions[i].height
        if len(pics) != len(frames) or pics[0].y.shape != (h, w):
            fail(f"encode_small ladder {w}x{h}: {len(pics)} pictures")
        for pic, r in zip(pics, rec):
            for a, b in zip((pic.y, pic.cb, pic.cr), r):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    fail(f"encode_small ladder {w}x{h}: decoded != recon")
        emit("encode_small", config=f"ladder {w}x{h}",
             decoded_equals_recon=True,
             **encode_numbers(lad.encoders[i], stream, 1.0))


def decode_checked(what, stream, recons, n, decode_order=None):
    """Decode a stream with the port's decoder (display order) and, where
    the system has it, libde265 (decoder/de265.py), each to the encoder's
    recons; recons: {display index: planes}; decode_order: the display
    indices in the order libde265 outputs them, when that is not display
    order. Returns the transform-skip TBs the port's decoder read and
    what libde265 did ("absent" where it is not installed)."""
    from x265_tpu_torch.decoder import de265
    from x265_tpu_torch.decoder import decoder as dec_mod
    hits = []
    tsr = dec_mod.transform_skip_residual
    dec_mod.transform_skip_residual = lambda *a: hits.append(1) or tsr(*a)
    try:
        pics = HEVCDecoder().decode(stream)
    finally:
        dec_mod.transform_skip_residual = tsr
    order = sorted(recons)
    if len(pics) != n or len(order) != n:
        fail(f"{what}: {len(pics)} pictures decoded, {len(order)} recons, "
             f"{n} expected")
    for pic, i in zip(pics, order):
        for a, b in zip((pic.y, pic.cb, pic.cr), recons[i]):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                fail(f"{what}: decoded picture {i} != encoder recon")
    if not de265.available():
        return len(hits), "absent"
    ext = de265.decode(stream)
    if len(ext) != n:
        fail(f"{what}: libde265 decoded {len(ext)} of {n} pictures")
    for pic, i in zip(ext, decode_order or order):
        for a, b in zip(pic, recons[i]):
            if not np.array_equal(a, np.asarray(b)):
                fail(f"{what}: libde265's picture {i} != encoder recon")
    return len(hits), "equal"


def small_structure_phases():
    """The stream-structure options at 416x240 (416x232 for transform
    skip: its bottom 8 lines are 8x8 CUs, whose 4x4 chroma TBs it can
    take), each decoded back by the port's decoder and by libde265 where
    present: WPP, 3 slices, transform skip, noise reduction, and frame-dup
    with the histogram scene cut and intra refresh; then an encode under
    X265TPU_CHECKIFY=1 that must give the unchecked bytes, and a bad QP
    that the checked transform chain must refuse on the card."""
    from x265_tpu_torch.models.residual import tq_chain
    from x265_tpu_torch.utils import checks
    crowd = list(clip_crowd1080(416, 240, 11, seed=40))
    cases = (
        ("wpp", steered_params({"wpp": "1"}, 400)(416, 240), crowd),
        ("slices3", steered_params({"slices": "3"}, 400)(416, 240), crowd),
        ("tskip", steered_params({"tskip": "1"}, 400)(416, 232),
         testclip.make_screen_clip(416, 232, 11, seed=20)),
        ("nr", steered_params({"nr-intra": "200", "nr-inter": "500"},
                              400)(416, 240), crowd),
        ("dup_hist_refresh", live_robust_params(416, 240),
         testclip.make_dup_cut_clip(416, 240, 8, seed=11, dup=2, cut=5)))
    for label, p, frames in cases:
        if label == "dup_hist_refresh":
            p.scenecut = 0            # the histogram decides the cut
        devcache.clear()
        enc = Encoder(p)
        recons, order = {}, []

        def sink(idx, planes, _r=recons, _o=order):
            _r[idx] = planes
            _o.append(idx)
        enc.recon_sink = sink
        t0 = time.time()
        stream = enc.encode(frames)
        t_enc = time.time() - t0
        pics = testclip.stream_structure(stream)
        dropped = len(frames) - len(pics)
        # (a picture coded again under VBV reports twice in a row)
        order = list(dict.fromkeys(order))
        tskip_tbs, ext = decode_checked(
            f"encode_small {label}", stream, recons, len(pics),
            decode_order=order if label == "dup_hist_refresh" else None)
        rows = p.pic_height_in_ctbs
        extra = {}
        if label == "wpp" and any(x["slices"] != [(0, rows - 1)]
                                  for x in pics):
            fail(f"encode_small wpp: entry points {pics}")
        if label == "slices3":
            b = [round(i * rows / 3) for i in range(4)]
            want = [(b[i] * p.pic_width_in_ctbs, 0) for i in range(3)]
            if any(x["slices"] != want for x in pics):
                fail(f"encode_small slices3: segments {pics}, want {want}")
        if label == "tskip" and not tskip_tbs:
            fail("encode_small tskip: no transform-skip TB in the stream")
        if label == "nr" and not enc._nr["cnt"][8:].any():
            fail("encode_small nr: no inter statistics gathered")
        if label == "dup_hist_refresh":
            ps = [x["pic_struct"] for x in pics]
            rec = [x["recovery"] for x in pics if x["recovery"] is not None]
            if (dropped != 1 or ps.count(7) != 1
                    or enc._scenecut_frames != {5}
                    or rec != [p.pic_width_in_ctbs - 1]):
                fail(f"encode_small dup_hist_refresh: dropped {dropped}, "
                     f"pic_struct {ps}, cuts {enc._scenecut_frames}, "
                     f"recovery {rec}")
            extra = {"pic_struct": ps, "recovery_poc_cnt": rec[0],
                     "scenecut_frames": sorted(enc._scenecut_frames)}
        emit("encode_small", config=label, frames=len(frames),
             pictures=len(pics), bytes=len(stream), encode_seconds=t_enc,
             decoded_equals_recon=True, de265=ext,
             transform_skip_tbs=tskip_tbs,
             slices=pics[0]["slices"],
             types="".join(s["type"] for s in enc.frame_stats), **extra)
    # the assertion mode: an encode with the checks on gives the same
    # bytes, and a bad QP raises on the card with the JAX package's message
    p = steered_params({}, 400)(416, 240)
    streams = []
    for on in ("0", "1"):
        os.environ["X265TPU_CHECKIFY"] = on
        devcache.clear()
        streams.append(Encoder(p).encode(crowd[:5]))
    os.environ.pop("X265TPU_CHECKIFY")
    if streams[0] != streams[1]:
        fail("encode_small checkify: the checked encode's bytes differ")
    resi = torch.zeros((4, 16, 16), dtype=torch.int32, device=DEV)
    sel = torch.zeros(4, dtype=torch.int32, device=DEV)
    os.environ["X265TPU_CHECKIFY"] = "1"
    try:
        tq_chain(resi, torch.full((4,), 99, dtype=torch.int32, device=DEV),
                 sel, 16, False, False, 8, True, True, False)
        fail("checkify: QP 99 did not raise on the card")
    except checks.CheckError as e:
        message = str(e)
    finally:
        os.environ.pop("X265TPU_CHECKIFY")
    if "QP out of range" not in message:
        fail(f"checkify: raised {message!r}")
    ok = tq_chain(resi, torch.full((4,), 30, dtype=torch.int32, device=DEV),
                  sel, 16, False, False, 8, True, True, False)
    torch.cuda.synchronize()                 # the context is still usable
    emit("checkify", checked_stream_equals_unchecked=True,
         bad_qp_raised=message, context_usable_after=bool(
             ok[2].shape == (4,)))


def live_robust_checks(log):
    """The checks of encode_1080p_live_robust: 16 entry points a slice (17
    CTB rows at 64), one pic_struct 7 (the dropped duplicate's
    predecessor), the refresh column intra in every P picture (log: what
    _apply_intra_refresh forced, from refresh_spy), the recovery point
    SEI of the cycle's start, and the keyframe at the scene cut."""
    def check(enc, stream):
        p = enc.param
        pics = testclip.stream_structure(stream)
        rows = p.pic_height_in_ctbs
        if any(x["slices"] != [(0, rows - 1)] for x in pics):
            fail(f"encode_1080p_live_robust: slices {pics[0]['slices']}, "
                 f"want one with {rows - 1} entry points")
        ps = [x["pic_struct"] for x in pics]
        if ps.count(7) != 1 or len(pics) != 7:
            fail(f"encode_1080p_live_robust: pic_struct {ps} over "
                 f"{len(pics)} pictures (one dropped of 8)")
        n_p = sum(s["type"] == "P" for s in enc.frame_stats)
        w8 = p.ctu_size >> 3
        if len(log) != n_p or any(
                inter8[:, c * w8:(c + 1) * w8].any()
                or (cu[:, c * w8:(c + 1) * w8] > 5).any()
                for c, inter8, cu in log):
            fail(f"encode_1080p_live_robust: the refresh column is not "
                 f"intra in every one of {n_p} P pictures ({len(log)} "
                 "refreshed)")
        rec = [x["recovery"] for x in pics if x["recovery"] is not None]
        if rec != [p.pic_width_in_ctbs - 1]:
            fail(f"encode_1080p_live_robust: recovery point SEIs {rec}")
        cra = [i for i, x in enumerate(pics) if x["nal"] == 21]
        if enc._scenecut_frames != {4} or len(cra) != 1:
            fail(f"encode_1080p_live_robust: cut at "
                 f"{enc._scenecut_frames}, CRAs at {cra}")
        return {"entry_points_per_slice": rows - 1, "pic_struct": ps,
                "refresh_columns": [c for c, _, _ in log],
                "recovery_poc_cnt": rec[0],
                "scenecut_frames": sorted(enc._scenecut_frames),
                "stage_calls": {st: v["calls"] for st, v in
                                profiling.report().items()}}
    return check


def refresh_spy(log):
    """A main_path setup: record the column each _apply_intra_refresh call
    forces and the decisions after it."""
    def setup(enc):
        orig = enc._apply_intra_refresh

        def run(dec):
            col = enc._ir_col % enc.param.pic_width_in_ctbs
            orig(dec)
            log.append((col, dec.inter8.copy(), dec.cu_log2_map.copy()))
        enc._apply_intra_refresh = run
    return setup


def medium_slices_checks(offsets, recons):
    """The checks of encode_1080p_medium_slices: four slices a picture at
    the bands' segment addresses, noise-reduction offsets nonzero once an
    inter picture has been coded (offsets: what _nr_offsets returned), and
    the stream decoded by the port's decoder to the encoder's recons with
    transform-skip TBs in it (recons: {display index: planes}; both from
    slices_spy). Transform skip takes only the 4x4 chroma TBs of the 8x8
    CUs of the bottom 8 lines, and few of them: the whole stream is
    decoded to find them."""
    def check(enc, stream):
        p = enc.param
        rows, wc = p.pic_height_in_ctbs, p.pic_width_in_ctbs
        b = [round(i * rows / 4) for i in range(5)]
        want = [(b[i] * wc, 0) for i in range(4)]
        pics = testclip.stream_structure(stream)
        if any(x["slices"] != want for x in pics):
            fail(f"encode_1080p_medium_slices: segments {pics[0]}, "
                 f"want {want}")
        # --nr-inter only: zero offsets until the first inter picture has
        # been coded (the I picture and the P anchor after it), nonzero
        # inter offsets on every picture after that
        nz = [int((o != 0).sum()) for o in offsets]
        if (any(nz[:2]) or not all(nz[2:])
                or any(o[:8].any() for o in offsets)):
            fail(f"encode_1080p_medium_slices: NR offsets by picture {nz}")
        t0 = time.time()
        hits, ext = decode_checked("encode_1080p_medium_slices", stream,
                                   recons, len(pics))
        if not hits:
            fail("encode_1080p_medium_slices: no transform-skip TB in the "
                 "stream")
        return {"segment_addresses": [a for a, _ in want],
                "transform_skip_tbs": hits, "decoded_equals_recon": True,
                "de265": ext, "decode_seconds": time.time() - t0,
                "nr_offsets_nonzero_by_picture": nz,
                "stage_calls": {st: v["calls"] for st, v in
                                profiling.report().items()}}
    return check


def slices_spy(offsets, recons):
    """A main_path setup: record the offsets each _nr_offsets call gives,
    and each picture's recon by display index."""
    def setup(enc):
        orig = enc._nr_offsets

        def run():
            off = orig()
            offsets.append(off.copy())
            return off
        enc._nr_offsets = run
        enc.recon_sink = lambda idx, planes: recons.__setitem__(idx, planes)
    return setup


# ---- the eleventh slice: the reference switches, the standalone motion
# API, the batched intra prediction and BASELINE config 5's ladder across
# two processes

# the renditions each of the two ladder processes owns (round-robin)
LADDER_PROCS = 2


def switch_encode(what, params, frames, attrs, decode=True):
    """Encode with the given reference switches (Encoder attributes),
    time it and, with decode, decode it back to the encoder's recon (the
    port's decoder, and libde265 where the system has it). Returns the
    encoder, the stream, the seconds and libde265's verdict."""
    devcache.clear()
    enc = switched(Encoder(params), attrs)
    recons = {}
    enc.recon_sink = lambda idx, planes: recons.__setitem__(idx, planes)
    torch.cuda.synchronize()
    t0 = time.time()
    stream = enc.encode(frames)
    torch.cuda.synchronize()
    secs = time.time() - t0
    de265 = None
    if decode:
        _ts, de265 = decode_checked(what, stream, recons, len(frames))
    return enc, stream, secs, de265


def medium_cqp_params(w, h, **opts):
    """x265's medium at CQP 30 with fixed mini-GOPs of one B picture, no
    scene cut, no AQ or cuTree (the setting of the JAX package's writer
    tests, tests/test_tskip.py and test_scaling_lists.py), with more
    options through param_parse."""
    p = param_default_preset("medium")
    for k, v in (("qp", "30"), ("bframes", "1"), ("b-adapt", "0"),
                 ("scenecut", "0"), ("aq-mode", "0"), ("cutree", "0"),
                 ("rdoq-level", "2"), *opts.items()):
        param_parse(p, k, v)
    p.width, p.height = w, h
    return p


def nxn_stream(w, h, frames):
    """The NxN oracle encode (tests/test_torch_e2e_oracle.py): ultrafast
    all-intra at QP 30 through the Python writer, every other 8x8 CU
    PART_NxN with varied per-PB modes, driven through headers +
    encode_frame + flush so that the patched _intra_decisions is reached.
    Returns the stream, the recons by display index and the seconds."""
    p = param_default_preset("ultrafast")
    p.width, p.height = w, h
    for k, v in (("qp", "30"), ("keyint", "1")):
        param_parse(p, k, v)
    enc = switched(Encoder(p), {"use_native": False})
    orig = enc._intra_decisions

    def patched(y):
        dec = orig(y)
        dec.cu_log2_map[:] = 3
        h8, w8 = dec.cu_log2_map.shape
        dec.nxn8 = (np.indices((h8, w8)).sum(0) % 2 == 0)
        m4 = np.repeat(np.repeat(dec.luma_mode8, 2, 0), 2, 1)
        m4[::2, 1::2] = (m4[::2, 1::2] + 7) % 35
        m4[1::2, ::2] = (m4[1::2, ::2] + 19) % 35
        dec.luma_mode4 = m4
        dec.chroma_mode8 = None
        return dec
    enc._intra_decisions = patched
    recons = {}
    enc.recon_sink = lambda idx, planes: recons.__setitem__(idx, planes)
    t0 = time.time()
    stream = enc.headers()
    for f in frames:
        stream += enc.encode_frame(*f)
    stream += enc.flush()
    return stream, recons, time.time() - t0


def reference_switches_phase(card):
    """The JAX package's reference switches at 416x240 on the card, each
    stream decoded back to the encoder's recon: the numpy intra analysis
    (--no-tpu) on the live encode and on config 3; the Python oracle
    writer on ultrafast + zerolatency and on fast + zerolatency (deblock,
    SAO); the NxN oracle stream (counted by the decoder); and where the
    JAX package's tests hold the Python writer equal to the native one
    (the three-way of tests/test_cu64.py, tests/test_tskip.py,
    tests/test_scaling_lists.py, with the native walk quantizing every
    TB), the two streams equal here too. Returns the launch counts of the
    phase's encodes."""
    phase = "reference_switches"
    w, h = 416, 240
    cuda_mc.reset_launches()
    out = {}
    for name, params, frames, attrs in (
            ("notpu_live", live_params(w, h), make_clip(w, h, 2, seed=3),
             {"use_tpu_analysis": False}),
            ("notpu_config3", medium_params(w, h),
             list(clip_crowd1080(w, h, 5, seed=40)),
             {"use_tpu_analysis": False}),
            ("py_ultrafast_zerolatency", slice_params(w, h),
             make_clip(w, h, 3, seed=3), {"use_native": False}),
            ("py_fast_zerolatency", filtered_params(w, h),
             make_ramp_clip(w, h, 3, seed=3), {"use_native": False})):
        enc, stream, secs, de265 = switch_encode(
            f"{phase} {name}", params, frames, attrs)
        out[name] = {"frames": len(frames), "bytes": len(stream),
                     "seconds_per_picture": secs / len(frames),
                     "types": "".join(s["type"] for s in enc.frame_stats),
                     "decoded_equals_recon": True, "de265": de265}
        if name == "py_fast_zerolatency":
            sp = enc._last_sao
            sao_ctus = int(((sp.type_y != 0) | (sp.type_c != 0)).sum())
            if not (sao_ctus and enc.param.deblock):
                fail(f"{phase} {name}: no SAO parameters or no deblock")
            out[name]["sao_ctus_last_frame"] = sao_ctus
    # the writers held equal (not decoded: the streams above are): native
    # walk (every TB its own), device residual, Python writer
    for name, params, frames in (
            ("three_way_medium", medium_cqp_params(w, h),
             make_clip(w, h, 3, seed=5)),
            ("tskip", medium_cqp_params(w, h, tskip="1"),
             testclip.make_screen_clip(w, h, 3, seed=3)),
            ("scaling_lists", medium_cqp_params(w, h, **{
                "scaling-list": "default"}), make_clip(w, h, 3, seed=11))):
        streams, secs = {}, {}
        for tag, attrs in (("native", {"use_tpu_residual": False}),
                           ("device", {}),
                           ("python", {"use_native": False,
                                       "use_tpu_residual": False})):
            if tag == "device" and name != "three_way_medium":
                continue
            enc, streams[tag], secs[tag], _ = switch_encode(
                f"{phase} {name} {tag}", params, frames, attrs,
                decode=False)
        if len(set(streams.values())) != 1:
            fail(f"{phase} {name}: the writers' streams differ "
                 f"({ {k: len(v) for k, v in streams.items()} } bytes)")
        cl = enc._last_analysis.cu_log2_map
        out[name] = {"frames": len(frames), "bytes": len(streams["native"]),
                     "streams_equal": sorted(streams),
                     "python_seconds_per_picture":
                         secs["python"] / len(frames),
                     "native_seconds_per_picture":
                         secs["native"] / len(frames),
                     "cu64_share_last_frame": float((cl == 6).mean())}
    # PART_NxN intra CUs: only the Python writer codes them
    frames = make_clip(w, h, 2, seed=7)
    stream, recons, secs = nxn_stream(w, h, frames)
    dec = HEVCDecoder(collect_stats=True)
    pics = dec.decode(stream)
    nxn = sum(1 for _p, _t, ev in dec.pic_stats for e in ev
              if e[2] == "intra_nxn")
    if nxn == 0 or len(pics) != len(frames):
        fail(f"{phase} nxn: {nxn} PART_NxN CUs in {len(pics)} pictures")
    _ts, de265 = decode_checked(f"{phase} nxn", stream, recons, len(frames))
    out["nxn"] = {"frames": len(frames), "bytes": len(stream),
                  "nxn_cus": nxn, "seconds_per_picture": secs / len(frames),
                  "decoded_equals_recon": True, "de265": de265}
    launches = dict(cuda_mc.launches)
    missing = [k for k, v in launches.items()
               if v == 0 and k not in OFF_PATH[phase]]
    if missing:
        fail(f"{phase}: kernels never launched: {missing}")
    emit(phase, card=card, size=f"{w}x{h}", launches=launches, **out)
    return launches


def tiles_path(card):
    """parallel/tiles.sharded_frame_analysis at 1088x1920 over four
    tiles of the card (tests/test_parallel.py's case at full width: a
    seeded texture and the reference moved 5 rows down, the top row
    repeated): the band step's min-SAD (kernel 5, a launch a band) equals
    the whole-frame dense minimum of the plain version on the card and is
    0 for every block off the bottom row; the frame cost equals the sum of
    the bands' costs to 1e-5; mesh.make_tile_mesh(4) raises on one card.
    Returns the launch counts and kernel 5's launches."""
    from x265_tpu_torch.parallel import mesh as pmesh
    from x265_tpu_torch.parallel.tiles import (make_tile_mesh,
                                               sharded_frame_analysis)
    phase, n_tiles, S, R, h = "tiles_1080p", 4, 16, 8, 1088
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (h, W)).astype(np.int32)
    ref = np.concatenate([np.repeat(y[:1], 5, axis=0), y[:-5]])
    mesh = make_tile_mesh(n_tiles, devices=[DEV] * n_tiles)
    if torch.cuda.device_count() < n_tiles:
        try:
            pmesh.make_tile_mesh(n_tiles)
            fail(f"{phase}: make_tile_mesh({n_tiles}) did not raise on "
                 f"{torch.cuda.device_count()} card(s)")
        except RuntimeError:
            pass
    sharded_frame_analysis(mesh, y, ref, S=S, R=R)        # warm-up
    torch.cuda.synchronize()
    cuda_mc.reset_launches()
    t0 = time.time()
    modes, icost, mcost, frame_cost = sharded_frame_analysis(mesh, y, ref,
                                                             S=S, R=R)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(cuda_mc.launches)
    if launches["sad_sweep_argmin"] != n_tiles or any(
            v for k, v in launches.items() if k != "sad_sweep_argmin"):
        fail(f"{phase}: launches {launches}, expected {n_tiles} of "
             "sad_sweep_argmin")
    cur = torch.from_numpy(y.astype(np.int16)).to(DEV)
    ref_pad = torch.from_numpy(np.pad(ref, R, mode="edge").astype(
        np.int16)).to(DEV)
    zero = torch.zeros(((2 * R + 1) ** 2,), dtype=torch.float32, device=DEV)
    _, whole = cuda_kernels.sad_sweep_argmin_plain(cur, ref_pad, zero, S, R)
    if not torch.equal(mcost, whole.to(torch.int32)):
        fail(f"{phase}: the bands' min-SAD != the whole-frame plain sweep")
    if int(mcost[:-1].max()) != 0:
        fail(f"{phase}: a block off the bottom row missed its 5-row shift")
    bands = np.minimum(icost.cpu().numpy().reshape(h // S, W // S),
                       mcost.cpu().numpy() * 2.0).reshape(
        n_tiles, -1).sum(axis=1, dtype=np.float64)
    fc = float(frame_cost)
    if not np.isfinite(fc) or abs(fc - bands.sum()) > 1e-5 * max(
            1.0, abs(bands.sum())):
        fail(f"{phase}: frame_cost {fc} != the bands' sum {bands.sum()}")
    if modes.shape[0] != (h // S) * (W // S):
        fail(f"{phase}: {modes.shape[0]} modes")
    emit(phase, card=card, size=f"{W}x{h}", tiles=n_tiles,
         devices=[str(d) for d in mesh.devices.flat], seconds=seconds,
         launches=launches, frame_cost=fc, band_costs=bands.tolist(),
         mcost_equals_whole_frame_plain=True,
         make_tile_mesh_raises_on_one_card=torch.cuda.device_count()
         < n_tiles)
    return launches, launches["sad_sweep_argmin"]


def mesh4_spy(seen):
    """setup of encode_1080p_medium_mesh4: attach four tiles of the card
    and count the mesh's intra analyses and motion-search bands."""
    from x265_tpu_torch.parallel import tiles

    def setup(enc):
        enc.attach_mesh(tiles.make_tile_mesh(4, devices=[DEV] * 4))
        intra, mesh_tiles = tiles.mesh_intra_decisions, me._mesh_tiles

        def count_intra(*a, **kw):
            seen["intra"] += 1
            return intra(*a, **kw)

        def count_tiles(mesh, nby):
            t = mesh_tiles(mesh, nby)
            seen["bands"] += len(t or ())
            return t
        tiles.mesh_intra_decisions = count_intra
        me._mesh_tiles = count_tiles
        seen["restore"] = lambda: (
            setattr(tiles, "mesh_intra_decisions", intra),
            setattr(me, "_mesh_tiles", mesh_tiles))
    return setup


def mesh4_check(seen):
    """encode_1080p_medium_mesh4's stream is encode_1080p_medium's, the
    mesh ran its intra analyses and banded searches, no device residual
    ran."""
    def check(enc, stream):
        seen.pop("restore")()
        want = PATH_STREAMS["encode_1080p_medium"]
        if stream != want:
            fail(f"encode_1080p_medium_mesh4: stream ({len(stream)} bytes) "
                 f"!= encode_1080p_medium's ({len(want)} bytes)")
        if not (seen["intra"] and seen["bands"]):
            fail(f"encode_1080p_medium_mesh4: the mesh did not run {seen}")
        if profiling.report().get("tpu_residual", {}).get("calls"):
            fail("encode_1080p_medium_mesh4: the device residual ran")
        return {"equals_encode_1080p_medium_stream": True,
                "mesh_intra_analyses": seen["intra"],
                "motion_search_bands": seen["bands"]}
    return check


def mesh4_refusal(frames):
    """Under a mesh with the device residual on, the first inter picture
    raises NotImplementedError naming the reference's fault."""
    from x265_tpu_torch.parallel.tiles import make_tile_mesh
    devcache.clear()
    enc = Encoder(medium_params(W, H))
    enc.attach_mesh(make_tile_mesh(4, devices=[DEV] * 4))
    try:
        enc.encode(frames)
    except NotImplementedError as e:
        if "_inter_multi" not in str(e):
            fail(f"encode_1080p_medium_mesh4: refusal names {e}")
        return "".join(s["type"] for s in enc.frame_stats)
    fail("encode_1080p_medium_mesh4: the device residual ran under a mesh")


def cpu_residual_check(enc, stream):
    """Config 3 with every TB quantized by the native walk: no device
    residual ran, and the stream is encode_1080p_medium's."""
    want = PATH_STREAMS["encode_1080p_medium"]
    if stream != want:
        fail(f"encode_1080p_medium_cpu_residual: stream ({len(stream)} "
             f"bytes) != encode_1080p_medium's ({len(want)} bytes)")
    if profiling.report().get("tpu_residual", {}).get("calls"):
        fail("encode_1080p_medium_cpu_residual: the device residual ran")
    return {"equals_encode_1080p_medium_stream": True}


def motion_api_path(card):
    """engine/me.py's standalone motion API at 1920x1080 on pictures 0-2
    of config 3's clip: motion_decide of picture 1 against picture 0 at
    merange 16 (the dense S=16, R=16 sweep on kernel 5's fused entry) and
    57 (the half-size sweep, then kernel 5's window entry), subme 0 and
    2 (kernel 3's fused gather + SATD); on the subme-2 bundles
    refine_with_mvp, smooth_mv_field, eval_mvs and bi_cost against a
    second bundle of picture 1 against picture 2 (kernel 3's blocks entry
    twice, kernel 4). The same calls with the plain versions on the card
    give the same mvs and costs exactly. Returns the launch counts and the
    dense R=16 sweep's launches."""
    phase = "motion_api_1080p"
    frames = list(clip_crowd1080(W, H, 3, seed=40))
    cur, ref0, ref1 = frames[1][0], frames[0][0], frames[2][0]

    def run():
        res, secs = {}, {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.time()
            res[name] = fn()
            torch.cuda.synchronize()
            secs[name] = time.time() - t
        for R in (16, 57):
            timed(f"R{R}_subme0", lambda: me.motion_decide(
                cur, ref0, W, H, S=16, R=R, qp=32, subme=0))
            timed(f"R{R}_subme2", lambda: me.motion_decide(
                cur, ref0, W, H, S=16, R=R, qp=32, subme=2,
                return_aux=True))
        timed("R16_subme2_list1", lambda: me.motion_decide(
            cur, ref1, W, H, S=16, R=16, qp=32, subme=2, return_aux=True))
        mv, cost, aux = res["R16_subme2"]
        mv1, _, aux1 = res["R16_subme2_list1"]
        mvp, mvp1 = me.mv_field_median3(mv), me.mv_field_median3(mv1)
        timed("refine_with_mvp", lambda: me.refine_with_mvp(aux, mv, mvp))
        timed("smooth_mv_field", lambda: me.smooth_mv_field(
            mv, cost, aux, aux["lam"]))
        timed("eval_mvs", lambda: me.eval_mvs(aux, mv))
        timed("bi_cost", lambda: me.bi_cost(mv, aux, mv1, aux1, mvp0=mvp,
                                            mvp1=mvp1))
        flat = {}
        for k, v in res.items():
            v = v if isinstance(v, tuple) else (v,)
            flat[k] = [np.asarray(x) for x in v if not isinstance(x, dict)]
        return flat, secs

    devcache.clear()
    dense = {"launches": 0, "shapes": set()}
    orig_search = me._int_search

    def counted(cur_t, ref_pad, mvcost, S, R):
        before = cuda_mc.launches["sad_sweep_argmin"]
        try:
            return orig_search(cur_t, ref_pad, mvcost, S, R)
        finally:
            if (S, R) == (16, 16):
                dense["launches"] += (cuda_mc.launches["sad_sweep_argmin"]
                                      - before)
            dense["shapes"].add((S, R))
    me._int_search = counted
    cuda_mc.reset_launches()
    try:
        got, secs = run()
    finally:
        me._int_search = orig_search
    launches = dict(cuda_mc.launches)
    missing = [k for k, v in launches.items()
               if v == 0 and k not in OFF_PATH[phase]]
    if missing:
        fail(f"{phase}: kernels never launched: {missing}")
    if dense["shapes"] != {(16, 16), (8, 29)}:
        fail(f"{phase}: the integer searches ran at {dense['shapes']}")
    with plain_versions():
        cuda_mc.reset_launches()
        t0 = time.time()
        want, _ = run()
        t_plain = time.time() - t0
        if any(cuda_mc.launches.values()):
            fail(f"{phase}: the plain-version run launched a kernel")
    for k in got:
        for a, b in zip(got[k], want[k]):
            if a.shape != b.shape or not np.array_equal(a, b):
                fail(f"{phase} {k}: the kernels' result != the plain "
                     "versions'")
    mv57 = got["R57_subme2"][0]
    emit(phase, card=card, size=f"{W}x{H}", seconds=secs,
         plain_seconds=t_plain, launches=launches,
         dense_r16_launches=dense["launches"],
         equals_plain="mvs and costs exact",
         mv57_range=[int(mv57.min()), int(mv57.max())],
         smoothed_blocks_changed=int(
             (got["smooth_mv_field"][0] != got["R16_subme2"][0]).any(
                 axis=-1).sum()))
    return launches, dense["launches"]


def intra_pred_phase(card):
    """models/intra_pred.predict_intra_batch (plain PyTorch: the JAX
    package reaches no Pallas kernel there) at a 1080p batch: 8160 blocks
    of 16x16, every mode, luma and chroma, strong smoothing on and off,
    some references unavailable; the card's prediction equals the CPU's
    exactly. Times the card's call (inputs on the card) and the CPU's."""
    from x265_tpu_torch.models.intra_pred import predict_intra_batch
    phase = "intra_pred_1080p"
    rng = np.random.default_rng(16)
    nt, N = 16, (H // 16 + 1) * (W // 16)
    R = 4 * nt + 1
    refs = rng.integers(0, 256, (N, R)).astype(np.int32)
    refs[::3] = 100 + np.arange(R) // 8
    avail = np.ones((N, R), bool)
    avail[::5, :R // 3] = False
    avail[::7, R // 2:] = False
    modes = (np.arange(N) % 35).astype(np.int32)
    out = {}
    dref, davail, dmodes = (to_dev(a) for a in (refs, avail, modes))
    for luma in (True, False):
        for strong in (False, True):
            a = (nt, 8, luma, strong)
            got = predict_intra_batch(dref, davail, dmodes, *a)
            t0 = time.time()
            want = predict_intra_batch(refs, avail, modes, *a,
                                       device="cpu")
            t_cpu = (time.time() - t0) * 1e3
            if not torch.equal(got.cpu(), want):
                fail(f"{phase}: the card's prediction != the CPU's "
                     f"(luma={luma}, strong={strong})")
            out[f"{'luma' if luma else 'chroma'}_strong{int(strong)}"] = {
                "ms": time_ms(lambda: predict_intra_batch(
                    dref, davail, dmodes, *a), 10),
                "cpu_ms": t_cpu}
    emit(phase, card=card, blocks=N, nt=nt, modes=35, max_abs_err=0,
         **out)


def ladder_2proc_path(card, n_frames):
    """BASELINE config 5 (tools/torch_ladder_worker.py): n_frames of the
    crowd clip at 3840x2160 into 3840x2160 at 12000 kbps, 1920x1080 at
    4000 and 1280x720 at 2400, x265's medium under config 3's ABR. First
    the three renditions one after another in this process (the launch
    counts of the phase), then two worker processes on the one card
    (torch.distributed, gloo: rank 0 the 4K and 720p renditions, rank 1
    the 1080p one), started after this process has built every kernel;
    every rendition's stream from the two equals this process's, and each
    stream's headers and frame types are checked. Reports both walls
    (each worker's from a common barrier to its last flush; the slower
    one is the two-process wall), their ratio and every rendition's
    seconds."""
    import importlib.util
    import socket
    phase = "ladder_2160p_2proc"
    spec = importlib.util.spec_from_file_location(
        "torch_ladder_worker", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "torch_ladder_worker.py"))
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    frames, size, rends = worker.ladder_spec("config5", n_frames)
    devcache.clear()
    cuda_mc.reset_launches()
    one, secs1, wall1, lad = worker.encode_shard(frames, size, rends, 0, 1)
    launches = dict(cuda_mc.launches)
    del frames
    missing = [k for k, v in launches.items()
               if v == 0 and k not in OFF_PATH[phase]]
    if missing:
        fail(f"{phase}: kernels never launched: {missing}")
    per = []
    for i, (w, h, kbps) in enumerate(rends):
        enc = lad.encoders[i]
        if (enc.sps.width, enc.sps.height) != (w, h):
            fail(f"{phase}: rendition {i} is {enc.sps.width}x"
                 f"{enc.sps.height}")
        # 8 frames: an I picture, P anchors and B pictures between them
        # (fewer than check_b_structure demands of 11)
        types = "".join(x["type"] for x in enc.frame_stats)
        heads = [(nal[0] >> 1) & 0x3F for nal in split_annexb(one[i])[:3]]
        if (heads != [32, 33, 34] or types[0] != "I" or "P" not in types
                or "B" not in types
                or len(first_slices(one[i])) != len(types)):
            fail(f"{phase} {w}x{h}: headers {heads}, types {types}")
        per.append({"size": f"{w}x{h}",
                    **encode_numbers(enc, one[i], secs1[i], kbps)})
    del lad
    devcache.clear()
    torch.cuda.empty_cache()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, spec.origin, "--coordinator",
             f"127.0.0.1:{port}", "--procs", str(LADDER_PROCS),
             "--proc-id", str(r), "--out", out_dir, "--ladder", "config5",
             "--frames", str(n_frames)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(LADDER_PROCS)]
        results = []
        try:
            for p in procs:
                so, se = p.communicate(timeout=600)
                if p.returncode != 0:
                    fail(f"{phase}: worker exited {p.returncode}: "
                         f"{se.decode(errors='replace')[-1500:]}")
                results.append(json.loads(so.decode().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        t_spawn = time.time() - t0
        for i in range(len(rends)):
            with open(os.path.join(out_dir, f"r{i}.hevc"), "rb") as f:
                two = f.read()
            if two != one[i]:
                fail(f"{phase}: rendition {per[i]['size']} from two "
                     f"processes ({len(two)} bytes) != one process's "
                     f"({len(one[i])} bytes)")
    wall2 = max(r["wall_seconds"] for r in results)
    emit(phase, card=card, source=f"{size[0]}x{size[1]}",
         source_frames=n_frames, one_process_seconds=wall1,
         two_process_seconds=wall2, two_over_one=wall2 / wall1,
         two_process_spawn_to_exit_seconds=t_spawn,
         streams_equal_across_processes=True, renditions=per,
         processes=[{"rank": r["rank"], "wall_seconds": r["wall_seconds"],
                     "renditions": r["renditions"],
                     "launches": r["launches"]} for r in results],
         launches=launches)
    return launches


def main():
    t_start = time.time()
    card = smi()
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- build
    cuda_build.get_lib()
    t0 = time.time()
    native.get_lib()
    emit("build", kernels_seconds=cuda_build.build_seconds,
         native_writer_seconds=time.time() - t0,
         ptxas=[l for l in cuda_build.build_log.splitlines()
                if "registers" in l or "spill" in l])

    # ---- the card's yardsticks, then the kernels against their plain
    # versions, on the card
    cal = calibration_phase()
    rows = kernel_phase()
    emit("kernels", kernels=sorted(rows), tolerance="exact (integer)",
         **{k: {"kernel_ms": v["ms"], "plain_ms": v["plain_ms"],
                "shape": v["shape"], "max_abs_err": v["max_abs_err"],
                **{x: v[x] for x in ("library_ms", "cold_l2_ms",
                                     "coherent_ms", "wide_ms") if v.get(x)},
                # the other shapes of the path, timed so far
                **{x: {"kernel_ms": v[x]["ms"]} for x in SHAPES_ON_PATH
                   if x in v}}
            for k, v in rows.items()})

    if "--kernels-only" in sys.argv[1:]:
        return      # a short first call for a new kernel: no result line

    # ---- small encodes, decoded back by the port's decoder
    for label, params, frames in (
            ("ultrafast_zerolatency", slice_params(416, 240),
             make_clip(416, 240, 6, seed=3)),
            ("fast_zerolatency", filtered_params(416, 240),
             make_ramp_clip(416, 240, 6, seed=3))):
        enc, stream, t_enc = encode_and_decode("encode_small " + label,
                                               params, frames)
        if not np.any(enc._last_analysis.mv8):
            fail(f"encode_small {label}: the motion field is all zero")
        extra = {}
        if label == "fast_zerolatency":
            extra = check_filtered(enc, "encode_small " + label)
        emit("encode_small", config=label, frames=len(frames),
             bytes=len(stream), encode_seconds=t_enc,
             decoded_equals_recon=True,
             types="".join(s["type"] for s in enc.frame_stats), **extra)
    # x265's default (medium, no tune, ABR): B frames, decoded back
    frames = list(clip_crowd1080(416, 240, 11, seed=40))
    enc, stream, t_enc = encode_and_decode(
        "encode_small medium", medium_params(416, 240), frames)
    types, vcl = check_b_structure("encode_small medium", enc, stream)
    emit("encode_small", config="medium", frames=len(frames),
         bytes=len(stream), encode_seconds=t_enc, decoded_equals_recon=True,
         types=types, slice_nal_types=vcl,
         frame_pocs=[s["poc"] for s in enc.frame_stats],
         frame_qps=[s["qp"] for s in enc.frame_stats])

    # Main10 with the default scaling lists (medium at its default CRF 28,
    # B frames), decoded back by the port's decoder
    frames = lift10(clip_crowd1080(416, 240, 11, seed=40), 40)
    p = param_default_preset("medium")
    param_parse(p, "output-depth", "10")
    param_parse(p, "scaling-list", "default")
    p.width, p.height = 416, 240
    enc, stream, t_enc = encode_and_decode("encode_small main10", p, frames)
    if not (enc.sps.bit_depth == 10 and enc.sps.scaling_list_enabled):
        fail("encode_small main10: not a Main10 stream with scaling lists")
    types, vcl = check_b_structure("encode_small main10", enc, stream)
    emit("encode_small", config="main10", frames=len(frames),
         bytes=len(stream), encode_seconds=t_enc, decoded_equals_recon=True,
         types=types, frame_qps=[s["qp"] for s in enc.frame_stats])

    # the steered encodes at the same size: two passes, qpfile + zones, a
    # two-rendition ladder
    small_steered_phases()
    # the stream-structure options, the checked encode and a bad QP
    small_structure_phases()
    # the reference switches: the numpy analysis, the Python writer, the
    # native walk's own quantization, the NxN oracle stream
    switch_launches = reference_switches_phase(card)

    # ---- golden streams: the card against the JAX package's digests
    golden_phase()

    # ---- bench.py config 1: 720p all-intra lossless, decoded to the source
    launches_by_path = {"encode_720p_lossless": lossless_path(card),
                        "reference_switches": switch_launches}
    dense_by_path = {}

    # ---- the main paths through Encoder.encode: at 1080p 8 frames each,
    # and 11 (an I picture and two mini-GOPs) for bench.py's config 3 and
    # for the slow preset under its rate control
    for phase, params_fn, frames, types, stages in (
            ("encode_1080p", slice_params, make_clip(W, H, 8, seed=11),
             "IPPPPPPP", ()),
            ("encode_1080p_filtered", filtered_params,
             make_ramp_clip(W, H, 8, seed=11, step=0.05), "IPPPPPPP",
             ("loopfilter", "sao_analyze")),
            ("encode_1080p_live", live_params,
             make_cut_clip(W, H, 8, seed=11, cut=4), "IPPPIPPP",
             ("lookahead", "rd_adopt", "rd_promote")),
            ("encode_1080p_medium", medium_params,
             list(clip_crowd1080(W, H, 11, seed=40)), None,
             ("slicetype", "lookahead", "motion", "rd_adopt", "rd_promote",
              "loopfilter", "finalize")),
            ("encode_1080p_slow", slow_params,
             list(clip_crowd1080(W, H, 11, seed=40)), None,
             ("slicetype", "lookahead", "motion", "rd_adopt", "rd_promote",
              "tpu_residual", "loopfilter", "finalize"))):
        plain = ("prefix" if types is not None else
                 "whole" if phase == "encode_1080p_medium" else
                 "first_minigop")
        log, seen = [], {}

        def kernel_passes(enc, stream):
            # the kernels' encode is over; the plain versions' comes next
            seen["passes"] = list(log)
            return {"pair_passes": seen["passes"]}
        with pair_passes(log):
            launches_by_path[phase], dense_by_path[phase] = main_path(
                phase, params_fn, frames, card, types, stages, plain=plain,
                check=kernel_passes)
        if phase == "encode_1080p_medium":
            pair_window_phase(card, rows, seen["passes"])

    # ---- config 3 with every TB quantized by the native walk
    # (use_tpu_residual = False): encode_1080p_medium's stream, byte for
    # byte; its fps and finalize seconds beside config 3's
    launches_by_path["encode_1080p_medium_cpu_residual"], _ = main_path(
        "encode_1080p_medium_cpu_residual", medium_params,
        list(clip_crowd1080(W, H, 11, seed=40)), card, None,
        ("slicetype", "lookahead", "motion", "rd_adopt", "rd_promote",
         "loopfilter", "finalize"),
        plain=None, check=cpu_residual_check,
        attrs={"use_tpu_residual": False})
    emit("switch_paths", card=card, **{
        k: PATH_NUMBERS[k] for k in ("encode_1080p_medium",
                                     "encode_1080p_medium_cpu_residual")})

    # ---- parallel/: the band step at 1088x1920 over four tiles of the
    # card, then config 3 without the device residual under a mesh of four
    # tiles (encode_1080p_medium's stream, byte for byte), beside the
    # unsharded runs; with the device residual a mesh encode is refused
    launches_by_path["tiles_1080p"], dense_by_path["tiles_1080p"] = \
        tiles_path(card)
    seen = {"intra": 0, "bands": 0}
    frames = list(clip_crowd1080(W, H, 11, seed=40))
    launches_by_path["encode_1080p_medium_mesh4"], _ = main_path(
        "encode_1080p_medium_mesh4", medium_params, frames, card, None,
        ("slicetype", "lookahead", "motion", "rd_adopt", "rd_promote",
         "loopfilter", "finalize"),
        plain=None, check=mesh4_check(seen), setup=mesh4_spy(seen),
        attrs={"use_tpu_residual": False})
    refused_after = mesh4_refusal(frames[:4])
    del frames
    emit("mesh_paths", card=card, device_residual_refused_after=refused_after,
         launches={k: launches_by_path[k] for k in (
             "encode_1080p_medium_cpu_residual", "encode_1080p_medium_mesh4")},
         **{k: PATH_NUMBERS[k] for k in (
             "encode_1080p_medium", "encode_1080p_medium_cpu_residual",
             "encode_1080p_medium_mesh4")})

    # ---- the stream-structure paths at 1080p: the live encode with the
    # robustness options (8 frames of the live clip, its picture 2 a copy
    # of picture 1, so 7 are coded), and config 3 sliced in four with
    # transform skip and noise reduction (11 frames of the crowd clip)
    live = make_cut_clip(W, H, 8, seed=11, cut=4)
    live[2] = tuple(pl.copy() for pl in live[1])
    log, offsets, recons = [], [], {}
    launches_by_path["encode_1080p_live_robust"], _ = main_path(
        "encode_1080p_live_robust", live_robust_params, live, card,
        "IPBIPBP", ("lookahead", "rd_adopt", "rd_promote", "finalize"),
        prefix=4, check=live_robust_checks(log), setup=refresh_spy(log))
    del live, log
    launches_by_path["encode_1080p_medium_slices"], _ = main_path(
        "encode_1080p_medium_slices", medium_slices_params,
        list(clip_crowd1080(W, H, 11, seed=40)), card, None,
        ("slicetype", "lookahead", "motion", "rd_adopt", "rd_promote",
         "loopfilter", "finalize"), plain="first_minigop",
        check=medium_slices_checks(offsets, recons),
        setup=slices_spy(offsets, recons))
    del recons
    # the stage seconds of the two beside the paths they extend, from this
    # call
    emit("structure_paths", card=card, **{
        k: PATH_NUMBERS[k] for k in (
            "encode_1080p_live", "encode_1080p_live_robust",
            "encode_1080p_medium", "encode_1080p_medium_slices")})

    # ---- BASELINE config 4 at 3840x2160: Main10, slow, scaling lists,
    # HDR10 and HDR10+ metadata (a file in a temporary directory), 11
    # frames of bench.py's crowd clip at 4K lifted to 10 bits
    phase, n4k = "encode_2160p_main10_hdr10", 11
    with tempfile.TemporaryDirectory() as tmp:
        meta = testclip.write_dhdr10_json(
            os.path.join(tmp, "hdr10plus.json"), n4k)
        frames = lift10(clip_crowd1080(W4K, H4K, n4k, seed=40), 40)
        launches_by_path[phase], dense_by_path[phase] = main_path(
            phase, lambda w, h: main10_params(w, h, meta), frames, card,
            None, ("slicetype", "lookahead", "motion", "rd_adopt",
                   "rd_promote", "tpu_residual", "loopfilter", "finalize"),
            plain="first_minigop", size=(W4K, H4K),
            check=check_main10_hdr10(phase, n4k))
        del frames

    # ---- the steered encodes at 1080p, on config 3's clip: two passes,
    # analysis save/load with the --scale-factor 2 chain, the ABR ladder
    frames = list(clip_crowd1080(W, H, 11, seed=40))
    launches_by_path["encode_1080p_twopass"], _ = twopass_path(card, frames)
    launches_by_path["encode_1080p_analysis_reuse"] = analysis_reuse_path(
        card, frames)
    launches_by_path["ladder_1080p"] = ladder_path(card, frames)
    del frames

    # ---- the standalone motion API and the batched intra prediction at
    # 1080p, against the plain versions and the CPU
    launches_by_path["motion_api_1080p"], dense_by_path[
        "motion_api_1080p"] = motion_api_path(card)
    intra_pred_phase(card)

    # ---- BASELINE config 5: the ABR ladder at 2160p/1080p/720p in one
    # process, then across two processes on the card
    # (8 frames of the worker's 11: chip_smoke.py's time)
    launches_by_path["ladder_2160p_2proc"] = ladder_2proc_path(card, 8)

    # ---- the kernels' table (launches: the main paths' runs together,
    # each path's own count beside it; the lossless path launches none).
    # Off the table: the entries no main path runs.
    table, off_path = [], []
    off_every_path = set.intersection(*(set(v) for v in OFF_PATH.values()))
    for name, r in rows.items():
        row = {
            "name": name, "route": "cuda", "source": META[name][0],
            "replaces": META[name][1],
            "launches": sum(v[name] for v in launches_by_path.values()),
            "launches_by_path": {k: v[name]
                                 for k, v in launches_by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], **bounds(r, cal),
            "library_ms": r["library_ms"], "shape": r["shape"]}
        for k in ("cold_l2_ms", "coherent_ms", "wide_ms",
                  "max_abs_err_10bit"):
            if k in r:
                row[k] = r[k]
        for key in SHAPES_ON_PATH:
            if key in r:
                # the same kernel at another shape of the path, timed and
                # bounded as above
                sub = r[key]
                row[key] = {
                    **{k: sub[k] for k in ("shape", "max_abs_err",
                                           "max_abs_err_10bit", "ms",
                                           "plain_ms", "cold_l2_ms",
                                           "wide_ms", "library_ms")
                       if k in sub},
                    **bounds(sub, cal)}
                if key in DENSE_PATH:
                    # the launches of the dense search alone
                    row[key]["launches"] = dense_by_path[DENSE_PATH[key]]
        (off_path if name in off_every_path else table).append(row)
    print(json.dumps({"kernels": table,
                      "entries_off_the_main_path": off_path,
                      "calibration": cal}), flush=True)
    emit("done", total_seconds=time.time() - t_start)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
