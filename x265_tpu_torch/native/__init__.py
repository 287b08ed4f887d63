"""Native (C++) components, built lazily with g++ and loaded via ctypes.

The slice writer is the framework's serial native finalizer (SURVEY.md
§7.2): decision tensors in, CABAC slice bytes out. Python reference
implementations remain the behavioral oracle (differential-tested).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "..", "build")
_SO = os.path.join(_BUILD, "libx265torch_writer.so")
_SRC = os.path.join(_DIR, "slice_writer.cpp")
_HDR = os.path.join(_DIR, "tables_gen.h")
_lock = threading.Lock()
_lib = None


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    mt = os.path.getmtime
    return mt(_SO) < max(mt(_SRC), mt(_HDR))


def _build() -> None:
    """Compile the slice writer with g++ into the package's build/
    directory. tables_gen.h is a checked-in source; it is never
    regenerated here. Raises on a failed build: there is no Python
    writer to drop to on the encode path."""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-funroll-loops", "-fPIC",
           "-shared", "-std=c++17", "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("native slice writer build failed:\n" + r.stderr)
    os.replace(tmp, _SO)      # atomic: concurrent builds never load half a file


def get_lib():
    """Load (building at first use) the native library; raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _needs_build():
            _build()
        lib = ctypes.CDLL(_SO)
        lib.encode_slice_intra.restype = ctypes.c_int
        lib.encode_slice_intra.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # planes
            ctypes.c_int, ctypes.c_int,                          # w, h
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # maps
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # ctb, mincb, qp
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # lossless, sdh, strong
            ctypes.c_int, ctypes.c_int,                          # cb/cr qp off
            ctypes.c_void_p, ctypes.c_int,                       # out, cap
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # recon out
        ]
        lib.encode_slice_px.restype = ctypes.c_int
        lib.encode_slice_px.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # src planes
            ctypes.c_int, ctypes.c_int,                          # w, h
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # cu/luma/chroma maps
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # inter8/dir8/mv8
            ctypes.c_void_p,                                     # ref8
            ctypes.c_int, ctypes.c_int,                          # slice_type, max_merge
            ctypes.c_void_p, ctypes.c_void_p,                    # ref planes/pocs
            ctypes.c_int, ctypes.c_int,                          # nref0/nref1
            ctypes.c_int, ctypes.c_int,                          # pad, cur_poc
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # ctb, mincb, qp
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # lossless, sdh, strong
            ctypes.c_int, ctypes.c_int,                          # cb/cr qp off
            ctypes.c_int, ctypes.c_int,                          # sao luma/chroma
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # sao y maps
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # sao c maps
            ctypes.c_void_p, ctypes.c_void_p,                    # sao c offsets
            ctypes.c_void_p, ctypes.c_void_p,                    # qp map in/out
            ctypes.c_int, ctypes.c_int,                          # bit depth, rdoq
            ctypes.c_void_p,                                     # scratch
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # recon in/out
            ctypes.c_void_p,                                     # cbf4 out
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,         # weights, denoms
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # col dir/mv/refpoc
            ctypes.c_int, ctypes.c_int,                          # col poc, from_l0
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # nr off/sum/cnt
            ctypes.c_int, ctypes.c_int,                          # ctb begin/count
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # pre lvl y/cb/cr
            ctypes.c_void_p, ctypes.c_void_p,                    # pre cbf8/has8
            ctypes.c_int,                                        # collect_only
            ctypes.c_int,                                        # scaling_lists
            ctypes.c_int,                                        # tskip
            ctypes.c_void_p,                                     # rate consts
            ctypes.c_int,                                        # wpp
            ctypes.c_void_p, ctypes.c_int,                       # ss sizes out, cap
            ctypes.c_int,                                        # psy_rdoq_fx
            ctypes.c_void_p, ctypes.c_int,                       # pre tusplit8, max_trafo_inter
            ctypes.c_void_p,                                     # cu counts
        ]
        lib.writer_scratch_new.restype = ctypes.c_void_p
        lib.writer_scratch_new.argtypes = []
        lib.writer_scratch_free.restype = None
        lib.writer_scratch_free.argtypes = [ctypes.c_void_p]
        lib.writer_scratch_bytes.restype = ctypes.c_void_p
        lib.writer_scratch_bytes.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def encode_slice_intra(src_y, src_cb, src_cr, cu_log2_map, luma_mode8,
                       chroma_mode8, ctb_log2, min_cb_log2, qp,
                       lossless, sign_hiding, strong_smooth,
                       cb_qp_off=0, cr_qp_off=0, want_recon=False):
    """Native slice-data encode; returns bytes (or (bytes, recon) when
    want_recon)."""
    lib = get_lib()
    h, w = src_y.shape
    y = np.ascontiguousarray(src_y, dtype=np.uint8)
    cbp = np.ascontiguousarray(src_cb, dtype=np.uint8)
    crp = np.ascontiguousarray(src_cr, dtype=np.uint8)
    cmap = np.ascontiguousarray(cu_log2_map, dtype=np.int32)
    lmap = np.ascontiguousarray(luma_mode8, dtype=np.int32)
    if chroma_mode8 is not None:
        cmode = np.ascontiguousarray(chroma_mode8, dtype=np.int32)
        cmode_p = cmode.ctypes.data
    else:
        cmode_p = None
    cap = w * h * 4 + 4096
    out = np.empty(cap, dtype=np.uint8)
    if want_recon:
        ry = np.empty((h, w), dtype=np.int16)
        rcb = np.empty((h // 2, w // 2), dtype=np.int16)
        rcr = np.empty((h // 2, w // 2), dtype=np.int16)
        rp = (ry.ctypes.data, rcb.ctypes.data, rcr.ctypes.data)
    else:
        rp = (None, None, None)
    n = lib.encode_slice_intra(
        y.ctypes.data, cbp.ctypes.data, crp.ctypes.data, w, h,
        cmap.ctypes.data, lmap.ctypes.data, cmode_p,
        ctb_log2, min_cb_log2, qp,
        int(lossless), int(sign_hiding), int(strong_smooth),
        cb_qp_off, cr_qp_off,
        out.ctypes.data, cap, *rp)
    if n < 0:
        raise RuntimeError(f"native slice writer failed (code {n})")
    data = out[:n].tobytes()
    if want_recon:
        return data, (ry.astype(np.int32), rcb.astype(np.int32),
                      rcr.astype(np.int32))
    return data


class Scratch:
    """What the native walk keeps between calls: its 4x4-grid maps and
    CABAC output keep their storage, so a walk in steady state allocates
    nothing. One per encoder and slice band (bands walk on threads: never
    hand one Scratch to two walks at once)."""

    def __init__(self):
        self._lib = get_lib()
        self.ptr = self._lib.writer_scratch_new()

    def __del__(self):
        ptr, self.ptr = getattr(self, "ptr", None), None
        if ptr:
            self._lib.writer_scratch_free(ptr)

    def __copy__(self):             # a copy shares no storage (no double free)
        return Scratch()

    def __deepcopy__(self, memo):
        return Scratch()


def encode_slice_px(src_y, src_cb, src_cr, cu_log2_map, luma_mode8,
                    chroma_mode8, inter8, dir8, mv8, slice_type,
                    max_merge_cand, refs, ref_poc, cur_poc, pad_luma,
                    ctb_log2, min_cb_log2, qp, lossless, sign_hiding,
                    strong_smooth, cb_qp_off=0, cr_qp_off=0,
                    sao_params=None, sao_luma=False, sao_chroma=False,
                    qp_map=None, bit_depth=8, ref8=None, rdoq_level=0,
                    weights=None, col=None, col_from_l0=1, nr=None,
                    pre=None, ctb_begin=0, ctb_count=-1,
                    collect=False, scaling_lists=False, tskip=False,
                    wpp=False, psy_rdoq_fx=0, tu_inter_depth=1,
                    recon=None, want_recon=True, cbf4_out=None, qp_out=None,
                    scratch=None, cu_counts=None):
    """Unified native I/P/B slice encode. It works in place: the planes
    and maps it writes (recon, pre's planes, cbf4_out, qp_out) are
    written where they are, never copied.

    refs: ([(y,cb,cr) padded int16 per ref] per list), up to 4 refs/list.
    weights: optional (wp[4,3,3] int32 flag/w/off per L0 ref x plane,
    luma_denom, chroma_denom) — explicit P-slice weighted prediction
    (pred_weight_table, 8.5.4.2.3.2).
    col: optional ColCtx (inter_tools) — 16x16 collocated motion for
    TMVP (8.5.3.2.7-8.5.3.2.9).
    nr: optional (offsets u16[16,1024], sums u32[16,1024], counts u32[16])
    DCT-domain noise reduction; sums/counts accumulate in place.
    pre: optional precomputed residual tensors from the device pipeline
    (models/inter_residual.build_inter_pre) — dict with lvl_y/lvl_cb/
    lvl_cr int16 planes, cbf8 uint8 [h8,w8] (bit0=y,1=cb,2=cr), has8
    uint8 [h8,w8], optionally tusplit8 uint8 [h8,w8]. CUs with has8=1 are
    emit-only.
    collect: the walk runs with CABAC disabled (collect-only) and exports
    every TB it computes into pre's planes (C-contiguous, of those
    dtypes; all-zero ones where nothing is precomputed), so a later
    emit-only call replays every TB from the same dict (the single-CABAC
    SAO pipeline; sao.cpp:1225 derives SAO from stats, not re-encode).
    recon: (y, cb, cr) int16 C-contiguous planes the walk reconstructs
    into: the precomputed CUs' recon is there already, the walk writes
    every other CU's. None: zeroed planes of its own.
    want_recon=False: an emit-only replay (every CU precomputed), which
    writes no sample and no map: recon, cbf4 and qp_actual come back None.
    cbf4_out (uint8 [h4,w4]), qp_out (int32 [h4,w4]): the maps to write
    the band's entries into (the bands of one picture share them); None:
    maps of its own.
    scratch: a Scratch (None: one for this call).
    cu_counts: optional int32 [2] array; += the CUs walked and those of
    them reconstructed here (not from pre).
    The source planes are read as uint16: hand them over in that form to
    save a conversion a call.
    Returns (bytes, recon, cbf4 (bool), qp_actual), and the WPP
    substream sizes after them under wpp.
    """
    lib = get_lib()
    h, w = src_y.shape
    c = np.ascontiguousarray
    y = c(src_y, dtype=np.uint16)
    cbp = c(src_cb, dtype=np.uint16)
    crp = c(src_cr, dtype=np.uint16)
    if scratch is None:
        scratch = Scratch()
    cmap = c(cu_log2_map, dtype=np.int32)
    lmap = c(luma_mode8, dtype=np.int32)
    cmode_p = None
    if chroma_mode8 is not None:
        cmode = c(chroma_mode8, dtype=np.int32)
        cmode_p = cmode.ctypes.data
    keep = []          # keep arrays alive across the call

    ref_ptr_arr = (ctypes.c_void_p * 24)()
    ref_poc_arr = np.zeros(8, dtype=np.int32)
    nrefs = [0, 0]
    for lx in (0, 1):
        lst = refs[lx] if lx < len(refs) else []
        nrefs[lx] = min(4, len(lst))
        for r in range(nrefs[lx]):
            planes = tuple(c(pl, dtype=np.int16) for pl in lst[r])
            keep.extend(planes)
            for pl in range(3):
                ref_ptr_arr[(lx * 4 + r) * 3 + pl] = planes[pl].ctypes.data
            if ref_poc[lx]:
                ref_poc_arr[lx * 4 + r] = ref_poc[lx][r]
    i8 = c(inter8, dtype=np.uint8) if inter8 is not None else None
    d8 = c(dir8, dtype=np.int32) if dir8 is not None else None
    m8 = c(mv8, dtype=np.int32) if mv8 is not None else None
    r8 = c(ref8, dtype=np.int32) if ref8 is not None else None
    h4, w4 = (h + 3) // 4, (w + 3) // 4

    def inplace(a, shape, dt, what):
        if not (a.dtype == dt and a.shape == shape
                and a.flags["C_CONTIGUOUS"] and a.flags["WRITEABLE"]):
            raise ValueError(f"{what}: a writeable C-contiguous "
                             f"{np.dtype(dt).name} array of shape {shape}")
        return a
    cbf4 = qp_actual = None
    rec_ptrs = [None] * 3
    if want_recon:
        if recon is None:
            recon = (np.zeros((h, w), np.int16),
                     np.zeros((h // 2, w // 2), np.int16),
                     np.zeros((h // 2, w // 2), np.int16))
        recon = tuple(inplace(pl, s, np.int16, "recon") for pl, s in zip(
            recon, ((h, w), (h // 2, w // 2), (h // 2, w // 2))))
        rec_ptrs = [pl.ctypes.data for pl in recon]
        cbf4 = (np.empty((h4, w4), np.uint8) if cbf4_out is None
                else inplace(cbf4_out, (h4, w4), np.uint8, "cbf4_out"))
        qp_actual = (np.empty((h4, w4), np.int32) if qp_out is None
                     else inplace(qp_out, (h4, w4), np.int32, "qp_out"))
    else:
        recon = None
    sao_ptrs = [None] * 8
    if sao_params is not None:
        sp = sao_params
        arrs = [sp.type_y, sp.class_y, sp.off_y, sp.type_c,
                sp.class_cb, sp.class_cr, sp.off_cb, sp.off_cr]
        for i, a in enumerate(arrs):
            a = c(a, dtype=np.int32)
            keep.append(a)
            sao_ptrs[i] = a.ctypes.data
    wp_ptr, wp_ld, wp_cd = None, 0, 0
    if weights is not None:
        wp_arr = c(weights[0], dtype=np.int32)
        keep.append(wp_arr)
        wp_ptr, wp_ld, wp_cd = wp_arr.ctypes.data, weights[1], weights[2]
    pre_ptrs = [None] * 5
    tus_ptr = None
    if collect and pre is None:
        raise ValueError("a collect-only walk exports into pre's planes")
    if pre is not None:
        h8, w8 = h >> 3, w >> 3
        shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2), (h8, w8),
                  (h8, w8))
        order = ("lvl_y", "lvl_cb", "lvl_cr", "cbf8", "has8")
        dts = (np.int16, np.int16, np.int16, np.uint8, np.uint8)
        for i, (k, s, dt) in enumerate(zip(order, shapes, dts)):
            a = inplace(pre[k], s, dt, f"pre[{k!r}]")
            pre_ptrs[i] = a.ctypes.data
        if pre.get("tusplit8") is not None:
            ta = c(pre["tusplit8"], dtype=np.uint8)
            keep.append(ta)
            tus_ptr = ta.ctypes.data
    nro_p = nrs_p = nrc_p = None
    if nr is not None:
        assert nr[0].dtype == np.uint16 and nr[1].dtype == np.uint32 \
            and nr[2].dtype == np.uint32
        nro_p, nrs_p, nrc_p = (nr[0].ctypes.data, nr[1].ctypes.data,
                               nr[2].ctypes.data)
    cd_ptr = cm_ptr = cp_ptr = None
    col_poc = 0
    if col is not None:
        cda = c(col.dir16, dtype=np.int32)
        cma = c(col.mv16, dtype=np.int32)
        cpa = c(col.refpoc16, dtype=np.int32)
        keep.extend((cda, cma, cpa))
        cd_ptr, cm_ptr, cp_ptr = (cda.ctypes.data, cma.ctypes.data,
                                  cpa.ctypes.data)
        col_poc = col.poc
    qmp = None
    if qp_map is not None:
        qm = c(qp_map, dtype=np.int32)
        keep.append(qm)
        qmp = qm.ctypes.data
    rc_ptr = None
    if rdoq_level > 0 and not lossless:
        # estBit fractional-bit RDOQ constants (hevc/rate_model.py):
        # identical derivation feeds the oracle and device paths, so
        # the three implementations keep deciding byte-identically
        from x265_tpu_torch.hevc.rate_model import slice_rate_consts
        rc = np.ascontiguousarray(slice_rate_consts(slice_type, qp))
        keep.append(rc)
        rc_ptr = rc.ctypes.data
    ss_sizes = None
    if wpp:
        hc = -(-h // (1 << ctb_log2))
        ss_sizes = np.zeros(hc, dtype=np.int32)
    if cu_counts is not None:
        cu_counts = inplace(cu_counts, (2,), np.int32, "cu_counts")
    n = lib.encode_slice_px(
        y.ctypes.data, cbp.ctypes.data, crp.ctypes.data, w, h,
        cmap.ctypes.data, lmap.ctypes.data, cmode_p,
        i8.ctypes.data if i8 is not None else None,
        d8.ctypes.data if d8 is not None else None,
        m8.ctypes.data if m8 is not None else None,
        r8.ctypes.data if r8 is not None else None,
        slice_type, max_merge_cand,
        ref_ptr_arr, ref_poc_arr.ctypes.data,
        nrefs[0], nrefs[1],
        pad_luma, cur_poc,
        ctb_log2, min_cb_log2, qp,
        int(lossless), int(sign_hiding), int(strong_smooth),
        cb_qp_off, cr_qp_off,
        int(sao_luma), int(sao_chroma), *sao_ptrs,
        qmp, None if qp_actual is None else qp_actual.ctypes.data,
        bit_depth, rdoq_level, scratch.ptr, *rec_ptrs,
        None if cbf4 is None else cbf4.ctypes.data, wp_ptr, wp_ld, wp_cd,
        cd_ptr, cm_ptr, cp_ptr, col_poc, int(col_from_l0),
        nro_p, nrs_p, nrc_p, int(ctb_begin), int(ctb_count), *pre_ptrs,
        int(bool(collect)), int(scaling_lists), int(tskip),
        rc_ptr, int(wpp),
        ss_sizes.ctypes.data if ss_sizes is not None else None,
        len(ss_sizes) if ss_sizes is not None else 0,
        int(psy_rdoq_fx), tus_ptr, int(tu_inter_depth) - 1,
        None if cu_counts is None else cu_counts.ctypes.data)
    if n < 0:
        raise RuntimeError(f"native slice writer failed (code {n})")
    data = (ctypes.string_at(lib.writer_scratch_bytes(scratch.ptr), n)
            if n else b"")
    res = (data,
           recon, None if cbf4 is None else cbf4.view(bool), qp_actual)
    if wpp:
        return res + (ss_sizes.tolist(),)
    return res
