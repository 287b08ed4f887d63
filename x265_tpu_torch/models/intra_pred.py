"""Exact batched intra prediction — device side of the finalizer split.

Reproduces the native finalizer's reference-sample handling and 35-mode
prediction (slice_writer.cpp get_ref_samples/filter_refs/predict_intra;
spec 8.4.4.2) bit-exactly as batched gathers:

Every predicted sample of every mode is expressible as
    pred[p] = clip0( (sum_t w[m,p,t] * refx[idx[m,p,t]] + rnd[m,p])
                     >> shift[m,p] )
over an extended reference vector refx = [ref (4nt+1 samples), dc], with
per-(mode, position) 4-sparse integer weight tables built once in numpy
(the intra_pred_allangs idea, reference intrapred.cpp:32-240, recast as
table-driven gathers). The data-dependent parts (reference sample
substitution, strong-smoothing condition, DC value) are computed per
block on the device, in int32 throughout. Plain PyTorch: the JAX
package reaches no Pallas kernel here.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from x265_tpu_torch.hevc.tables import INTRA_PRED_ANGLE
from x265_tpu_torch.models.intra_frame import first_argmin
from x265_tpu_torch.utils.device import resolve_device


def _filter_flag(mode: int, log2: int) -> bool:
    if mode in (1, 10, 26) or log2 == 2:
        return False
    if mode == 0:
        return True
    d = min(abs(mode - 26), abs(mode - 10))
    thresh = 7 if log2 == 3 else (1 if log2 == 4 else 0)
    return d > thresh


@lru_cache(maxsize=16)
def build_pred_tables(nt: int, luma: bool):
    """4-sparse prediction tables for all 35 modes at one TU size.

    Returns (idx [35,nt*nt,4] int32 into refx[R+1] (slot R = dc),
    w [35,nt*nt,4] int32, rnd [35,nt*nt] int32, shift [35,nt*nt] int32,
    filt [35] bool).
    """
    n2 = 2 * nt
    corner = n2
    R = 4 * nt + 1
    DC = R                      # index of the dc pseudo-sample
    log2 = nt.bit_length() - 1
    np_idx = np.zeros((35, nt * nt, 4), np.int32)
    np_w = np.zeros((35, nt * nt, 4), np.int32)
    np_rnd = np.zeros((35, nt * nt), np.int32)
    np_shift = np.zeros((35, nt * nt), np.int32)

    def topp(i):
        return corner + 1 + i

    def leftv(y):
        return n2 - 1 - y

    # mode 0: planar
    for y in range(nt):
        for x in range(nt):
            p = y * nt + x
            np_idx[0, p] = (leftv(y), topp(nt), topp(x), leftv(nt))
            np_w[0, p] = (nt - 1 - x, x + 1, nt - 1 - y, y + 1)
            np_rnd[0, p] = nt
            np_shift[0, p] = log2 + 1

    # mode 1: DC (+ luma edge filtering for nt < 32)
    np_idx[1, :, 0] = DC
    np_w[1, :, 0] = 1
    if luma and nt < 32:
        for x in range(1, nt):
            np_idx[1, x] = (topp(x), DC, 0, 0)
            np_w[1, x] = (1, 3, 0, 0)
            np_rnd[1, x] = 2
            np_shift[1, x] = 2
        for y in range(1, nt):
            p = y * nt
            np_idx[1, p] = (leftv(y), DC, 0, 0)
            np_w[1, p] = (1, 3, 0, 0)
            np_rnd[1, p] = 2
            np_shift[1, p] = 2
        np_idx[1, 0] = (leftv(0), DC, topp(0), 0)
        np_w[1, 0] = (1, 2, 1, 0)
        np_rnd[1, 0] = 2
        np_shift[1, 0] = 2

    # modes 2..34: angular
    for mode in range(2, 35):
        angle = int(INTRA_PRED_ANGLE[mode - 2])
        vertical = mode >= 18
        main_src = np.zeros(2 * n2 + 8, np.int32)
        if angle < 0:
            ia = 8192.0 / angle
            inv = -256 if angle == -32 else int(ia + (0.5 if ia >= 0 else -0.5))
            lo = (nt * angle) >> 5
            base = -lo
            for x in range(lo + 1, 0):
                k = ((x * inv + 128) >> 8) - 1
                main_src[x - lo] = corner if k < 0 else (
                    leftv(k) if vertical else topp(k))
            main_src[base] = corner
            for i in range(n2):
                main_src[base + 1 + i] = topp(i) if vertical else leftv(i)
        else:
            base = 0
            main_src[0] = corner
            for i in range(n2):
                main_src[1 + i] = topp(i) if vertical else leftv(i)
            main_src[n2 + 1] = topp(n2 - 1) if vertical else leftv(n2 - 1)
        for j in range(1, nt + 1):
            iidx = (j * angle) >> 5
            ifact = (j * angle) & 31
            for i in range(nt):
                k = i + iidx + 1 + base
                p = (j - 1) * nt + i if vertical else i * nt + (j - 1)
                np_idx[mode, p] = (main_src[k], main_src[k + 1], 0, 0)
                np_w[mode, p] = (32 - ifact, ifact, 0, 0)
                np_rnd[mode, p] = 16
                np_shift[mode, p] = 5
        if luma and nt < 32:
            if mode == 26:       # first column: t0 + ((left(y) - pc) >> 1)
                for y in range(nt):
                    p = y * nt
                    np_idx[26, p] = (topp(0), leftv(y), corner, 0)
                    np_w[26, p] = (2, 1, -1, 0)
                    np_rnd[26, p] = 0
                    np_shift[26, p] = 1
            elif mode == 10:     # first row: l0 + ((top(x) - pc) >> 1)
                for x in range(nt):
                    np_idx[10, x] = (leftv(0), topp(x), corner, 0)
                    np_w[10, x] = (2, 1, -1, 0)
                    np_rnd[10, x] = 0
                    np_shift[10, x] = 1

    filt = np.array([_filter_flag(m, log2) for m in range(35)], bool)
    return np_idx, np_w, np_rnd, np_shift, filt


@lru_cache(maxsize=32)
def _tables_dev(nt: int, luma: bool, device: str):
    """build_pred_tables on a device: gather indices as int64, the rest
    int32, the filter flags bool."""
    idx, w, rnd, shift, filt = build_pred_tables(nt, luma)
    dev = torch.device(device)
    return (torch.from_numpy(idx).to(dev, torch.int64),
            torch.from_numpy(w).to(dev), torch.from_numpy(rnd).to(dev),
            torch.from_numpy(shift).to(dev), torch.from_numpy(filt).to(dev))


def predict_intra_batch(refs, avail, modes, nt: int, bd: int, luma: bool,
                        strong: bool, device=None) -> torch.Tensor:
    """refs [N, 4nt+1] raw reference samples (native layout: left
    bottom-up, corner, top), avail [N, 4nt+1] bool, modes [N] ->
    pred [N, nt, nt] int32 on the device. Bit-exact vs get_ref_samples
    substitution + filter_refs + predict_intra.

    Tensors stay on their device when `device` is None; numpy inputs go
    to `device` (None: the CUDA device, raising without one)."""
    if device is None and isinstance(refs, torch.Tensor):
        dev = refs.device
    else:
        dev = resolve_device(device)

    def up(a, dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
    refs = up(refs, torch.int32)
    avail = up(avail, torch.bool)
    modes = up(modes, torch.int64)
    N, R = refs.shape
    n2 = 2 * nt
    corner = n2

    # --- reference sample substitution (unavailable -> forward fill) ---
    ar = torch.arange(R, device=dev, dtype=torch.int64)
    idx = torch.where(avail, ar[None, :], torch.full_like(ar, -1)[None, :])
    last = torch.cummax(idx, dim=1).values
    first = first_argmin((~avail).to(torch.int32), 1)
    take = torch.where(last >= 0, last, first[:, None])
    ref = torch.gather(refs, 1, take)
    none_avail = ~avail.any(dim=1)
    ref = torch.where(none_avail[:, None],
                      torch.full_like(ref, 1 << (bd - 1)), ref)

    # --- 1:2:1 reference filtering (+ strong bilinear for nt=32) ---
    f121 = ref.clone()
    f121[:, 1:R - 1] = (ref[:, :R - 2] + 2 * ref[:, 1:R - 1]
                        + ref[:, 2:] + 2) >> 2
    if strong and nt == 32:
        c = ref[:, corner]
        topend = ref[:, 4 * nt]
        leftend = ref[:, 0]
        thr = 1 << (bd - 5)
        cond = (((c + topend - 2 * ref[:, corner + nt]).abs() < thr)
                & ((c + leftend - 2 * ref[:, nt]).abs() < thr))
        x = torch.arange(n2 - 1, device=dev, dtype=torch.int32)
        top_s = ((63 - x)[None, :] * c[:, None]
                 + (x + 1)[None, :] * topend[:, None] + 32) >> 6
        yy = n2 - 1 - torch.arange(1, n2, device=dev, dtype=torch.int32)
        left_s = ((63 - yy)[None, :] * c[:, None]
                  + (yy + 1)[None, :] * leftend[:, None] + 32) >> 6
        strong_ref = ref.clone()
        strong_ref[:, corner + 1:corner + n2] = top_s
        strong_ref[:, 1:n2] = left_s
        fref = torch.where(cond[:, None], strong_ref, f121)
    else:
        fref = f121
    t_idx, t_w, t_rnd, t_shift, filt = _tables_dev(nt, bool(luma), str(dev))
    if luma:
        final_ref = torch.where(filt[modes][:, None], fref, ref)
    else:
        final_ref = ref          # chroma refs are never filtered (8.4.4.2.3)

    # --- dc pseudo-sample (from the per-block selected ref: DC mode is
    # never filtered, so final_ref == raw ref for those blocks) ---
    log2 = nt.bit_length() - 1
    top_sum = final_ref[:, corner + 1:corner + 1 + nt].sum(
        dim=1, dtype=torch.int32)
    left_sum = final_ref[:, n2 - nt:n2].sum(dim=1, dtype=torch.int32)
    dc = (top_sum + left_sum + nt) >> (log2 + 1)
    refx = torch.cat([final_ref, dc[:, None]], dim=1)        # [N, R+1]

    # --- 4-term sparse prediction ---
    g = torch.gather(refx, 1, t_idx[modes].reshape(N, -1))
    acc = ((g.reshape(N, nt * nt, 4) * t_w[modes]).sum(
        dim=2, dtype=torch.int32) + t_rnd[modes])
    pred = (acc >> t_shift[modes]).clamp_(0, (1 << bd) - 1)
    return pred.reshape(N, nt, nt)
