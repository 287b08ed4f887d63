"""State conversion between numpy and the port's device tensors.

The encoder has no trained weights; its constant tensors and its frame
state take their place. Everything here starts from numpy, so a test
can hand the SAME arrays to the JAX package and to this one.
"""
from __future__ import annotations

import numpy as np
import torch

from x265_tpu_torch.utils.device import resolve_device


def to_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """numpy (or anything np.asarray takes) -> tensor on `device`."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def intra_bank(S: int, device=None) -> torch.Tensor:
    """The intra mode-bank matrix [35, S*S, 4S+1] float32."""
    from x265_tpu_torch.ops.intra_matrix import intra_weight_matrices
    return to_tensor(intra_weight_matrices(S), torch.float32, device)


def interp_filters(device=None):
    """(luma [4,8], chroma [8,4]) interpolation taps, int32."""
    from x265_tpu_torch.models.inter_residual import (
        _CHROMA_FILT, _LUMA_FILT)
    return (to_tensor(_LUMA_FILT, torch.int32, device),
            to_tensor(_CHROMA_FILT, torch.int32, device))


def transform_matrix(n: int, dst: bool = False, device=None) -> torch.Tensor:
    """The n x n forward transform matrix (DST for 4x4 intra luma), int32."""
    from x265_tpu_torch.models.residual import _tmat
    return to_tensor(_tmat(n, dst), torch.int32, device)


def quant_tables(device=None):
    """(quant scales [6], dequant scales [6]) int32."""
    from x265_tpu_torch.hevc.tables import DEQUANT_SCALES, QUANT_SCALES
    return (to_tensor(QUANT_SCALES, torch.int32, device),
            to_tensor(DEQUANT_SCALES, torch.int32, device))


_DECISION_FIELDS = ("cu_log2_map", "luma_mode8", "chroma_mode8", "inter8",
                    "dir8", "mv8", "ref8", "qp_map", "tusplit8")


def decisions_from_numpy(**maps):
    """A FrameDecisions from numpy decision maps (copies, so the two
    packages never share a mutable map)."""
    from x265_tpu_torch.engine.ctu_writer import FrameDecisions
    kw = {k: (None if v is None else np.array(v))
          for k, v in maps.items()}
    dec = FrameDecisions(cu_log2_map=kw.pop("cu_log2_map"),
                         luma_mode8=kw.pop("luma_mode8"))
    for k, v in kw.items():
        if k not in _DECISION_FIELDS:
            raise KeyError(k)
        setattr(dec, k, v)
    return dec


def decisions_to_numpy(dec) -> dict:
    return {k: (None if getattr(dec, k, None) is None
                else np.array(getattr(dec, k)))
            for k in _DECISION_FIELDS}


def reference_from_numpy(planes, bd: int = 8, device=None):
    """(y, cb, cr) numpy planes -> FramePlanes on a device."""
    from x265_tpu_torch.engine.planes import FramePlanes
    return FramePlanes(host=tuple(np.asarray(p) for p in planes), bd=bd,
                       device=resolve_device(device))


def reference_to_numpy(ref):
    """FramePlanes (or a plain tuple) -> (y, cb, cr) numpy int32."""
    from x265_tpu_torch.engine.planes import FramePlanes
    if isinstance(ref, FramePlanes):
        if ref.host_ready:
            return tuple(np.asarray(p, np.int32) for p in ref.host())
        return tuple(to_numpy(p).astype(np.int32) for p in ref.dev())
    return tuple(np.asarray(p, np.int32) for p in ref)


# ---- loop-filter, AQ and weighted-prediction state (all host numpy) ----

_SAO_FIELDS = ("type_y", "class_y", "off_y", "type_c", "class_cb",
               "class_cr", "off_cb", "off_cr")


def sao_params_from_numpy(**maps):
    """An SaoParams from the eight numpy parameter maps (copies)."""
    from x265_tpu_torch.hevc.sao import SaoParams
    if set(maps) != set(_SAO_FIELDS):
        raise KeyError(sorted(set(maps) ^ set(_SAO_FIELDS)))
    return SaoParams(**{k: np.array(v, np.int32) for k, v in maps.items()})


def sao_params_to_numpy(sp) -> dict:
    return {k: np.array(getattr(sp, k)) for k in _SAO_FIELDS}


def deblock_state_from_numpy(height, width, edge_v, edge_h, cbf4,
                             bypass4=None, is_intra4=None, mv4=None,
                             refpoc4=None):
    """(DeblockState, is_intra4, mv4, refpoc4): the state hevc.deblock and
    models.loopfilter filter from, with its boundary-strength inputs.
    Omitted bS inputs mean an all-intra picture."""
    from x265_tpu_torch.hevc.deblock import NOPOC, DeblockState
    st = DeblockState(height, width)
    h4, w4 = st.cbf4.shape
    st.edge_v = np.array(edge_v, bool)
    st.edge_h = np.array(edge_h, bool)
    st.cbf4 = np.array(cbf4, bool)
    if bypass4 is not None:
        st.bypass4 = np.array(bypass4, bool)
    if is_intra4 is None:
        is_intra4 = np.ones((h4, w4), bool)
    if mv4 is None:
        mv4 = np.zeros((h4, w4, 2, 2), np.int32)
    if refpoc4 is None:
        refpoc4 = np.full((h4, w4, 2), NOPOC, np.int64)
    return (st, np.array(is_intra4, bool), np.array(mv4, np.int32),
            np.array(refpoc4, np.int64))


def qp_map_from_numpy(qp_map):
    """A per-CTU QP map as FrameDecisions.qp_map holds it (int32 copy)."""
    return np.array(qp_map, np.int32)


def weights_from_numpy(wl=None, wc=None):
    """Explicit L0 weights of the nearest reference as the slice header
    and build_inter_pre take them: wl = (weight, offset) or None,
    wc = ((w_cb, o_cb), (w_cr, o_cr)) or None. Returns the native
    writer's (table [4,3,3] int32, luma denom, chroma denom), or None
    when neither is set."""
    from x265_tpu_torch.engine.weightp import DENOM
    if wl is None and wc is None:
        return None
    wp = np.zeros((4, 3, 3), np.int32)
    if wl is not None:
        wp[0, 0] = (1, int(wl[0]), int(wl[1]))
    if wc is not None:
        wp[0, 1] = (1, int(wc[0][0]), int(wc[0][1]))
        wp[0, 2] = (1, int(wc[1][0]), int(wc[1][1]))
    return wp, DENOM if wl is not None else 0, DENOM if wc is not None else 0
