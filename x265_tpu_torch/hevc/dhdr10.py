"""HDR10+ dynamic metadata (x265 dynamicHDR10/ analog: hdr10plus.h,
metadataFromJson — x265's --dhdr10-info reads a JSON document of
per-frame SMPTE ST 2094-40 parameters and emits one
user_data_registered_itu_t_t35 prefix SEI per access unit).

This module parses the same JSON shape the HDR10+ ecosystem tools emit
(a "SceneInfo" array with BezierCurveData / LuminanceParameters per
frame) and bit-packs the ST 2094-40 application-4 payload per the
public ATSC A/341 / ST 2094-40 syntax.  The packing is written from the
spec field list, not from x265's JSON walker.
"""
from __future__ import annotations

import json
from typing import List, Optional

from x265_tpu_torch.hevc.bitstream import BitWriter, make_nal, NAL_PREFIX_SEI

SEI_USER_DATA_REGISTERED = 4


def load_dhdr10_json(path: str) -> List[dict]:
    """Read an HDR10+ JSON file -> list of per-frame metadata dicts."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        frames = doc.get("SceneInfo", doc.get("frames", []))
    else:
        frames = doc
    if not isinstance(frames, list):
        raise ValueError("dhdr10 JSON: expected a SceneInfo array")
    return frames


def _get(d: dict, *names, default=None):
    for n in names:
        if n in d:
            return d[n]
    return default


def pack_st2094_40(meta: dict) -> bytes:
    """Bit-pack one frame's ST 2094-40 payload (application_identifier 4).

    Field widths follow ATSC A/341 §6.3.2 (the HDR10+ SEI syntax):
    u2 num_windows, u27 targeted max luminance, u17 maxscl/average,
    u7+u17 distribution pairs, u12 knee point, u10 anchors.
    """
    bw = BitWriter()
    bw.write(0xB5, 8)                 # itu_t_t35_country_code (US)
    bw.write(0x003C, 16)              # provider: Samsung (HDR10+ LLC)
    bw.write(0x0001, 16)              # provider_oriented_code
    bw.write(4, 8)                    # application_identifier
    bw.write(1, 8)                    # application_version
    nwin = int(_get(meta, "NumberOfWindows", "num_windows", default=1))
    nwin = max(1, min(3, nwin))
    bw.write(nwin, 2)
    for _ in range(nwin - 1):
        # elliptical processing windows are not produced by the JSON
        # tools we accept; emit a degenerate window if ever requested
        for width in (16, 16, 16, 16, 16, 16):
            bw.write(0, width)
        bw.write(0, 8)                # rotation angle
        bw.write(0, 1)                # semimajor axis ellipse overlap
    tsd = int(_get(meta, "TargetedSystemDisplayMaximumLuminance",
                   "targeted_system_display_maximum_luminance", default=0))
    bw.write(min(tsd, (1 << 27) - 1), 27)
    bw.write(0, 1)                    # targeted..actual_peak_luminance_flag
    lum = _get(meta, "LuminanceParameters", "luminance_parameters",
               default={}) or {}
    maxscl = _get(lum, "MaxScl", "max_scl", default=[0, 0, 0])
    avg = int(_get(lum, "AverageRGB", "average_maxrgb", default=0))
    dists = _get(lum, "LuminanceDistributions", "luminance_distributions",
                 default={}) or {}
    idx = _get(dists, "DistributionIndex", "distribution_index", default=[])
    val = _get(dists, "DistributionValues", "distribution_values", default=[])
    for w in range(nwin):
        for i in range(3):
            v = int(maxscl[i]) if i < len(maxscl) else 0
            bw.write(min(max(v, 0), (1 << 17) - 1), 17)
        bw.write(min(max(avg, 0), (1 << 17) - 1), 17)
        n = min(len(idx), len(val), 15)
        bw.write(n, 4)
        for i in range(n):
            bw.write(min(max(int(idx[i]), 0), 127), 7)
            bw.write(min(max(int(val[i]), 0), (1 << 17) - 1), 17)
        fbp = int(_get(meta, "FractionBrightPixels",
                       "fraction_bright_pixels", default=0))
        bw.write(min(max(fbp, 0), 1023), 10)
    bw.write(0, 1)                    # mastering..actual_peak_luminance_flag
    bez = _get(meta, "BezierCurveData", "bezier_curve_data", default=None)
    for w in range(nwin):
        if bez:
            bw.write(1, 1)            # tone_mapping_flag
            kx = int(_get(bez, "KneePointX", "knee_point_x", default=0))
            ky = int(_get(bez, "KneePointY", "knee_point_y", default=0))
            bw.write(min(max(kx, 0), 4095), 12)
            bw.write(min(max(ky, 0), 4095), 12)
            anchors = _get(bez, "Anchors", "anchors", default=[]) or []
            n = min(len(anchors), 15)
            bw.write(n, 4)
            for a in anchors[:n]:
                bw.write(min(max(int(a), 0), 1023), 10)
        else:
            bw.write(0, 1)
        bw.write(0, 1)                # color_saturation_mapping_flag
    while not bw.byte_aligned():      # T.35 payloads are whole bytes
        bw.write(0, 1)
    return bw.data()


def dhdr10_sei(meta: dict) -> bytes:
    """One HDR10+ prefix-SEI NAL for one frame's metadata."""
    from x265_tpu_torch.hevc.sei import _sei_payload
    return make_nal(NAL_PREFIX_SEI,
                    _sei_payload(SEI_USER_DATA_REGISTERED,
                                 pack_st2094_40(meta)))


def parse_st2094_40(payload: bytes) -> Optional[dict]:
    """Minimal parser for round-trip tests: returns the headline fields
    (targeted max luminance, maxscl, average, distributions, knee/anchors)
    or None if the payload is not an HDR10+ app-4 message."""
    from x265_tpu_torch.hevc.bitstream import BitReader
    br = BitReader(payload)
    if br.read(8) != 0xB5 or br.read(16) != 0x003C or br.read(16) != 0x0001:
        return None
    if br.read(8) != 4:
        return None
    br.read(8)                        # application_version
    nwin = br.read(2)
    for _ in range(nwin - 1):
        for width in (16, 16, 16, 16, 16, 16):
            br.read(width)
        br.read(8)
        br.read(1)
    out = {"NumberOfWindows": nwin,
           "TargetedSystemDisplayMaximumLuminance": br.read(27)}
    br.read(1)
    maxscl, dist_idx, dist_val = [], [], []
    for w in range(nwin):
        scl = [br.read(17) for _ in range(3)]
        avg = br.read(17)
        n = br.read(4)
        di, dv = [], []
        for _ in range(n):
            di.append(br.read(7))
            dv.append(br.read(17))
        br.read(10)
        if w == 0:
            maxscl, dist_idx, dist_val = scl, di, dv
            out["LuminanceParameters"] = {
                "MaxScl": scl, "AverageRGB": avg,
                "LuminanceDistributions": {
                    "DistributionIndex": di, "DistributionValues": dv}}
    br.read(1)
    for w in range(nwin):
        if br.read(1):
            kx, ky = br.read(12), br.read(12)
            n = br.read(4)
            anchors = [br.read(10) for _ in range(n)]
            if w == 0:
                out["BezierCurveData"] = {
                    "KneePointX": kx, "KneePointY": ky, "Anchors": anchors}
        br.read(1)
    return out
