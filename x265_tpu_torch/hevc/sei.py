"""SEI messages (x265 analog: sei.{h,cpp} class tree, sei.h:36-327).

Implemented: decoded_picture_hash (D.2.19/D.3.19, MD5 type) — the
self-verification channel x265's regression suites rely on
(frameencoder.cpp:1167), plus user_data_unregistered for encoder tags.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

import numpy as np

from x265_tpu_torch.hevc.bitstream import BitWriter, make_nal, NAL_SUFFIX_SEI

SEI_USER_DATA_UNREGISTERED = 5
SEI_DECODED_PICTURE_HASH = 132
SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_RECOVERY_POINT = 6
SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144


def _plane_md5(plane: np.ndarray, bd: int) -> bytes:
    """MD5 of a plane in spec sample order (D.3.19: LSB-first bytes,
    (bd+7)//8 bytes per sample)."""
    if bd <= 8:
        data = plane.astype(np.uint8).tobytes()
    else:
        data = plane.astype("<u2").tobytes()
    return hashlib.md5(data).digest()


def picture_hash_md5(planes, bd: int = 8) -> List[bytes]:
    return [_plane_md5(p, bd) for p in planes]


def _sei_payload(payload_type: int, payload: bytes) -> bytes:
    out = bytearray()
    t = payload_type
    while t >= 255:
        out.append(255)
        t -= 255
    out.append(t)
    s = len(payload)
    while s >= 255:
        out.append(255)
        s -= 255
    out.append(s)
    out += payload
    out.append(0x80)               # rbsp_trailing_bits
    return bytes(out)


def decoded_picture_hash_sei(planes, bd: int = 8) -> bytes:
    """Suffix-SEI NAL carrying the MD5 of the decoded picture."""
    payload = bytes([0]) + b"".join(picture_hash_md5(planes, bd))  # type 0=MD5
    return make_nal(NAL_SUFFIX_SEI, _sei_payload(SEI_DECODED_PICTURE_HASH,
                                                 payload))


def parse_sei(rbsp: bytes):
    """Parse one SEI NAL rbsp -> list of (payload_type, payload bytes)."""
    out = []
    i = 0
    while i < len(rbsp):
        if rbsp[i] == 0x80 and i == len(rbsp) - 1:
            break
        t = 0
        while i < len(rbsp) and rbsp[i] == 255:
            t += 255
            i += 1
        if i >= len(rbsp):
            break
        t += rbsp[i]; i += 1
        s = 0
        while i < len(rbsp) and rbsp[i] == 255:
            s += 255
            i += 1
        if i >= len(rbsp):
            break
        s += rbsp[i]; i += 1
        out.append((t, rbsp[i:i + s]))
        i += s
    return out


def check_picture_hash(sei_payload: bytes, planes, bd: int = 8) -> bool:
    """Verify a decoded_picture_hash payload against decoded planes."""
    if not sei_payload or sei_payload[0] != 0:   # only MD5 supported
        return False
    digests = picture_hash_md5(planes, bd)
    want = sei_payload[1:]
    got = b"".join(digests)
    return want == got


def parse_master_display(s: str):
    """Parse the x265 --master-display string
    "G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)" -> (primaries[3][2] in G,B,R
    order, white_point[2], max_lum, min_lum). Values already in the SEI's
    0.00002-degree / 0.0001-nit units (x265 x265.h:masteringDisplayColorVolume).
    """
    import re
    m = re.match(r"G\((\d+),(\d+)\)B\((\d+),(\d+)\)R\((\d+),(\d+)\)"
                 r"WP\((\d+),(\d+)\)L\((\d+),(\d+)\)", s.replace(" ", ""))
    if not m:
        raise ValueError(f"bad master-display string: {s}")
    v = [int(x) for x in m.groups()]
    return ((v[0], v[1]), (v[2], v[3]), (v[4], v[5])), (v[6], v[7]), v[8], v[9]


def mastering_display_sei(display: str) -> bytes:
    """mastering_display_colour_volume SEI (payload 137, D.3.28) as a
    prefix-SEI NAL. Takes the x265-format display string."""
    prim, wp, maxl, minl = parse_master_display(display)
    from x265_tpu_torch.hevc.bitstream import NAL_PREFIX_SEI
    pl = b""
    for (x, y) in prim:
        pl += x.to_bytes(2, "big") + y.to_bytes(2, "big")
    pl += wp[0].to_bytes(2, "big") + wp[1].to_bytes(2, "big")
    pl += maxl.to_bytes(4, "big") + minl.to_bytes(4, "big")
    return make_nal(NAL_PREFIX_SEI, _sei_payload(SEI_MASTERING_DISPLAY, pl))


def content_light_level_sei(max_cll: int, max_fall: int) -> bytes:
    """content_light_level_info SEI (payload 144, D.3.35)."""
    from x265_tpu_torch.hevc.bitstream import NAL_PREFIX_SEI
    pl = max_cll.to_bytes(2, "big") + max_fall.to_bytes(2, "big")
    return make_nal(NAL_PREFIX_SEI, _sei_payload(SEI_CONTENT_LIGHT_LEVEL, pl))


def user_data_unregistered_sei(text: str) -> bytes:
    """user_data_unregistered prefix SEI carrying the encoder info tag
    (x265 writes its build/options string this way by default,
    frameencoder.cpp getStreamHeaders; disable with --no-info)."""
    from x265_tpu_torch.hevc.bitstream import NAL_PREFIX_SEI
    # 16-byte UUID then the payload string (7.3.5 user_data_unregistered)
    uuid = bytes.fromhex("2CA2DE09B51747DBBB55A4FE7FC2FC4E")
    payload = uuid + text.encode()
    return make_nal(NAL_PREFIX_SEI,
                    _sei_payload(SEI_USER_DATA_UNREGISTERED, payload))


def recovery_point_sei(recovery_poc_cnt: int, exact_match: bool = True,
                       broken_link: bool = False) -> bytes:
    """recovery_point SEI (D.3.8): emitted at the start of an
    intra-refresh cycle so decoders can join mid-stream (x265
    frameencoder.cpp recovery point for --intra-refresh)."""
    from x265_tpu_torch.hevc.bitstream import BitWriter, NAL_PREFIX_SEI
    bw = BitWriter()
    bw.write_se(recovery_poc_cnt)
    bw.write_flag(exact_match)
    bw.write_flag(broken_link)
    bw.rbsp_trailing_bits()          # payload bit-alignment (D.2.1)
    return make_nal(NAL_PREFIX_SEI, _sei_payload(SEI_RECOVERY_POINT,
                                                 bw.data()))


def parse_recovery_point(payload: bytes):
    from x265_tpu_torch.hevc.bitstream import BitReader
    br = BitReader(payload)
    cnt = br.read_se()
    return cnt, bool(br.read_flag()), bool(br.read_flag())


def buffering_period_sei(initial_delay_90k: int,
                         initial_offset_90k: int = 0) -> bytes:
    """buffering_period SEI (D.3.2): NAL HRD, one CPB, 24-bit delay
    fields (matching the hrd_parameters lengths we signal)."""
    from x265_tpu_torch.hevc.bitstream import BitWriter, NAL_PREFIX_SEI
    bw = BitWriter()
    bw.write_ue(0)                       # bp_seq_parameter_set_id
    bw.write_flag(0)                     # irap_cpb_params_present
    bw.write_flag(0)                     # concatenation_flag
    bw.write(0, 24)                      # au_cpb_removal_delay_delta-1
    bw.write(min(initial_delay_90k, (1 << 24) - 1), 24)
    bw.write(min(initial_offset_90k, (1 << 24) - 1), 24)
    bw.rbsp_trailing_bits()
    return make_nal(NAL_PREFIX_SEI, _sei_payload(SEI_BUFFERING_PERIOD,
                                                 bw.data()))


def pic_timing_sei(au_cpb_removal_delay_m1: int,
                   dpb_output_delay: int,
                   pic_struct: Optional[int] = None,
                   with_delays: bool = True) -> bytes:
    """pic_timing SEI (D.3.3). pic_struct (when the VUI signals
    frame_field_info_present) precedes the HRD delay fields; values 7/8
    are frame doubling/tripling — how x265 --frame-dup keeps timing
    after dropping duplicate pictures (encoder.cpp:1602)."""
    from x265_tpu_torch.hevc.bitstream import BitWriter, NAL_PREFIX_SEI
    bw = BitWriter()
    if pic_struct is not None:
        bw.write(pic_struct, 4)
        bw.write(0, 2)                   # source_scan_type: progressive
        bw.write(0, 1)                   # duplicate_flag
    if with_delays:
        bw.write(min(au_cpb_removal_delay_m1, (1 << 24) - 1), 24)
        bw.write(min(dpb_output_delay, (1 << 24) - 1), 24)
    bw.rbsp_trailing_bits()
    return make_nal(NAL_PREFIX_SEI, _sei_payload(SEI_PIC_TIMING, bw.data()))
