"""Access units out of the encoder's byte chunks, read with the plain
reference's own header parsers (``encbench/reference``), never the port's.

``encode_frame`` returns the bytes of zero, one or several access units
(decode order); the harness keeps each call's chunk and splits it here,
after the window, into access units by the rule of HEVC 7.4.2.4.4.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from encbench.reference.bitstream import strip_emulation_prevention
from encbench.reference.headers import (is_idr, parse_pps, parse_slice_header,
                                        parse_sps)

_START = re.compile(b"\x00\x00\x01")
# NAL types that open a new access unit when they follow a picture's
# slices (7.4.2.4.4): AUD, VPS, SPS, PPS, prefix SEI, 41..44, 48..55
_AU_OPENERS = {32, 33, 34, 35, 39, 41, 42, 43, 44} | set(range(48, 56))


def nal_units(data: bytes):
    """[(begin, end, nal_type, payload)] of an Annex-B chunk; begin counts
    a 4-byte start code's zero byte, so the spans tile the chunk."""
    starts = []
    for m in _START.finditer(data):
        b = m.start()
        if starts and b < starts[-1][1]:
            continue                         # 00 00 01 inside 00 00 00 01
        starts.append((b - 1 if b > 0 and data[b - 1] == 0 else b, m.end()))
    out = []
    for i, (b, p) in enumerate(starts):
        e = starts[i + 1][0] if i + 1 < len(starts) else len(data)
        payload = data[p:e]
        out.append((b, e, (payload[0] >> 1) & 0x3F if payload else -1,
                    payload))
    if starts and starts[0][0] != 0:
        raise ValueError("bytes before the first start code")
    return out


@dataclass
class AccessUnit:
    data: bytes
    call: int                      # index of the encode_frame call that returned it
    nal_types: list = field(default_factory=list)


def split_access_units(chunks):
    """chunks: [(call index, bytes)] in return order -> [AccessUnit]."""
    aus = []
    cur = None
    seen_vcl = False
    for call, data in chunks:
        for b, e, t, payload in nal_units(data):
            first_slice = t < 32 and len(payload) > 2 and payload[2] & 0x80
            opens = (t in _AU_OPENERS and seen_vcl) or (first_slice and seen_vcl)
            if cur is None or opens:
                cur = AccessUnit(b"", call)
                aus.append(cur)
                seen_vcl = False
            cur.data += data[b:e]
            cur.nal_types.append(t)
            if t < 32:
                seen_vcl = True
    return aus


class HeaderReader:
    """Parameter sets from the stream's headers, then each access unit's
    first slice header, its POC (8.3.1) and its picture's display index:
    after an IDR every picture shown earlier has been coded, so an IDR's
    display index is the count of pictures coded before it."""

    def __init__(self, header_bytes: bytes):
        self.sps, self.pps = {}, {}
        self._read_params(header_bytes)
        self.prev_lsb = self.prev_msb = 0
        self.base = 0
        self.coded = 0

    def _read_params(self, data):
        for _b, _e, t, payload in nal_units(data):
            if t == 33:
                s = parse_sps(strip_emulation_prevention(payload[2:]))
                self.sps[s.sps_id] = s
            elif t == 34:
                p = parse_pps(strip_emulation_prevention(payload[2:]))
                self.pps[p.pps_id] = p

    def read(self, au: AccessUnit) -> dict:
        """{nal_type, slice_type, poc, display}; raises when the access
        unit holds no first slice or its header does not parse."""
        self._read_params(au.data)
        for _b, _e, t, payload in nal_units(au.data):
            if t >= 32:
                continue
            rbsp = strip_emulation_prevention(payload[2:])
            pps = next(iter(self.pps.values()))
            sh, _off = parse_slice_header(rbsp, t, self.sps[pps.sps_id], pps)
            if not sh.first_slice_in_pic:
                raise ValueError("access unit does not begin a picture")
            sps = self.sps[self.pps[sh.pps_id].sps_id]
            if is_idr(t):
                poc = 0
                self.prev_lsb = self.prev_msb = 0
                self.base = self.coded
            else:
                lsb, max_lsb = sh.pic_order_cnt_lsb, 1 << sps.log2_max_poc_lsb
                msb = self.prev_msb
                if lsb < self.prev_lsb and self.prev_lsb - lsb >= max_lsb // 2:
                    msb += max_lsb
                elif lsb > self.prev_lsb and lsb - self.prev_lsb > max_lsb // 2:
                    msb -= max_lsb
                poc = msb + lsb
                if t not in (0, 2, 4, 6, 7, 8, 9):
                    self.prev_lsb, self.prev_msb = lsb, msb
            self.coded += 1
            return {"nal_type": t, "slice_type": sh.slice_type, "poc": poc,
                    "display": self.base + poc}
        raise ValueError("access unit without a slice")
