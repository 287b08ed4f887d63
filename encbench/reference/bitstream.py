"""Bit-level I/O and NAL assembly.

Functional analog of x265's Bitstream/SyntaxElementWriter
(reference source/common/bitstream.{h,cpp}) and NALList
(source/encoder/nal.{h,cpp}): a bit FIFO with Exp-Golomb writers, RBSP
trailing bits, emulation prevention (0x03 escaping) and Annex-B start codes.
Implementation is original: a 64-bit accumulator over a bytearray.
"""
from __future__ import annotations

from typing import List, Tuple

# --- NAL unit types (HEVC spec Table 7-1) ---
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_TSA_N = 2
NAL_TSA_R = 3
NAL_STSA_N = 4
NAL_STSA_R = 5
NAL_RADL_N = 6
NAL_RADL_R = 7
NAL_RASL_N = 8
NAL_RASL_R = 9
NAL_BLA_W_LP = 16
NAL_BLA_W_RADL = 17
NAL_BLA_N_LP = 18
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS = 36
NAL_EOB = 37
NAL_FD = 38
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


class BitWriter:
    """MSB-first bit writer producing an RBSP byte string."""

    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0          # bit accumulator, MSB-aligned within _nbits
        self._nbits = 0        # bits currently in accumulator (< 8 after flush)

    def write(self, value: int, nbits: int) -> None:
        """Write `value` in `nbits` bits, MSB first (u(n))."""
        if nbits == 0:
            return
        assert 0 <= value < (1 << nbits), (value, nbits)
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_flag(self, flag) -> None:
        self.write(1 if flag else 0, 1)

    def write_ue(self, value: int) -> None:
        """Exp-Golomb unsigned ue(v)."""
        assert value >= 0
        code = value + 1
        nbits = code.bit_length()
        self.write(0, nbits - 1)
        self.write(code, nbits)

    def write_se(self, value: int) -> None:
        """Exp-Golomb signed se(v)."""
        self.write_ue((value << 1) - 1 if value > 0 else (-value) << 1)

    def write_bytes(self, data: bytes) -> None:
        assert self._nbits == 0, "byte-align before writing raw bytes"
        self._buf.extend(data)

    @property
    def bit_position(self) -> int:
        return len(self._buf) * 8 + self._nbits

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def rbsp_trailing_bits(self) -> None:
        """stop-one bit then zero pad to byte boundary (spec 7.3.2.11)."""
        self.write(1, 1)
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def byte_align_with_ones(self) -> None:
        """slice header byte_alignment(): one '1' bit then zeros."""
        self.rbsp_trailing_bits()

    def data(self) -> bytes:
        assert self._nbits == 0, "bitstream not byte-aligned"
        return bytes(self._buf)


def add_emulation_prevention(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (spec 7.4.2: escape any
    00 00 0x with x<=3 inside the RBSP). x265 analog: NALList::serialize
    (source/encoder/nal.cpp)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def escaped_sizes(parts) -> list:
    """Post-emulation-prevention byte size of each part when the parts
    are concatenated into one RBSP region (the zero-run state carries
    across boundaries, matching add_emulation_prevention over the
    concatenation). Used for WPP entry_point_offset values, which the
    spec counts in the escaped (EBSP) domain (7.4.7.1)."""
    zeros = 0
    sizes = []
    for part in parts:
        add = 0
        for b in part:
            if zeros >= 2 and b <= 3:
                add += 1
                zeros = 0
            zeros = zeros + 1 if b == 0 else 0
        sizes.append(len(part) + add)
    return sizes


def ebsp_to_rbsp_offsets(data_rbsp: bytes, ebsp_offsets) -> list:
    """Map cumulative byte offsets in the escaped (EBSP) domain to
    offsets in `data_rbsp` (the stripped region they index into), by
    simulating where emulation bytes would sit. WPP entry points are
    spec'd in the escaped domain (7.4.7.1) but our slice decoder indexes
    the stripped payload. `ebsp_offsets` must be ascending."""
    targets = list(ebsp_offsets)
    res = [len(data_rbsp)] * len(targets)
    ti = 0
    eb = 0
    zeros = 0
    for r, b in enumerate(data_rbsp):
        if zeros >= 2 and b <= 3:
            eb += 1                        # implied escape byte here
            zeros = 0
        while ti < len(targets) and eb >= targets[ti]:
            res[ti] = r
            ti += 1
        if ti == len(targets):
            break
        eb += 1
        zeros = zeros + 1 if b == 0 else 0
    return res


def strip_emulation_prevention(data: bytes) -> bytes:
    """Remove emulation_prevention_three_byte from a NAL payload."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3 and i + 1 < n and data[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        if zeros >= 2 and b == 3 and i + 1 == n:
            # trailing cabac_zero_word escape
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def make_nal(nal_type: int, rbsp: bytes, temporal_id: int = 0) -> bytes:
    """Build a NAL unit: 2-byte header + escaped RBSP (no start code)."""
    hdr = bytes([(nal_type << 1) & 0x7E, 1 + temporal_id])
    return hdr + add_emulation_prevention(rbsp)


def annexb(nals: List[bytes]) -> bytes:
    """Concatenate NAL units with 4-byte start codes (Annex B)."""
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


def split_annexb(stream: bytes) -> List[bytes]:
    """Split an Annex-B byte stream into NAL units (start codes removed)."""
    nals = []
    i = 0
    n = len(stream)
    # find first start code
    starts = []
    zeros = 0
    while i < n:
        b = stream[i]
        if b == 0:
            zeros += 1
        elif b == 1 and zeros >= 2:
            starts.append((i + 1, min(zeros, 3) + 1))  # (payload start, sc len)
            zeros = 0
        else:
            zeros = 0
        i += 1
    for k, (s, sclen) in enumerate(starts):
        e = starts[k + 1][0] - starts[k + 1][1] if k + 1 < len(starts) else n
        # strip trailing zero bytes that belong to the next start code only
        nals.append(stream[s:e])
    return nals


class BitReader:
    """MSB-first bit reader over an (unescaped) RBSP."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def read(self, nbits: int) -> int:
        v = 0
        p = self._pos
        data = self._data
        for _ in range(nbits):
            byte = data[p >> 3]
            v = (v << 1) | ((byte >> (7 - (p & 7))) & 1)
            p += 1
        self._pos = p
        return v

    def read_flag(self) -> int:
        return self.read(1)

    def read_ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("bad ue(v)")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.read(zeros)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_position(self) -> int:
        return self._pos

    def bits_left(self) -> int:
        return len(self._data) * 8 - self._pos

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP data before rbsp_trailing_bits."""
        rem = self.bits_left()
        if rem <= 0:
            return False
        # find last set bit in the stream (the rbsp_stop_one_bit)
        data = self._data
        last = len(data) * 8 - 1
        i = len(data) - 1
        while i >= 0 and data[i] == 0:
            i -= 1
        if i < 0:
            return False
        b = data[i]
        lowbit = (b & -b).bit_length() - 1
        stop_pos = i * 8 + (7 - lowbit)
        return self._pos < stop_pos
