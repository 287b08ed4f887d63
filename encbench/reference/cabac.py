"""CABAC arithmetic coding engines (HEVC spec 9.3.4.3).

Encoder and decoder share the tables in :mod:`encbench.reference.tables`.
This Python implementation is the *reference*; the production finalizer is
the C++ extension in ``x265_tpu_torch/native`` (same algorithm, same tests).

The engine follows the well-known HM carry-buffer formulation (low/range
with buffered 0xff bytes) which is bit-identical to the spec's
PutBit/bitsOutstanding procedure. x265's equivalent lives in
source/encoder/entropy.cpp:2454-2550; this is an independent
implementation from the spec.
"""
from __future__ import annotations

import numpy as np

from encbench.reference.tables import (
    LPS_TABLE, RENORM_TABLE, NEXT_STATE_LPS, NEXT_STATE_MPS,
    NUM_CONTEXTS, init_contexts,
)

_MASK32 = 0xFFFFFFFF


class CabacEncoder:
    """Binary arithmetic encoder producing slice-data bytes."""

    __slots__ = ("ctx", "low", "range", "bits_left", "num_buffered",
                 "buffered_byte", "out")

    def __init__(self) -> None:
        self.ctx = np.zeros(NUM_CONTEXTS, dtype=np.uint8)
        self.reset_engine()

    def reset_engine(self) -> None:
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered = 0
        self.buffered_byte = 0xFF
        self.out = bytearray()

    def init_slice(self, init_type: int, qp: int) -> None:
        """Initialize contexts for a slice (initType 0=I,1=P,2=B)."""
        self.ctx = init_contexts(init_type, qp)
        self.reset_engine()

    # -- core bin coders --

    def encode_bin(self, ctx_idx: int, binval: int) -> None:
        state = self.ctx[ctx_idx]
        lps = int(LPS_TABLE[state >> 1, (self.range >> 6) & 3])
        self.range -= lps
        if binval != (state & 1):
            nbits = int(RENORM_TABLE[lps >> 3])
            self.low = ((self.low + self.range) << nbits) & _MASK32
            self.range = lps << nbits
            self.ctx[ctx_idx] = NEXT_STATE_LPS[state]
            self.bits_left -= nbits
        else:
            self.ctx[ctx_idx] = NEXT_STATE_MPS[state]
            if self.range >= 256:
                return
            self.low = (self.low << 1) & _MASK32
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bin_ep(self, binval: int) -> None:
        self.low = (self.low << 1) & _MASK32
        if binval:
            self.low = (self.low + self.range) & _MASK32
        self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bins_ep(self, pattern: int, nbins: int) -> None:
        while nbins > 8:
            nbins -= 8
            chunk = (pattern >> nbins) & 0xFF
            self.low = ((self.low << 8) + self.range * chunk) & _MASK32
            self.bits_left -= 8
            if self.bits_left < 12:
                self._write_out()
        if nbins > 0:
            chunk = pattern & ((1 << nbins) - 1)
            self.low = ((self.low << nbins) + self.range * chunk) & _MASK32
            self.bits_left -= nbins
            if self.bits_left < 12:
                self._write_out()

    def encode_bin_trm(self, binval: int) -> None:
        self.range -= 2
        if binval:
            self.low = ((self.low + self.range) << 7) & _MASK32
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low = (self.low << 1) & _MASK32
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    # -- byte plumbing --

    def _write_out(self) -> None:
        lead = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= _MASK32 >> self.bits_left
        if lead == 0xFF:
            self.num_buffered += 1
        elif self.num_buffered > 0:
            carry = lead >> 8
            self.out.append((self.buffered_byte + carry) & 0xFF)
            fill = (0xFF + carry) & 0xFF
            for _ in range(self.num_buffered - 1):
                self.out.append(fill)
            self.buffered_byte = lead & 0xFF
            self.num_buffered = 1
        else:
            self.num_buffered = 1
            self.buffered_byte = lead & 0xFF

    def finish(self) -> bytes:
        """Flush the engine (spec EncodeFlush); returns slice-data bytes.

        Caller appends the rbsp stop bit / alignment via BitWriter semantics:
        the returned bytes already include the final aligned byte per
        9.3.4.3.7 (we emit low bits and the stop bit pattern together).
        """
        if (self.low >> (32 - self.bits_left)) & 1:
            self.out.append((self.buffered_byte + 1) & 0xFF)
            for _ in range(self.num_buffered - 1):
                self.out.append(0x00)
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                self.out.append(self.buffered_byte)
            for _ in range(self.num_buffered - 1):
                self.out.append(0xFF)
        # remaining payload bits: (24 - bits_left) bits of low >> 8
        nbits = 24 - self.bits_left
        val = (self.low >> 8) & ((1 << nbits) - 1) if nbits > 0 else 0
        # append stop bit '1' then zero-pad to byte boundary
        nbits += 1
        val = (val << 1) | 1
        pad = (8 - (nbits & 7)) & 7
        val <<= pad
        nbits += pad
        while nbits >= 8:
            nbits -= 8
            self.out.append((val >> nbits) & 0xFF)
        return bytes(self.out)


class CabacDecoder:
    """Binary arithmetic decoder over slice-data bytes."""

    __slots__ = ("ctx", "range", "value", "bits_needed", "data", "pos")

    def __init__(self, data: bytes) -> None:
        self.ctx = np.zeros(NUM_CONTEXTS, dtype=np.uint8)
        self.data = data
        self.pos = 0
        self.range = 510
        self.value = (self._byte() << 8) | self._byte()
        self.bits_needed = -8

    def init_slice(self, init_type: int, qp: int) -> None:
        self.ctx = init_contexts(init_type, qp)

    def _byte(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        return 0

    def decode_bin(self, ctx_idx: int) -> int:
        state = self.ctx[ctx_idx]
        lps = int(LPS_TABLE[state >> 1, (self.range >> 6) & 3])
        self.range -= lps
        scaled = self.range << 7
        if self.value < scaled:
            binval = state & 1
            self.ctx[ctx_idx] = NEXT_STATE_MPS[state]
            if scaled >= (256 << 7):
                return int(binval)
            self.range = scaled >> 6
            self.value <<= 1
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self._byte()
            return int(binval)
        else:
            nbits = int(RENORM_TABLE[lps >> 3])
            self.value = (self.value - scaled) << nbits
            self.range = lps << nbits
            binval = 1 - (state & 1)
            self.ctx[ctx_idx] = NEXT_STATE_LPS[state]
            self.bits_needed += nbits
            if self.bits_needed >= 0:
                self.value += self._byte() << self.bits_needed
                self.bits_needed -= 8
            return int(binval)

    def decode_bin_ep(self) -> int:
        self.value <<= 1
        self.bits_needed += 1
        if self.bits_needed >= 0:
            self.bits_needed = -8
            self.value += self._byte()
        scaled = self.range << 7
        if self.value >= scaled:
            self.value -= scaled
            return 1
        return 0

    def decode_bins_ep(self, nbins: int) -> int:
        out = 0
        while nbins > 8:
            self.value = (self.value << 8) + (self._byte() << (8 + self.bits_needed))
            scaled = self.range << 15
            for _ in range(8):
                scaled >>= 1
                if self.value >= scaled:
                    out = (out << 1) | 1
                    self.value -= scaled
                else:
                    out <<= 1
            nbins -= 8
        for _ in range(nbins):
            out = (out << 1) | self.decode_bin_ep()
        return out

    def decode_bin_trm(self) -> int:
        self.range -= 2
        scaled = self.range << 7
        if self.value >= scaled:
            return 1
        if scaled < (256 << 7):
            self.range = scaled >> 6
            self.value <<= 1
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self._byte()
        return 0
