"""Bit-level writers/readers for HEVC syntax (host side).

Covers the roles of reference `common/bitstream.{h,cpp}` (bit packer,
uvlc/svlc exp-Golomb writer) with a Python implementation; the hot CABAC
byte stream is produced by the native coder, this module handles headers.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit packer (reference semantics: `common/bitstream.h:63`)."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._bitpos = 0          # bits used in current partial byte
        self._cur = 0

    def write(self, value: int, bits: int) -> None:
        if bits == 0:
            return
        assert 0 <= value < (1 << bits), (value, bits)
        for shift in range(bits - 1, -1, -1):
            self._cur = (self._cur << 1) | ((value >> shift) & 1)
            self._bitpos += 1
            if self._bitpos == 8:
                self._bytes.append(self._cur)
                self._cur = 0
                self._bitpos = 0

    def write_flag(self, flag: int | bool) -> None:
        self.write(1 if flag else 0, 1)

    def write_ue(self, value: int) -> None:
        """Unsigned exp-Golomb (ue(v))."""
        assert value >= 0
        code = value + 1
        length = code.bit_length()
        self.write(0, length - 1)
        self.write(code, length)

    def write_se(self, value: int) -> None:
        """Signed exp-Golomb (se(v)): 0,1,-1,2,-2.. -> 0,1,2,3,4.."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_align_one(self) -> None:
        while self._bitpos != 0:
            self.write(1, 1)

    def write_align_zero(self) -> None:
        while self._bitpos != 0:
            self.write(0, 1)

    def rbsp_trailing_bits(self) -> None:
        self.write(1, 1)
        self.write_align_zero()

    @property
    def bit_count(self) -> int:
        return len(self._bytes) * 8 + self._bitpos

    def byte_aligned(self) -> bool:
        return self._bitpos == 0

    def append_bytes(self, data: bytes) -> None:
        assert self._bitpos == 0, "must be byte aligned to splice bytes"
        self._bytes.extend(data)

    def data(self) -> bytes:
        assert self._bitpos == 0, "stream not byte aligned"
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader for verification/decoding."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def read(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self._data[self._pos >> 3] if (self._pos >> 3) < len(
                self._data) else 0
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def read_flag(self) -> int:
        return self.read(1)

    def read_ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
            assert zeros < 64, "corrupt ue(v)"
        return (1 << zeros) - 1 + (self.read(zeros) if zeros else 0)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) // 2 if (k & 1) else -(k // 2)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_pos(self) -> int:
        return self._pos

    def more_data(self) -> bool:
        return self._pos < len(self._data) * 8
