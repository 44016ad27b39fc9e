"""NAL unit encapsulation: Annex-B start codes + emulation prevention.

Role of reference `encoder/nal.cpp` (serialize: start codes, 0x03 escape
insertion at `nal.cpp:127-153`, NAL header) re-implemented per ITU-T H.265
clauses 7.3.1.1 and 7.4.2.
"""

from __future__ import annotations

# nal_unit_type values (spec Table 7-1)
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_RASL_R = 9
NAL_BLA_W_LP = 16
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA_NUT = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS = 36
NAL_EOB = 37
NAL_FD = 38
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


def emulation_prevention(rbsp: bytes) -> bytes:
    """Insert 0x03 escape bytes (spec 7.4.2: forbid 0x000000..0x000003)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def strip_emulation_prevention(ebsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(ebsp):
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < len(ebsp) and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def nal_header(nal_type: int, layer_id: int = 0, temporal_id: int = 0
               ) -> bytes:
    """Two-byte nal_unit_header (spec 7.3.1.2)."""
    b0 = (0 << 7) | (nal_type << 1) | (layer_id >> 5)
    b1 = ((layer_id & 31) << 3) | (temporal_id + 1)
    return bytes([b0, b1])


def wrap_nal(nal_type: int, rbsp: bytes, long_start_code: bool = True,
             temporal_id: int = 0) -> bytes:
    start = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return start + nal_header(nal_type, 0, temporal_id) + \
        emulation_prevention(rbsp)


def split_annexb(stream: bytes):
    """Split an Annex-B stream into (nal_type, temporal_id, rbsp) tuples."""
    units = []
    i = 0
    n = len(stream)
    starts = []
    while i < n - 2:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    starts.append(None)
    for s, e in zip(starts[:-1], starts[1:]):
        end = n if e is None else (e - 3)
        # trim trailing zero bytes belonging to next start code
        while end > s and stream[end - 1] == 0:
            end -= 1
        payload = stream[s:end]
        if len(payload) < 2:
            continue
        nal_type = (payload[0] >> 1) & 0x3F
        tid = (payload[1] & 7) - 1
        units.append((nal_type, tid, strip_emulation_prevention(payload[2:])))
    return units
