"""SEI message writers (role of reference `encoder/sei.{h,cpp}`).

The port's subset of the JAX package's `bitstream/sei.py`: the stream-level
prefix messages the encoder writes (user data unregistered, mastering
display colour volume, content light level, alternative transfer
characteristics) and the HRD messages of a VBV encode (buffering period on
each IRAP access unit, picture timing on every one).  Payload framing per spec 7.3.5 (ff-byte escape for
type/size).
"""

from __future__ import annotations

from .bitio import BitWriter
from .nal import NAL_PREFIX_SEI, NAL_SUFFIX_SEI, wrap_nal

# payload types (spec Annex D)
SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_USER_DATA_UNREGISTERED = 5
SEI_MASTERING_DISPLAY = 137
SEI_CONTENT_LIGHT_LEVEL = 144
SEI_ALTERNATIVE_TRANSFER = 147


def _payload_data(bw: BitWriter) -> bytes:
    """SEI payload extraction with payload alignment (spec 7.3.5:
    payload_bit_equal_to_one + zero padding when not byte aligned)."""
    if not bw.byte_aligned():
        bw.write(1, 1)
        bw.write_align_zero()
    return bw.data()


def _sei_message(payload_type: int, payload: bytes) -> bytes:
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
    return bytes(out)


def wrap_sei(messages: list[tuple[int, bytes]], suffix: bool = False,
             temporal_id: int = 0) -> bytes:
    """One SEI NAL carrying the given (type, payload) messages."""
    body = b"".join(_sei_message(t, p) for t, p in messages)
    bw = BitWriter()
    bw.append_bytes(body)
    bw.rbsp_trailing_bits()
    return wrap_nal(NAL_SUFFIX_SEI if suffix else NAL_PREFIX_SEI,
                    bw.data(), temporal_id=temporal_id)


# ---- HRD conformance SEI (D.2.2/D.2.3; reference SEIBP/SEIPT sei.h) -------

def buffering_period(initial_delay_90k: int,
                     initial_offset_90k: int) -> bytes:
    """buffering_period SEI (spec D.2.2), NAL HRD, one CPB, matching
    the SPS hrd_parameters written by headers._write_hrd_parameters
    (24-bit delay fields).  Delays in 90 kHz ticks."""
    bw = BitWriter()
    bw.write_ue(0)                      # bp_seq_parameter_set_id
    bw.write_flag(0)                    # irap_cpb_params_present_flag
    bw.write_flag(0)                    # concatenation_flag
    bw.write(0, 24)                     # au_cpb_removal_delay_delta-1
    bw.write(min(initial_delay_90k, (1 << 24) - 1), 24)
    bw.write(min(initial_offset_90k, (1 << 24) - 1), 24)
    return _payload_data(bw)


def pic_timing(au_cpb_removal_delay: int,
               pic_dpb_output_delay: int) -> bytes:
    """pic_timing SEI (spec D.2.3) with CpbDpbDelaysPresent and
    frame_field_info off (matches the emitted VUI)."""
    bw = BitWriter()
    bw.write(max(au_cpb_removal_delay - 1, 0) & ((1 << 24) - 1), 24)
    bw.write(pic_dpb_output_delay & ((1 << 24) - 1), 24)
    return _payload_data(bw)


# ---- HDR static metadata ----------------------------------------------------

def mastering_display(primaries, white_point, max_lum: int,
                      min_lum: int) -> bytes:
    """primaries: 3x(x,y) in 0.00002 units (G,B,R order per spec),
    white_point: (x,y), luminance in 0.0001 cd/m2 units."""
    bw = BitWriter()
    for (x, y) in primaries:
        bw.write(x, 16)
        bw.write(y, 16)
    bw.write(white_point[0], 16)
    bw.write(white_point[1], 16)
    bw.write(max_lum, 32)
    bw.write(min_lum, 32)
    return _payload_data(bw)


def content_light_level(max_cll: int, max_fall: int) -> bytes:
    bw = BitWriter()
    bw.write(max_cll, 16)
    bw.write(max_fall, 16)
    return _payload_data(bw)


def parse_mastering_display_string(s: str):
    """Parse the x265 CLI format:
    G(x,y)B(x,y)R(x,y)WP(x,y)L(max,min)."""
    import re
    vals = [int(v) for v in re.findall(r"-?\d+", s)]
    if len(vals) != 10:
        raise ValueError("master-display needs 10 integers")
    g, b, r = (vals[0], vals[1]), (vals[2], vals[3]), (vals[4], vals[5])
    wp = (vals[6], vals[7])
    return [g, b, r], wp, vals[8], vals[9]


# ---- misc -------------------------------------------------------------------

X265AMOD_TPU_UUID = bytes.fromhex("2ca12c12d8e94bfaa6d0a8e04c9ed2a1")


def user_data_unregistered(text: bytes,
                           uuid: bytes = X265AMOD_TPU_UUID) -> bytes:
    assert len(uuid) == 16
    return uuid + text


def alternative_transfer(preferred_tc: int) -> bytes:
    bw = BitWriter()
    bw.write(preferred_tc, 8)
    return _payload_data(bw)
