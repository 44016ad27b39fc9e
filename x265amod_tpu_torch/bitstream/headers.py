"""High-level syntax writers: VPS / SPS / PPS / slice segment header.

Role of reference `encoder/entropy.cpp:233-379` (codeVPS/codeSPS/codePPS)
and `codeSliceHeader:593`, re-derived from ITU-T H.265 clause 7.3.2 and
7.3.6.  Header bins are plain fixed/exp-Golomb bits (no CABAC), written
host-side via BitWriter.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitio import BitWriter, BitReader

# HEVC level table subset: (level_idc, MaxLumaPs, MaxLumaSr)
# (spec Table A.8; reference encoder/level.cpp:40-60 carries the same)
_LEVELS = [
    (30, 36864, 552960), (60, 122880, 3686400), (63, 245760, 7372800),
    (90, 552960, 16588800), (93, 983040, 33177600),
    (120, 2228224, 66846720), (123, 2228224, 133693440),
    (150, 8912896, 267386880), (153, 8912896, 534773760),
    (156, 8912896, 1069547520), (180, 35651584, 1069547520),
    (183, 35651584, 2139095040), (186, 35651584, 4278190080),
]


def determine_level(width: int, height: int, fps: float) -> int:
    luma_ps = width * height
    luma_sr = luma_ps * fps
    for idc, max_ps, max_sr in _LEVELS:
        if luma_ps <= max_ps and luma_sr <= max_sr:
            return idc
    return 186


@dataclass
class SpsInfo:
    """Resolved sequence-level state shared by encoder and verifier."""
    width: int                # padded (multiple of min CB)
    height: int
    conf_win_right: int = 0   # in chroma units
    conf_win_bottom: int = 0
    bit_depth: int = 8
    chroma_format_idc: int = 1
    log2_ctb_size: int = 4
    log2_min_cb_size: int = 4
    log2_min_tb_size: int = 2
    log2_max_tb_size: int = 4
    max_transform_hierarchy_depth_intra: int = 0
    max_transform_hierarchy_depth_inter: int = 0
    log2_max_poc_lsb: int = 8
    amp_enabled: bool = False
    sao_enabled: bool = False
    strong_intra_smoothing: bool = False
    temporal_mvp: bool = False
    fps_num: int = 25
    fps_den: int = 1
    level_idc: int = 0
    profile_idc: int = 1      # 1 = Main, 2 = Main10
    num_negative_ref: int = 0  # simple low-delay RPS size (0 = all intra)
    max_num_reorder: int = 0   # > 0 when B frames reorder output
    max_dec_buffering: int = 0 # DPB size - 1 (0 -> derived from refs)
    # HRD (spec E.2.2; emitted when VBV is configured, reference
    # initHRD ratecontrol.cpp:888): 0 = no hrd_parameters in VUI
    hrd_bitrate: int = 0       # bits/s (vbv-maxrate)
    hrd_cpb_size: int = 0      # bits (vbv-bufsize)
    hrd_cbr: bool = False

    @property
    def ctb_size(self) -> int:
        return 1 << self.log2_ctb_size

    @property
    def pic_width_in_ctbs(self) -> int:
        return -(-self.width // self.ctb_size)

    @property
    def pic_height_in_ctbs(self) -> int:
        return -(-self.height // self.ctb_size)


@dataclass
class PpsInfo:
    init_qp: int = 26
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    sign_data_hiding: bool = False
    transform_skip_enabled: bool = False
    constrained_intra_pred: bool = False
    deblocking_disabled: bool = True
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    entropy_coding_sync: bool = False   # WPP
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    weighted_pred: bool = False
    loop_filter_across_slices: bool = True
    transquant_bypass: bool = False     # lossless coding


def _write_profile_tier_level(bw: BitWriter, sps: SpsInfo) -> None:
    bw.write(0, 2)                      # general_profile_space
    bw.write_flag(0)                    # general_tier_flag
    bw.write(sps.profile_idc, 5)        # general_profile_idc
    compat = [0] * 32
    compat[sps.profile_idc] = 1
    if sps.profile_idc == 1:
        compat[2] = 1                   # Main bitstreams obey Main10
    for f in compat:
        bw.write_flag(f)
    bw.write_flag(1)                    # general_progressive_source_flag
    bw.write_flag(0)                    # general_interlaced_source_flag
    bw.write_flag(0)                    # general_non_packed_constraint_flag
    bw.write_flag(1)                    # general_frame_only_constraint_flag
    bw.write(0, 22)                     # general_reserved_zero_43bits
    bw.write(0, 21)
    bw.write_flag(0)                    # general_inbld / reserved bit
    bw.write(sps.level_idc, 8)          # general_level_idc


def write_vps(sps: SpsInfo) -> bytes:
    bw = BitWriter()
    bw.write(0, 4)                      # vps_video_parameter_set_id
    bw.write_flag(1)                    # vps_base_layer_internal_flag
    bw.write_flag(1)                    # vps_base_layer_available_flag
    bw.write(0, 6)                      # vps_max_layers_minus1
    bw.write(0, 3)                      # vps_max_sub_layers_minus1
    bw.write_flag(1)                    # vps_temporal_id_nesting_flag
    bw.write(0xFFFF, 16)                # vps_reserved_0xffff_16bits
    _write_profile_tier_level(bw, sps)
    bw.write_flag(0)                    # vps_sub_layer_ordering_info_present
    bw.write_ue(max(1, sps.num_negative_ref,
                    sps.max_dec_buffering))  # vps_max_dec_pic_buffering_m1
    bw.write_ue(sps.max_num_reorder)    # vps_max_num_reorder_pics
    bw.write_ue(0)                      # vps_max_latency_increase_plus1
    bw.write(0, 6)                      # vps_max_layer_id
    bw.write_ue(0)                      # vps_num_layer_sets_minus1
    bw.write_flag(0)                    # vps_timing_info_present_flag
    bw.write_flag(0)                    # vps_extension_flag
    bw.rbsp_trailing_bits()
    return bw.data()


def hrd_scaled_values(bitrate_bps: int, cpb_bits: int):
    """HRD scale/value split (spec E.2.3: BitRate = (value+1) <<
    (6+scale), CpbSize = (value+1) << (4+scale)); reference initHRD
    (encoder/ratecontrol.cpp:888) picks the smallest scale that fits."""
    def split(v, base):
        scale = 0
        while scale < 15 and (v >> (base + scale + 1)) >= (1 << 16):
            scale += 1
        value = max(1, v >> (base + scale))
        return scale, value - 1
    br_scale, br_value = split(bitrate_bps, 6)
    cpb_scale, cpb_value = split(cpb_bits, 4)
    return br_scale, br_value, cpb_scale, cpb_value


def _write_hrd_parameters(bw: BitWriter, sps: "SpsInfo") -> None:
    """hrd_parameters (spec E.2.2), NAL HRD only, one CPB, one
    sub-layer; 24-bit delay fields like the reference (initHRD)."""
    br_scale, br_value, cpb_scale, cpb_value = hrd_scaled_values(
        sps.hrd_bitrate, sps.hrd_cpb_size)
    bw.write_flag(1)                    # nal_hrd_parameters_present
    bw.write_flag(0)                    # vcl_hrd_parameters_present
    bw.write_flag(0)                    # sub_pic_hrd_params_present
    bw.write(br_scale, 4)               # bit_rate_scale
    bw.write(cpb_scale, 4)              # cpb_size_scale
    bw.write(23, 5)                     # initial_cpb_removal_delay_len-1
    bw.write(23, 5)                     # au_cpb_removal_delay_length-1
    bw.write(23, 5)                     # dpb_output_delay_length-1
    # sub-layer 0
    bw.write_flag(1)                    # fixed_pic_rate_general_flag
    bw.write_ue(0)                      # elemental_duration_in_tc-1
    bw.write_ue(0)                      # cpb_cnt_minus1
    # sub_layer_hrd_parameters (NAL), CPB 0
    bw.write_ue(br_value)               # bit_rate_value_minus1
    bw.write_ue(cpb_value)              # cpb_size_value_minus1
    bw.write_flag(1 if sps.hrd_cbr else 0)   # cbr_flag


def write_sps(sps: SpsInfo) -> bytes:
    bw = BitWriter()
    bw.write(0, 4)                      # sps_video_parameter_set_id
    bw.write(0, 3)                      # sps_max_sub_layers_minus1
    bw.write_flag(1)                    # sps_temporal_id_nesting_flag
    _write_profile_tier_level(bw, sps)
    bw.write_ue(0)                      # sps_seq_parameter_set_id
    bw.write_ue(sps.chroma_format_idc)
    bw.write_ue(sps.width)
    bw.write_ue(sps.height)
    have_win = sps.conf_win_right or sps.conf_win_bottom
    bw.write_flag(1 if have_win else 0)
    if have_win:
        bw.write_ue(0)
        bw.write_ue(sps.conf_win_right)
        bw.write_ue(0)
        bw.write_ue(sps.conf_win_bottom)
    bw.write_ue(sps.bit_depth - 8)
    bw.write_ue(sps.bit_depth - 8)
    bw.write_ue(sps.log2_max_poc_lsb - 4)
    bw.write_flag(0)                    # sps_sub_layer_ordering_info_present
    bw.write_ue(max(1, sps.num_negative_ref,
                    sps.max_dec_buffering))  # max_dec_pic_buffering_minus1
    bw.write_ue(sps.max_num_reorder)    # sps_max_num_reorder_pics
    bw.write_ue(0)                      # sps_max_latency_increase_plus1
    bw.write_ue(sps.log2_min_cb_size - 3)
    bw.write_ue(sps.log2_ctb_size - sps.log2_min_cb_size)
    bw.write_ue(sps.log2_min_tb_size - 2)
    bw.write_ue(sps.log2_max_tb_size - sps.log2_min_tb_size)
    bw.write_ue(sps.max_transform_hierarchy_depth_inter)
    bw.write_ue(sps.max_transform_hierarchy_depth_intra)
    bw.write_flag(0)                    # scaling_list_enabled_flag
    bw.write_flag(1 if sps.amp_enabled else 0)
    bw.write_flag(1 if sps.sao_enabled else 0)
    bw.write_flag(0)                    # pcm_enabled_flag
    bw.write_ue(0)                      # num_short_term_ref_pic_sets
    bw.write_flag(0)                    # long_term_ref_pics_present_flag
    bw.write_flag(1 if sps.temporal_mvp else 0)
    bw.write_flag(1 if sps.strong_intra_smoothing else 0)
    # minimal VUI carrying frame timing
    bw.write_flag(1)                    # vui_parameters_present_flag
    bw.write_flag(0)                    # aspect_ratio_info_present_flag
    bw.write_flag(0)                    # overscan_info_present_flag
    bw.write_flag(0)                    # video_signal_type_present_flag
    bw.write_flag(0)                    # chroma_loc_info_present_flag
    bw.write_flag(0)                    # neutral_chroma_indication_flag
    bw.write_flag(0)                    # field_seq_flag
    bw.write_flag(0)                    # frame_field_info_present_flag
    bw.write_flag(0)                    # default_display_window_flag
    bw.write_flag(1)                    # vui_timing_info_present_flag
    bw.write(sps.fps_den, 32)           # vui_num_units_in_tick
    bw.write(sps.fps_num, 32)           # vui_time_scale
    bw.write_flag(0)                    # vui_poc_proportional_to_timing_flag
    if sps.hrd_bitrate > 0:
        bw.write_flag(1)                # vui_hrd_parameters_present_flag
        _write_hrd_parameters(bw, sps)
    else:
        bw.write_flag(0)                # vui_hrd_parameters_present_flag
    bw.write_flag(0)                    # bitstream_restriction_flag
    bw.write_flag(0)                    # sps_extension_present_flag
    bw.rbsp_trailing_bits()
    return bw.data()


def write_pps(pps: PpsInfo) -> bytes:
    bw = BitWriter()
    bw.write_ue(0)                      # pps_pic_parameter_set_id
    bw.write_ue(0)                      # pps_seq_parameter_set_id
    bw.write_flag(0)                    # dependent_slice_segments_enabled
    bw.write_flag(0)                    # output_flag_present_flag
    bw.write(0, 3)                      # num_extra_slice_header_bits
    bw.write_flag(1 if pps.sign_data_hiding else 0)
    bw.write_flag(0)                    # cabac_init_present_flag
    bw.write_ue(0)                      # num_ref_idx_l0_default_active_m1
    bw.write_ue(0)                      # num_ref_idx_l1_default_active_m1
    bw.write_se(pps.init_qp - 26)
    bw.write_flag(1 if pps.constrained_intra_pred else 0)
    bw.write_flag(1 if pps.transform_skip_enabled else 0)
    bw.write_flag(1 if pps.cu_qp_delta_enabled else 0)
    if pps.cu_qp_delta_enabled:
        bw.write_ue(pps.diff_cu_qp_delta_depth)
    bw.write_se(pps.cb_qp_offset)
    bw.write_se(pps.cr_qp_offset)
    bw.write_flag(0)                    # pps_slice_chroma_qp_offsets_present
    bw.write_flag(1 if pps.weighted_pred else 0)
    bw.write_flag(0)                    # weighted_bipred_flag
    bw.write_flag(1 if pps.transquant_bypass else 0)
    bw.write_flag(0)                    # tiles_enabled_flag
    bw.write_flag(1 if pps.entropy_coding_sync else 0)
    bw.write_flag(1 if pps.loop_filter_across_slices else 0)
    bw.write_flag(1)                    # deblocking_filter_control_present
    bw.write_flag(0)                    # deblocking_filter_override_enabled
    bw.write_flag(1 if pps.deblocking_disabled else 0)
    if not pps.deblocking_disabled:
        bw.write_se(pps.beta_offset_div2)
        bw.write_se(pps.tc_offset_div2)
    bw.write_flag(0)                    # pps_scaling_list_data_present_flag
    bw.write_flag(0)                    # lists_modification_present_flag
    bw.write_ue(0)                      # log2_parallel_merge_level_minus2
    bw.write_flag(0)                    # slice_segment_header_extension
    bw.write_flag(0)                    # pps_extension_present_flag
    bw.rbsp_trailing_bits()
    return bw.data()


def write_slice_header(sps: SpsInfo, pps: PpsInfo, slice_type: str,
                       slice_qp: int, nal_type: int, poc: int = 0,
                       num_entry_points: int = 0,
                       entry_point_offsets: list[int] | None = None,
                       sao_luma: bool = False, sao_chroma: bool = False,
                       rps_neg: list[tuple[int, int]] | None = None,
                       rps_pos: list[tuple[int, int]] | None = None,
                       max_merge: int = 2, num_ref0: int = 1,
                       ) -> BitWriter:
    """Write slice segment header; returns the open BitWriter so the
    caller can byte-align and splice the CABAC payload.

    rps_neg/rps_pos: inline short-term RPS (spec 7.3.7) as lists of
    (distance, used_by_curr) with distance = |poc - ref_poc| > 0 in
    ascending order.  When None, a simple low-delay RPS of
    sps.num_negative_ref immediately-previous pictures is written.
    """
    from ..bitstream.nal import NAL_IDR_W_RADL, NAL_IDR_N_LP, NAL_CRA_NUT
    bw = BitWriter()
    bw.write_flag(1)                    # first_slice_segment_in_pic_flag
    if NAL_IDR_W_RADL <= nal_type <= 23:  # IRAP
        bw.write_flag(0)                # no_output_of_prior_pics_flag
    bw.write_ue(0)                      # slice_pic_parameter_set_id
    st = {"B": 0, "P": 1, "I": 2}[slice_type]
    bw.write_ue(st)
    is_idr = nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)
    if not is_idr:
        bw.write(poc % (1 << sps.log2_max_poc_lsb), sps.log2_max_poc_lsb)
        bw.write_flag(0)                # short_term_ref_pic_set_sps_flag
        if rps_neg is None:
            rps_neg = [(i + 1, 1) for i in range(sps.num_negative_ref)]
        if rps_pos is None:
            rps_pos = []
        bw.write_ue(len(rps_neg))       # num_negative_pics
        bw.write_ue(len(rps_pos))       # num_positive_pics
        prev = 0
        for dist, used in rps_neg:
            bw.write_ue(dist - prev - 1)    # delta_poc_s0_minus1
            bw.write_flag(used)             # used_by_curr_pic_s0_flag
            prev = dist
        prev = 0
        for dist, used in rps_pos:
            bw.write_ue(dist - prev - 1)    # delta_poc_s1_minus1
            bw.write_flag(used)             # used_by_curr_pic_s1_flag
            prev = dist
        if sps.temporal_mvp:
            bw.write_flag(1)            # slice_temporal_mvp_enabled_flag
    if sps.sao_enabled:
        bw.write_flag(1 if sao_luma else 0)
        bw.write_flag(1 if sao_chroma else 0)
    if st != 2:
        # num_ref_idx_active_override: PPS default is 1 per list; a
        # multi-ref P slice overrides L0 (spec 7.4.7.1; the ref list is
        # cyclic-filled from the RPS when fewer pictures are available,
        # 8.3.4)
        bw.write_flag(1 if num_ref0 > 1 else 0)
        if num_ref0 > 1:
            bw.write_ue(num_ref0 - 1)   # num_ref_idx_l0_active_minus1
            if st == 0:
                bw.write_ue(0)          # num_ref_idx_l1_active_minus1
        if st == 0:
            bw.write_flag(0)            # mvd_l1_zero_flag
        if sps.temporal_mvp and st == 1:
            bw.write_flag(0)            # collocated_from_l0 defaults; omit
        bw.write_ue(5 - max_merge)      # five_minus_max_num_merge_cand
    bw.write_se(slice_qp - pps.init_qp)
    if pps.entropy_coding_sync:
        bw.write_ue(num_entry_points)
        if num_entry_points:
            offsets = entry_point_offsets or []
            assert len(offsets) == num_entry_points
            max_len = max(o.bit_length() for o in offsets)
            bw.write_ue(max_len - 1)    # offset_len_minus1
            for o in offsets:
                bw.write(o - 1, max_len)  # entry_point_offset_minus1
    # byte_alignment()
    bw.write(1, 1)
    bw.write_align_zero()
    return bw
