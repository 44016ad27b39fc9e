"""CABAC constant tables from ITU-T H.265 (02/2018), clause 9.3.

All tables here are normative constants of the HEVC standard (identical in
every conformant codec; cf. reference x265 `common/constants.cpp:484` /
`encoder/entropy.cpp:42-230` which carry the same ITU values).

Context-model initialization values are stored indexed by ``initType``
(spec 9.3.2.2): 0 = I slice, 1 = P slice, 2 = B slice (default
``cabac_init_flag = 0`` mapping).
"""

from __future__ import annotations

import numpy as np

# --- Arithmetic engine tables (spec Tables 9-46, 9-47, 9-48) ---------------

# rangeTabLps[pStateIdx][qRangeIdx], qRangeIdx = (ivlCurrRange >> 6) & 3
RANGE_TAB_LPS = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9],
    [2, 2, 2, 2],
], dtype=np.int32)

# transIdxLps[pStateIdx] (spec Table 9-47)
TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
], dtype=np.int32)

# transIdxMps[pStateIdx] (spec Table 9-47)
TRANS_IDX_MPS = np.array(
    [min(i + 1, 62) for i in range(63)] + [63], dtype=np.int32)

# --- Context model init values (spec Tables 9-5 .. 9-32) -------------------
# Each entry: initValues[initType][ctxIdx]; initType: 0=I, 1=P, 2=B.
CNU = 154

INIT_VALUES = {
    # coding quadtree / CU level
    "split_cu_flag": [[139, 141, 157], [107, 139, 126], [107, 139, 126]],
    "cu_transquant_bypass_flag": [[154], [154], [154]],
    "cu_skip_flag": [[CNU, CNU, CNU], [197, 185, 201], [197, 185, 201]],
    "pred_mode_flag": [[CNU], [149], [134]],
    "part_mode": [[184, CNU, CNU, CNU], [154, 139, 154, 154],
                  [154, 139, 154, 154]],
    "prev_intra_luma_pred_flag": [[184], [154], [183]],
    "intra_chroma_pred_mode": [[63, 139], [152, 139], [152, 139]],
    # inter
    "merge_flag": [[CNU], [110], [154]],
    "merge_idx": [[CNU], [122], [137]],
    "inter_pred_idc": [[CNU] * 5, [95, 79, 63, 31, 31], [95, 79, 63, 31, 31]],
    "ref_idx": [[CNU, CNU], [153, 153], [153, 153]],
    "abs_mvd_greater_flag": [[CNU, CNU], [140, 198], [169, 198]],
    "mvp_flag": [[CNU], [168], [168]],
    "rqt_root_cbf": [[CNU], [79], [79]],
    # transform tree
    "split_transform_flag": [[153, 138, 138], [124, 138, 94],
                             [224, 167, 122]],
    # cbf_luma uses entries [0..1], cbf_cb/cr entries [2..6] of qt_cbf
    "qt_cbf": [[111, 141, 94, 138, 182, 154, 154],
               [153, 111, 149, 107, 167, 154, 154],
               [153, 111, 149, 92, 167, 154, 154]],
    "cu_qp_delta_abs": [[154, 154, 154], [154, 154, 154], [154, 154, 154]],
    "transform_skip_flag": [[139, 139], [139, 139], [139, 139]],
    # residual coding
    "last_sig_coeff_prefix": [  # x then y, 15 luma + 3 chroma each
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
         111, 79, 108, 123, 63,
         110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
         111, 79, 108, 123, 63],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108,
         125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108],
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111,
         111, 79, 108, 123, 93,
         125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111,
         111, 79, 108, 123, 93]],
    "coded_sub_block_flag": [  # 2 luma + 2 chroma
        [91, 171, 134, 141], [121, 140, 61, 154], [121, 140, 61, 154]],
    "sig_coeff_flag": [  # 27 luma + 15 chroma = 42
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179,
         153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
         125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111,
         136, 139, 111],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136,
         153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140,
         151, 183, 140],
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136,
         153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140,
         151, 183, 140]],
    "coeff_abs_level_greater1_flag": [  # 16 luma + 8 chroma
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139,
         107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
         121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
         121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182]],
    "coeff_abs_level_greater2_flag": [  # 4 luma + 2 chroma
        [138, 153, 136, 167, 152, 152], [107, 167, 91, 122, 107, 167],
        [107, 167, 91, 107, 107, 167]],
    # SAO
    "sao_merge_flag": [[153], [153], [153]],
    "sao_type_idx": [[200], [185], [160]],
}

# Order in which contexts are laid out in the flat state vector.  The flat
# layout lets WPP context save/restore and (later) the native coder treat
# the whole context state as one small array.
CTX_LAYOUT = [
    "split_cu_flag", "cu_transquant_bypass_flag", "cu_skip_flag",
    "pred_mode_flag", "part_mode", "prev_intra_luma_pred_flag",
    "intra_chroma_pred_mode", "merge_flag", "merge_idx", "inter_pred_idc",
    "ref_idx", "abs_mvd_greater_flag", "mvp_flag", "rqt_root_cbf",
    "split_transform_flag", "qt_cbf", "cu_qp_delta_abs",
    "transform_skip_flag", "last_sig_coeff_prefix", "coded_sub_block_flag",
    "sig_coeff_flag", "coeff_abs_level_greater1_flag",
    "coeff_abs_level_greater2_flag", "sao_merge_flag", "sao_type_idx",
]

CTX_OFFSET = {}
_off = 0
for _name in CTX_LAYOUT:
    CTX_OFFSET[_name] = _off
    _off += len(INIT_VALUES[_name][0])
NUM_CTX = _off


def init_context_states(slice_type: str, qp: int) -> np.ndarray:
    """Spec 9.3.2.2 context-variable initialization.

    Returns an array of shape (NUM_CTX, 2): columns (pStateIdx, valMps).
    slice_type in {"I", "P", "B"} (cabac_init_flag=0 mapping).
    """
    init_type = {"I": 0, "P": 1, "B": 2}[slice_type]
    qp = int(np.clip(qp, 0, 51))
    states = np.zeros((NUM_CTX, 2), dtype=np.int32)
    for name in CTX_LAYOUT:
        base = CTX_OFFSET[name]
        for i, init_value in enumerate(INIT_VALUES[name][init_type]):
            slope = (init_value >> 4) * 5 - 45
            offset = ((init_value & 15) << 3) - 16
            pre = np.clip(((slope * qp) >> 4) + offset, 1, 126)
            if pre <= 63:
                states[base + i] = (63 - pre, 0)
            else:
                states[base + i] = (pre - 64, 1)
    return states


# --- Entropy bit-estimation table (fractional bits, 1/32768 units) ---------
# entropyBits[pStateIdx][bin==MPS?0:1] approximates -log2(prob) << 15.
# Regenerated from first principles (probability model of spec Table 9-46
# state machine): the canonical table used for RDO bit estimation.
def _gen_entropy_bits() -> np.ndarray:
    # Follow the standard CABAC probability model: p_lps(state) =
    # alpha^state * 0.5 with alpha = (0.01875/0.5)**(1/63).
    alpha = (0.01875 / 0.5) ** (1.0 / 63.0)
    bits = np.zeros((64, 2), dtype=np.int64)
    for s in range(64):
        p_lps = 0.5 * (alpha ** s)
        bits[s, 1] = int(round(-np.log2(p_lps) * 32768))
        bits[s, 0] = int(round(-np.log2(1.0 - p_lps) * 32768))
    return bits


ENTROPY_BITS = _gen_entropy_bits()
