// Native CABAC slice finalizer.
//
// Role of reference encoder/entropy.cpp (encodeBin/encodeBinEP/writeOut
// + codeCoeffNxN): the arithmetic coder and residual-syntax serializer
// run as ONE host call per slice over the device-produced decision
// arrays (modes + quantized levels), re-derived from ITU-T H.265
// 9.3.3/9.3.4 + 7.3.8.  The port's copy of the JAX package's
// native/cabac.cpp (which tests/test_native_cabac.py holds against its
// Python syntax oracle); the port's streams are held byte for byte against
// the JAX package's by tests/test_torch_{slice,encoder}.py.
//
// Build: x265amod_tpu_torch/native/__init__.py runs g++ -O3 -shared -fPIC
// into build/x265amod_tpu_torch/libhevc_cabac.so at first use.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- spec arithmetic tables (H.265 Tables 9-46..9-48) ----------------
static const uint8_t kLpsTable[64][4] = {
    {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
    {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
    {95,116,137,158},{90,110,130,150},{85,104,123,142},{81,99,117,135},
    {77,94,111,128},{73,89,105,122},{69,85,100,116},{66,80,95,110},
    {62,76,90,104},{59,72,86,99},{56,69,81,94},{53,65,77,89},
    {51,62,73,85},{48,59,69,80},{46,56,66,76},{43,53,63,72},
    {41,50,59,69},{39,48,56,65},{37,45,54,62},{35,43,51,59},
    {33,41,48,56},{32,39,46,53},{30,37,43,50},{29,35,41,48},
    {27,33,39,45},{26,31,37,43},{24,30,35,41},{23,28,33,39},
    {22,27,32,37},{21,26,30,35},{20,24,29,33},{19,23,27,31},
    {18,22,26,30},{17,21,25,28},{16,20,23,27},{15,19,22,25},
    {14,18,21,24},{14,17,20,23},{13,16,19,22},{12,15,18,21},
    {12,14,17,20},{11,14,16,19},{11,13,15,18},{10,12,15,17},
    {10,12,14,16},{9,11,13,15},{9,11,12,14},{8,10,12,14},
    {8,9,11,13},{7,9,11,12},{7,9,10,12},{7,8,10,11},
    {6,8,9,11},{6,7,9,10},{6,7,8,9},{2,2,2,2}};

static const uint8_t kTransLps[64] = {
    0,0,1,2,2,4,4,5,6,7,8,9,9,11,11,12,13,13,15,15,16,16,18,18,19,19,
    21,21,22,22,23,24,24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,
    33,33,34,34,35,35,35,36,36,36,37,37,37,38,38,63};

// ---- context layout (must match cabac/tables.py CTX_LAYOUT) ----------
// Offsets are injected from Python at init time to guarantee agreement.
struct CtxLayout {
  int32_t part_mode, prev_intra, chroma_pred, qt_cbf, last_x, last_y,
      csbf, sig, gt1, gt2, num_ctx;
};

struct Cabac {
  uint32_t low = 0, range = 510, bits_outstanding = 0;
  bool first_bit = true;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  std::vector<uint8_t> bytes;
  std::vector<uint8_t> state;   // pStateIdx
  std::vector<uint8_t> mps;

  void write_bit(int b) {
    bitbuf = (bitbuf << 1) | (uint32_t)b;
    if (++bitcnt == 8) {
      bytes.push_back((uint8_t)bitbuf);
      bitbuf = 0;
      bitcnt = 0;
    }
  }
  void put_bit(int b) {
    if (first_bit) first_bit = false; else write_bit(b);
    while (bits_outstanding > 0) { write_bit(1 - b); bits_outstanding--; }
  }
  void renorm() {
    while (range < 256) {
      if (low < 256) put_bit(0);
      else if (low >= 512) { low -= 512; put_bit(1); }
      else { low -= 256; bits_outstanding++; }
      range <<= 1;
      low <<= 1;
    }
  }
  void encode_bin(int ctx, int bin) {
    uint32_t s = state[ctx];
    uint32_t lps = kLpsTable[s][(range >> 6) & 3];
    range -= lps;
    if (bin != mps[ctx]) {
      low += range;
      range = lps;
      if (s == 0) mps[ctx] = 1 - mps[ctx];
      state[ctx] = kTransLps[s];
    } else {
      state[ctx] = s < 62 ? s + 1 : s;
    }
    renorm();
  }
  void encode_bypass(int bin) {
    low <<= 1;
    if (bin) low += range;
    if (low >= 1024) { put_bit(1); low -= 1024; }
    else if (low < 512) put_bit(0);
    else { low -= 512; bits_outstanding++; }
  }
  void encode_bypass_bins(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) encode_bypass((v >> i) & 1);
  }
  void encode_terminate(int bin) {
    range -= 2;
    if (bin) {
      low += range;
      // flush
      range = 2;
      renorm();
      put_bit((low >> 9) & 1);
      uint32_t v = ((low >> 7) & 3) | 1;
      write_bit((v >> 1) & 1);
      write_bit(v & 1);
    } else {
      renorm();
    }
  }
  void finish() {
    while (bitcnt != 0) write_bit(0);
  }
};

// diag scan generation (spec 6.5.3)
static void diag_scan(int size, int32_t* xs, int32_t* ys) {
  int i = 0, x = 0, y = 0;
  while (i < size * size) {
    while (y >= 0) {
      if (x < size && y < size) { xs[i] = x; ys[i] = y; i++; }
      y--; x++;
    }
    y = x; x = 0;
  }
}

static const int32_t kCtxIdxMap4x4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};

static int sig_ctx_inc(int xc, int yc, int log2n, int c_idx, int scan_idx,
                       int right, int below) {
  int sig;
  if (log2n == 2) {
    sig = kCtxIdxMap4x4[(yc << 2) + xc];
  } else if (xc + yc == 0) {
    sig = 0;
  } else {
    int prev = right + 2 * below;
    int xp = xc & 3, yp = yc & 3;
    if (prev == 0) sig = (xp + yp == 0) ? 2 : (xp + yp < 3 ? 1 : 0);
    else if (prev == 1) sig = (yp == 0) ? 2 : (yp == 1 ? 1 : 0);
    else if (prev == 2) sig = (xp == 0) ? 2 : (xp == 1 ? 1 : 0);
    else sig = 2;
    if (c_idx == 0) {
      if ((xc >> 2) + (yc >> 2) > 0) sig += 3;
      sig += (log2n == 3) ? (scan_idx == 0 ? 9 : 15) : 21;
    } else {
      sig += (log2n == 3) ? 9 : 12;
    }
  }
  return sig + (c_idx ? 27 : 0);
}

static int last_group(int pos) {
  if (pos < 4) return pos;
  int k = 31 - __builtin_clz((unsigned)pos);
  return 2 * k + ((pos >> (k - 1)) & 1);
}
static int last_min_in_group(int g) {
  if (g < 4) return g;
  return (2 + (g & 1)) << ((g >> 1) - 1);
}

struct ScanTabs {
  int32_t fx[1024], fy[1024];   // full-TU scan
  int32_t sbx[64], sby[64];     // subblock scan
  int32_t ix[16], iy[16];       // 4x4 inner scan
};

static void build_diag_scans(int log2n, ScanTabs* t) {
  int n = 1 << log2n;
  diag_scan(4, t->ix, t->iy);
  if (n > 4) {
    diag_scan(n >> 2, t->sbx, t->sby);
    int k = 0;
    for (int s = 0; s < (n >> 2) * (n >> 2); s++)
      for (int c = 0; c < 16; c++, k++) {
        t->fx[k] = t->sbx[s] * 4 + t->ix[c];
        t->fy[k] = t->sby[s] * 4 + t->iy[c];
      }
  } else {
    t->sbx[0] = t->sby[0] = 0;
    for (int c = 0; c < 16; c++) { t->fx[c] = t->ix[c]; t->fy[c] = t->iy[c]; }
  }
}

static void write_remaining(Cabac& e, uint32_t value, int rice) {
  uint32_t prefix = value >> rice;
  if (prefix < 3) {
    for (uint32_t i = 0; i < prefix; i++) e.encode_bypass(1);
    e.encode_bypass(0);
    e.encode_bypass_bins(value & ((1u << rice) - 1), rice);
  } else {
    uint32_t q = prefix - 3;
    int length = 31 - __builtin_clz(q + 1);
    uint32_t rem = q - ((1u << length) - 1);
    for (int i = 0; i < 3 + length; i++) e.encode_bypass(1);
    e.encode_bypass(0);
    e.encode_bypass_bins((rem << rice) + (value & ((1u << rice) - 1)),
                         length + rice);
  }
}

static CtxLayout g_layout;

static void residual_coding(Cabac& e, const int32_t* lv, int log2n,
                            int c_idx, const ScanTabs& t, int sbh = 0) {
  const int n = 1 << log2n;
  const int scan_idx = 0;  // diag (v1 pipeline)
  int last_pos = -1;
  for (int i = n * n - 1; i >= 0; i--) {
    if (lv[t.fy[i] * n + t.fx[i]] != 0) { last_pos = i; break; }
  }
  // last position
  int xl = t.fx[last_pos], yl = t.fy[last_pos];
  int off, shift;
  if (c_idx == 0) {
    off = 3 * (log2n - 2) + ((log2n - 1) >> 2);
    shift = (log2n + 1) >> 2;
  } else { off = 15; shift = log2n - 2; }
  int cmax = (log2n << 1) - 1;
  int coords[2] = {xl, yl};
  int bases[2] = {g_layout.last_x, g_layout.last_y};
  for (int c = 0; c < 2; c++) {
    int g = last_group(coords[c]);
    for (int b = 0; b < (g < cmax ? g : cmax); b++)
      e.encode_bin(bases[c] + off + (b >> shift), 1);
    if (g < cmax) e.encode_bin(bases[c] + off + (g >> shift), 0);
  }
  for (int c = 0; c < 2; c++) {
    int g = last_group(coords[c]);
    if (g > 3)
      e.encode_bypass_bins(coords[c] - last_min_in_group(g), (g >> 1) - 1);
  }

  const int n_sb = n > 4 ? (n >> 2) : 1;
  int32_t csbf[64] = {0};
  for (int sy = 0; sy < n_sb; sy++)
    for (int sx = 0; sx < n_sb; sx++) {
      int any = 0;
      for (int yy = 0; yy < 4 && !any; yy++)
        for (int xx = 0; xx < 4; xx++)
          if (lv[(sy * 4 + yy) * n + sx * 4 + xx]) { any = 1; break; }
      csbf[sy * n_sb + sx] = any;
    }

  int last_sb = last_pos >> 4;
  int c1 = 1;
  for (int i = last_sb; i >= 0; i--) {
    int sbx = t.sbx[i], sby = t.sby[i];
    int right = sbx + 1 < n_sb ? csbf[sby * n_sb + sbx + 1] : 0;
    int below = sby + 1 < n_sb ? csbf[(sby + 1) * n_sb + sbx] : 0;
    bool infer_dc = false;
    int coded;
    if (i == last_sb || i == 0) coded = 1;
    else {
      coded = csbf[sby * n_sb + sbx];
      int ctx = (right + below > 0 ? 1 : 0) + (c_idx ? 2 : 0);
      e.encode_bin(g_layout.csbf + ctx, coded);
      infer_dc = coded != 0;
    }
    if (!coded) continue;

    int start = (i < last_sb) ? 15 : (last_pos & 15) - 1;
    int sig_pos[16];
    int num_sig = 0;
    bool any_sig = false;
    if (i == last_sb) { sig_pos[num_sig++] = last_pos & 15; any_sig = true; }
    for (int np = start; np >= 0; np--) {
      int xc = sbx * 4 + t.ix[np];
      int yc = sby * 4 + t.iy[np];
      int sig = lv[yc * n + xc] != 0;
      if (np == 0 && infer_dc && !any_sig) {
        // inferred significant
      } else {
        e.encode_bin(g_layout.sig +
                     sig_ctx_inc(xc, yc, log2n, c_idx, scan_idx, right,
                                 below), sig);
      }
      if (sig) { sig_pos[num_sig++] = np; any_sig = true; }
    }

    int abs_c[16], sgn[16];
    for (int k = 0; k < num_sig; k++) {
      int xc = sbx * 4 + t.ix[sig_pos[k]];
      int yc = sby * 4 + t.iy[sig_pos[k]];
      int v = lv[yc * n + xc];
      abs_c[k] = v < 0 ? -v : v;
      sgn[k] = v < 0;
    }
    int ctx_set = (i > 0 && c_idx == 0) ? 2 : 0;
    if (c1 == 0) ctx_set++;
    c1 = 1;
    int num_c1 = num_sig < 8 ? num_sig : 8;
    int gt1[8];
    int first_gt1 = -1;
    for (int k = 0; k < num_c1; k++) {
      int f = abs_c[k] > 1;
      int ctx = ctx_set * 4 + (c1 < 3 ? c1 : 3) + (c_idx ? 16 : 0);
      e.encode_bin(g_layout.gt1 + ctx, f);
      gt1[k] = f;
      if (f) { if (first_gt1 < 0) first_gt1 = k; c1 = 0; }
      else if (c1 > 0 && c1 < 3) c1++;
    }
    if (first_gt1 >= 0)
      e.encode_bin(g_layout.gt2 + ctx_set + (c_idx ? 4 : 0),
                   abs_c[first_gt1] > 2);
    // sign data hiding (spec 7.4.9.11): the first significant
    // coefficient's sign is inferred from level-sum parity
    int sign_hidden = 0;
    if (sbh && num_sig > 1 &&
        sig_pos[0] - sig_pos[num_sig - 1] > 3)
      sign_hidden = 1;
    for (int k = 0; k < num_sig - sign_hidden; k++)
      e.encode_bypass(sgn[k]);
    int rice = 0, first2 = 1;
    for (int k = 0; k < num_sig; k++) {
      int base_level = k < 8 ? 2 + first2 : 1;
      if (abs_c[k] >= base_level) {
        write_remaining(e, (uint32_t)(abs_c[k] - base_level), rice);
        if (abs_c[k] > (3 << rice)) rice = rice < 4 ? rice + 1 : 4;
      }
      if (abs_c[k] >= 2) first2 = 0;
    }
  }
}

static void mpm_from_left(int a, int mpms[3]) {
  // above neighbor is always DC (above-CTU rule with 16px CTUs)
  if (a == 1) { mpms[0] = 0; mpms[1] = 1; mpms[2] = 26; return; }
  if (a == 0) { mpms[0] = 0; mpms[1] = 1; mpms[2] = 26; return; }
  mpms[0] = a; mpms[1] = 1; mpms[2] = 0;
}

}  // namespace

extern "C" {

// Must be called once before encoding; offsets from Python CTX_OFFSET.
void hevc_cabac_set_layout(const int32_t* offs, int32_t num_ctx) {
  g_layout.part_mode = offs[0];
  g_layout.prev_intra = offs[1];
  g_layout.chroma_pred = offs[2];
  g_layout.qt_cbf = offs[3];
  g_layout.last_x = offs[4];
  g_layout.last_y = offs[5];
  g_layout.csbf = offs[6];
  g_layout.sig = offs[7];
  g_layout.gt1 = offs[8];
  g_layout.gt2 = offs[9];
  g_layout.num_ctx = num_ctx;
}

// init_states: [num_ctx*2] (pStateIdx, valMps) from Python
// (init_context_states).  Returns bytes written or -1 if out_cap small.
int64_t hevc_encode_islice_ctu16(
    const int32_t* modes, const int32_t* levels_y,
    const int32_t* levels_cb, const int32_t* levels_cr,
    int32_t hc, int32_t wc, const int32_t* init_states,
    uint8_t* out, int64_t out_cap) {
  Cabac e;
  e.state.resize(g_layout.num_ctx);
  e.mps.resize(g_layout.num_ctx);
  for (int i = 0; i < g_layout.num_ctx; i++) {
    e.state[i] = (uint8_t)init_states[2 * i];
    e.mps[i] = (uint8_t)init_states[2 * i + 1];
  }
  ScanTabs t16, t8;
  build_diag_scans(4, &t16);
  build_diag_scans(3, &t8);

  for (int cy = 0; cy < hc; cy++) {
    for (int cx = 0; cx < wc; cx++) {
      int idx = cy * wc + cx;
      int mode = modes[idx];
      const int32_t* ly = levels_y + (int64_t)idx * 256;
      const int32_t* lcb = levels_cb + (int64_t)idx * 64;
      const int32_t* lcr = levels_cr + (int64_t)idx * 64;

      e.encode_bin(g_layout.part_mode, 1);  // PART_2Nx2N
      int mpms[3];
      mpm_from_left(cx > 0 ? modes[idx - 1] : 1, mpms);
      int mi = -1;
      for (int k = 0; k < 3; k++) if (mode == mpms[k]) { mi = k; break; }
      if (mi >= 0) {
        e.encode_bin(g_layout.prev_intra, 1);
        e.encode_bypass(mi != 0);
        if (mi) e.encode_bypass(mi - 1);
      } else {
        e.encode_bin(g_layout.prev_intra, 0);
        int rem = mode;
        int srt[3] = {mpms[0], mpms[1], mpms[2]};
        if (srt[0] > srt[1]) { int x = srt[0]; srt[0] = srt[1]; srt[1] = x; }
        if (srt[1] > srt[2]) { int x = srt[1]; srt[1] = srt[2]; srt[2] = x; }
        if (srt[0] > srt[1]) { int x = srt[0]; srt[0] = srt[1]; srt[1] = x; }
        for (int k = 2; k >= 0; k--) if (rem > srt[k]) rem--;
        e.encode_bypass_bins((uint32_t)rem, 5);
      }
      e.encode_bin(g_layout.chroma_pred, 0);  // DM

      int cbf_y = 0, cbf_cb = 0, cbf_cr = 0;
      for (int k = 0; k < 256 && !cbf_y; k++) cbf_y = ly[k] != 0;
      for (int k = 0; k < 64 && !cbf_cb; k++) cbf_cb = lcb[k] != 0;
      for (int k = 0; k < 64 && !cbf_cr; k++) cbf_cr = lcr[k] != 0;
      e.encode_bin(g_layout.qt_cbf + 2, cbf_cb);
      e.encode_bin(g_layout.qt_cbf + 2, cbf_cr);
      e.encode_bin(g_layout.qt_cbf + 1, cbf_y);
      if (cbf_y) residual_coding(e, ly, 4, 0, t16);
      if (cbf_cb) residual_coding(e, lcb, 3, 1, t8);
      if (cbf_cr) residual_coding(e, lcr, 3, 2, t8);

      bool last = (cy == hc - 1) && (cx == wc - 1);
      e.encode_terminate(last ? 1 : 0);
    }
  }
  e.finish();
  if ((int64_t)e.bytes.size() > out_cap) return -1;
  std::memcpy(out, e.bytes.data(), e.bytes.size());
  return (int64_t)e.bytes.size();
}

}  // extern "C"

// ---- P-slice syntax ---------------------------------------------------

struct CtxLayout2 {
  int32_t cu_skip, pred_mode, merge_flag, merge_idx, mvd, mvp, root_cbf;
  int32_t inter_dir;
};
static CtxLayout2 g_layout2;

extern "C" void hevc_cabac_set_layout2(const int32_t* offs) {
  g_layout2.cu_skip = offs[0];
  g_layout2.pred_mode = offs[1];
  g_layout2.merge_flag = offs[2];
  g_layout2.merge_idx = offs[3];
  g_layout2.mvd = offs[4];
  g_layout2.mvp = offs[5];
  g_layout2.root_cbf = offs[6];
  g_layout2.inter_dir = offs[7];
}

namespace {

void write_ep_exgolomb(Cabac& e, uint32_t value, int k) {
  while (value >= (1u << k)) {
    e.encode_bypass(1);
    value -= 1u << k;
    k++;
  }
  e.encode_bypass(0);
  e.encode_bypass_bins(value, k);
}

void encode_mvd(Cabac& e, int mvd_x, int mvd_y) {
  int ax = mvd_x < 0 ? -mvd_x : mvd_x;
  int ay = mvd_y < 0 ? -mvd_y : mvd_y;
  e.encode_bin(g_layout2.mvd, ax ? 1 : 0);
  e.encode_bin(g_layout2.mvd, ay ? 1 : 0);
  if (ax) e.encode_bin(g_layout2.mvd + 1, ax > 1 ? 1 : 0);
  if (ay) e.encode_bin(g_layout2.mvd + 1, ay > 1 ? 1 : 0);
  if (ax) {
    if (ax > 1) write_ep_exgolomb(e, (uint32_t)(ax - 2), 1);
    e.encode_bypass(mvd_x < 0 ? 1 : 0);
  }
  if (ay) {
    if (ay > 1) write_ep_exgolomb(e, (uint32_t)(ay - 2), 1);
    e.encode_bypass(mvd_y < 0 ? 1 : 0);
  }
}

void encode_merge_idx(Cabac& e, int idx, int max_merge) {
  if (max_merge <= 1) return;
  e.encode_bin(g_layout2.merge_idx, idx > 0 ? 1 : 0);
  for (int k = 1; k < idx; k++) e.encode_bypass(1);
  if (idx > 0 && idx < max_merge - 1) e.encode_bypass(0);
}

}  // namespace

// kinds: 0=skip 1=inter 2=intra; levels as in the I-slice entry.
extern "C" int64_t hevc_encode_pslice_ctu16(
    const int32_t* kinds, const int32_t* merge_idx, const int32_t* mvd,
    const int32_t* mvp_idx, const int32_t* modes, const int32_t* levels_y,
    const int32_t* levels_cb, const int32_t* levels_cr,
    int32_t hc, int32_t wc, int32_t max_merge,
    const int32_t* init_states, uint8_t* out, int64_t out_cap) {
  Cabac e;
  e.state.resize(g_layout.num_ctx);
  e.mps.resize(g_layout.num_ctx);
  for (int i = 0; i < g_layout.num_ctx; i++) {
    e.state[i] = (uint8_t)init_states[2 * i];
    e.mps[i] = (uint8_t)init_states[2 * i + 1];
  }
  ScanTabs t16, t8;
  build_diag_scans(4, &t16);
  build_diag_scans(3, &t8);

  for (int cy = 0; cy < hc; cy++) {
    for (int cx = 0; cx < wc; cx++) {
      int idx = cy * wc + cx;
      int kind = kinds[idx];
      int left_skip = cx > 0 ? (kinds[idx - 1] == 0) : 0;
      int above_skip = cy > 0 ? (kinds[idx - wc] == 0) : 0;
      e.encode_bin(g_layout2.cu_skip + left_skip + above_skip,
                   kind == 0 ? 1 : 0);
      if (kind == 0) {
        encode_merge_idx(e, merge_idx[idx], max_merge);
      } else {
        const int32_t* ly = levels_y + (int64_t)idx * 256;
        const int32_t* lcb = levels_cb + (int64_t)idx * 64;
        const int32_t* lcr = levels_cr + (int64_t)idx * 64;
        int cbf_y = 0, cbf_cb = 0, cbf_cr = 0;
        for (int k = 0; k < 256 && !cbf_y; k++) cbf_y = ly[k] != 0;
        for (int k = 0; k < 64 && !cbf_cb; k++) cbf_cb = lcb[k] != 0;
        for (int k = 0; k < 64 && !cbf_cr; k++) cbf_cr = lcr[k] != 0;
        int intra = kind == 2;
        e.encode_bin(g_layout2.pred_mode, intra);
        e.encode_bin(g_layout.part_mode, 1);
        if (intra) {
          int cand_a = 1;
          if (cx > 0 && kinds[idx - 1] == 2) cand_a = modes[idx - 1];
          int mpms[3];
          mpm_from_left(cand_a, mpms);
          int mode = modes[idx];
          int mi = -1;
          for (int k = 0; k < 3; k++) if (mode == mpms[k]) { mi = k; break; }
          if (mi >= 0) {
            e.encode_bin(g_layout.prev_intra, 1);
            e.encode_bypass(mi != 0);
            if (mi) e.encode_bypass(mi - 1);
          } else {
            e.encode_bin(g_layout.prev_intra, 0);
            int rem = mode;
            int srt[3] = {mpms[0], mpms[1], mpms[2]};
            if (srt[0] > srt[1]) { int x = srt[0]; srt[0] = srt[1]; srt[1] = x; }
            if (srt[1] > srt[2]) { int x = srt[1]; srt[1] = srt[2]; srt[2] = x; }
            if (srt[0] > srt[1]) { int x = srt[0]; srt[0] = srt[1]; srt[1] = x; }
            for (int k = 2; k >= 0; k--) if (rem > srt[k]) rem--;
            e.encode_bypass_bins((uint32_t)rem, 5);
          }
          e.encode_bin(g_layout.chroma_pred, 0);
          e.encode_bin(g_layout.qt_cbf + 2, cbf_cb);
          e.encode_bin(g_layout.qt_cbf + 2, cbf_cr);
          e.encode_bin(g_layout.qt_cbf + 1, cbf_y);
          if (cbf_y) residual_coding(e, ly, 4, 0, t16);
          if (cbf_cb) residual_coding(e, lcb, 3, 1, t8);
          if (cbf_cr) residual_coding(e, lcr, 3, 2, t8);
        } else {
          e.encode_bin(g_layout2.merge_flag, 0);
          encode_mvd(e, mvd[idx * 2], mvd[idx * 2 + 1]);
          e.encode_bin(g_layout2.mvp, mvp_idx[idx]);
          int root = (cbf_y || cbf_cb || cbf_cr) ? 1 : 0;
          e.encode_bin(g_layout2.root_cbf, root);
          if (root) {
            e.encode_bin(g_layout.qt_cbf + 2, cbf_cb);
            e.encode_bin(g_layout.qt_cbf + 2, cbf_cr);
            if (cbf_cb || cbf_cr) e.encode_bin(g_layout.qt_cbf + 1, cbf_y);
            if (cbf_y) residual_coding(e, ly, 4, 0, t16);
            if (cbf_cb) residual_coding(e, lcb, 3, 1, t8);
            if (cbf_cr) residual_coding(e, lcr, 3, 2, t8);
          }
        }
      }
      bool last = (cy == hc - 1) && (cx == wc - 1);
      e.encode_terminate(last ? 1 : 0);
    }
  }
  e.finish();
  if ((int64_t)e.bytes.size() > out_cap) return -1;
  std::memcpy(out, e.bytes.data(), e.bytes.size());
  return (int64_t)e.bytes.size();
}


// ---- B-slice syntax (two reference lists, one active ref per list) -----

namespace {

void encode_intra_in_inter(Cabac& e, int mode, int cand_a,
                           int cbf_y, int cbf_cb, int cbf_cr,
                           const int32_t* ly, const int32_t* lcb,
                           const int32_t* lcr, const ScanTabs& t16,
                           const ScanTabs& t8) {
  int mpms[3];
  mpm_from_left(cand_a, mpms);
  int mi = -1;
  for (int k = 0; k < 3; k++) if (mode == mpms[k]) { mi = k; break; }
  if (mi >= 0) {
    e.encode_bin(g_layout.prev_intra, 1);
    e.encode_bypass(mi != 0);
    if (mi) e.encode_bypass(mi - 1);
  } else {
    e.encode_bin(g_layout.prev_intra, 0);
    int rem = mode;
    int srt[3] = {mpms[0], mpms[1], mpms[2]};
    if (srt[0] > srt[1]) { int x = srt[0]; srt[0] = srt[1]; srt[1] = x; }
    if (srt[1] > srt[2]) { int x = srt[1]; srt[1] = srt[2]; srt[2] = x; }
    if (srt[0] > srt[1]) { int x = srt[0]; srt[0] = srt[1]; srt[1] = x; }
    for (int k = 2; k >= 0; k--) if (rem > srt[k]) rem--;
    e.encode_bypass_bins((uint32_t)rem, 5);
  }
  e.encode_bin(g_layout.chroma_pred, 0);
  e.encode_bin(g_layout.qt_cbf + 2, cbf_cb);
  e.encode_bin(g_layout.qt_cbf + 2, cbf_cr);
  e.encode_bin(g_layout.qt_cbf + 1, cbf_y);
  if (cbf_y) residual_coding(e, ly, 4, 0, t16);
  if (cbf_cb) residual_coding(e, lcb, 3, 1, t8);
  if (cbf_cr) residual_coding(e, lcr, 3, 2, t8);
}

}  // namespace

// kinds 0=skip 1=inter 2=intra; inter_dir 1=L0 2=L1 3=BI;
// mvd0/mvd1 packed [n][2]; mirrors cabac.syntax.encode_b_ctu16.
extern "C" int64_t hevc_encode_bslice_ctu16(
    const int32_t* kinds, const int32_t* merge_idx,
    const int32_t* inter_dir, const int32_t* mvd0, const int32_t* mvp0,
    const int32_t* mvd1, const int32_t* mvp1, const int32_t* modes,
    const int32_t* levels_y, const int32_t* levels_cb,
    const int32_t* levels_cr, int32_t hc, int32_t wc, int32_t max_merge,
    const int32_t* init_states, uint8_t* out, int64_t out_cap) {
  Cabac e;
  e.state.resize(g_layout.num_ctx);
  e.mps.resize(g_layout.num_ctx);
  for (int i = 0; i < g_layout.num_ctx; i++) {
    e.state[i] = (uint8_t)init_states[2 * i];
    e.mps[i] = (uint8_t)init_states[2 * i + 1];
  }
  ScanTabs t16, t8;
  build_diag_scans(4, &t16);
  build_diag_scans(3, &t8);

  for (int cy = 0; cy < hc; cy++) {
    for (int cx = 0; cx < wc; cx++) {
      int idx = cy * wc + cx;
      int kind = kinds[idx];
      int left_skip = cx > 0 ? (kinds[idx - 1] == 0) : 0;
      int above_skip = cy > 0 ? (kinds[idx - wc] == 0) : 0;
      e.encode_bin(g_layout2.cu_skip + left_skip + above_skip,
                   kind == 0 ? 1 : 0);
      if (kind == 0) {
        encode_merge_idx(e, merge_idx[idx], max_merge);
      } else {
        const int32_t* ly = levels_y + (int64_t)idx * 256;
        const int32_t* lcb = levels_cb + (int64_t)idx * 64;
        const int32_t* lcr = levels_cr + (int64_t)idx * 64;
        int cbf_y = 0, cbf_cb = 0, cbf_cr = 0;
        for (int k = 0; k < 256 && !cbf_y; k++) cbf_y = ly[k] != 0;
        for (int k = 0; k < 64 && !cbf_cb; k++) cbf_cb = lcb[k] != 0;
        for (int k = 0; k < 64 && !cbf_cr; k++) cbf_cr = lcr[k] != 0;
        int intra = kind == 2;
        e.encode_bin(g_layout2.pred_mode, intra);
        e.encode_bin(g_layout.part_mode, 1);
        if (intra) {
          int cand_a = 1;
          if (cx > 0 && kinds[idx - 1] == 2) cand_a = modes[idx - 1];
          encode_intra_in_inter(e, modes[idx], cand_a, cbf_y, cbf_cb,
                                cbf_cr, ly, lcb, lcr, t16, t8);
        } else {
          e.encode_bin(g_layout2.merge_flag, 0);
          int d = inter_dir[idx];
          // inter_pred_idc: bin0 ctx CtDepth(0): BI; else bin1 ctx 4
          e.encode_bin(g_layout2.inter_dir + 0, d == 3 ? 1 : 0);
          if (d != 3) e.encode_bin(g_layout2.inter_dir + 4,
                                   d == 2 ? 1 : 0);
          if (d != 2) {                     // uses L0
            encode_mvd(e, mvd0[idx * 2], mvd0[idx * 2 + 1]);
            e.encode_bin(g_layout2.mvp, mvp0[idx]);
          }
          if (d != 1) {                     // uses L1
            encode_mvd(e, mvd1[idx * 2], mvd1[idx * 2 + 1]);
            e.encode_bin(g_layout2.mvp, mvp1[idx]);
          }
          int root = (cbf_y || cbf_cb || cbf_cr) ? 1 : 0;
          e.encode_bin(g_layout2.root_cbf, root);
          if (root) {
            e.encode_bin(g_layout.qt_cbf + 2, cbf_cb);
            e.encode_bin(g_layout.qt_cbf + 2, cbf_cr);
            if (cbf_cb || cbf_cr) e.encode_bin(g_layout.qt_cbf + 1, cbf_y);
            if (cbf_y) residual_coding(e, ly, 4, 0, t16);
            if (cbf_cb) residual_coding(e, lcb, 3, 1, t8);
            if (cbf_cr) residual_coding(e, lcr, 3, 2, t8);
          }
        }
      }
      bool last = (cy == hc - 1) && (cx == wc - 1);
      e.encode_terminate(last ? 1 : 0);
    }
  }
  e.finish();
  if ((int64_t)e.bytes.size() > out_cap) return -1;
  std::memcpy(out, e.bytes.data(), e.bytes.size());
  return (int64_t)e.bytes.size();
}

// ---- unified slice serializer ------------------------------------------
//
// One entry point covering I/P/B slices, flat CTU16 and CTU32 depth-1
// quadtree, per-CU QP deltas (AQ), SAO parameters and WPP substreams —
// so NO encoder configuration falls back to the per-CTU Python loops
// (reference analog: Entropy::encodeCTU over all tool combinations,
// encoder/entropy.cpp:768).  Mirrors cabac/syntax.py +
// models/encoder.py::_encode_slice_payload bit-for-bit (enforced by
// tests/test_native_cabac.py).

struct CtxLayout3 {
  int32_t split_cu, cu_qp_delta, sao_merge, sao_type, ref_idx, tq_bypass;
};
static CtxLayout3 g_layout3;

extern "C" void hevc_cabac_set_layout3(const int32_t* offs) {
  g_layout3.split_cu = offs[0];
  g_layout3.cu_qp_delta = offs[1];
  g_layout3.sao_merge = offs[2];
  g_layout3.sao_type = offs[3];
  g_layout3.ref_idx = offs[4];
  g_layout3.tq_bypass = offs[5];
}

namespace {

struct SliceCtx {
  int st;                       // 0=I 1=P 2=B
  int ctb_log2, hc, wc, w16, h16;
  const int32_t *split, *kinds, *modes, *merge, *idir;
  const int32_t *mvd0, *mvp0, *mvd1, *mvp1;
  const int32_t *ref0;          // L0 ref_idx per 16-cell (multi-ref)
  int num_ref0;
  const int32_t *ly, *lcb, *lcr;
  const int32_t *qp16, *qp32;
  const int32_t *sao_l, *sao_c;
  int slice_qp, max_merge;
  int sbh;
  int tqb;        // cu_transquant_bypass_flag of every CU, -1: not coded
  int qp_prev;
  int qg_coded;   // IsCuQpDeltaCoded for the current QG (== CTB)
  ScanTabs t32, t16, t8;
};

void nc_cu_qp_delta(Cabac& e, int delta) {
  int a = delta < 0 ? -delta : delta;
  int prefix = a < 5 ? a : 5;
  for (int k = 0; k < prefix; k++)
    e.encode_bin(g_layout3.cu_qp_delta + (k ? 1 : 0), 1);
  if (prefix < 5) e.encode_bin(g_layout3.cu_qp_delta + (prefix ? 1 : 0), 0);
  if (a >= 5) write_ep_exgolomb(e, (uint32_t)(a - 5), 0);
  if (a) e.encode_bypass(delta < 0 ? 1 : 0);
}

void nc_sao_offsets_abs(Cabac& e, const int32_t* o) {
  for (int k = 0; k < 4; k++) {
    int a = o[k] < 0 ? -o[k] : o[k];
    for (int i = 0; i < a; i++) e.encode_bypass(1);
    if (a < 7) e.encode_bypass(0);
  }
}

void nc_sao_bo_tail(Cabac& e, const int32_t* o, int bp) {
  for (int k = 0; k < 4; k++)
    if (o[k]) e.encode_bypass(o[k] < 0 ? 1 : 0);
  e.encode_bypass_bins((uint32_t)bp, 5);
}

void nc_sao_ctu(Cabac& e, const SliceCtx& s, int cy, int cx) {
  if (!s.sao_l && !s.sao_c) return;
  if (cx > 0) e.encode_bin(g_layout3.sao_merge, 0);
  if (cy > 0) e.encode_bin(g_layout3.sao_merge, 0);
  int k = cy * s.wc + cx;
  if (s.sao_l) {
    const int32_t* L = s.sao_l + (int64_t)k * 7;  // t, eo, bp, off[4]
    int t = L[0];
    e.encode_bin(g_layout3.sao_type, t ? 1 : 0);
    if (t) {
      e.encode_bypass(t == 2 ? 1 : 0);
      nc_sao_offsets_abs(e, L + 3);
      if (t == 1) nc_sao_bo_tail(e, L + 3, L[2]);
      else e.encode_bypass_bins((uint32_t)L[1], 2);
    }
  }
  if (s.sao_c) {
    const int32_t* C = s.sao_c + (int64_t)k * 14;
    int t = C[0];  // t, eo, bp_cb, off_cb[4], bp_cr, off_cr[4]
    e.encode_bin(g_layout3.sao_type, t ? 1 : 0);
    if (t) {
      e.encode_bypass(t == 2 ? 1 : 0);
      nc_sao_offsets_abs(e, C + 3);
      if (t == 1) nc_sao_bo_tail(e, C + 3, C[2]);
      else e.encode_bypass_bins((uint32_t)C[1], 2);
      nc_sao_offsets_abs(e, C + 8);
      if (t == 1) nc_sao_bo_tail(e, C + 8, C[7]);
    }
  }
}

void mpm_list2(int a, int b, int m[3]) {
  if (a == b) {
    if (a < 2) { m[0] = 0; m[1] = 1; m[2] = 26; return; }
    m[0] = a; m[1] = 2 + ((a + 29) % 32); m[2] = 2 + ((a - 1) % 32);
    return;
  }
  m[0] = a; m[1] = b;
  if (a != 0 && b != 0) m[2] = 0;
  else if (a != 1 && b != 1) m[2] = 1;
  else m[2] = 26;
}

void nc_intra_luma_mode(Cabac& e, int mode, const int m[3]) {
  int mi = -1;
  for (int k = 0; k < 3; k++) if (mode == m[k]) { mi = k; break; }
  if (mi >= 0) {
    e.encode_bin(g_layout.prev_intra, 1);
    e.encode_bypass(mi != 0);
    if (mi) e.encode_bypass(mi - 1);
  } else {
    e.encode_bin(g_layout.prev_intra, 0);
    int rem = mode;
    int srt[3] = {m[0], m[1], m[2]};
    if (srt[0] > srt[1]) { int x = srt[0]; srt[0] = srt[1]; srt[1] = x; }
    if (srt[1] > srt[2]) { int x = srt[1]; srt[1] = srt[2]; srt[2] = x; }
    if (srt[0] > srt[1]) { int x = srt[0]; srt[0] = srt[1]; srt[1] = x; }
    for (int k = 2; k >= 0; k--) if (rem > srt[k]) rem--;
    e.encode_bypass_bins((uint32_t)rem, 5);
  }
}

// Gather one CU's level arrays; for cells==2 assembles the TU32 (and
// TU16 chroma) from the four quadrant 16-cells into buf.
struct CuLevels {
  const int32_t *y, *cb, *cr;
  int cbf_y, cbf_cb, cbf_cr;
};

CuLevels cu_levels(const SliceCtx& s, int bx, int by, int cells,
                   int32_t* buf /* >= 32*32 + 2*16*16 */) {
  CuLevels r;
  if (cells == 1) {
    int64_t idx = (int64_t)by * s.w16 + bx;
    r.y = s.ly + idx * 256;
    r.cb = s.lcb + idx * 64;
    r.cr = s.lcr + idx * 64;
  } else {
    int32_t* y32 = buf;
    int32_t* cb16 = buf + 1024;
    int32_t* cr16 = buf + 1024 + 256;
    for (int qy = 0; qy < 2; qy++)
      for (int qx = 0; qx < 2; qx++) {
        int64_t idx = (int64_t)(by + qy) * s.w16 + bx + qx;
        const int32_t* sy = s.ly + idx * 256;
        const int32_t* scb = s.lcb + idx * 64;
        const int32_t* scr = s.lcr + idx * 64;
        for (int yy = 0; yy < 16; yy++)
          for (int xx = 0; xx < 16; xx++)
            y32[(qy * 16 + yy) * 32 + qx * 16 + xx] = sy[yy * 16 + xx];
        for (int yy = 0; yy < 8; yy++)
          for (int xx = 0; xx < 8; xx++) {
            cb16[(qy * 8 + yy) * 16 + qx * 8 + xx] = scb[yy * 8 + xx];
            cr16[(qy * 8 + yy) * 16 + qx * 8 + xx] = scr[yy * 8 + xx];
          }
      }
    r.y = y32; r.cb = cb16; r.cr = cr16;
  }
  int ny = cells == 2 ? 1024 : 256, nc = cells == 2 ? 256 : 64;
  r.cbf_y = r.cbf_cb = r.cbf_cr = 0;
  for (int k = 0; k < ny && !r.cbf_y; k++) r.cbf_y = r.y[k] != 0;
  for (int k = 0; k < nc && !r.cbf_cb; k++) r.cbf_cb = r.cb[k] != 0;
  for (int k = 0; k < nc && !r.cbf_cr; k++) r.cbf_cr = r.cr[k] != 0;
  return r;
}

// delta handling shared by all CU shapes: returns the delta to signal
// (when qp16 active and the CU has coded coefficients) and updates prev.
bool cu_delta(SliceCtx& s, int bx, int by, int cells, int any_cbf,
              int* delta) {
  if (!s.qp16 || s.qg_coded) return false;
  int qp = cells == 2 ? s.qp32[(by / 2) * s.wc + bx / 2]
                      : s.qp16[by * s.w16 + bx];
  if (!any_cbf) return false;
  *delta = qp - s.qp_prev;
  s.qp_prev = qp;
  s.qg_coded = 1;
  return true;
}

void cu_residuals(Cabac& e, SliceCtx& s, const CuLevels& L, int cells) {
  const ScanTabs& tl = cells == 2 ? s.t32 : s.t16;
  const ScanTabs& tc = cells == 2 ? s.t16 : s.t8;
  int log2l = cells == 2 ? 5 : 4;
  if (L.cbf_y) residual_coding(e, L.y, log2l, 0, tl, s.sbh);
  if (L.cbf_cb) residual_coding(e, L.cb, log2l - 1, 1, tc, s.sbh);
  if (L.cbf_cr) residual_coding(e, L.cr, log2l - 1, 2, tc, s.sbh);
}

// intra CU of size cells*16 at 16-cell (bx, by).  in_inter: coded after
// a pred_mode/part_mode prefix inside a P/B slice (part handled by
// caller); standalone I-slice CUs code part_mode at min CB size here.
void code_intra_cu(Cabac& e, SliceCtx& s, int bx, int by, int cells,
                   bool in_inter, int32_t* buf) {
  if (!in_inter && cells == 1) e.encode_bin(g_layout.part_mode, 1);
  int64_t idx = (int64_t)by * s.w16 + bx;
  int cand_a = 1, cand_b = 1;
  if (bx > 0 && (s.st == 0 || s.kinds[idx - 1] == 2))
    cand_a = s.modes[idx - 1];
  if (s.ctb_log2 == 5 && (by & 1) == 1 &&
      (s.st == 0 || s.kinds[idx - s.w16] == 2))
    cand_b = s.modes[idx - s.w16];
  int m[3];
  mpm_list2(cand_a, cand_b, m);
  nc_intra_luma_mode(e, s.modes[idx], m);
  e.encode_bin(g_layout.chroma_pred, 0);          // DM chroma
  CuLevels L = cu_levels(s, bx, by, cells, buf);
  e.encode_bin(g_layout.qt_cbf + 2, L.cbf_cb);
  e.encode_bin(g_layout.qt_cbf + 2, L.cbf_cr);
  e.encode_bin(g_layout.qt_cbf + 1, L.cbf_y);
  int delta;
  if (cu_delta(s, bx, by, cells, L.cbf_y || L.cbf_cb || L.cbf_cr,
               &delta))
    nc_cu_qp_delta(e, delta);
  cu_residuals(e, s, L, cells);
}

// non-skip inter CU (merge_flag == 0 AMVP form).
void code_inter_cu(Cabac& e, SliceCtx& s, int bx, int by, int cells,
                   int ct_depth, int32_t* buf) {
  int64_t idx = (int64_t)by * s.w16 + bx;
  e.encode_bin(g_layout2.merge_flag, 0);
  if (s.st == 2) {
    int d = s.idir[idx];
    e.encode_bin(g_layout2.inter_dir + ct_depth, d == 3 ? 1 : 0);
    if (d != 3) e.encode_bin(g_layout2.inter_dir + 4, d == 2 ? 1 : 0);
    if (d != 2) {
      encode_mvd(e, s.mvd0[idx * 2], s.mvd0[idx * 2 + 1]);
      e.encode_bin(g_layout2.mvp, s.mvp0[idx]);
    }
    if (d != 1) {
      encode_mvd(e, s.mvd1[idx * 2], s.mvd1[idx * 2 + 1]);
      e.encode_bin(g_layout2.mvp, s.mvp1[idx]);
    }
  } else {
    // ref_idx_l0 (7.3.8.6): TR cMax = num_ref - 1, bins 0-1 ctx-coded
    if (s.num_ref0 > 1) {
      int ri = s.ref0 ? s.ref0[idx] : 0;
      int cmax = s.num_ref0 - 1;
      for (int k = 0; k < ri; k++) {
        if (k < 2) e.encode_bin(g_layout3.ref_idx + k, 1);
        else e.encode_bypass(1);
      }
      if (ri < cmax) {
        if (ri < 2) e.encode_bin(g_layout3.ref_idx + ri, 0);
        else e.encode_bypass(0);
      }
    }
    encode_mvd(e, s.mvd0[idx * 2], s.mvd0[idx * 2 + 1]);
    e.encode_bin(g_layout2.mvp, s.mvp0[idx]);
  }
  CuLevels L = cu_levels(s, bx, by, cells, buf);
  int root = (L.cbf_y || L.cbf_cb || L.cbf_cr) ? 1 : 0;
  e.encode_bin(g_layout2.root_cbf, root);
  if (root) {
    e.encode_bin(g_layout.qt_cbf + 2, L.cbf_cb);
    e.encode_bin(g_layout.qt_cbf + 2, L.cbf_cr);
    if (L.cbf_cb || L.cbf_cr) e.encode_bin(g_layout.qt_cbf + 1, L.cbf_y);
    int delta;
    if (cu_delta(s, bx, by, cells, 1, &delta)) nc_cu_qp_delta(e, delta);
    cu_residuals(e, s, L, cells);
  }
}

void code_cu(Cabac& e, SliceCtx& s, int bx, int by, int cells,
             int ct_depth, int32_t* buf) {
  // cu_transquant_bypass_flag: the CU's first element (spec 7.3.8.5)
  if (s.tqb >= 0) e.encode_bin(g_layout3.tq_bypass, s.tqb);
  if (s.st == 0) {
    code_intra_cu(e, s, bx, by, cells, false, buf);
    return;
  }
  int64_t idx = (int64_t)by * s.w16 + bx;
  int kind = s.kinds[idx];
  int left_skip = bx > 0 ? (s.kinds[idx - 1] == 0) : 0;
  int above_skip = by > 0 ? (s.kinds[idx - s.w16] == 0) : 0;
  e.encode_bin(g_layout2.cu_skip + left_skip + above_skip,
               kind == 0 ? 1 : 0);
  if (kind == 0) {
    encode_merge_idx(e, s.merge[idx], s.max_merge);
    return;
  }
  int intra = kind == 2;
  e.encode_bin(g_layout2.pred_mode, intra);
  // part_mode: always coded for inter; for intra only at min CB size
  if (!intra || cells == 1) e.encode_bin(g_layout.part_mode, 1);
  if (intra) code_intra_cu(e, s, bx, by, cells, true, buf);
  else code_inter_cu(e, s, bx, by, cells, ct_depth, buf);
}

void code_ctu(Cabac& e, SliceCtx& s, int cy, int cx, int32_t* buf) {
  nc_sao_ctu(e, s, cy, cx);
  s.qg_coded = 0;                 // new quantization group (QG == CTB)
  if (s.ctb_log2 == 5) {
    int sp = s.split[(int64_t)cy * s.wc + cx];
    int ctx = ((cx > 0 && s.split[(int64_t)cy * s.wc + cx - 1]) ? 1 : 0)
        + ((cy > 0 && s.split[(int64_t)(cy - 1) * s.wc + cx]) ? 1 : 0);
    e.encode_bin(g_layout3.split_cu + ctx, sp);
    int bx = 2 * cx, by = 2 * cy;
    if (sp) {
      for (int q = 0; q < 4; q++)
        code_cu(e, s, bx + (q & 1), by + (q >> 1), 1, 1, buf);
    } else {
      code_cu(e, s, bx, by, 2, 0, buf);
    }
  } else {
    code_cu(e, s, cx, cy, 1, 0, buf);
  }
}

void init_cabac(Cabac& e, const int32_t* init_states) {
  e.state.resize(g_layout.num_ctx);
  e.mps.resize(g_layout.num_ctx);
  for (int i = 0; i < g_layout.num_ctx; i++) {
    e.state[i] = (uint8_t)init_states[2 * i];
    e.mps[i] = (uint8_t)init_states[2 * i + 1];
  }
}

}  // namespace

// Returns total payload bytes (all substreams concatenated), or -1 on
// overflow.  entry_sizes (len hc, used hc-1) receives per-substream
// byte counts when wpp != 0.  NULLable: split (ctb16), kinds/merge (I),
// idir/mvd1/mvp1 (I/P), qp16/qp32 (no AQ), sao_l/sao_c (no SAO).
// tq_bypass: -1 when the PPS disables transquant bypass, else the
// cu_transquant_bypass_flag every CU codes (1 under lossless).
extern "C" int64_t hevc_encode_slice(
    int32_t slice_type, int32_t ctb_log2, int32_t hc, int32_t wc,
    const int32_t* split, const int32_t* kinds, const int32_t* modes,
    const int32_t* merge_idx, const int32_t* inter_dir,
    const int32_t* mvd0, const int32_t* mvp0,
    const int32_t* mvd1, const int32_t* mvp1,
    const int32_t* levels_y, const int32_t* levels_cb,
    const int32_t* levels_cr, const int32_t* qp16, const int32_t* qp32,
    const int32_t* sao_luma, const int32_t* sao_chroma,
    const int32_t* ref0, int32_t num_ref0,
    int32_t slice_qp, int32_t max_merge, int32_t wpp, int32_t sbh,
    int32_t tq_bypass, const int32_t* init_states, int32_t* entry_sizes,
    uint8_t* out, int64_t out_cap) {
  SliceCtx s;
  s.st = slice_type;
  s.ctb_log2 = ctb_log2;
  s.hc = hc; s.wc = wc;
  int scale = ctb_log2 == 5 ? 2 : 1;
  s.w16 = wc * scale; s.h16 = hc * scale;
  s.split = split; s.kinds = kinds; s.modes = modes;
  s.merge = merge_idx; s.idir = inter_dir;
  s.mvd0 = mvd0; s.mvp0 = mvp0; s.mvd1 = mvd1; s.mvp1 = mvp1;
  s.ref0 = ref0; s.num_ref0 = num_ref0;
  s.ly = levels_y; s.lcb = levels_cb; s.lcr = levels_cr;
  s.qp16 = qp16; s.qp32 = qp32;
  s.sao_l = sao_luma; s.sao_c = sao_chroma;
  s.slice_qp = slice_qp; s.max_merge = max_merge;
  s.sbh = sbh;
  s.tqb = tq_bypass;
  s.qp_prev = slice_qp;
  s.qg_coded = 0;
  build_diag_scans(5, &s.t32);
  build_diag_scans(4, &s.t16);
  build_diag_scans(3, &s.t8);
  int32_t buf[1024 + 2 * 256];

  int64_t total = 0;
  if (!wpp || hc <= 1) {
    Cabac e;
    init_cabac(e, init_states);
    for (int cy = 0; cy < hc; cy++)
      for (int cx = 0; cx < wc; cx++) {
        code_ctu(e, s, cy, cx, buf);
        e.encode_terminate((cy == hc - 1 && cx == wc - 1) ? 1 : 0);
      }
    e.finish();
    if ((int64_t)e.bytes.size() > out_cap) return -1;
    std::memcpy(out, e.bytes.data(), e.bytes.size());
    return (int64_t)e.bytes.size();
  }
  // WPP: one substream per CTU row, context inheritance from col 1 of
  // the row above (spec 9.3.1 / frameencoder.cpp:1595-1597)
  std::vector<uint8_t> row_state, row_mps;
  bool have_row = false;
  for (int cy = 0; cy < hc; cy++) {
    Cabac e;
    if (cy == 0 || !have_row) {
      init_cabac(e, init_states);
    } else {
      e.state = row_state;
      e.mps = row_mps;
    }
    if (qp16) s.qp_prev = slice_qp;    // qPY_PREV resets per row
    for (int cx = 0; cx < wc; cx++) {
      code_ctu(e, s, cy, cx, buf);
      if (cx == 1) { row_state = e.state; row_mps = e.mps;
                     have_row = true; }
      e.encode_terminate((cy == hc - 1 && cx == wc - 1) ? 1 : 0);
    }
    if (cy < hc - 1) e.encode_terminate(1);   // end_of_subset_one_bit
    e.finish();
    if (total + (int64_t)e.bytes.size() > out_cap) return -1;
    std::memcpy(out + total, e.bytes.data(), e.bytes.size());
    if (entry_sizes) entry_sizes[cy] = (int32_t)e.bytes.size();
    total += (int64_t)e.bytes.size();
  }
  return total;
}
