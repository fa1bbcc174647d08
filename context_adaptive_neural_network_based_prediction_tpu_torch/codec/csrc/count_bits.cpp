// The RD bit count of one TU's coefficients: the bins that
// `syntax.encode_coefficients` codes (HM TEncSbac::codeCoeffNxN), costed
// as `rdo.BitCounter` costs them (15-bit fixed-point entropy of each
// context bin, one bit a bypass bin), with the context states advanced in
// place exactly as the counting coder advances them.  Luma and chroma; the
// caller passes the scan, the CG scan, the sig_coeff_flag context of every
// position under each CG pattern and the channel's context offsets.

#include <cstdint>
#include <cstdlib>
#include <utility>

namespace {

const int kGroupIdx[32] = {0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                           8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9};
constexpr int kC1FlagNumber = 8;
constexpr int kSbhThreshold = 4;
constexpr int kCoefRemainBinReduction = 3;
constexpr int64_t kEpBits = 32768;

struct Counter {
  int32_t* ctx;
  const int32_t* entropy;
  const int32_t* next_mps;
  const int32_t* next_lps;
  int64_t bits;

  void bin(int value, int idx) {
    const int state = ctx[idx];
    bits += entropy[state ^ value];
    ctx[idx] = value == (state & 1) ? next_mps[state] : next_lps[state];
  }
  void bypass(int n) { bits += kEpBits * n; }
};

// xWriteCoefRemainExGolomb's bins.
void coef_remain(Counter& c, int symbol, int r) {
  if (symbol < (kCoefRemainBinReduction << r)) {
    c.bypass((symbol >> r) + 1 + r);
    return;
  }
  int length = r;
  int64_t code = symbol - (kCoefRemainBinReduction << r);
  while (code >= (int64_t{1} << length)) {
    code -= int64_t{1} << length;
    ++length;
  }
  c.bypass(kCoefRemainBinReduction + length + 1 - r + length);
}

}  // namespace

extern "C" {

// Returns the bits (15-bit fixed point) of one non-empty n x n TU, or -1
// for an empty one.  `scan_ver`: the scan is vertical (last x / y swap).
// `sig_ctx`: 4 x n*n absolute contexts by CG pattern and raster position.
int64_t count_coefficient_bits(
    const int32_t* coeffs, int n, int scan_ver, int sign_hiding,
    const int32_t* scan, const int32_t* scan_cg, const int32_t* sig_ctx,
    int last_x_off, int last_y_off, int blk_offset, int shift,
    int sig_cg_off, int greater1_off, int greater2_off, int is_chroma,
    int32_t* ctx, const int32_t* entropy, const int32_t* next_mps,
    const int32_t* next_lps) {
  if (n < 4 || n > 32) return -2;
  Counter c{ctx, entropy, next_mps, next_lps, 0};
  const int nn = n * n;
  const int wig = n / 4;
  int scan_pos_last = -1;
  for (int sp = nn - 1; sp >= 0; --sp) {
    if (coeffs[scan[sp]]) {
      scan_pos_last = sp;
      break;
    }
  }
  if (scan_pos_last < 0) return -1;
  int sig_cg[64] = {0};
  for (int sp = 0; sp <= scan_pos_last; ++sp) {
    const int rp = scan[sp];
    if (coeffs[rp]) sig_cg[((rp / n) >> 2) * wig + ((rp % n) >> 2)] = 1;
  }

  // Last significant position.
  const int pos_last = scan[scan_pos_last];
  int lx = pos_last % n, ly = pos_last / n;
  if (scan_ver) std::swap(lx, ly);
  const int gx = kGroupIdx[lx], gy = kGroupIdx[ly], gmax = kGroupIdx[n - 1];
  for (int k = 0; k < gx; ++k) c.bin(1, last_x_off + blk_offset + (k >> shift));
  if (gx < gmax) c.bin(0, last_x_off + blk_offset + (gx >> shift));
  for (int k = 0; k < gy; ++k) c.bin(1, last_y_off + blk_offset + (k >> shift));
  if (gy < gmax) c.bin(0, last_y_off + blk_offset + (gy >> shift));
  if (gx > 3) c.bypass((gx - 2) >> 1);
  if (gy > 3) c.bypass((gy - 2) >> 1);

  // Coefficient groups, last to first.
  const int last_scan_set = scan_pos_last >> 4;
  int c1 = 1;
  int scan_pos_sig = scan_pos_last;
  int abs_coeffs[16];
  for (int subset = last_scan_set; subset >= 0; --subset) {
    const int sub_pos = subset << 4;
    int go_rice = 0, num_nonzero = 0;
    int last_nz_in_cg = -1, first_nz_in_cg = 16;
    if (scan_pos_sig == scan_pos_last) {
      abs_coeffs[0] = std::abs(coeffs[pos_last]);
      num_nonzero = 1;
      last_nz_in_cg = first_nz_in_cg = scan_pos_sig;
      --scan_pos_sig;
    }
    const int cg_blk = scan_cg[subset];
    const int cg_y = cg_blk / wig, cg_x = cg_blk % wig;
    const bool right = cg_x < wig - 1 && sig_cg[cg_blk + 1];
    const bool below = cg_y < wig - 1 && sig_cg[cg_blk + wig];
    if (subset == last_scan_set || subset == 0) {
      sig_cg[cg_blk] = 1;
    } else {
      c.bin(sig_cg[cg_blk], sig_cg_off + (right || below ? 1 : 0));
    }
    if (sig_cg[cg_blk]) {
      const int32_t* ctx_of = sig_ctx + ((right ? 1 : 0) + (below ? 2 : 0)) * nn;
      for (; scan_pos_sig >= sub_pos; --scan_pos_sig) {
        const int rp = scan[scan_pos_sig];
        const int v = coeffs[rp];
        if (scan_pos_sig > sub_pos || subset == 0 || num_nonzero)
          c.bin(v ? 1 : 0, ctx_of[rp]);
        if (v) {
          abs_coeffs[num_nonzero++] = std::abs(v);
          if (last_nz_in_cg == -1) last_nz_in_cg = scan_pos_sig;
          first_nz_in_cg = scan_pos_sig;
        }
      }
    } else {
      scan_pos_sig = sub_pos - 1;
    }
    if (num_nonzero == 0) continue;

    const bool hidden =
        sign_hiding && last_nz_in_cg - first_nz_in_cg >= kSbhThreshold;
    const int ctx_set = (subset > 0 && !is_chroma ? 2 : 0) + (c1 == 0 ? 1 : 0);
    c1 = 1;
    const int base_g1 = greater1_off + 4 * ctx_set;
    bool escape = false;
    const int num_c1 = num_nonzero < kC1FlagNumber ? num_nonzero : kC1FlagNumber;
    int first_c2 = -1;
    for (int idx = 0; idx < num_c1; ++idx) {
      const int symbol = abs_coeffs[idx] > 1;
      c.bin(symbol, base_g1 + c1);
      if (symbol) {
        c1 = 0;
        if (first_c2 == -1) first_c2 = idx; else escape = true;
      } else if (c1 > 0 && c1 < 3) {
        ++c1;
      }
    }
    if (c1 == 0 && first_c2 != -1) {
      const int symbol = abs_coeffs[first_c2] > 2;
      c.bin(symbol, greater2_off + ctx_set);
      if (symbol) escape = true;
    }
    escape = escape || num_nonzero > kC1FlagNumber;
    c.bypass(hidden ? num_nonzero - 1 : num_nonzero);
    if (escape) {
      int first_coeff2 = 1;
      for (int idx = 0; idx < num_nonzero; ++idx) {
        const int base = idx < kC1FlagNumber ? 2 + first_coeff2 : 1;
        if (abs_coeffs[idx] >= base) {
          coef_remain(c, abs_coeffs[idx] - base, go_rice);
          if (abs_coeffs[idx] > (3 << go_rice))
            go_rice = go_rice + 1 < 4 ? go_rice + 1 : 4;
        }
        if (abs_coeffs[idx] >= 2) first_coeff2 = 0;
      }
    }
  }
  return c.bits;
}

}  // extern "C"
