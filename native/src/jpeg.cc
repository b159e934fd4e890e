// Baseline JPEG (DCTDecode) decoder: sequential Huffman, 8-bit samples.
//
// Covers what PDF producers embed: 1-component gray, 3-component YCbCr or
// RGB, 4-component CMYK/YCCK (Adobe APP14), any sampling factors,
// interleaved and single-component scans, restart intervals. Progressive
// and arithmetic-coded files return empty (a counted decode failure).
//
// The arithmetic follows libjpeg's defaults so decodes match it sample for
// sample: the ISLOW integer IDCT (jidctint.c), "fancy" triangle-filter
// chroma upsampling (jdsample.c) and the fixed-point YCbCr->RGB tables
// (jdcolor.c). tests/test_jpeg.py holds the two equal.
#include "spdf.h"

#include <algorithm>
#include <cstring>

namespace spdf {

namespace {

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // corrupt run lengths can push k past 63: those writes land on 63
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool ok = false;
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | symbol, 0 = take the slow path
  uint16_t fast[512];

  bool build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    memcpy(vals, symbols, nsym);
    int code = 0, k = 0;
    memset(fast, 0, sizeof(fast));
    for (int len = 1; len <= 16; len++) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < counts[len - 1]; i++) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); j++)
            fast[(code << shift) | j] = (uint16_t)((len << 8) | vals[k]);
        }
        code++;
        k++;
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      if (code > (1 << len)) return false;  // over-subscribed table
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    ok = true;
    return true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;        // table selectors of the current scan
  int w = 0, ht = 0;         // downsampled size in samples
  int bw = 0, bh = 0;        // allocated blocks per row / column
  int pred = 0;
  std::vector<uint8_t> pix;  // bw*8 x bh*8
};

class BitReader {
 public:
  BitReader(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

  int get(int n) {  // n in 1..16
    fill();
    int v = (int)(buf_ >> (32 - n));
    buf_ <<= n;
    cnt_ -= n;
    return v;
  }
  int peek16() {
    fill();
    return (int)(buf_ >> 16);
  }
  void skip(int n) {
    buf_ <<= n;
    cnt_ -= n;
  }
  // Restart: drop the partial byte and step over the RSTn marker.
  void restart() {
    buf_ = 0;
    cnt_ = 0;
    marker_ = false;
    while (p_ + 1 < end_) {
      if (p_[0] == 0xFF && p_[1] >= 0xD0 && p_[1] <= 0xD7) {
        p_ += 2;
        return;
      }
      if (p_[0] == 0xFF && p_[1] != 0x00 && p_[1] != 0xFF) return;
      p_++;
    }
  }
  const uint8_t* pos() const { return p_; }

 private:
  void fill() {
    while (cnt_ <= 24) {
      uint32_t b = 0;
      if (!marker_ && p_ < end_) {
        if (*p_ == 0xFF) {
          const uint8_t* q = p_ + 1;
          while (q < end_ && *q == 0xFF) q++;  // fill bytes
          if (q < end_ && *q == 0x00) {
            b = 0xFF;
            p_ = q + 1;
          } else {
            marker_ = true;  // entropy data ends: feed zeros like libjpeg
            p_ = q - 1;
          }
        } else {
          b = *p_++;
        }
      }
      buf_ |= b << (24 - cnt_);
      cnt_ += 8;
    }
  }

  const uint8_t* p_;
  const uint8_t* end_;
  uint32_t buf_ = 0;
  int cnt_ = 0;
  bool marker_ = false;
};

inline int decode_symbol(BitReader* br, const Huffman& ht) {
  int look = br->peek16();
  uint16_t f = ht.fast[look >> 7];
  if (f) {
    br->skip(f >> 8);
    return f & 0xFF;
  }
  for (int len = 10; len <= 16; len++) {
    int code = look >> (16 - len);
    if (code <= ht.maxcode[len]) {
      br->skip(len);
      int idx = ht.valptr[len] + code - ht.mincode[len];
      return idx < 256 ? ht.vals[idx] : 0;
    }
  }
  br->skip(16);  // invalid code: libjpeg warns and returns 0
  return 0;
}

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

// libjpeg's post-IDCT range limit: the descaled value is wrapped to 10
// bits, then clamped around the +128 level shift
inline uint8_t range_limit(int v) {
  int i = v & 1023;
  if (i >= 512) i -= 1024;
  i += 128;
  return (uint8_t)(i < 0 ? 0 : (i > 255 ? 255 : i));
}

// jidctint.c jpeg_idct_islow: separable 8x8 integer IDCT with the
// dequantization folded into pass 1.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  const int CB = 13, P1 = 2;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = (in[0] * qt[0]) * (1 << P1);
      for (int r = 0; r < 8; r++) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = in[16] * qt[16], z3 = in[48] * qt[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = in[0] * qt[0];
    z3 = in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = in[56] * qt[56];
    tmp1 = in[40] * qt[40];
    tmp2 = in[24] * qt[24];
    tmp3 = in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CB - P1;
    const int64_t rnd = (int64_t)1 << (sh - 1);
    w[0] = (int)((t10 + tmp3 + rnd) >> sh);
    w[56] = (int)((t10 - tmp3 + rnd) >> sh);
    w[8] = (int)((t11 + tmp2 + rnd) >> sh);
    w[48] = (int)((t11 - tmp2 + rnd) >> sh);
    w[16] = (int)((t12 + tmp1 + rnd) >> sh);
    w[40] = (int)((t12 - tmp1 + rnd) >> sh);
    w[24] = (int)((t13 + tmp0 + rnd) >> sh);
    w[32] = (int)((t13 - tmp0 + rnd) >> sh);
  }
  const int sh = CB + P1 + 3;
  const int64_t rnd = (int64_t)1 << (sh - 1);
  for (int r = 0; r < 8; r++) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CB);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CB);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = range_limit((int)((t10 + tmp3 + rnd) >> sh));
    o[7] = range_limit((int)((t10 - tmp3 + rnd) >> sh));
    o[1] = range_limit((int)((t11 + tmp2 + rnd) >> sh));
    o[6] = range_limit((int)((t11 - tmp2 + rnd) >> sh));
    o[2] = range_limit((int)((t12 + tmp1 + rnd) >> sh));
    o[5] = range_limit((int)((t12 - tmp1 + rnd) >> sh));
    o[3] = range_limit((int)((t13 + tmp0 + rnd) >> sh));
    o[4] = range_limit((int)((t13 - tmp0 + rnd) >> sh));
  }
}

// Upsample one component plane to the full image size (jdsample.c:
// triangle filters for 2x1, 1x2 and 2x2, replication otherwise). Rows
// outside the plane repeat its edge rows, as libjpeg's context rows do.
std::vector<uint8_t> upsample(const Component& c, int hmax, int vmax, int W,
                              int H) {
  std::vector<uint8_t> out((size_t)W * H);
  const int stride = c.bw * 8;
  auto at = [&](int x, int y) { return (int)c.pix[(size_t)y * stride + x]; };
  const int fh = hmax / c.h, fv = vmax / c.v;
  const bool exact = hmax % c.h == 0 && vmax % c.v == 0;
  if (fh == 1 && fv == 1 && exact) {
    for (int y = 0; y < H; y++)
      memcpy(&out[(size_t)y * W], &c.pix[(size_t)y * stride], W);
    return out;
  }
  const int cw = c.w, ch = c.ht;
  auto row_clamp = [&](int r) { return r < 0 ? 0 : (r >= ch ? ch - 1 : r); };
  if (exact && fh == 2 && fv == 1 && cw > 2) {
    for (int y = 0; y < H; y++) {
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; x++) {
        int i = x >> 1;
        int cur = at(i, y) * 3;
        int v;
        if (x & 1)
          v = i == cw - 1 ? at(i, y) : (cur + at(i + 1, y) + 2) >> 2;
        else
          v = i == 0 ? at(0, y) : (cur + at(i - 1, y) + 1) >> 2;
        o[x] = (uint8_t)v;
      }
    }
    return out;
  }
  if (exact && fh == 1 && fv == 2) {
    for (int y = 0; y < H; y++) {
      int r = y >> 1;
      int nb = row_clamp((y & 1) ? r + 1 : r - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; x++)
        o[x] = (uint8_t)((at(x, r) * 3 + at(x, nb) + bias) >> 2);
    }
    return out;
  }
  if (exact && fh == 2 && fv == 2 && cw > 2) {
    std::vector<int> colsum(cw);
    for (int y = 0; y < H; y++) {
      int r = y >> 1;
      int nb = row_clamp((y & 1) ? r + 1 : r - 1);
      for (int i = 0; i < cw; i++) colsum[i] = at(i, r) * 3 + at(i, nb);
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; x++) {
        int i = x >> 1;
        int cur = colsum[i];
        int v;
        if (x & 1)
          v = i == cw - 1 ? (cur * 4 + 7) >> 4
                          : (cur * 3 + colsum[i + 1] + 7) >> 4;
        else
          v = i == 0 ? (cur * 4 + 8) >> 4 : (cur * 3 + colsum[i - 1] + 8) >> 4;
        o[x] = (uint8_t)v;
      }
    }
    return out;
  }
  // integral replication (also the narrow-plane fallback libjpeg takes)
  for (int y = 0; y < H; y++) {
    int sy = std::min(y * c.v / vmax, c.bh * 8 - 1);
    uint8_t* o = &out[(size_t)y * W];
    for (int x = 0; x < W; x++)
      o[x] = (uint8_t)at(std::min(x * c.h / hmax, stride - 1), sy);
  }
  return out;
}

struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    const int SB = 16;
    const int64_t half = (int64_t)1 << (SB - 1);
    auto fix = [](double v) { return (int64_t)(v * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> SB);
      cr_g[i] = (int)(-fix(0.71414) * x);
      cb_g[i] = (int)(-fix(0.34414) * x + half);
    }
  }
};

inline uint8_t clamp8(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

std::vector<uint8_t> dct_decode_rgb(const uint8_t* data, size_t size, int* w,
                                    int* h) {
  static const YccTables ycc;
  const uint8_t* p = data;
  const uint8_t* end = data + size;
  if (size < 4 || p[0] != 0xFF || p[1] != 0xD8) return {};
  p += 2;
  uint16_t qt[4][64] = {};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int W = 0, H = 0, hmax = 1, vmax = 1, restart = 0;
  bool jfif = false, adobe = false, frame = false, any_scan = false;
  int adobe_transform = -1;
  int16_t blk[64];

  while (p + 4 <= end) {
    if (p[0] != 0xFF) {  // garbage between segments: resync on next 0xFF
      p++;
      continue;
    }
    int m = p[1];
    p += 2;
    if (m == 0xFF || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
      if (m == 0xFF) p--;
      continue;
    }
    if (m == 0xD9) break;  // EOI
    if (p + 2 > end) break;
    int len = (p[0] << 8) | p[1];
    if (len < 2 || p + len > end) return {};
    const uint8_t* seg = p + 2;
    const uint8_t* seg_end = p + len;
    p += len;
    switch (m) {
      case 0xC0:
      case 0xC1: {  // baseline / extended sequential, Huffman
        if (len < 8 || seg[0] != 8 || frame) return {};
        H = (seg[1] << 8) | seg[2];
        W = (seg[3] << 8) | seg[4];
        int nc = seg[5];
        if (W <= 0 || H <= 0 || (nc != 1 && nc != 3 && nc != 4) ||
            len < 8 + 3 * nc || (int64_t)W * H > (int64_t)1 << 28)
          return {};
        comps.resize(nc);
        for (int i = 0; i < nc; i++) {
          comps[i].id = seg[6 + i * 3];
          comps[i].h = seg[7 + i * 3] >> 4;
          comps[i].v = seg[7 + i * 3] & 15;
          comps[i].tq = seg[8 + i * 3] & 3;
          if (comps[i].h < 1 || comps[i].h > 4 || comps[i].v < 1 ||
              comps[i].v > 4)
            return {};
          hmax = std::max(hmax, comps[i].h);
          vmax = std::max(vmax, comps[i].v);
        }
        int mcux = (W + 8 * hmax - 1) / (8 * hmax);
        int mcuy = (H + 8 * vmax - 1) / (8 * vmax);
        for (auto& c : comps) {
          c.w = (W * c.h + hmax - 1) / hmax;
          c.ht = (H * c.v + vmax - 1) / vmax;
          c.bw = mcux * c.h;
          c.bh = mcuy * c.v;
          c.pix.assign((size_t)c.bw * 8 * c.bh * 8, 0);
        }
        frame = true;
        break;
      }
      case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        return {};  // progressive, lossless, hierarchical, arithmetic
      case 0xC4: {  // DHT
        const uint8_t* s = seg;
        while (s + 17 <= seg_end) {
          int cls = s[0] >> 4, id = s[0] & 3;
          int n = 0;
          for (int i = 0; i < 16; i++) n += s[1 + i];
          if (n > 256 || s + 17 + n > seg_end) return {};
          Huffman& t = cls ? ac[id] : dc[id];
          if (!t.build(s + 1, s + 17, n)) return {};
          s += 17 + n;
        }
        break;
      }
      case 0xDB: {  // DQT (zigzag order in the file, natural order here)
        const uint8_t* s = seg;
        while (s < seg_end) {
          int prec = s[0] >> 4, id = s[0] & 3;
          s++;
          int need = prec ? 128 : 64;
          if (s + need > seg_end) return {};
          for (int k = 0; k < 64; k++)
            qt[id][kNatural[k]] = prec ? (uint16_t)((s[2 * k] << 8) | s[2 * k + 1])
                                       : s[k];
          s += need;
        }
        break;
      }
      case 0xDD:  // DRI
        if (len >= 4) restart = (seg[0] << 8) | seg[1];
        break;
      case 0xE0:
        if (len >= 7 && !memcmp(seg, "JFIF", 4)) jfif = true;
        break;
      case 0xEE:
        if (len >= 14 && !memcmp(seg, "Adobe", 5)) {
          adobe = true;
          adobe_transform = seg[11];
        }
        break;
      case 0xDA: {  // SOS: decode one scan
        if (!frame || len < 6) return {};
        int ns = seg[0];
        if (ns < 1 || ns > 4 || len < 6 + 2 * ns) return {};
        std::vector<Component*> sc;
        for (int i = 0; i < ns; i++) {
          int cid = seg[1 + i * 2];
          Component* c = nullptr;
          for (auto& cc : comps)
            if (cc.id == cid) c = &cc;
          if (!c) return {};
          c->td = seg[2 + i * 2] >> 4 & 3;
          c->ta = seg[2 + i * 2] & 3;
          if (!dc[c->td].ok || !ac[c->ta].ok) return {};
          c->pred = 0;
          sc.push_back(c);
        }
        int mcux, mcuy;
        if (ns == 1) {  // non-interleaved: one block per MCU
          mcux = (sc[0]->w + 7) / 8;
          mcuy = (sc[0]->ht + 7) / 8;
        } else {
          mcux = (W + 8 * hmax - 1) / (8 * hmax);
          mcuy = (H + 8 * vmax - 1) / (8 * vmax);
        }
        BitReader br(p, end);
        int todo = restart;
        for (int my = 0; my < mcuy; my++) {
          for (int mx = 0; mx < mcux; mx++) {
            if (restart) {
              if (todo == 0) {
                br.restart();
                for (auto* c : sc) c->pred = 0;
                todo = restart;
              }
              todo--;
            }
            for (auto* c : sc) {
              int nbh = ns == 1 ? 1 : c->h, nbv = ns == 1 ? 1 : c->v;
              for (int by = 0; by < nbv; by++) {
                for (int bx = 0; bx < nbh; bx++) {
                  memset(blk, 0, sizeof(blk));
                  int t = decode_symbol(&br, dc[c->td]);
                  int diff = t ? extend(br.get(t), t) : 0;
                  c->pred += diff;
                  blk[0] = (int16_t)c->pred;
                  const Huffman& at = ac[c->ta];
                  for (int k = 1; k < 64;) {
                    int rs = decode_symbol(&br, at);
                    int r = rs >> 4, s = rs & 15;
                    if (s) {
                      k += r;
                      blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
                      k++;
                    } else if (r == 15) {
                      k += 16;
                    } else {
                      break;
                    }
                  }
                  int bcol = ns == 1 ? mx : mx * c->h + bx;
                  int brow = ns == 1 ? my : my * c->v + by;
                  if (bcol >= c->bw || brow >= c->bh) continue;
                  int stride = c->bw * 8;
                  idct_islow(blk, qt[c->tq],
                             &c->pix[(size_t)brow * 8 * stride + bcol * 8],
                             stride);
                }
              }
            }
          }
        }
        p = br.pos();
        any_scan = true;
        break;
      }
      default:
        break;  // APPn, COM, DNL...: skipped
    }
  }
  if (!frame || !any_scan) return {};

  int nc = (int)comps.size();
  std::vector<std::vector<uint8_t>> planes(nc);
  for (int i = 0; i < nc; i++) planes[i] = upsample(comps[i], hmax, vmax, W, H);
  *w = W;
  *h = H;
  std::vector<uint8_t> out((size_t)W * H * 3);
  const size_t n = (size_t)W * H;
  if (nc == 1) {
    for (size_t i = 0; i < n; i++)
      out[i * 3] = out[i * 3 + 1] = out[i * 3 + 2] = planes[0][i];
    return out;
  }
  if (nc == 3) {
    bool rgb = false;
    if (!jfif) {
      if (adobe)
        rgb = adobe_transform == 0;
      else
        rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
    }
    for (size_t i = 0; i < n; i++) {
      int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
      if (rgb) {
        out[i * 3] = (uint8_t)y;
        out[i * 3 + 1] = (uint8_t)cb;
        out[i * 3 + 2] = (uint8_t)cr;
      } else {
        out[i * 3] = clamp8(y + ycc.cr_r[cr]);
        out[i * 3 + 1] = clamp8(y + ((ycc.cb_g[cb] + ycc.cr_g[cr]) >> 16));
        out[i * 3 + 2] = clamp8(y + ycc.cb_b[cb]);
      }
    }
    return out;
  }
  // 4 components: CMYK, or YCCK when the Adobe transform says so. Adobe
  // files store inverted ink (255 == no ink).
  bool ycck = adobe && adobe_transform == 2;
  for (size_t i = 0; i < n; i++) {
    int c = planes[0][i], m = planes[1][i], ye = planes[2][i],
        k = planes[3][i];
    if (ycck) {
      int y = c, cb = m, cr = ye;
      c = 255 - clamp8(y + ycc.cr_r[cr]);
      m = 255 - clamp8(y + ((ycc.cb_g[cb] + ycc.cr_g[cr]) >> 16));
      ye = 255 - clamp8(y + ycc.cb_b[cb]);
    }
    if (adobe) {
      out[i * 3] = (uint8_t)(c * k / 255);
      out[i * 3 + 1] = (uint8_t)(m * k / 255);
      out[i * 3 + 2] = (uint8_t)(ye * k / 255);
    } else {
      out[i * 3] = (uint8_t)((255 - c) * (255 - k) / 255);
      out[i * 3 + 1] = (uint8_t)((255 - m) * (255 - k) / 255);
      out[i * 3 + 2] = (uint8_t)((255 - ye) * (255 - k) / 255);
    }
  }
  return out;
}

}  // namespace spdf
