// Host-side image I/O of the port: a baseline/extended sequential JPEG
// decoder and Pillow's LANCZOS / BILINEAR resampler, with a plain C
// interface for ctypes (built by hostio.py with the host C++ compiler).
//
// The decoder follows libjpeg-turbo's default decompression path, which is
// what PIL uses, so that its output equals np.asarray(Image.open(path)) bit
// for bit:
//   - Huffman decoding of sequential scans (jdhuff.c), interleaved or not,
//     with restart intervals; a marker inside the entropy data supplies
//     zero bits, as libjpeg does;
//   - the ISLOW integer IDCT (jidctint.c), its descale and its range-limit
//     table (jdmaster.c prepare_range_limit_table);
//   - fancy upsampling (jdsample.c: h2v1, h2v2 and h1v2 with their edge
//     rules and biases; plain replication where the component is 2 samples
//     wide or less); never the merged upsampler;
//   - fixed-point YCbCr -> RGB with 16 scale bits (jdcolor.c).
// Progressive, lossless, hierarchical and arithmetic-coded frames, 12-bit
// samples and 2- or 4-component (CMYK) images are refused with a message
// that names the marker.
//
// The resampler is Pillow's Resample.c: per output pixel, coefficients in
// double, normalised, then fixed point with PRECISION_BITS = 32 - 8 - 2;
// the horizontal pass over only the rows the vertical pass reads, then the
// vertical pass; each result rounded and clipped to 8 bits.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- JPEG

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for safety in decoder (jutils.c jpeg_natural_order)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

struct HuffTable {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 when the code is longer
  uint16_t look[1 << 9];
};

void build_huff(HuffTable& t, const uint8_t* bits, const uint8_t* vals, int nvals) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) fail("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      t.valoffset[l] = p - huffcode[p];
      p += bits[l - 1];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.vals, 0, sizeof(t.vals));
  std::memcpy(t.vals, vals, nvals);
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= 9; l++) {
    for (int i = 1; i <= bits[l - 1]; i++, p++) {
      int lookbits = huffcode[p] << (9 - l);
      for (int ctr = 1 << (9 - l); ctr > 0; ctr--)
        t.look[lookbits++] = (uint16_t)((l << 8) | t.vals[p]);
    }
  }
  t.defined = true;
}

struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;  // next byte to fetch
  uint64_t acc = 0;
  int cnt = 0;
  bool hit_marker = false;

  void reset_at(size_t p) {
    pos = p;
    acc = 0;
    cnt = 0;
    hit_marker = false;
  }
  void fill() {
    while (cnt <= 56) {
      uint32_t c = 0;
      if (!hit_marker && pos < n) {
        c = d[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q < n && d[q] == 0x00) {
            pos = q + 1;
          } else {
            hit_marker = true;  // pos stays at the marker's first 0xFF
            c = 0;
          }
        } else {
          pos++;
        }
      }
      acc |= (uint64_t)c << (56 - cnt);
      cnt += 8;
    }
  }
  inline int peek(int k) {
    if (cnt < k) fill();
    return (int)(acc >> (64 - k));
  }
  inline void skip(int k) {
    acc <<= k;
    cnt -= k;
  }
  inline int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  int decode(const HuffTable& t) {
    if (cnt < 16) fill();
    int look = t.look[acc >> (64 - 9)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int l = 10;
    int code = (int)(acc >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = (int)(acc >> (64 - l));
    }
    if (l > 16) {  // corrupt data: libjpeg returns symbol 0
      skip(16);
      return 0;
    }
    skip(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

// jidctint.c jpeg_idct_islow
const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t table[5 * 256 + 128];
  const uint8_t* idct;  // post-IDCT table, indexed by (x & 1023)
  RangeLimit() {
    uint8_t* t = table + 256;  // simple table: limit[x] = clamp(x)
    std::memset(table, 0, 256);
    for (int i = 0; i <= 255; i++) t[i] = (uint8_t)i;
    t += 128;
    for (int i = 128; i < 512; i++) t[i] = 255;
    std::memset(t + 512, 0, 512 - 128);
    std::memcpy(t + 1024 - 128, table + 256, 128);
    idct = t;
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  const uint8_t* range = kRange.idct;
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = (int)((int64_t)in[0] * qq[0]) << PASS1_BITS;
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qq[16], z3 = (int64_t)in[48] * qq[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qq[0];
    z3 = (int64_t)in[32] * qq[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qq[56];
    tmp1 = (int64_t)in[40] * qq[40];
    tmp2 = (int64_t)in[24] * qq[24];
    tmp3 = (int64_t)in[8] * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = (int)descale(tmp10 + tmp3, sh);
    w[56] = (int)descale(tmp10 - tmp3, sh);
    w[8] = (int)descale(tmp11 + tmp2, sh);
    w[48] = (int)descale(tmp11 - tmp2, sh);
    w[16] = (int)descale(tmp12 + tmp1, sh);
    w[40] = (int)descale(tmp12 - tmp1, sh);
    w[24] = (int)descale(tmp13 + tmp0, sh);
    w[32] = (int)descale(tmp13 - tmp0, sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t v = range[(int)descale(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = range[(int)descale(tmp10 + tmp3, sh) & 1023];
    o[7] = range[(int)descale(tmp10 - tmp3, sh) & 1023];
    o[1] = range[(int)descale(tmp11 + tmp2, sh) & 1023];
    o[6] = range[(int)descale(tmp11 - tmp2, sh) & 1023];
    o[2] = range[(int)descale(tmp12 + tmp1, sh) & 1023];
    o[5] = range[(int)descale(tmp12 - tmp1, sh) & 1023];
    o[3] = range[(int)descale(tmp13 + tmp0, sh) & 1023];
    o[4] = range[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

struct Component {
  int id, h, v, tq;
  int ds_w, ds_h;            // downsampled size (jdiv_round_up)
  int bw, bh;                // blocks of a non-interleaved scan
  int pw, ph;                // plane size in samples (MCU-padded)
  uint16_t q[64];            // quant table latched at the component's scan
  bool seen = false;
  std::vector<uint8_t> plane;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  bool frame = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u8() {
    if (pos >= n) fail("unexpected end of file");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // next marker code from pos, skipping anything before it (jdmarker.c next_marker)
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) fail("unexpected end of file (no EOI)");
      int c = d[pos++];
      if (c != 0) return c;
    }
  }

  static std::string marker_name(int m) {
    char buf[32];
    std::snprintf(buf, sizeof(buf), "0xFF%02X", m);
    return buf;
  }

  void sof(int m) {
    int len = u16();
    size_t end = pos + len - 2;
    int prec = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (prec != 8)
      fail("SOF" + std::to_string(m - 0xC0) + " (" + marker_name(m) + ") with " +
           std::to_string(prec) + "-bit samples: only 8-bit JPEGs are supported");
    if (height == 0) fail("DNL-defined height (SOF height 0) is not supported");
    if (width == 0) fail("zero image width");
    if (ncomp == 4)
      fail("4-component (CMYK/YCCK) JPEG in " + marker_name(m) + ": not supported");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG in " + marker_name(m) + ": not supported");
    comps.resize(ncomp);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comps[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad SOF component");
      if (c.h > 2 || c.v > 2)
        fail("sampling factors above 2x2 (" + std::to_string(c.h) + "x" + std::to_string(c.v) +
             ") are not supported");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    pos = end;
    frame = true;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      if (hmax % c.h || vmax % c.v) fail("fractional sampling ratios are not supported");
      c.ds_w = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.ds_h = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = (c.ds_w + 7) / 8;
      c.bh = (c.ds_h + 7) / 8;
      c.pw = mcux * c.h * 8;
      c.ph = mcuy * c.v * 8;
    }
  }

  void dqt() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq = u8();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3) fail("bad DQT table index");
      for (int k = 0; k < 64; k++) qt[tq][kNatural[k]] = (uint16_t)(prec ? u16() : u8());
      qt_defined[tq] = true;
    }
    pos = end;
  }

  void dht() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc = u8();
      int th = tc & 15;
      tc >>= 4;
      if (th > 3 || tc > 1) fail("bad DHT table index");
      uint8_t bits[16], vals[256];
      int count = 0;
      for (int i = 0; i < 16; i++) count += bits[i] = (uint8_t)u8();
      if (count > 256) fail("bad DHT table");
      for (int i = 0; i < count; i++) vals[i] = (uint8_t)u8();
      build_huff(tc ? ac[th] : dc[th], bits, vals, count);
    }
    pos = end;
  }

  void app(int m) {
    int len = u16();
    size_t end = pos + len - 2;
    if (end > n) fail("truncated marker segment");
    size_t dlen = len - 2;
    const uint8_t* p = d + pos;
    if (m == 0xE0 && dlen >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && dlen >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = end;
  }

  void skip_segment() {
    int len = u16();
    if (len < 2 || pos + len - 2 > n) fail("truncated marker segment");
    pos += len - 2;
  }

  void decode_block(BitReader& br, Component& c, int& pred, const HuffTable& dct,
                    const HuffTable& act, int by, int bx) {
    int16_t blk[64];
    std::memset(blk, 0, sizeof(blk));
    int s = br.decode(dct);
    if (s) {
      int r = br.get(s);
      s = extend(r, s);
    }
    pred += s;
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; k++) {
      s = br.decode(act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = br.get(s);
        blk[kNatural[k]] = (int16_t)extend(r, s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(blk, c.q, c.plane.data() + (size_t)by * 8 * c.pw + (size_t)bx * 8, c.pw);
  }

  // after an interval: find the RSTn marker and restart the bit reader
  void restart(BitReader& br, int& expected) {
    size_t p = br.pos;
    for (;;) {
      while (p < n && d[p] != 0xFF) p++;
      while (p < n && d[p] == 0xFF) p++;
      if (p >= n) fail("missing restart marker");
      int c = d[p++];
      if (c == 0) continue;
      if (c != 0xD0 + expected)
        fail("expected RST" + std::to_string(expected) + ", found " + marker_name(c));
      break;
    }
    expected = (expected + 1) & 7;
    br.reset_at(p);
  }

  void sos() {
    if (!frame) fail("SOS before SOF");
    int len = u16();
    size_t end = pos + len - 2;
    int ns = u8();
    if (ns < 1 || ns > 4) fail("bad SOS component count");
    std::vector<int> idx(ns), td(ns), ta(ns);
    for (int i = 0; i < ns; i++) {
      int cid = u8(), t = u8();
      idx[i] = -1;
      for (int j = 0; j < ncomp; j++)
        if (comps[j].id == cid) idx[i] = j;
      if (idx[i] < 0) fail("SOS names an unknown component");
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) fail("bad SOS table index");
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) fail("spectral selection in a sequential scan");
    pos = end;
    for (int i = 0; i < ns; i++) {
      Component& c = comps[idx[i]];
      if (!dc[td[i]].defined || !ac[ta[i]].defined) fail("scan uses an undefined Huffman table");
      if (!qt_defined[c.tq]) fail("component uses an undefined quantization table");
      std::memcpy(c.q, qt[c.tq], sizeof(c.q));
      if (c.plane.empty()) c.plane.assign((size_t)c.pw * c.ph, 0);
      c.seen = true;
    }
    BitReader br{d, n, pos};
    std::vector<int> pred(ns, 0);
    int expected_rst = 0;
    long mcus_left = restart_interval;
    auto maybe_restart = [&](bool more) {
      if (!restart_interval) return;
      if (--mcus_left == 0 && more) {
        restart(br, expected_rst);
        std::fill(pred.begin(), pred.end(), 0);
        mcus_left = restart_interval;
      }
    };
    if (ns == 1) {
      Component& c = comps[idx[0]];
      const HuffTable &dct = dc[td[0]], &act = ac[ta[0]];
      long total = (long)c.bw * c.bh, k = 0;
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++) {
          decode_block(br, c, pred[0], dct, act, by, bx);
          maybe_restart(++k < total);
        }
    } else {
      long total = (long)mcux * mcuy, k = 0;
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          for (int i = 0; i < ns; i++) {
            Component& c = comps[idx[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++)
                decode_block(br, c, pred[i], dc[td[i]], ac[ta[i]], my * c.v + v, mx * c.h + h);
          }
          maybe_restart(++k < total);
        }
    }
    pos = br.pos;  // next_marker() skips whatever is left before the marker
  }

  // width, height and components from the first SOFn segment, without
  // decoding (any SOFn: a progressive file's size reads too)
  void frame_header(int* w, int* h, int* nc) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        u16();
        u8();
        *h = u16();
        *w = u16();
        *nc = u8();
        return;
      }
      if (m == 0xDA || m == 0xD9) fail("no frame header (SOFn) before the scan data");
      if (m != 0x01 && !(m >= 0xD0 && m <= 0xD7)) skip_segment();
    }
  }

  void parse() {
    pos = 0;
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1) {
        if (frame) fail("second frame header");
        sof(m);
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        fail("SOF" + std::to_string(m - 0xC0) + " (" + marker_name(m) +
             ", progressive) is not supported: only baseline and extended sequential "
             "Huffman JPEGs (SOF0, SOF1) are");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        fail("SOF" + std::to_string(m - 0xC0) + " (" + marker_name(m) +
             ", lossless) is not supported: only baseline and extended sequential "
             "Huffman JPEGs (SOF0, SOF1) are");
      } else if (m == 0xC5 || m == 0xC9 || m == 0xCD) {
        fail("SOF" + std::to_string(m - 0xC0) + " (" + marker_name(m) +
             (m == 0xC5 ? ", hierarchical" : ", arithmetic-coded") +
             ") is not supported: only baseline and extended sequential Huffman JPEGs "
             "(SOF0, SOF1) are");
      } else if (m == 0xCC) {
        fail("DAC (0xFFCC, arithmetic coding) is not supported: only Huffman-coded JPEGs are");
      } else if (m == 0xC4) {
        dht();
      } else if (m == 0xDB) {
        dqt();
      } else if (m == 0xDD) {
        int len = u16();
        restart_interval = u16();
        pos += len - 4;
      } else if (m == 0xDA) {
        sos();
      } else if (m == 0xD9) {
        if (!frame) fail("EOI before a frame");
        return;
      } else if (m >= 0xE0 && m <= 0xEF) {
        app(m);
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        continue;  // standalone markers
      } else if (m == 0xDC) {
        fail("DNL marker is not supported");
      } else {
        skip_segment();  // COM, JPG, DHP, EXP, reserved
      }
    }
  }

  // --- output: upsample each component to the full grid, then colour convert
  std::vector<uint8_t> upsample(const Component& c) const {
    const int hr = hmax / c.h, vr = vmax / c.v;
    const int W = c.ds_w, H = c.ds_h, ow = W * hr, oh = H * vr;
    const uint8_t* p = c.plane.data();
    const int st = c.pw;
    std::vector<uint8_t> out((size_t)ow * oh);
    auto row = [&](int y) { return p + (size_t)std::min(std::max(y, 0), H - 1) * st; };
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < H; y++) std::memcpy(&out[(size_t)y * ow], row(y), W);
    } else if (hr == 2 && vr == 1 && W > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < H; y++) {
        const uint8_t* in = row(y);
        uint8_t* o = &out[(size_t)y * ow];
        for (int x = 0; x < W; x++) {
          int v3 = in[x] * 3, l = in[x > 0 ? x - 1 : 0], r = in[x < W - 1 ? x + 1 : W - 1];
          o[2 * x] = (uint8_t)(x == 0 ? in[0] : (v3 + l + 1) >> 2);
          o[2 * x + 1] = (uint8_t)(x == W - 1 ? in[x] : (v3 + r + 2) >> 2);
        }
      }
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; y++) {
        const uint8_t *in0 = row(y), *up = row(y - 1), *dn = row(y + 1);
        uint8_t* o0 = &out[(size_t)(2 * y) * ow];
        uint8_t* o1 = o0 + ow;
        for (int x = 0; x < W; x++) {
          o0[x] = (uint8_t)((in0[x] * 3 + up[x] + 1) >> 2);
          o1[x] = (uint8_t)((in0[x] * 3 + dn[x] + 2) >> 2);
        }
      }
    } else if (hr == 2 && vr == 2 && W > 2) {  // h2v2_fancy_upsample
      std::vector<int> cs(W);
      for (int y = 0; y < H; y++) {
        for (int v = 0; v < 2; v++) {
          const uint8_t *in0 = row(y), *in1 = row(v == 0 ? y - 1 : y + 1);
          for (int x = 0; x < W; x++) cs[x] = in0[x] * 3 + in1[x];
          uint8_t* o = &out[(size_t)(2 * y + v) * ow];
          for (int x = 0; x < W; x++) {
            int l = cs[x > 0 ? x - 1 : 0], r = cs[x < W - 1 ? x + 1 : W - 1];
            o[2 * x] = (uint8_t)((cs[x] * 3 + l + 8) >> 4);
            o[2 * x + 1] = (uint8_t)((cs[x] * 3 + r + 7) >> 4);
          }
        }
      }
    } else {  // plain replication (h2v1_upsample, h2v2_upsample, int_upsample)
      for (int y = 0; y < oh; y++) {
        const uint8_t* in = row(y / vr);
        uint8_t* o = &out[(size_t)y * ow];
        for (int x = 0; x < ow; x++) o[x] = in[x / hr];
      }
    }
    return out;
  }

  void output(uint8_t* out) {
    for (const Component& c : comps)
      if (!c.seen) fail("a component has no scan");
    if (ncomp == 1) {
      const Component& c = comps[0];
      for (int y = 0; y < height; y++)
        std::memcpy(out + (size_t)y * width, c.plane.data() + (size_t)y * c.pw, width);
      return;
    }
    std::vector<uint8_t> up[3];
    int ows[3];
    for (int i = 0; i < 3; i++) {
      up[i] = upsample(comps[i]);
      ows[i] = comps[i].ds_w * (hmax / comps[i].h);
    }
    bool rgb;
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
    if (rgb) {
      for (int y = 0; y < height; y++)
        for (int x = 0; x < width; x++)
          for (int i = 0; i < 3; i++)
            out[((size_t)y * width + x) * 3 + i] = up[i][(size_t)y * ows[i] + x];
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto FIX = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i <= 255; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
    const uint8_t* lim = kRange.table + 256;  // simple clamp table, valid for -256..511
    for (int yy = 0; yy < height; yy++) {
      const uint8_t* py = &up[0][(size_t)yy * ows[0]];
      const uint8_t* pb = &up[1][(size_t)yy * ows[1]];
      const uint8_t* pr = &up[2][(size_t)yy * ows[2]];
      uint8_t* o = out + (size_t)yy * width * 3;
      for (int x = 0; x < width; x++) {
        int y = py[x], cb = pb[x], cr = pr[x];
        o[3 * x] = lim[y + cr_r[cr]];
        o[3 * x + 1] = lim[y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS)];
        o[3 * x + 2] = lim[y + cb_b[cb]];
      }
    }
  }
};

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

// ---------------------------------------------------------------- resample

const int PRECISION_BITS = 32 - 8 - 2;

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}

double lanczos_filter(double x) {
  if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
  return 0.0;
}

// Resample.c precompute_coeffs + normalize_coeffs_8bpc
int precompute_coeffs(int in_size, float in0, float in1, int out_size, int filter,
                      std::vector<int>& bounds, std::vector<int32_t>& kk) {
  double (*fn)(double) = filter == 1 ? lanczos_filter : bilinear_filter;
  double support_base = filter == 1 ? 3.0 : 1.0;
  double filterscale, scale;
  filterscale = scale = (double)(in1 - in0) / out_size;
  if (filterscale < 1.0) filterscale = 1.0;
  double support = support_base * filterscale;
  int ksize = (int)std::ceil(support) * 2 + 1;
  std::vector<double> pre((size_t)out_size * ksize, 0.0);
  bounds.assign((size_t)out_size * 2, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[(size_t)xx * ksize];
    int x;
    for (x = 0; x < xmax; x++) {
      double w = fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    for (; x < ksize; x++) k[x] = 0;
    bounds[(size_t)xx * 2] = xmin;
    bounds[(size_t)xx * 2 + 1] = xmax;
  }
  kk.resize(pre.size());
  for (size_t i = 0; i < pre.size(); i++)
    kk[i] = pre[i] < 0 ? (int32_t)(-0.5 + pre[i] * (1 << PRECISION_BITS))
                       : (int32_t)(0.5 + pre[i] * (1 << PRECISION_BITS));
  return ksize;
}

inline uint8_t clip8(int in) {
  int v = in >> PRECISION_BITS;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

}  // namespace

extern "C" {

// The frame header's width, height and components (jpeg_decode's output
// size); 0, or -1 with a message in err.
int jpeg_info(const uint8_t* data, long n, int* w, int* h, int* ncomp, char* err, int errlen) {
  try {
    Decoder(data, (size_t)n).frame_header(w, h, ncomp);
    return 0;
  } catch (const JpegError& e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

// Decode into out (h * w * ncomp bytes, as jpeg_info gives them); 0, or -1
// with a message in err.
int jpeg_decode(const uint8_t* data, long n, uint8_t* out, int w, int h, int ncomp, char* err,
                int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.parse();
    if (dec.width != w || dec.height != h || dec.ncomp != ncomp) {
      set_err(err, errlen, "output size does not match the frame header");
      return -1;
    }
    dec.output(out);
    return 0;
  } catch (const JpegError& e) {
    set_err(err, errlen, e.msg);
    return -1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

// Pillow's ImagingResample (8 bits per channel) of an [ih, iw, ch] image to
// [oh, ow, ch]; filter 1 = LANCZOS, 2 = BILINEAR. A resize to the same size
// copies, as Pillow's does.
int resample_u8(const uint8_t* in, int iw, int ih, int ch, uint8_t* out, int ow, int oh,
                int filter) {
  if (iw <= 0 || ih <= 0 || ow <= 0 || oh <= 0 || ch < 1 || ch > 4) return -1;
  if (filter != 1 && filter != 2) return -1;
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  float box[4] = {0.0f, 0.0f, (float)iw, (float)ih};
  bool need_h = ow != iw || box[0] != 0.0f || box[2] != ow;
  bool need_v = oh != ih || box[1] != 0.0f || box[3] != oh;
  int ksh = precompute_coeffs(iw, box[0], box[2], ow, filter, bh, kh);
  int ksv = precompute_coeffs(ih, box[1], box[3], oh, filter, bv, kv);
  int ybox_first = bv[0];
  int ybox_last = bv[(size_t)oh * 2 - 2] + bv[(size_t)oh * 2 - 1];
  const uint8_t* src = in;
  int sw = iw, sh = ih;
  std::vector<uint8_t> tmp;
  if (need_h) {
    for (int i = 0; i < oh; i++) bv[(size_t)i * 2] -= ybox_first;
    int th = ybox_last - ybox_first;
    tmp.resize((size_t)th * ow * ch);
    for (int yy = 0; yy < th; yy++) {
      const uint8_t* row = in + (size_t)(yy + ybox_first) * iw * ch;
      uint8_t* o = &tmp[(size_t)yy * ow * ch];
      for (int xx = 0; xx < ow; xx++) {
        int xmin = bh[(size_t)xx * 2], xmax = bh[(size_t)xx * 2 + 1];
        const int32_t* k = &kh[(size_t)xx * ksh];
        for (int c = 0; c < ch; c++) {
          int ss = 1 << (PRECISION_BITS - 1);
          for (int x = 0; x < xmax; x++) ss += row[(size_t)(x + xmin) * ch + c] * k[x];
          o[(size_t)xx * ch + c] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    sw = ow;
    sh = th;
  }
  if (need_v) {
    for (int yy = 0; yy < oh; yy++) {
      const int32_t* k = &kv[(size_t)yy * ksv];
      int ymin = bv[(size_t)yy * 2], ymax = bv[(size_t)yy * 2 + 1];
      uint8_t* o = out + (size_t)yy * sw * ch;
      for (int xx = 0; xx < sw * ch; xx++) {
        int ss = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; y++) ss += src[(size_t)(y + ymin) * sw * ch + xx] * k[y];
        o[xx] = clip8(ss);
      }
    }
  } else {
    std::memcpy(out, src, (size_t)sw * sh * ch);
  }
  return 0;
}

}  // extern "C"
