// Host-side image I/O of the port: a baseline, extended sequential and
// progressive JPEG decoder and Pillow's LANCZOS / BILINEAR resampler, with
// a plain C interface for ctypes (built by hostio.py with the host C++
// compiler).
//
// The decoder follows libjpeg-turbo's default decompression path, which is
// what PIL uses, so that its output equals np.asarray(Image.open(path)) bit
// for bit:
//   - Huffman decoding of sequential scans (jdhuff.c), interleaved or not,
//     with restart intervals; damaged data as libjpeg takes it: a unit that
//     reads past its segment's data reads zero bits, the units after it up
//     to the next restart stay zero (mid-grey), a wrong RSTn resyncs as
//     jpeg_resync_to_restart does, a code past 16 bits is symbol 0;
//   - progressive Huffman scans (SOF2, jdphuff.c): DC first and refinement
//     scans, interleaved or not, AC first and refinement scans over a band
//     Ss..Se with EOB runs, into a whole-image coefficient array per
//     component; scan parameters checked as libjpeg checks them; damaged
//     data as above, the units left as they were; after the last scan,
//     libjpeg-turbo 3.1's block smoothing (jdcoefct.c
//     decompress_smooth_data, on by default) where coefficients were left
//     unrefined, with the Al from before the last scan in the iMCU rows
//     after the one where that scan ran out of data;
//   - the ISLOW integer IDCT (jidctint.c) with the 16-bit arithmetic of
//     libjpeg-turbo's x86 SIMD version, which PIL runs;
//   - fancy upsampling (jdsample.c: h2v1, h2v2 and h1v2 with their edge
//     rules and biases; plain replication where the component is 2 samples
//     wide or less); never the merged upsampler;
//   - fixed-point YCbCr -> RGB with 16 scale bits (jdcolor.c).
// Lossless, hierarchical and arithmetic-coded frames, 12-bit samples and 2-
// or 4-component (CMYK) images are refused with a message that names the
// marker.
//
// The resampler is Pillow's Resample.c: per output pixel, coefficients in
// double, normalised, then fixed point with PRECISION_BITS = 32 - 8 - 2;
// the horizontal pass over only the rows the vertical pass reads, then the
// vertical pass; each result rounded and clipped to 8 bits.
#include <algorithm>
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
  bool dc_ok = false;  // every symbol <= 15, as a DC table's must be
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
  t.dc_ok = std::all_of(vals, vals + nvals, [](uint8_t v) { return v <= 15; });
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
  // zero bits appended past the data (saturating: cnt < pad exactly when
  // some of them were consumed, libjpeg's insufficient_data)
  int pad = 0;

  void reset_at(size_t p) {
    pos = p;
    acc = 0;
    cnt = 0;
    hit_marker = false;
    pad = 0;
  }
  bool past_end() const { return cnt < pad; }
  void fill() {
    while (cnt <= 56) {
      uint32_t c = 0;
      if (hit_marker || pos >= n) {
        pad = std::min(pad + 8, 128);
      } else {
        c = d[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q < n && d[q] == 0x00) {
            pos = q + 1;
          } else {
            hit_marker = true;  // pos stays at the marker's first 0xFF
            c = 0;
            pad += 8;
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
    if (l > 16) {  // corrupt data: libjpeg returns symbol 0, past the 17th bit
      if (cnt < 17) fill();
      skip(17);
      return 0;
    }
    skip(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

// jdmaster.c prepare_range_limit_table's simple table: table[x + 256]
// clamps x in -256..511 to 0..255 (the colour conversion's range)
struct RangeLimit {
  uint8_t table[768];
  RangeLimit() {
    for (int i = 0; i < 768; i++) table[i] = (uint8_t)std::min(std::max(i - 256, 0), 255);
  }
};
const RangeLimit kRange;

// The ISLOW integer IDCT (jidctint.c) as libjpeg-turbo's x86 SIMD version
// computes it (jidctint-sse2.asm / -avx2.asm; what PIL runs): coefficients
// dequantised to their low 16 bits, a column pass and a row pass on 16-bit
// values, where in0 +- in4, in7 + in3 and in5 + in1 wrap at 16 bits,
// products and their sums are 32-bit, and each pass's descaled outputs
// saturate to 16 bits; a block whose rows 1-7 are all zero takes the
// column pass's shortcut (the DC << 2, wrapped); samples saturate to
// 0..255. On any data a valid file holds this is jidctint.c's result.
const int CONST_BITS = 13, PASS1_BITS = 2;
const int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270, F_0_899 = 7373,
              F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
              F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int32_t add32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
inline int32_t sub32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
// vpaddd of the rounding constant, vpsrad, vpackssdw
template <int N>
inline int32_t descale_sat16(int32_t x) {
  return std::min(std::max(add32(x, 1 << (N - 1)) >> N, -32768), 32767);
}

// one 1-D pass of the 8 lanes in[k][0..7], k = 0..7, into out[k][..],
// descaled by N bits and saturated to 16 bits (element-wise over the lanes,
// 16-bit operands, so that the compiler vectorises it)
template <int N>
inline void idct_lanes(const int16_t (*__restrict in)[8], int16_t (*__restrict out)[8]) {
  for (int c = 0; c < 8; c++) {
    const int16_t z2 = in[2][c], z3 = in[6][c];
    const int32_t tmp3 = z2 * (F_0_541 + F_0_765) + z3 * F_0_541;
    const int32_t tmp2 = z2 * F_0_541 + z3 * (F_0_541 - F_1_847);
    const int32_t tmp0 = (int32_t)(int16_t)(in[0][c] + in[4][c]) * (1 << CONST_BITS);
    const int32_t tmp1 = (int32_t)(int16_t)(in[0][c] - in[4][c]) * (1 << CONST_BITS);
    const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
    const int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
    const int16_t i7 = in[7][c], i5 = in[5][c], i3 = in[3][c], i1 = in[1][c];
    const int16_t z3s = (int16_t)(i7 + i3), z4s = (int16_t)(i5 + i1);
    const int32_t zz3 = z3s * (F_1_175 - F_1_961) + z4s * F_1_175;
    const int32_t zz4 = z3s * F_1_175 + z4s * (F_1_175 - F_0_390);
    const int32_t o0 = add32(i7 * (F_0_298 - F_0_899) + i1 * -F_0_899, zz3);
    const int32_t o1 = add32(i5 * (F_2_053 - F_2_562) + i3 * -F_2_562, zz4);
    const int32_t o2 = add32(i5 * -F_2_562 + i3 * (F_3_072 - F_2_562), zz3);
    const int32_t o3 = add32(i7 * -F_0_899 + i1 * (F_1_501 - F_0_899), zz4);
    out[0][c] = (int16_t)descale_sat16<N>(add32(tmp10, o3));
    out[7][c] = (int16_t)descale_sat16<N>(sub32(tmp10, o3));
    out[1][c] = (int16_t)descale_sat16<N>(add32(tmp11, o2));
    out[6][c] = (int16_t)descale_sat16<N>(sub32(tmp11, o2));
    out[2][c] = (int16_t)descale_sat16<N>(add32(tmp12, o1));
    out[5][c] = (int16_t)descale_sat16<N>(sub32(tmp12, o1));
    out[3][c] = (int16_t)descale_sat16<N>(add32(tmp13, o0));
    out[4][c] = (int16_t)descale_sat16<N>(sub32(tmp13, o0));
  }
}

inline uint8_t to_sample(int x) { return (uint8_t)(std::min(std::max(x, -128), 127) + 128); }

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  alignas(32) int16_t in[8][8], ws[8][8], wt[8][8], px[8][8];
  int16_t ac = 0;
  for (int i = 8; i < 64; i++) ac |= coef[i];
  if (!(ac | coef[1] | coef[2] | coef[3] | coef[4] | coef[5] | coef[6] | coef[7])) {
    // the DC alone: both passes give one value, (DC << 2 wrapped + 16) >> 5
    const int v = ((int16_t)((int16_t)(coef[0] * q[0]) * 4) + 16) >> 5;
    for (int r = 0; r < 8; r++) std::memset(out + (size_t)r * stride, to_sample(v), 8);
    return;
  }
  for (int i = 0; i < 64; i++) in[i / 8][i % 8] = (int16_t)(coef[i] * q[i]);  // vpmullw
  if (ac) {
    idct_lanes<CONST_BITS - PASS1_BITS>(in, ws);     // the columns
  } else {  // rows 1-7 all zero: the DC << 2, wrapped, down each column
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++) ws[r][c] = (int16_t)(in[0][c] * 4);
  }
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) wt[c][r] = ws[r][c];
  idct_lanes<CONST_BITS + PASS1_BITS + 3>(wt, px);  // the rows, one per lane
  for (int r = 0; r < 8; r++) {
    uint8_t* o = out + (size_t)r * stride;
    for (int c = 0; c < 8; c++) o[c] = to_sample(px[c][r]);
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
  // progressive only: the coefficients of every block, natural order, in
  // the MCU-padded grid (cbw x cbh blocks, as jdcoefct.c's whole_image),
  // the Al of the last scan of each zigzag coefficient (-1: none yet), and
  // those Al as they stood before the component's last scan
  int cbw = 0, cbh = 0;
  std::vector<int16_t> coef;
  int coef_bits[64], prev_bits[64];
  int16_t* block(int by, int bx) { return coef.data() + ((size_t)by * cbw + bx) * 64; }
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
  bool progressive = false;
  int scans = 0;
  // the last iMCU row the latest scan finished with data to spare
  // (libjpeg's last_good_iMCU_row); smoothing below it uses prev_bits
  int last_good_row = 0;
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
      if (pos >= n)
        fail(scans ? "truncated file: no EOI after scan " + std::to_string(scans)
                   : std::string("unexpected end of file (no EOI)"));
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
      if (progressive) {
        c.cbw = mcux * c.h;
        c.cbh = mcuy * c.v;
        c.coef.assign((size_t)c.cbw * c.cbh * 64, 0);
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
        std::fill(c.prev_bits, c.prev_bits + 64, 0);
      }
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

  // after an interval: read the RSTn marker, or resync as libjpeg's
  // jpeg_resync_to_restart does where another marker stands there, and
  // restart the bit reader. False where the reader is left at a marker: the
  // segment after it is empty and keeps the data run out.
  bool restart(BitReader& br, int& expected) {
    size_t p = br.pos, at = p;
    auto next = [&]() {  // jdmarker.c next_marker: `at` its first 0xFF, p past it
      for (;;) {
        while (p < n && d[p] != 0xFF) p++;
        at = p;
        while (p < n && d[p] == 0xFF) p++;
        if (p >= n) fail("truncated file: no restart marker after scan " + std::to_string(scans));
        int c = d[p++];
        if (c != 0) return c;
      }
    };
    const auto rst = [&](int k) { return 0xD0 + (k & 7); };
    bool consumed = true;
    for (int m = next(); m != rst(expected);) {
      if (m < 0xC0 || m == rst(expected - 1) || m == rst(expected - 2)) {
        m = next();  // junk or an earlier restart: on to the next marker
      } else if ((m < 0xD0 || m > 0xD7) || m == rst(expected + 1) || m == rst(expected + 2)) {
        p = at;  // another marker, or one of the next two restarts: left for later
        consumed = false;
        break;
      } else {
        break;  // a restart too far away: taken in place of this one
      }
    }
    expected = (expected + 1) & 7;
    br.reset_at(p);
    return consumed;
  }

  // a block of a unit left unread once the data has run out: libjpeg's
  // zeroed coefficients, a flat mid-grey block
  void mid_grey(Component& c, int by, int bx) {
    for (int r = 0; r < 8; r++)
      std::memset(c.plane.data() + ((size_t)by * 8 + r) * c.pw + (size_t)bx * 8, 128, 8);
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
    pos = end;
    scans++;
    if (progressive) return progressive_scan(idx, td, ta, ss, se, ahal >> 4, ahal & 15);
    if (ss != 0 || se != 63 || ahal != 0) fail("spectral selection in a sequential scan");
    for (int i = 0; i < ns; i++) {
      Component& c = comps[idx[i]];
      if (!dc[td[i]].defined || !ac[ta[i]].defined) fail("scan uses an undefined Huffman table");
      if (!dc[td[i]].dc_ok) fail("scan uses a DC Huffman table with a symbol above 15");
      if (!qt_defined[c.tq]) fail("component uses an undefined quantization table");
      std::memcpy(c.q, qt[c.tq], sizeof(c.q));
      if (c.plane.empty()) c.plane.assign((size_t)c.pw * c.ph, 0);
      c.seen = true;
    }
    BitReader br{d, n, pos};
    std::vector<int> pred(ns, 0);
    int expected_rst = 0;
    // once a unit reads past the segment's data, libjpeg leaves the units
    // after it zeroed until the next restart
    bool insufficient = false;
    long mcus_left = restart_interval;
    auto maybe_restart = [&](bool more) {
      insufficient = insufficient || br.past_end();
      if (!restart_interval) return;
      if (--mcus_left == 0 && more) {
        if (restart(br, expected_rst)) insufficient = false;
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
          if (insufficient) mid_grey(c, by, bx);
          else decode_block(br, c, pred[0], dct, act, by, bx);
          maybe_restart(++k < total);
        }
    } else {
      long total = (long)mcux * mcuy, k = 0;
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          for (int i = 0; i < ns; i++) {
            Component& c = comps[idx[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) {
                const int by = my * c.v + v, bx = mx * c.h + h;
                if (insufficient) mid_grey(c, by, bx);
                else decode_block(br, c, pred[i], dc[td[i]], ac[ta[i]], by, bx);
              }
          }
          maybe_restart(++k < total);
        }
    }
    pos = br.pos;  // next_marker() skips whatever is left before the marker
  }

  // ---- progressive scans (jdphuff.c)

  std::string scan_name() const { return "scan " + std::to_string(scans); }

  void progressive_scan(const std::vector<int>& idx, const std::vector<int>& td,
                        const std::vector<int>& ta, int ss, int se, int ah, int al) {
    const int ns = (int)idx.size();
    const bool dc_band = ss == 0;
    // start_pass_phuff_decoder's checks: each is fatal in libjpeg (PIL raises)
    const char* bad = nullptr;
    if (dc_band) {
      if (se != 0) bad = "a DC scan with Se != 0";
    } else if (ss > se) {
      bad = "Ss > Se";
    } else if (se > 63) {
      bad = "Se > 63";
    } else if (ns != 1) {
      bad = "an AC scan names more than one component";
    }
    if (!bad && ah != 0 && al != ah - 1) bad = "a refinement scan with Al != Ah - 1";
    if (!bad && al > 13) bad = "Al > 13";
    if (bad)
      fail(scan_name() + " (Ss " + std::to_string(ss) + ", Se " + std::to_string(se) + ", Ah " +
           std::to_string(ah) + ", Al " + std::to_string(al) + "): bad progression: " + bad);
    for (int i = 0; i < ns; i++) {
      Component& c = comps[idx[i]];
      if (dc_band ? ah == 0 && !dc[td[i]].defined : !ac[ta[i]].defined)
        fail(scan_name() + " uses an undefined Huffman table");
      if (dc_band && ah == 0 && !dc[td[i]].dc_ok)
        fail(scan_name() + " uses a DC Huffman table with a symbol above 15");
      if (!c.seen) {  // latched at the component's first scan (jdinput.c latch_quant_tables)
        if (!qt_defined[c.tq]) fail("component uses an undefined quantization table");
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
      }
      c.seen = true;
      // a bogus progression (a band refined twice, AC before DC) only warns
      for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
        c.prev_bits[k] = scans > 1 ? c.coef_bits[k] : 0;
      for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
    }
    BitReader br{d, n, pos};
    long long pred[4] = {0, 0, 0, 0};
    int eobrun = 0, expected_rst = 0;
    // once a unit reads past the segment's data, libjpeg leaves the units
    // after it untouched until the next restart
    bool insufficient = false;
    long mcus_left = restart_interval;
    // before each unit of iMCU row `row`: the row is good while the data
    // has not run out before the unit
    auto unit_start = [&](int row) {
      if (!insufficient) last_good_row = row;
    };
    auto unit_done = [&](bool more) {
      insufficient = insufficient || br.past_end();
      if (!restart_interval) return;
      if (--mcus_left == 0 && more) {
        if (restart(br, expected_rst)) insufficient = false;
        std::fill(pred, pred + 4, 0);
        eobrun = 0;
        mcus_left = restart_interval;
      }
    };
    auto dc_unit = [&](int i, int16_t* b) {
      if (ah) {  // decode_mcu_DC_refine: one raw bit
        if (br.get(1)) b[0] = (int16_t)(b[0] | (1 << al));
        return;
      }
      int s = br.decode(dc[td[i]]);
      if (s) {
        int r = br.get(s);
        s = extend(r, s);
      }
      pred[i] += s;
      if (pred[i] > INT32_MAX || pred[i] < INT32_MIN) fail(scan_name() + ": DC out of range");
      b[0] = (int16_t)(uint16_t)((uint32_t)pred[i] << al);
    };
    if (dc_band && ns > 1) {  // interleaved: every block of each MCU, padding included
      long total = (long)mcux * mcuy, k = 0;
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          unit_start(my);
          for (int i = 0; i < ns && !insufficient; i++) {
            Component& c = comps[idx[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) dc_unit(i, c.block(my * c.v + v, mx * c.h + h));
          }
          unit_done(++k < total);
        }
    } else {  // one component: the blocks it covers, as the ns == 1 sequential scan
      Component& c = comps[idx[0]];
      const HuffTable& t = ac[ta[0]];
      long total = (long)c.bw * c.bh, k = 0;
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++) {
          int16_t* b = c.block(by, bx);
          unit_start(by / c.v);
          if (!insufficient) {
            if (dc_band) dc_unit(0, b);
            else if (ah == 0) ac_first(br, t, b, ss, se, al, eobrun);
            else ac_refine(br, t, b, ss, se, al, eobrun);
          }
          unit_done(++k < total);
        }
    }
    pos = br.pos;
  }

  // decode_mcu_AC_first
  static void ac_first(BitReader& br, const HuffTable& t, int16_t* b, int ss, int se, int al,
                       int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int s = br.decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = br.get(s);
        b[kNatural[k]] = (int16_t)(uint16_t)((uint32_t)extend(r, s) << al);
      } else if (r == 15) {
        k += 15;  // ZRL
      } else {  // EOBr: a run of 2^r + r appended bits blocks, this one included
        eobrun = (1 << r) + br.get(r) - 1;
        break;
      }
    }
  }

  // decode_mcu_AC_refine: correction bits for the nonzero history, new
  // coefficients of +-1 << Al, and EOB runs that still refine the band
  static void ac_refine(BitReader& br, const HuffTable& t, int16_t* b, int ss, int se, int al,
                        int& eobrun) {
    const int p1 = 1 << al, m1 = -(1 << al);
    auto correct = [&](int16_t& coef) {
      if (br.get(1) && (coef & p1) == 0) coef = (int16_t)(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int s = br.decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {  // a size other than 1 only warns
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = (1 << r) + br.get(r);
          break;
        }
        do {
          int16_t& coef = b[kNatural[k]];
          if (coef != 0) correct(coef);
          else if (--r < 0) break;  // the target zero coefficient
          k++;
        } while (k <= se);
        if (s) b[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t& coef = b[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      eobrun--;
    }
  }

  // ---- progressive output: block smoothing (jdcoefct.c), then the IDCT

  // smoothing_ok: every component's DC partly known, the DC and first nine
  // AC quantisers nonzero, and some of those AC coefficients not exact
  bool smoothing_ok() const {
    bool useful = false;
    for (const Component& c : comps) {
      for (int k = 0; k < 10; k++)
        if (c.q[kNatural[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // decompress_smooth_data for one block: dc holds the DC values of the 5x5
  // neighbourhood (DC01..DC25 row by row), w the block, changed in place
  static void smooth_block(const Component& c, const int* bits, const int* dc, int16_t* w) {
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                           bits[5] == -1 && bits[6] == -1 && bits[7] == -1 &&
                           bits[8] == -1 && bits[9] == -1;
    const int64_t Q00 = c.q[0];
    auto D = [&](int i) { return (int64_t)dc[i - 1]; };
    // an estimate applies only where the coefficient is still zero and not exact
    auto estimate = [&](int zz, int64_t num) {
      const int pos = kNatural[zz], al = bits[zz];
      if (al == 0 || w[pos] != 0) return;
      const int64_t q = c.q[pos];
      int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      w[pos] = (int16_t)(num >= 0 ? pred : -pred);
    };
    if (change_dc) {  // DC interpolation: a Gaussian-like kernel over the 5x5 DCs
      estimate(1, Q00 * (-D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) - 13 * D(9) +
                         3 * D(10) - 3 * D(11) + 38 * D(12) - 38 * D(14) + 3 * D(15) -
                         3 * D(16) + 13 * D(17) - 13 * D(19) + 3 * D(20) - D(21) - D(22) +
                         D(24) + D(25)));
      estimate(2, Q00 * (-D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) + 13 * D(7) +
                         38 * D(8) + 13 * D(9) - D(10) + D(16) - 13 * D(17) - 38 * D(18) -
                         13 * D(19) + D(20) + D(21) + 3 * D(22) + 3 * D(23) + 3 * D(24) +
                         D(25)));
      estimate(3, Q00 * (D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) - 14 * D(13) -
                         5 * D(14) + 2 * D(17) + 7 * D(18) + 2 * D(19) + D(23)));
      estimate(4, Q00 * (-D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) + 9 * D(19) + D(21) -
                         D(25)));
      estimate(5, Q00 * (2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) - 14 * D(13) +
                         7 * D(14) + D(15) + 2 * D(17) - 5 * D(18) + 2 * D(19)));
      estimate(6, Q00 * (D(7) - D(9) + 2 * D(12) - 2 * D(14) + D(17) - D(19)));
      estimate(7, Q00 * (D(7) - 3 * D(8) + D(9) - D(17) + 3 * D(18) - D(19)));
      estimate(8, Q00 * (D(7) - D(9) - 3 * D(12) + 3 * D(14) + D(17) - D(19)));
      estimate(9, Q00 * (D(7) + 2 * D(8) + D(9) - D(17) - 2 * D(18) - D(19)));
      const int64_t num =
          Q00 * (-2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) - 6 * D(6) + 6 * D(7) +
                 42 * D(8) + 6 * D(9) - 6 * D(10) - 8 * D(11) + 42 * D(12) + 152 * D(13) +
                 42 * D(14) - 8 * D(15) - 6 * D(16) + 6 * D(17) + 42 * D(18) + 6 * D(19) -
                 6 * D(20) - 2 * D(21) - 6 * D(22) - 8 * D(23) - 6 * D(24) - 2 * D(25));
      const int pred = (int)(((Q00 << 7) + (num >= 0 ? num : -num)) / (Q00 << 8));
      w[0] = (int16_t)(num >= 0 ? pred : -pred);
    } else {  // T.81 K.8's AC prediction over a 5x5 window
      estimate(1, Q00 * (-7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15)));
      estimate(2, Q00 * (-7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23)));
      estimate(3, Q00 * (-D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23)));
      estimate(4, Q00 * (D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) + D(22) -
                         D(24) + D(4) - D(6) + 10 * D(7) - 10 * D(9)));
      estimate(5, Q00 * (-D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15)));
    }
  }

  // every block the output reads (the bw x bh the component covers),
  // smoothed when smoothing_ok, dequantised and transformed into the plane
  void finish_progressive() {
    for (const Component& c : comps)
      if (!c.seen) fail("a component has no scan");
    const bool smooth = smoothing_ok();
    for (Component& c : comps) {
      c.plane.assign((size_t)c.pw * c.ph, 0);
      const int T = mcuy, last = c.bw - 1;
      // the rows after the latest scan ran out of data smooth with the
      // Al before that scan (none at all after a single scan)
      int prev[10];
      for (int k = 0; k < 10; k++) prev[k] = scans > 1 ? c.prev_bits[k] : -1;
      for (int R = 0; R < T; R++) {
        const int* bits = R > last_good_row ? prev : c.coef_bits;
        // decompress_smooth_data's rows: an iMCU row's real block rows, and
        // the neighbours it picks by its own row count (image_block_rows)
        int block_rows = c.v;
        if (R == T - 1 && c.bh % c.v) block_rows = c.bh % c.v;
        const int image_rows = block_rows * T;
        for (int b = 0; b < block_rows; b++) {
          const int row = R * c.v + b, ib = R * block_rows + b;
          int rows[5];
          rows[2] = row;
          rows[1] = ib > 0 ? row - 1 : row;
          rows[0] = ib > 1 ? row - 2 : rows[1];
          rows[3] = ib < image_rows - 1 ? row + 1 : row;
          rows[4] = ib < image_rows - 2 ? row + 2 : rows[3];
          for (int bx = 0; bx < c.bw; bx++) {
            int16_t w[64];
            std::memcpy(w, c.block(row, bx), sizeof(w));
            if (smooth) {
              int dcs[25];
              for (int i = 0; i < 5; i++)
                for (int j = 0; j < 5; j++)
                  dcs[i * 5 + j] = c.block(rows[i], std::min(std::max(bx + j - 2, 0), last))[0];
              smooth_block(c, bits, dcs, w);
            }
            idct_islow(w, c.q, c.plane.data() + (size_t)row * 8 * c.pw + (size_t)bx * 8, c.pw);
          }
        }
      }
    }
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
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        if (frame) fail("second frame header");
        progressive = m == 0xC2;
        sof(m);
      } else if (m == 0xC3 || m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xC9 || m == 0xCA ||
                 m == 0xCB || m == 0xCD || m == 0xCE || m == 0xCF) {
        const char* kind = m == 0xC3 ? "lossless"
                           : m == 0xC5 ? "hierarchical"
                           : m == 0xC6 ? "progressive, hierarchical"
                           : m == 0xC7 ? "lossless, hierarchical"
                           : m == 0xC9 ? "arithmetic-coded"
                           : m == 0xCA ? "progressive, arithmetic-coded"
                           : m == 0xCB ? "lossless, arithmetic-coded"
                           : m == 0xCD ? "hierarchical, arithmetic-coded"
                           : m == 0xCE ? "progressive, hierarchical, arithmetic-coded"
                                       : "lossless, hierarchical, arithmetic-coded";
        fail("SOF" + std::to_string(m - 0xC0) + " (" + marker_name(m) + ", " + kind +
             ") is not supported: only baseline, extended sequential and progressive "
             "Huffman JPEGs (SOF0, SOF1, SOF2) are");
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
    if (progressive) finish_progressive();
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
