// Host JPEG decoder with libjpeg's arithmetic: baseline and progressive
// Huffman JPEGs of 8-bit samples, 1, 3 or 4 components with sampling
// factors of 1 or 2, decoded to RGB as Pillow's
// ``Image.open(path).convert("RGB")`` does over libjpeg-turbo:
//   - entropy decoding as jdhuff.c / jdphuff.c (restart markers reset the DC
//     predictors and the EOB run; data cut by a marker reads as zero bits,
//     and the rest of that restart segment stays zero, as libjpeg leaves it);
//   - the accurate integer IDCT of jidctint.c (jpeg_idct_islow), its output
//     clamped to 0..255;
//   - the default fancy upsampling of jdsample.c (h2v1 and h2v2 with their
//     alternating rounding bias, h2v2 reading the rows above and below with
//     the first and last real rows replicated; box upsampling where the
//     component is at most 2 samples wide); h1v2 is refused;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c; grayscale is
//     replicated; the Adobe APP14 transform picks RGB against YCbCr and CMYK
//     against YCCK; CMYK then goes through Pillow's inverted ("CMYK;I")
//     unpacking, which Pillow assumes for every 4-component JPEG, and its
//     CMYK -> RGB conversion.
// Arithmetic coding, lossless, hierarchical and 12-bit files raise.
//
// C interface (loaded with ctypes, which drops the GIL during the call):
//   int mcl_jpeg_info(const uint8_t* data, long long n, int* width,
//                     int* height, char* err, int err_len);
//   int mcl_jpeg_decode(const uint8_t* data, long long n, uint8_t* out,
//                       long long out_len, char* err, int err_len);
// Both return 0, or 1 with a message in ``err``.  ``out`` takes H*W*3 bytes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// zigzag index -> natural (row-major) index; 16 extra entries absorb
// corrupt run lengths that step past 63, as jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t look_len[1 << kLookBits];
  uint8_t look_sym[1 << kLookBits];

  // jdhuff.c jpeg_make_d_derived_tbl
  void build() {
    int huffsize[257];
    unsigned huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int numsymbols = p;
    unsigned code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if ((int64_t)code >= ((int64_t)1 << si)) throw DecodeError("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - (int32_t)huffcode[p];
        p += bits[l];
        maxcode[l] = (int32_t)huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look_len, 0, sizeof(look_len));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 1; i <= bits[l]; i++, p++) {
        int look = (int)(huffcode[p] << (kLookBits - l));
        for (int ctr = 1 << (kLookBits - l); ctr > 0; ctr--, look++) {
          look_len[look] = (uint8_t)l;
          look_sym[look] = vals[p];
        }
      }
    }
    (void)numsymbols;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int blocks_w = 0, blocks_h = 0;      // blocks stored (whole MCUs)
  int comp_blocks_w = 0, comp_blocks_h = 0;  // blocks a non-interleaved scan covers
  int width = 0, height = 0;           // downsampled size in samples
  bool quant_latched = false;
  uint16_t quant[64];
  std::vector<int16_t> coef;           // blocks_h * blocks_w * 64, natural order
  int dc_pred = 0;
  int16_t* block(int by, int bx) { return &coef[((size_t)by * blocks_w + bx) * 64]; }
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  size_t pos() const { return pos_; }
  bool insufficient() const { return insufficient_; }

  // jdhuff.c jpeg_fill_bit_buffer: stuffed FF00 is FF, FF fill bytes before a
  // marker are skipped, past a marker the stream reads as zeros
  void fill() {
    while (cnt_ <= 56) {
      uint32_t byte = 0;
      if (!marker_) {
        if (pos_ >= n_) throw DecodeError("file is truncated inside entropy-coded data");
        byte = d_[pos_];
        if (byte == 0xFF) {
          size_t q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) q++;
          if (q >= n_) throw DecodeError("file is truncated inside entropy-coded data");
          if (d_[q] == 0) {
            pos_ = q + 1;
          } else {
            marker_ = true;
            pos_ = q - 1;  // at the FF that starts the marker
            byte = 0;
            fake_ += 8;
          }
        } else {
          pos_++;
        }
      } else {
        fake_ += 8;
      }
      buf_ |= (uint64_t)byte << (56 - cnt_);
      cnt_ += 8;
    }
  }

  uint32_t peek(int n) {
    if (cnt_ < n) fill();
    return (uint32_t)(buf_ >> (64 - n));
  }

  void skip(int n) {
    buf_ <<= n;
    cnt_ -= n;
    if (cnt_ < fake_) {
      insufficient_ = true;
      fake_ = cnt_;
    }
  }

  int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return (int)v;
  }

  int decode(const Huffman& t) {
    uint32_t look = peek(kLookBits);
    int len = t.look_len[look];
    if (len) {
      skip(len);
      return t.look_sym[look];
    }
    // jdhuff.c jpeg_huff_decode, codes longer than the lookahead
    uint32_t bits16 = peek(16);
    int l = kLookBits + 1;
    int32_t code = (int32_t)(bits16 >> (16 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = (int32_t)(bits16 >> (16 - l));
    }
    if (l > 16) {  // corrupt data: libjpeg warns and decodes 0 after 17 bits
      skip(16);
      skip(1);
      return 0;
    }
    skip(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  // start of a restart interval: drop the remaining bits, consume an RSTn
  // marker if one is next (libjpeg's read_restart_marker for a valid file;
  // any other marker stays and the segment reads as zeros)
  void restart() {
    buf_ = 0;
    cnt_ = 0;
    fake_ = 0;
    insufficient_ = false;
    size_t q = find_marker(pos_);
    if (q + 1 < n_ && d_[q + 1] >= 0xD0 && d_[q + 1] <= 0xD7) {
      pos_ = q + 2;
      marker_ = false;
    } else {
      pos_ = q;
      marker_ = true;
    }
  }

  // the position of the next marker's FF at or after p (garbage skipped)
  size_t find_marker(size_t p) const {
    while (true) {
      while (p < n_ && d_[p] != 0xFF) p++;
      while (p + 1 < n_ && d_[p + 1] == 0xFF) p++;
      if (p + 1 >= n_) throw DecodeError("file is truncated: no marker after entropy-coded data");
      if (d_[p + 1] != 0) return p;
      p += 2;
    }
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_;
  uint64_t buf_ = 0;
  int cnt_ = 0;
  int fake_ = 0;
  bool marker_ = false;
  bool insufficient_ = false;
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)((unsigned)-1 << s) + 1 : r; }

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  void read_header() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) throw DecodeError("not a JPEG file (no SOI marker)");
    pos_ = 2;
    while (!have_frame_) {
      int m = next_marker();
      if (m == 0xD9) throw DecodeError("no frame header before EOI");
      if (m == 0xDA) throw DecodeError("scan before the frame header");
      segment(m);
    }
  }

  void decode(uint8_t* out) {
    allocate();
    bool eoi = false;
    while (!eoi) {
      int m = next_marker();
      if (m == 0xD9) {
        eoi = true;
      } else if (m == 0xDA) {
        scan();
        scans_++;
      } else {
        segment(m);
      }
    }
    if (scans_ == 0) throw DecodeError("no scan in the file");
    to_rgb(out);
  }

  int width() const { return width_; }
  int height() const { return height_; }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool have_frame_ = false, progressive_ = false;
  int width_ = 0, height_ = 0, max_h_ = 1, max_v_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  std::vector<Component> comps_;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;  // as read before the first scan
  int adobe_transform_ = 0;
  int scans_ = 0;

  int byte() {
    if (pos_ >= n_) throw DecodeError("file is truncated inside a marker segment");
    return d_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // jdmarker.c next_marker: skip garbage up to FF, then FF fill bytes
  int next_marker() {
    while (true) {
      if (pos_ >= n_) throw DecodeError("file is truncated: no EOI marker");
      if (d_[pos_] != 0xFF) {
        pos_++;
        continue;
      }
      while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
      if (pos_ >= n_) throw DecodeError("file is truncated: no EOI marker");
      int m = d_[pos_++];
      if (m != 0) return m;
    }
  }

  void segment(int m) {
    if (m >= 0xD0 && m <= 0xD7) return;  // a stray RSTn carries no length
    if (m == 0x01) return;
    size_t start = pos_;
    int len = word();
    if (len < 2) throw DecodeError("bad marker segment length");
    size_t end = start + (size_t)len;
    if (end > n_) throw DecodeError("file is truncated inside a marker segment");
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        frame(m == 0xC2, end);
        break;
      case 0xC3:
        throw DecodeError("lossless JPEG is not supported");
      case 0xC5: case 0xC6: case 0xC7:
        throw DecodeError("hierarchical JPEG is not supported");
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        throw DecodeError("arithmetic-coded JPEG is not supported");
      case 0xCC:
        throw DecodeError("arithmetic-coded JPEG is not supported (DAC marker)");
      case 0xC4:
        huffman_tables(end);
        break;
      case 0xDB:
        quant_tables(end);
        break;
      case 0xDD:
        restart_interval_ = word();
        break;
      case 0xDC:
        throw DecodeError("DNL marker is not supported");
      case 0xE0:
        if (len >= 16 && std::memcmp(d_ + start + 2, "JFIF\0", 5) == 0 && !scans_) saw_jfif_ = true;
        break;
      case 0xEE:
        if (len - 2 >= 12 && std::memcmp(d_ + start + 2, "Adobe", 5) == 0 && !scans_) {
          saw_adobe_ = true;  // libjpeg reads APP14 of at least APP14_DATA_LEN bytes
          adobe_transform_ = d_[start + 2 + 11];
        }
        break;
      default:
        break;
    }
    pos_ = end;
  }

  void frame(bool progressive, size_t end) {
    if (have_frame_) throw DecodeError("more than one frame header");
    int precision = byte();
    if (precision != 8) throw DecodeError(std::to_string(precision) + "-bit samples are not supported");
    height_ = word();
    width_ = word();
    int nc = byte();
    if (height_ == 0) throw DecodeError("a height of 0 (DNL) is not supported");
    if (width_ == 0) throw DecodeError("a width of 0");
    if (nc != 1 && nc != 3 && nc != 4)
      throw DecodeError(std::to_string(nc) + " components are not supported");
    if ((size_t)(8 + 3 * nc) > end - (pos_ - 8)) throw DecodeError("bad frame header length");
    comps_.resize(nc);
    for (auto& c : comps_) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        throw DecodeError("sampling factors other than 1 or 2 are not supported");
      if (c.tq > 3) throw DecodeError("bad quantization table index");
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    progressive_ = progressive;
    have_frame_ = true;
  }

  void quant_tables(size_t end) {
    while (pos_ < end) {
      int pq = byte();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3) throw DecodeError("bad quantization table index");
      for (int i = 0; i < 64; i++) qt_[tq][kNatural[i]] = (uint16_t)(prec ? word() : byte());
      qt_defined_[tq] = true;
    }
  }

  void huffman_tables(size_t end) {
    while (pos_ < end) {
      int tc = byte();
      int cls = tc >> 4, idx = tc & 15;
      if (cls > 1 || idx > 3) throw DecodeError("bad Huffman table index");
      Huffman& t = cls ? ac_[idx] : dc_[idx];
      int count = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; l++) {
        t.bits[l] = (uint8_t)byte();
        count += t.bits[l];
      }
      if (count > 256) throw DecodeError("bad Huffman table");
      std::memset(t.vals, 0, sizeof(t.vals));
      for (int i = 0; i < count; i++) t.vals[i] = (uint8_t)byte();
      t.build();
    }
  }

  void allocate() {
    mcus_x_ = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
    mcus_y_ = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
    for (auto& c : comps_) {
      c.width = (int)(((int64_t)width_ * c.h + max_h_ - 1) / max_h_);
      c.height = (int)(((int64_t)height_ * c.v + max_v_ - 1) / max_v_);
      c.comp_blocks_w = (int)(((int64_t)width_ * c.h + 8 * max_h_ - 1) / (8 * max_h_));
      c.comp_blocks_h = (int)(((int64_t)height_ * c.v + 8 * max_v_ - 1) / (8 * max_v_));
      c.blocks_w = mcus_x_ * c.h;
      c.blocks_h = mcus_y_ * c.v;
      c.coef.assign((size_t)c.blocks_w * c.blocks_h * 64, 0);
    }
  }

  // ---- scans -------------------------------------------------------------

  void scan() {
    size_t start = pos_;
    int len = word();
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) throw DecodeError("bad scan header");
    std::vector<Component*> sc;
    std::vector<int> td(ns), ta(ns);
    for (int i = 0; i < ns; i++) {
      int cid = byte();
      int t = byte();
      Component* found = nullptr;
      for (auto& c : comps_)
        if (c.id == cid) found = &c;
      if (!found) throw DecodeError("scan names an unknown component");
      sc.push_back(found);
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) throw DecodeError("bad Huffman table index in a scan");
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    pos_ = start + (size_t)len;
    if (!progressive_) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) throw DecodeError("bad baseline scan parameters");
    } else {
      bool bad = ss > se || se > 63 || al > 13 || (ah != 0 && ah != al + 1);
      if (ss == 0 && se != 0) bad = true;
      if (ss != 0 && ns != 1) bad = true;
      if (bad) throw DecodeError("bad progressive scan parameters");
    }
    // latch each component's quantization table at its first scan
    for (auto* c : sc) {
      if (!c->quant_latched) {
        if (!qt_defined_[c->tq]) throw DecodeError("a component's quantization table is not defined");
        std::memcpy(c->quant, qt_[c->tq], sizeof(c->quant));
        c->quant_latched = true;
      }
      c->dc_pred = 0;
    }
    bool need_dc = !progressive_ || ss == 0;
    bool need_ac = !progressive_ || ss != 0;
    for (int i = 0; i < ns; i++) {
      if (need_dc && !(progressive_ && ah != 0) && !dc_[td[i]].defined)
        throw DecodeError("a scan uses an undefined Huffman table");
      if (need_ac && !ac_[ta[i]].defined) throw DecodeError("a scan uses an undefined Huffman table");
    }

    BitReader br(d_, n_, pos_);
    int eobrun = 0;
    int restarts_to_go = restart_interval_;
    auto mcu_prologue = [&]() {
      if (restart_interval_) {
        if (restarts_to_go == 0) {
          br.restart();
          for (auto* c : sc) c->dc_pred = 0;
          eobrun = 0;
          restarts_to_go = restart_interval_;
        }
        restarts_to_go--;
      }
    };
    auto decode_block = [&](Component* c, int i, int16_t* blk) {
      if (!progressive_) baseline_block(br, *c, dc_[td[i]], ac_[ta[i]], blk);
      else if (ss == 0) {
        if (ah == 0) dc_first(br, *c, dc_[td[i]], blk, al);
        else if (br.get(1)) blk[0] |= (int16_t)(1 << al);
      } else if (ah == 0) {
        ac_first(br, ac_[ta[i]], blk, ss, se, al, eobrun);
      } else {
        ac_refine(br, ac_[ta[i]], blk, ss, se, al, eobrun);
      }
    };

    if (ns == 1) {
      Component* c = sc[0];
      for (int by = 0; by < c->comp_blocks_h; by++) {
        for (int bx = 0; bx < c->comp_blocks_w; bx++) {
          mcu_prologue();
          if (br.insufficient()) continue;
          decode_block(c, 0, c->block(by, bx));
        }
      }
    } else {
      for (int my = 0; my < mcus_y_; my++) {
        for (int mx = 0; mx < mcus_x_; mx++) {
          mcu_prologue();
          if (br.insufficient()) continue;
          for (int i = 0; i < ns; i++) {
            Component* c = sc[i];
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++)
                decode_block(c, i, c->block(my * c->v + y, mx * c->h + x));
          }
        }
      }
    }
    pos_ = br.find_marker(br.pos());
  }

  static void baseline_block(BitReader& br, Component& c, const Huffman& dc, const Huffman& ac,
                             int16_t* blk) {
    int s = br.decode(dc);
    if (s) s = extend(br.get(s), s);
    c.dc_pred += s;
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.get(s), s);
        blk[kNatural[k]] = (int16_t)v;
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void dc_first(BitReader& br, Component& c, const Huffman& dc, int16_t* blk, int al) {
    int s = br.decode(dc);
    if (s) s = extend(br.get(s), s);
    c.dc_pred += s;
    blk[0] = (int16_t)((unsigned)c.dc_pred << al);
  }

  static void ac_first(BitReader& br, const Huffman& ac, int16_t* blk, int ss, int se, int al,
                       int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.get(s), s);
        blk[kNatural[k]] = (int16_t)((unsigned)v << al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          eobrun--;
          break;
        }
      }
    }
  }

  static void ac_refine(BitReader& br, const Huffman& ac, int16_t* blk, int ss, int se, int al,
                        int& eobrun) {
    int p1 = 1 << al;
    int m1 = (int)((unsigned)-1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1)) {
              if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.get(1)) {
            if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          }
        }
      }
      eobrun--;
    }
  }

  // ---- reconstruction ----------------------------------------------------

  static inline uint8_t clamp8(int64_t x) { return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x)); }

  // jidctint.c jpeg_idct_islow
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                      F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                      F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; };
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      int* wp = ws + col;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
          ip[56] == 0) {
        int dc = (int)((int64_t)ip[0] * qp[0] * (1 << P1));
        for (int r = 0; r < 8; r++) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = (int64_t)ip[0] * qp[0];
      z3 = (int64_t)ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (int64_t)ip[56] * qp[56];
      tmp1 = (int64_t)ip[40] * qp[40];
      tmp2 = (int64_t)ip[24] * qp[24];
      tmp3 = (int64_t)ip[8] * qp[8];
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
      wp[0] = (int)descale(tmp10 + tmp3, CB - P1);
      wp[56] = (int)descale(tmp10 - tmp3, CB - P1);
      wp[8] = (int)descale(tmp11 + tmp2, CB - P1);
      wp[48] = (int)descale(tmp11 - tmp2, CB - P1);
      wp[16] = (int)descale(tmp12 + tmp1, CB - P1);
      wp[40] = (int)descale(tmp12 - tmp1, CB - P1);
      wp[24] = (int)descale(tmp13 + tmp0, CB - P1);
      wp[32] = (int)descale(tmp13 - tmp0, CB - P1);
    }
    for (int row = 0; row < 8; row++) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + (size_t)row * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
          wp[7] == 0) {
        uint8_t dc = clamp8(descale(wp[0], P1 + 3) + 128);
        std::memset(op, dc, 8);
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB);
      int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
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
      constexpr int S = CB + P1 + 3;
      op[0] = clamp8(descale(tmp10 + tmp3, S) + 128);
      op[7] = clamp8(descale(tmp10 - tmp3, S) + 128);
      op[1] = clamp8(descale(tmp11 + tmp2, S) + 128);
      op[6] = clamp8(descale(tmp11 - tmp2, S) + 128);
      op[2] = clamp8(descale(tmp12 + tmp1, S) + 128);
      op[5] = clamp8(descale(tmp12 - tmp1, S) + 128);
      op[3] = clamp8(descale(tmp13 + tmp0, S) + 128);
      op[4] = clamp8(descale(tmp13 - tmp0, S) + 128);
    }
  }

  // one component as a full-resolution plane [out_h][out_w] (jdsample.c)
  std::vector<uint8_t> plane(Component& c, int out_w, int out_h) {
    int pw = c.blocks_w * 8, ph = c.blocks_h * 8;
    std::vector<uint8_t> p((size_t)pw * ph);
    for (int by = 0; by < c.blocks_h; by++)
      for (int bx = 0; bx < c.blocks_w; bx++)
        idct_islow(c.block(by, bx), c.quant, &p[(size_t)by * 8 * pw + bx * 8], pw);
    int rh = max_h_ / c.h, rv = max_v_ / c.v;
    std::vector<uint8_t> o((size_t)out_w * out_h);
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < out_h; y++) std::memcpy(&o[(size_t)y * out_w], &p[(size_t)y * pw], out_w);
      return o;
    }
    if (rh == 1 && rv == 2) throw DecodeError("h1v2 (4:4:0) chroma subsampling is not supported");
    bool fancy = c.width > 2;
    if (!fancy) {  // box upsampling (h2v1_upsample, h2v2_upsample)
      for (int y = 0; y < out_h; y++)
        for (int x = 0; x < out_w; x++) o[(size_t)y * out_w + x] = p[(size_t)(y / rv) * pw + x / rh];
      return o;
    }
    std::vector<uint8_t> row(2 * (size_t)c.width);
    if (rv == 1) {  // h2v1_fancy_upsample
      for (int y = 0; y < out_h; y++) {
        const uint8_t* in = &p[(size_t)y * pw];
        uint8_t* op = row.data();
        int inv = in[0];
        *op++ = (uint8_t)inv;
        *op++ = (uint8_t)((inv * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < c.width - 1; x++) {
          inv = in[x] * 3;
          *op++ = (uint8_t)((inv + in[x - 1] + 1) >> 2);
          *op++ = (uint8_t)((inv + in[x + 1] + 2) >> 2);
        }
        inv = in[c.width - 1];
        *op++ = (uint8_t)((inv * 3 + in[c.width - 2] + 1) >> 2);
        *op++ = (uint8_t)inv;
        std::memcpy(&o[(size_t)y * out_w], row.data(), out_w);
      }
      return o;
    }
    // h2v2_fancy_upsample: context rows above/below, the first and last real
    // rows (of c.height) replicated past the edges
    for (int y = 0; y < out_h; y++) {
      int r0 = y >> 1;
      int r1 = (y & 1) ? r0 + 1 : r0 - 1;
      r1 = std::min(std::max(r1, 0), c.height - 1);
      r0 = std::min(r0, c.height - 1);
      const uint8_t* i0 = &p[(size_t)r0 * pw];
      const uint8_t* i1 = &p[(size_t)r1 * pw];
      uint8_t* op = row.data();
      int thiscol = i0[0] * 3 + i1[0];
      int nextcol = i0[1] * 3 + i1[1];
      *op++ = (uint8_t)((thiscol * 4 + 8) >> 4);
      *op++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 2; x < c.width; x++) {
        nextcol = i0[x] * 3 + i1[x];
        *op++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        *op++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      *op++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      *op++ = (uint8_t)((thiscol * 4 + 7) >> 4);
      std::memcpy(&o[(size_t)y * out_w], row.data(), out_w);
    }
    return o;
  }

  void to_rgb(uint8_t* out) {
    const int w = width_, h = height_;
    const size_t npix = (size_t)w * h;
    std::vector<std::vector<uint8_t>> planes;
    for (auto& c : comps_) {
      if (!c.quant_latched) throw DecodeError("a component has no scan");
      planes.push_back(plane(c, w, h));
    }
    int nc = (int)comps_.size();
    if (nc == 1) {
      const uint8_t* g = planes[0].data();
      for (size_t i = 0; i < npix; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
      return;
    }
    // jdapimin.c default_decompress_parms
    bool ycc;
    if (nc == 3) {
      if (saw_jfif_) ycc = true;
      else if (saw_adobe_) ycc = adobe_transform_ != 0;
      else ycc = !(comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66);
    } else {
      ycc = saw_adobe_ && adobe_transform_ != 0;  // YCCK, else CMYK
    }
    // jdcolor.c build_ycc_rgb_table
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((91881LL * x + 32768) >> 16);
      cb_b[i] = (int)((116130LL * x + 32768) >> 16);
      cr_g[i] = -46802LL * x;
      cb_g[i] = -22554LL * x + 32768;
    }
    const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(), *p2 = planes[2].data();
    if (nc == 3) {
      for (size_t i = 0; i < npix; i++) {
        if (ycc) {
          int y = p0[i], cb = p1[i], cr = p2[i];
          out[3 * i] = clamp8(y + cr_r[cr]);
          out[3 * i + 1] = clamp8(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
          out[3 * i + 2] = clamp8(y + cb_b[cb]);
        } else {
          out[3 * i] = p0[i];
          out[3 * i + 1] = p1[i];
          out[3 * i + 2] = p2[i];
        }
      }
      return;
    }
    const uint8_t* p3 = planes[3].data();
    for (size_t i = 0; i < npix; i++) {
      int cmyk[4];
      if (ycc) {  // jdcolor.c ycck_cmyk_convert
        int y = p0[i], cb = p1[i], cr = p2[i];
        cmyk[0] = 255 - clamp8(y + cr_r[cr]);
        cmyk[1] = 255 - clamp8(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        cmyk[2] = 255 - clamp8(y + cb_b[cb]);
      } else {
        cmyk[0] = p0[i];
        cmyk[1] = p1[i];
        cmyk[2] = p2[i];
      }
      cmyk[3] = p3[i];
      for (int k = 0; k < 4; k++) cmyk[k] = 255 - cmyk[k];  // Pillow's "CMYK;I" raw mode
      // Pillow Convert.c cmyk2rgb
      int nk = 255 - cmyk[3];
      for (int k = 0; k < 3; k++) {
        int tmp = cmyk[k] * nk + 128;
        int v = nk - (((tmp >> 8) + tmp) >> 8);
        out[3 * i + k] = clamp8(v);
      }
    }
  }
};

void write_error(char* err, int err_len, const char* msg) {
  if (err && err_len > 0) {
    std::strncpy(err, msg, (size_t)err_len - 1);
    err[err_len - 1] = 0;
  }
}

}  // namespace

extern "C" int mcl_jpeg_info(const uint8_t* data, long long n, int* width, int* height, char* err,
                             int err_len) {
  try {
    Decoder dec(data, (size_t)n);
    dec.read_header();
    *width = dec.width();
    *height = dec.height();
    return 0;
  } catch (const std::exception& e) {
    write_error(err, err_len, e.what());
    return 1;
  }
}

extern "C" int mcl_jpeg_decode(const uint8_t* data, long long n, uint8_t* out, long long out_len,
                               char* err, int err_len) {
  try {
    Decoder dec(data, (size_t)n);
    dec.read_header();
    if ((long long)dec.width() * dec.height() * 3 > out_len) throw DecodeError("output buffer too small");
    dec.decode(out);
    return 0;
  } catch (const std::bad_alloc&) {
    write_error(err, err_len, "out of memory");
    return 1;
  } catch (const std::exception& e) {
    write_error(err, err_len, e.what());
    return 1;
  }
}
