// Native FLAC subset decoder (companion to wavio.cpp).
//
// Scope: the full *standard* FLAC stream feature set actually emitted
// by the reference encoder for PCM corpora (LibriSpeech et al.):
// 8/16/24-bit, constant/verbatim/fixed(0-4)/LPC(1-32) subframes,
// Rice/Rice2 residual partitions incl. raw-bits escapes, wasted bits,
// all four channel assignments (independent, left/side, right/side,
// mid/side), fixed and variable blocking strategies, CRC-8 frame
// header and CRC-16 frame verification.  NOT supported (loud error
// codes, never silent garbage): streams whose STREAMINFO omits the
// total sample count (-8), >2^32 samples, reserved codes (-4),
// Ogg-encapsulated FLAC (-1).
//
// C ABI:
//   flac_info(buf, len, &sr, &ch, &bits, &nframes)   -> 0 | <0
//   flac_decode(buf, len, out[ch*nframes])           -> 0 | <0
//     out is channel-major float32 in [-1, 1).
//
// Error codes: -1 bad magic, -2 bad/truncated metadata, -3
// unsupported bit depth, -4 reserved/invalid frame field, -5 CRC
// mismatch, -6 bitstream overrun, -7 malformed subframe, -8 unknown
// total length, -9 sample-count mismatch.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* p;
  size_t n;
  size_t byte = 0;
  int bit = 0;  // 0..7, MSB first
  bool err = false;

  BitReader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}

  inline uint32_t bits(int k) {  // k <= 32
    uint32_t v = 0;
    while (k > 0) {
      if (byte >= n) { err = true; return 0; }
      int take = 8 - bit;
      if (take > k) take = k;
      uint32_t chunk = (p[byte] >> (8 - bit - take)) & ((1u << take) - 1u);
      v = (v << take) | chunk;
      bit += take;
      k -= take;
      if (bit == 8) { bit = 0; ++byte; }
    }
    return v;
  }

  inline uint64_t bits64(int k) {
    uint64_t v = 0;
    if (k > 32) { v = bits(k - 32); k = 32; }
    return (v << k) | bits(k);
  }

  inline int32_t sbits(int k) {  // signed, two's complement
    uint32_t v = bits(k);
    if (k == 0) return 0;
    if (v & (1u << (k - 1))) return (int32_t)(v | (~0u << k));
    return (int32_t)v;
  }

  inline uint32_t unary() {
    uint32_t q = 0;
    for (;;) {
      if (byte >= n) { err = true; return 0; }
      if (bits(1)) return q;
      ++q;
      if (q > 1u << 24) { err = true; return 0; }  // runaway guard
    }
  }

  inline void align() {
    if (bit) { bit = 0; ++byte; }
  }
};

inline uint8_t crc8(const uint8_t* p, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= p[i];
    for (int b = 0; b < 8; ++b)
      c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
  }
  return c;
}

inline uint16_t crc16(const uint8_t* p, size_t n) {
  uint16_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= (uint16_t)p[i] << 8;
    for (int b = 0; b < 8; ++b)
      c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
  }
  return c;
}

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint64_t total = 0;
  size_t frames_off = 0;  // first audio frame byte offset
};

int parse_streaminfo(const uint8_t* buf, size_t len, StreamInfo* si) {
  if (len < 4 || memcmp(buf, "fLaC", 4) != 0) return -1;
  size_t off = 4;
  bool have_si = false;
  for (;;) {
    if (off + 4 > len) return -2;
    uint8_t hdr = buf[off];
    uint32_t blen = ((uint32_t)buf[off + 1] << 16) |
                    ((uint32_t)buf[off + 2] << 8) | buf[off + 3];
    size_t body = off + 4;
    if (body + blen > len) return -2;
    if ((hdr & 0x7F) == 0) {  // STREAMINFO
      if (blen < 34) return -2;
      BitReader br(buf + body, blen);
      br.bits(16);  // min blocksize
      br.bits(16);  // max blocksize
      br.bits(24);  // min framesize
      br.bits(24);  // max framesize
      si->sample_rate = br.bits(20);
      si->channels = (uint16_t)(br.bits(3) + 1);
      si->bits = (uint16_t)(br.bits(5) + 1);
      si->total = br.bits64(36);
      have_si = true;
    }
    off = body + blen;
    if (hdr & 0x80) break;  // last metadata block
  }
  if (!have_si) return -2;
  if (si->bits != 8 && si->bits != 16 && si->bits != 24) return -3;
  if (si->total == 0) return -8;
  si->frames_off = off;
  return 0;
}

// residual for one subframe, predictor order `pred`, into x[pred..bs)
int read_residual(BitReader& br, int bs, int pred, int32_t* x) {
  uint32_t method = br.bits(2);
  if (method > 1) return -4;
  int pbits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t porder = br.bits(4);
  int nparts = 1 << porder;
  if (bs % nparts != 0) return -7;
  int idx = pred;
  for (int part = 0; part < nparts; ++part) {
    int count = bs >> porder;
    if (part == 0) count -= pred;
    if (count < 0) return -7;
    uint32_t param = br.bits(pbits);
    if (param == escape) {
      uint32_t raw = br.bits(5);
      for (int i = 0; i < count; ++i)
        x[idx++] = raw ? br.sbits((int)raw) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.unary();
        uint32_t r = param ? br.bits((int)param) : 0;
        uint32_t v = (q << param) | r;
        x[idx++] = (int32_t)(v >> 1) ^ -(int32_t)(v & 1);
        if (br.err) return -6;
      }
    }
    if (br.err) return -6;
  }
  return 0;
}

int read_subframe(BitReader& br, int bs, int bps, int32_t* x) {
  if (br.bits(1) != 0) return -4;  // padding bit
  uint32_t type = br.bits(6);
  int wasted = 0;
  if (br.bits(1)) wasted = (int)br.unary() + 1;
  if (br.err) return -6;
  bps -= wasted;
  if (bps <= 0 || bps > 32) return -7;

  if (type == 0) {  // CONSTANT
    int32_t v = br.sbits(bps);
    for (int i = 0; i < bs; ++i) x[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < bs; ++i) x[i] = br.sbits(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED order 0-4
    int order = (int)type - 8;
    if (order > bs) return -7;
    for (int i = 0; i < order; ++i) x[i] = br.sbits(bps);
    int rc = read_residual(br, bs, order, x);
    if (rc) return rc;
    switch (order) {
      case 0: break;
      case 1:
        for (int i = 1; i < bs; ++i) x[i] += x[i - 1];
        break;
      case 2:
        for (int i = 2; i < bs; ++i) x[i] += 2 * x[i - 1] - x[i - 2];
        break;
      case 3:
        for (int i = 3; i < bs; ++i)
          x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
        break;
      case 4:
        for (int i = 4; i < bs; ++i)
          x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4];
        break;
    }
  } else if (type >= 32) {  // LPC order 1-32
    int order = (int)(type & 31) + 1;
    if (order > bs) return -7;
    for (int i = 0; i < order; ++i) x[i] = br.sbits(bps);
    uint32_t prec = br.bits(4);
    if (prec == 15) return -4;
    int precision = (int)prec + 1;
    int shift = br.sbits(5);
    if (shift < 0) return -4;
    int32_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br.sbits(precision);
    int rc = read_residual(br, bs, order, x);
    if (rc) return rc;
    for (int i = order; i < bs; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j)
        acc += (int64_t)coef[j] * x[i - 1 - j];
      x[i] += (int32_t)(acc >> shift);
    }
  } else {
    return -4;  // reserved subframe type
  }
  if (br.err) return -6;
  if (wasted)
    for (int i = 0; i < bs; ++i) x[i] = (int32_t)((uint32_t)x[i] << wasted);
  return 0;
}

}  // namespace

extern "C" {

int flac_info(const uint8_t* buf, size_t len, uint32_t* sr, uint16_t* ch,
              uint16_t* bits, uint64_t* nframes) {
  StreamInfo si;
  int rc = parse_streaminfo(buf, len, &si);
  if (rc) return rc;
  *sr = si.sample_rate;
  *ch = si.channels;
  *bits = si.bits;
  *nframes = si.total;
  return 0;
}

int flac_decode(const uint8_t* buf, size_t len, float* out) {
  StreamInfo si;
  int rc = parse_streaminfo(buf, len, &si);
  if (rc) return rc;
  const int ch = si.channels;
  const float scale = 1.0f / (float)(1u << (si.bits - 1));

  BitReader br(buf, len);
  br.byte = si.frames_off;
  uint64_t done = 0;
  std::vector<std::vector<int32_t>> x((size_t)ch);

  while (done < si.total) {
    size_t frame_start = br.byte;
    if (br.bit != 0) return -4;
    // ---- frame header ----
    if (frame_start + 2 > len) return -6;
    if (buf[frame_start] != 0xFF || (buf[frame_start + 1] & 0xFC) != 0xF8)
      return -4;  // 14-bit sync + reserved bit
    br.bits(14);
    br.bits(1);             // reserved (already checked 0)
    br.bits(1);             // blocking strategy
    uint32_t bs_code = br.bits(4);
    uint32_t sr_code = br.bits(4);
    uint32_t ch_asgn = br.bits(4);
    uint32_t ss_code = br.bits(3);
    if (br.bits(1) != 0) return -4;  // reserved
    // UTF-8 coded frame/sample number: first byte determines length
    uint32_t lead = br.bits(8);
    int extra = 0;
    if (lead >= 0x80) {
      uint32_t m = 0x40;
      while (lead & m) { ++extra; m >>= 1; }
      if (extra < 1 || extra > 6) return -4;
      for (int i = 0; i < extra; ++i)
        if ((br.bits(8) & 0xC0) != 0x80) return -4;
    }
    uint32_t bs;
    if (bs_code == 0) return -4;
    else if (bs_code == 1) bs = 192;
    else if (bs_code <= 5) bs = 576u << (bs_code - 2);
    else if (bs_code == 6) bs = br.bits(8) + 1;
    else if (bs_code == 7) bs = br.bits(16) + 1;
    else bs = 256u << (bs_code - 8);
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    else if (sr_code == 15) return -4;
    // CRC-8 over the header bytes read so far
    uint8_t hcrc = (uint8_t)br.bits(8);
    if (br.err) return -6;
    if (crc8(buf + frame_start, br.byte - 1 - frame_start) != hcrc)
      return -5;

    // channel count per assignment
    int nch;
    if (ch_asgn < 8) nch = (int)ch_asgn + 1;
    else if (ch_asgn <= 10) nch = 2;
    else return -4;
    if (nch != ch) return -4;
    int bps;
    switch (ss_code) {
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      case 0: bps = (int)si.bits; break;
      default: return -4;
    }
    if (bps != (int)si.bits) return -4;
    if (done + bs > si.total) return -9;

    for (int c = 0; c < ch; ++c) {
      if (x[(size_t)c].size() < bs) x[(size_t)c].resize(bs);
      int sub_bps = bps;
      if ((ch_asgn == 8 && c == 1) ||    // left/side
          (ch_asgn == 9 && c == 0) ||    // right/side
          (ch_asgn == 10 && c == 1))     // mid/side
        sub_bps += 1;
      rc = read_subframe(br, (int)bs, sub_bps, x[(size_t)c].data());
      if (rc) return rc;
    }
    br.align();
    uint16_t fcrc = (uint16_t)br.bits(16);
    if (br.err) return -6;
    if (crc16(buf + frame_start, br.byte - 2 - frame_start) != fcrc)
      return -5;

    // stereo decorrelation
    if (ch_asgn == 8) {        // left/side -> right = left - side
      for (uint32_t i = 0; i < bs; ++i)
        x[1][i] = x[0][i] - x[1][i];
    } else if (ch_asgn == 9) { // right/side -> left = right + side
      for (uint32_t i = 0; i < bs; ++i)
        x[0][i] = x[1][i] + x[0][i];
    } else if (ch_asgn == 10) {  // mid/side
      for (uint32_t i = 0; i < bs; ++i) {
        int32_t side = x[1][i];
        int32_t mid = ((int32_t)((uint32_t)x[0][i] << 1)) | (side & 1);
        x[0][i] = (mid + side) >> 1;
        x[1][i] = (mid - side) >> 1;
      }
    }
    for (int c = 0; c < ch; ++c) {
      float* dst = out + (size_t)c * si.total + done;
      for (uint32_t i = 0; i < bs; ++i) dst[i] = x[(size_t)c][i] * scale;
    }
    done += bs;
  }
  return 0;
}

}  // extern "C"
