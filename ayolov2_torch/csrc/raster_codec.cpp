// Host decoders of the port's uncompressed-family formats: the loops that
// BMP's run-length encoding and TIFF's LZW and PackBits compression need,
// equal bit for bit to what OpenCV's imread gives (its own BMP reader, and
// libtiff 4.7's codecs). The callers (data/codecs.py) parse the headers and
// turn samples into BGR.
//
// - BMP RLE8 and RLE4 as OpenCV's BmpDecoder reads them: encoded runs,
//   absolute runs (padded to 16 bits), end of line, end of bitmap and delta
//   escapes; what a skip leaves behind takes palette entry 0; a run past
//   the end of its line or data that ends first raise. In RLE4, as in
//   OpenCV, an escape fills only to its horizontal target: end of bitmap
//   ends the line, and a delta's rows are not skipped.
// - TIFF LZW, the current MSB-first codes with the width raised one code
//   early and the old LSB-first ("compat") order that libtiff still reads,
//   told apart by the first two bytes as libtiff does; and PackBits.
//
// Plain C interface for ctypes; no global state.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct CodecError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError{msg}; }

int report(const CodecError& e, char* msg, int msg_len) {
  if (msg && msg_len > 0) snprintf(msg, (size_t)msg_len, "%s", e.msg.c_str());
  return 1;
}

struct ByteStream {
  const uint8_t* p;
  const uint8_t* end;
  int byte() {
    if (p >= end) fail("BMP data ends inside the run-length data");
    return *p++;
  }
  int word() {
    int lo = byte();
    return lo | (byte() << 8);
  }
  void bytes(uint8_t* dst, int n) {
    if (end - p < n) fail("BMP data ends inside the run-length data");
    memcpy(dst, p, n);
    p += n;
  }
};

// OpenCV's FillUniColor: count3 bytes of one colour from data on, moving to
// the next line at each line's end; y counts the lines finished
uint8_t* fill_uni(uint8_t* data, uint8_t*& line_end, int step, int width3, int& y, int height,
                  int count3, const uint8_t* clr) {
  do {
    uint8_t* end = data + count3;
    if (end > line_end) end = line_end;
    count3 -= (int)(end - data);
    for (; data < end; data += 3) memcpy(data, clr, 3);
    if (data >= line_end) {
      line_end += step;
      data = line_end - width3;
      if (++y >= height) break;
    }
  } while (count3 > 0);
  return data;
}

uint8_t* fill_row8(uint8_t* data, const uint8_t* src, int n, const uint8_t* pal) {
  for (int i = 0; i < n; ++i, data += 3) memcpy(data, pal + 3 * src[i], 3);
  return data;
}

uint8_t* fill_row4(uint8_t* data, const uint8_t* src, int n, const uint8_t* pal) {
  for (int i = 0; i < n; ++i, data += 3) {
    int idx = i & 1 ? src[i >> 1] & 15 : src[i >> 1] >> 4;
    memcpy(data, pal + 3 * idx, 3);
  }
  return data;
}

// out: (h + 1) rows of w * 3 bytes (the last one a guard), in file order
void bmp_rle(const uint8_t* src, size_t n, int w, int h, int bits, const uint8_t* pal,
             uint8_t* out) {
  ByteStream s{src, src + n};
  const int width3 = w * 3, step = width3;
  uint8_t* data = out;
  uint8_t* line_end = data + width3;
  std::vector<uint8_t> buf(256 + 32);
  int y = 0;
  if (bits == 8) {
    int line_end_flag = 0;
    for (;;) {
      int code = s.word();
      int len = code & 255;
      code >>= 8;
      if (len != 0) {  // encoded run
        int prev_y = y;
        len *= 3;
        if (data + len > line_end) fail("BMP run-length data runs past a line");
        data = fill_uni(data, line_end, step, width3, y, h, len, pal + 3 * code);
        line_end_flag = y - prev_y;
        if (y >= h) break;
      } else if (code > 2) {  // absolute run
        int prev_y = y;
        if (data + code * 3 > line_end) fail("BMP run-length data runs past a line");
        int sz = (code + 1) & ~1;
        s.bytes(buf.data(), sz);
        data = fill_row8(data, buf.data(), code, pal);
        line_end_flag = y - prev_y;
      } else {
        int x_shift3 = (int)(line_end - data);
        int y_shift = h - y;
        if (code || !line_end_flag || x_shift3 < width3) {
          if (code == 2) {
            x_shift3 = s.byte() * 3;
            y_shift = s.byte();
          }
          x_shift3 += (y_shift * width3) & ((code == 0) - 1);
          if (y >= h) break;
          data = fill_uni(data, line_end, step, width3, y, h, x_shift3, pal);
          if (y >= h) break;
        }
        line_end_flag = 0;
        if (y >= h) break;
      }
    }
  } else {
    for (;;) {
      int code = s.word();
      int len = code & 255;
      code >>= 8;
      if (len != 0) {  // encoded run of two alternating colours
        const uint8_t* clr[2] = {pal + 3 * (code >> 4), pal + 3 * (code & 15)};
        uint8_t* end = data + len * 3;
        if (end > line_end) fail("BMP run-length data runs past a line");
        int t = 0;
        do {
          memcpy(data, clr[t], 3);
          t ^= 1;
        } while ((data += 3) < end);
      } else if (code > 2) {  // absolute run
        if (data + code * 3 > line_end) fail("BMP run-length data runs past a line");
        int sz = (((code + 1) >> 1) + 1) & ~1;
        s.bytes(buf.data(), sz);
        data = fill_row4(data, buf.data(), code, pal);
      } else {
        int x_shift3 = (int)(line_end - data);
        if (code == 2) {
          x_shift3 = s.byte() * 3;
          s.byte();  // the delta's rows
        }
        data = fill_uni(data, line_end, step, width3, y, h, x_shift3, pal);
        if (y >= h) break;
      }
    }
  }
}

// libtiff's LZWDecode (and LZWDecodeCompat for the old bit order) of one
// strip or tile into want bytes; returns the bytes written. Each table entry
// is the place and length of its string in the output already written (a
// code's string followed by the next string's first byte lies there), so a
// code is a forward byte copy.
int64_t lzw(const uint8_t* src, size_t n, uint8_t* dst, int64_t want) {
  const bool compat = n >= 2 && src[0] == 0 && (src[1] & 1);
  std::vector<int64_t> pos(4096);
  std::vector<int32_t> len(4096, 1);
  size_t bitpos = 0;
  const size_t nbits_total = n * 8;
  auto get = [&](int width) -> int {
    if (bitpos + width > nbits_total) return -1;
    size_t byte = bitpos >> 3;
    uint32_t window = 0;
    for (int k = 0; k < 3; ++k) window |= (uint32_t)(byte + k < n ? src[byte + k] : 0) << (8 * k);
    int shift = (int)(bitpos & 7);
    bitpos += width;
    if (compat) return (int)((window >> shift) & ((1u << width) - 1));
    uint32_t msb = ((window & 0xff) << 16) | (window & 0xff00) | ((window >> 16) & 0xff);
    return (int)((msb >> (24 - shift - width)) & ((1u << width) - 1));
  };
  int64_t out = 0;
  int width = 9, free_ent = 258, old = -1;
  // write code's string at out; a literal is its own byte
  auto emit = [&](int code) -> int64_t {
    const int64_t at = out;
    if (code < 256) {
      if (out < want) dst[out] = (uint8_t)code;
      ++out;
    } else {
      const int64_t from = pos[code];
      for (int32_t i = 0; i < len[code]; ++i, ++out)
        if (out < want) dst[out] = dst[from + i];
    }
    return at;
  };
  int64_t old_at = 0;
  while (out < want) {
    int code = get(width);
    if (code < 0 || code == 257) break;
    if (code == 256) {
      width = 9;
      free_ent = 258;
      code = get(width);
      if (code < 0 || code == 257) break;
      if (code >= 256) fail("TIFF LZW data is corrupt (a code after Clear)");
      old_at = emit(code);
      old = code;
      continue;
    }
    if (old < 0) fail("TIFF LZW data does not start with a Clear code");
    if (code > free_ent) fail("TIFF LZW data is corrupt (a code not yet in the table)");
    const int32_t old_len = old < 256 ? 1 : len[old];
    if (free_ent < 4096) {  // old's string and the next byte, which follows it in the output
      pos[free_ent] = old_at;
      len[free_ent] = old_len + 1;
      ++free_ent;
    }
    old_at = emit(code);  // a code just added (KwKwK) copies its own first byte forward
    old = code;
    const int limit = compat ? (1 << width) : (1 << width) - 1;
    if (free_ent >= limit && width < 12) ++width;
  }
  return out < want ? out : want;
}

int64_t packbits(const uint8_t* src, size_t n, uint8_t* dst, int64_t want) {
  size_t i = 0;
  int64_t out = 0;
  while (i < n && out < want) {
    int c = (int8_t)src[i++];
    if (c == -128) continue;
    if (c < 0) {
      int64_t k = 1 - c;
      if (k > want - out) k = want - out;
      if (i >= n) break;
      memset(dst + out, src[i++], (size_t)k);
      out += k;
    } else {
      int64_t k = c + 1;
      if (k > want - out) k = want - out;
      if (n - i < (size_t)k) break;
      memcpy(dst + out, src + i, (size_t)k);
      out += k;
      i += (size_t)k;
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Decode BMP RLE8 (bits 8) or RLE4 (bits 4) data (src[0:n]) of a w x h image
// into out ((h + 1) * w * 3 bytes: the rows in file order, then a guard row)
// with pal, 256 BGR entries. Returns 0, or 1 with msg saying why.
int ayolo_bmp_rle(const uint8_t* src, int64_t n, int w, int h, int bits, const uint8_t* pal,
                  uint8_t* out, char* msg, int msg_len) {
  try {
    bmp_rle(src, (size_t)n, w, h, bits, pal, out);
    return 0;
  } catch (const CodecError& e) {
    return report(e, msg, msg_len);
  }
}

// Decompress one TIFF strip or tile (src[0:n]) into dst[0:want]: method 5
// (LZW) or 32773 (PackBits). Returns the bytes written, or -1 with msg.
int64_t ayolo_tiff_unpack(const uint8_t* src, int64_t n, int method, uint8_t* dst, int64_t want,
                          char* msg, int msg_len) {
  try {
    if (method == 5) return lzw(src, (size_t)n, dst, want);
    return packbits(src, (size_t)n, dst, want);
  } catch (const CodecError& e) {
    report(e, msg, msg_len);
    return -1;
  }
}

}  // extern "C"
