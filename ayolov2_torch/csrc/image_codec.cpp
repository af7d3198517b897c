// Host image codecs of the port: a JPEG decoder and encoder and the pixel
// stage of a PNG decoder, equal bit for bit to what OpenCV's imread and
// imencode give through libjpeg-turbo and libpng at OpenCV's defaults.
//
// JPEG decoding follows libjpeg-turbo: baseline, extended sequential and
// progressive scans, Huffman-coded or arithmetic-coded (jdarith.c's QM
// decoder, DAC conditioning; data past a marker decoded as zeros) (restart
// intervals, 8- and 16-bit quantisation tables, tables redefined between
// scans, the standard Huffman tables where a file defines none), the islow
// inverse DCT in the arithmetic of libjpeg-turbo's SIMD version (which
// OpenCV's build runs), fancy upsampling (h2v1, h1v2, h2v2 with context
// rows; other integral factors replicated), and jdcolor.c's fixed-point
// YCbCr -> BGR. Data cut short reads on as libjpeg's stdio source feeds it
// (fake EOI markers): a Huffman scan is padded with zero bits and its rest
// left zero, and a progressive file cut before its last scan is
// block-smoothed (decompress_smooth_data). Four-component files are CMYK,
// or YCCK after an Adobe marker whose transform is not 0, turned into BGR by
// OpenCV's inverted-CMYK formula. Lossless frames (SOF3) follow jdlhuff.c,
// jddiffct.c and jdlossls.c: predictors 1-7, the point transform, any
// sampling (replicated, never fancy), restarts at MCU rows, and a scan that
// runs out of data read on at the centre value; cv2 gives an image only for
// 8-bit samples whose colour space libjpeg takes as RGB or CMYK, since it
// converts no colours in lossless mode. After the scan of a single-scan
// file nothing is read: OpenCV keeps the image whatever
// jpeg_finish_decompress finds there. A JPEG strip or tile of a TIFF is
// decoded as libtiff asks libjpeg to (ayolo_jpeg_decode's mode): YCbCr ->
// RGB whatever the markers say, or the components as stored. Hierarchical
// frames, arithmetic-coded lossless ones and DCT samples of other than 8
// bits raise as cv2.imread gives None for them.
//
// JPEG encoding is libjpeg-turbo's at OpenCV's defaults: JFIF, baseline,
// 4:2:0 (gray: one component), jpeg_set_quality's tables, jccolor.c's
// RGB -> YCbCr, h2v2 downsampling with the alternating 1, 2 bias, edges
// replicated to whole blocks, the islow forward DCT, jcdctmgr.c's
// reciprocal quantisation and the standard Huffman tables.
//
// PNG: the caller parses the chunks and inflates IDAT; here the rows are
// unfiltered (Adam7 passes too) and turned into BGR uint8 as OpenCV asks
// libpng to: 16 bits keep their high byte, alpha is dropped, gray and
// palettes are expanded (an index past the palette is black).
//
// Plain C interface for ctypes; no call holds any global state, so threads
// may decode at once.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status { OK = 0, CORRUPT = 1, UNSUPPORTED = 2 };

struct CodecError {
  Status status;
  std::string msg;
};

[[noreturn]] void fail(Status s, const std::string& msg) { throw CodecError{s, msg}; }

// zigzag index -> natural index, with the 16 extra entries libjpeg keeps so
// that a corrupt run past 63 lands on 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard Huffman tables (ITU T.81 K.3): bits[1..16], then the values.
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jcparam.c's base quantisation tables, natural order
const int kLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                        14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                        18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                          24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                          99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                          99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jaricom.c's jpeg_aritab (T.81 table D.2): Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed probability
// 0.5 of the sign and refinement bits
#define V(qe, nlps, nmps, sw) (((int32_t)(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int32_t kAriTab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

// islow's constants (13 fractional bits)
constexpr int32_t C0298 = 2446, C0390 = 3196, C0541 = 4433, C0765 = 6270, C0899 = 7373,
                  C1175 = 9633, C1501 = 12299, C1847 = 15137, C1961 = 16069, C2053 = 16819,
                  C2562 = 20995, C3072 = 25172;
constexpr int kConstBits = 13, kPass1Bits = 2;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }
inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---- JPEG decoding -------------------------------------------------------------

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | value, 0 where longer

  // dc: values above max_dc are refused, as libjpeg refuses them (15 in a
  // DCT frame, 16 in a lossless one)
  void derive(bool dc, int max_dc = 15) {
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) {
        if (p >= 256) fail(CORRUPT, "bad Huffman table");
        huffsize[p++] = l;
      }
    const int count = p;
    if (dc)
      for (int i = 0; i < count; i++)
        if (vals[i] > max_dc) fail(CORRUPT, "bad Huffman table");
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail(CORRUPT, "bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; l++)
      for (int i = 0; i < bits[l]; i++, p++) {
        int lookbits = huffcode[p] << (9 - l);
        for (int c = 0; c < (1 << (9 - l)); c++) look[lookbits + c] = (uint16_t)((l << 8) | vals[p]);
      }
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;    // blocks that hold image samples
  int bw = 0, bh = 0;      // blocks allocated (whole MCUs)
  int dw = 0, dh = 0;      // downsampled width and height
  bool latched = false;
  uint16_t q[64] = {};     // quantisation table latched at its first scan
  int coef_bits[64];  // libjpeg's progression status: Al of each coefficient, -1 unseen
  int prev_bits[64];  // the same before the last scan that held this component
  std::vector<int16_t> coef;
  std::vector<uint16_t> plane;  // lossless: the undifferenced samples, dw x dh
  int pt = 0;                   // lossless: the point transform of its scan
  int16_t* block(int by, int bx) { return coef.data() + ((size_t)by * bw + bx) * 64; }
};

// The entropy-coded data reader, with libjpeg's handling of markers: a
// marker (or the end of the data, read as EOI) stops it, and bits asked for
// beyond it are zeros and flag the scan as cut short.
struct BitReader {
  const uint8_t* data;
  size_t n, pos;
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;
  bool insufficient = false;

  void fill(int need) {
    while (bits <= 56 && !marker) {
      if (pos >= n) { marker = 0xD9; break; }
      int c = data[pos++];
      if (c == 0xFF) {
        do {
          if (pos >= n) { c = -1; break; }
          c = data[pos++];
        } while (c == 0xFF);
        if (c < 0) { marker = 0xD9; break; }
        if (c != 0) { marker = c; break; }
        c = 0xFF;
      }
      buf = (buf << 8) | (uint64_t)c;
      bits += 8;
    }
    if (bits < need) {
      insufficient = true;
      buf <<= (48 - bits);
      bits = 48;
    }
  }
  inline int get(int nb) {
    if (nb == 0) return 0;
    if (bits < nb) fill(nb);
    bits -= nb;
    return (int)((buf >> bits) & ((1u << nb) - 1));
  }
  inline int decode(const HuffTable& t) {
    if (bits < 9) fill(0);
    int l, code;
    if (bits >= 9) {
      int look = t.look[(buf >> (bits - 9)) & 511];
      if (look) {
        bits -= look >> 8;
        return look & 255;
      }
      code = get(9);
      l = 9;
    } else {
      code = get(1);
      l = 1;
    }
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;  // corrupt data: libjpeg fakes a zero
    return t.vals[code + t.valoffset[l]];
  }
};

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

// jdarith.c's arith_decode (T.81 D.2 with Markus Kuhn's floating cut between
// the interval base and the bit buffer in C): a marker, or the end of the
// data, stops the byte input, and zeros are decoded on from there
struct ArithReader {
  const uint8_t* data;
  size_t n, pos;
  int marker = 0;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to fetch; -1: an error stops the scan's decoding

  int byte() { return pos < n ? data[pos++] : 0xD9; }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int d;
        if (marker) {
          d = 0;
        } else {
          d = byte();
          if (d == 0xFF) {
            do d = byte();
            while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;
            } else {
              marker = d;
              d = 0;
            }
          }
        }
        c = (c << 8) | d;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAriTab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct JpegDecoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  HuffTable dc[4], ac[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {};
  std::vector<Component> comps;
  int width = 0, height = 0, max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  bool frame = false, progressive = false, lossless = false, arithmetic = false, jfif = false,
       adobe = false;
  // DAC's conditioning of each arithmetic table (L and U of the DC tables,
  // K of the AC tables), libjpeg's defaults until a DAC segment sets them
  uint8_t arith_l[16] = {}, arith_u[16], arith_k[16];
  int precision = 8;
  int color_mode = 0;  // 0: as cv2 (BGR), 1: YCbCr -> RGB, 2: the components as stored
  int adobe_transform = -1;
  int restart_interval = 0;
  int scans = 0;
  bool single_scan = false;  // the first scan held every component: nothing after it is read

  JpegDecoder(const uint8_t* d, size_t len) : data(d), n(len) {
    std::memset(arith_u, 1, sizeof(arith_u));
    std::memset(arith_k, 5, sizeof(arith_k));
  }

  int byte() {
    if (pos >= n) fail(CORRUPT, "JPEG data ends inside a marker segment");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  // libjpeg's next_marker: skip to an FF, swallow fill FFs, skip FF00
  int next_marker(size_t& p) const {
    for (;;) {
      while (p < n && data[p] != 0xFF) p++;
      if (p >= n) return 0xD9;
      while (p < n && data[p] == 0xFF) p++;
      if (p >= n) return 0xD9;
      int c = data[p++];
      if (c != 0) return c;
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq = byte(), t = pq & 15, prec = pq >> 4;
      if (t > 3) fail(CORRUPT, "bad quantisation table index");
      for (int i = 0; i < 64; i++) qt[t][kNatural[i]] = (uint16_t)(prec ? word() : byte());
      qt_defined[t] = true;
    }
    if (pos != end) fail(CORRUPT, "bad DQT length");
  }

  void read_dht(size_t end) {
    while (pos + 17 <= end) {
      int tc = byte(), idx = tc & 15;
      uint8_t bits[17] = {};
      int count = 0;
      for (int l = 1; l <= 16; l++) count += bits[l] = (uint8_t)byte();
      if (count > 256 || pos + count > end) fail(CORRUPT, "bad Huffman table");
      if (idx > 3 || (tc >> 4) > 1) fail(CORRUPT, "bad Huffman table index");
      HuffTable& t = (tc >> 4) ? ac[idx] : dc[idx];
      std::memcpy(t.bits, bits, 17);
      std::memset(t.vals, 0, 256);
      for (int i = 0; i < count; i++) t.vals[i] = (uint8_t)byte();
      t.defined = true;
    }
    if (pos != end) fail(CORRUPT, "bad DHT length");
  }

  void read_sof(int marker, size_t end) {
    if (frame) fail(CORRUPT, "a second SOF marker");
    precision = byte();
    height = word();
    width = word();
    int nc = byte();
    if (end - pos != (size_t)nc * 3) fail(CORRUPT, "bad SOF length");
    lossless = marker == 0xC3;
    if (lossless && (precision < 2 || precision > 16)) fail(CORRUPT, "bad lossless JPEG precision");
    if (lossless && (precision != 8 || color_mode))
      fail(UNSUPPORTED, "lossless JPEG of " + std::to_string(precision) +
                            "-bit samples is not read (cv2.imread gives None)");
    if (!lossless && precision != 8)
      fail(UNSUPPORTED, std::to_string(precision) +
                            "-bit JPEG samples are not read (cv2.imread gives None)");
    if (height <= 0 || width <= 0 || nc <= 0) fail(CORRUPT, "empty JPEG image");
    if (nc != 1 && nc != 3 && nc != 4)
      fail(CORRUPT, "a JPEG file of " + std::to_string(nc) + " components");
    progressive = marker == 0xC2 || marker == 0xCA;
    arithmetic = marker == 0xC9 || marker == 0xCA;
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail(CORRUPT, "bad sampling factors");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto& c : comps) {
      c.dw = (int)(((int64_t)width * c.h + max_h - 1) / max_h);
      c.dh = (int)(((int64_t)height * c.v + max_v - 1) / max_v);
      c.wib = (int)(((int64_t)width * c.h + 8 * max_h - 1) / (8 * max_h));
      c.hib = (int)(((int64_t)height * c.v + 8 * max_v - 1) / (8 * max_v));
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      for (int& b : c.coef_bits) b = -1;
      for (int& b : c.prev_bits) b = 0;
    }
    frame = true;
  }

  // libjpeg's read_restart_marker and jpeg_resync_to_restart over the
  // reader's position and the marker it stopped at
  void read_restart_marker(size_t& pos_, int& marker, int& next_rst) const {
    if (marker == 0) marker = next_marker(pos_);
    if (marker == 0xD0 + next_rst) {
      marker = 0;
    } else {
      for (;;) {
        int m = marker, action;
        if (m < 0xC0) action = 2;
        else if (m < 0xD0 || m > 0xD7) action = 3;
        else if (m == 0xD0 + ((next_rst + 1) & 7) || m == 0xD0 + ((next_rst + 2) & 7)) action = 3;
        else if (m == 0xD0 + ((next_rst - 1) & 7) || m == 0xD0 + ((next_rst - 2) & 7)) action = 2;
        else action = 1;
        if (action == 1) { marker = 0; break; }
        if (action == 3) break;
        marker = next_marker(pos_);
      }
    }
    next_rst = (next_rst + 1) & 7;
  }

  void restart(BitReader& br, int& next_rst) {
    br.bits = 0;
    read_restart_marker(br.pos, br.marker, next_rst);
    if (br.marker == 0) br.insufficient = false;
  }

  void read_sos(size_t end) {
    if (!frame) fail(CORRUPT, "SOS before SOF");
    int ns = byte();
    if (ns < 1 || ns > 4 || end - pos != (size_t)ns * 2 + 3) fail(CORRUPT, "bad SOS length");
    std::vector<Component*> sc;
    std::vector<int> td(ns), ta(ns);
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      Component* c = nullptr;
      for (auto& cc : comps)
        if (cc.id == id) c = &cc;
      if (!c) fail(CORRUPT, "SOS names a component the frame lacks");
      for (auto* o : sc)
        if (o == c) fail(CORRUPT, "SOS names a component twice");
      sc.push_back(c);
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (!arithmetic && (td[i] > 3 || ta[i] > 3)) fail(CORRUPT, "bad Huffman table index");
    }
    int ss = byte(), se = byte(), a = byte(), ah = a >> 4, al = a & 15;
    if (scans == 0 && !progressive && ns == (int)comps.size()) single_scan = true;
    scans++;
    if (lossless) {
      // jdlossls.c's start_pass: Ss the predictor, Al the point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision)
        fail(CORRUPT, "bad lossless scan parameters");
      for (int k = 0; k < 2; k++)
        if (!dc[k].defined)
          set_std(dc[k], k ? kDcChromaBits : kDcLumaBits, k ? kDcChromaVals : kDcLumaVals, 12);
      for (int i = 0; i < ns; i++) {
        if (!dc[td[i]].defined) fail(CORRUPT, "a scan's Huffman table is not defined");
        dc[td[i]].derive(true, 16);
      }
      decode_lossless_scan(sc, td, ss, al);
      return;
    }
    if (arithmetic) {
      if (progressive) {
        bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
        if (bad || (ah != 0 && al != ah - 1) || al > 13) fail(CORRUPT, "bad progressive scan parameters");
        for (auto* c : sc) {
          for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
            c->prev_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
          for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
        }
      }
      for (auto* c : sc)
        if (!c->latched) {
          if (!qt_defined[c->tq]) fail(CORRUPT, "a component's quantisation table is not defined");
          std::memcpy(c->q, qt[c->tq], sizeof(c->q));
          c->latched = true;
        }
      decode_scan_arith(sc, td, ta, ss, se, ah, al);
      return;
    }
    // libjpeg's standard tables for slots 0 and 1 where the file defines none
    for (int k = 0; k < 2; k++) {
      if (!dc[k].defined)
        set_std(dc[k], k ? kDcChromaBits : kDcLumaBits, k ? kDcChromaVals : kDcLumaVals, 12);
      if (!ac[k].defined)
        set_std(ac[k], k ? kAcChromaBits : kAcLumaBits, k ? kAcChromaVals : kAcLumaVals, 162);
    }
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if (bad || (ah != 0 && al != ah - 1) || al > 13) fail(CORRUPT, "bad progressive scan parameters");
      for (auto* c : sc) {
        for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
          c->prev_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
      }
    }
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      if (!c->latched) {
        if (!qt_defined[c->tq]) fail(CORRUPT, "a component's quantisation table is not defined");
        std::memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss != 0;
      if (need_dc) {
        if (!dc[td[i]].defined) fail(CORRUPT, "a scan's Huffman table is not defined");
        dc[td[i]].derive(true);
      }
      if (need_ac) {
        if (!ac[ta[i]].defined) fail(CORRUPT, "a scan's Huffman table is not defined");
        ac[ta[i]].derive(false);
      }
    }
    decode_scan(sc, td, ta, ss, se, ah, al);
  }

  // jddiffct.c's decompress_data over jdlhuff.c's decode_mcus and
  // jdlossls.c's undifferencing (a DCT block is one sample): an MCU row
  // holds v rows of each component, its dummy samples past a component's
  // width decoded and dropped; restarts come every restart_interval /
  // MCUs-per-row MCU rows (an interval that is no multiple is refused); an
  // MCU row begun after the data ran out gets zero differences. A restart,
  // or the data running out, sets the first-row predictor for the next row
  // undifferenced, and libjpeg undifferences once an iMCU row has been
  // decoded: v rows of a single-component scan's MCU rows, so a reset
  // inside them acts on the first
  void decode_lossless_scan(std::vector<Component*>& sc, std::vector<int>& td, int psv, int pt) {
    BitReader br{data, n, pos};
    const int ns = (int)sc.size();
    for (auto* c : sc) {
      c->pt = pt;
      c->latched = true;
      c->plane.assign((size_t)c->dw * c->dh, 0);
    }
    // an interleaved scan's MCU is max_h x max_v samples of the image;
    // a single component's is one of its samples
    const int per_row = ns == 1 ? sc[0]->dw : (width + max_h - 1) / max_h;
    const int mcu_rows = ns == 1 ? sc[0]->dh : (height + max_v - 1) / max_v;
    std::vector<int> bh(ns), bv(ns);
    std::vector<std::vector<int>> diff(ns);
    for (int i = 0; i < ns; i++) {
      bh[i] = ns == 1 ? 1 : sc[i]->h;
      bv[i] = ns == 1 ? 1 : sc[i]->v;
      diff[i].assign((size_t)bv[i] * per_row * bh[i], 0);
    }
    if (restart_interval % per_row)
      fail(CORRUPT, "a lossless restart interval that is not a whole number of MCU rows");
    const int restart_rows = restart_interval / per_row;
    // MCU rows undifferenced together: an iMCU row
    const int group = ns == 1 ? sc[0]->v : 1;
    std::vector<std::vector<int>> rows_diff(group);
    int rows_to_go = restart_rows, next_rst = 0;
    std::vector<bool> first_row(ns, true);
    for (int g0 = 0; g0 < mcu_rows; g0 += group) {
      const int n_rows = std::min(group, mcu_rows - g0);
      for (int k = 0; k < n_rows; k++) {
        if (restart_interval && rows_to_go == 0) {
          restart(br, next_rst);
          first_row.assign(ns, true);
          rows_to_go = restart_rows;
        }
        if (br.insufficient) {
          for (auto& d : diff) std::fill(d.begin(), d.end(), 0);
          first_row.assign(ns, true);
        } else {
          for (int mx = 0; mx < per_row; mx++)
            for (int i = 0; i < ns; i++)
              for (int y = 0; y < bv[i]; y++)
                for (int x = 0; x < bh[i]; x++) {
                  int s = br.decode(dc[td[i]]);
                  if (s == 16) s = 32768;
                  else if (s) s = extend(br.get(s), s);
                  diff[i][(size_t)y * per_row * bh[i] + mx * bh[i] + x] = s;
                }
        }
        if (restart_interval) rows_to_go--;
        if (group > 1) rows_diff[k] = diff[0];
      }
      if (group > 1) {  // one component: its iMCU row's rows
        for (int k = 0; k < n_rows; k++) {
          undifference(*sc[0], g0 + k, rows_diff[k].data(), psv, pt, first_row[0]);
          first_row[0] = false;
        }
        continue;
      }
      for (int i = 0; i < ns; i++)
        for (int y = 0; y < bv[i] && g0 * bv[i] + y < sc[i]->dh; y++) {
          undifference(*sc[i], g0 * bv[i] + y, diff[i].data() + (size_t)y * per_row * bh[i], psv,
                       pt, first_row[i]);
          first_row[i] = false;
        }
    }
    pos = br.pos;
    pending_marker = br.marker ? br.marker : next_marker(pos);
  }

  // jdlossls.c's undifferencing of component row y from its differences d
  void undifference(Component& c, int y, const int* d, int psv, int pt, bool first_row) {
    const int w = c.dw;
    uint16_t* row = c.plane.data() + (size_t)y * w;
    if (first_row) {
      int ra = (d[0] + (1 << (precision - pt - 1))) & 0xFFFF;
      row[0] = (uint16_t)ra;
      for (int x = 1; x < w; x++) row[x] = (uint16_t)(ra = (d[x] + ra) & 0xFFFF);
      return;
    }
    const uint16_t* prev = row - w;
    int rb = prev[0], ra = (d[0] + rb) & 0xFFFF, rc;
    row[0] = (uint16_t)ra;
    for (int x = 1; x < w; x++) {
      rc = rb;
      rb = prev[x];
      int p;
      switch (psv) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      row[x] = (uint16_t)(ra = (d[x] + p) & 0xFFFF);
    }
  }

  // jdarith.c's decode_mcu (sequential), decode_mcu_DC_first, _AC_first,
  // _DC_refine and _AC_refine over the scan's MCUs: each scan starts its
  // statistics bins afresh, as each restart does; a magnitude or spectral
  // overflow stops decoding until the next restart (the blocks left as they
  // are)
  void decode_scan_arith(std::vector<Component*>& sc, std::vector<int>& td, std::vector<int>& ta,
                         int ss, int se, int ah, int al) {
    ArithReader ar{data, n, pos};
    const int ns = (int)sc.size();
    uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin[4] = {113, 0, 0, 0};
    int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
    auto reset = [&]() {
      for (int i = 0; i < ns; i++) {
        if (!progressive || (ss == 0 && ah == 0)) {
          std::memset(dc_stats[td[i]], 0, 64);
          last_dc[i] = dc_context[i] = 0;
        }
        if (!progressive || ss) std::memset(ac_stats[ta[i]], 0, 256);
      }
      ar.c = ar.a = 0;
      ar.ct = -16;
    };
    reset();
    int restarts_to_go = restart_interval, next_rst = 0;
    // Figures F.19-F.24: a DC difference; false on a magnitude overflow
    auto dc_diff = [&](int i) -> bool {
      const int tbl = td[i];
      uint8_t* st = dc_stats[tbl] + dc_context[i];
      if (ar.decode(st) == 0) {
        dc_context[i] = 0;
        return true;
      }
      const int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m) {
        st = dc_stats[tbl] + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          st += 1;
        }
      }
      if (m < (int)((1L << arith_l[tbl]) >> 1)) dc_context[i] = 0;
      else if (m > (int)((1L << arith_u[tbl]) >> 1)) dc_context[i] = 12 + sign * 4;
      else dc_context[i] = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      last_dc[i] = (last_dc[i] + v) & 0xffff;
      return true;
    };
    // an AC coefficient's value after its position k (st at its bins + 2)
    auto ac_value = [&](int tbl, int k, uint8_t* st, int& v) -> bool {
      const int sign = ar.decode(fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          st += 1;
        }
      }
      v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      return true;
    };
    // the AC bins of positions lo..hi: false on a spectral or magnitude overflow
    auto ac_run = [&](int tbl, int lo, int hi, int16_t* blk, int shift) -> bool {
      for (int k = lo; k <= hi; k++) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (ar.decode(st)) break;  // EOB
        while (ar.decode(st + 1) == 0) {
          st += 3;
          if (++k > hi) {
            ar.ct = -1;
            return false;
          }
        }
        int v;
        if (!ac_value(tbl, k, st, v)) return false;
        blk[kNatural[k]] = (int16_t)((unsigned)v << shift);
      }
      return true;
    };
    auto ac_refine = [&](int tbl, int16_t* blk) {
      const int p1 = 1 << al, m1 = -1 * (1 << al);
      int kex = se;
      for (; kex > 0; kex--)
        if (blk[kNatural[kex]]) break;
      for (int k = ss; k <= se; k++) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && ar.decode(st)) break;  // EOB
        for (;;) {
          int16_t* coef = blk + kNatural[k];
          if (*coef) {
            if (ar.decode(st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
            break;
          }
          if (ar.decode(st + 1)) {
            *coef = (int16_t)(ar.decode(fixed_bin) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > se) {
            ar.ct = -1;
            return;
          }
        }
      }
    };
    // one MCU: blocks[j] of scan component comp[j]
    auto do_mcu = [&](int nb, int16_t* const* blocks, const int* comp, int imcu_row) {
      last_good_row = imcu_row;
      if (restart_interval) {
        if (restarts_to_go == 0) {
          read_restart_marker(ar.pos, ar.marker, next_rst);
          reset();
          restarts_to_go = restart_interval;
        }
        restarts_to_go--;
      }
      if (progressive && ss == 0 && ah != 0) {  // DC refinement: the next bit of each DC value
        for (int j = 0; j < nb; j++)
          if (ar.decode(fixed_bin)) blocks[j][0] = (int16_t)(blocks[j][0] | (1 << al));
        return;
      }
      if (ar.ct == -1) return;
      for (int j = 0; j < nb; j++) {
        const int i = comp[j];
        int16_t* blk = blocks[j];
        if (!progressive) {
          if (!dc_diff(i)) return;
          blk[0] = (int16_t)last_dc[i];
          if (!ac_run(ta[i], 1, 63, blk, 0)) return;
        } else if (ss == 0) {
          if (!dc_diff(i)) return;
          blk[0] = (int16_t)((unsigned)last_dc[i] << al);
        } else if (ah == 0) {
          if (!ac_run(ta[i], ss, se, blk, al)) return;
        } else {
          ac_refine(ta[i], blk);
          if (ar.ct == -1) return;
        }
      }
    };
    int16_t* blocks[10];
    int comp[10];
    if (ns == 1) {
      Component* c = sc[0];
      comp[0] = 0;
      for (int by = 0; by < c->hib; by++)
        for (int bx = 0; bx < c->wib; bx++) {
          blocks[0] = c->block(by, bx);
          do_mcu(1, blocks, comp, by / c->v);
        }
    } else {
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++) {
          int nb = 0;
          for (int i = 0; i < ns; i++) {
            Component* c = sc[i];
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++) {
                if (nb == 10) fail(CORRUPT, "an MCU of more than 10 blocks");
                comp[nb] = i;
                blocks[nb++] = c->block(my * c->v + y, mx * c->h + x);
              }
          }
          do_mcu(nb, blocks, comp, my);
        }
    }
    pos = ar.pos;
    pending_marker = ar.marker ? ar.marker : next_marker(pos);
  }

  // DAC: conditioning of the arithmetic tables
  void read_dac(size_t end) {
    while (pos + 2 <= end) {
      int index = byte(), val = byte();
      if (index >= 32) fail(CORRUPT, "bad DAC table index");
      if (index >= 16) {
        arith_k[index - 16] = (uint8_t)val;
      } else {
        arith_l[index] = (uint8_t)(val & 15);
        arith_u[index] = (uint8_t)(val >> 4);
        if (arith_l[index] > arith_u[index]) fail(CORRUPT, "bad DAC value");
      }
    }
    if (pos != end) fail(CORRUPT, "bad DAC length");
  }

  void set_std(HuffTable& t, const uint8_t* bits, const uint8_t* vals, int n) {
    std::memcpy(t.bits, bits, 17);
    std::memset(t.vals, 0, 256);
    std::memcpy(t.vals, vals, n);
    t.defined = true;
  }

  void decode_scan(std::vector<Component*>& sc, std::vector<int>& td, std::vector<int>& ta, int ss,
                   int se, int ah, int al) {
    BitReader br{data, n, pos};
    int ns = (int)sc.size();
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int restarts_to_go = restart_interval, next_rst = 0;
    auto do_block = [&](int ci, int16_t* blk) {
      if (!progressive) {
        const HuffTable& d = dc[td[ci]];
        const HuffTable& a = ac[ta[ci]];
        int s = br.decode(d);
        if (s) s = extend(br.get(s), s);
        s += last_dc[ci];
        last_dc[ci] = s;
        blk[0] = (int16_t)s;
        for (int k = 1; k < 64; k++) {
          int rs = br.decode(a), r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      } else if (ss == 0) {
        if (ah == 0) {
          int s = br.decode(dc[td[ci]]);
          if (s) s = extend(br.get(s), s);
          s += last_dc[ci];
          last_dc[ci] = s;
          blk[0] = (int16_t)((unsigned)s << al);
        } else if (br.get(1)) {
          blk[0] = (int16_t)(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        if (eobrun > 0) {
          eobrun--;
          return;
        }
        const HuffTable& a = ac[ta[ci]];
        for (int k = ss; k <= se; k++) {
          int rs = br.decode(a), r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = (int16_t)((unsigned)extend(br.get(s), s) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            eobrun--;
            break;
          }
        }
      } else {
        int p1 = 1 << al, m1 = -1 * (1 << al);
        int k = ss;
        if (eobrun == 0) {
          const HuffTable& a = ac[ta[ci]];
          for (; k <= se; k++) {
            int rs = br.decode(a), r = rs >> 4, s = rs & 15;
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
                if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
              } else if (--r < 0) {
                break;
              }
              k++;
            } while (k <= se);
            if (s) blk[kNatural[k]] = (int16_t)s;
          }
        }
        if (eobrun > 0) {
          for (; k <= se; k++) {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
              *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
          }
          eobrun--;
        }
      }
    };
    auto mcu_start = [&](int imcu_row) {
      if (!br.insufficient) last_good_row = imcu_row;
      if (restart_interval) {
        if (restarts_to_go == 0) {
          restart(br, next_rst);
          for (int& d : last_dc) d = 0;
          eobrun = 0;
          restarts_to_go = restart_interval;
        }
        restarts_to_go--;
      }
      return !br.insufficient;
    };
    if (ns == 1) {
      Component* c = sc[0];
      for (int by = 0; by < c->hib; by++)
        for (int bx = 0; bx < c->wib; bx++)
          if (mcu_start(by / c->v)) do_block(0, c->block(by, bx));
    } else {
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++) {
          if (!mcu_start(my)) continue;
          for (int ci = 0; ci < ns; ci++) {
            Component* c = sc[ci];
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++) do_block(ci, c->block(my * c->v + y, mx * c->h + x));
          }
        }
    }
    // the next marker: the one that stopped the reader, else the first after it
    if (br.marker) {
      pos = br.pos;
      pending_marker = br.marker;
    } else {
      pos = br.pos;
      pending_marker = next_marker(pos);
    }
  }

  int pending_marker = 0;
  int last_good_row = 0;  // the iMCU row of the last MCU begun before the data ran out

  void parse() {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail(CORRUPT, "not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      int m;
      if (pending_marker) {
        m = pending_marker;
        pending_marker = 0;
      } else {
        m = next_marker(pos);
      }
      if (m == 0xD9) break;
      if (m == 0xD8) fail(CORRUPT, "a second SOI marker");
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (m == 0x01) continue;  // TEM
      size_t seg = pos;
      int len = word();
      if (len < 2) fail(CORRUPT, "bad marker length");
      size_t end = seg + len;
      if (end > n) fail(CORRUPT, "JPEG data ends inside a marker segment");
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          read_sof(m, end);
          break;
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
          fail(UNSUPPORTED, "hierarchical JPEG is not read (cv2.imread gives None)");
        case 0xCB:
          fail(UNSUPPORTED, "arithmetic-coded lossless JPEG is not read (cv2.imread gives None)");
        case 0xCC:
          read_dac(end);
          break;
        case 0xC4:
          read_dht(end);
          break;
        case 0xDB:
          read_dqt(end);
          break;
        case 0xDD:
          if (len != 4) fail(CORRUPT, "bad DRI length");
          restart_interval = word();
          break;
        case 0xDA:
          read_sos(end);
          // after a single-scan file's scan libjpeg reads markers only in
          // jpeg_finish_decompress, whose errors OpenCV ignores: the image
          // is whole whatever follows
          if (single_scan) return;
          continue;  // decode_scan left pos and the next marker
        case 0xE0:
          if (len >= 16 && !std::memcmp(data + seg + 2, "JFIF\0", 5)) jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && !std::memcmp(data + seg + 2, "Adobe", 5)) {
            adobe = true;
            adobe_transform = data[seg + 13];
          }
          break;
        case 0xDC: case 0xDE: case 0xDF:
        case 0xFE:
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) break;
          fail(CORRUPT, "unknown JPEG marker");
      }
      pos = end;
    }
    if (!frame || scans == 0) fail(CORRUPT, "a JPEG file without an image");
  }

  bool rgb_colorspace() const {
    if (comps.size() != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  }

  // libjpeg's smoothing_ok: a progressive file whose low AC coefficients
  // are not all known (cut before its last scan) is block-smoothed
  bool smoothing() const {
    if (!progressive) return false;
    bool useful = false;
    for (const auto& c : comps) {
      if (!c.latched || c.coef_bits[0] < 0) return false;
      for (int k : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.q[k] == 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // libjpeg-turbo's decompress_smooth_data for one block: the first nine AC
  // coefficients that are still zero and not known exactly are estimated
  // from the DC values d[1..25] of the 5x5 blocks around it (with DC
  // interpolation where no AC coefficient is known at all)
  static void smooth_block(int16_t* ws, const uint16_t* q, const int* bits, bool change_dc,
                           const int* d) {
    const int64_t q00 = q[0];
    auto estimate = [&](int pos, int al, int64_t weights) {
      if (al == 0 || ws[pos] != 0) return;
      const int64_t num = q00 * weights, qq = q[pos];
      int pred;
      if (num >= 0) {
        pred = (int)(((qq << 7) + num) / (qq << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = (int)(((qq << 7) - num) / (qq << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      ws[pos] = (int16_t)pred;
    };
    estimate(1, bits[1], change_dc ? -d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] +
                                         3 * d[10] - 3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15] -
                                         3 * d[16] + 13 * d[17] - 13 * d[19] + 3 * d[20] - d[21] -
                                         d[22] + d[24] + d[25]
                                   : -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]);
    estimate(8, bits[2], change_dc ? -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7] +
                                         38 * d[8] + 13 * d[9] - d[10] + d[16] - 13 * d[17] -
                                         38 * d[18] - 13 * d[19] + d[20] + d[21] + 3 * d[22] +
                                         3 * d[23] + 3 * d[24] + d[25]
                                   : -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]);
    estimate(16, bits[3], change_dc ? d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13] -
                                          5 * d[14] + 2 * d[17] + 7 * d[18] + 2 * d[19] + d[23]
                                    : -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]);
    estimate(9, bits[4], change_dc ? -d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] +
                                         d[21] - d[25]
                                   : d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] -
                                         d[24] + d[4] - d[6] + 10 * d[7] - 10 * d[9]);
    estimate(2, bits[5], change_dc ? 2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13] +
                                         7 * d[14] + d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19]
                                   : -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]);
    if (!change_dc) return;
    estimate(3, bits[6], d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]);
    estimate(10, bits[7], d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]);
    estimate(17, bits[8], d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]);
    estimate(24, bits[9], d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]);
    const int64_t num = q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] +
                               6 * d[7] + 42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] +
                               152 * d[13] + 42 * d[14] - 8 * d[15] - 6 * d[16] + 6 * d[17] +
                               42 * d[18] + 6 * d[19] - 6 * d[20] - 2 * d[21] - 6 * d[22] -
                               8 * d[23] - 6 * d[24] - 2 * d[25]);
    ws[0] = (int16_t)(num >= 0 ? ((q00 << 7) + num) / (q00 << 8) : -(((q00 << 7) - num) / (q00 << 8)));
  }

  static int32_t wrap16(int32_t v) { return (int16_t)v; }
  static int32_t sat16(int32_t v) { return v < -32768 ? -32768 : (v > 32767 ? 32767 : v); }

  // one 1-D pass of jpeg_idct_islow over d[0], d[kStep], ..., d[7 kStep]
  // into o[0], o[kOStep], ..., descaled by kShift, in the SIMD version's
  // arithmetic (see idct)
  template <int kStep, int kOStep, int kShift, typename T>
  static inline void idct_pass(const T* d, int32_t* o) {
    const int32_t d0 = d[0], d1 = d[kStep], d2 = d[2 * kStep], d3 = d[3 * kStep],
                  d4 = d[4 * kStep], d5 = d[5 * kStep], d6 = d[6 * kStep], d7 = d[7 * kStep];
    const int32_t tmp3e = d2 * (C0541 + C0765) + d6 * C0541;
    const int32_t tmp2e = d2 * C0541 + d6 * (C0541 - C1847);
    const int32_t tmp0e = wrap16(d0 + d4) * (1 << kConstBits);
    const int32_t tmp1e = wrap16(d0 - d4) * (1 << kConstBits);
    const int32_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e, tmp11 = tmp1e + tmp2e,
                  tmp12 = tmp1e - tmp2e;
    const int32_t z3 = wrap16(d3 + d7), z4 = wrap16(d1 + d5);
    const int32_t z3o = z3 * (C1175 - C1961) + z4 * C1175;
    const int32_t z4o = z3 * C1175 + z4 * (C1175 - C0390);
    const int32_t tmp0 = d7 * (C0298 - C0899) - d1 * C0899 + z3o;
    const int32_t tmp3 = -d7 * C0899 + d1 * (C1501 - C0899) + z4o;
    const int32_t tmp1 = d5 * (C2053 - C2562) - d3 * C2562 + z4o;
    const int32_t tmp2 = -d5 * C2562 + d3 * (C3072 - C2562) + z3o;
    o[0] = sat16(descale(tmp10 + tmp3, kShift));
    o[7 * kOStep] = sat16(descale(tmp10 - tmp3, kShift));
    o[kOStep] = sat16(descale(tmp11 + tmp2, kShift));
    o[6 * kOStep] = sat16(descale(tmp11 - tmp2, kShift));
    o[2 * kOStep] = sat16(descale(tmp12 + tmp1, kShift));
    o[5 * kOStep] = sat16(descale(tmp12 - tmp1, kShift));
    o[3 * kOStep] = sat16(descale(tmp13 + tmp0, kShift));
    o[4 * kOStep] = sat16(descale(tmp13 - tmp0, kShift));
  }

  // jpeg_idct_islow of one block into 8 rows of out (stride), with the
  // arithmetic of libjpeg-turbo's SIMD version, which OpenCV's build runs:
  // 16-bit lanes that wrap in the dequantisation and in the sums feeding
  // the products, and saturate between the passes and at the end. On valid
  // data this is the C version exactly; on garbage coefficients (a cut file
  // padded with zero bits) it gives what cv2 gives.
  static void idct(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int16_t dq[64], ac[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    int32_t ws[64];
    for (int i = 0; i < 64; i++) dq[i] = (int16_t)(in[i] * (int16_t)q[i]);
    for (int k = 1; k < 8; k++)
      for (int c = 0; c < 8; c++) ac[c] |= in[8 * k + c];
    const bool any_ac = (ac[0] | ac[1] | ac[2] | ac[3] | ac[4] | ac[5] | ac[6] | ac[7]) != 0;
    for (int c = 0; c < 8; c++) {
      if (ac[c]) {
        idct_pass<8, 8, kConstBits - kPass1Bits>(dq + c, ws + c);
        continue;
      }
      // the whole-block shortcut shifts in 16 bits; a full pass saturates
      const int32_t dc = any_ac ? sat16(dq[c] * (1 << kPass1Bits)) : wrap16(dq[c] * (1 << kPass1Bits));
      for (int k = 0; k < 8; k++) ws[8 * k + c] = dc;
    }
    for (int r = 0; r < 8; r++) {
      const int32_t* w = ws + 8 * r;
      uint8_t* o = out + (size_t)r * stride;
      if ((w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7]) == 0) {
        // what the full pass gives for a row without AC terms
        std::memset(o, clamp255(descale(w[0], kPass1Bits + 3) + 128), 8);
        continue;
      }
      int32_t v[8];
      idct_pass<1, 1, kConstBits + kPass1Bits + 3>(w, v);
      for (int k = 0; k < 8; k++) o[k] = clamp255(v[k] + 128);
    }
  }


  // one component's samples at its own resolution, (wib * 8) x (hib * 8)
  std::vector<uint8_t> samples(Component& c, bool smooth) const {
    const int pw = c.wib * 8;
    std::vector<uint8_t> s((size_t)pw * c.hib * 8);
    if (!smooth) {
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++)
          idct(c.block(by, bx), c.q, s.data() + (size_t)by * 8 * pw + bx * 8, pw);
      return s;
    }
    // libjpeg's rows and columns of neighbours, row by iMCU row: past the
    // last row begun before the data ran out, the status before the last scan
    const int rows_total = mcus_y;
    int prev[10];
    prev[0] = c.coef_bits[0];
    for (int k = 1; k < 10; k++) prev[k] = scans > 1 ? c.prev_bits[k] : -1;
    for (int m = 0; m < rows_total; m++) {
      const int block_rows = m < rows_total - 1 ? c.v : (c.hib % c.v ? c.hib % c.v : c.v);
      const int* bits = m > last_good_row ? prev : c.coef_bits;
      bool change_dc = true;
      for (int k = 1; k < 10; k++) change_dc &= bits[k] == -1;
      for (int j = 0; j < block_rows; j++) {
        const int r = m * c.v + j, ib = m * block_rows + j, ibs = block_rows * rows_total;
        const int r1 = ib > 0 ? r - 1 : r, r2 = ib > 1 ? r - 2 : r1;
        const int n1 = ib < ibs - 1 ? r + 1 : r, n2 = ib < ibs - 2 ? r + 2 : n1;
        const int rows[5] = {r2, r1, r, n1, n2};
        for (int bx = 0; bx < c.wib; bx++) {
          int d[26];
          for (int a = 0; a < 5; a++)
            for (int b = 0; b < 5; b++)
              d[1 + 5 * a + b] = c.block(rows[a], std::min(std::max(bx + b - 2, 0), c.wib - 1))[0];
          int16_t ws[64];
          std::memcpy(ws, c.block(r, bx), sizeof(ws));
          smooth_block(ws, c.q, bits, change_dc, d);
          idct(ws, c.q, s.data() + (size_t)r * 8 * pw + bx * 8, pw);
        }
      }
    }
    return s;
  }

  // row y of component c at the image's resolution, from its samples s as
  // libjpeg upsamples them (into buf, or s itself for a full-size one); the
  // rows above the first and below the last repeat them
  const uint8_t* row_of(const Component& c, const uint8_t* s, int y, uint8_t* buf) const {
    const int pw = c.wib * 8, hx = max_h / c.h, vy = max_v / c.v, r = y / vy;
    if (hx == 1 && vy == 1) return s + (size_t)y * pw;
    if (lossless) {  // libjpeg upsamples a lossless frame by replication only
      const uint8_t* in = s + (size_t)r * pw;
      for (int x = 0; x < width; x++) buf[x] = in[x / hx];
      return buf;
    }
    auto row = [&](int k) { return s + (size_t)std::min(std::max(k, 0), c.dh - 1) * pw; };
    const int last = c.dw - 1;
    if (hx == 2 && vy == 1 && c.dw > 2) {
      const uint8_t* in = row(r);
      buf[0] = in[0];
      buf[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < last; x++) {
        int v3 = in[x] * 3;
        buf[2 * x] = (uint8_t)((v3 + in[x - 1] + 1) >> 2);
        buf[2 * x + 1] = (uint8_t)((v3 + in[x + 1] + 2) >> 2);
      }
      buf[2 * last] = (uint8_t)((in[last] * 3 + in[last - 1] + 1) >> 2);
      buf[2 * last + 1] = in[last];
    } else if (hx == 1 && vy == 2) {
      const uint8_t *near = row(r), *far = row(y & 1 ? r + 1 : r - 1);
      const int bias = y & 1 ? 2 : 1;
      for (int x = 0; x < c.dw; x++) buf[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
    } else if (hx == 2 && vy == 2 && c.dw > 2) {
      const uint8_t *near = row(r), *far = row(y & 1 ? r + 1 : r - 1);
      int thiscol = near[0] * 3 + far[0], nextcol = near[1] * 3 + far[1], lastcol;
      buf[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
      buf[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 1; x < last; x++) {
        nextcol = near[x + 1] * 3 + far[x + 1];
        buf[2 * x] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        buf[2 * x + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      buf[2 * last] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      buf[2 * last + 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
    } else {
      // other integral factors, and rows of one or two samples: replicated
      const uint8_t* in = s + (size_t)r * pw;
      for (int x = 0; x < width; x++) buf[x] = in[x / hx];
    }
    return buf;
  }

  // a lossless component's samples as libjpeg's scaler gives them (shifted
  // back by the point transform, cast to 8 bits), (wib * 8) x dh
  static std::vector<uint8_t> lossless_samples(const Component& c) {
    const int pw = c.wib * 8;
    std::vector<uint8_t> s((size_t)pw * c.dh);
    for (int y = 0; y < c.dh; y++)
      for (int x = 0; x < c.dw; x++)
        s[(size_t)y * pw + x] = (uint8_t)(c.plane[(size_t)y * c.dw + x] << c.pt);
    return s;
  }

  // libjpeg's colour space of a lossless frame (default_decompress_parms);
  // it converts none in lossless mode, so cv2 reads only RGB and CMYK
  void check_lossless_colors() const {
    const size_t nc = comps.size();
    bool ok;
    if (nc == 3)
      ok = !jfif && (!adobe || adobe_transform == 0);
    else if (nc == 4)
      ok = !(adobe && adobe_transform == 2);
    else
      ok = false;
    if (!ok)
      fail(UNSUPPORTED, std::string("a lossless JPEG whose colour space libjpeg takes as ") +
                            (nc == 1 ? "grey" : nc == 3 ? "YCbCr" : "YCCK") +
                            " is not read (cv2.imread gives None: libjpeg converts no colours "
                            "in lossless mode)");
    for (const auto& c : comps)
      if (!c.latched) fail(CORRUPT, "a component of a lossless JPEG that no scan holds");
  }

  // out: (h, w, 3) BGR as cv2 (color_mode 0), (h, w, 3) RGB from YCbCr
  // (1) or (h, w, components) as stored (2)
  void output(uint8_t* out) {
    const bool smooth = !lossless && smoothing();
    const size_t nc = comps.size();
    if (lossless) check_lossless_colors();
    if (color_mode == 1 && nc != 3) fail(CORRUPT, "a YCbCr JPEG of " + std::to_string(nc) + " components");
    std::vector<std::vector<uint8_t>> s(nc), buf(nc);
    for (size_t i = 0; i < nc; i++) {
      Component& c = comps[i];
      if (!c.latched) {
        // a component no scan named: libjpeg's coefficients stay zero
        if (!qt_defined[c.tq]) fail(CORRUPT, "a component's quantisation table is not defined");
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
      }
      if (max_h % c.h || max_v % c.v) fail(UNSUPPORTED, "fractional sampling factors are not supported");
      s[i] = lossless ? lossless_samples(c) : samples(c, smooth);
      buf[i].resize((size_t)std::max(c.dw * (max_h / c.h), width));
    }
    if (color_mode == 2) {
      for (int y = 0; y < height; y++)
        for (size_t i = 0; i < nc; i++) {
          const uint8_t* r = row_of(comps[i], s[i].data(), y, buf[i].data());
          uint8_t* o = out + (size_t)y * width * nc + i;
          for (int x = 0; x < width; x++) o[x * nc] = r[x];
        }
      return;
    }
    if (nc == 1) {
      for (int y = 0; y < height; y++) {
        const uint8_t* g = row_of(comps[0], s[0].data(), y, buf[0].data());
        uint8_t* o = out + (size_t)y * width * 3;
        for (int x = 0; x < width; x++, o += 3) o[0] = o[1] = o[2] = g[x];
      }
      return;
    }
    const bool rgb = color_mode == 1 ? false : lossless || rgb_colorspace();
    // four components are CMYK, or YCCK where an Adobe marker's transform is
    // not 0 (libjpeg's default_decompress_parms)
    const bool ycck = nc == 4 && adobe && adobe_transform != 0;
    const int kScale = 16, kHalf = 1 << 15;
    auto fix = [](double v) { return (int32_t)(v * 65536 + 0.5); };
    int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int x = i - 128;
      cr_r[i] = (fix(1.40200) * x + kHalf) >> kScale;
      cb_b[i] = (fix(1.77200) * x + kHalf) >> kScale;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    for (int y = 0; y < height; y++) {
      const uint8_t* p0 = row_of(comps[0], s[0].data(), y, buf[0].data());
      const uint8_t* p1 = row_of(comps[1], s[1].data(), y, buf[1].data());
      const uint8_t* p2 = row_of(comps[2], s[2].data(), y, buf[2].data());
      uint8_t* o = out + (size_t)y * width * 3;
      if (nc == 4) {
        // libjpeg's CMYK output (ycck_cmyk_convert for YCCK), then OpenCV's
        // icvCvt_CMYK2BGR_8u_C4C3R, which reads the values as Adobe's
        // inverted CMYK
        const uint8_t* p3 = row_of(comps[3], s[3].data(), y, buf[3].data());
        for (int x = 0; x < width; x++, o += 3) {
          int c = p0[x], m = p1[x], ye = p2[x];
          if (ycck) {
            const int yy = p0[x], cb = p1[x], cr = p2[x];
            c = clamp255(255 - (yy + cr_r[cr]));
            m = clamp255(255 - (yy + ((cb_g[cb] + cr_g[cr]) >> kScale)));
            ye = clamp255(255 - (yy + cb_b[cb]));
          }
          const int k = p3[x];
          o[2] = (uint8_t)(k - ((255 - c) * k >> 8));
          o[1] = (uint8_t)(k - ((255 - m) * k >> 8));
          o[0] = (uint8_t)(k - ((255 - ye) * k >> 8));
        }
        continue;
      }
      if (rgb) {
        for (int x = 0; x < width; x++, o += 3) {
          o[0] = p2[x];
          o[1] = p1[x];
          o[2] = p0[x];
        }
        continue;
      }
      const int bi = color_mode == 1 ? 2 : 0, ri = 2 - bi;
      for (int x = 0; x < width; x++, o += 3) {
        int yy = p0[x], cb = p1[x], cr = p2[x];
        o[bi] = clamp255(yy + cb_b[cb]);
        o[1] = clamp255(yy + ((cb_g[cb] + cr_g[cr]) >> kScale));
        o[ri] = clamp255(yy + cr_r[cr]);
      }
    }
  }
};

// ---- JPEG encoding -------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    if (size == 0) return;
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t c = (uint8_t)(acc >> (nbits - 8));
      out.push_back(c);
      if (c == 0xFF) out.push_back(0);
      nbits -= 8;
    }
    acc &= (1u << nbits) - 1;
  }
};

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
  HuffEnc(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        code[vals[p]] = (uint16_t)c++;
        size[vals[p]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; pass++) {
    for (int i = 0; i < 8; i++) {
      int32_t* p = pass == 0 ? d + 8 * i : d + i;
      int st = pass == 0 ? 1 : 8;
      int32_t d0 = p[0], d1 = p[st], d2 = p[2 * st], d3 = p[3 * st], d4 = p[4 * st],
              d5 = p[5 * st], d6 = p[6 * st], d7 = p[7 * st];
      int32_t tmp0 = d0 + d7, tmp7 = d0 - d7, tmp1 = d1 + d6, tmp6 = d1 - d6;
      int32_t tmp2 = d2 + d5, tmp5 = d2 - d5, tmp3 = d3 + d4, tmp4 = d3 - d4;
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int shift;
      if (pass == 0) {
        p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        p[4 * st] = (tmp10 - tmp11) * (1 << kPass1Bits);
        shift = kConstBits - kPass1Bits;
      } else {
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[4 * st] = descale(tmp10 - tmp11, kPass1Bits);
        shift = kConstBits + kPass1Bits;
      }
      int32_t z1 = (tmp12 + tmp13) * C0541;
      p[2 * st] = descale(z1 + tmp13 * C0765, shift);
      p[6 * st] = descale(z1 - tmp12 * C1847, shift);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * C1175;
      tmp4 *= C0298;
      tmp5 *= C2053;
      tmp6 *= C3072;
      tmp7 *= C1501;
      z1 *= -C0899;
      z2 *= -C2562;
      z3 = z3 * -C1961 + z5;
      z4 = z4 * -C0390 + z5;
      p[7 * st] = descale(tmp4 + z1 + z3, shift);
      p[5 * st] = descale(tmp5 + z2 + z4, shift);
      p[3 * st] = descale(tmp6 + z2 + z3, shift);
      p[1 * st] = descale(tmp7 + z1 + z4, shift);
    }
  }
}

// jcdctmgr.c's compute_reciprocal for 16-bit DCT elements
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = 0;
  for (uint32_t v = divisor; v > 1; v >>= 1) b++;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor), fr = (uint32_t)((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r - 16};
}

inline int16_t quantize(int32_t temp, const Divisor& d) {
  bool neg = temp < 0;
  uint32_t t = (uint32_t)(neg ? -temp : temp) & 0xFFFF;
  uint32_t product = ((t + d.corr) & 0xFFFF) * d.recip;
  int32_t q = (int32_t)(uint16_t)(product >> (d.shift + 16));
  return (int16_t)(neg ? -q : q);
}

void quant_table(const int* base, int quality, uint16_t* out) {
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    out[i] = (uint16_t)std::min(std::max(t, 1L), 255L);
  }
}

void marker(std::vector<uint8_t>& o, int m, int len) {
  o.push_back(0xFF);
  o.push_back((uint8_t)m);
  o.push_back((uint8_t)(len >> 8));
  o.push_back((uint8_t)len);
}

void emit_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits, const uint8_t* vals) {
  int count = 0;
  for (int l = 1; l <= 16; l++) count += bits[l];
  marker(o, 0xC4, count + 2 + 1 + 16);
  o.push_back((uint8_t)index);
  for (int l = 1; l <= 16; l++) o.push_back(bits[l]);
  for (int i = 0; i < count; i++) o.push_back(vals[i]);
}

std::vector<uint8_t> encode_jpeg(const uint8_t* im, int w, int h, int channels, int quality) {
  const int nc = channels == 1 ? 1 : 3;
  std::vector<uint8_t> planes[3];
  for (int c = 0; c < nc; c++) planes[c].resize((size_t)w * h);
  if (nc == 1) {
    std::memcpy(planes[0].data(), im, (size_t)w * h);
  } else {
    auto fix = [](double v) { return (int32_t)(v * 65536 + 0.5); };
    const int32_t half = 1 << 15, off = 128 << 16;
    for (size_t i = 0; i < (size_t)w * h; i++) {
      int32_t b = im[3 * i], g = im[3 * i + 1], r = im[3 * i + 2];
      planes[0][i] = (uint8_t)((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16);
      planes[1][i] = (uint8_t)((-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16);
      planes[2][i] = (uint8_t)((fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16);
    }
  }
  uint16_t q[2][64];
  quant_table(kLumaQ, quality, q[0]);
  quant_table(kChromaQ, quality, q[1]);
  const int hs = nc == 1 ? 1 : 2;  // luma sampling factor (4:2:0)
  const int mcus_x = (w + 8 * hs - 1) / (8 * hs), mcus_y = (h + 8 * hs - 1) / (8 * hs);
  const int ywib = (w + 7) / 8, yhib = (h + 7) / 8;
  const int ch = (h + 1) / 2;
  // 4:2:0 chroma planes, downsampled over edges replicated to whole MCUs
  std::vector<uint8_t> down[2];
  const int dpw = mcus_x * 8, dph = mcus_y * 8;
  if (nc == 3)
    for (int c = 0; c < 2; c++) {
      down[c].resize((size_t)dpw * dph);
      const uint8_t* p = planes[c + 1].data();
      for (int y = 0; y < dph; y++) {
        int yy = std::min(y, ch - 1);
        int r0 = std::min(2 * yy, h - 1), r1 = std::min(2 * yy + 1, h - 1);
        for (int x = 0; x < dpw; x++) {
          int c0 = std::min(2 * x, w - 1), c1 = std::min(2 * x + 1, w - 1);
          int s = p[(size_t)r0 * w + c0] + p[(size_t)r0 * w + c1] + p[(size_t)r1 * w + c0] +
                  p[(size_t)r1 * w + c1];
          down[c][(size_t)y * dpw + x] = (uint8_t)((s + 1 + (x & 1)) >> 2);
        }
      }
    }
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal((uint16_t)(q[t][i] << 3));
  auto code_block = [&](const uint8_t* p, int pw, int ph, int bx, int by, int t, int16_t* out) {
    int32_t d[64];
    for (int r = 0; r < 8; r++) {
      int y = std::min(by * 8 + r, ph - 1);
      for (int c = 0; c < 8; c++) d[8 * r + c] = p[(size_t)y * pw + std::min(bx * 8 + c, pw - 1)] - 128;
    }
    fdct_islow(d);
    for (int i = 0; i < 64; i++) out[i] = quantize(d[i], div[t][i]);
  };

  std::vector<uint8_t> o;
  o.reserve((size_t)w * h + 1024);
  o.push_back(0xFF);
  o.push_back(0xD8);
  static const uint8_t jfif[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), jfif, jfif + sizeof(jfif));
  for (int t = 0; t < (nc == 1 ? 1 : 2); t++) {
    marker(o, 0xDB, 64 + 1 + 2);
    o.push_back((uint8_t)t);
    for (int i = 0; i < 64; i++) o.push_back((uint8_t)q[t][kNatural[i]]);
  }
  marker(o, 0xC0, 3 * nc + 2 + 5 + 1);
  o.push_back(8);
  o.push_back((uint8_t)(h >> 8));
  o.push_back((uint8_t)h);
  o.push_back((uint8_t)(w >> 8));
  o.push_back((uint8_t)w);
  o.push_back((uint8_t)nc);
  for (int c = 0; c < nc; c++) {
    o.push_back((uint8_t)(c + 1));
    o.push_back(c == 0 ? (uint8_t)((hs << 4) | hs) : 0x11);
    o.push_back(c == 0 ? 0 : 1);
  }
  emit_dht(o, 0x00, kDcLumaBits, kDcLumaVals);
  emit_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    emit_dht(o, 0x01, kDcChromaBits, kDcChromaVals);
    emit_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  }
  marker(o, 0xDA, 2 * nc + 2 + 1 + 3);
  o.push_back((uint8_t)nc);
  for (int c = 0; c < nc; c++) {
    o.push_back((uint8_t)(c + 1));
    o.push_back(c == 0 ? 0x00 : 0x11);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  static const HuffEnc dcl(kDcLumaBits, kDcLumaVals), acl(kAcLumaBits, kAcLumaVals);
  static const HuffEnc dcc(kDcChromaBits, kDcChromaVals), acc(kAcChromaBits, kAcChromaVals);
  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  auto encode_block = [&](const int16_t* blk, int ci) {
    const HuffEnc& dc = ci ? dcc : dcl;
    const HuffEnc& ac = ci ? acc : acl;
    int temp = blk[0] - last_dc[ci], temp2 = temp;
    last_dc[ci] = blk[0];
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = 0;
    while (temp) {
      nbits++;
      temp >>= 1;
    }
    bw.put(dc.code[nbits], dc.size[nbits]);
    bw.put((uint32_t)temp2, nbits);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      temp = blk[kNatural[k]];
      if (temp == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        bw.put(ac.code[0xF0], ac.size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nbits = 1;
      while ((temp >>= 1)) nbits++;
      int i = (r << 4) + nbits;
      bw.put(ac.code[i], ac.size[i]);
      bw.put((uint32_t)temp2, nbits);
      r = 0;
    }
    if (r > 0) bw.put(ac.code[0], ac.size[0]);
  };

  int16_t blk[4][64], cblk[64];
  if (nc == 1) {
    for (int by = 0; by < yhib; by++)
      for (int bx = 0; bx < ywib; bx++) {
        code_block(planes[0].data(), w, h, bx, by, 0, blk[0]);
        encode_block(blk[0], 0);
      }
  } else {
    for (int my = 0; my < mcus_y; my++)
      for (int mx = 0; mx < mcus_x; mx++) {
        for (int y = 0; y < 2; y++)
          for (int x = 0; x < 2; x++) {
            int16_t* b = blk[2 * y + x];
            int bx = 2 * mx + x, by = 2 * my + y;
            if (by >= yhib) {
              // a dummy row: zero AC, the DC of the block before it
              std::memset(b, 0, sizeof(int16_t) * 64);
              b[0] = blk[2 * y - 1][0];
            } else if (bx >= ywib) {
              std::memset(b, 0, sizeof(int16_t) * 64);
              b[0] = blk[2 * y + x - 1][0];
            } else {
              code_block(planes[0].data(), w, h, bx, by, 0, b);
            }
          }
        for (int k = 0; k < 4; k++) encode_block(blk[k], 0);
        for (int c = 0; c < 2; c++) {
          code_block(down[c].data(), dpw, dph, mx, my, 1, cblk);
          encode_block(cblk, c + 1);
        }
      }
  }
  if (bw.nbits) bw.put(0x7F, 8 - bw.nbits);
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

// ---- PNG pixels ------------------------------------------------------------------

void unfilter(uint8_t* rows, int nrows, int rowbytes, int bpp) {
  std::vector<uint8_t> zero(rowbytes, 0);
  const uint8_t* prev = zero.data();
  for (int r = 0; r < nrows; r++) {
    uint8_t* line = rows + (size_t)r * (rowbytes + 1);
    int f = line[0];
    uint8_t* x = line + 1;
    switch (f) {
      case 0:
        break;
      case 1:
        for (int i = bpp; i < rowbytes; i++) x[i] = (uint8_t)(x[i] + x[i - bpp]);
        break;
      case 2:
        for (int i = 0; i < rowbytes; i++) x[i] = (uint8_t)(x[i] + prev[i]);
        break;
      case 3:
        for (int i = 0; i < rowbytes; i++)
          x[i] = (uint8_t)(x[i] + (((i >= bpp ? x[i - bpp] : 0) + prev[i]) >> 1));
        break;
      case 4:
        for (int i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? x[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
          int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          x[i] = (uint8_t)(x[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
        }
        break;
      default:
        fail(CORRUPT, "bad PNG filter type");
    }
    prev = x;
  }
}

void png_pixels(uint8_t* raw, size_t n, int w, int h, int depth, int ctype, int interlace,
                const uint8_t* palette, int npal, uint8_t* out) {
  int ch = ctype == 0 ? 1 : ctype == 2 ? 3 : ctype == 3 ? 1 : ctype == 4 ? 2 : 4;
  int bitspp = ch * depth, bpp = std::max(1, bitspp / 8);
  uint8_t pal[256][3] = {};
  for (int i = 0; i < std::min(npal, 256); i++) std::memcpy(pal[i], palette + 3 * i, 3);
  int gray_scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  auto sample = [&](const uint8_t* row, int x, int k) -> int {
    if (depth == 8) return row[x * ch + k];
    if (depth == 16) return row[2 * (x * ch + k)];
    int per = 8 / depth, byte = row[x / per], shift = 8 - depth * (x % per + 1);
    return (byte >> shift) & ((1 << depth) - 1);
  };
  auto put = [&](const uint8_t* row, int x, uint8_t* o) {
    if (ctype == 3) {
      int i = sample(row, x, 0);
      o[0] = pal[i][2];
      o[1] = pal[i][1];
      o[2] = pal[i][0];
    } else if (ctype == 0 || ctype == 4) {
      int g = sample(row, x, 0);
      o[0] = o[1] = o[2] = (uint8_t)(depth < 8 ? g * gray_scale : g);
    } else {
      o[0] = (uint8_t)sample(row, x, 2);
      o[1] = (uint8_t)sample(row, x, 1);
      o[2] = (uint8_t)sample(row, x, 0);
    }
  };
  static const int ax0[7] = {0, 4, 0, 2, 0, 1, 0}, ay0[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int adx[7] = {8, 8, 4, 4, 2, 2, 1}, ady[7] = {8, 8, 8, 4, 4, 2, 2};
  size_t at = 0;
  for (int pass = 0; pass < (interlace ? 7 : 1); pass++) {
    int x0 = interlace ? ax0[pass] : 0, y0 = interlace ? ay0[pass] : 0;
    int dx = interlace ? adx[pass] : 1, dy = interlace ? ady[pass] : 1;
    int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0, ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;
    int rowbytes = (int)(((int64_t)pw * bitspp + 7) / 8);
    size_t need = (size_t)ph * (rowbytes + 1);
    if (at + need > n) fail(CORRUPT, "not enough PNG image data");
    unfilter(raw + at, ph, rowbytes, bpp);
    for (int r = 0; r < ph; r++) {
      const uint8_t* row = raw + at + (size_t)r * (rowbytes + 1) + 1;
      int y = y0 + r * dy;
      for (int i = 0; i < pw; i++) put(row, i, out + ((size_t)y * w + x0 + i * dx) * 3);
    }
    at += need;
  }
}

int report(const CodecError& e, char* msg, int msg_len) {
  if (msg && msg_len > 0) std::snprintf(msg, (size_t)msg_len, "%s", e.msg.c_str());
  return e.status;
}

}  // namespace

extern "C" {

// Decode a JPEG held in data[0:n] into out, where (w, h) is the frame's
// size (the caller reads it from the header): mode 0, (h, w, 3) BGR uint8 as
// cv2.imread; 1, (h, w, 3) RGB from YCbCr whatever the markers say; 2,
// (h, w, components) as stored (libtiff's JPEGCOLORMODE_RGB and its
// suppressed colour handling). Returns 0, or 1 where cv2.imread gives None,
// or 2 for a file it does not decode; msg says why.
int ayolo_jpeg_decode(const uint8_t* data, int64_t n, int w, int h, int mode, uint8_t* out,
                      char* msg, int msg_len) {
  try {
    // past its end libjpeg's stdio source reads FF D9 (a fake EOI) again and
    // again, and a segment cut short is parsed with those bytes
    std::vector<uint8_t> padded(data, data + n);
    for (int i = 0; i < 65536 + 4; i += 2) {
      padded.push_back(0xFF);
      padded.push_back(0xD9);
    }
    JpegDecoder d(padded.data(), padded.size());
    d.color_mode = mode;
    d.parse();
    if (d.width != w || d.height != h) fail(CORRUPT, "the frame's size differs from the header's");
    d.output(out);
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(CodecError{CORRUPT, "out of memory"}, msg, msg_len);
  }
}

// Encode (h, w, channels) uint8 (channels 3: BGR, 1: gray) as cv2.imencode('.jpg')
// at quality; the bytes are returned in *out (free with ayolo_free).
int ayolo_jpeg_encode(const uint8_t* im, int w, int h, int channels, int quality, uint8_t** out,
                      int64_t* out_len) {
  try {
    std::vector<uint8_t> o = encode_jpeg(im, w, h, channels, quality);
    *out = (uint8_t*)std::malloc(o.size());
    if (!*out) return CORRUPT;
    std::memcpy(*out, o.data(), o.size());
    *out_len = (int64_t)o.size();
    return OK;
  } catch (...) {
    return CORRUPT;
  }
}

void ayolo_free(uint8_t* p) { std::free(p); }

// Unfilter a PNG's inflated image data (raw[0:n], changed in place) and write
// (h, w, 3) BGR uint8 into out as cv2.imread does. palette: npal RGB triples.
int ayolo_png_pixels(uint8_t* raw, int64_t n, int w, int h, int depth, int ctype, int interlace,
                     const uint8_t* palette, int npal, uint8_t* out, char* msg, int msg_len) {
  try {
    png_pixels(raw, (size_t)n, w, h, depth, ctype, interlace, palette, npal, out);
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msg_len);
  }
}

}  // extern "C"
