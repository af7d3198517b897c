// Host decoder of TIFF's CCITT compressions, equal bit for bit to what
// OpenCV's imread gives through libtiff 4.7 (tif_fax3.c): modified Huffman
// rows byte-aligned (compression 2, "CCITT RLE") or word-aligned (32771,
// RLEW), T.4 with EOLs in 1D or, where T4Options bit 0 is set, mixed 1D/2D
// rows (3, fill bits before an EOL skipped as libtiff skips them), and T.6
// (4). The bit accumulator, the lookup tables (indexed by bit-reversed
// codes: 12 bits for white runs, 13 for black, 7 for the 2D modes, an EOL
// matched on its eleven zeros), the zero bits read past the end of the data
// and the clean-up of a row that decodes to the wrong length follow
// libtiff's macros (tif_fax3.h), so a cut or damaged strip gives the rows
// libtiff gives: a bad code ends its row, which is padded out, and decoding
// goes on; the data running out ends the strip, its last row padded and the
// rows after it left zero. FillOrder is read here, as libtiff's Fax3 state
// reads it (its rows are never bit-reversed before decoding). The output
// rows are 1 bit a pixel, MSB first, 1 for the black runs; the caller turns
// them into BGR by the photometric.
//
// Plain C interface for ctypes; the tables are built once, read only after.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum State : uint8_t { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
                       S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

struct TabEnt {
  uint8_t state = S_Null;
  uint8_t width = 0;
  uint32_t param = 0;
};

struct Proto {
  uint16_t code;  // MSB first
  uint8_t len;
  uint16_t param;
};

// ITU-T T.4 tables 2 and 3: terminating codes (runs 0-63) and make-up codes
const Proto kTermW[] = {
    {0x35, 8, 0},   {0x07, 6, 1},   {0x07, 4, 2},   {0x08, 4, 3},   {0x0B, 4, 4},   {0x0C, 4, 5},
    {0x0E, 4, 6},   {0x0F, 4, 7},   {0x13, 5, 8},   {0x14, 5, 9},   {0x07, 5, 10},  {0x08, 5, 11},
    {0x08, 6, 12},  {0x03, 6, 13},  {0x34, 6, 14},  {0x35, 6, 15},  {0x2A, 6, 16},  {0x2B, 6, 17},
    {0x27, 7, 18},  {0x0C, 7, 19},  {0x08, 7, 20},  {0x17, 7, 21},  {0x03, 7, 22},  {0x04, 7, 23},
    {0x28, 7, 24},  {0x2B, 7, 25},  {0x13, 7, 26},  {0x24, 7, 27},  {0x18, 7, 28},  {0x02, 8, 29},
    {0x03, 8, 30},  {0x1A, 8, 31},  {0x1B, 8, 32},  {0x12, 8, 33},  {0x13, 8, 34},  {0x14, 8, 35},
    {0x15, 8, 36},  {0x16, 8, 37},  {0x17, 8, 38},  {0x28, 8, 39},  {0x29, 8, 40},  {0x2A, 8, 41},
    {0x2B, 8, 42},  {0x2C, 8, 43},  {0x2D, 8, 44},  {0x04, 8, 45},  {0x05, 8, 46},  {0x0A, 8, 47},
    {0x0B, 8, 48},  {0x52, 8, 49},  {0x53, 8, 50},  {0x54, 8, 51},  {0x55, 8, 52},  {0x24, 8, 53},
    {0x25, 8, 54},  {0x58, 8, 55},  {0x59, 8, 56},  {0x5A, 8, 57},  {0x5B, 8, 58},  {0x4A, 8, 59},
    {0x4B, 8, 60},  {0x32, 8, 61},  {0x33, 8, 62},  {0x34, 8, 63}};
const Proto kMakeUpW[] = {
    {0x1B, 5, 64},    {0x12, 5, 128},   {0x17, 6, 192},   {0x37, 7, 256},   {0x36, 8, 320},
    {0x37, 8, 384},   {0x64, 8, 448},   {0x65, 8, 512},   {0x68, 8, 576},   {0x67, 8, 640},
    {0xCC, 9, 704},   {0xCD, 9, 768},   {0xD2, 9, 832},   {0xD3, 9, 896},   {0xD4, 9, 960},
    {0xD5, 9, 1024},  {0xD6, 9, 1088},  {0xD7, 9, 1152},  {0xD8, 9, 1216},  {0xD9, 9, 1280},
    {0xDA, 9, 1344},  {0xDB, 9, 1408},  {0x98, 9, 1472},  {0x99, 9, 1536},  {0x9A, 9, 1600},
    {0x18, 6, 1664},  {0x9B, 9, 1728}};
const Proto kTermB[] = {
    {0x37, 10, 0},  {0x02, 3, 1},   {0x03, 2, 2},   {0x02, 2, 3},   {0x03, 3, 4},   {0x03, 4, 5},
    {0x02, 4, 6},   {0x03, 5, 7},   {0x05, 6, 8},   {0x04, 6, 9},   {0x04, 7, 10},  {0x05, 7, 11},
    {0x07, 7, 12},  {0x04, 8, 13},  {0x07, 8, 14},  {0x18, 9, 15},  {0x17, 10, 16}, {0x18, 10, 17},
    {0x08, 10, 18}, {0x67, 11, 19}, {0x68, 11, 20}, {0x6C, 11, 21}, {0x37, 11, 22}, {0x28, 11, 23},
    {0x17, 11, 24}, {0x18, 11, 25}, {0xCA, 12, 26}, {0xCB, 12, 27}, {0xCC, 12, 28}, {0xCD, 12, 29},
    {0x68, 12, 30}, {0x69, 12, 31}, {0x6A, 12, 32}, {0x6B, 12, 33}, {0xD2, 12, 34}, {0xD3, 12, 35},
    {0xD4, 12, 36}, {0xD5, 12, 37}, {0xD6, 12, 38}, {0xD7, 12, 39}, {0x6C, 12, 40}, {0x6D, 12, 41},
    {0xDA, 12, 42}, {0xDB, 12, 43}, {0x54, 12, 44}, {0x55, 12, 45}, {0x56, 12, 46}, {0x57, 12, 47},
    {0x64, 12, 48}, {0x65, 12, 49}, {0x52, 12, 50}, {0x53, 12, 51}, {0x24, 12, 52}, {0x37, 12, 53},
    {0x38, 12, 54}, {0x27, 12, 55}, {0x28, 12, 56}, {0x58, 12, 57}, {0x59, 12, 58}, {0x2B, 12, 59},
    {0x2C, 12, 60}, {0x5A, 12, 61}, {0x66, 12, 62}, {0x67, 12, 63}};
const Proto kMakeUpB[] = {
    {0x0F, 10, 64},   {0xC8, 12, 128},  {0xC9, 12, 192},  {0x5B, 12, 256},  {0x33, 12, 320},
    {0x34, 12, 384},  {0x35, 12, 448},  {0x6C, 13, 512},  {0x6D, 13, 576},  {0x4A, 13, 640},
    {0x4B, 13, 704},  {0x4C, 13, 768},  {0x4D, 13, 832},  {0x72, 13, 896},  {0x73, 13, 960},
    {0x74, 13, 1024}, {0x75, 13, 1088}, {0x76, 13, 1152}, {0x77, 13, 1216}, {0x52, 13, 1280},
    {0x53, 13, 1344}, {0x54, 13, 1408}, {0x55, 13, 1472}, {0x5A, 13, 1536}, {0x5B, 13, 1600},
    {0x64, 13, 1664}, {0x65, 13, 1728}};
// T.4 table 4: make-up codes of either colour
const Proto kMakeUp[] = {
    {0x08, 11, 1792}, {0x0C, 11, 1856}, {0x0D, 11, 1920}, {0x12, 12, 1984}, {0x13, 12, 2048},
    {0x14, 12, 2112}, {0x15, 12, 2176}, {0x16, 12, 2240}, {0x17, 12, 2304}, {0x1C, 12, 2368},
    {0x1D, 12, 2432}, {0x1E, 12, 2496}, {0x1F, 12, 2560}};
// T.4 table 5: the 2D modes (VR and VL carry their offset)
const Proto kPass[] = {{0x1, 4, 0}};
const Proto kHoriz[] = {{0x1, 3, 0}};
const Proto kV0[] = {{0x1, 1, 0}};
const Proto kVR[] = {{0x3, 3, 1}, {0x03, 6, 2}, {0x03, 7, 3}};
const Proto kVL[] = {{0x2, 3, 1}, {0x02, 6, 2}, {0x02, 7, 3}};
const Proto kExt[] = {{0x1, 7, 0}};
const Proto kEolMain[] = {{0x0, 7, 0}};
const Proto kEolRun[] = {{0x0, 11, 0}};

struct Tables {
  TabEnt main[1 << 7], white[1 << 12], black[1 << 13];
  static void fill(TabEnt* t, int wbits, const Proto* p, size_t n, State s) {
    for (size_t i = 0; i < n; i++) {
      uint32_t rev = 0;
      for (int b = 0; b < p[i].len; b++) rev |= ((p[i].code >> (p[i].len - 1 - b)) & 1u) << b;
      for (uint32_t hi = 0; hi < (1u << (wbits - p[i].len)); hi++) {
        TabEnt& e = t[rev | (hi << p[i].len)];
        e.state = s;
        e.width = p[i].len;
        e.param = p[i].param;
      }
    }
  }
  Tables() {
#define ADD(t, w, arr, s) fill(t, w, arr, sizeof(arr) / sizeof(arr[0]), s)
    ADD(main, 7, kEolMain, S_EOL);
    ADD(main, 7, kPass, S_Pass);
    ADD(main, 7, kHoriz, S_Horiz);
    ADD(main, 7, kV0, S_V0);
    ADD(main, 7, kVR, S_VR);
    ADD(main, 7, kVL, S_VL);
    ADD(main, 7, kExt, S_Ext);
    ADD(white, 12, kEolRun, S_EOL);
    ADD(white, 12, kMakeUpW, S_MakeUpW);
    ADD(white, 12, kMakeUp, S_MakeUp);
    ADD(white, 12, kTermW, S_TermW);
    ADD(black, 13, kEolRun, S_EOL);
    ADD(black, 13, kMakeUpB, S_MakeUpB);
    ADD(black, 13, kMakeUp, S_MakeUp);
    ADD(black, 13, kTermB, S_TermB);
#undef ADD
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// _TIFFFax3fillruns: white runs clear their bits, black runs set them
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; k++) {
      uint32_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
      for (uint32_t i = 0; i < run; i++, x++) {
        if (k) buf[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
        else buf[x >> 3] &= (uint8_t)~(0x80 >> (x & 7));
      }
    }
  }
}

uint8_t reverse(uint8_t b) {
  b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

enum Mode { kRle = 2, kG3 = 3, kG4 = 4, kRlew = 32771 };

// One strip or tile (libtiff's Fax3DecodeRLE, Fax3Decode1D, Fax3Decode2D
// and Fax4Decode; the labels and checks are theirs). Returns 0, or 1 where
// libtiff reports an error (the rows it leaves are in out all the same).
int decode(const uint8_t* src, size_t n, int method, int options, int fill_order, int width,
           int nrows, int odd_start, int& noeol, uint8_t* out, std::string& why) {
  const Tables& tb = tables();
  const bool is2d = method == kG4 || (method == kG3 && (options & 1));
  const int lastx = width;
  const size_t rowbytes = ((size_t)width + 7) / 8;
  // libtiff's run arrays: nruns entries for this row and for the reference row
  const uint32_t nruns = (uint32_t)((is2d ? 2 * (((uint32_t)width + 31) & ~31u) : (uint32_t)width) + 3);
  std::vector<uint32_t> runs(2 * (size_t)nruns);
  uint32_t* curruns = runs.data();
  uint32_t* refruns = is2d ? runs.data() + nruns : nullptr;
  if (refruns) {
    refruns[0] = (uint32_t)width;
    refruns[1] = 0;
  }
  uint8_t bitmap[256];
  for (int i = 0; i < 256; i++) bitmap[i] = fill_order == 2 ? (uint8_t)i : reverse((uint8_t)i);
  const uint8_t* cp = src;
  const uint8_t* ep = src + n;
  uint32_t BitAcc = 0;
  int BitsAvail = 0, EOLcnt = 0, a0 = 0, RunLength = 0, b1 = 0;
  uint32_t *pa = nullptr, *pb = nullptr, *thisrun = curruns;
  const TabEnt* ent = nullptr;
  int line = 0;
  uint8_t* buf = out;

#define EndOfData() (cp >= ep)
#define GetBits(n) (BitAcc & ((1u << (n)) - 1))
#define ClrBits(n)    \
  do {                \
    BitsAvail -= (n); \
    BitAcc >>= (n);   \
  } while (0)
#define NeedBits8(n, eoflab)                            \
  do {                                                  \
    if (BitsAvail < (n)) {                              \
      if (EndOfData()) {                                \
        if (BitsAvail == 0) goto eoflab;                \
        BitsAvail = (n);                                \
      } else {                                          \
        BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail; \
        BitsAvail += 8;                                 \
      }                                                 \
    }                                                   \
  } while (0)
#define NeedBits16(n, eoflab)                                 \
  do {                                                        \
    if (BitsAvail < (n)) {                                    \
      if (EndOfData()) {                                      \
        if (BitsAvail == 0) goto eoflab;                      \
        BitsAvail = (n);                                      \
      } else {                                                \
        BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail;     \
        if ((BitsAvail += 8) < (n)) {                         \
          if (EndOfData()) {                                  \
            BitsAvail = (n);                                  \
          } else {                                            \
            BitAcc |= ((uint32_t)bitmap[*cp++]) << BitsAvail; \
            BitsAvail += 8;                                   \
          }                                                   \
        }                                                     \
      }                                                       \
    }                                                         \
  } while (0)
#define LOOKUP8(wid, tab, eoflab)      \
  do {                                 \
    NeedBits8(wid, eoflab);            \
    ent = tab + GetBits(wid);       \
    ClrBits(ent->width);            \
  } while (0)
#define LOOKUP16(wid, tab, eoflab)     \
  do {                                 \
    NeedBits16(wid, eoflab);           \
    ent = tab + GetBits(wid);       \
    ClrBits(ent->width);            \
  } while (0)
#define OVERFLOW()                                                   \
  do {                                                               \
    why = "CCITT data overflows its run array at row " + std::to_string(line); \
    return 1;                                                        \
  } while (0)
#define SETVALUE(x)                                   \
  do {                                                \
    if (pa >= thisrun + nruns) OVERFLOW();            \
    *pa++ = (uint32_t)(RunLength + (x));              \
    a0 += (x);                                        \
    RunLength = 0;                                    \
  } while (0)
#define NOTE(msg) \
  do {            \
    if (why.empty()) why = std::string(msg) + " at row " + std::to_string(line); \
  } while (0)
#define CLEANUP_RUNS()                                 \
  do {                                                 \
    if (RunLength) SETVALUE(0);                        \
    if (a0 != lastx) {                                 \
      NOTE("a CCITT row of the wrong length");         \
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;  \
      if (a0 < lastx) {                                \
        if (a0 < 0) a0 = 0;                            \
        if ((pa - thisrun) & 1) SETVALUE(0);           \
        SETVALUE(lastx - a0);                          \
      } else if (a0 > lastx) {                         \
        SETVALUE(lastx);                               \
        SETVALUE(0);                                   \
      }                                                \
    }                                                  \
  } while (0)
#define EXPAND1D(eoflab)                                   \
  do {                                                     \
    for (;;) {                                             \
      for (;;) {                                           \
        LOOKUP16(12, tb.white, eof1d##eoflab);             \
        switch (ent->state) {                           \
          case S_EOL:                                      \
            EOLcnt = 1;                                    \
            goto done1d##eoflab;                           \
          case S_TermW:                                    \
            SETVALUE((int)ent->param);                  \
            goto doneWhite1d##eoflab;                      \
          case S_MakeUpW:                                  \
          case S_MakeUp:                                   \
            a0 += (int)ent->param;                      \
            RunLength += (int)ent->param;               \
            break;                                         \
          default:                                         \
            NOTE("a bad CCITT white code");                \
            goto done1d##eoflab;                           \
        }                                                  \
      }                                                    \
    doneWhite1d##eoflab:                                   \
      if (a0 >= lastx) goto done1d##eoflab;                \
      for (;;) {                                           \
        LOOKUP16(13, tb.black, eof1d##eoflab);             \
        switch (ent->state) {                           \
          case S_EOL:                                      \
            EOLcnt = 1;                                    \
            goto done1d##eoflab;                           \
          case S_TermB:                                    \
            SETVALUE((int)ent->param);                  \
            goto doneBlack1d##eoflab;                      \
          case S_MakeUpB:                                  \
          case S_MakeUp:                                   \
            a0 += (int)ent->param;                      \
            RunLength += (int)ent->param;               \
            break;                                         \
          default:                                         \
            NOTE("a bad CCITT black code");                \
            goto done1d##eoflab;                           \
        }                                                  \
      }                                                    \
    doneBlack1d##eoflab:                                   \
      if (a0 >= lastx) goto done1d##eoflab;                \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;       \
    }                                                      \
  eof1d##eoflab:                                           \
    NOTE("CCITT data ends early");                         \
    CLEANUP_RUNS();                                        \
    goto eoflab;                                           \
  done1d##eoflab:                                          \
    CLEANUP_RUNS();                                        \
  } while (0)
#define CHECK_b1                                                  \
  do {                                                            \
    if (pa != thisrun)                                            \
      while (b1 <= a0 && b1 < lastx) {                            \
        if (pb + 1 >= refruns + nruns) OVERFLOW();                \
        b1 += (int)(pb[0] + pb[1]);                               \
        pb += 2;                                                  \
      }                                                           \
  } while (0)
#define EXPAND2D(eoflab)                                                      \
  do {                                                                        \
    while (a0 < lastx) {                                                      \
      if (pa >= thisrun + nruns) OVERFLOW();                                  \
      LOOKUP8(7, tb.main, eof2d##eoflab);                                     \
      switch (ent->state) {                                                \
        case S_Pass:                                                          \
          CHECK_b1;                                                           \
          if (pb + 1 >= refruns + nruns) OVERFLOW();                          \
          b1 += (int)*pb++;                                                   \
          RunLength += b1 - a0;                                               \
          a0 = b1;                                                            \
          b1 += (int)*pb++;                                                   \
          break;                                                              \
        case S_Horiz:                                                         \
          if ((pa - thisrun) & 1) {                                           \
            for (;;) {                                                        \
              LOOKUP16(13, tb.black, eof2d##eoflab);                          \
              switch (ent->state) {                                        \
                case S_TermB:                                                 \
                  SETVALUE((int)ent->param);                               \
                  goto doneWhite2da##eoflab;                                  \
                case S_MakeUpB:                                               \
                case S_MakeUp:                                                \
                  a0 += (int)ent->param;                                   \
                  RunLength += (int)ent->param;                            \
                  break;                                                      \
                default:                                                      \
                  goto badBlack2d##eoflab;                                    \
              }                                                               \
            }                                                                 \
          doneWhite2da##eoflab:;                                              \
            for (;;) {                                                        \
              LOOKUP16(12, tb.white, eof2d##eoflab);                          \
              switch (ent->state) {                                        \
                case S_TermW:                                                 \
                  SETVALUE((int)ent->param);                               \
                  goto doneBlack2da##eoflab;                                  \
                case S_MakeUpW:                                               \
                case S_MakeUp:                                                \
                  a0 += (int)ent->param;                                   \
                  RunLength += (int)ent->param;                            \
                  break;                                                      \
                default:                                                      \
                  goto badWhite2d##eoflab;                                    \
              }                                                               \
            }                                                                 \
          doneBlack2da##eoflab:;                                              \
          } else {                                                            \
            for (;;) {                                                        \
              LOOKUP16(12, tb.white, eof2d##eoflab);                          \
              switch (ent->state) {                                        \
                case S_TermW:                                                 \
                  SETVALUE((int)ent->param);                               \
                  goto doneWhite2db##eoflab;                                  \
                case S_MakeUpW:                                               \
                case S_MakeUp:                                                \
                  a0 += (int)ent->param;                                   \
                  RunLength += (int)ent->param;                            \
                  break;                                                      \
                default:                                                      \
                  goto badWhite2d##eoflab;                                    \
              }                                                               \
            }                                                                 \
          doneWhite2db##eoflab:;                                              \
            for (;;) {                                                        \
              LOOKUP16(13, tb.black, eof2d##eoflab);                          \
              switch (ent->state) {                                        \
                case S_TermB:                                                 \
                  SETVALUE((int)ent->param);                               \
                  goto doneBlack2db##eoflab;                                  \
                case S_MakeUpB:                                               \
                case S_MakeUp:                                                \
                  a0 += (int)ent->param;                                   \
                  RunLength += (int)ent->param;                            \
                  break;                                                      \
                default:                                                      \
                  goto badBlack2d##eoflab;                                    \
              }                                                               \
            }                                                                 \
          doneBlack2db##eoflab:;                                              \
          }                                                                   \
          CHECK_b1;                                                           \
          break;                                                              \
        case S_V0:                                                            \
          CHECK_b1;                                                           \
          SETVALUE(b1 - a0);                                                  \
          if (pb >= refruns + nruns) OVERFLOW();                              \
          b1 += (int)*pb++;                                                   \
          break;                                                              \
        case S_VR:                                                            \
          CHECK_b1;                                                           \
          SETVALUE(b1 - a0 + (int)ent->param);                             \
          if (pb >= refruns + nruns) OVERFLOW();                              \
          b1 += (int)*pb++;                                                   \
          break;                                                              \
        case S_VL:                                                            \
          CHECK_b1;                                                           \
          if (b1 < (int)(a0 + ent->param)) {                               \
            NOTE("a bad CCITT VL code");                                      \
            goto eol2d##eoflab;                                               \
          }                                                                   \
          SETVALUE(b1 - a0 - (int)ent->param);                             \
          b1 -= (int)*--pb;                                                   \
          break;                                                              \
        case S_Ext:                                                           \
          *pa++ = (uint32_t)(lastx - a0);                                     \
          NOTE("a CCITT extension code");                                     \
          goto eol2d##eoflab;                                                 \
        case S_EOL:                                                           \
          *pa++ = (uint32_t)(lastx - a0);                                     \
          NeedBits8(4, eof2d##eoflab);                                        \
          if (GetBits(4)) NOTE("a bad CCITT EOL");                            \
          ClrBits(4);                                                         \
          EOLcnt = 1;                                                         \
          goto eol2d##eoflab;                                                 \
        default:                                                              \
        badMain2d##eoflab:                                                    \
          NOTE("a bad CCITT mode code");                                      \
          goto eol2d##eoflab;                                                 \
        badBlack2d##eoflab:                                                   \
          NOTE("a bad CCITT black code");                                     \
          goto eol2d##eoflab;                                                 \
        badWhite2d##eoflab:                                                   \
          NOTE("a bad CCITT white code");                                     \
          goto eol2d##eoflab;                                                 \
        eof2d##eoflab:                                                        \
          NOTE("CCITT data ends early");                                      \
          CLEANUP_RUNS();                                                     \
          goto eoflab;                                                        \
      }                                                                       \
    }                                                                         \
    if (RunLength) {                                                          \
      if (RunLength + a0 < lastx) {                                           \
        NeedBits8(1, eof2d##eoflab);                                          \
        if (!GetBits(1)) goto badMain2d##eoflab;                              \
        ClrBits(1);                                                           \
      }                                                                       \
      SETVALUE(0);                                                            \
    }                                                                         \
  eol2d##eoflab:                                                              \
    CLEANUP_RUNS();                                                           \
  } while (0)
// libtiff 4.7's SYNC_EOL: where the data ends before the EOL's 1 bit, it
// switches the codec to rows without EOLs for good and reads this row again
// from the state the decoding call began with (the strip's first bit)
#define SYNC_EOL(eoflab)                   \
  do {                                     \
    if (!noeol) {                          \
      if (EOLcnt == 0) {                   \
        for (;;) {                         \
          NeedBits16(11, eoflab);          \
          if (GetBits(11) == 0) break;     \
          ClrBits(1);                      \
        }                                  \
      }                                    \
      for (;;) {                           \
        NeedBits8(8, noEOL##eoflab);       \
        if (GetBits(8)) break;             \
        ClrBits(8);                        \
      }                                    \
      while (GetBits(1) == 0) ClrBits(1);  \
      ClrBits(1);                          \
      EOLcnt = 0;                          \
      break;                               \
    noEOL##eoflab:                         \
      noeol = 1;                           \
      NOTE("CCITT Group 3 data without an EOL"); \
      cp = src;                            \
      BitAcc = 0;                          \
      BitsAvail = 0;                       \
      EOLcnt = 0;                          \
    }                                      \
  } while (0)
#define SWAP_RUNS()            \
  do {                         \
    uint32_t* t_ = curruns;    \
    curruns = refruns;         \
    refruns = t_;              \
  } while (0)

  if (method == kRle || method == kRlew) {
    thisrun = curruns;
    for (; line < nrows; line++, buf += rowbytes) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      EXPAND1D(EOFRLE);
      fill_runs(buf, thisrun, pa, (uint32_t)lastx);
      const int n_align = BitsAvail - (BitsAvail & (method == kRle ? ~7 : ~15));
      ClrBits(n_align);
      if (method == kRlew && BitsAvail == 0 && (((cp - src) + odd_start) & 1)) cp++;
    }
    return why.empty() ? 0 : 1;
  EOFRLE:
    fill_runs(buf, thisrun, pa, (uint32_t)lastx);
    return 1;
  }
  if (method == kG3 && !is2d) {
    thisrun = curruns;
    for (; line < nrows; line++, buf += rowbytes) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      SYNC_EOL(EOF1D);
      EXPAND1D(EOF1Da);
      fill_runs(buf, thisrun, pa, (uint32_t)lastx);
    }
    return why.empty() ? 0 : 1;
  EOF1D:
    NOTE("CCITT data ends early");
    CLEANUP_RUNS();
  EOF1Da:
    fill_runs(buf, thisrun, pa, (uint32_t)lastx);
    return 1;
  }
  if (method == kG3) {
    for (; line < nrows; line++, buf += rowbytes) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun = curruns;
      SYNC_EOL(EOF2D);
      NeedBits8(1, EOF2D);
      {
        const bool is1d = GetBits(1);
        ClrBits(1);
        pb = refruns;
        b1 = (int)*pb++;
        if (is1d) EXPAND1D(EOF2Da);
        else EXPAND2D(EOF2Da);
      }
      fill_runs(buf, thisrun, pa, (uint32_t)lastx);
      if (pa < thisrun + nruns) SETVALUE(0);
      SWAP_RUNS();
    }
    return why.empty() ? 0 : 1;
  EOF2D:
    NOTE("CCITT data ends early");
    CLEANUP_RUNS();
  EOF2Da:
    fill_runs(buf, thisrun, pa, (uint32_t)lastx);
    return 1;
  }
  for (; line < nrows; line++, buf += rowbytes) {  // Group 4
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    pb = refruns;
    b1 = (int)*pb++;
    EXPAND2D(EOFG4);
    if (EOLcnt) goto EOFG4;
    fill_runs(buf, thisrun, pa, (uint32_t)lastx);
    SETVALUE(0);
    SWAP_RUNS();
  }
  return why.empty() ? 0 : 1;
EOFG4:
  NeedBits16(13, BADG4);
BADG4:
  ClrBits(13);
  fill_runs(buf, thisrun, pa, (uint32_t)lastx);
  return line ? (why.empty() ? 0 : 1) : 1;
}

}  // namespace

extern "C" {

// Decode one CCITT strip or tile (src[0:n]) of nrows rows of width pixels
// into out (nrows rows of (width + 7) / 8 bytes, zeroed by the caller):
// method 2 (RLE), 3 (T.4; options: T4Options), 4 (T.6) or 32771 (RLEW,
// aligned to 16 bits from the file's start: odd_start is the strip's offset
// & 1). fill_order: the FillOrder tag. *noeol: libtiff's "no EOL" mode,
// which a Group 3 strip that runs out of data while seeking an EOL turns on
// for the strips after it; 0 for an image's first strip. Returns 0, 1 where
// libtiff reports an error (msg says which; out holds what libtiff leaves),
// or -1 for a bad argument.
int ayolo_fax_decode(const uint8_t* src, int64_t n, int method, int options, int fill_order,
                     int width, int nrows, int odd_start, int* noeol, uint8_t* out, char* msg,
                     int msg_len) {
  if (width <= 0 || nrows <= 0 || n < 0 ||
      (method != kRle && method != kG3 && method != kG4 && method != kRlew)) {
    if (msg && msg_len > 0) snprintf(msg, (size_t)msg_len, "bad CCITT arguments");
    return -1;
  }
  std::string why;
  int rc = decode(src, (size_t)n, method, options, fill_order, width, nrows, odd_start & 1, *noeol,
                  out, why);
  if (msg && msg_len > 0) snprintf(msg, (size_t)msg_len, "%s", why.c_str());
  return rc;
}

}  // extern "C"
