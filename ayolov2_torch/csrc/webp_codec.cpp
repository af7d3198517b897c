// WebP decoding of the port: the VP8L (lossless) and VP8 (lossy key frame)
// bitstreams into BGR, equal bit for bit to libwebp's WebPDecodeBGRInto,
// which OpenCV's imread calls. The caller parses the RIFF container and
// hands over one chunk's payload; alpha is never decoded, since imread's
// three-channel output drops it.
//
// VP8L: prefix codes (simple and normal, the code-length code, canonical
// assignment; a code of one symbol takes no bits), meta prefix codes over
// an entropy image, LZ77 copies with the 120-entry distance map, the colour
// cache, and the four transforms (predictor with its 14 modes,
// cross-colour, subtract-green, colour indexing with pixel bundling),
// undone in reverse order.
//
// VP8 (RFC 6386 as libwebp decodes it): the boolean decoder, the frame
// header (segments, filter deltas, up to 8 token partitions, the
// quantiser with libwebp's y2 scaling), token probabilities, intra modes
// with their context trees, coefficients, the inverse WHT and DCT, the
// 16x16, 8x8 and 4x4 intra predictors with libwebp's borders (127 above,
// 129 left, the top-right pixels replicated below), the simple and normal
// loop filters on the unfiltered-predicted frame, and libwebp's "fancy"
// 4:2:0 upsampler with its 14-bit fixed-point YUV -> BGR. Data that ends
// before the decoder is done raises, as libwebp's does.
//
// Plain C interface for ctypes; no global state.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct CodecError {
  int status;
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError{1, msg}; }

// Tables of RFC 6386 and of the VP8L format, as libwebp holds them: the
// quantiser steps, the default and update coefficient probabilities
// [type][band][context][node], the 4x4 mode probabilities [above][left][node]
// with the modes in libwebp's order (the enum below), and VP8L's distance map.
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

// ---- VP8L ----------------------------------------------------------------------

// LSB-first reader; bits past the end read as zeros and flag the stream.
struct LBitReader {
  const uint8_t* buf;
  size_t len, pos = 0;
  uint64_t val = 0;
  int have = 0;
  bool eos = false;

  LBitReader(const uint8_t* b, size_t n) : buf(b), len(n) { fill(); }
  void fill() {
    while (have <= 56 && pos < len) {
      val |= (uint64_t)buf[pos++] << have;
      have += 8;
    }
  }
  uint32_t peek(int n) {
    if (have < 32) fill();
    return (uint32_t)(val & ((1ull << n) - 1));
  }
  void skip(int n) {
    if (n > have) {
      eos = true;
      val = 0;
      have = 0;
      return;
    }
    val >>= n;
    have -= n;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

const int kRootBits = 10;

// A canonical prefix code; a code of one symbol takes no bits.
struct Huff {
  int single = -1;
  int count[16] = {0};
  std::vector<int> sorted;
  std::vector<uint32_t> table;  // (length << 16) | symbol for codes up to kRootBits, else 0

  // libwebp's VP8LBuildHuffmanTable: false where the lengths make no code
  bool build(const int* lengths, int n) {
    std::fill(count, count + 16, 0);
    int nonzero = 0, short_count = 0, short_sym = -1;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      ++count[lengths[s]];
      if (lengths[s]) ++nonzero;
      if (lengths[s] && lengths[s] < 15) short_count++, short_sym = s;
    }
    if (!nonzero) return false;
    if (short_count == 1) {  // only one value: no bits
      single = short_sym;
      return true;
    }
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
      left = (left << 1) - count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    sorted.assign(nonzero, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted[offs[lengths[s]]++] = s;
    table.assign(1 << kRootBits, 0);
    int code = 0, k = 0;
    for (int len = 1; len <= kRootBits; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> (len - 1 - b)) & 1) << b;
        for (int r = rev; r < (1 << kRootBits); r += 1 << len)
          table[r] = ((uint32_t)len << 16) | (uint32_t)sorted[k];
      }
      code <<= 1;
    }
    return true;
  }

  int decode(LBitReader& br) const {
    if (single >= 0) return single;
    uint32_t bits = br.peek(15);
    uint32_t e = table[bits & ((1 << kRootBits) - 1)];
    if (e) {
      br.skip((int)(e >> 16));
      return (int)(e & 0xffff);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (bits >> (len - 1)) & 1;
      int c = count[len];
      if (code - c < first) {
        br.skip(len);
        return sorted[index + (code - first)];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    fail("VP8L: bad prefix code");
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int d = 0;
  for (int s = 0; s < 32; s += 8) d += sub3((a >> s) & 255, (b >> s) & 255, (c >> s) & 255);
  return d <= 0 ? a : b;
}

inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int v = (int)((c0 >> s) & 255) + (int)((c1 >> s) & 255) - (int)((c2 >> s) & 255);
    out |= clip255((uint32_t)v) << s;
  }
  return out;
}

inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t ave = average2(c0, c1), out = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (int)((ave >> s) & 255), b = (int)((c2 >> s) & 255);
    out |= clip255((uint32_t)(a + (a - b) / 2)) << s;
  }
  return out;
}

// The predictor of mode m for the pixel at out[0], its left neighbour at
// out[-1] and the row above at top[0] (top[-1], top[1] the diagonals).
inline uint32_t predict(int m, const uint32_t* out, const uint32_t* top) {
  uint32_t L = out[-1], T = top[0], TL = top[-1], TR = top[1];
  switch (m) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return add_sub_full(L, T, TL);
    case 13: return add_sub_half(L, T, TL);
    default: return 0xff000000u;
  }
}

struct VP8LDecoder {
  LBitReader br;
  std::vector<Transform> transforms;
  unsigned seen = 0;

  VP8LDecoder(const uint8_t* d, size_t n) : br(d, n) {}

  void check() {
    if (br.eos) fail("VP8L data ends before the image does");
  }

  void read_code(int alphabet, Huff& h) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {  // simple code
      int num = br.read(1) + 1;
      int first_bits = br.read(1) ? 8 : 1;
      int s = br.read(first_bits);
      if (s >= alphabet) fail("VP8L: symbol past the alphabet");
      lengths[s] = 1;
      if (num == 2) {
        s = br.read(8);
        if (s >= alphabet) fail("VP8L: symbol past the alphabet");
        lengths[s] = 1;
      }
    } else {
      int cl[19] = {0};
      int num = br.read(4) + 4;
      for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
      Huff lh;
      if (!lh.build(cl, 19)) fail("VP8L: bad code-length code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        int nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(nbits);
        if (max_symbol > alphabet) fail("VP8L: bad code-length count");
      }
      int prev = 8, s = 0;
      while (s < alphabet) {
        if (max_symbol-- == 0) break;
        int c = lh.decode(br);
        if (c < 16) {
          lengths[s++] = c;
          if (c) prev = c;
        } else {
          static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          int repeat = br.read(extra[c - 16]) + offset[c - 16];
          if (s + repeat > alphabet) fail("VP8L: code lengths past the alphabet");
          int v = c == 16 ? prev : 0;
          while (repeat-- > 0) lengths[s++] = v;
        }
      }
    }
    check();
    if (!h.build(lengths.data(), alphabet)) fail("VP8L: bad prefix code");
  }

  std::vector<uint32_t> decode_stream(int xs, int ys, bool level0) {
    if (level0) {
      while (br.read(1)) read_transform(xs, ys);
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L: bad colour cache size");
    }
    int meta_bits = 0, meta_w = 0, num_groups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br.read(1)) {
      meta_bits = br.read(3) + 2;
      meta_w = subsample(xs, meta_bits);
      meta = decode_stream(meta_w, subsample(ys, meta_bits), false);
      for (auto& m : meta) {
        m = (m >> 8) & 0xffff;
        num_groups = std::max(num_groups, (int)m + 1);
      }
    }
    check();
    const int sizes[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0), 256, 256, 256, 40};
    std::vector<Huff> codes(5 * (size_t)num_groups);
    for (int g = 0; g < num_groups; ++g)
      for (int j = 0; j < 5; ++j) read_code(sizes[j], codes[5 * g + j]);

    std::vector<uint32_t> cache(cache_bits ? 1 << cache_bits : 0);
    std::vector<uint32_t> data((size_t)xs * ys);
    const size_t total = data.size();
    size_t i = 0;
    int col = 0, row = 0;
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
    };
    while (i < total) {
      const Huff* h = &codes[0];
      if (meta_bits) h = &codes[5 * meta[(size_t)(row >> meta_bits) * meta_w + (col >> meta_bits)]];
      int code = h[0].decode(br);
      if (code < 256) {
        int red = h[1].decode(br), blue = h[2].decode(br), alpha = h[3].decode(br);
        check();
        data[i] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) | blue;
        insert(data[i]);
        ++i;
        if (++col >= xs) col = 0, ++row;
      } else if (code < 256 + 24) {
        int ls = code - 256;
        int length = ls < 4 ? ls + 1 : 0;
        if (ls >= 4) {
          int eb = (ls - 2) >> 1;
          length = ((2 + (ls & 1)) << eb) + br.read(eb) + 1;
        }
        int ds = h[4].decode(br);
        int dcode = ds < 4 ? ds + 1 : 0;
        if (ds >= 4) {
          int eb = (ds - 2) >> 1;
          dcode = ((2 + (ds & 1)) << eb) + br.read(eb) + 1;
        }
        int dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          int p = kCodeToPlane[dcode - 1];
          dist = (p >> 4) * xs + (8 - (p & 15));
          if (dist < 1) dist = 1;
        }
        check();
        if ((size_t)dist > i || total - i < (size_t)length) fail("VP8L: bad backward reference");
        for (int k = 0; k < length; ++k, ++i) {
          data[i] = data[i - dist];
          insert(data[i]);
        }
        col += length;
        while (col >= xs) col -= xs, ++row;
      } else {
        int key = code - 256 - 24;
        if (key >= (int)cache.size()) fail("VP8L: bad colour cache index");
        check();
        data[i] = cache[key];
        insert(data[i]);
        ++i;
        if (++col >= xs) col = 0, ++row;
      }
    }
    check();
    return data;
  }

  void read_transform(int& xs, int ys) {
    int type = br.read(2);
    if (seen & (1u << type)) fail("VP8L: a transform used twice");
    seen |= 1u << type;
    Transform t{type, 0, xs, ys, {}};
    if (type == 0 || type == 1) {
      t.bits = br.read(3) + 2;
      t.data = decode_stream(subsample(xs, t.bits), subsample(ys, t.bits), false);
    } else if (type == 3) {
      int num_colors = br.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xs = subsample(xs, t.bits);
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      t.data.assign((size_t)1 << (8 >> t.bits), 0);
      t.data[0] = pal[0];
      for (int k = 1; k < num_colors; ++k) t.data[k] = add_pixels(pal[k], t.data[k - 1]);
    }
    transforms.push_back(std::move(t));
  }

  static std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 2) {  // subtract green
      for (auto& p : in) {
        uint32_t g = (p >> 8) & 255;
        uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
      return std::move(in);
    }
    if (t.type == 1) {  // cross colour
      const int tw = subsample(w, t.bits);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t m = t.data[(size_t)(y >> t.bits) * tw + (x >> t.bits)];
          int8_t g2r = (int8_t)(m & 255), g2b = (int8_t)((m >> 8) & 255),
                 r2b = (int8_t)((m >> 16) & 255);
          uint32_t& p = in[(size_t)y * w + x];
          int8_t green = (int8_t)(p >> 8);
          int red = (p >> 16) & 255, blue = p & 255;
          red = (red + (((int)g2r * green) >> 5)) & 255;
          blue += ((int)g2b * green) >> 5;
          blue += ((int)r2b * (int8_t)red) >> 5;
          blue &= 255;
          p = (p & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
        }
      return std::move(in);
    }
    if (t.type == 0) {  // predictor: in place, each pixel from its decoded neighbours
      const int tw = subsample(w, t.bits);
      std::vector<uint32_t>& out = in;
      for (int y = 0; y < h; ++y) {
        uint32_t* o = &out[(size_t)y * w];
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) pred = x == 0 ? 0xff000000u : o[x - 1];
          else if (x == 0) pred = o[x - w];
          else pred = predict((t.data[(size_t)(y >> t.bits) * tw + (x >> t.bits)] >> 8) & 15,
                              o + x, o + x - w);
          o[x] = add_pixels(o[x], pred);
        }
      }
      return std::move(in);
    }
    // colour indexing
    std::vector<uint32_t> out((size_t)w * h);
    const int in_w = subsample(w, t.bits);
    if (t.bits == 0) {
      for (size_t k = 0; k < out.size(); ++k) out[k] = t.data[(in[k] >> 8) & 255];
      return out;
    }
    const int bpp = 8 >> t.bits, per = 1 << t.bits, mask = (1 << bpp) - 1;
    for (int y = 0; y < h; ++y) {
      const uint32_t* src = &in[(size_t)y * in_w];
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & (per - 1)) == 0) packed = (*src++ >> 8) & 255;
        out[(size_t)y * w + x] = t.data[packed & mask];
        packed >>= bpp;
      }
    }
    return out;
  }

  // (h, w, 3) BGR of the whole image
  void decode(int w, int h, uint8_t* bgr) {
    if (br.read(8) != 0x2f) fail("VP8L: bad signature");
    int iw = br.read(14) + 1, ih = br.read(14) + 1;
    br.read(1);  // alpha hint
    if (br.read(3) != 0) fail("VP8L: unknown version");
    check();
    if (iw != w || ih != h) fail("VP8L: size differs from the container's");
    std::vector<uint32_t> px = decode_stream(w, h, true);
    for (int k = (int)transforms.size() - 1; k >= 0; --k) px = inverse(transforms[k], px);
    for (size_t k = 0; k < px.size(); ++k) {
      bgr[3 * k] = px[k] & 255;
      bgr[3 * k + 1] = (px[k] >> 8) & 255;
      bgr[3 * k + 2] = (px[k] >> 16) & 255;
    }
  }
};

// ---- VP8 -----------------------------------------------------------------------

// libwebp's boolean decoder, a byte at a time: range holds range - 1, and a
// byte needed past the end reads as zero and sets eof.
struct BoolReader {
  const uint8_t *p = nullptr, *end = nullptr;
  uint32_t value = 0;
  int bits = -8, range = 254;
  bool eof = false;

  void init(const uint8_t* b, size_t n) {
    p = b;
    end = b + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (p < end) {
      bits += 8;
      value = *p++ | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = (uint32_t)range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = value >> pos;
    int b = v > split;
    if (b) {
      r -= split;
      value -= (split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = __builtin_clz(r) - 24;  // 7 - floor(log2(r)), r in [1, 255]
    r <<= shift;
    bits -= shift;
    range = (int)r - 1;
    return b;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's enum: B_DC_PRED, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED,
// B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED; the 16x16 and
// chroma modes DC, TM, V, H share the first four numbers.
enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3 };

const int BPS = 32;
const int Y_OFF = BPS * 1 + 8;
const int U_OFF = Y_OFF + BPS * 16 + BPS;
const int V_OFF = U_OFF + 16;
const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

#define DST(x, y) dst[(x) + (y) * BPS]

void transform(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = ((in[4] * 35468) >> 16) - (((in[12] * 20091) >> 16) + in[12]);
    const int d = (((in[4] * 20091) >> 16) + in[4]) + ((in[12] * 35468) >> 16);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = ((tmp[4] * 35468) >> 16) - (((tmp[12] * 20091) >> 16) + tmp[12]);
    const int d = (((tmp[4] * 20091) >> 16) + tmp[4]) + ((tmp[12] * 35468) >> 16);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - tl);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
}

// 16x16 (size 16) and chroma (size 8) prediction; mode DC at the frame's
// edges uses only the samples there are
void predict_block(uint8_t* dst, int size, int mode, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  if (mode == DC_PRED) {
    int dc = 0;
    if (has_top && has_left) {
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, size, (dc + size) >> (shift + 1));
    } else if (has_left) {
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, (dc + (size >> 1)) >> shift);
    } else if (has_top) {
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, (dc + (size >> 1)) >> shift);
    } else {
      fill(dst, size, 0x80);
    }
  } else if (mode == TM_PRED) {
    true_motion(dst, size);
  } else if (mode == V_PRED) {
    for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
  } else {
    for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case 0: {  // DC
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case 1:
      true_motion(dst, 4);
      break;
    case 2: {  // VE
      const uint8_t v[4] = {(uint8_t)avg3(X, A, B), (uint8_t)avg3(A, B, C),
                            (uint8_t)avg3(B, C, D), (uint8_t)avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, v, 4);
      break;
    }
    case 3:  // HE
      memset(dst, avg3(X, I, J), 4);
      memset(dst + BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case 4:  // RD
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case 5:  // VR
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case 6:  // LD
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case 7:  // VL
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case 8:  // HD
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}
#undef DST

// ---- loop filter, on a plane with stride `stride`

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int t) {
  return std::abs(p[-2 * step] - p[-step]) > t || std::abs(p[step] - p[0]) > t;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

void loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t) {
  const int t2 = 2 * thresh + 1;
  for (; size > 0; --size, p += vstride)
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_t)) filter2(p, hstride);
      else filter6(p, hstride);
    }
}

void loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t) {
  const int t2 = 2 * thresh + 1;
  for (; size > 0; --size, p += vstride)
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_t)) filter2(p, hstride);
      else filter4(p, hstride);
    }
}

struct FInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct MBInfo {
  uint8_t nz[9];  // per-block "has coefficients": 4 luma columns (top) or rows (left), 2 U, 2 V, Y2
};

struct VP8Decoder {
  BoolReader br;
  BoolReader parts[8];
  int num_parts = 1;
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  int seg_proba[3] = {255, 255, 255};
  // filter header
  bool simple = false;
  int level = 0, sharpness = 0, filter_type = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  // quantisers per segment: y1 dc/ac, y2 dc/ac, uv dc/ac
  int dq[4][6];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];

  void parse_header(const uint8_t* data, size_t n) {
    if (n < 10) fail("VP8 data is too short");
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    const bool key = !(bits & 1);
    const int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
    const uint32_t part_len = bits >> 5;
    if (!key) fail("VP8: not a key frame");
    if (profile > 3) fail("VP8: incorrect keyframe parameters");
    if (!show) fail("VP8: frame not displayable");
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail("VP8: bad code word");
    width = ((data[7] << 8) | data[6]) & 0x3fff;
    height = ((data[9] << 8) | data[8]) & 0x3fff;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    const uint8_t* buf = data + 10;
    size_t size = n - 10;
    if (part_len > size) fail("VP8: bad partition length");
    br.init(buf, part_len);
    buf += part_len;
    size -= part_len;
    br.bit(0x80);  // colour space
    br.bit(0x80);  // clamping type
    // segment header
    use_segment = br.bit(0x80);
    if (use_segment) {
      update_map = br.bit(0x80);
      if (br.bit(0x80)) {
        absolute_delta = br.bit(0x80);
        for (int s = 0; s < 4; ++s) quantizer[s] = br.bit(0x80) ? br.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength[s] = br.bit(0x80) ? br.signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s) seg_proba[s] = br.bit(0x80) ? br.value_bits(8) : 255;
    }
    if (br.eof) fail("VP8: cannot parse segment header");
    // filter header
    simple = br.bit(0x80);
    level = br.value_bits(6);
    sharpness = br.value_bits(3);
    use_lf_delta = br.bit(0x80);
    if (use_lf_delta && br.bit(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br.bit(0x80)) ref_lf_delta[i] = br.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.bit(0x80)) mode_lf_delta[i] = br.signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) fail("VP8: cannot parse filter header");
    // partitions
    num_parts = 1 << br.value_bits(2);
    const size_t last = num_parts - 1;
    if (size < 3 * last) fail("VP8: cannot parse partitions");
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts[last].init(start, left);
    if (start >= buf + size) fail("VP8: cannot parse partitions (no data)");
    // quantiser
    const int base_q0 = br.value_bits(7);
    const int dqy1_dc = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dqy2_dc = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dqy2_ac = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dquv_dc = br.bit(0x80) ? br.signed_value(4) : 0;
    const int dquv_ac = br.bit(0x80) ? br.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment) {
        q = quantizer[s];
        if (!absolute_delta) q += base_q0;
      } else {
        if (s > 0) {
          memcpy(dq[s], dq[0], sizeof(dq[0]));
          continue;
        }
        q = base_q0;
      }
      dq[s][0] = kDcTable[clip(q + dqy1_dc, 127)];
      dq[s][1] = kAcTable[clip(q, 127)];
      dq[s][2] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      dq[s][3] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (dq[s][3] < 8) dq[s][3] = 8;
      dq[s][4] = kDcTable[clip(q + dquv_dc, 117)];
      dq[s][5] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.bit(0x80);  // refresh entropy probabilities: ignored
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p]) ? br.value_bits(8)
                                                                        : kCoeffsProba0[t][b][c][p];
    use_skip = br.bit(0x80);
    if (use_skip) skip_p = br.value_bits(8);
    // filter strengths
    if (filter_type > 0) {
      for (int s = 0; s < 4; ++s) {
        int base_level = level;
        if (use_segment) {
          base_level = filter_strength[s];
          if (!absolute_delta) base_level += level;
        }
        for (int i4 = 0; i4 <= 1; ++i4) {
          FInfo& f = fstrengths[s][i4];
          int lv = base_level;
          if (use_lf_delta) {
            lv += ref_lf_delta[0];
            if (i4) lv += mode_lf_delta[0];
          }
          lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
          if (lv > 0) {
            int il = lv;
            if (sharpness > 0) {
              il >>= sharpness > 4 ? 2 : 1;
              if (il > 9 - sharpness) il = 9 - sharpness;
            }
            if (il < 1) il = 1;
            f.ilevel = il;
            f.limit = 2 * lv + il;
            f.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
          } else {
            f.limit = 0;
          }
          f.inner = i4;
        }
      }
    }
  }

  // GetCoeffs: the coefficients of one block from position n, dequantised
  // into out (natural order); returns the position after the last one read
  int coeffs(BoolReader& tb, int type, int ctx, const int* q, int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!tb.bit(p[0])) return n;
      while (!tb.bit(p[1])) {
        p = proba[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!tb.bit(p[2])) {
        v = 1;
        p = proba[type][kBands[n + 1]][1];
      } else {
        if (!tb.bit(p[3])) {
          if (!tb.bit(p[4])) v = 2;
          else v = 3 + tb.bit(p[5]);
        } else if (!tb.bit(p[6])) {
          if (!tb.bit(p[7])) {
            v = 5 + tb.bit(159);
          } else {
            v = 7 + 2 * tb.bit(165);
            v += tb.bit(145);
          }
        } else {
          const int bit1 = tb.bit(p[8]);
          const int bit0 = tb.bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tb.bit(*tab);
          v += 3 + (8 << cat);
        }
        p = proba[type][kBands[n + 1]][2];
      }
      const int sign = tb.bit(0x80);
      out[kZigzag[n]] = (int16_t)((sign ? -v : v) * q[n > 0]);
    }
    return 16;
  }

  // (h, w, 3) BGR of the frame
  void decode(const uint8_t* data, size_t n, int w, int h, uint8_t* bgr) {
    parse_header(data, n);
    if (width != w || height != h) fail("VP8: size differs from the container's");
    if (width == 0 || height == 0) fail("VP8: empty frame");
    const int yw = mb_w * 16, uvw = mb_w * 8;
    std::vector<uint8_t> Y((size_t)yw * mb_h * 16), U((size_t)uvw * mb_h * 8), V(U.size());
    std::vector<uint8_t> top_y((size_t)yw), top_u((size_t)uvw), top_v((size_t)uvw);
    std::vector<uint8_t> intra_t((size_t)4 * mb_w, DC_PRED);
    std::vector<MBInfo> nz_top(mb_w);
    memset(nz_top.data(), 0, nz_top.size() * sizeof(MBInfo));
    std::vector<FInfo> finfo((size_t)mb_w * mb_h);
    std::vector<uint8_t> work(BPS * 17 + BPS * 9 + 64, 0);
    uint8_t* const yb = work.data() + Y_OFF;
    uint8_t* const ub = work.data() + U_OFF;
    uint8_t* const vb = work.data() + V_OFF;
    struct MBData {
      int segment, skip, is_i4;
      uint8_t imodes[16];
      int uvmode;
    };
    std::vector<MBData> row_modes(mb_w);
    alignas(16) int16_t coeffs_buf[384];

    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      // intra modes of the row (first partition)
      uint8_t intra_l[4] = {DC_PRED, DC_PRED, DC_PRED, DC_PRED};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& b = row_modes[mb_x];
        uint8_t* top = &intra_t[4 * mb_x];
        b.segment = update_map ? (!br.bit(seg_proba[0]) ? br.bit(seg_proba[1])
                                                        : br.bit(seg_proba[2]) + 2)
                               : 0;
        b.skip = use_skip ? br.bit(skip_p) : 0;
        b.is_i4 = !br.bit(145);
        if (!b.is_i4) {
          const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                        : (br.bit(163) ? V_PRED : DC_PRED);
          b.imodes[0] = (uint8_t)ymode;
          memset(top, ymode, 4);
          memset(intra_l, ymode, 4);
        } else {
          uint8_t* modes = b.imodes;
          for (int y = 0; y < 4; ++y) {
            int ymode = intra_l[y];
            for (int x = 0; x < 4; ++x) {
              const uint8_t* prob = kBModesProba[top[x]][ymode];
              if (!br.bit(prob[0])) ymode = 0;
              else if (!br.bit(prob[1])) ymode = 1;
              else if (!br.bit(prob[2])) ymode = 2;
              else if (!br.bit(prob[3])) ymode = !br.bit(prob[4]) ? 3 : !br.bit(prob[5]) ? 4 : 5;
              else if (!br.bit(prob[6])) ymode = 6;
              else if (!br.bit(prob[7])) ymode = 7;
              else ymode = !br.bit(prob[8]) ? 8 : 9;
              top[x] = (uint8_t)ymode;
            }
            memcpy(modes, top, 4);
            modes += 4;
            intra_l[y] = (uint8_t)ymode;
          }
        }
        b.uvmode = !br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED;
      }
      if (br.eof) fail("VP8: premature end of partition 0");

      BoolReader& tb = parts[mb_y & (num_parts - 1)];
      MBInfo nz_left;
      memset(&nz_left, 0, sizeof(nz_left));
      // borders of the work buffer for this row
      for (int j = 0; j < 16; ++j) yb[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) ub[j * BPS - 1] = vb[j * BPS - 1] = 129;
      if (mb_y > 0) {
        yb[-1 - BPS] = ub[-1 - BPS] = vb[-1 - BPS] = 129;
      } else {
        memset(yb - BPS - 1, 127, 16 + 4 + 1);
        memset(ub - BPS - 1, 127, 8 + 1);
        memset(vb - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const MBData& b = row_modes[mb_x];
        MBInfo& nt = nz_top[mb_x];
        const int* q = dq[b.segment];
        memset(coeffs_buf, 0, sizeof(coeffs_buf));
        bool any = false;  // ParseResiduals' non-zero bits
        bool coded[24] = {false};  // blocks with a coefficient to transform
        if (!b.skip) {
          int first, ac_type;
          if (!b.is_i4) {
            int16_t dc[16] = {0};
            const int ctx = nt.nz[8] + nz_left.nz[8];
            const int nz = coeffs(tb, 1, ctx, q + 2, 0, dc);
            nt.nz[8] = nz_left.nz[8] = nz > 0;
            if (nz > 1) {
              transform_wht(dc, coeffs_buf);
            } else {
              const int dc0 = (dc[0] + 3) >> 3;
              for (int i = 0; i < 256; i += 16) coeffs_buf[i] = (int16_t)dc0;
            }
            for (int k = 0; k < 16; ++k) coded[k] = coeffs_buf[16 * k] != 0;
            first = 1;
            ac_type = 0;
          } else {
            first = 0;
            ac_type = 3;
          }
          for (int y = 0; y < 4; ++y) {
            int l = nz_left.nz[y];
            for (int x = 0; x < 4; ++x) {
              int16_t* dst = coeffs_buf + 16 * (4 * y + x);
              const int ctx = l + nt.nz[x];
              const int nz = coeffs(tb, ac_type, ctx, q, first, dst);
              l = nz > first;
              nt.nz[x] = (uint8_t)l;
              if (nz > 1 || dst[0] != 0) any = coded[4 * y + x] = true;
            }
            nz_left.nz[y] = (uint8_t)l;
          }
          for (int ch = 0; ch < 2; ++ch) {
            for (int y = 0; y < 2; ++y) {
              int l = nz_left.nz[4 + 2 * ch + y];
              for (int x = 0; x < 2; ++x) {
                int16_t* dst = coeffs_buf + 256 + 64 * ch + 16 * (2 * y + x);
                const int ctx = l + nt.nz[4 + 2 * ch + x];
                const int nz = coeffs(tb, 2, ctx, q + 4, 0, dst);
                l = nz > 0;
                nt.nz[4 + 2 * ch + x] = (uint8_t)l;
                if (nz > 1 || dst[0] != 0) any = coded[16 + 4 * ch + 2 * y + x] = true;
              }
              nz_left.nz[4 + 2 * ch + y] = (uint8_t)l;
            }
          }
        } else {
          for (int i = 0; i < 8; ++i) nt.nz[i] = nz_left.nz[i] = 0;
          if (!b.is_i4) nt.nz[8] = nz_left.nz[8] = 0;
        }
        if (tb.eof) fail("VP8: premature end of the token data");
        if (filter_type > 0) {
          FInfo f = fstrengths[b.segment][b.is_i4];
          f.inner = f.inner || (!b.skip && any);
          finfo[(size_t)mb_y * mb_w + mb_x] = f;
        }

        // reconstruction in the work buffer
        if (mb_x > 0) {
          for (int j = -1; j < 16; ++j) memcpy(yb + j * BPS - 4, yb + j * BPS + 12, 4);
          for (int j = -1; j < 8; ++j) {
            memcpy(ub + j * BPS - 4, ub + j * BPS + 4, 4);
            memcpy(vb + j * BPS - 4, vb + j * BPS + 4, 4);
          }
        }
        if (mb_y > 0) {
          memcpy(yb - BPS, &top_y[16 * mb_x], 16);
          memcpy(ub - BPS, &top_u[8 * mb_x], 8);
          memcpy(vb - BPS, &top_v[8 * mb_x], 8);
        }
        if (b.is_i4) {
          uint8_t* top_right = yb - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w - 1) memset(top_right, top_y[16 * mb_x + 15], 4);
            else memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
          }
          for (int r = 1; r <= 3; ++r) memcpy(top_right + r * 4 * BPS, top_right, 4);
          for (int k = 0; k < 16; ++k) {
            uint8_t* dst = yb + kScan[k];
            predict4(dst, b.imodes[k]);
            if (coded[k]) transform(coeffs_buf + 16 * k, dst);
          }
        } else {
          predict_block(yb, 16, b.imodes[0], mb_y > 0, mb_x > 0);
          for (int k = 0; k < 16; ++k)
            if (coded[k]) transform(coeffs_buf + 16 * k, yb + kScan[k]);
        }
        predict_block(ub, 8, b.uvmode, mb_y > 0, mb_x > 0);
        predict_block(vb, 8, b.uvmode, mb_y > 0, mb_x > 0);
        static const int kUV[4] = {0, 4, 4 * BPS, 4 * BPS + 4};
        for (int k = 0; k < 4; ++k) {
          if (coded[16 + k]) transform(coeffs_buf + 256 + 16 * k, ub + kUV[k]);
          if (coded[20 + k]) transform(coeffs_buf + 320 + 16 * k, vb + kUV[k]);
        }
        if (mb_y < mb_h - 1) {
          memcpy(&top_y[16 * mb_x], yb + 15 * BPS, 16);
          memcpy(&top_u[8 * mb_x], ub + 7 * BPS, 8);
          memcpy(&top_v[8 * mb_x], vb + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j)
          memcpy(&Y[(size_t)(mb_y * 16 + j) * yw + mb_x * 16], yb + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
          memcpy(&U[(size_t)(mb_y * 8 + j) * uvw + mb_x * 8], ub + j * BPS, 8);
          memcpy(&V[(size_t)(mb_y * 8 + j) * uvw + mb_x * 8], vb + j * BPS, 8);
        }
      }
    }

    // loop filter, macroblocks in raster order
    if (filter_type > 0) {
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
          const FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
          if (f.limit == 0) continue;
          uint8_t* yd = &Y[(size_t)mb_y * 16 * yw + mb_x * 16];
          if (filter_type == 1) {
            if (mb_x > 0) simple_edge(yd, 1, yw, f.limit + 4);
            if (f.inner)
              for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k, 1, yw, f.limit);
            if (mb_y > 0) simple_edge(yd, yw, 1, f.limit + 4);
            if (f.inner)
              for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k * yw, yw, 1, f.limit);
          } else {
            uint8_t* ud = &U[(size_t)mb_y * 8 * uvw + mb_x * 8];
            uint8_t* vd = &V[(size_t)mb_y * 8 * uvw + mb_x * 8];
            const int il = f.ilevel, ht = f.hev_thresh;
            if (mb_x > 0) {
              loop26(yd, 1, yw, 16, f.limit + 4, il, ht);
              loop26(ud, 1, uvw, 8, f.limit + 4, il, ht);
              loop26(vd, 1, uvw, 8, f.limit + 4, il, ht);
            }
            if (f.inner) {
              for (int k = 1; k < 4; ++k) loop24(yd + 4 * k, 1, yw, 16, f.limit, il, ht);
              loop24(ud + 4, 1, uvw, 8, f.limit, il, ht);
              loop24(vd + 4, 1, uvw, 8, f.limit, il, ht);
            }
            if (mb_y > 0) {
              loop26(yd, yw, 1, 16, f.limit + 4, il, ht);
              loop26(ud, uvw, 1, 8, f.limit + 4, il, ht);
              loop26(vd, uvw, 1, 8, f.limit + 4, il, ht);
            }
            if (f.inner) {
              for (int k = 1; k < 4; ++k) loop24(yd + 4 * k * yw, yw, 1, 16, f.limit, il, ht);
              loop24(ud + 4 * uvw, uvw, 1, 8, f.limit, il, ht);
              loop24(vd + 4 * uvw, uvw, 1, 8, f.limit, il, ht);
            }
          }
        }
    }
    upsample(Y.data(), yw, U.data(), V.data(), uvw, bgr);
  }

  static inline int mult_hi(int v, int c) { return (v * c) >> 8; }
  static inline uint8_t yuv_clip8(int v) {
    return ((v & ~16383) == 0) ? (uint8_t)(v >> 6) : (v < 0) ? 0 : 255;
  }
  static inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
    bgr[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
    bgr[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    bgr[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  }

  // libwebp's UpsampleBgrLinePair: two output rows from two luma rows and
  // the chroma rows above (top) and below (cur) them
  void line_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* tu, const uint8_t* tv,
                 const uint8_t* cu, const uint8_t* cv, uint8_t* top_dst, uint8_t* bot_dst) const {
    const int len = width;
    const int last_pair = (len - 1) >> 1;
    uint32_t tl_uv = tu[0] | (tv[0] << 16);
    uint32_t l_uv = cu[0] | (cv[0] << 16);
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_bgr(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
    }
    if (bot_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_bgr(bot_y[0], uv0 & 0xff, uv0 >> 16, bot_dst);
    }
    for (int x = 1; x <= last_pair; ++x) {
      const uint32_t t_uv = tu[x] | (tv[x] << 16);
      const uint32_t uv = cu[x] | (cv[x] << 16);
      const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
      const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
      const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
      {
        const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
        const uint32_t uv1 = (diag_03 + t_uv) >> 1;
        yuv_to_bgr(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, top_dst + (2 * x - 1) * 3);
        yuv_to_bgr(top_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff, top_dst + (2 * x) * 3);
      }
      if (bot_y) {
        const uint32_t uv0 = (diag_03 + l_uv) >> 1;
        const uint32_t uv1 = (diag_12 + uv) >> 1;
        yuv_to_bgr(bot_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16) & 0xff, bot_dst + (2 * x - 1) * 3);
        yuv_to_bgr(bot_y[2 * x], uv1 & 0xff, (uv1 >> 16) & 0xff, bot_dst + (2 * x) * 3);
      }
      tl_uv = t_uv;
      l_uv = uv;
    }
    if (!(len & 1)) {
      {
        const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_bgr(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 3);
      }
      if (bot_y) {
        const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_bgr(bot_y[len - 1], uv0 & 0xff, uv0 >> 16, bot_dst + (len - 1) * 3);
      }
    }
  }

  void upsample(const uint8_t* Y, int ys, const uint8_t* U, const uint8_t* V, int uvs,
                uint8_t* bgr) const {
    const size_t row = (size_t)width * 3;
    line_pair(Y, nullptr, U, V, U, V, bgr, nullptr);
    int k = 1;
    for (; 2 * k < height; ++k)
      line_pair(Y + (size_t)(2 * k - 1) * ys, Y + (size_t)(2 * k) * ys, U + (size_t)(k - 1) * uvs,
                V + (size_t)(k - 1) * uvs, U + (size_t)k * uvs, V + (size_t)k * uvs,
                bgr + (2 * k - 1) * row, bgr + (2 * k) * row);
    if (!(height & 1)) {
      const int c = height / 2 - 1;
      line_pair(Y + (size_t)(height - 1) * ys, nullptr, U + (size_t)c * uvs, V + (size_t)c * uvs,
                U + (size_t)c * uvs, V + (size_t)c * uvs, bgr + (height - 1) * row, nullptr);
    }
  }
};

int report(const CodecError& e, char* msg, int msg_len) {
  if (msg && msg_len > 0) snprintf(msg, msg_len, "%s", e.msg.c_str());
  return e.status;
}

}  // namespace

extern "C" {

// Decode a VP8L bitstream (data[0:n], the payload of a "VP8L" chunk) of
// (w, h) into out, (h, w, 3) BGR uint8. Returns 0, or 1 with msg saying why.
int ayolo_vp8l_decode(const uint8_t* data, int64_t n, int w, int h, uint8_t* out, char* msg,
                      int msg_len) {
  try {
    VP8LDecoder d(data, (size_t)n);
    d.decode(w, h, out);
    return 0;
  } catch (const CodecError& e) {
    return report(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(CodecError{1, "out of memory"}, msg, msg_len);
  }
}

// Decode a VP8 key frame (data[0:n], the payload of a "VP8 " chunk) of (w, h)
// into out, (h, w, 3) BGR uint8. Returns 0, or 1 with msg saying why.
int ayolo_vp8_decode(const uint8_t* data, int64_t n, int w, int h, uint8_t* out, char* msg,
                     int msg_len) {
  try {
    VP8Decoder d;
    d.decode(data, (size_t)n, w, h, out);
    return 0;
  } catch (const CodecError& e) {
    return report(e, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(CodecError{1, "out of memory"}, msg, msg_len);
  }
}

}  // extern "C"
