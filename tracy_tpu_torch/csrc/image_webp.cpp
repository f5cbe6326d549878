// WebP decoding on the host, for the texture loader and read_image: lossy
// VP8 key frames (with an ALPH chunk's alpha), lossless VP8L, and the
// first frame of an animation, as PIL's open(...).convert("RGBA") gives
// them (PIL decodes every WebP through libwebp's WebPAnimDecoder, with
// fancy upsampling on and no dithering).
//
// Built into the same library as image_decode.cpp (utils/native.py::
// get_image_lib), with its conventions: `tracy_webp_info` (width and
// height) and `tracy_webp_decode` (RGBA8 [h, w, 4]) return 0, 1 for a
// fault of the file, or 2 for a failure inside the decoder, with the
// message in tracy_decode_error(). No zlib: VP8L has its own prefix and
// LZ77 coding.
//
// What libwebp computes, bit for bit:
//
// Container: RIFF chunks with odd-size padding, read only up to the RIFF
//   size (a file shorter than that is refused, as libwebp's demuxer
//   refuses it); simple files (one VP8 or VP8L chunk) and VP8X files, whose
//   24-bit canvas size and flags are read and whose ICCP, EXIF, XMP and
//   unknown chunks are skipped. The demuxer's checks are kept: every frame
//   fits its canvas (a still exactly), ALPH precedes its image, VP8L takes
//   no ALPH, ANIM precedes ANMF. An animation gives its first frame only,
//   on a canvas of transparent black at the frame's offset (2X, 2Y), not
//   blended and without the background colour (libwebp's anim_decode.c).
//   Without the VP8X alpha flag (simple files: without the VP8L alpha
//   hint) alpha is 255, as PIL's RGBX mode gives it; a VP8X still's ALPH
//   chunk is then dropped, as the demuxer drops it.
// VP8L: the 14-bit size header; the predictor (all 14 modes, and 14 and 15
//   as 0; row 0 from the left, column 0 from the top, the top-right of the
//   last column the row's first pixel), cross-colour, subtract-green and
//   colour-indexing transforms (pixels bundled 8, 4 or 2 to a byte at 2, 4
//   and 16 colours; indices past the palette black transparent); the
//   colour cache (1-11 bits); meta prefix codes from the entropy image;
//   simple (1-2 symbol) and normal codes through code-length codes, a code
//   of one symbol taking no bits, incomplete codes refused; LZ77 with the
//   120-entry distance map. Reading past the data is an error.
// VP8: the bool decoder (reading past a partition is an error, as libwebp
//   makes it); segmentation; loop-filter deltas (reference 0 and the B_PRED
//   mode delta, the only ones a key frame uses); 1, 2, 4 or 8 token
//   partitions; token probability updates and mb_no_coeff_skip; the 16x16,
//   B_PRED 4x4 and chroma intra modes with libwebp's edges (127 above, 129
//   left, DC without a missing side); the dequantisation tables with the Y2
//   (x 155/100, at least 8) and UV DC (index at most 117) clamps; the WHT
//   and IDCT in 16-bit coefficients; the normal and simple loop filters
//   with sharpness and the interior, edge and high-edge-variance limits,
//   none when the frame's level is 0 (whatever the segments say); the scale
//   bits read and ignored. YUV to RGB: fancy upsampling (the 9-3-3-1 /16
//   weights in libwebp's rounding, the first and last rows from one chroma
//   row) and libwebp's 14-bit fixed-point VP8YUVToR/G/B.
// ALPH: raw or a headerless VP8L stream (its green channel), the none,
//   horizontal, vertical and gradient filters inverted as dsp/filters.c
//   does; the pre-processing field read and ignored (PIL decodes with
//   alpha dithering 0).
//
// Refused by name: VP8 interframes, frames not shown, a bad start code,
// profiles above 3, truncated data, a frame that does not fit its canvas,
// an animation without frames, sizes beyond kMaxPixels.

#include "image_common.h"

namespace {

// ------------------------------------------------------------ tables

constexpr uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
    18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
    29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
    44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
    59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
    75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
    91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

constexpr uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
    20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
    36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
    78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// Default token probabilities [type 4][band 8][context 3][11] (RFC 6386 13.5).
constexpr uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

// Probabilities of their updates, same layout (RFC 6386 13.4).
constexpr uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// Key-frame 4x4 mode probabilities [top][left][9], in libwebp's mode order
// (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU).
constexpr uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// Band of each coefficient position; the 17th entry serves the position
// after the last.
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// Intra modes in libwebp's order; the 4x4 ones and, for 16x16 and chroma,
// DC, TM, V and H, with DC's variants at a missing edge.
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
  B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  DC_PRED_NOTOP = 10, DC_PRED_NOLEFT, DC_PRED_NOTOPLEFT,
};
// The 4x4 mode tree: a leaf is -mode, a node the index of its pair.
constexpr int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED,
};

// VP8L's 120 short distance codes: (dy << 4) | (8 - dx).
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};
constexpr uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                              7,  8,  9, 10, 11, 12, 13, 14, 15};

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// ------------------------------------------------------------ VP8L

// LSB-first bit reader. Past the data it reads zeros and records the
// overrun: libwebp's end-of-stream, which its decoder turns into an error
// (the window is 64 bits, so a stream shorter than 8 bytes may be read to
// its 64th bit).
struct LBits {
  const uint8_t* p;
  size_t n;
  uint64_t pos = 0;

  LBits(const uint8_t* data, size_t len) : p(data), n(len) {}
  bool eos() const { return pos > std::max<uint64_t>(64, uint64_t(n) * 8); }
  uint32_t peek() const {  // the next 32 bits
    const size_t at = pos >> 3;
    uint64_t v = 0;
    if (at + 8 <= n) {
      for (int i = 7; i >= 0; --i) v = v << 8 | p[at + i];
    } else {
      for (int i = 7; i >= 0; --i) v = v << 8 | (at + i < n ? p[at + i] : 0);
    }
    return static_cast<uint32_t>(v >> (pos & 7));
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek() & ((1u << k) - 1);
    pos += k;
    return v;
  }
};

// A canonical prefix code: an 8-bit first-level table (symbol | length <<
// 16; length 0 marks a longer code) and the canonical lists for codes
// longer than 8 bits. A code of a single symbol takes no bits.
struct Huff {
  uint32_t root[256];
  uint16_t count[16];
  std::vector<uint16_t> sorted;
  int single = -1;

  // False where libwebp's BuildHuffmanTable refuses the lengths: all zero,
  // or (for more than one symbol) not a complete code.
  bool build(const int* lengths, int n) {
    std::memset(count, 0, sizeof(count));
    int nonzero = 0, last = 0;
    for (int s = 0; s < n; ++s) {
      ++count[lengths[s]];
      if (lengths[s]) ++nonzero, last = s;
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      single = last;
      return true;
    }
    int64_t kraft = 0;
    for (int l = 1; l < 16; ++l) kraft += int64_t(count[l]) << (15 - l);
    if (kraft != (int64_t(1) << 15)) return false;
    single = -1;
    uint16_t offset[16] = {0};
    for (int l = 1; l < 15; ++l) offset[l + 1] = offset[l] + count[l];
    sorted.assign(nonzero, 0);
    for (int s = 0; s < n; ++s) {
      if (lengths[s]) sorted[offset[lengths[s]]++] = static_cast<uint16_t>(s);
    }
    std::memset(root, 0, sizeof(root));
    uint32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 8; ++l, code <<= 1) {
      for (int i = 0; i < count[l]; ++i, ++code, ++k) {
        uint32_t rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (uint32_t r = rev; r < 256; r += 1u << l) root[r] = sorted[k] | uint32_t(l) << 16;
      }
    }
    return true;
  }

  int read(LBits& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek();
    const uint32_t e = root[bits & 255];
    if (e >> 16) {
      br.pos += e >> 16;
      return e & 0xffff;
    }
    // Canonical decoding, a bit at a time (the stream gives each code's
    // first bit first).
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= (bits >> (l - 1)) & 1;
      const int c = count[l];
      if (code - c < first) {
        br.pos += l;
        return sorted[index + (code - first)];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    fail("WebP: VP8L prefix code overrun");  // unreachable for a complete code
  }
};

enum { GREEN = 0, RED, BLUE, ALPHA, DIST };
constexpr int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};

struct HGroup {
  Huff h[5];
};

struct VP8LDecoder {
  LBits br;
  int transforms_seen = 0;
  struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
  };
  std::vector<Transform> transforms;

  explicit VP8LDecoder(const uint8_t* p, size_t n) : br(p, n) {}

  void check() const {
    if (br.eos()) fail("WebP: VP8L data is truncated");
  }

  static int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

  // ReadHuffmanCode: a simple or a normal code of `alphabet` symbols.
  void read_code(int alphabet, Huff& out) {
    std::vector<int> lengths(std::max(alphabet, 256), 0);
    if (br.read(1)) {  // simple: one or two symbols of length 1
      const int num = br.read(1) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      lengths[br.read(first_bits)] = 1;
      if (num == 2) lengths[br.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
      Huff cl;
      if (!cl.build(cl_lengths, 19)) fail("WebP: VP8L bad code-length code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        const int nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(nbits);
        if (max_symbol > alphabet) fail("WebP: VP8L bad code-length count");
      }
      int prev = 8, sym = 0;
      while (sym < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = cl.read(br);
        if (len < 16) {
          lengths[sym++] = len;
          if (len) prev = len;
        } else {
          const int slot = len - 16;
          const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          const int repeat = br.read(extra[slot]) + offset[slot];
          if (sym + repeat > alphabet) fail("WebP: VP8L code lengths overrun");
          const int v = slot == 0 ? prev : 0;
          for (int i = 0; i < repeat; ++i) lengths[sym++] = v;
        }
      }
    }
    check();
    if (!out.build(lengths.data(), alphabet)) fail("WebP: VP8L incomplete prefix code");
  }

  // One image stream (DecodeImageStream): the transforms at level 0, the
  // colour cache, the codes (meta codes at level 0), then, for a sub-image,
  // its pixels. At level 0 the caller decodes the pixels.
  struct Stream {
    int xsize = 0, ysize = 0;
    int cache_bits = 0;
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;  // group index of each tile
    std::vector<HGroup> groups;
  };

  Stream read_stream_header(int xsize, int ysize, bool level0) {
    Stream s;
    if (level0) {
      while (br.read(1)) read_transform(xsize, ysize);
    }
    if (br.read(1)) {
      s.cache_bits = br.read(4);
      if (s.cache_bits < 1 || s.cache_bits > 11) fail("WebP: VP8L bad colour cache size");
    }
    int num_groups = 1;
    std::vector<int> mapping;
    if (level0 && br.read(1)) {
      s.meta_bits = 2 + br.read(3);
      s.meta_xsize = subsample(xsize, s.meta_bits);
      s.meta = decode_subimage(s.meta_xsize, subsample(ysize, s.meta_bits));
      int max_group = 0;
      for (auto& g : s.meta) {
        g = (g >> 8) & 0xffff;
        max_group = std::max<int>(max_group, g + 1);
      }
      num_groups = max_group;
      if (max_group > 1000 || int64_t(max_group) > int64_t(xsize) * ysize) {
        // Codes of groups no tile uses are read and checked, not kept.
        mapping.assign(max_group, -1);
        num_groups = 0;
        for (auto& g : s.meta) {
          if (mapping[g] < 0) mapping[g] = num_groups++;
          g = mapping[g];
        }
      }
    }
    s.xsize = xsize;
    s.ysize = ysize;
    const int cache_size = s.cache_bits ? 1 << s.cache_bits : 0;
    s.groups.resize(num_groups);
    const int total = mapping.empty() ? num_groups : static_cast<int>(mapping.size());
    HGroup scratch;
    for (int i = 0; i < total; ++i) {
      HGroup& g = mapping.empty() ? s.groups[i] : mapping[i] < 0 ? scratch : s.groups[mapping[i]];
      for (int j = 0; j < 5; ++j) read_code(kAlphabetSize[j] + (j == 0 ? cache_size : 0), g.h[j]);
    }
    return s;
  }

  std::vector<uint32_t> decode_subimage(int xsize, int ysize) {
    Stream s = read_stream_header(xsize, ysize, false);
    std::vector<uint32_t> px(size_t(xsize) * ysize);
    decode_pixels(s, px.data(), false);
    return px;
  }

  void read_transform(int& xsize, int ysize) {
    Transform t;
    t.type = br.read(2);
    if (transforms_seen & (1 << t.type)) fail("WebP: VP8L repeats a transform");
    transforms_seen |= 1 << t.type;
    t.xsize = xsize;
    t.ysize = ysize;
    t.bits = 0;
    if (t.type == 0 || t.type == 1) {  // predictor, cross-colour
      t.bits = 2 + br.read(3);
      t.data = decode_subimage(subsample(xsize, t.bits), subsample(ysize, t.bits));
    } else if (t.type == 3) {  // colour indexing
      const int num_colors = br.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal = decode_subimage(num_colors, 1);
      // Delta-coded palette, expanded to 2^(8 >> bits) entries (black
      // transparent past the last).
      t.data.assign(size_t(1) << (8 >> t.bits), 0);
      t.data[0] = pal[0];
      for (int i = 1; i < num_colors; ++i) {
        const uint32_t a = pal[i], b = t.data[i - 1];
        t.data[i] = (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
                    (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
      }
    }
    transforms.push_back(std::move(t));
  }

  static int copy_value(int symbol, LBits& br) {  // GetCopyDistance/GetCopyLength
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  static int plane_to_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int v = kCodeToPlane[code - 1];
    const int dist = (v >> 4) * xsize + (8 - (v & 0xf));
    return dist >= 1 ? dist : 1;
  }

  // DecodeImageData: literals, backward references and colour-cache hits
  // into `px` (xsize * ysize ARGB). With `tolerate_final_eos` (the alpha
  // plane's 8-bit path), reading past the data while decoding the last
  // pixel is not an error.
  void decode_pixels(const Stream& s, uint32_t* px, bool tolerate_final_eos) {
    const int w = s.xsize;
    const size_t end = size_t(w) * s.ysize;
    const int cache_size = s.cache_bits ? 1 << s.cache_bits : 0;
    std::vector<uint32_t> cache(cache_size);
    size_t pos = 0, cached = 0;
    int col = 0, row = 0;
    auto flush_cache = [&] {
      for (; cached < pos; ++cached) {
        cache[(px[cached] * 0x1e35a7bdu) >> (32 - s.cache_bits)] = px[cached];
      }
    };
    auto group_at = [&](int x, int y) -> const HGroup* {
      if (s.meta_bits == 0) return &s.groups[0];
      return &s.groups[s.meta[size_t(y >> s.meta_bits) * s.meta_xsize + (x >> s.meta_bits)]];
    };
    while (pos < end) {
      const HGroup* g = group_at(col, row);
      const int code = g->h[GREEN].read(br);
      if (code < 256) {
        const int red = g->h[RED].read(br);
        const int blue = g->h[BLUE].read(br);
        const int alpha = g->h[ALPHA].read(br);
        px[pos++] = uint32_t(alpha) << 24 | uint32_t(red) << 16 | uint32_t(code) << 8 | blue;
        if (++col >= w) col = 0, ++row;
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256, br);
        const int dsym = g->h[DIST].read(br);
        const int dist = plane_to_distance(w, copy_value(dsym, br));
        if (br.eos() && !(tolerate_final_eos && pos + length >= end)) check();
        if (pos < size_t(dist) || end - pos < size_t(length)) {
          fail("WebP: VP8L backward reference out of the image");
        }
        for (int i = 0; i < length; ++i, ++pos) px[pos] = px[pos - dist];
        col += length;
        while (col >= w) col -= w, ++row;
      } else {
        const int key = code - 256 - 24;
        if (key >= cache_size) fail("WebP: VP8L bad symbol");
        flush_cache();
        px[pos++] = cache[key];
        if (++col >= w) col = 0, ++row;
      }
      if (cache_size) flush_cache();
      if (br.eos() && !(tolerate_final_eos && pos >= end)) check();
    }
  }

  // The inverse transforms, last read first, on the whole image.
  void inverse_transforms(std::vector<uint32_t>& img, int height) const {
    std::vector<uint32_t> out;
    for (int n = static_cast<int>(transforms.size()) - 1; n >= 0; --n) {
      const Transform& t = transforms[n];
      const int w = t.xsize;
      if (t.type == 0) {
        predictor_inverse(t, img.data(), w, height);
      } else if (t.type == 1) {
        const int tiles = subsample(w, t.bits);
        for (int y = 0; y < height; ++y) {
          for (int x = 0; x < w; ++x) {
            const uint32_t m = t.data[size_t(y >> t.bits) * tiles + (x >> t.bits)];
            const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff),
                         r2b = int8_t((m >> 16) & 0xff);
            uint32_t& p = img[size_t(y) * w + x];
            const int8_t green = int8_t(p >> 8);
            int r = (p >> 16) & 0xff, b = p & 0xff;
            r = (r + ((int(g2r) * green) >> 5)) & 0xff;
            b += (int(g2b) * green) >> 5;
            b = (b + ((int(r2b) * int8_t(r)) >> 5)) & 0xff;
            p = (p & 0xff00ff00u) | uint32_t(r) << 16 | uint32_t(b);
          }
        }
      } else if (t.type == 2) {
        for (auto& p : img) {
          const uint32_t green = (p >> 8) & 0xff;
          const uint32_t rb = ((p & 0x00ff00ffu) + (green << 16 | green)) & 0x00ff00ffu;
          p = (p & 0xff00ff00u) | rb;
        }
      } else {
        const int packed_w = subsample(w, t.bits);
        out.assign(size_t(w) * height, 0);
        const int per_byte_bits = 8 >> t.bits;
        const uint32_t mask = (1u << per_byte_bits) - 1;
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = img.data() + size_t(y) * packed_w;
          uint32_t* dst = out.data() + size_t(y) * w;
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & ((1 << t.bits) - 1)) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & mask];
            packed >>= per_byte_bits;
          }
        }
        img.swap(out);
      }
    }
  }

  static uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static uint32_t add_pixels(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
  }
  static int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
    int d = 0;
    for (int sh = 0; sh < 32; sh += 8) d += sub3((a >> sh) & 0xff, (b >> sh) & 0xff, (c >> sh) & 0xff);
    return d <= 0 ? a : b;
  }
  static uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int sh = 0; sh < 32; sh += 8) {
      const int v = int((c0 >> sh) & 0xff) + int((c1 >> sh) & 0xff) - int((c2 >> sh) & 0xff);
      out |= uint32_t(clip255(v)) << sh;
    }
    return out;
  }
  static uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = average2(c0, c1);
    uint32_t out = 0;
    for (int sh = 0; sh < 32; sh += 8) {
      const int a = (ave >> sh) & 0xff, b = (c2 >> sh) & 0xff;
      out |= uint32_t(clip255(a + (a - b) / 2)) << sh;
    }
    return out;
  }
  static uint32_t predict(int mode, const uint32_t* left, const uint32_t* top) {
    switch (mode) {
      case 1: return *left;
      case 2: return top[0];
      case 3: return top[1];
      case 4: return top[-1];
      case 5: return average2(average2(*left, top[1]), top[0]);
      case 6: return average2(*left, top[-1]);
      case 7: return average2(*left, top[0]);
      case 8: return average2(top[-1], top[0]);
      case 9: return average2(top[0], top[1]);
      case 10: return average2(average2(*left, top[-1]), average2(top[0], top[1]));
      case 11: return select(top[0], *left, top[-1]);
      case 12: return clamped_full(*left, top[0], top[-1]);
      case 13: return clamped_half(*left, top[0], top[-1]);
      default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
    }
  }

  // In place: row 0 from the left (its first pixel from black), column 0
  // from the top; the top-right of a row's last pixel is its own first.
  static void predictor_inverse(const Transform& t, uint32_t* img, int w, int h) {
    img[0] = add_pixels(img[0], 0xff000000u);
    for (int x = 1; x < w; ++x) img[x] = add_pixels(img[x], img[x - 1]);
    const int tiles = subsample(w, t.bits);
    for (int y = 1; y < h; ++y) {
      uint32_t* row = img + size_t(y) * w;
      const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * tiles;
      row[0] = add_pixels(row[0], row[-w]);
      for (int x = 1; x < w; ++x) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        row[x] = add_pixels(row[x], predict(mode, row + x - 1, row + x - w));
      }
    }
  }
};

struct Vp8lInfo {
  int64_t w, h;
  bool alpha;
};

// VP8LGetInfo: the signature byte, 14-bit sizes, the alpha hint, version 0.
Vp8lInfo vp8l_info(const uint8_t* p, size_t n) {
  if (n < 5 || p[0] != 0x2f) fail("WebP: bad VP8L signature");
  if ((p[4] >> 5) != 0) fail("WebP: VP8L version is not 0");
  LBits br(p, n);
  br.read(8);
  Vp8lInfo info;
  info.w = br.read(14) + 1;
  info.h = br.read(14) + 1;
  info.alpha = br.read(1);
  return info;
}

// A VP8L image as ARGB [h, w].
std::vector<uint32_t> vp8l_decode(const uint8_t* p, size_t n, int w, int h) {
  VP8LDecoder dec(p, n);
  dec.br.pos = 8 + 14 + 14 + 1 + 3;  // the header, read by vp8l_info
  auto s = dec.read_stream_header(w, h, true);
  std::vector<uint32_t> img(size_t(s.xsize) * h);
  dec.decode_pixels(s, img.data(), false);
  dec.check();
  dec.inverse_transforms(img, h);
  return img;
}

// ------------------------------------------------------------ VP8

// The boolean entropy decoder, as libwebp's VP8BitReader (range kept minus
// one, a byte loaded when the window runs dry): reading past the
// partition shifts in zeros once and marks it, an error for the decoder.
struct BoolReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* start, size_t n) {
    p = start;
    end = start + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (p < end) {
      bits += 8;
      value = value << 8 | *p++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * uint32_t(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= uint64_t(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  uint32_t literal(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= uint32_t(get(0x80)) << n;
    return v;
  }
  int signed_literal(int n) {
    const int v = static_cast<int>(literal(n));
    return get(0x80) ? -v : v;
  }
};

constexpr int BPS = 32;  // stride of the reconstruction buffer
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS) {
    for (int x = 0; x < size; ++x) dst[x] = static_cast<uint8_t>(clip255(top[x] + dst[-1] - top[-1]));
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) prediction.
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, size, dc >> (shift + 1));
      break;
    }
    case DC_PRED_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_PRED_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_PRED_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, v, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
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
    case B_VL_PRED:
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
    case B_HD_PRED:
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
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
  }
}

#undef DST

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The inverse DCT of one 4x4 block, added to the prediction (TransformOne;
// libwebp's DC-only and three-coefficient shortcuts give the same bytes).
void idct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i, dst += BPS) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    dst[0] = static_cast<uint8_t>(clip255(dst[0] + ((a + d) >> 3)));
    dst[1] = static_cast<uint8_t>(clip255(dst[1] + ((b + c) >> 3)));
    dst[2] = static_cast<uint8_t>(clip255(dst[2] + ((b - c) >> 3)));
    dst[3] = static_cast<uint8_t>(clip255(dst[3] + ((a - d) >> 3)));
  }
}

// The inverse Walsh-Hadamard transform of the Y2 block into the DC of the
// 16 luma blocks (int16, as libwebp keeps them).
void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

// ---- loop filter (dsp/dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = static_cast<uint8_t>(clip255(p0 + a2));
  p[0] = static_cast<uint8_t>(clip255(q0 - a1));
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = static_cast<uint8_t>(clip255(p1 + a3));
  p[-step] = static_cast<uint8_t>(clip255(p0 + a2));
  p[0] = static_cast<uint8_t>(clip255(q0 - a1));
  p[step] = static_cast<uint8_t>(clip255(q1 - a3));
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = static_cast<uint8_t>(clip255(p2 + a3));
  p[-2 * step] = static_cast<uint8_t>(clip255(p1 + a2));
  p[-step] = static_cast<uint8_t>(clip255(p0 + a1));
  p[0] = static_cast<uint8_t>(clip255(q0 - a1));
  p[step] = static_cast<uint8_t>(clip255(q1 - a2));
  p[2 * step] = static_cast<uint8_t>(clip255(q2 - a3));
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// Simple filter across one edge of 16 pixels: `step` across the edge,
// `stride` along it.
void simple_filter(uint8_t* p, int step, int stride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * stride, step, t2)) do_filter2(p + i * stride, step);
  }
}

// Normal filter: `six` on macroblock edges (6 taps), else the inner 4.
void filter_loop(uint8_t* p, int step, int stride, int size, int thresh, int ithresh,
                 int hev_thresh, bool six) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += stride) {
    if (!needs_filter2(p, step, t2, ithresh)) continue;
    if (hev(p, step, hev_thresh)) {
      do_filter2(p, step);
    } else if (six) {
      do_filter6(p, step);
    } else {
      do_filter4(p, step);
    }
  }
}

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct Vp8Frame {
  int width = 0, height = 0;
  std::vector<uint8_t> y, u, v;  // whole macroblocks
  int y_stride = 0, uv_stride = 0;
};

struct Vp8Info {
  int64_t w, h;
};

// VP8GetInfo: a shown key frame of profile 0-3 with the start code, whose
// first partition fits the chunk.
Vp8Info vp8_info(const uint8_t* p, size_t n, size_t chunk_size) {
  if (n < 10) fail("WebP: VP8 data is truncated");
  if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a) fail("WebP: bad VP8 start code");
  const uint32_t bits = p[0] | p[1] << 8 | p[2] << 16;
  if (bits & 1) fail("WebP: VP8 interframe (not a key frame) not read");
  if (((bits >> 1) & 7) > 3) fail("WebP: VP8 profile above 3 not read");
  if (!((bits >> 4) & 1)) fail("WebP: VP8 frame not shown");
  if ((bits >> 5) >= chunk_size) fail("WebP: VP8 partition 0 is truncated (past its chunk)");
  const int w = (p[7] << 8 | p[6]) & 0x3fff, h = (p[9] << 8 | p[8]) & 0x3fff;
  if (w == 0 || h == 0) fail("WebP: VP8 size is 0");
  return {w, h};
}

struct Vp8Decoder {
  // headers
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segment_probs[3] = {255, 255, 255};
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int num_parts = 1;
  BoolReader br, parts[8];
  struct Quant {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];

  // per macroblock of the current row
  struct MB {
    int segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
    uint8_t imodes[16];
    int16_t coeffs[384];
    uint32_t non_zero_y = 0, non_zero_uv = 0;
  };

  void parse_headers(const uint8_t* data, size_t size) {
    if (size < 10) fail("WebP: VP8 data is truncated");
    const uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
    const uint32_t part0 = bits >> 5;
    width = (data[7] << 8 | data[6]) & 0x3fff;  // the top 2 bits: scale, ignored
    height = (data[9] << 8 | data[8]) & 0x3fff;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    data += 10;
    size -= 10;
    if (part0 > size) fail("WebP: VP8 partition 0 is truncated");
    br.init(data, part0);
    data += part0;
    size -= part0;

    br.get(0x80);  // colour space
    br.get(0x80);  // clamping type
    use_segment = br.get(0x80);
    if (use_segment) {
      update_map = br.get(0x80);
      if (br.get(0x80)) {  // update segment data
        absolute_delta = br.get(0x80);
        for (int s = 0; s < 4; ++s) quantizer[s] = br.get(0x80) ? br.signed_literal(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength[s] = br.get(0x80) ? br.signed_literal(6) : 0;
      }
      if (update_map) {
        for (int s = 0; s < 3; ++s) {
          segment_probs[s] = br.get(0x80) ? static_cast<uint8_t>(br.literal(8)) : 255;
        }
      }
    }
    if (br.eof) fail("WebP: VP8 segment header is truncated");
    simple = br.get(0x80);
    level = br.literal(6);
    sharpness = br.literal(3);
    use_lf_delta = br.get(0x80);
    if (use_lf_delta && br.get(0x80)) {
      for (int i = 0; i < 4; ++i) {
        if (br.get(0x80)) ref_lf_delta[i] = br.signed_literal(6);
      }
      for (int i = 0; i < 4; ++i) {
        if (br.get(0x80)) mode_lf_delta[i] = br.signed_literal(6);
      }
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) fail("WebP: VP8 filter header is truncated");

    // token partitions: 3-byte sizes of all but the last, which takes the rest
    num_parts = 1 << br.literal(2);
    const size_t last = num_parts - 1;
    if (size < 3 * last) fail("WebP: VP8 partition sizes are truncated");
    const uint8_t* sz = data;
    const uint8_t* start = data + 3 * last;
    size_t left = size - 3 * last;
    for (size_t i = 0; i < last; ++i, sz += 3) {
      size_t psize = sz[0] | sz[1] << 8 | sz[2] << 16;
      if (psize > left) psize = left;
      parts[i].init(start, psize);
      start += psize;
      left -= psize;
    }
    if (left == 0) fail("WebP: VP8 last partition is truncated (empty)");
    parts[last].init(start, left);

    // quantisers
    const int base_q0 = br.literal(7);
    const int dqy1_dc = br.get(0x80) ? br.signed_literal(4) : 0;
    const int dqy2_dc = br.get(0x80) ? br.signed_literal(4) : 0;
    const int dqy2_ac = br.get(0x80) ? br.signed_literal(4) : 0;
    const int dquv_dc = br.get(0x80) ? br.signed_literal(4) : 0;
    const int dquv_ac = br.get(0x80) ? br.signed_literal(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i] + (absolute_delta ? 0 : base_q0);
      } else if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }

    br.get(0x80);  // refresh entropy probs: ignored for a key frame
    for (int t = 0; t < 4; ++t) {
      for (int b = 0; b < 8; ++b) {
        for (int c = 0; c < 3; ++c) {
          for (int p = 0; p < 11; ++p) {
            const int k = ((t * 8 + b) * 3 + c) * 11 + p;
            proba[t][b][c][p] = br.get(kCoeffsUpdateProba[k]) ? static_cast<uint8_t>(br.literal(8))
                                                               : kCoeffsProba0[k];
          }
        }
      }
    }
    use_skip_proba = br.get(0x80);
    if (use_skip_proba) skip_p = br.literal(8);

    // filter strengths of each segment, without and with B_PRED
    if (filter_type > 0) {
      for (int s = 0; s < 4; ++s) {
        int base = level;
        if (use_segment) base = filter_strength[s] + (absolute_delta ? 0 : level);
        for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
          FInfo& info = fstrengths[s][i4x4];
          int lv = base;
          if (use_lf_delta) {
            lv += ref_lf_delta[0];
            if (i4x4) lv += mode_lf_delta[0];
          }
          lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
          if (lv > 0) {
            int ilevel = lv;
            if (sharpness > 0) {
              ilevel >>= sharpness > 4 ? 2 : 1;
              if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
            }
            if (ilevel < 1) ilevel = 1;
            info.ilevel = static_cast<uint8_t>(ilevel);
            info.limit = static_cast<uint8_t>(2 * lv + ilevel);
            info.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
          } else {
            info.limit = 0;
          }
          info.inner = static_cast<uint8_t>(i4x4);
        }
      }
    }
  }

  void parse_intra(MB& mb, uint8_t* top, uint8_t* left) {
    if (update_map) {
      mb.segment = !br.get(segment_probs[0]) ? br.get(segment_probs[1])
                                             : br.get(segment_probs[2]) + 2;
    } else {
      mb.segment = 0;
    }
    mb.skip = use_skip_proba ? br.get(skip_p) : 0;
    mb.is_i4x4 = !br.get(145);
    if (!mb.is_i4x4) {
      const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED)
                                    : (br.get(163) ? V_PRED : DC_PRED);
      mb.imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
          int i = kYModesIntra4[br.get(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
          ymode = -i;
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    mb.uvmode = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
  }

  static int large_value(BoolReader& r, const uint8_t* p) {
    if (!r.get(p[3])) {
      if (!r.get(p[4])) return 2;
      return 3 + r.get(p[5]);
    }
    if (!r.get(p[6])) {
      if (!r.get(p[7])) return 5 + r.get(159);
      int v = 7 + 2 * r.get(165);
      return v + r.get(145);
    }
    const int bit1 = r.get(p[8]);
    const int bit0 = r.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    int v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + r.get(*tab);
    return v + 3 + (8 << cat);
  }

  // GetCoeffs: the tokens of one block from position n, dequantised into
  // `out` (int16, wrapping as libwebp's stores do); the index after the
  // last non-zero token (16 without an end of block).
  int get_coeffs(BoolReader& r, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!r.get(p[0])) return n;
      while (!r.get(p[1])) {
        p = proba[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!r.get(p[2])) {
        v = 1;
        p = proba[type][kBands[n + 1]][1];
      } else {
        v = large_value(r, p);
        p = proba[type][kBands[n + 1]][2];
      }
      const int s = r.get(0x80) ? -v : v;
      out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // ParseResiduals; true when every coefficient is zero.
  bool parse_residuals(MB& mb, BoolReader& r, uint8_t& top_nz, uint8_t& top_nz_dc,
                       uint8_t& left_nz, uint8_t& left_nz_dc) {
    const Quant& q = dqm[mb.segment];
    int16_t* dst = mb.coeffs;
    std::memset(dst, 0, sizeof(mb.coeffs));
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top_nz_dc + left_nz_dc;
      const int nz = get_coeffs(r, 1, ctx, q.y2, 0, dc);
      top_nz_dc = left_nz_dc = nz > 0;
      if (nz > 1) {
        inverse_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      uint32_t l = lnz & 1, nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(r, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = top_nz >> (4 + ch);
      lnz = left_nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        uint32_t l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(r, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    top_nz = static_cast<uint8_t>(out_t_nz);
    left_nz = static_cast<uint8_t>(out_l_nz);
    mb.non_zero_y = non_zero_y;
    mb.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == DC_PRED) {
      if (mb_x == 0) return mb_y == 0 ? DC_PRED_NOTOPLEFT : DC_PRED_NOLEFT;
      return mb_y == 0 ? DC_PRED_NOTOP : DC_PRED;
    }
    return mode;
  }

  void decode(const uint8_t* data, size_t size, Vp8Frame& f) {
    parse_headers(data, size);
    f.width = width;
    f.height = height;
    f.y_stride = mb_w * 16;
    f.uv_stride = mb_w * 8;
    f.y.assign(size_t(f.y_stride) * mb_h * 16, 0);
    f.u.assign(size_t(f.uv_stride) * mb_h * 8, 0);
    f.v.assign(size_t(f.uv_stride) * mb_h * 8, 0);
    std::vector<FInfo> finfo(size_t(mb_w) * mb_h);
    std::vector<uint8_t> intra_t(size_t(4) * mb_w, B_DC_PRED);
    std::vector<uint8_t> top_nz(mb_w, 0), top_nz_dc(mb_w, 0);
    std::vector<uint8_t> top_y(size_t(16) * mb_w), top_u(size_t(8) * mb_w),
        top_v(size_t(8) * mb_w);
    std::vector<MB> row(mb_w);
    uint8_t yuv_b[YUV_SIZE];
    std::memset(yuv_b, 0, sizeof(yuv_b));
    uint8_t* const y_dst = yuv_b + Y_OFF;
    uint8_t* const u_dst = yuv_b + U_OFF;
    uint8_t* const v_dst = yuv_b + V_OFF;

    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra(row[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br.eof) fail("WebP: VP8 partition 0 is truncated");
      BoolReader& tr = parts[mb_y & (num_parts - 1)];
      uint8_t left_nz = 0, left_nz_dc = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MB& mb = row[mb_x];
        int skip = use_skip_proba ? mb.skip : 0;
        if (!skip) {
          skip = parse_residuals(mb, tr, top_nz[mb_x], top_nz_dc[mb_x], left_nz, left_nz_dc);
        } else {
          left_nz = top_nz[mb_x] = 0;
          if (!mb.is_i4x4) left_nz_dc = top_nz_dc[mb_x] = 0;
          mb.non_zero_y = mb.non_zero_uv = 0;
          std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
        }
        if (filter_type > 0) {
          FInfo fi = fstrengths[mb.segment][mb.is_i4x4];
          fi.inner |= !skip;
          finfo[size_t(mb_y) * mb_w + mb_x] = fi;
        }
        if (tr.eof) fail("WebP: VP8 token partition is truncated");
      }

      // Reconstruct the row (ReconstructRow), in libwebp's work buffer.
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const MB& mb = row[mb_x];
        if (mb_x > 0) {
          for (int j = -1; j < 16; ++j) std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
          for (int j = -1; j < 8; ++j) {
            std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
            std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
          }
        }
        if (mb_y > 0) {
          std::memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
          std::memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
          std::memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
        }
        if (mb.is_i4x4) {
          uint8_t* top_right = y_dst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w - 1) {
              std::memset(top_right, top_y[16 * mb_x + 15], 4);
            } else {
              std::memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
            }
          }
          for (int k = 1; k <= 3; ++k) std::memcpy(top_right + k * 4 * BPS, top_right, 4);
          for (int n = 0; n < 16; ++n) {
            uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            predict4(dst, mb.imodes[n]);
            idct_add(mb.coeffs + n * 16, dst);
          }
        } else {
          predict_block(y_dst, 16, check_mode(mb_x, mb_y, mb.imodes[0]));
          for (int n = 0; n < 16; ++n) {
            idct_add(mb.coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
          }
        }
        const int uvmode = check_mode(mb_x, mb_y, mb.uvmode);
        predict_block(u_dst, 8, uvmode);
        predict_block(v_dst, 8, uvmode);
        for (int n = 0; n < 4; ++n) {
          const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
          idct_add(mb.coeffs + 256 + n * 16, u_dst + off);
          idct_add(mb.coeffs + 320 + n * 16, v_dst + off);
        }
        if (mb_y < mb_h - 1) {
          std::memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
          std::memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
          std::memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j) {
          std::memcpy(&f.y[(size_t(mb_y) * 16 + j) * f.y_stride + 16 * mb_x], y_dst + j * BPS, 16);
        }
        for (int j = 0; j < 8; ++j) {
          const size_t at = (size_t(mb_y) * 8 + j) * f.uv_stride + 8 * mb_x;
          std::memcpy(&f.u[at], u_dst + j * BPS, 8);
          std::memcpy(&f.v[at], v_dst + j * BPS, 8);
        }
      }
    }

    // The loop filter, macroblock by macroblock in raster order, on the
    // whole frame (intra prediction read the unfiltered pixels).
    if (filter_type == 0) return;
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& fi = finfo[size_t(mb_y) * mb_w + mb_x];
        const int limit = fi.limit;
        if (limit == 0) continue;
        const int ys = f.y_stride, uvs = f.uv_stride;
        uint8_t* yd = &f.y[size_t(mb_y) * 16 * ys + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) simple_filter(yd, 1, ys, limit + 4);
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k, 1, ys, limit);
          }
          if (mb_y > 0) simple_filter(yd, ys, 1, limit + 4);
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k * ys, ys, 1, limit);
          }
        } else {
          uint8_t* ud = &f.u[size_t(mb_y) * 8 * uvs + mb_x * 8];
          uint8_t* vd = &f.v[size_t(mb_y) * 8 * uvs + mb_x * 8];
          const int il = fi.ilevel, hv = fi.hev_thresh;
          if (mb_x > 0) {
            filter_loop(yd, 1, ys, 16, limit + 4, il, hv, true);
            filter_loop(ud, 1, uvs, 8, limit + 4, il, hv, true);
            filter_loop(vd, 1, uvs, 8, limit + 4, il, hv, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) filter_loop(yd + 4 * k, 1, ys, 16, limit, il, hv, false);
            filter_loop(ud + 4, 1, uvs, 8, limit, il, hv, false);
            filter_loop(vd + 4, 1, uvs, 8, limit, il, hv, false);
          }
          if (mb_y > 0) {
            filter_loop(yd, ys, 1, 16, limit + 4, il, hv, true);
            filter_loop(ud, uvs, 1, 8, limit + 4, il, hv, true);
            filter_loop(vd, uvs, 1, 8, limit + 4, il, hv, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; ++k) {
              filter_loop(yd + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
            }
            filter_loop(ud + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
            filter_loop(vd + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
          }
        }
      }
    }
  }
};

// ---- YUV to RGB (dsp/yuv.h): 14-bit fixed point through MultHi.

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = static_cast<uint8_t>(yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = static_cast<uint8_t>(
      yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgb[2] = static_cast<uint8_t>(yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// One output row by the fancy upsampler (UPSAMPLE_FUNC's top row, with
// `near` the chroma row nearer this row and `far` the other: the bottom
// row's formulas are the same with the two swapped).
void upsample_row(const uint8_t* y, const uint8_t* near_u, const uint8_t* near_v,
                  const uint8_t* far_u, const uint8_t* far_v, uint8_t* out, int len) {
  auto chroma = [](int tl, int t, int l, int uv, int& c0, int& c1) {
    const int avg = tl + t + l + uv + 8;
    const int d12 = (avg + 2 * (t + l)) >> 3;
    const int d03 = (avg + 2 * (tl + uv)) >> 3;
    c0 = (d12 + tl) >> 1;
    c1 = (d03 + t) >> 1;
  };
  const int last_pair = (len - 1) >> 1;
  int tl_u = near_u[0], tl_v = near_v[0], l_u = far_u[0], l_v = far_v[0];
  yuv_to_rgb(y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, out);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = near_u[x], t_v = near_v[x], u = far_u[x], v = far_v[x];
    int u0, u1, v0, v1;
    chroma(tl_u, t_u, l_u, u, u0, u1);
    chroma(tl_v, t_v, l_v, v, v0, v1);
    yuv_to_rgb(y[2 * x - 1], u0, v0, out + 4 * (2 * x - 1));
    yuv_to_rgb(y[2 * x], u1, v1, out + 4 * (2 * x));
    tl_u = t_u, tl_v = t_v, l_u = u, l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               out + 4 * (len - 1));
  }
}

// EmitFancyRGB over the whole frame into RGBA (alpha 255): row 0 and, at
// an even height, the last row from one chroma row; row 2k-1 near chroma
// row k-1, row 2k near chroma row k.
void vp8_to_rgba(const Vp8Frame& f, uint8_t* out) {
  const int w = f.width, h = f.height;
  for (int j = 0; j < h; ++j) {
    int near_row, far_row;
    if (j == 0) {
      near_row = far_row = 0;
    } else if (j & 1) {
      near_row = (j - 1) >> 1;
      far_row = j + 1 < h ? (j + 1) >> 1 : near_row;
    } else {
      near_row = j >> 1;
      far_row = near_row - 1;
    }
    const size_t n = size_t(near_row) * f.uv_stride, fr = size_t(far_row) * f.uv_stride;
    uint8_t* row = out + size_t(j) * w * 4;
    upsample_row(&f.y[size_t(j) * f.y_stride], &f.u[n], &f.v[n], &f.u[fr], &f.v[fr], row, w);
    for (int x = 0; x < w; ++x) row[4 * x + 3] = 255;
  }
}

// ---- ALPH

// The alpha plane [h, w] of an ALPH chunk's payload.
std::vector<uint8_t> decode_alpha(const uint8_t* p, size_t n, int w, int h) {
  if (n <= 1) fail("WebP: ALPH chunk is truncated");
  const int method = p[0] & 3, filter = (p[0] >> 2) & 3, pre = (p[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (p[0] >> 6) != 0) fail("WebP: bad ALPH header");
  std::vector<uint8_t> a(size_t(w) * h);
  if (method == 0) {
    if (n - 1 < a.size()) fail("WebP: ALPH data is truncated");
    std::memcpy(a.data(), p + 1, a.size());
  } else {
    VP8LDecoder dec(p + 1, n - 1);
    auto s = dec.read_stream_header(w, h, true);
    std::vector<uint32_t> img(size_t(s.xsize) * h);
    // libwebp's 8-bit path (colour indexing alone, no colour cache, red,
    // blue and alpha codes of one symbol) lets the last pixel read past
    // the data.
    bool eight_bit = dec.transforms.size() == 1 && dec.transforms[0].type == 3 &&
                     s.cache_bits == 0;
    for (const auto& g : s.groups) {
      for (int j : {RED, BLUE, ALPHA}) eight_bit = eight_bit && g.h[j].single >= 0;
    }
    dec.decode_pixels(s, img.data(), eight_bit);
    if (!eight_bit) dec.check();
    dec.inverse_transforms(img, h);
    for (size_t i = 0; i < a.size(); ++i) a[i] = static_cast<uint8_t>(img[i] >> 8);
  }
  // Unfilter (dsp/filters.c): row 0 from the left (its first pixel from 0),
  // column 0 from above.
  if (filter != 0) {
    for (int y = 0; y < h; ++y) {
      uint8_t* row = &a[size_t(y) * w];
      const uint8_t* prev = y ? row - w : nullptr;
      if (filter == 1 || !prev) {
        uint8_t pred = prev ? prev[0] : 0;
        for (int x = 0; x < w; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
      } else if (filter == 2) {
        for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
      } else {
        uint8_t top = prev[0], top_left = top, left = top;
        for (int x = 0; x < w; ++x) {
          top = prev[x];
          left = static_cast<uint8_t>(row[x] + clip255(left + top - top_left));
          top_left = top;
          row[x] = left;
        }
      }
    }
  }
  return a;
}

// ------------------------------------------------------------ container

struct Frame {
  int64_t x = 0, y = 0, w = 0, h = 0;
  bool has_image = false, lossless = false, alpha_hint = false;
  size_t alpha_at = 0, alpha_size = 0;  // ALPH payload (0: none)
  size_t alpha_chunk = 0, image_chunk = 0;  // chunk starts, for the order check
  size_t image_at = 0, image_avail = 0;  // bitstream and the bytes to its padded end
};

struct WebP {
  int64_t w = 0, h = 0;
  bool alpha = false;
  Frame first;
};

constexpr uint32_t kMaxChunk = ~0u - 8 - 1;
constexpr int ALPHA_FLAG = 0x10, ANIMATION_FLAG = 0x02, ALL_VALID_FLAGS = 0x3e;

// StoreFrame: an optional ALPH and a VP8 or VP8L chunk from `at` (up to
// `end`, the RIFF's end), stopping at the first other chunk. Returns the
// position after them.
size_t store_frame(const Bytes& b, size_t at, size_t end, Frame& f) {
  int alpha_chunks = 0, image_chunks = 0;
  if (end - at < 8) fail("WebP: chunk header is truncated");
  while (true) {
    const size_t start = at;
    const uint32_t fourcc = b.le32(at), size = b.le32(at + 4);
    if (size > kMaxChunk) fail("WebP: bad chunk size");
    const size_t padded = size_t(size) + (size & 1);
    if (padded > end - at - 8) fail("WebP: chunk does not fit the file");
    const bool is_alph = fourcc == 0x48504c41u, is_vp8 = fourcc == 0x20385056u,
               is_vp8l = fourcc == 0x4c385056u;
    if (is_alph && alpha_chunks == 0) {
      ++alpha_chunks;
      f.alpha_chunk = start;
      f.alpha_at = at + 8;
      f.alpha_size = size;
    } else if ((is_vp8 || is_vp8l) && image_chunks == 0) {
      if (is_vp8l && alpha_chunks > 0) fail("WebP: ALPH chunk before a VP8L image");
      ++image_chunks;
      f.image_chunk = start;
      f.image_at = at + 8;
      f.image_avail = padded;
      f.lossless = is_vp8l;
      f.has_image = true;
      if (is_vp8l) {
        const Vp8lInfo info = vp8l_info(b.p + f.image_at, f.image_avail);
        f.w = info.w, f.h = info.h, f.alpha_hint = info.alpha;
      } else {
        const Vp8Info info = vp8_info(b.p + f.image_at, f.image_avail, size);
        f.w = info.w, f.h = info.h;
      }
    } else {
      return at;  // not part of this frame
    }
    at += 8 + padded;
    if (at == end) return at;
    if (end - at < 8) fail("WebP: chunk header is truncated");
  }
}

WebP webp_parse(const Bytes& b) {
  if (b.n < 20 || std::memcmp(b.p, "RIFF", 4) != 0 || std::memcmp(b.p + 8, "WEBP", 4) != 0) {
    fail("WebP: not a RIFF WEBP file");
  }
  const uint32_t riff_size = b.le32(4);
  if (riff_size < 8 || riff_size > kMaxChunk) fail("WebP: bad RIFF size");
  const size_t end = size_t(riff_size) + 8;
  if (b.n < end) fail("WebP: file is truncated");
  WebP out;
  size_t at = 12;
  if (std::memcmp(b.p + at, "VP8 ", 4) == 0 || std::memcmp(b.p + at, "VP8L", 4) == 0) {
    Frame f;
    store_frame(b, at, end, f);
    f.alpha_size = 0;  // no ALPH without the VP8X alpha flag
    if (!f.has_image) fail("WebP: no image");
    out.w = f.w, out.h = f.h, out.alpha = f.lossless && f.alpha_hint;
    out.first = f;
    return out;
  }
  if (std::memcmp(b.p + at, "VP8X", 4) != 0) fail("WebP: no VP8, VP8L or VP8X chunk");
  const uint32_t vp8x_size = b.le32(at + 4);
  if (vp8x_size > kMaxChunk || vp8x_size < 10) fail("WebP: bad VP8X chunk");
  const size_t vp8x_padded = size_t(vp8x_size) + (vp8x_size & 1);
  if (vp8x_padded > end - at - 8) fail("WebP: VP8X chunk does not fit the file");
  const int flags = b.u8(at + 8);
  out.w = 1 + int64_t(b.u8(at + 12) | b.u8(at + 13) << 8 | b.u8(at + 14) << 16);
  out.h = 1 + int64_t(b.u8(at + 15) | b.u8(at + 16) << 8 | b.u8(at + 17) << 16);
  const bool alpha_flag = flags & ALPHA_FLAG;
  out.alpha = alpha_flag;
  const bool animation = flags & ANIMATION_FLAG;
  if (flags & ~ALL_VALID_FLAGS) fail("WebP: reserved VP8X flags set");
  check_size("WebP", out.w, out.h);
  at += 8 + vp8x_padded;
  if (end - at < 8) fail("WebP: no chunk after VP8X");

  bool have_frame = false, have_anim = false;
  while (true) {
    const uint32_t fourcc = b.le32(at), size = b.le32(at + 4);
    if (size > kMaxChunk) fail("WebP: bad chunk size");
    const size_t padded = size_t(size) + (size & 1);
    if (padded > end - at - 8) fail("WebP: chunk does not fit the file");
    if (fourcc == 0x58385056u) fail("WebP: second VP8X chunk");
    if (fourcc == 0x48504c41u || fourcc == 0x20385056u || fourcc == 0x4c385056u) {
      if (have_anim || animation) fail("WebP: still image in an animation");
      if (have_frame) fail("WebP: second image");
      Frame f;
      at = store_frame(b, at, end, f);
      if (!f.has_image) fail("WebP: ALPH chunk without an image");
      // PIL's mode: RGBA when WebPGetFeatures finds alpha, which for a still
      // is the VP8L hint (VP8: the flag) or an ALPH chunk before the image.
      out.alpha = (f.lossless ? f.alpha_hint : alpha_flag) ||
                  (f.alpha_chunk && f.alpha_chunk < f.image_chunk);
      if (!alpha_flag) f.alpha_size = 0, f.alpha_chunk = 0;
      if (f.alpha_chunk > f.image_chunk) fail("WebP: ALPH chunk after its image");
      if (f.w != out.w || f.h != out.h) fail("WebP: image size differs from the canvas");
      out.first = f;
      have_frame = true;
    } else if (fourcc == 0x4d494e41u) {  // ANIM
      if (padded < 6) fail("WebP: bad ANIM chunk");
      have_anim = true;
      at += 8 + padded;
    } else if (fourcc == 0x464d4e41u) {  // ANMF
      if (!have_anim) fail("WebP: ANMF before ANIM");
      if (end - at - 8 < 16 || padded < 16) fail("WebP: bad ANMF chunk");
      const size_t payload = padded - 16;
      const size_t hdr = at + 8;
      auto le24 = [&](size_t k) { return int64_t(b.u8(k) | b.u8(k + 1) << 8 | b.u8(k + 2) << 16); };
      Frame f;
      f.x = 2 * le24(hdr);
      f.y = 2 * le24(hdr + 3);
      const int64_t anmf_w = 1 + le24(hdr + 6), anmf_h = 1 + le24(hdr + 9);
      if (anmf_w * anmf_h >= (int64_t(1) << 32)) fail("WebP: ANMF frame is too large");
      const size_t start = hdr + 16;
      if (end - start < 8 || end - start < payload) fail("WebP: ANMF frame is truncated");
      at = store_frame(b, start, end, f);
      if (at - start > payload) fail("WebP: ANMF frame overruns its chunk");
      if (animation && (f.has_image || f.alpha_chunk)) {
        if (!f.has_image) fail("WebP: ANMF frame without an image");
        if (f.alpha_chunk && f.alpha_chunk > f.image_chunk) {
          fail("WebP: ALPH chunk after its image");
        }
        if (f.x + f.w > out.w || f.y + f.h > out.h) fail("WebP: frame does not fit its canvas");
        if (!have_frame) out.first = f;
        have_frame = true;
      }
    } else {  // ICCP, EXIF, XMP and unknown chunks
      at += 8 + padded;
    }
    if (at == end) break;
    if (end - at < 8) fail("WebP: chunk header is truncated");
  }
  if (!have_frame) fail("WebP: no frame");
  return out;
}

WebP webp_header(const Bytes& b) {
  WebP m = webp_parse(b);
  check_size("WebP", m.w, m.h);
  return m;
}

void webp_decode(const Bytes& b, uint8_t* out, int out_w, int out_h) {
  const WebP m = webp_header(b);
  check_out("WebP", m.w, m.h, out_w, out_h);
  const Frame& f = m.first;
  const int fw = static_cast<int>(f.w), fh = static_cast<int>(f.h);
  std::vector<uint8_t> rgba(size_t(fw) * fh * 4);
  if (f.lossless) {
    const std::vector<uint32_t> argb = vp8l_decode(b.p + f.image_at, f.image_avail, fw, fh);
    for (size_t i = 0; i < argb.size(); ++i) {
      const uint32_t p = argb[i];
      put(&rgba[4 * i], (p >> 16) & 0xff, (p >> 8) & 0xff, p & 0xff, p >> 24);
    }
  } else {
    Vp8Decoder dec;
    Vp8Frame frame;
    dec.decode(b.p + f.image_at, f.image_avail, frame);
    vp8_to_rgba(frame, rgba.data());
    if (f.alpha_size) {
      const std::vector<uint8_t> a = decode_alpha(b.p + f.alpha_at, f.alpha_size, fw, fh);
      for (size_t i = 0; i < a.size(); ++i) rgba[4 * i + 3] = a[i];
    }
  }
  // The canvas: transparent black, the frame at its offset; RGBX without
  // the alpha flag.
  std::memset(out, 0, size_t(out_w) * out_h * 4);
  for (int y = 0; y < fh; ++y) {
    std::memcpy(out + ((size_t(f.y) + y) * out_w + size_t(f.x)) * 4, &rgba[size_t(y) * fw * 4],
                size_t(fw) * 4);
  }
  if (!m.alpha) {
    for (size_t i = 0; i < size_t(out_w) * out_h; ++i) out[4 * i + 3] = 255;
  }
}

}  // namespace

extern "C" {

// Canvas width and height (0, or 1 with a message when the decoder refuses
// the file); then tracy_webp_decode writes RGBA8 [h, w, 4] to `out`.
int tracy_webp_info(const uint8_t* data, int64_t len, int* w, int* h) {
  return info("WebP", data, len, w, h, webp_header);
}
int tracy_webp_decode(const uint8_t* data, int64_t len, uint8_t* out, int w, int h) {
  return guarded("WebP", [&] { webp_decode({data, static_cast<size_t>(len), "WebP"}, out, w, h); });
}

}  // extern "C"
