// h264_cabac.cpp — the H.264 decoder's CABAC (h264.h): the context
// variables' initialisation (9.3.1.1, Tables 9-12 to 9-33), the arithmetic
// decoding engine (9.3.1.2, 9.3.3.2, Tables 9-44 and 9-45) and the
// binarizations with their context index increments (9.3.2, 9.3.3.1) of
// every syntax element of progressive 4:2:0 slice data. The increments that
// read neighbouring macroblocks are derived by the caller (h264_slice.cpp,
// which locates the neighbours) and passed in. Clause and table numbers are
// ITU-T H.264's.

#include <algorithm>
#include <cstring>

#include "h264.h"

namespace oatxt {
namespace h264 {

namespace {

// (m, n) pairs by ctxIdx (9.3.1.1). Each table below lists a run of
// consecutive ctxIdx, by slice kind where the kinds differ (0: I, 1-3: P and
// B with cabac_init_idc 0-2; init_pair picks the entry). ctxIdx 0-10 and
// 60-69 are the same for every slice kind; 11-59 exist only in P and B
// slices. The field-coded ranges (277-398, 436-459) are not listed: field
// pictures and MBAFF are refused.
struct Mn {
  int8_t m;
  int16_t n;
};

// Table 9-12: ctxIdx 0-10 (mb_type of SI and I slices), every slice kind
constexpr Mn kInit0_10[11] = {{20, -15}, {2, 54},   {3, 74},   {20, -15}, {2, 54}, {3, 74},
                              {-28, 127}, {-23, 104}, {-6, 53}, {-1, 54},  {7, 51}};

// Tables 9-13 to 9-16: ctxIdx 11-59 (mb_skip_flag, mb_type and sub_mb_type
// of P and B slices, mvd, ref_idx) by cabac_init_idc
constexpr Mn kInit11_59[3][49] = {
    {// cabac_init_idc 0
     {23, 33},  {23, 2},    {21, 0},   {1, 9},    {0, 49},   {-37, 118}, {5, 57},  {-13, 78},
     {-11, 65}, {1, 62},    {12, 49},  {-4, 73},  {17, 50},  {18, 64},   {9, 43},  {29, 0},
     {26, 67},  {16, 90},   {9, 104},  {-46, 127}, {-20, 104}, {1, 67},  {-13, 78}, {-11, 65},
     {1, 62},   {-6, 86},   {-17, 95}, {-6, 61},  {9, 45},   {-3, 69},   {-6, 81}, {-11, 96},
     {6, 55},   {7, 67},    {-5, 86},  {2, 88},   {0, 58},   {-3, 76},   {-10, 94}, {5, 54},
     {4, 69},   {-3, 81},   {0, 88},   {-7, 67},  {-5, 74},  {-4, 74},   {-5, 80}, {-7, 72},
     {1, 58}},
    {// cabac_init_idc 1
     {22, 25},  {34, 0},    {16, 0},   {-2, 9},   {4, 41},   {-29, 118}, {2, 65},  {-6, 71},
     {-13, 79}, {5, 52},    {9, 50},   {-3, 70},  {10, 54},  {26, 34},   {19, 22}, {40, 0},
     {57, 2},   {41, 36},   {26, 69},  {-45, 127}, {-15, 101}, {-4, 76}, {-6, 71}, {-13, 79},
     {5, 52},   {6, 69},    {-13, 90}, {0, 52},   {8, 43},   {-2, 69},   {-5, 82}, {-10, 96},
     {2, 59},   {2, 75},    {-3, 87},  {-3, 100}, {1, 56},   {-3, 74},   {-6, 85}, {0, 59},
     {-3, 81},  {-7, 86},   {-5, 95},  {-1, 66},  {-1, 77},  {1, 70},    {-2, 86}, {-5, 72},
     {0, 61}},
    {// cabac_init_idc 2
     {29, 16},  {25, 0},    {14, 0},   {-10, 51}, {-3, 62},  {-27, 99},  {26, 16}, {-4, 85},
     {-24, 102}, {5, 57},   {6, 57},   {-17, 73}, {14, 57},  {20, 40},   {20, 10}, {29, 0},
     {54, 0},   {37, 42},   {12, 97},  {-32, 127}, {-22, 117}, {-2, 74}, {-4, 85}, {-24, 102},
     {5, 57},   {-6, 93},   {-14, 88}, {-6, 44},  {4, 55},   {-11, 89},  {-15, 103}, {-21, 116},
     {19, 57},  {20, 58},   {4, 84},   {6, 96},   {1, 63},   {-5, 85},   {-13, 106}, {5, 63},
     {6, 75},   {-3, 90},   {-1, 101}, {3, 55},   {-4, 79},  {-2, 75},   {-12, 97}, {-7, 50},
     {1, 60}}};

// Table 9-17: ctxIdx 60-69 (mb_qp_delta, intra_chroma_pred_mode,
// prev_intra*_pred_mode_flag, rem_intra*_pred_mode), every slice kind
constexpr Mn kInit60_69[10] = {{0, 41},  {0, 63}, {0, 63},  {0, 63},  {-9, 83},
                               {4, 86},  {0, 97}, {-7, 72}, {13, 41}, {3, 62}};

// Table 9-18: ctxIdx 70-104 (mb_field_decoding_flag, coded_block_pattern,
// coded_block_flag of ctxBlockCat 0-4); [0] I slices, [1..3] cabac_init_idc 0-2
constexpr Mn kInit70_104[4][35] = {
    {{0, 11},    {1, 55},    {0, 69},    {-17, 127}, {-13, 102}, {0, 82},    {-7, 74},
     {-21, 107}, {-27, 127}, {-31, 127}, {-24, 127}, {-18, 95},  {-27, 127}, {-21, 114},
     {-30, 127}, {-17, 123}, {-12, 115}, {-16, 122}, {-11, 115}, {-12, 63},  {-2, 68},
     {-15, 84},  {-13, 104}, {-3, 70},   {-8, 93},   {-10, 90},  {-30, 127}, {-1, 74},
     {-6, 97},   {-7, 91},   {-20, 127}, {-4, 56},   {-5, 82},   {-7, 76},   {-22, 125}},
    {{0, 45},    {-4, 78},   {-3, 96},   {-27, 126}, {-28, 98},  {-25, 101}, {-23, 67},
     {-28, 82},  {-20, 94},  {-16, 83},  {-22, 110}, {-21, 91},  {-18, 102}, {-13, 93},
     {-29, 127}, {-7, 92},   {-5, 89},   {-7, 96},   {-13, 108}, {-3, 46},   {-1, 65},
     {-1, 57},   {-9, 93},   {-3, 74},   {-9, 92},   {-8, 87},   {-23, 126}, {5, 54},
     {6, 60},    {6, 59},    {6, 69},    {-1, 48},   {0, 68},    {-4, 69},   {-8, 88}},
    {{13, 15},   {7, 51},    {2, 80},    {-39, 127}, {-18, 91},  {-17, 96},  {-26, 81},
     {-35, 98},  {-24, 102}, {-23, 97},  {-27, 119}, {-24, 99},  {-21, 110}, {-18, 102},
     {-36, 127}, {0, 80},    {-5, 89},   {-7, 94},   {-4, 92},   {0, 39},    {0, 65},
     {-15, 84},  {-35, 127}, {-2, 73},   {-12, 104}, {-9, 91},   {-31, 127}, {3, 55},
     {7, 56},    {7, 55},    {8, 61},    {-3, 53},   {0, 68},    {-7, 74},   {-9, 88}},
    {{7, 34},    {-9, 88},   {-20, 127}, {-36, 127}, {-17, 91},  {-14, 95},  {-25, 84},
     {-25, 86},  {-12, 89},  {-17, 91},  {-31, 127}, {-14, 76},  {-18, 103}, {-13, 90},
     {-37, 127}, {11, 80},   {5, 76},    {2, 84},    {5, 78},    {-6, 55},   {4, 61},
     {-14, 83},  {-37, 127}, {-5, 79},   {-11, 104}, {-11, 91},  {-30, 127}, {0, 65},
     {-2, 79},   {0, 72},    {-4, 92},   {-6, 56},   {3, 68},    {-8, 71},   {-13, 98}}};

// Tables 9-19 and 9-20: ctxIdx 105-165 (significant_coeff_flag, frame
// coded, ctxBlockCat 0-4); I, then cabac_init_idc 0-2
constexpr Mn kInit105_165[4][61] = {
    {{-7, 93},   {-11, 87},  {-3, 77},   {-5, 71},   {-4, 63},   {-4, 68},  {-12, 84},
     {-7, 62},   {-7, 65},   {8, 61},    {5, 56},    {-2, 66},   {1, 64},   {0, 61},
     {-2, 78},   {1, 50},    {7, 52},    {10, 35},   {0, 44},    {11, 38},  {1, 45},
     {0, 46},    {5, 44},    {31, 17},   {1, 51},    {7, 50},    {28, 19},  {16, 33},
     {14, 62},   {-13, 108}, {-15, 100}, {-13, 101}, {-13, 91},  {-12, 94}, {-10, 88},
     {-16, 84},  {-10, 86},  {-7, 83},   {-13, 87},  {-19, 94},  {1, 70},   {0, 72},
     {-5, 74},   {18, 59},   {-8, 102},  {-15, 100}, {0, 95},    {-4, 75},  {2, 72},
     {-11, 75},  {-3, 71},   {15, 46},   {-13, 69},  {0, 62},    {0, 65},   {21, 37},
     {-15, 72},  {9, 57},    {16, 54},   {0, 62},    {12, 72}},
    {{-2, 85},   {-6, 78},   {-1, 75},   {-7, 77},   {2, 54},    {5, 50},   {-3, 68},
     {1, 50},    {6, 42},    {-4, 81},   {1, 63},    {-4, 70},   {0, 67},   {2, 57},
     {-2, 76},   {11, 35},   {4, 64},    {1, 61},    {11, 35},   {18, 25},  {12, 24},
     {13, 29},   {13, 36},   {-10, 93},  {-7, 73},   {-2, 73},   {13, 46},  {9, 49},
     {-7, 100},  {9, 53},    {2, 53},    {5, 53},    {-2, 61},   {0, 56},   {0, 56},
     {-13, 63},  {-5, 60},   {-1, 62},   {4, 57},    {-6, 69},   {4, 57},   {14, 39},
     {4, 51},    {13, 68},   {3, 64},    {1, 61},    {9, 63},    {7, 50},   {16, 39},
     {5, 44},    {4, 52},    {11, 48},   {-5, 60},   {-1, 59},   {0, 59},   {22, 33},
     {5, 44},    {14, 43},   {-1, 78},   {0, 60},    {9, 69}},
    {{-13, 103}, {-13, 91},  {-9, 89},   {-14, 92},  {-8, 76},   {-12, 87}, {-23, 110},
     {-24, 105}, {-10, 78},  {-20, 112}, {-17, 99},  {-78, 127}, {-70, 127}, {-50, 127},
     {-46, 127}, {-4, 66},   {-5, 78},   {-4, 71},   {-8, 72},   {2, 59},   {-1, 55},
     {-7, 70},   {-6, 75},   {-8, 89},   {-34, 119}, {-3, 75},   {32, 20},  {30, 22},
     {-44, 127}, {0, 54},    {-5, 61},   {0, 58},    {-1, 60},   {-3, 61},  {-8, 67},
     {-25, 84},  {-14, 74},  {-5, 65},   {5, 52},    {2, 57},    {0, 61},   {-9, 69},
     {-11, 70},  {18, 55},   {-4, 71},   {0, 58},    {7, 61},    {9, 41},   {18, 25},
     {9, 32},    {5, 43},    {9, 47},    {0, 44},    {0, 51},    {2, 46},   {19, 38},
     {-4, 66},   {15, 38},   {12, 42},   {9, 34},    {0, 89}},
    {{-4, 86},   {-12, 88},  {-5, 82},   {-3, 72},   {-4, 67},   {-8, 72},  {-16, 89},
     {-9, 69},   {-1, 59},   {5, 66},    {4, 57},    {-4, 71},   {-2, 71},  {2, 58},
     {-1, 74},   {-4, 44},   {-1, 69},   {0, 62},    {-7, 51},   {-4, 47},  {-6, 42},
     {-3, 41},   {-6, 53},   {8, 76},    {-9, 78},   {-11, 83},  {9, 52},   {0, 67},
     {-5, 90},   {1, 67},    {-15, 72},  {-5, 75},   {-8, 80},   {-21, 83}, {-21, 64},
     {-13, 31},  {-25, 64},  {-29, 94},  {9, 75},    {17, 63},   {-8, 74},  {-5, 35},
     {-2, 27},   {13, 91},   {3, 65},    {-7, 69},   {8, 77},    {-10, 66}, {3, 62},
     {-3, 68},   {-20, 81},  {0, 30},    {1, 7},     {-3, 23},   {-21, 74}, {16, 66},
     {-23, 124}, {17, 37},   {44, -18},  {50, -34},  {-22, 127}}};

// Tables 9-21 and 9-22: ctxIdx 166-226 (last_significant_coeff_flag, frame
// coded, ctxBlockCat 0-4)
constexpr Mn kInit166_226[4][61] = {
    {{24, 0},   {15, 9},   {8, 25},   {13, 18},  {15, 9},   {13, 19},  {10, 37},  {12, 18},
     {6, 29},   {20, 33},  {15, 30},  {4, 45},   {1, 58},   {0, 62},   {7, 61},   {12, 38},
     {11, 45},  {15, 39},  {11, 42},  {13, 44},  {16, 45},  {12, 41},  {10, 49},  {30, 34},
     {18, 42},  {10, 55},  {17, 51},  {17, 46},  {0, 89},   {26, -19}, {22, -17}, {26, -17},
     {30, -25}, {28, -20}, {33, -23}, {37, -27}, {33, -23}, {40, -28}, {38, -17}, {33, -11},
     {40, -15}, {41, -6},  {38, 1},   {41, 17},  {30, -6},  {27, 3},   {26, 22},  {37, -16},
     {35, -4},  {38, -8},  {38, -3},  {37, 3},   {38, 5},   {42, 0},   {35, 16},  {39, 22},
     {14, 48},  {27, 37},  {21, 60},  {12, 68},  {2, 97}},
    {{11, 28},  {2, 40},   {3, 44},   {0, 49},   {0, 46},   {2, 44},   {2, 51},   {0, 47},
     {4, 39},   {2, 62},   {6, 46},   {0, 54},   {3, 54},   {2, 58},   {4, 63},   {6, 51},
     {6, 57},   {7, 53},   {6, 52},   {6, 55},   {11, 45},  {14, 36},  {8, 53},   {-1, 82},
     {7, 55},   {-3, 78},  {15, 46},  {22, 31},  {-1, 84},  {25, 7},   {30, -7},  {28, 3},
     {28, 4},   {32, 0},   {34, -1},  {30, 6},   {30, 6},   {32, 9},   {31, 19},  {26, 27},
     {26, 30},  {37, 20},  {28, 34},  {17, 70},  {1, 67},   {5, 59},   {9, 67},   {16, 30},
     {18, 32},  {18, 35},  {22, 29},  {24, 31},  {23, 38},  {18, 43},  {20, 41},  {11, 63},
     {9, 59},   {9, 64},   {-1, 94},  {-2, 89},  {-9, 108}},
    {{4, 45},   {10, 28},  {10, 31},  {33, -11}, {52, -43}, {18, 15},  {28, 0},   {35, -22},
     {38, -25}, {34, 0},   {39, -18}, {32, -12}, {102, -94}, {0, 0},   {56, -15}, {33, -4},
     {29, 10},  {37, -5},  {51, -29}, {39, -9},  {52, -34}, {69, -58}, {67, -63}, {44, -5},
     {32, 7},   {55, -29}, {32, 1},   {0, 0},    {27, 36},  {33, -25}, {34, -30}, {36, -28},
     {38, -28}, {38, -27}, {34, -18}, {35, -16}, {34, -14}, {32, -8},  {37, -6},  {35, 0},
     {30, 10},  {28, 18},  {26, 25},  {29, 41},  {0, 75},   {2, 72},   {8, 77},   {14, 35},
     {18, 31},  {17, 35},  {21, 30},  {17, 45},  {20, 42},  {18, 45},  {27, 26},  {16, 54},
     {7, 66},   {16, 56},  {11, 73},  {10, 67},  {-10, 116}},
    {{4, 39},   {0, 42},   {7, 34},   {11, 29},  {8, 31},   {6, 37},   {7, 42},   {3, 40},
     {8, 33},   {13, 43},  {13, 36},  {4, 47},   {3, 55},   {2, 58},   {6, 60},   {8, 44},
     {11, 44},  {14, 42},  {7, 48},   {4, 56},   {4, 52},   {13, 37},  {9, 49},   {19, 58},
     {10, 48},  {12, 45},  {0, 69},   {20, 33},  {8, 63},   {35, -18}, {33, -25}, {28, -3},
     {24, 10},  {27, 0},   {34, -14}, {52, -44}, {39, -24}, {19, 17},  {31, 25},  {36, 29},
     {24, 33},  {34, 15},  {30, 20},  {22, 73},  {20, 34},  {19, 31},  {27, 44},  {19, 16},
     {15, 36},  {15, 36},  {21, 28},  {25, 21},  {30, 20},  {31, 12},  {27, 16},  {24, 42},
     {0, 93},   {14, 56},  {15, 57},  {26, 38},  {-24, 127}}};

// Tables 9-23 and 9-24: ctxIdx 227-275 (coeff_abs_level_minus1,
// ctxBlockCat 0-4)
constexpr Mn kInit227_275[4][49] = {
    {{-3, 71},   {-6, 42},   {-5, 50},   {-3, 54},   {-2, 62},  {0, 58},    {1, 63},
     {-2, 72},   {-1, 74},   {-9, 91},   {-5, 67},   {-5, 27},  {-3, 39},   {-2, 44},
     {0, 46},    {-16, 64},  {-8, 68},   {-10, 78},  {-6, 77},  {-10, 86},  {-12, 92},
     {-15, 55},  {-10, 60},  {-6, 62},   {-4, 65},   {-12, 73}, {-8, 76},   {-7, 80},
     {-9, 88},   {-17, 110}, {-11, 97},  {-20, 84},  {-11, 79}, {-6, 73},   {-4, 74},
     {-13, 86},  {-13, 96},  {-11, 97},  {-19, 117}, {-8, 78},  {-5, 33},   {-4, 48},
     {-2, 53},   {-3, 62},   {-13, 71},  {-10, 79},  {-12, 86}, {-13, 90},  {-14, 97}},
    {{-6, 76},   {-2, 44},   {0, 45},    {0, 52},    {-3, 64},  {-2, 59},   {-4, 70},
     {-4, 75},   {-8, 82},   {-17, 102}, {-9, 77},   {3, 24},   {0, 42},    {0, 48},
     {0, 55},    {-6, 59},   {-7, 71},   {-12, 83},  {-11, 87}, {-30, 119}, {1, 58},
     {-3, 29},   {-1, 36},   {1, 38},    {2, 43},    {-6, 55},  {0, 58},    {0, 64},
     {-3, 74},   {-10, 90},  {0, 70},    {-4, 29},   {5, 31},   {7, 42},    {1, 59},
     {-2, 58},   {-3, 72},   {-3, 81},   {-11, 97},  {0, 58},   {8, 5},     {10, 14},
     {14, 18},   {13, 27},   {2, 40},    {0, 58},    {-3, 70},  {-6, 79},   {-8, 85}},
    {{-23, 112}, {-15, 71},  {-7, 61},   {0, 53},    {-5, 66},  {-11, 77},  {-9, 80},
     {-9, 84},   {-10, 87},  {-34, 127}, {-21, 101}, {-3, 39},  {-5, 53},   {-7, 61},
     {-11, 75},  {-15, 77},  {-17, 91},  {-25, 107}, {-25, 111}, {-28, 122}, {-11, 76},
     {-10, 44},  {-10, 52},  {-10, 57},  {-9, 58},   {-16, 72}, {-7, 69},   {-4, 69},
     {-5, 74},   {-9, 86},   {2, 66},    {-9, 34},   {1, 32},   {11, 31},   {5, 52},
     {-2, 55},   {-2, 67},   {0, 73},    {-8, 89},   {3, 52},   {7, 4},     {10, 8},
     {17, 8},    {16, 19},   {3, 37},    {-1, 61},   {-5, 73},  {-1, 70},   {-4, 78}},
    {{-24, 115}, {-22, 82},  {-9, 62},   {0, 53},    {0, 59},   {-14, 85},  {-13, 89},
     {-13, 94},  {-11, 92},  {-29, 127}, {-21, 100}, {-14, 57}, {-12, 67},  {-11, 71},
     {-10, 77},  {-21, 85},  {-16, 88},  {-23, 104}, {-15, 98}, {-37, 127}, {-10, 82},
     {-8, 48},   {-8, 61},   {-8, 66},   {-7, 70},   {-14, 75}, {-10, 79},  {-9, 83},
     {-12, 92},  {-18, 108}, {-4, 79},   {-22, 69},  {-16, 75}, {-2, 58},   {1, 58},
     {-13, 78},  {-9, 83},   {-4, 81},   {-13, 99},  {-13, 81}, {-6, 38},   {-13, 62},
     {-6, 58},   {-2, 59},   {-16, 73},  {-10, 76},  {-13, 86}, {-9, 83},   {-10, 87}}};

// Tables 9-25 to 9-33 (the 8×8 transform): ctxIdx 399-401
// (transform_size_8x8_flag), 402-416 (significant_coeff_flag, frame coded,
// ctxBlockCat 5), 417-425 (last_significant_coeff_flag, frame coded),
// 426-435 (coeff_abs_level_minus1); I slices, cabac_init_idc 0 and 2. The
// cabac_init_idc 1 column is not here: no transcription of it decoded
// x264's cabac-idc=1 streams as FFmpeg does, and slice_header refuses those
// slices where the PPS allows the 8×8 transform.
constexpr Mn kInit399_435[3][37] = {
    {{31, 21},  {31, 31},   {25, 50},  {-17, 120}, {-20, 112}, {-18, 114}, {-11, 85},
     {-15, 92}, {-14, 89},  {-26, 71}, {-15, 81},  {-14, 80},  {0, 68},    {-14, 70},
     {-24, 56}, {-23, 68},  {-24, 50}, {-11, 74},  {23, -13},  {26, -13},  {40, -15},
     {49, -14}, {44, 3},    {45, 6},   {44, 34},   {33, 54},   {19, 82},   {-3, 75},
     {-1, 23},  {1, 34},    {1, 43},   {0, 54},    {-2, 55},   {0, 61},    {1, 64},
     {0, 68},   {-9, 92}},
    {{12, 40},  {11, 51},   {14, 59},  {-4, 79},   {-7, 71},   {-5, 69},   {-9, 70},
     {-8, 66},  {-10, 68},  {-19, 73}, {-12, 69},  {-16, 70},  {-15, 67},  {-20, 62},
     {-19, 70}, {-16, 66},  {-22, 65}, {-20, 63},  {9, -2},    {26, -9},   {33, -9},
     {39, -7},  {41, -2},   {45, 3},   {49, 9},    {45, 27},   {36, 59},   {-6, 66},
     {-7, 35},  {-7, 42},   {-8, 45},  {-5, 48},   {-12, 56},  {-6, 60},   {-5, 62},
     {-8, 66},  {-8, 76}},
    {{21, 33},  {19, 50},   {17, 61},  {-3, 78},   {-8, 74},   {-9, 72},   {-10, 72},
     {-18, 75}, {-12, 71},  {-11, 63}, {-5, 70},   {-17, 75},  {-14, 72},  {-16, 67},
     {-8, 53},  {-14, 59},  {-9, 52},  {-11, 68},  {9, -2},    {30, -10},  {31, -4},
     {33, -1},  {33, 7},    {31, 12},  {37, 23},   {31, 38},   {20, 64},   {-9, 71},
     {-7, 37},  {-8, 44},   {-11, 49}, {-10, 56},  {-12, 59},  {-8, 63},   {-9, 67},
     {-6, 68},  {-10, 79}}};

// Table 9-44: rangeTabLPS[pStateIdx][qCodIRangeIdx]
constexpr uint8_t kRangeLps[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216}, {123, 150, 178, 205},
    {116, 142, 169, 195}, {111, 135, 160, 185}, {105, 128, 152, 175}, {100, 122, 144, 166},
    {95, 116, 137, 158},  {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},   {66, 80, 95, 110},
    {62, 76, 90, 104},    {59, 72, 86, 99},     {56, 69, 81, 94},     {53, 65, 77, 89},
    {51, 62, 73, 85},     {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},     {35, 43, 51, 59},
    {33, 41, 48, 56},     {32, 39, 46, 53},     {30, 37, 43, 50},     {29, 35, 41, 48},
    {27, 33, 39, 45},     {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},     {19, 23, 27, 31},
    {18, 22, 26, 30},     {17, 21, 25, 28},     {16, 20, 23, 27},     {15, 19, 22, 25},
    {14, 18, 21, 24},     {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},     {10, 12, 15, 17},
    {10, 12, 14, 16},     {9, 11, 13, 15},      {9, 11, 12, 14},      {8, 10, 12, 14},
    {8, 9, 11, 13},       {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},         {2, 2, 2, 2}};

// Table 9-45: transIdxLPS (transIdxMPS is min(pStateIdx + 1, 62), 63 kept)
constexpr uint8_t kTransLps[64] = {
    0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12, 13, 13, 15, 15, 16, 16,
    18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30,
    31, 32, 32, 33, 33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

inline int trans_mps(int s) { return s < 62 ? s + 1 : s; }

// Table 9-43: ctxIdxInc of significant_coeff_flag (frame coded) and of
// last_significant_coeff_flag for ctxBlockCat 5, by levelListIdx
constexpr uint8_t kSig8x8[63] = {
    0,  1,  2,  3,  4,  5,  5,  4,  4,  3,  3,  4,  4,  4,  5,  5,  4,  4,  4,  4,  3,
    3,  6,  7,  7,  7,  8,  9,  10, 9,  8,  7,  7,  6,  11, 12, 13, 11, 6,  7,  8,  9,
    14, 10, 9,  8,  6,  11, 12, 13, 11, 6,  9,  14, 10, 9,  11, 12, 13, 11, 14, 10, 12};
constexpr uint8_t kLast8x8[63] = {
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8};

// ctxBlockCatOffset (Table 9-40) by ctxBlockCat 0-4, for coded_block_flag,
// significant / last_significant_coeff_flag and coeff_abs_level_minus1
constexpr int kCbfCatOffset[5] = {0, 4, 8, 12, 16};
constexpr int kSigCatOffset[5] = {0, 15, 29, 44, 47};
constexpr int kAbsCatOffset[5] = {0, 10, 20, 30, 39};

// The (m, n) pair of ctxIdx for slice kind k (0: I, 1-3: cabac_init_idc
// 0-2); nullptr where the table has none for that kind.
const Mn* init_pair(int k, int ctx) {
  if (ctx <= 10) return &kInit0_10[ctx];
  if (ctx <= 59) return k ? &kInit11_59[k - 1][ctx - 11] : nullptr;
  if (ctx <= 69) return &kInit60_69[ctx - 60];
  if (ctx <= 104) return &kInit70_104[k][ctx - 70];
  if (ctx <= 165) return &kInit105_165[k][ctx - 105];
  if (ctx <= 226) return &kInit166_226[k][ctx - 166];
  if (ctx <= 275) return &kInit227_275[k][ctx - 227];
  if (ctx >= 399 && ctx <= 435) return k == 2 ? nullptr : &kInit399_435[k - (k > 2)][ctx - 399];
  return nullptr;
}

}  // namespace

// ------------------------------------------------------------- the engine

void Cabac::init_contexts(int slice_type, int cabac_init_idc, int slice_qp) {  // 9.3.1.1
  const int k = slice_type == 2 ? 0 : 1 + cabac_init_idc;
  const int qp = std::min(std::max(slice_qp, 0), 51);
  for (int ctx = 0; ctx < kContexts; ctx++) {
    const Mn* p = init_pair(k, ctx);
    if (!p) {
      state[ctx] = 0;
      continue;
    }
    const int pre = std::min(std::max(((p->m * qp) >> 4) + p->n, 1), 126);
    state[ctx] = (uint8_t)(pre <= 63 ? (63 - pre) << 1 : (pre - 64) << 1 | 1);
  }
}

void Cabac::start(const uint8_t* data, size_t bit_pos, size_t end_bits) {  // 9.3.1.2
  buf = data;
  pos = bit_pos;
  end = end_bits;
  range = 510;
  offset = read(9);
  if (offset >= 510) raise(kCorrupt, "CABAC codIOffset 510 or 511 at initialisation");
}

int Cabac::decision(int ctx) {  // 9.3.3.2.1
  uint8_t& s = state[ctx];
  const int p = s >> 1, mps = s & 1;
  const uint32_t lps = kRangeLps[p][(range >> 6) & 3];
  range -= lps;
  int bin;
  if (offset >= range) {
    bin = !mps;
    offset -= range;
    range = lps;
    s = (uint8_t)(kTransLps[p] << 1 | (p == 0 ? !mps : mps));
  } else {
    bin = mps;
    s = (uint8_t)(trans_mps(p) << 1 | mps);
  }
  if (range < 256) {  // RenormD: shift until codIRange is at least 256
    const int n = __builtin_clz(range) - 23;
    range <<= n;
    offset = offset << n | read(n);
  }
  return bin;
}

int Cabac::bypass() {  // 9.3.3.2.3
  offset = offset << 1 | read(1);
  if (offset >= range) {
    offset -= range;
    return 1;
  }
  return 0;
}

int Cabac::terminate() {  // 9.3.3.2.2.3
  range -= 2;
  if (offset >= range) return 1;  // no renormalization: the last bit read was the last one
  if (range < 256) {
    range <<= 1;
    offset = offset << 1 | read(1);
  }
  return 0;
}

uint32_t Cabac::read(int n) {  // n bits; zeros past the buffer
  uint32_t v = 0;
  for (int i = 0; i < n; i++, pos++)
    v = v << 1 | (pos < end ? (buf[pos >> 3] >> (7 - (pos & 7))) & 1 : 0);
  return v;
}

// ---------------------------------------------------- binarizations (9.3.2)

int Cabac::mb_type_i(int offset, int inc0) {  // Table 9-36; ctxIdxInc of Table 9-39
  const bool prefix = offset == 3;  // I slices; 17 (P) and 32 (B) take it as a suffix
  if (!decision(offset + (prefix ? inc0 : 0))) return 0;  // I_NxN
  if (terminate()) return 25;                              // I_PCM
  const int luma = decision(offset + (prefix ? 3 : 1));
  const int chroma_nz = decision(offset + (prefix ? 4 : 2));
  int chroma = 0;
  if (chroma_nz) chroma = 1 + decision(offset + (prefix ? 5 : 2));
  const int m1 = decision(offset + (prefix ? 6 : 3));
  const int m0 = decision(offset + (prefix ? 7 : 3));
  return 1 + (m1 << 1 | m0) + 4 * chroma + 12 * luma;
}

int Cabac::mb_type_p() {  // 0-4 P, 5 + I numbering for intra
  if (decision(14)) return 5 + mb_type_i(17, 0);
  if (!decision(15)) return decision(16) ? 3 : 0;  // P_8x8 : P_L0_16x16
  return decision(17) ? 1 : 2;                     // P_L0_L0_16x8 : P_L0_L0_8x16
}

int Cabac::mb_type_b(int inc0) {  // 0-22 B (Table 7-14), 23 + I numbering for intra
  if (!decision(27 + inc0)) return 0;  // B_Direct_16x16
  if (!decision(27 + 3)) return 1 + decision(27 + 5);
  int bits = decision(27 + 4) << 3;
  bits |= decision(27 + 5) << 2;
  bits |= decision(27 + 5) << 1;
  bits |= decision(27 + 5);
  if (bits < 8) return bits + 3;
  if (bits == 13) return 23 + mb_type_i(32, 0);
  if (bits == 14) return 11;
  if (bits == 15) return 22;
  return ((bits << 1) | decision(27 + 5)) - 4;
}

int Cabac::sub_mb_type_p() {  // Table 9-38, P
  if (decision(21)) return 0;
  if (!decision(22)) return 1;
  return decision(23) ? 2 : 3;
}

int Cabac::sub_mb_type_b() {  // Table 9-38, B
  if (!decision(36)) return 0;
  if (!decision(37)) return 1 + decision(39);
  int t = 3;
  if (decision(38)) {
    if (decision(39)) return 11 + decision(39);
    t += 4;
  }
  t += 2 * decision(39);
  t += decision(39);
  return t;
}

int Cabac::skip_flag(bool b_slice, int inc) { return decision((b_slice ? 24 : 11) + inc); }

int Cabac::ref_idx(int inc0, int max) {  // U, ctxIdxInc 0-3, 4, 5 (Table 9-39)
  int v = 0;
  while (decision(54 + (v == 0 ? inc0 : v == 1 ? 4 : 5))) {
    if (++v > max) raise(kCorrupt, "ref_idx out of range");
  }
  return v;
}

int Cabac::mvd(int comp, int abs_sum) {  // UEG3, signedValFlag 1, uCoff 9 (9.3.2.3)
  const int base = comp ? 47 : 40;
  const int inc0 = abs_sum < 3 ? 0 : abs_sum > 32 ? 2 : 1;
  if (!decision(base + inc0)) return 0;
  int v = 1;
  static const int kInc[9] = {0, 3, 4, 5, 6, 6, 6, 6, 6};
  while (v < 9 && decision(base + kInc[v])) v++;
  if (v >= 9) {  // the Exp-Golomb suffix, k = 3
    if (stats) stats[kStat_cabac_mvd_suffix]++;
    int k = 3;
    while (bypass()) {
      v += 1 << k;
      if (++k > 24) raise(kCorrupt, "mvd suffix too long");
    }
    while (k--) v += bypass() << k;
  }
  return bypass() ? -v : v;
}

int Cabac::qp_delta(bool prev_nonzero) {  // U over the mapping of Table 9-3
  int k = 0;
  while (decision(60 + (k == 0 ? prev_nonzero : k == 1 ? 2 : 3))) {
    if (++k > 52) raise(kCorrupt, "mb_qp_delta out of range");
  }
  return (k & 1) ? (k + 1) / 2 : -(k / 2);
}

int Cabac::chroma_pred_mode(int inc0) {  // TU, cMax 3
  if (!decision(64 + inc0)) return 0;
  if (!decision(64 + 3)) return 1;
  return decision(64 + 3) ? 3 : 2;
}

int Cabac::intra_mode() {  // prev_intra*_pred_mode_flag (→ -1), rem_intra*_pred_mode (FL)
  if (decision(68)) return -1;
  int v = decision(69);
  v |= decision(69) << 1;
  v |= decision(69) << 2;
  return v;
}

int Cabac::cbp(const int cond_a[4], const int cond_b[4], int chroma_a, int chroma_b,
               int chroma2_a, int chroma2_b) {  // 9.3.2.6, 9.3.3.1.1.4
  // cond_a / cond_b: condTermFlagN of each 8×8 where N lies outside the
  // macroblock (-1 where N is inside, read from the bins decoded here)
  int luma = 0;
  for (int b8 = 0; b8 < 4; b8++) {
    const int a = cond_a[b8] >= 0 ? cond_a[b8] : !((luma >> (b8 - 1)) & 1);
    const int b = cond_b[b8] >= 0 ? cond_b[b8] : !((luma >> (b8 - 2)) & 1);
    luma |= decision(73 + a + 2 * b) << b8;
  }
  int chroma = 0;
  if (decision(77 + chroma_a + 2 * chroma_b)) chroma = 1 + decision(77 + 4 + chroma2_a + 2 * chroma2_b);
  return luma | chroma << 4;
}

int Cabac::transform_8x8(int inc) { return decision(399 + inc); }

// residual_block_cabac (7.3.5.3.3) with the coefficient ctxIdxInc of
// 9.3.3.1.3: levels by scan index 0..max-1 into `level`; returns the
// number of non-zero levels (0 when coded_block_flag is 0).
int Cabac::residual(int cat, int cbf_inc, int max, int32_t* level) {
  for (int i = 0; i < max; i++) level[i] = 0;
  if (cat != 5 && !decision(85 + kCbfCatOffset[cat] + cbf_inc)) return 0;
  const int sig_base = cat == 5 ? 402 : 105 + kSigCatOffset[cat];
  const int last_base = cat == 5 ? 417 : 166 + kSigCatOffset[cat];
  const int abs_base = cat == 5 ? 426 : 227 + kAbsCatOffset[cat];
  int idx[64], n = 0, num = max;
  for (int i = 0; i < num - 1; i++) {
    const int inc_sig = cat == 5 ? kSig8x8[i] : cat == 3 ? std::min(i, 2) : i;
    if (!decision(sig_base + inc_sig)) continue;
    idx[n++] = i;
    const int inc_last = cat == 5 ? kLast8x8[i] : cat == 3 ? std::min(i, 2) : i;
    if (decision(last_base + inc_last)) {
      num = i + 1;
      break;
    }
  }
  if (num == max) idx[n++] = max - 1;  // no last flag: the last coefficient is significant
  int eq1 = 0, gt1 = 0;
  const int gt1_max = cat == 3 ? 3 : 4;
  for (int j = n - 1; j >= 0; j--) {  // coeff_abs_level_minus1 (UEG0, uCoff 14), sign
    int v = 0;
    if (decision(abs_base + (gt1 ? 0 : std::min(4, 1 + eq1)))) {
      v = 1;
      const int ctx = abs_base + 5 + std::min(gt1_max, gt1);
      while (v < 14 && decision(ctx)) v++;
      if (v >= 14) {  // the Exp-Golomb suffix, k = 0
        if (stats) stats[kStat_cabac_level_suffix]++;
        int k = 0;
        while (bypass()) {
          v += 1 << k;
          if (++k > 24) raise(kCorrupt, "coeff_abs_level_minus1 suffix too long");
        }
        while (k--) v += bypass() << k;
      }
    }
    if (v == 0) eq1++;
    else gt1++;
    level[idx[j]] = bypass() ? -(v + 1) : v + 1;
  }
  return n;
}

// The spot checks' view of the tables (read_syntax kinds 3 and 4).
void cabac_table_rows(int kind, int arg, int n, int32_t* out) {
  if (kind == 3) {  // the initialised state of ctxIdx out[0..n) for arg = kind · 64 + SliceQPY
    Cabac c;
    const int k = arg / 64, qp = arg % 64;
    c.init_contexts(k == 0 ? 2 : 0, k == 0 ? 0 : k - 1, qp);
    for (int i = 0; i < n; i++) {
      const int ctx = out[i];
      out[i] = init_pair(k, ctx) ? (c.state[ctx] >> 1) * 2 + (c.state[ctx] & 1) : -1;
    }
    return;
  }
  for (int i = 0; i < n; i++) {  // kind 4: pStateIdx out[i] → rangeTabLPS row, transIdxLPS
    const int p = out[i] & 63;
    out[i] = kRangeLps[p][0] << 24 | kRangeLps[p][1] << 16 | kRangeLps[p][2] << 8 |
             kRangeLps[p][3];
    out[n + i] = kTransLps[p];
  }
}

}  // namespace h264
}  // namespace oatxt
