// The one decision of the planar histogram's launcher: where a launch
// keeps its sub-histograms.  Plain C++ with no CUDA header, so that the
// CPU tests compile it alone with g++ (tests/test_torch_histogram.py).
#pragma once

namespace planar_histogram {

//: where the sub-histograms lie (kernels/histogram.py's HISTOGRAM_PATHS
//: names them in this order)
enum Path { kWarpPrivate = 0, kBlockSmem = 1, kGlobalBins = 2 };

//: the bins of one warp's copy on the warp_private path
constexpr unsigned kWarpBins = 256;

// The bins a launch can count: the alphabet, cut to what the width holds
// (u8: 256, u16: 65536).
inline unsigned bins_of(int a_count, int sym_bytes) {
  const long long most = sym_bytes == 1 ? 256 : sym_bytes == 2 ? 65536
                                                               : a_count;
  return static_cast<unsigned>(a_count < most ? a_count : most);
}

// The path of a launch over `bins_of(a_count, sym_bytes)` bins: one u32
// copy a warp up to 256 bins, one a CTA while its u32 bins fit the
// `smem_optin` bytes a CTA may opt in to, else u64 atomics on the totals.
inline int path_of(int a_count, int sym_bytes, int smem_optin) {
  const unsigned bins = bins_of(a_count, sym_bytes);
  if (bins <= kWarpBins) return kWarpPrivate;
  if (4ull * bins <= static_cast<unsigned long long>(smem_optin))
    return kBlockSmem;
  return kGlobalBins;
}

}  // namespace planar_histogram
