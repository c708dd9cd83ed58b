// Tile variants of the f32 flash kernel, for tools/flash_tiles.py: the
// shipped source, included as it is, instantiated at other (hd_pad, TM,
// TN, TY, UD, UP) tiles (the meaning of each in the kernel's `Tile`).
// Variants 0, 5 and 8 are the tiles the C entry ships (Tile64, Tile128,
// Tile256).
#include "../src/repro_torch/kernels/csrc/flash_attention.cu"

namespace {

template <class TL>
int go(Args* a, const void* q, const void* k, const void* v, void* out,
       int B, int H, int K, int Sq, int Skv, int hd, const long long* st,
       int causal, int has_window, long long window, long long q_offset,
       float scale, cudaStream_t s) {
  if (hd > TL::HDP || (TL::HDP > 64 && hd <= TL::HDP / 2))
    return cudaErrorInvalidValue;      // not this variant's head dims
  const int err = make_args(a, q, k, v, out, B, H, K, Sq, Skv, hd, hd,
                            st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                            st[7], st[8], causal, has_window, window,
                            q_offset, scale, 0, TL::BM);
  return err ? err : run<TL>(*a, s);
}

}  // namespace

#define DEAL_TILES(X)                                                    \
  X(0, 64, 8, 4, 8, 1, 4)                                                \
  X(1, 64, 8, 4, 8, 2, 4)                                                \
  X(2, 64, 4, 4, 16, 4, 4)                                               \
  X(3, 64, 8, 4, 16, 1, 2)                                               \
  X(4, 64, 8, 2, 8, 1, 4)                                                \
  X(5, 128, 8, 2, 8, 1, 1)                                               \
  X(6, 128, 8, 2, 8, 2, 4)                                               \
  X(7, 128, 4, 2, 16, 1, 2)                                              \
  X(8, 256, 4, 4, 16, 2, 4)                                              \
  X(9, 256, 4, 2, 16, 2, 4)                                              \
  X(10, 256, 8, 4, 8, 1, 2)
constexpr int kVariants = 11;

// (hd_pad, TM, TN, TY, UD, UP) of each variant, for the script
extern "C" int flash_tile_shape(int variant, int* out6) {
  static const int kShapes[][6] = {
#define DEAL_SHAPE(N, ...) {__VA_ARGS__},
      DEAL_TILES(DEAL_SHAPE)
#undef DEAL_SHAPE
  };
  if (variant < 0 || variant >= kVariants) return 1;
  for (int i = 0; i < 6; ++i) out6[i] = kShapes[variant][i];
  return 0;
}

// the C entry's arguments (v's head dim that of q and k) with the nine
// strides as an array, plus the variant
extern "C" int flash_tile(const void* q, const void* k, const void* v,
                          void* out, int B, int H, int K, int Sq, int Skv,
                          int hd, const long long* strides, int causal,
                          int has_window, long long window,
                          long long q_offset, float scale, int variant,
                          void* stream) {
  Args a;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEAL_TILE(N, ...)                                                  \
  case N:                                                                  \
    return go<Tile<__VA_ARGS__>>(&a, q, k, v, out, B, H, K, Sq, Skv, hd,   \
                                 strides, causal, has_window, window,      \
                                 q_offset, scale, s);
  switch (variant) {
    DEAL_TILES(DEAL_TILE)
    default:
      return cudaErrorInvalidValue;
  }
#undef DEAL_TILE
}
