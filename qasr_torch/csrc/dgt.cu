// Kernel J: the row-contracting product out[K,N] = cast(sum_m x[m,k] y[m,n]).
//
// Replaces the TPU kernel benchmarks/probe_dgt.py:kern, which walks G chunks
// of M in order on one core, adds each chunk's x^T y into an f32 scratch
// accumulator and casts it once at the end. Two operand orientations, as the
// probe's two modes:
//   rows (the probe's "dgt"): x [M,K], rows contract with rows (a dW's form);
//   cols (the probe's "plain"): x pre-transposed to [K,M], a plain matmul.
// y [M,N] in both; bf16 or f32 in, f32 accumulation, one cast to x's type.
//
// What bounds it on an H100: at the probe's shape (M 65536, K = N = 256, bf16)
// it executes 8.6 GFLOP against 67 MB of input, ~128 FLOP/byte, under the
// card's ~295: the bytes (20 us at 3.35 TB/s). Blocks run in no order on 132
// SMs, so the TPU's sequential carry becomes a split of M: grid (N/64, K/64,
// S), block (n, k, s) sums its 64 x 64 tile over the s-th run of whole
// chunks of M into an f32 partial [S,K,N]; a second pass (qtile's
// reduce_splits, shared with kernel I) sums the S partials in fixed order
// and casts. No atomics: the same bits every run. The chunks
// arrive by cp.async kStages - 1 ahead. The product is qtile's: bf16 on
// mma.sync (rows mode feeds x^T through ldmatrix.trans, cols mode loads it
// straight; both hand the tensor cores the same fragments in the same order,
// so the two modes give the same bits), f32 on the CUDA cores in the same
// order in both modes.
#include "qtile.cuh"

using namespace qtile;

namespace {

constexpr int kStages = 4;
constexpr int kMinBlocks = 4;
constexpr int kStaticSmem = 48 * 1024;  // above it a launch needs an attribute

// rows of M per chunk: the mma's contraction
template <typename T>
struct DgtCfg;
template <>
struct DgtCfg<__nv_bfloat16> {
  static constexpr int MC = 32;
};
template <>
struct DgtCfg<float> {
  static constexpr int MC = 16;
};

// One stage: the x tile (rows mode: [MC][kLdb], rows m; cols mode:
// [BM][lda(MC)], rows k), then the y tile [MC][kLdb]. The strides are those
// ProductAT::mma_t and Product::mma read.
template <typename T, bool kRows>
struct DgtLayout {
  static constexpr int MC = DgtCfg<T>::MC;
  static constexpr int ldx = kRows ? Elem<T>::kLdb : Elem<T>::lda(MC);
  static constexpr int ldy = Elem<T>::kLdb;
  static constexpr int x_bytes = align128((kRows ? MC : BM) * ldx * (int)sizeof(T));
  static constexpr int y_bytes = align128(MC * ldy * (int)sizeof(T));
  static constexpr int stage = x_bytes + y_bytes;
  static constexpr int total = kStages * stage;
};

template <typename T, bool kRows>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dgt_kernel(const T* __restrict__ x, const T* __restrict__ y, float* __restrict__ part, int M,
           int K, int N, int chunks_per_split) {
  using L = DgtLayout<T, kRows>;
  constexpr int V = Elem<T>::kVec, MC = L::MC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, s = blockIdx.z;
  const int first = s * chunks_per_split;
  const int count = min(chunks_per_split, (M + MC - 1) / MC - first);

  // chunk first + i into stage i % kStages; rows (or columns) past M and
  // columns past K or N are zero-filled, so they add nothing
  auto issue = [&](int i) {
    unsigned char* st = smem + (i % kStages) * L::stage;
    T* xs = reinterpret_cast<T*>(st);
    T* ys = reinterpret_cast<T*>(st + L::x_bytes);
    const int m0 = (first + i) * MC;
    constexpr int VPR = BN / V;  // 16-byte vectors in a 64-wide row
    for (int e = threadIdx.x; e < MC * VPR; e += kThreads) {
      const int r = e / VPR, c = (e % VPR) * V, m = m0 + r;
      const bool oky = m < M && n0 + c < N;
      cp_async16(ys + r * L::ldy + c, oky ? y + (size_t)m * N + n0 + c : y, oky);
      if constexpr (kRows) {
        const bool okx = m < M && k0 + c < K;
        cp_async16(xs + r * L::ldx + c, okx ? x + (size_t)m * K + k0 + c : x, okx);
      }
    }
    if constexpr (!kRows) {
      constexpr int VPC = MC / V;  // 16-byte vectors in a chunk's row of x^T
      for (int e = threadIdx.x; e < BM * VPC; e += kThreads) {
        const int r = e / VPC, c = (e % VPC) * V, k = k0 + r, m = m0 + c;
        const bool okx = k < K && m < M;  // M % V == 0: a vector is all in or all out
        cp_async16(xs + r * L::ldx + c, okx ? x + (size_t)k * M + m : x, okx);
      }
    }
  };

  ProductAT<T, MC> prod;  // its mma (cols mode) is Product's
  prod.zero();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i has landed; chunk i - 1's stage is consumed
    if (i + kStages - 1 < count) issue(i + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % kStages) * L::stage;
    const T* xs = reinterpret_cast<const T*>(st);
    const T* ys = reinterpret_cast<const T*>(st + L::x_bytes);
    if constexpr (kRows)
      prod.mma_t(xs, ys);
    else
      prod.mma(xs, ys);
  }

  float* out = part + (size_t)s * K * N;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = k0 + prod.row(j), n = n0 + prod.col(j);
    if (k < K && n < N) out[(size_t)k * N + n] = prod.at(j);
  }
}

template <typename T, bool kRows>
int launch(const void* x, const void* y, float* part, void* out, int M, int K, int N,
           int splits, cudaStream_t stream) {
  constexpr int MC = DgtCfg<T>::MC, smem = DgtLayout<T, kRows>::total;
  static_assert(smem <= kStaticSmem, "kernel J's stages need no shared-memory attribute");
  const int chunks = (M + MC - 1) / MC;
  const int per_split = (chunks + splits - 1) / splits;
  if (splits < 1 || (splits - 1) * per_split >= chunks) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, splits);
  dgt_kernel<T, kRows><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), part, M, K, N, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_splits(part, static_cast<T*>(out), splits, (size_t)K * N, stream);
}

}  // namespace

extern "C" {

// x [M,K] (rows = 1) or [K,M] (rows = 0) and y [M,N] in the compute dtype
// (0 = float32, 1 = bfloat16); part [splits,K,N] f32 scratch; out [K,N] in
// the compute dtype. K and N multiples of 8, and M too when rows = 0;
// every one of the splits runs of ceil(chunks / splits) chunks holds at
// least one chunk. Returns a cudaError_t (0 on success).
int qasr_dgt(const void* x, const void* y, void* part, void* out, int M, int K, int N,
             int splits, int rows, int dtype, void* stream) {
  if (M < 1 || K % 8 || N % 8 || (!rows && M % 8) || (K + BM - 1) / BM > 65535 ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return rows ? launch<float, true>(x, y, p, out, M, K, N, splits, st)
                : launch<float, false>(x, y, p, out, M, K, N, splits, st);
  if (dtype == 1)
    return rows ? launch<__nv_bfloat16, true>(x, y, p, out, M, K, N, splits, st)
                : launch<__nv_bfloat16, false>(x, y, p, out, M, K, N, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
