// The quaternion GEMM of P products on the component-leading layout, shared
// by kernel B (qgemm8.cu, the rank-8 scheme, P = 8) and kernel H
// (qgemm10.cu, the 10-product scheme, P = 10):
//
//   y4[b] = sum_p O[b,p] ((sum_a V[p,a] x4[a]) @ wc[p])
//
// x4 [4,M,K], wc [P,K,N] (U-combined), y4 [4,M,N]; f32 accumulation, the
// output in the input's type. M is masked in the kernel; the wrappers pad K
// and N to multiples of 8 (one 16-byte bf16 vector).
//
// What bounds it on an H100 (bf16): a block owns a 64 x 64 tile of all four
// outputs (P f32 accumulators of it take 128 or 160 registers a thread, so
// one block an SM and no larger tile), so every x tile is read by N/64
// blocks and every weight tile by M/64: about 2 * (4 M K N + P K N M) / 64
// bytes reach the SMs from L2, ~1.3 GB at M4096 K3328 N256 (P = 8) against
// ~0.06 ms of tensor-core work. That re-fetch bounds a call: with the
// products taken out the copies alone take ~0.146 ms there (~9 TB/s into
// the SMs), with the copies taken out the products ~0.127 (PERF.md §6).
//
// The design (bf16):
// - Two warpgroups each run half the products over the block's whole 64 x
//   64 tile with wgmma (A, the input combos, from registers; B, the
//   product's weight tile, from shared memory), so each product's f32
//   accumulator stays in registers for the whole run and the fold with O
//   runs once, at the end, through shared memory. A warp forms the combos
//   of its 16 rows in registers from the ldmatrix fragments of the four
//   components, in the storage dtype as the TPU kernel forms them (qtile's
//   wg_combo: B's V8 combos by combo2, each term scaled by its coefficient
//   rounded to bf16, each scaled term and their sum rounded once; H's unit
//   combos by one addition, the same bits): no combo reaches shared memory.
//   Each product's input terms are compiled in (the host checks the tables
//   it is passed).
// - One barrier a K chunk of 32: the chunk's four components and its P
//   weight tiles arrive by TMA in a ring of four stages, all but the one
//   being read in flight, each stage behind a full-barrier (mbarrier).
//   Tiles are stored swizzled (x rows of 64 bytes in the 64-byte pattern,
//   weight rows of 128 bytes in the 128-byte pattern, which is wgmma's
//   layout for an N-contiguous B), so the ldmatrix rows fall in distinct
//   bank groups without padding.
// - The weight re-fetch: TMA moves the tiles ~1.3x faster than cp.async
//   from every thread, and the block's eight warps (not one a product: ten
//   warps left two of the SM's four schedulers a third) keep the products
//   under the copies' time. Sharing each chunk's weight tiles among a
//   cluster of 2 or 4 blocks along M by TMA multicast divides their L2
//   reads but not the bytes each SM takes in, and measured slower (PERF.md
//   §6, the versions of the main loop).
// f32 keeps the CUDA-core loop (one product at a time over a resident
// chunk, folded into four accumulators): it is on no timed path.
#pragma once

#include "qtile.cuh"

namespace qgemm {

using namespace qtile;

// ---------------------------------------------------------------------------
// f32: the CUDA-core loop
// ---------------------------------------------------------------------------

constexpr int kKcF32 = 32;  // K chunk a step

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
qgemm_f32_kernel(const float* __restrict__ x4, const float* __restrict__ wc,
                 float* __restrict__ y4, int M, int K, int N, Scheme<P> scheme) {
  using T = float;
  constexpr int V = Elem<T>::kVec, KC = kKcF32;
  constexpr int LDB = Layout<T, KC, P>::ldb;
  using Prod = Product<T, KC>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T, KC, P> L(BM, 1);
  Scheme<P>& sch = *reinterpret_cast<Scheme<P>*>(smem);
  if (threadIdx.x == 0) sch = scheme;
  T* A = reinterpret_cast<T*>(smem + L.a);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const size_t comp_stride = (size_t)M * K;
  const int nchunks = (K + KC - 1) / KC;
  const int nsteps = nchunks * P;  // step = chunk * P + product

  // copies; each thread keeps one 16-byte column of the rows it copies
  auto issue_x = [&](int chunk) {  // the four components of a K chunk
    constexpr int VPR = KC / V, RSTEP = kThreads / VPR;
    T* xs = reinterpret_cast<T*>(smem + L.x + (chunk % 2) * L.x_bytes);
    const int v = threadIdx.x % VPR, k = chunk * KC + v * V;
    for (int r = threadIdx.x / VPR; r < BM; r += RSTEP) {
      const bool ok = m0 + r < M && k < K;
      const size_t off = ok ? (size_t)(m0 + r) * K + k : 0;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        cp_async16(xs + (a * BM + r) * KC + v * V, x4 + a * comp_stride + off, ok);
    }
  };
  auto issue_w = [&](int step) {  // one product's weights for one chunk
    constexpr int VPRB = BN / V, KSTEP = kThreads / VPRB;
    const int p = step % P, k0 = (step / P) * KC;
    T* ws = reinterpret_cast<T*>(smem + L.w + (step % 2) * L.w_bytes);
    const T* wp = wc + (size_t)p * K * N;
    const int vb = threadIdx.x % VPRB, n = n0 + vb * V;
    for (int kr = threadIdx.x / VPRB; kr < KC; kr += KSTEP) {
      const bool ok = k0 + kr < K && n < N;
      cp_async16(ws + kr * LDB + vb * V, ok ? wp + (size_t)(k0 + kr) * N + n : wp, ok);
    }
  };

  float y[4][kPerThread];
#pragma unroll
  for (int bo = 0; bo < 4; ++bo)
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) y[bo][j] = 0.0f;

  __syncthreads();  // the scheme
  issue_x(0);
  issue_w(0);
  cp_async_commit();
  Prod prod;
  for (int step = 0; step < nsteps; ++step) {
    const int chunk = step / P, p = step % P;
    cp_async_wait_all();
    __syncthreads();  // this step's copies have landed; the last step's tiles are consumed
    // the next copies overwrite only what the last step read
    if (step + 1 < nsteps) issue_w(step + 1);
    if (p == P - 2 && chunk + 1 < nchunks) issue_x(chunk + 1);
    cp_async_commit();
    form_combos<T, KC>(A, reinterpret_cast<const T*>(smem + L.x + (chunk % 2) * L.x_bytes),
                       BM, sch, p);
    __syncthreads();  // A is complete
    prod.zero();
    prod.mma(A, reinterpret_cast<const T*>(smem + L.w + (step % 2) * L.w_bytes));
    fold(y, prod, sch, p);
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int m = m0 + Prod::row(j), n = n0 + Prod::col(j);
    if (m >= M || n >= N) continue;
#pragma unroll
    for (int bo = 0; bo < 4; ++bo)
      y4[((size_t)bo * M + m) * N + n] = Elem<T>::from_f(y[bo][j]);
  }
}

// ---------------------------------------------------------------------------
// bf16: the ring and the products
// ---------------------------------------------------------------------------

constexpr int kKc = 32;      // K a chunk: two 16-deep steps
constexpr int kStages = 4;   // the ring's stages
constexpr int kXTile = BM * kKc * 2;     // one component of a chunk: 64 rows of 64 bytes
constexpr int kXBytes = 4 * kXTile;      // 16 KB
constexpr int kWTile = kKc * BN * 2;     // one product's weights: 32 rows of 128 bytes
constexpr int kThreadsBf16 = 2 * 128;    // two warpgroups

// Offsets from the block's 1024-aligned base: the stages, each the chunk's
// x [4][BM][kKc] then its weights [P][kKc][BN]; then the stages' full
// barriers. At the end the P f32 product tiles [P][BM][kFoldLd] of the
// fold reuse the ring.
template <int P>
struct Ring {
  static constexpr int stage = kXBytes + P * kWTile;  // a multiple of 1024
  static constexpr int fold = P * BM * kFoldLd * 4;
  static constexpr int ring = kStages * stage > fold ? kStages * stage : fold;
  static constexpr int bars = ring;
  static constexpr int total = 1024 + ring + kStages * 8;  // 1024: room to align the base
};

// A warpgroup's H = P/2 products over the block's 64 x 64 tile (WgAcc):
// warp wr of the group holds rows wr*16 .. +16 of each; acc[j][i] is
// product G*H + j at row wr*16 + lane/4 (+8 for i%4 >= 2), column (i/4)*8 +
// 2*(lane%4) + i%2
template <int P>
struct WgProducts : WgAcc<P> {
  using WgAcc<P>::H, WgAcc<P>::acc, WgAcc<P>::c1, WgAcc<P>::c2;

  // one chunk: xs the stage's x, ws its weights (shared addresses)
  template <int G>
  __device__ void chunk(unsigned xs, unsigned ws, int wr, int lane) {
    const int lr = lane % 16, lu = lane / 16;
#pragma unroll
    for (int kk = 0; kk < kKc / 16; ++kk) {
      // the four components' fragments of this warp's rows: lanes 0-15 rows
      // 0-15 at unit 0, lanes 16-31 the same rows 8 elements on
      unsigned f[4][4];
      const unsigned off = x_off(wr * 16 + lr, kk * 2 + lu);
#pragma unroll
      for (int a = 0; a < 4; ++a) ldsm_x4(f[a], xs + a * kXTile + off);
      unsigned A[H][4];
#pragma unroll
      for (int j = 0; j < H; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) A[j][q] = wg_combo<P>(f, G * H + j, q, c1[j], c2[j]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < H; ++j)
        wgmma_64x64x16(acc[j], A[j], w_desc(ws + (G * H + j) * kWTile + kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait0();  // the stage is read and the registers free before it is refilled
  }

  // this warpgroup's products into the fold's tiles fs [P][BM][kFoldLd]
  template <int G>
  __device__ void store(float* fs, int wr, int lane) const {
    wg_store<H, G>(acc, fs, wr, lane);
  }
};

template <int P>
__global__ void __launch_bounds__(kThreadsBf16, 1)
qgemm_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ y4,
                  int M, int K, int N, Scheme<P> sch) {
  using R = Ring<P>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* buf = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const unsigned base = smem_u32(buf);
  const unsigned bars = base + R::bars;  // the full barrier of stage s at bars + 8 s
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nchunks = (K + kKc - 1) / kKc;

  // chunk `chunk` into its stage (thread 0): the x box and the P weight
  // boxes, zero past M, K and N
  auto issue = [&](int chunk) {
    const int s = chunk % kStages, k0 = chunk * kKc;
    const unsigned xs = base + s * R::stage, bar = bars + 8 * s;
    mbar_expect_tx(bar, R::stage);
    tma_load_3d(xs, &xmap, bar, k0, m0, 0);
    for (int p = 0; p < P; ++p) tma_load_3d(xs + kXBytes + p * kWTile, &wmap, bar, n0, k0, p);
  };

  // warpgroup G runs products G*P/2 .. +P/2; its warp wr holds rows wr*16 ..
  const int G = warp / 4, wr = warp % 4;
  WgProducts<P> wg;
  if (G == 0)
    wg.template init<0>(sch);
  else
    wg.template init<1>(sch);
  auto compute = [&](int s) {
    const unsigned xs = base + s * R::stage;
    if (G == 0)
      wg.template chunk<0>(xs, xs + kXBytes, wr, lane);
    else
      wg.template chunk<1>(xs, xs + kXBytes, wr, lane);
  };

  // ---- the main loop: one barrier a chunk
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages && i < nchunks; ++i) issue(i);
  for (int i = 0; i < nchunks; ++i) {
    mbar_wait(bars + 8 * (i % kStages), (i / kStages) & 1);
    compute(i % kStages);
    __syncthreads();  // every warp is done with chunk i: refill its stage
    if (threadIdx.x == 0 && i + kStages < nchunks) issue(i + kStages);
  }

  // ---- the fold, once: y_b = sum_p O[b,p] prod_p in f32, product order
  // (every copy has landed and every warp is done with the ring)
  float* fs = reinterpret_cast<float*>(buf);  // [P][BM][kFoldLd]
  if (G == 0)
    wg.template store<0>(fs, wr, lane);
  else
    wg.template store<1>(fs, wr, lane);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN / 2; e += kThreadsBf16) {
    const int r = e / (BN / 2), c = (e % (BN / 2)) * 2;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;  // N % 8 == 0: n < N means n + 1 < N
    float y[4][2];
#pragma unroll
    for (int bo = 0; bo < 4; ++bo) y[bo][0] = y[bo][1] = 0.0f;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(fs + (q * BM + r) * kFoldLd + c);
#pragma unroll
      for (int bo = 0; bo < 4; ++bo) {
        y[bo][0] += sch.out[bo][q] * v.x;
        y[bo][1] += sch.out[bo][q] * v.y;
      }
    }
#pragma unroll
    for (int bo = 0; bo < 4; ++bo)
      *reinterpret_cast<__nv_bfloat162*>(y4 + ((size_t)bo * M + m) * N + n) =
          __floats2bfloat162_rn(y[bo][0], y[bo][1]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int P>
int launch_f32(const void* x4, const void* wc, void* y4, int M, int K, int N,
               const Scheme<P>& s, cudaStream_t stream) {
  const int bytes = Layout<float, kKcF32, P>(BM, 1).total;
  // once per instantiation (one device a process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      qgemm_f32_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm_f32_kernel<P><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x4), static_cast<const float*>(wc), static_cast<float*>(y4), M,
      K, N, s);
  return (int)cudaGetLastError();
}

template <int P>
int launch_bf16(const void* x4, const void* wc, void* y4, int M, int K, int N,
                const Scheme<P>& s, cudaStream_t stream) {
  constexpr int smem = Ring<P>::total;
  static_assert(smem <= kMaxSmem, "the GEMM's ring exceeds a block's shared memory");
  // once per instantiation (one device a process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      qgemm_bf16_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[3] = {(cuuint64_t)K, (cuuint64_t)M, 4};
  const cuuint64_t wdims[3] = {(cuuint64_t)N, (cuuint64_t)K, P};
  const cuuint32_t xbox[3] = {kKc, BM, 4}, wbox[3] = {BN, kKc, 1};
  if (encode_bf16(&xmap, x4, 3, xdims, xbox, CU_TENSOR_MAP_SWIZZLE_64B) != 0 ||
      encode_bf16(&wmap, wc, 3, wdims, wbox, CU_TENSOR_MAP_SWIZZLE_128B) != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm_bf16_kernel<P><<<grid, kThreadsBf16, smem, stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(y4), M, K, N, s);
  return (int)cudaGetLastError();
}

// The body of a C entry (qasr_qgemm8, qasr_qgemm10): dtype 0 = float32,
// 1 = bfloat16; v [P*4] and o [4*P] are the scheme's host tables. Returns a
// cudaError_t (0 on success).
template <int P>
int entry(const void* x4, const void* wc, void* y4, int M, int K, int N, int dtype,
          const float* v, const float* o, void* stream) {
  Scheme<P> s;
  if (make_scheme(v, o, &s) != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && !wg_scheme_ok(s))  // the bf16 kernel's input terms are compiled in
    return (int)cudaErrorInvalidValue;
  if (M < 1 || K % 8 || N % 8 || (M + BM - 1) / BM > 65535 ||
      reinterpret_cast<uintptr_t>(x4) % 16 || reinterpret_cast<uintptr_t>(wc) % 16 ||
      reinterpret_cast<uintptr_t>(y4) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32<P>(x4, wc, y4, M, K, N, s, st);
  if (dtype == 1) return launch_bf16<P>(x4, wc, y4, M, K, N, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace qgemm
