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
// SMs, so the TPU's sequential carry becomes a split of M: grid (N tiles, K
// tiles, S), block (n, k, s) sums its output tile over the s-th run of M's
// chunks (dgt.py: j_splits, the chunks shared out as evenly as whole chunks
// allow) into an f32 partial; a second pass sums the partials in fixed
// order and casts. No atomics: the same bits every run.
//
// The design (bf16): every input byte should enter the SMs about once. A
// block owns a 128 (K) x 256 (N) tile, so at the probe's shape each x
// element is read by one block and each y element by two (~100 MB into the
// SMs for 67 MB of input; 64 x 64 tiles read each byte four times). Two
// warpgroups each hold an m64 x n256 f32 accumulator (128 registers a
// thread) for the whole run and multiply on wgmma: A = x^T from registers
// (ldmatrix.trans from x's [m][k] tile in rows mode, ldmatrix from x^T's
// [k][m] tile in cols mode: the same fragments in the same order, so the
// two modes give the same bits), B = y by descriptor (N contiguous, four
// 64-wide swizzle atoms, one n64 wgmma each). Chunks of 64 rows of M arrive
// by TMA (rows of 128 bytes in the 128-byte swizzle; zero past M, K and N)
// in a ring of three 48 KB stages behind one mbarrier each, one block
// barrier a chunk, one block an SM; S fills one wave (66 runs at the
// probe's shape on 132 SMs). The partials, not the loop, are what the
// bytes leave to trim (PERF.md §6): a cluster pairs two runs, and each
// block hands the half of its tile that its partner stores over
// distributed shared memory (one 16-byte store a float4, then an arrival
// on the partner's mbarrier), which halves the partials to 8.7 MB; the
// second pass drops each partial's L2 lines once read
// (discard.global.L2), so the dead scratch is never written back to HBM.
//
// f32 keeps the CUDA-core loop on 64 x 64 tiles (qtile's ProductAT, chunks
// of 16 rows by cp.async, no pairs, qtile's reduce_splits): no timed path
// runs it.
#include "qtile.cuh"

using namespace qtile;

namespace {

// Run s of `splits` runs of M: chunks [first, first + count), the chunks
// shared out as evenly as whole chunks allow (none empty when splits <=
// chunks)
struct Run {
  int first, count;
  __device__ Run(int s, int splits, int chunks)
      : first((int)((long long)s * chunks / splits)),
        count((int)((long long)(s + 1) * chunks / splits) - first) {}
};

// ---------------------------------------------------------------------------
// f32: the CUDA-core loop; its output tile is qtile's BM x BN
// ---------------------------------------------------------------------------

constexpr int kChunkF32 = 16;   // rows of M a chunk
constexpr int kStagesF32 = 4;   // the cp.async ring
constexpr int kBlocksF32 = 4;   // blocks resident on an SM
constexpr int kStaticSmem = 48 * 1024;  // above it a launch needs an attribute

// One stage: the x tile (rows mode: [MC][kLdb], rows m; cols mode:
// [BM][lda(MC)], rows k), then the y tile [MC][kLdb]. The strides are those
// ProductAT::mma_t and Product::mma read.
template <bool kRows>
struct F32Layout {
  using E = Elem<float>;
  static constexpr int MC = kChunkF32;
  static constexpr int ldx = kRows ? E::kLdb : E::lda(MC);
  static constexpr int ldy = E::kLdb;
  static constexpr int x_bytes = align128((kRows ? MC : BM) * ldx * 4);
  static constexpr int y_bytes = align128(MC * ldy * 4);
  static constexpr int stage = x_bytes + y_bytes;
  static constexpr int total = kStagesF32 * stage;
};

template <bool kRows>
__global__ void __launch_bounds__(kThreads, kBlocksF32)
dgt_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ part, int M, int K, int N, int splits) {
  using L = F32Layout<kRows>;
  constexpr int V = Elem<float>::kVec, MC = L::MC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, s = blockIdx.z;
  const Run run(s, splits, (M + MC - 1) / MC);
  const int first = run.first, count = run.count;

  // chunk first + i into stage i % kStagesF32; rows (or columns) past M and
  // columns past K or N are zero-filled, so they add nothing
  auto issue = [&](int i) {
    unsigned char* st = smem + (i % kStagesF32) * L::stage;
    float* xs = reinterpret_cast<float*>(st);
    float* ys = reinterpret_cast<float*>(st + L::x_bytes);
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

  ProductAT<float, MC> prod;  // its mma (cols mode) is Product's
  prod.zero();
#pragma unroll
  for (int i = 0; i < kStagesF32 - 1; ++i) {
    if (i < count) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStagesF32 - 2>();
    __syncthreads();  // chunk i has landed; chunk i - 1's stage is consumed
    if (i + kStagesF32 - 1 < count) issue(i + kStagesF32 - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % kStagesF32) * L::stage;
    const float* xs = reinterpret_cast<const float*>(st);
    const float* ys = reinterpret_cast<const float*>(st + L::x_bytes);
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

template <bool kRows>
int launch_f32(const void* x, const void* y, float* part, void* out, int M, int K, int N,
               int splits, cudaStream_t stream) {
  constexpr int smem = F32Layout<kRows>::total;
  static_assert(smem <= kStaticSmem, "kernel J's f32 stages need no shared-memory attribute");
  if (splits > (M + kChunkF32 - 1) / kChunkF32) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, splits);
  dgt_f32_kernel<kRows><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), part, M, K, N, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_splits(part, static_cast<float*>(out), splits, (size_t)K * N, stream);
}

// ---------------------------------------------------------------------------
// bf16: the TMA ring and wgmma
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;     // rows of M a chunk: four 16-deep wgmma steps
constexpr int kTileK = 128;    // output rows a block: a warpgroup's m64 each
constexpr int kTileN = 256;    // output columns a block: four 64-wide atoms
constexpr int kStages = 3;     // the ring's stages (four measured no faster)
constexpr int kBlocks = 1;     // blocks resident on an SM
constexpr int kThreadsBf16 = 2 * 128;  // two warpgroups
constexpr int kCluster = 2;    // runs a cluster pairs: their partials summed in shared memory

constexpr int kBox = 64;                      // a box row: 64 bf16, 128 bytes
constexpr int kBoxBytes = kChunk * kBox * 2;  // a [64][64] box: 8 KB
constexpr int kXBytes = kTileK * kChunk * 2;  // x's part of a stage: 16 KB
constexpr int kStage = kXBytes + kTileN * kChunk * 2;  // and y's: 48 KB
// A warpgroup's accumulators as the partner hands them over: float4 q of
// thread t of the warpgroup at [q][t], so a warp's 16-byte stores and
// loads are 512 contiguous bytes
constexpr int kHalfBytes = kTileN / kBox * 32 * 128 * 4;  // 64 KB
// From the block's 1024-aligned base: the ring, the half-tile a partner
// hands over, the stages' full barriers and the handover's barrier
constexpr int kHalf = kStages * kStage;
constexpr int kBars = kHalf + kHalfBytes;
constexpr int kSmem = 1024 + kBars + (kStages + 1) * 8;  // 1024: room to align

// The cluster a launch of `splits` runs takes along them: pairs where the
// runs pair up
constexpr int cluster_of(int splits) { return splits % kCluster ? 1 : kCluster; }

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(v));
  return v;
}

// 16 bytes into block `rank`'s shared memory at this block's address a
__device__ __forceinline__ void st_cluster_f4(unsigned a, unsigned rank, float4 v) {
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(r), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// an arrival, releasing this thread's writes to the cluster, on the
// mbarrier of block `rank` at this block's address bar
__device__ __forceinline__ void mbar_arrive_cluster(unsigned bar, unsigned rank) {
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(r)
               : "memory");
}

// mbar_wait's acquire at cluster scope: what the arrivals of other blocks
// released is visible after it
__device__ __forceinline__ void mbar_wait_cluster(unsigned bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}

// byte offset of 16-byte unit c of row r in a tile of 128-byte rows as TMA
// writes it in the 128-byte swizzle (r from a 1024-aligned start)
__device__ __forceinline__ unsigned sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// A stage from its 1024-aligned start: x (rows mode: two boxes [64 m][64 k],
// box b the K rows of warpgroup b; cols mode: one box [128 k][64 m]), then y
// (four boxes [64 m][64 n]).
template <bool kRows>
__global__ void __launch_bounds__(kThreadsBf16, kBlocks)
dgt_wg_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
              float* __restrict__ part, int M, int K, int N, int splits) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = raw + ((1024u - (raw & 1023u)) & 1023u);
  const unsigned bars = base + kBars;  // stage s's full barrier at bars + 8 s
  const unsigned half_bar = bars + 8 * kStages;  // the partner's half-tile has landed
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = warp / 4, wr = warp % 4;  // warpgroup G: output rows G*64 ..; warp wr: wr*16 ..
  const int n0 = blockIdx.x * kTileN, k0 = blockIdx.y * kTileK, s = blockIdx.z;
  const Run run(s, splits, (M + kChunk - 1) / kChunk);
  const int first = run.first, count = run.count;
  // boxes wholly past K (rows mode) or N are not loaded: their stale rows
  // and columns reach only outputs that are not stored
  const int xboxes = kRows ? min(2, (K - k0 + kBox - 1) / kBox) : 1;
  const int yboxes = min(kTileN / kBox, (N - n0 + kBox - 1) / kBox);
  const unsigned bytes = (kRows ? xboxes * kBoxBytes : kXBytes) + yboxes * kBoxBytes;

  // chunk first + i into stage i % kStages (thread 0)
  auto issue = [&](int i) {
    const int st = i % kStages, m0 = (first + i) * kChunk;
    const unsigned xs = base + st * kStage, ys = xs + kXBytes, bar = bars + 8 * st;
    mbar_expect_tx(bar, bytes);
    if constexpr (kRows) {
      for (int b = 0; b < xboxes; ++b)
        tma_load_2d(xs + b * kBoxBytes, &xmap, bar, k0 + b * kBox, m0);
    } else {
      tma_load_2d(xs, &xmap, bar, m0, k0);
    }
    for (int j = 0; j < yboxes; ++j) tma_load_2d(ys + j * kBoxBytes, &ymap, bar, n0 + j * kBox, m0);
  };

  // the A fragment's ldmatrix address (16 K rows x 16 of M) from the stage's
  // x, at k16 step 0; a step adds 16 rows of M. Rows mode, transposed: lane
  // l addresses row m (l/16)*8 + l%8 at K unit 2 wr + (l/8)%2 of box G; cols
  // mode: row k G*64 + wr*16 + l%16 at M unit l/16 (+2 a step). Both give
  // the four 8 x 8 matrices (K 0-7, M 0-7), (K 8-15, M 0-7), (K 0-7, M 8-15),
  // (K 8-15, M 8-15): the A registers' order.
  const int xr = kRows ? (lane / 16) * 8 + lane % 8 : G * 64 + wr * 16 + lane % 16;
  const int xu = kRows ? 2 * wr + (lane / 8) % 2 : lane / 16;
  const unsigned xoff = kRows ? G * kBoxBytes + sw128(xr, xu) : 0u;

  float acc[kTileN / kBox][32];  // acc[j]: columns j*64 .. +64
#pragma unroll
  for (int j = 0; j < kTileN / kBox; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;

  const unsigned csize = cluster_size(), rank = cluster_rank();
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, 1);
    mbar_init(half_bar, 128);  // one arrival a thread of the partner's warpgroup
    fence_mbar_init();
  }
  if (csize > 1)
    cluster_sync();  // the barriers are set before the partner can arrive
  else
    __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages && i < count; ++i) issue(i);
  for (int i = 0; i < count; ++i) {
    const int st = i % kStages;
    mbar_wait(bars + 8 * st, (i / kStages) & 1);
    const unsigned xs = base + st * kStage, ys = xs + kXBytes;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      unsigned a[4];
      if constexpr (kRows)
        ldsm_x4_trans(a, xs + xoff + kk * 16 * 128);
      else
        ldsm_x4(a, xs + sw128(xr, xu + 2 * kk));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTileN / kBox; ++j)
        wgmma_64x64x16(acc[j], a, w_desc(ys + j * kBoxBytes + kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait0();  // the stage is read before it is refilled
    __syncthreads();
    if (threadIdx.x == 0 && i + kStages < count) issue(i + kStages);
  }

  // the cluster's partial, s/C. In a pair, block r stores rows r*64 .. of
  // the tile (warpgroup r's): warpgroup 1 - r writes its accumulators into
  // the partner's half-tile as soon as its run is done and arrives on the
  // partner's barrier; warpgroup r waits there and adds them to its own (two
  // terms: the same bits in either order).
  if (csize > 1) {
    const int t = threadIdx.x % 128;
    if (G != (int)rank) {
#pragma unroll
      for (int q = 0; q < kTileN / kBox * 8; ++q)
        st_cluster_f4(base + kHalf + (unsigned)(q * 128 + t) * 16, rank ^ 1u,
                      make_float4(acc[q / 8][q % 8 * 4], acc[q / 8][q % 8 * 4 + 1],
                                  acc[q / 8][q % 8 * 4 + 2], acc[q / 8][q % 8 * 4 + 3]));
      mbar_arrive_cluster(half_bar, rank ^ 1u);
    } else {
      mbar_wait_cluster(half_bar, 0);
      const float4* half = reinterpret_cast<const float4*>(smem_raw + (base - raw) + kHalf);
#pragma unroll
      for (int q = 0; q < kTileN / kBox * 8; ++q) {
        const float4 w = half[q * 128 + t];
        float* a = acc[q / 8] + q % 8 * 4;
        a[0] += w.x;
        a[1] += w.y;
        a[2] += w.z;
        a[3] += w.w;
      }
    }
  }
  // element i of acc[j] lies at row wr*16 + lane/4 (+8 for i%4 >= 2) of
  // warpgroup G's 64 rows of the tile, column j*64 + (i/4)*8 + 2*(lane%4) +
  // i%2
  const int rr = wr * 16 + lane / 4, cc = 2 * (lane % 4);
  if (csize == 1 || G == (int)rank) {
    float* out = part + (size_t)(s / (int)csize) * K * N;
    const int kr = k0 + G * 64 + rr, nc = n0 + cc;
#pragma unroll
    for (int j = 0; j < kTileN / kBox; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int k = kr + ((i % 4) / 2) * 8, n = nc + j * kBox + (i / 4) * 8;
        if (k < K && n < N)  // N % 8 == 0: n < N means n + 1 < N
          *reinterpret_cast<float2*>(out + (size_t)k * N + n) =
              make_float2(acc[j][i], acc[j][i + 1]);
      }
  }
}

// The bf16 loop's second pass: out[i] = cast(sum_g part[g][i]), g
// ascending (qtile's reduce_splits: the same sums, the same bits); then the
// warp that read a 128-byte line of the partials drops it from L2 unwritten
// (discard.global.L2): the scratch is dead, and its write-back would share
// HBM with the next call's loads. count is a multiple of 32: whole warps.
__global__ void __launch_bounds__(kReduceThreads)
dgt_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out, int groups,
                  size_t count) {
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= count) return;
  float acc = part[i];
  for (int g = 1; g < groups; ++g) acc += part[(size_t)g * count + i];
  out[i] = __float2bfloat16(acc);
  __syncwarp();
  if (threadIdx.x % 32 == 0)
    for (int g = 0; g < groups; ++g)
      asm volatile("discard.global.L2 [%0], 128;\n" ::"l"(part + (size_t)g * count + i)
                   : "memory");
}

template <bool kRows>
int launch_bf16(const void* x, const void* y, float* part, void* out, int M, int K, int N,
                int splits, cudaStream_t stream) {
  static_assert(kSmem <= kMaxSmem, "kernel J's ring exceeds a block's shared memory");
  if (splits > (M + kChunk - 1) / kChunk) return (int)cudaErrorInvalidValue;
  // once per instantiation (one device a process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      dgt_wg_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap xmap, ymap;
  const cuuint64_t xdims[2] = {(cuuint64_t)(kRows ? K : M), (cuuint64_t)(kRows ? M : K)};
  const cuuint32_t xbox[2] = {(cuuint32_t)kBox, (cuuint32_t)(kRows ? kChunk : kTileK)};
  const cuuint64_t ydims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint32_t ybox[2] = {(cuuint32_t)kBox, (cuuint32_t)kChunk};
  if (encode_bf16(&xmap, x, 2, xdims, xbox, CU_TENSOR_MAP_SWIZZLE_128B) != 0 ||
      encode_bf16(&ymap, y, 2, ydims, ybox, CU_TENSOR_MAP_SWIZZLE_128B) != 0)
    return (int)cudaErrorInvalidValue;
  const int cluster = cluster_of(splits);
  cudaLaunchAttribute along[1];  // the cluster, along the runs
  along[0].id = cudaLaunchAttributeClusterDimension;
  along[0].val.clusterDim.x = 1;
  along[0].val.clusterDim.y = 1;
  along[0].val.clusterDim.z = cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTileN - 1) / kTileN, (K + kTileK - 1) / kTileK, splits);
  cfg.blockDim = dim3(kThreadsBf16);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = along;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, dgt_wg_kernel<kRows>, xmap, ymap, part, M, K, N,
                                       splits);
  if (err != cudaSuccess) return (int)err;
  const size_t count = (size_t)K * N;
  dgt_reduce_kernel<<<(unsigned)((count + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
                      stream>>>(part, static_cast<__nv_bfloat16*>(out), splits / cluster, count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M,K] (rows = 1) or [K,M] (rows = 0) and y [M,N] in the compute dtype
// (0 = float32, 1 = bfloat16), 16-byte aligned; part [P,K,N] f32 scratch,
// P = splits in f32 and splits / cluster_of(splits) in bf16; out [K,N] in
// the compute dtype. K and N multiples of 8, and M too when rows = 0; 1 <=
// splits <= the chunks of M (16 rows in f32, 64 in bf16). Returns a
// cudaError_t (0 on success).
int qasr_dgt(const void* x, const void* y, void* part, void* out, int M, int K, int N,
             int splits, int rows, int dtype, void* stream) {
  if (M < 1 || K % 8 || N % 8 || (!rows && M % 8) || (K + BM - 1) / BM > 65535 || splits < 1 ||
      splits > 65535 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return rows ? launch_f32<true>(x, y, p, out, M, K, N, splits, st)
                : launch_f32<false>(x, y, p, out, M, K, N, splits, st);
  if (dtype == 1)
    return rows ? launch_bf16<true>(x, y, p, out, M, K, N, splits, st)
                : launch_bf16<false>(x, y, p, out, M, K, N, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
