// The stacked quaternion conv main loops of P products, shared by kernels A
// and F (qconv_ft8.cu, qconv_ft10.cu: the forward, with bias) and kernels C
// and G (qconv_dx8.cu, qconv_dx10.cu: the transposed conv of the backward,
// with the PReLU backward). A and C run the rank-8 scheme (P = 8), F and G
// the 10-product scheme (P = 10). Each kernel supplies its epilogue (both
// are here); everything up to the four f32 output accumulators is the main
// loop:
//
//   acc[b,:,f,t,n] = sum_p O[:,p] sum_{dt,df}
//                    (sum_a V[p,a] act(x[b,a,f+df-pw,t+dt-ph,:])) . wc[p,dt*kw+df,:,n]
//
// x [B,4,F,T,Cin], wc [P,kh*kw,Cin,Cout] (U-combined, kh over time, kw over
// frequency); act is the optional split-PReLU prologue x>=0 ? x : alpha*x.
// Out-of-range taps read as zero (SAME padding, odd kernels).
//
// One block: a 64-step time tile of one (b, f) row x 64 output channels, an
// implicit GEMM whose contraction walks (Cin chunk, tap). Two loops:
//
// - qconv_wg_kernel (bf16: A, C, F and G): the window of a 32-deep Cin
//   chunk and, per (chunk, tap), the P weight tiles arrive by TMA into a
//   ring behind mbarriers, one block barrier a stage; two warpgroups each
//   run half the products on wgmma with the combos formed in registers from
//   ldmatrix fragments of the window at the tap's row offset (the rank-8
//   scheme's by combo2, X_COMBO's unit sums by one addition); each
//   product's f32 accumulator stays in registers for the whole contraction
//   and the fold with O runs once, at the end. It is qgemm.cuh's loop
//   (kernels B and H) with the window in place of the x tile.
// - qconv_kernel (f32 only: its CUDA-core products keep f32 accuracy, which
//   the f32 gradient checks need): per Cin chunk, the four input components
//   over the kw x (64+kh-1) halo window stay in shared memory for all P
//   products; per product, the weights of all taps arrive by cp.async one
//   step ahead, the product's combos are formed from the window into
//   shared memory, its products run over all taps and are folded at once
//   into four accumulators. Copies, combos and products run in series, a
//   barrier between each.
//
// What bounds the bf16 wgmma loop on an H100 (at B16 F13 T256 C256 3x3: F
// 6.3e11 FLOP, 0.64 ms of tensor-core work; A 5.0e11, 0.51 ms): the P f32
// accumulators of a 64 x 64 tile take 32 P registers a thread, so one block
// an SM and no larger tile; every block then pulls all P * taps * Cin * 64
// weights from L2 (F 2.95 MB, 9.8 GB over the layer's 3328 blocks, ~1.1 ms
// at the ~9 TB/s into the SMs that kernel H reaches; A 2.36 MB, 7.9 GB,
// ~0.9 ms): the copies, as in H.
#pragma once

#include <type_traits>

#include "qtile.cuh"

namespace qconv {

using namespace qtile;

constexpr int kStepKc = 8;  // qconv_kernel's Cin chunk a step (f32)

// Where an output tile sits, handed to the epilogue.
struct Tile {
  int b, f, t0, n0;
  int F, T_len, Cout;
};

// Epi: a functor with
//   template <typename Prod> __device__ void store(float (&y)[4][kPerThread],
//                                                  unsigned char* smem,
//                                                  const Tile& tile) const;
// It may use the block's shared memory (after a __syncthreads()), and every
// thread of the block calls it.
template <typename T, int P, typename Epi>
__global__ void __launch_bounds__(kThreads, 1)
qconv_kernel(const T* __restrict__ x, const T* __restrict__ wc,
             const float* __restrict__ alpha, int F, int T_len, int Cin, int Cout,
             int kh, int kw, Scheme<P> scheme, Epi epi) {
  static_assert(std::is_same<T, float>::value, "bf16 runs qconv_wg_kernel");
  constexpr int V = Elem<T>::kVec, KC = kStepKc;
  constexpr int LDA = Layout<T, KC, P>::lda, LDB = Layout<T, KC, P>::ldb;
  using Prod = Product<T, KC>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int taps = kh * kw;
  const int rows = BM + kh - 1;  // time rows of the halo window
  const int a_rows = kw * rows;  // window row r: input (f + r/rows - pw, t0 - ph + r%rows)
  const Layout<T, KC, P> L(a_rows, taps);
  Scheme<P>& sch = *reinterpret_cast<Scheme<P>*>(smem);
  if (threadIdx.x == 0) sch = scheme;
  T* A = reinterpret_cast<T*>(smem + L.a);

  const int n0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * BM;
  const int f = blockIdx.z % F;
  const int b = blockIdx.z / F;
  const int pw = (kw - 1) / 2, ph = (kh - 1) / 2;
  const size_t comp_stride = (size_t)F * T_len * Cin;
  const T* xb = x + (size_t)b * 4 * comp_stride;
  const int nchunks = (Cin + KC - 1) / KC;
  const int nsteps = nchunks * P;  // step = chunk * P + product

  // Copies. Each thread keeps one 16-byte column of the rows it copies, so
  // the loops stride by constants and only the window row needs a division.
  auto issue_x = [&](int chunk) {  // the four components of a Cin chunk
    constexpr int VPR = KC / V, RSTEP = kThreads / VPR;
    T* xs = reinterpret_cast<T*>(smem + L.x + (chunk % 2) * L.x_bytes);
    const int v = threadIdx.x % VPR, c = chunk * KC + v * V;
    for (int r = threadIdx.x / VPR; r < a_rows; r += RSTEP) {
      const int df = r / rows;
      const int fi = f + df - pw, ti = t0 + (r - df * rows) - ph;
      const bool ok = c < Cin && fi >= 0 && fi < F && ti >= 0 && ti < T_len;
      const size_t off = ok ? ((size_t)fi * T_len + ti) * Cin + c : 0;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        cp_async16(xs + (a * a_rows + r) * KC + v * V, xb + a * comp_stride + off, ok);
    }
  };
  auto issue_w = [&](int step) {  // one product's weights, all taps, one chunk
    constexpr int VPRB = BN / V, KSTEP = kThreads / VPRB;
    const int p = step % P, c0 = (step / P) * KC;
    T* ws = reinterpret_cast<T*>(smem + L.w + (step % 2) * L.w_bytes);
    const T* wp = wc + (size_t)p * taps * Cin * Cout;
    const int vb = threadIdx.x % VPRB, n = n0 + vb * V;
    for (int sk = threadIdx.x / VPRB; sk < taps * KC; sk += KSTEP) {
      const int s = sk / KC, ci = c0 + sk % KC;
      const bool ok = ci < Cin && n < Cout;
      cp_async16(ws + sk * LDB + vb * V, ok ? wp + ((size_t)s * Cin + ci) * Cout + n : wp,
                 ok);
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
    T* xs = reinterpret_cast<T*>(smem + L.x + (chunk % 2) * L.x_bytes);
    if (p == 0 && alpha != nullptr) {
      prelu_chunk<T, KC>(xs, a_rows, alpha, Cin, chunk * KC);
      __syncthreads();  // the chunk is activated
    }
    form_combos<T, KC>(A, xs, a_rows, sch, p);
    __syncthreads();  // A is complete
    const T* ws = reinterpret_cast<const T*>(smem + L.w + (step % 2) * L.w_bytes);
    prod.zero();
    for (int dt = 0; dt < kh; ++dt)
      for (int df = 0; df < kw; ++df)
        prod.mma(A + (df * rows + dt) * LDA, ws + (dt * kw + df) * KC * LDB);
    fold(y, prod, sch, p);
  }

  epi.template store<Prod>(y, smem, Tile{b, f, t0, n0, F, T_len, Cout});
}

// ---------------------------------------------------------------------------
// bf16 (kernels A, C: P = 8; F, G: P = 10): TMA, wgmma, the combos in
// registers
// ---------------------------------------------------------------------------

constexpr int kWgKc = 32;                   // Cin a chunk: two 16-deep steps
constexpr int kWgWTile = kWgKc * BN * 2;    // one product's weights of a tap: 32 rows of 128 B
constexpr int kWgThreads = 2 * 128;         // two warpgroups
constexpr int kWgMaxStages = 4;
constexpr int kWgBars = 2 + kWgMaxStages;  // the windows' and the stages' full barriers

// The shared memory of one block, from its 1024-aligned base: nwin window
// buffers (a Cin chunk's four components over kw frequency rows and rows =
// BM + kh - 1 time rows, [4][kw][rows][kWgKc], rows of 64 bytes), then nst
// weight stages (one tap of a chunk for all P products, [P][kWgKc][BN],
// rows of 128 bytes: 32 KB at P = 8, 40 KB at P = 10), then the barriers.
// Two windows and three stages fit up to 5x3; a kernel five frequency taps
// wide takes one window (refilled after the chunk's last stage, its copy
// then not hidden) and four stages. At the end the fold's P f32 tiles
// [P][BM][kFoldLd] reuse the start.
template <int P>
struct WgRing {
  int rows, xbytes, win, nwin, nst, stages, bars, total;
  __host__ __device__ WgRing(int kh, int kw) {
    constexpr int stage = P * kWgWTile, fixed = 1024 + kWgBars * 8;
    rows = BM + kh - 1;
    xbytes = 4 * kw * rows * kWgKc * 2;
    win = (xbytes + 1023) / 1024 * 1024;
    nwin = fixed + 2 * win + 3 * stage <= kMaxSmem ? 2 : 1;
    nst = (kMaxSmem - fixed - nwin * win) / stage;
    if (nst > kWgMaxStages) nst = kWgMaxStages;
    stages = nwin * win;
    const int ring = stages + nst * stage, fold = P * BM * kFoldLd * 4;
    bars = ring > fold ? ring : fold;
    total = 1024 + bars + kWgBars * 8;
  }
};

// The previous layer's split PReLU, in place on a window as TMA wrote it
// (4 * rows_a rows of 64 bytes in the 64-byte swizzle), with prelu_chunk's
// arithmetic. Thread i takes component i / 64 and, of its rows, those 16
// apart from row (i % 64) / 4 at 16-byte unit i % 4: the swizzle then maps
// its units to one set of 8 channels, whose slopes it reads once. Channels
// past Cin were zero-filled and are skipped; rows out of range are zeros
// and stay so.
__device__ inline void prelu_window(unsigned char* win, int rows_a,
                                    const float* __restrict__ alpha, int Cin, int c0) {
  static_assert(kWgThreads == 4 * 64, "64 threads a component");
  const int a = threadIdx.x / 64, u = threadIdx.x % 4, r0 = (threadIdx.x % 64) / 4;
  const int r = a * rows_a + r0;  // the first row; the rest are 16 apart
  const int c = c0 + 8 * (u ^ ((r >> 1) & 3));
  if (c >= Cin) return;
  float al[8];
  *reinterpret_cast<float4*>(al) = *reinterpret_cast<const float4*>(alpha + a * Cin + c);
  *reinterpret_cast<float4*>(al + 4) = *reinterpret_cast<const float4*>(alpha + a * Cin + c + 4);
  unsigned char* p = win + r * 64 + u * 16;
#pragma unroll 4
  for (int k = r0; k < rows_a; k += 16, p += 16 * 64) {
    float v[8];
    load_vec(reinterpret_cast<__nv_bfloat16*>(p), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = v[e] < 0.0f ? v[e] * al[e] : v[e];
    store_vec(reinterpret_cast<__nv_bfloat16*>(p), v);
  }
}

// A warpgroup's H = P/2 products over the block's 64 x 64 tile (WgAcc),
// fed tap by tap
template <int P>
struct WgConv : WgAcc<P> {
  using WgAcc<P>::H, WgAcc<P>::acc, WgAcc<P>::c1, WgAcc<P>::c2;

  // One tap of one chunk. win: the window; rows_a: its rows a component;
  // r0: this lane's row of component 0 at the tap's offsets (lanes 0-15
  // rows 0-15 of the warp's 16 output rows, lanes 16-31 the same rows 8
  // channels on), its swizzle taken from the true row, so any offset reads
  // conflict-free; ws: the stage's weights, landed when full's phase of
  // parity `parity` completes. The first step's combos are formed before
  // that wait.
  template <int G>
  __device__ void tap(unsigned win, int rows_a, int r0, unsigned ws, unsigned full,
                      unsigned parity, int lane) {
#pragma unroll
    for (int kk = 0; kk < kWgKc / 16; ++kk) {
      unsigned f[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        ldsm_x4(f[a], win + x_off(a * rows_a + r0, kk * 2 + lane / 16));
      unsigned A[H][4];
#pragma unroll
      for (int j = 0; j < H; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) A[j][q] = wg_combo<P>(f, G * H + j, q, c1[j], c2[j]);
      if (kk == 0) mbar_wait(full, parity);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < H; ++j)
        wgmma_64x64x16(acc[j], A[j], w_desc(ws + (G * H + j) * kWgWTile + kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait0();  // the stage is read and the registers free
  }
};

// The main loop, bf16: an implicit GEMM whose K walks (Cin chunk, tap).
// Per chunk the window arrives by one TMA box (zero outside F, T and Cin:
// SAME padding and the Cin tail for free) and, when alpha is given, is
// activated in place before the chunk's last barrier; per (chunk, tap) the
// P weight tiles arrive by one TMA box into a ring of stages, each behind a
// full barrier (TMA's bytes). One block barrier a stage, as in qgemm.cuh:
// every warp has read it, thread 0 refills it (empty barriers with thread
// 0 or the last warp done refilling measured 5-19% slower, PERF.md §6).
// Then the P products are folded with O once, through shared memory, into
// the four outputs in Product<bf16>'s layout for the epilogue.
template <int P, typename Epi>
__global__ void __launch_bounds__(kWgThreads, 1)
qconv_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap, const float* __restrict__ alpha,
                int F, int T_len, int Cin, int Cout, int kh, int kw, Scheme<P> sch, Epi epi) {
  const WgRing<P> L(kh, kw);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* buf = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const unsigned base = smem_u32(buf);
  const unsigned win_full = base + L.bars;                 // window buffer w: + 8 w
  const unsigned w_full = win_full + 16;                   // stage s: + 8 s
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = warp / 4, wr = warp % 4;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * BM;
  const int f = blockIdx.z % F, b = blockIdx.z / F;
  const int pw = (kw - 1) / 2, ph = (kh - 1) / 2;
  const int taps = kh * kw, rows_a = kw * L.rows;
  const int nchunks = (Cin + kWgKc - 1) / kWgKc;
  const int nsteps = nchunks * taps;  // step = chunk * taps + tap

  // copies (thread 0): chunk c's window; step's weights of all P products
  auto issue_window = [&](int c) {
    const unsigned bar = win_full + 8 * (c % L.nwin);
    mbar_expect_tx(bar, L.xbytes);
    tma_load_5d(base + (c % L.nwin) * L.win, &xmap, bar, c * kWgKc, t0 - ph, f - pw, 0, b);
  };
  auto issue_weights = [&](int step) {
    const int s = step % L.nst, c = step / taps;
    mbar_expect_tx(w_full + 8 * s, P * kWgWTile);
    tma_load_4d(base + L.stages + s * P * kWgWTile, &wmap, w_full + 8 * s, n0, c * kWgKc,
                step - c * taps, 0);
  };
  // chunk c's window landed, then activated
  auto activate = [&](int c) {
    mbar_wait(win_full + 8 * (c % L.nwin), (c / L.nwin) & 1);
    if (alpha != nullptr) {
      prelu_window(buf + (c % L.nwin) * L.win, rows_a, alpha, Cin, c * kWgKc);
      fence_proxy_async();  // the pass's writes before TMA refills the buffer
    }
  };

  WgConv<P> wg;
  if (G == 0)
    wg.template init<0>(sch);
  else
    wg.template init<1>(sch);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(win_full + 8 * i, 1);
    for (int s = 0; s < L.nst; ++s) mbar_init(w_full + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    issue_window(0);
    if (L.nwin == 2 && nchunks > 1) issue_window(1);
    for (int i = 0; i < L.nst && i < nsteps; ++i) issue_weights(i);
  }
  activate(0);
  __syncthreads();

  int step = 0;
  for (int c = 0; c < nchunks; ++c) {
    // chunk c - 1's last barrier freed its window's buffer
    if (threadIdx.x == 0 && L.nwin == 2 && c >= 1 && c + 1 < nchunks) issue_window(c + 1);
    const unsigned win = base + (c % L.nwin) * L.win;
    for (int t = 0; t < taps; ++t, ++step) {
      const int s = step % L.nst, dt = t / kw, df = t - dt * kw;
      const unsigned parity = (step / L.nst) & 1;
      const unsigned ws = base + L.stages + s * P * kWgWTile;
      const int r0 = df * L.rows + dt + wr * 16 + lane % 16;
      if (G == 0)
        wg.template tap<0>(win, rows_a, r0, ws, w_full + 8 * s, parity, lane);
      else
        wg.template tap<1>(win, rows_a, r0, ws, w_full + 8 * s, parity, lane);
      __syncthreads();  // every warp has read the stage (and, the chunk's last, the window)
      if (threadIdx.x == 0 && step + L.nst < nsteps) issue_weights(step + L.nst);
    }
    if (c + 1 < nchunks) {
      if (L.nwin == 1 && threadIdx.x == 0) issue_window(c + 1);
      activate(c + 1);
      if (alpha != nullptr) __syncthreads();  // the window is activated
    }
  }

  // ---- the fold, once: y_b = sum_p O[b,p] prod_p in f32, product order
  // (every copy has landed and every warp is done with the ring)
  float* fs = reinterpret_cast<float*>(buf);  // [P][BM][kFoldLd]
  if (G == 0)
    wg_store<WgConv<P>::H, 0>(wg.acc, fs, wr, lane);
  else
    wg_store<WgConv<P>::H, 1>(wg.acc, fs, wr, lane);
  __syncthreads();
  using Prod = Product<__nv_bfloat16, 16>;  // the epilogues' layout of y
  float y[4][kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int r = Prod::row(j), col = Prod::col(j);
#pragma unroll
    for (int bo = 0; bo < 4; ++bo) y[bo][j] = 0.0f;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float v = fs[(q * BM + r) * kFoldLd + col];
#pragma unroll
      for (int bo = 0; bo < 4; ++bo) y[bo][j] += sch.out[bo][q] * v;
    }
  }
  epi.template store<Prod>(y, buf, Tile{b, f, t0, n0, F, T_len, Cout});
}

template <int P, typename Epi>
int launch_wg(const void* x, const void* wc, const float* alpha, int B, int F, int T_len,
              int Cin, int Cout, int kh, int kw, const Scheme<P>& s, const Epi& epi,
              int epi_bytes, cudaStream_t stream) {
  const WgRing<P> L(kh, kw);
  if (L.nst < 2 || L.total > kMaxSmem || epi_bytes > L.bars || !wg_scheme_ok(s) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wc) % 16)
    return (int)cudaErrorInvalidValue;
  // once per instantiation (one device a process): the most any launch asks
  static const cudaError_t attr = cudaFuncSetAttribute(
      qconv_wg_kernel<P, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  // x [B,4,F,T,Cin] in boxes of one chunk's window; wc [P,kh*kw,Cin,Cout]
  // in boxes of one (chunk, tap) for all P products
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[5] = {(cuuint64_t)Cin, (cuuint64_t)T_len, (cuuint64_t)F, 4,
                               (cuuint64_t)B};
  const cuuint32_t xbox[5] = {kWgKc, (cuuint32_t)L.rows, (cuuint32_t)kw, 4, 1};
  const cuuint64_t wdims[4] = {(cuuint64_t)Cout, (cuuint64_t)Cin, (cuuint64_t)(kh * kw), P};
  const cuuint32_t wbox[4] = {BN, kWgKc, 1, P};
  if (encode_bf16(&xmap, x, 5, xdims, xbox, CU_TENSOR_MAP_SWIZZLE_64B) != 0 ||
      encode_bf16(&wmap, wc, 4, wdims, wbox, CU_TENSOR_MAP_SWIZZLE_128B) != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Cout + BN - 1) / BN, (T_len + BM - 1) / BM, B * F);
  qconv_wg_kernel<P, Epi><<<grid, kWgThreads, L.total, stream>>>(xmap, wmap, alpha, F, T_len,
                                                                 Cin, Cout, kh, kw, s, epi);
  return (int)cudaGetLastError();
}

// Launch qconv_kernel (f32) over the grid (Cout tiles, T tiles, B*F), with
// the main loop's shared memory, or more when the epilogue asks for it
// (epi_bytes, from the start of shared memory).
template <typename T, int P, typename Epi>
int launch_steps(const void* x, const void* wc, const float* alpha, int B, int F, int T_len,
                 int Cin, int Cout, int kh, int kw, const Scheme<P>& s, const Epi& epi,
                 int epi_bytes, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "bf16 runs qconv_wg_kernel");
  const int main = Layout<T, kStepKc, P>(kw * (BM + kh - 1), kh * kw).total;
  const int smem = main > epi_bytes ? main : epi_bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // once per instantiation (one device a process): the most any launch asks
  static const cudaError_t attr = cudaFuncSetAttribute(
      qconv_kernel<T, P, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Cout + BN - 1) / BN, (T_len + BM - 1) / BM, B * F);
  qconv_kernel<T, P, Epi><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wc), alpha, F, T_len, Cin, Cout,
      kh, kw, s, epi);
  return (int)cudaGetLastError();
}

// Launch one instantiation: bf16 (kernels A, C, F and G) on the wgmma loop,
// f32 on qconv_kernel. Nothing falls back: a shape or scheme the wgmma loop
// refuses comes back as its error.
template <typename T, int P, typename Epi>
int launch(const void* x, const void* wc, const float* alpha, int B, int F, int T_len,
           int Cin, int Cout, int kh, int kw, const Scheme<P>& s, const Epi& epi,
           int epi_bytes, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_wg<P>(x, wc, alpha, B, F, T_len, Cin, Cout, kh, kw, s, epi, epi_bytes,
                        stream);
  else
    return launch_steps<T, P>(x, wc, alpha, B, F, T_len, Cin, Cout, kh, kw, s, epi,
                              epi_bytes, stream);
}

// The shape checks every C entry makes (the Python wrappers check first).
inline bool shape_ok(int B, int F, int Cin, int Cout, int kh, int kw) {
  return kh % 2 == 1 && kw % 2 == 1 && Cin % 8 == 0 && Cout % 8 == 0 && B * F <= 65535;
}

// ---------------------------------------------------------------------------
// the forward's epilogue (kernels A and F): bias, mask the ragged time and
// channel edges, store
// ---------------------------------------------------------------------------

template <typename T>
struct BiasStore {
  const float* bias;  // [4*Cout] or null
  T* out;             // [B,4,F,T,Cout]

  template <typename Prod>
  __device__ void store(float (&y)[4][kPerThread], unsigned char*, const Tile& tl) const {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int t = tl.t0 + Prod::row(j), n = tl.n0 + Prod::col(j);
      if (t >= tl.T_len || n >= tl.Cout) continue;
#pragma unroll
      for (int bo = 0; bo < 4; ++bo) {
        const float bv = bias != nullptr ? bias[bo * tl.Cout + n] : 0.0f;
        out[((((size_t)tl.b * 4 + bo) * tl.F + tl.f) * tl.T_len + t) * tl.Cout + n] =
            Elem<T>::from_f(y[bo][j] + bv);
      }
    }
  }
};

// The body of a forward C entry (qasr_qconv_ft8, qasr_qconv_ft10): v [P*4]
// and o [4*P] are the scheme's host tables; dtype 0 = float32, 1 = bfloat16.
template <int P>
int forward_entry(const void* x, const void* wc, const void* bias, const void* alpha,
                  void* out, int B, int F, int T_len, int Cin, int Cout, int kh, int kw,
                  int dtype, const float* v, const float* o, void* stream) {
  Scheme<P> s;
  if (make_scheme(v, o, &s) != 0) return (int)cudaErrorInvalidValue;
  if (!shape_ok(B, F, Cin, Cout, kh, kw)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  const float* al = static_cast<const float*>(alpha);
  if (dtype == 0)
    return launch<float, P>(x, wc, al, B, F, T_len, Cin, Cout, kh, kw, s,
                            BiasStore<float>{bi, static_cast<float*>(out)}, 0, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, P>(
        x, wc, al, B, F, T_len, Cin, Cout, kh, kw, s,
        BiasStore<__nv_bfloat16>{bi, static_cast<__nv_bfloat16*>(out)}, 0, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the transposed conv's epilogue (kernels C and G): the previous layer's
// PReLU backward and a deterministic dalpha
// ---------------------------------------------------------------------------

constexpr int kRedLd = BN + 1;                          // padded row of the reduction tile
constexpr int kRedBytes = BM * kRedLd * (int)sizeof(float);

template <typename T>
struct PreluBwdStore {
  const T* z;          // [B,4,F,T,N] or null (then no gate, no dalpha)
  const float* alpha;  // [4*N]
  T* out;              // dx [B,4,F,T,N]
  float* partials;     // [B*F*ceil(T/BM), 4*N]

  template <typename Prod>
  __device__ void store(float (&y)[4][kPerThread], unsigned char* smem,
                        const Tile& tl) const {
    const int N = tl.Cout;
    if (z == nullptr) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int t = tl.t0 + Prod::row(j), n = tl.n0 + Prod::col(j);
        if (t >= tl.T_len || n >= N) continue;
#pragma unroll
        for (int bo = 0; bo < 4; ++bo)
          out[((((size_t)tl.b * 4 + bo) * tl.F + tl.f) * tl.T_len + t) * N + n] =
              Elem<T>::from_f(y[bo][j]);
      }
      return;
    }
    // The reduction tile lies over the staging buffers: wait until every
    // thread has finished the last step's products.
    float* red = reinterpret_cast<float*>(smem);
    const size_t row_block = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
    __syncthreads();
#pragma unroll
    for (int bo = 0; bo < 4; ++bo) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int r = Prod::row(j), c = Prod::col(j);
        const int t = tl.t0 + r, n = tl.n0 + c;
        float part = 0.0f;
        if (t < tl.T_len && n < N) {
          const size_t idx = ((((size_t)tl.b * 4 + bo) * tl.F + tl.f) * tl.T_len + t) * N + n;
          float g = y[bo][j];
          const float zv = Elem<T>::to_f(z[idx]);
          if (zv < 0.0f) {
            part = g * zv;
            g *= alpha[bo * N + n];
          }
          out[idx] = Elem<T>::from_f(g);
        }
        red[r * kRedLd + c] = part;
      }
      __syncthreads();
      if (threadIdx.x < BN) {
        float s = 0.0f;
        for (int r = 0; r < BM; ++r) s += red[r * kRedLd + threadIdx.x];
        const int n = tl.n0 + threadIdx.x;
        if (n < N) partials[(row_block * 4 + bo) * N + n] = s;
      }
      __syncthreads();  // red is free for the next component
    }
  }
};

namespace {  // one copy in each source that includes this header

// dalpha[i] = sum over partial rows r, in order, of partials[r, i]
__global__ void dalpha_reduce_kernel(const float* __restrict__ partials,
                                     float* __restrict__ dalpha, int rows, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += partials[(size_t)r * n4 + i];
  dalpha[i] = s;
}

}  // namespace

inline int partial_rows(int B, int F, int T_len) { return B * F * ((T_len + BM - 1) / BM); }

template <typename T, int P>
int launch_dx(const void* dz, const void* wc, const void* z, const float* alpha, void* dx,
              float* partials, float* dalpha, int B, int F, int T_len, int Cin, int Cout,
              int kh, int kw, const Scheme<P>& s, cudaStream_t stream) {
  const PreluBwdStore<T> epi{static_cast<const T*>(z), alpha, static_cast<T*>(dx), partials};
  int err = launch<T, P>(dz, wc, nullptr, B, F, T_len, Cin, Cout, kh, kw, s, epi,
                         z != nullptr ? kRedBytes : 0, stream);
  if (err != 0 || z == nullptr) return err;
  const int n4 = 4 * Cout;
  dalpha_reduce_kernel<<<(n4 + 255) / 256, 256, 0, stream>>>(
      partials, dalpha, partial_rows(B, F, T_len), n4);
  return (int)cudaGetLastError();
}

// The body of a transposed-conv C entry (qasr_qconv_dx8, qasr_qconv_dx10);
// arguments as those entries document.
template <int P>
int dx_entry(const void* dz, const void* wc, const void* z, const void* alpha, void* dx,
             void* partials, void* dalpha, int B, int F, int T_len, int Cin, int Cout,
             int kh, int kw, int dtype, const float* v, const float* o, void* stream) {
  Scheme<P> s;
  if (make_scheme(v, o, &s) != 0) return (int)cudaErrorInvalidValue;
  if (!shape_ok(B, F, Cin, Cout, kh, kw)) return (int)cudaErrorInvalidValue;
  if (z != nullptr && (alpha == nullptr || partials == nullptr || dalpha == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  float* pa = static_cast<float*>(partials);
  float* da = static_cast<float*>(dalpha);
  if (dtype == 0)
    return launch_dx<float, P>(dz, wc, z, a, dx, pa, da, B, F, T_len, Cin, Cout, kh, kw, s,
                               st);
  if (dtype == 1)
    return launch_dx<__nv_bfloat16, P>(dz, wc, z, a, dx, pa, da, B, F, T_len, Cin, Cout, kh,
                                       kw, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace qconv
