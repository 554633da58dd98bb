// Kernel E: the backward of the bidirectional rank-8 QLSTM recurrence, a
// reverse-time scan in one launch.
//
// Replaces the TPU kernel qasr/ops/pallas/qlstm_scan.py:_bwd_kernel. For each
// direction d and row b, t runs from T-1 down to 0 on the scan-order stream
// (direction 1 time-flipped, as in the forward), dh = dc = 0 at the start,
// carried in f32 (as _bwd_xla carries them; the forward carries h and c in
// the storage type). Per step, from the forward's gates (gate-major i, f, o,
// g), c_prev = cs[t-1] (zero at t = 0), the upstream dhs[t] and the mask m:
//
//   th     = tanh(f c_prev + i g)
//   dh_tot = dhs[t] + dh,  dh_c = m dh_tot,  dc_c = m dc + dh_c o (1 - th^2)
//   dz     = [dc_c g i(1-i) | dc_c c_prev f(1-f) | dh_c th o(1-o) | dc_c i (1-g^2)]
//   dprods_p = sum_q O8[q,p] dz[g,q]    from the f32 dz, rounded once
//   dhc_p  = dprods_p @ wc8[d,p]^T       f32 accumulation, [B, H]
//   dh     = (1-m) dh_tot + sum_p V8[p,a] dhc_p,   dc = (1-m) dc + dc_c f
//
// dz is written gate-major in the storage type. Each elementwise expression
// is evaluated in _bwd_xla's order without contraction (__fmul_rn,
// __fadd_rn), so it rounds where the plain version rounds.
//
// What bounds it on an H100, and the design. At B32 T512 H256 (both
// directions, one layer, bf16) the bytes bound it: gates, cs and dhs in, dz
// out, wc8 once: ~680 MB, 0.20 ms at 3.35 TB/s, against 137 GFLOP (0.14 ms
// at the bf16 peak). The TPU kernel kept all of wc8^T (8.4 MB in bf16) in one
// core's VMEM across a sequential grid; no SM holds that. As kernel D does
// for the forward, the kernel is persistent and cooperative, partitioned by
// the hidden index the carry belongs to: block (d, j0) owns kJ hidden
// indices j of direction d, keeps dh and dc of its cells (b, q, j) in f32,
// and holds resident in shared memory the weight rows its dhc_p[:, j] need,
// wc8[d, p, j, :] for the 8 products. A step:
//   A. the elementwise part for the block's cells; dz to device memory, the
//      f32 dz to shared memory; then the block's own columns of dprods (it
//      holds every q and g of its j), rounded, into an exchange buffer;
//   B. one grid barrier;
//   C. every block streams the whole dprods of its direction, [8, B, 4H],
//      from L2 in K-chunks (cp.async, two stages), runs its 8 products and
//      folds V8^T into dh for its j.
// The carry never leaves the block, so the one barrier a step suffices. The
// exchange buffer is scratch the wrapper allocates, a ping-pong pair [2, D,
// 8, B, 4H] indexed by the parity of t: a block rewrites one half only after
// the next barrier, which no block passes before every block has read it.
// The carry lives in a scratch [2, D, B, 4H] f32 that only the thread owning
// a cell reads and writes (every phase maps cell e to the same thread).
//
// bf16: kJ = 8 (64 blocks at H=256), one n8 tile of mma.sync m16n8k16 a
// product, warp p runs product p over both m16 row tiles; weights 8 x 8 x
// (4H + 8) bf16 = 129 KB. Fewer, wider blocks halve the L2 traffic of the
// exchange (each block reads the whole 512 KB of dprods a step). f32: kJ = 4
// (128 blocks), CUDA-core FMA so f32 stays at f32 accuracy; weights 8 x 4H x
// 4 f32 = 128 KB, resident as in bf16 (twice the bytes, half the indices).
// The T dependent steps each pay the barrier and the L2 round trips: a
// latency floor far above the bound, which this version does not hide. The
// launch is cooperative, so a grid that cannot be co-resident is refused
// rather than deadlocked. No atomics: two runs give the same bits. Any B and
// T: rows past B are zero-filled in shared memory and never stored.
#include <cooperative_groups.h>

#include "qtile8.cuh"

namespace cg = cooperative_groups;
using namespace qtile8;

namespace {

constexpr int kBwdThreads = 256;  // 8 warps; warp p runs product p
constexpr int kRows = 32;         // rows of the batch a tile holds

template <typename T>
struct BwdCfg;

// bf16: weights [p][jj][4H + 8] (k contiguous: a b fragment is one 32-bit
// load; the 8 rows x 4 words of a fragment fall in 32 distinct banks since
// (4H + 8) / 2 words is 4 mod 32 at H % 16 == 0); dprods chunks [p][row][KC
// + 8] for ldmatrix (rows an odd number of 16-byte units).
template <>
struct BwdCfg<__nv_bfloat16> {
  static constexpr int kJ = 8, KC = 64, kPad = 8;
  __host__ __device__ static int w_elems(int H) { return kProds * kJ * (4 * H + 8); }
  __device__ static int w_at(int p, int jj, int n, int H) { return (p * kJ + jj) * (4 * H + 8) + n; }
};

// f32: weights [p][n][kJ] (one broadcast float4 a k); dprods chunks
// [p][row][KC + 4], read as float4 along k (a quarter warp's 8 rows fall in
// distinct banks).
template <>
struct BwdCfg<float> {
  static constexpr int kJ = 4, KC = 32, kPad = 4;
  __host__ __device__ static int w_elems(int H) { return kProds * 4 * H * kJ; }
  __device__ static int w_at(int p, int jj, int n, int H) { return (p * 4 * H + n) * kJ + jj; }
};

// In order: the resident weights; two stages of dprods chunks; a scratch that
// holds the tile's f32 dz [row][g][q][kJ] in phase A and the products
// [p][row][kJ] in phase C. The launcher refuses a layout past kMaxSmem.
template <typename T>
struct BwdLayout {
  int x, x_bytes, s, total;
  __host__ __device__ explicit BwdLayout(int H) {
    using C = BwdCfg<T>;
    x = align128(C::w_elems(H) * (int)sizeof(T));
    x_bytes = align128(kProds * kRows * (C::KC + C::kPad) * (int)sizeof(T));
    s = x + 2 * x_bytes;
    const int dz = kRows * 16 * C::kJ * (int)sizeof(float);
    const int pr = kProds * kRows * C::kJ * (int)sizeof(float);
    total = s + align128(dz > pr ? dz : pr);
  }
};

__device__ inline float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ inline float fsub(float a, float b) { return __fsub_rn(a, b); }

__device__ inline void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Chunk c of dprods rows r0 .. r0+kRows (all 8 products) into stage xs:
// xs[p][row][k] = xb[p][r0 + row][c*KC + k]; rows past B zero-filled. L2-only
// copies (cp.async.cg): other blocks wrote xb since this SM last looked.
template <typename T>
__device__ inline void load_chunk(T* xs, const T* xb, int B, int r0, int c, int H) {
  using C = BwdCfg<T>;
  constexpr int V = Elem<T>::kVec, VPR = C::KC / V, LDX = C::KC + C::kPad;
  const size_t h4 = 4 * (size_t)H;
  for (int i = threadIdx.x; i < kProds * kRows * VPR; i += kBwdThreads) {
    const int v = i % VPR, r = (i / VPR) % kRows, p = i / (VPR * kRows);
    const int b = r0 + r;
    const T* src = xb + ((size_t)p * B + (b < B ? b : 0)) * h4 + c * C::KC + v * V;
    cp_async16(xs + (p * kRows + r) * LDX + v * V, src, b < B);
  }
  cp_async_commit();
}

// Warp p: dhc_p [kRows, kJ] over n in 0..4H, into p_s [p][row][kJ]; chunks
// of dprods stream through two stages, one chunk ahead.
template <typename T>
struct BwdProduct;

template <>
struct BwdProduct<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using C = BwdCfg<T>;
  __device__ static void run(const T* w_s, T* x_s, int stage, float* p_s, const T* xb, int B,
                             int r0, int H) {
    constexpr int LDX = C::KC + C::kPad;
    const int lane = threadIdx.x % 32, p = threadIdx.x / 32;
    const int g8 = lane / 4, t2 = (lane % 4) * 2;
    const int lr = lane % 16, lc = (lane / 16) * 8;  // ldmatrix row addresses
    const int nk = 4 * H / C::KC;
    float acc[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][e] = 0.0f;
    load_chunk<T>(x_s, xb, B, r0, 0, H);
    for (int c = 0; c < nk; ++c) {
      if (c + 1 < nk) {
        load_chunk<T>(x_s + ((c + 1) & 1) * stage, xb, B, r0, c + 1, H);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      const T* xs = x_s + (c & 1) * stage + p * kRows * LDX;
      // b fragment (n = jj = g8): k 2t, 2t+1 and 2t+8, 2t+9 of this chunk
      const T* wp = w_s + C::w_at(p, g8, c * C::KC + t2, H);
#pragma unroll
      for (int kk = 0; kk < C::KC / 16; ++kk) {
        const unsigned b0 = *reinterpret_cast<const unsigned*>(wp + kk * 16);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(wp + kk * 16 + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          unsigned a[4];
          ldmatrix_x4(a, xs + (mi * 16 + lr) * LDX + kk * 16 + lc);
          mma_bf16_16816(acc[mi], a, b0, b1);
        }
      }
      __syncthreads();  // the stage is consumed before the load two chunks on
    }
    // accumulator element e: row g8 (+8 for e >= 2), column t2 + e % 2
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p_s[(p * kRows + mi * 16 + g8 + (e / 2) * 8) * C::kJ + t2 + e % 2] = acc[mi][e];
  }
};

template <>
struct BwdProduct<float> {
  using T = float;
  using C = BwdCfg<T>;
  __device__ static void run(const T* w_s, T* x_s, int stage, float* p_s, const T* xb, int B,
                             int r0, int H) {
    constexpr int LDX = C::KC + C::kPad;
    const int r = threadIdx.x % 32, p = threadIdx.x / 32;  // lane = row
    const int nk = 4 * H / C::KC;
    float acc[C::kJ];
#pragma unroll
    for (int jj = 0; jj < C::kJ; ++jj) acc[jj] = 0.0f;
    load_chunk<T>(x_s, xb, B, r0, 0, H);
    for (int c = 0; c < nk; ++c) {
      if (c + 1 < nk) {
        load_chunk<T>(x_s + ((c + 1) & 1) * stage, xb, B, r0, c + 1, H);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      const float* xr = x_s + (c & 1) * stage + (p * kRows + r) * LDX;
      const float* wp = w_s + C::w_at(p, 0, c * C::KC, H);
#pragma unroll 2
      for (int k = 0; k < C::KC; k += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + k);
        const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 wv = *reinterpret_cast<const float4*>(wp + (k + u) * C::kJ);
          acc[0] = fmaf(xk[u], wv.x, acc[0]);
          acc[1] = fmaf(xk[u], wv.y, acc[1]);
          acc[2] = fmaf(xk[u], wv.z, acc[2]);
          acc[3] = fmaf(xk[u], wv.w, acc[3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int jj = 0; jj < C::kJ; ++jj) p_s[(p * kRows + r) * C::kJ + jj] = acc[jj];
  }
};

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
qlstm_scan8_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ cs,
                       const T* __restrict__ dhs, const T* __restrict__ wc8,
                       const int* __restrict__ lengths, T* __restrict__ dz, T* xbuf, float* dh_g,
                       float* dc_g, int Tn, int D, int B, int H, Scheme8 sch) {
  using C = BwdCfg<T>;
  constexpr int kJ = C::kJ;
  constexpr int kCells = kRows * 4 * kJ / kBwdThreads;  // cells a thread owns in a tile
  static_assert(kRows * 4 * kJ % kBwdThreads == 0, "every thread owns as many cells");
  static_assert(kJ == Elem<T>::kVec, "a block's columns of a dprods row are one 16-byte vector");
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout<T> L(H);
  T* w_s = reinterpret_cast<T*>(smem);
  T* x_s = reinterpret_cast<T*>(smem + L.x);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  const int stage = L.x_bytes / (int)sizeof(T);
  const int per_dir = H / kJ;
  const int d = blockIdx.x / per_dir, j0 = (blockIdx.x % per_dir) * kJ;
  const size_t h4 = 4 * (size_t)H, h16 = 16 * (size_t)H;
  const size_t xdir = (size_t)kProds * B * h4;  // one direction of one exchange half
  cg::grid_group grid = cg::this_grid();

  // this block's weight rows, resident for the whole scan:
  // w[p][jj][n] <- wc8[d, p, j0 + jj, n]
  for (int i = threadIdx.x; i < kProds * kJ * 4 * H; i += blockDim.x) {
    const int n = i % (4 * H), jj = (i / (4 * H)) % kJ, p = i / (4 * H * kJ);
    w_s[C::w_at(p, jj, n, H)] = wc8[(((size_t)d * kProds + p) * H + j0 + jj) * h4 + n];
  }
  // cell e of a tile: jj = e % kJ, q = (e / kJ) % 4, row = e / (4 kJ); the
  // carry of a cell is touched by its one thread only, in every phase
  for (int r0 = 0; r0 < B; r0 += kRows) {
#pragma unroll
    for (int u = 0; u < kCells; ++u) {
      const int e = threadIdx.x + u * kBwdThreads;
      const int b = r0 + e / (4 * kJ);
      if (b >= B) continue;
      const size_t ci = ((size_t)d * B + b) * h4 + ((e / kJ) % 4) * H + j0 + e % kJ;
      dh_g[ci] = 0.0f;
      dc_g[ci] = 0.0f;
    }
  }

  for (int t = Tn - 1; t >= 0; --t) {
    const int frame = d == 0 ? t : Tn - 1 - t;  // the original time index
    T* xb = xbuf + ((size_t)(t & 1) * D + d) * xdir;  // [8][B][4H]
    // A. the elementwise part, then this block's columns of dprods
    for (int r0 = 0; r0 < B; r0 += kRows) {
      __syncthreads();  // the scratch's last reads are done
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        const int e = threadIdx.x + u * kBwdThreads;
        const int jj = e % kJ, q = (e / kJ) % 4, r = e / (4 * kJ), b = r0 + r;
        float dzv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (b < B) {
          const size_t row = ((size_t)t * D + d) * B + b;
          const size_t lane = (size_t)q * H + j0 + jj;
          const size_t ci = ((size_t)d * B + b) * h4 + lane;
          const T* gt = gates + row * h16 + lane;
          const float ig = Elem<T>::to_f(gt[0]), fg = Elem<T>::to_f(gt[h4]);
          const float og = Elem<T>::to_f(gt[2 * h4]), gg = Elem<T>::to_f(gt[3 * h4]);
          const float cp = t > 0 ? Elem<T>::to_f(cs[(row - (size_t)D * B) * h4 + lane]) : 0.0f;
          const float dhu = Elem<T>::to_f(dhs[row * h4 + lane]);
          const float m = (lengths == nullptr || frame < lengths[b]) ? 1.0f : 0.0f;
          const float dh = dh_g[ci], dc = dc_g[ci];
          const float th = tanhf(fadd(fmul(fg, cp), fmul(ig, gg)));
          const float dh_tot = fadd(dhu, dh);
          const float dh_c = fmul(m, dh_tot);
          const float dc_c = fadd(fmul(m, dc), fmul(fmul(dh_c, og), fsub(1.0f, fmul(th, th))));
          dzv[0] = fmul(fmul(fmul(dc_c, gg), ig), fsub(1.0f, ig));
          dzv[1] = fmul(fmul(fmul(dc_c, cp), fg), fsub(1.0f, fg));
          dzv[2] = fmul(fmul(fmul(dh_c, th), og), fsub(1.0f, og));
          dzv[3] = fmul(fmul(dc_c, ig), fsub(1.0f, fmul(gg, gg)));
          dc_g[ci] = fadd(fmul(fsub(1.0f, m), dc), fmul(dc_c, fg));
          dh_g[ci] = fmul(fsub(1.0f, m), dh_tot);  // phase C adds dh_rec
          T* dzt = dz + row * h16 + lane;
#pragma unroll
          for (int g = 0; g < 4; ++g) dzt[g * h4] = Elem<T>::from_f(dzv[g]);
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) s_s[((r * 4 + g) * 4 + q) * kJ + jj] = dzv[g];
      }
      __syncthreads();
      // dprods_p[b][g*H + j] = sum_q O8[q,p] dz[b][g][q][j], summed over q in
      // order from the f32 dz and rounded once; one 16-byte vector per (p, b, g)
      for (int i = threadIdx.x; i < kProds * kRows * 4; i += kBwdThreads) {
        const int g = i % 4, r = (i / 4) % kRows, p = i / (4 * kRows), b = r0 + r;
        if (b >= B) continue;
        const float* zq = s_s + (r * 4 + g) * 4 * kJ;
        float v[kJ];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          float a = fmul(zq[jj], sch.out[0][p]);
#pragma unroll
          for (int q = 1; q < 4; ++q) a = fadd(a, fmul(zq[q * kJ + jj], sch.out[q][p]));
          v[jj] = a;
        }
        store_vec<T>(xb + ((size_t)p * B + b) * h4 + (size_t)g * H + j0, v);
      }
    }
    grid.sync();  // every block's columns of dprods[t] are written
    // C. the products over the whole dprods of this direction, then dh
    for (int r0 = 0; r0 < B; r0 += kRows) {
      if (t > 0) {  // the next step's inputs of this tile's cells, into L2
#pragma unroll
        for (int u = 0; u < kCells; ++u) {
          const int e = threadIdx.x + u * kBwdThreads, b = r0 + e / (4 * kJ);
          if (b >= B || e % kJ) continue;
          const size_t row = ((size_t)(t - 1) * D + d) * B + b;
          const size_t lane = (size_t)((e / kJ) % 4) * H + j0;
#pragma unroll
          for (int g = 0; g < 4; ++g) prefetch_l2(gates + row * h16 + g * h4 + lane);
          prefetch_l2(dhs + row * h4 + lane);
          if (t > 1) prefetch_l2(cs + (row - (size_t)D * B) * h4 + lane);
        }
      }
      BwdProduct<T>::run(w_s, x_s, stage, s_s, xb, B, r0, H);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        const int e = threadIdx.x + u * kBwdThreads;
        const int jj = e % kJ, a = (e / kJ) % 4, r = e / (4 * kJ), b = r0 + r;
        if (b >= B) continue;
        // dh_rec[a] = sum over p ascending of V8[p,a] dhc_p (the scheme's
        // sparse rows, read by column)
        float rec = 0.0f;
        bool first = true;
#pragma unroll
        for (int p = 0; p < kProds; ++p) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            if (sch.in_a[p][n] != a) continue;
            const float term = fmul(s_s[(p * kRows + r) * kJ + jj], sch.in_c[p][n]);
            rec = first ? term : fadd(rec, term);
            first = false;
          }
        }
        const size_t ci = ((size_t)d * B + b) * h4 + (size_t)a * H + j0 + jj;
        dh_g[ci] = fadd(dh_g[ci], rec);
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* gates, const void* cs, const void* dhs, const void* wc8,
               const void* lengths, void* dz, void* xbuf, void* dh, void* dc, int Tn, int D,
               int B, int H, const Scheme8& s, cudaStream_t stream) {
  const int smem = BwdLayout<T>(H).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qlstm_scan8_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const T* g = static_cast<const T*>(gates);
  const T* c = static_cast<const T*>(cs);
  const T* dh_up = static_cast<const T*>(dhs);
  const T* w = static_cast<const T*>(wc8);
  const int* lens = static_cast<const int*>(lengths);
  T* out = static_cast<T*>(dz);
  T* x = static_cast<T*>(xbuf);
  float* dhp = static_cast<float*>(dh);
  float* dcp = static_cast<float*>(dc);
  Scheme8 sch = s;
  void* args[] = {&g, &c, &dh_up, &w, &lens, &out, &x, &dhp, &dcp, &Tn, &D, &B, &H, &sch};
  // refused (cudaErrorCooperativeLaunchTooLarge) when the grid cannot be
  // co-resident
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(qlstm_scan8_bwd_kernel<T>),
                                    dim3(D * H / BwdCfg<T>::kJ), dim3(kBwdThreads), args,
                                    (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both directions, D = 2: gates [T,D,B,16H] gate-major, cs and dhs [T,D,B,4H],
// wc8 [D,8,H,4H], lengths [B] int32 or null; dz [T,D,B,16H] is written. xbuf
// [2,D,8,B,4H] (storage type) and dh, dc [D,B,4H] (f32) are scratch. dtype:
// 0 = float32, 1 = bfloat16. v8 [8*4] and o8 [4*8] are host pointers.
// Returns a cudaError_t (0 on success).
int qasr_qlstm_scan8_bwd(const void* gates, const void* cs, const void* dhs, const void* wc8,
                         const void* lengths, void* dz, void* xbuf, void* dh, void* dc, int T,
                         int D, int B, int H, int dtype, const float* v8, const float* o8,
                         void* stream) {
  Scheme8 s;
  if (make_scheme(v8, o8, &s) != 0) return (int)cudaErrorInvalidValue;
  if (H < 16 || H % 16 || D != 2 || T < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(gates, cs, dhs, wc8, lengths, dz, xbuf, dh, dc, T, D, B, H, s, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(gates, cs, dhs, wc8, lengths, dz, xbuf, dh, dc, T, D, B, H,
                                     s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
