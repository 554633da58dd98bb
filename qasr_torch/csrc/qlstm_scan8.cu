// Kernel D: the whole bidirectional rank-8 QLSTM recurrence in one launch.
//
// Replaces the TPU kernel qasr/ops/pallas/qlstm_scan.py:_fwd_kernel. For each
// direction d, row b and step t in order (direction 1 walks the time-flipped
// stream):
//
//   hc_p   = sum_a V8[p,a] h_{t-1,a}     f32, rounded to the storage type
//   prod_p = hc_p @ wc8[d,p]             f32 accumulation, p = 0..7
//   z      = xz_t + O8 . prod            f32, gate-major lanes [g, q, H]
//   i,f,o  = sigmoid(z_i, z_f, z_o),  g = tanh(z_g)
//   c'     = f c + i g,  h' = o tanh(c') frozen where the row is inactive
//
// h and c are carried in the storage type, rounded every step, as the TPU
// kernel's scratch and its XLA twin _fwd_xla carry them. Outputs: hs, cs
// [T,D,B,4H] component-major [q,H]; gates [T,D,B,16H] gate-major
// [sigmoid(i,f,o) | tanh(g)], which the backward reads.
//
// What bounds it on an H100, and the design. At B32 T512 H256 (both
// directions, one layer) the bytes bound it: ~679 MB of xz, hs, cs, gates and
// weights, 0.20 ms at 3.35 TB/s, against 137 GFLOP (0.14 ms at the bf16
// peak). The TPU kernel kept all of wc8 (8.4 MB bf16 at H=256) in one core's
// VMEM across a sequential grid; no SM holds that. Here the kernel is
// persistent and cooperative: block (d, j0) owns kJ = 4 hidden indices of one
// direction and keeps in shared memory the 32 weight columns they need
// (wc8[d, p, :, g*H + j] for 8 p x 4 g), 66 KB in bf16 at H=256, so the
// weights leave device memory once per launch; 2 x 256 / 4 = 128 blocks, one
// per SM. Each step every block first loads the xz, c_{t-1} and activity of
// the cells it updates (none depends on h_{t-1}), then stages h_{t-1} of its
// direction from hs[t-1] (an L2 read, eight loads in flight a thread), forms
// the V8 combos while loading the operands of the products (warp p runs
// product p: mma.sync m16n8k16 in bf16, CUDA-core FMA in f32 so f32 stays at
// f32 accuracy), folds the products with O8, updates its cells and writes
// its slice of hs[t], cs[t] and gates[t]. hs[t] is the exchange buffer, so
// one grid barrier a step is the only synchronisation. The T dependent steps
// each pay that barrier and the L2 round trips: a latency floor far above
// the bound, which this version shortens but does not hide. The launch is
// cooperative, so a grid that cannot be co-resident is refused rather than
// deadlocked. Any B and T: rows past B are zero-filled in shared memory and
// never stored.
#include <cooperative_groups.h>

#include "qtile.cuh"

namespace cg = cooperative_groups;
using namespace qtile;

namespace {

constexpr int kJ = 4;              // hidden indices a block owns
constexpr int kCols = 4 * kJ;      // its weight columns per product: 4 gates x kJ
constexpr int kScanThreads = 256;  // 8 warps; warp p runs product p

template <typename T>
struct ScanCfg;

// bf16: 32 rows of h a tile (two m16 tiles). The weights are stored
// transposed [p][n][H + 8] and h as [q][row][H + 8], so every mma fragment
// is a 32-bit load, and the 8 rows x 4 column pairs of a fragment fall in 32
// distinct banks ((H + 8) / 2 words is 4 times an odd number).
template <>
struct ScanCfg<__nv_bfloat16> {
  static constexpr int BM = 32, kHPad = 8;
  __host__ __device__ static int w_elems(int H) { return kProds * kCols * (H + 8); }
  __device__ static int w_at(int p, int k, int n, int H) { return (p * kCols + n) * (H + 8) + k; }
};

// f32: 16 rows a tile; lane = (row, half of the columns). The weights are
// stored [p][k][kCols] (two broadcast 16-byte loads a k), h as [q][row][H+1]
// (odd stride: the 16 rows a warp reads fall in distinct banks).
template <>
struct ScanCfg<float> {
  static constexpr int BM = 16, kHPad = 1;
  __host__ __device__ static int w_elems(int H) { return kProds * H * kCols; }
  __device__ static int w_at(int p, int k, int n, int H) { return (p * H + k) * kCols + n; }
};

// In order: the resident weights, the staged rows of h, the products [p][row][kCols]
// in f32. The launcher refuses a layout past kMaxSmem.
template <typename T>
struct ScanLayout {
  int h, prod, total;
  __host__ __device__ explicit ScanLayout(int H) {
    using C = ScanCfg<T>;
    h = align128(C::w_elems(H) * (int)sizeof(T));
    prod = h + align128(4 * C::BM * (H + C::kHPad) * (int)sizeof(T));
    total = prod + kProds * C::BM * kCols * (int)sizeof(float);
  }
};

// Rows r0 .. r0+BM of h_{t-1} (hprev = hs[t-1, d], or null at t = 0) into
// h_s [q][row][H + pad]; rows past B and the first step are zeros. L2-only
// loads: other blocks wrote hprev since this SM last looked. A thread issues
// kBatch loads before it stores any, so their round trips overlap.
template <typename T>
__device__ inline void stage_h(T* h_s, const T* hprev, int B, int r0, int H) {
  using C = ScanCfg<T>;
  constexpr int V = Elem<T>::kVec, kBatch = 8;
  const int ldh = H + C::kHPad, vpr = 4 * H / V, n = C::BM * vpr;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kScanThreads) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kScanThreads, b = r0 + i / vpr;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n && hprev != nullptr && b < B)
        raw[u] = __ldcg(reinterpret_cast<const uint4*>(hprev + (size_t)b * 4 * H + (i % vpr) * V));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kScanThreads;
      if (i >= n) break;
      const int r = i / vpr, c = (i % vpr) * V;
      T* dst = h_s + ((c / H) * C::BM + r) * ldh + c % H;
      if constexpr (C::kHPad % V == 0) {
        *reinterpret_cast<uint4*>(dst) = raw[u];
      } else {
        const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int v = 0; v < V; ++v) dst[v] = e[v];
      }
    }
  }
}

// Two neighbouring combo elements c1 x1 + c2 x2, formed in f32 without
// contraction (as _fwd_xla rounds), packed as bf16 (lower half first).
__device__ inline unsigned combo2(const __nv_bfloat16* x1, const __nv_bfloat16* x2, float c1,
                                  float c2) {
  const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x1));
  const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x2));
  __nv_bfloat162 r = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(c1, u.x), __fmul_rn(c2, w.x)),
                                          __fadd_rn(__fmul_rn(c1, u.y), __fmul_rn(c2, w.y)));
  return *reinterpret_cast<unsigned*>(&r);
}

// Warp p: prods_p [BM, kCols] = combos_p(h_s) @ w_p, into p_s [p][row][kCols].
template <typename T>
struct ScanProduct;

template <>
struct ScanProduct<__nv_bfloat16> {
  using T = __nv_bfloat16;
  __device__ static void run(const T* w_s, const T* h_s, float* p_s, int H, const Scheme8& sch) {
    constexpr int BM = ScanCfg<T>::BM;
    const int lane = threadIdx.x % 32, p = threadIdx.x / 32;
    const int g8 = lane / 4, t2 = (lane % 4) * 2;
    const int ldh = H + ScanCfg<T>::kHPad, ldw = H + 8;
    const float c1 = sch.in_c[p][0], c2 = sch.in_c[p][1];
    const T* x1 = h_s + sch.in_a[p][0] * BM * ldh;
    const T* x2 = h_s + sch.in_a[p][1] * BM * ldh;
    const T* wp = w_s + p * kCols * ldw;
    float acc[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    // unrolled: with one warp a product, the next k-step's loads and combos
    // are what hides this one's latencies
#pragma unroll 4
    for (int k0 = 0; k0 < H; k0 += 16) {
      // b fragment of n tile ni: (k 2t, 2t+1; n g8) and (k 2t+8, 2t+9; n g8)
      unsigned b[2][2];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const T* wn = wp + (ni * 8 + g8) * ldw + k0 + t2;
        b[ni][0] = *reinterpret_cast<const unsigned*>(wn);
        b[ni][1] = *reinterpret_cast<const unsigned*>(wn + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // a fragment: rows g8, g8+8 at columns 2t, 2t+1 and 2t+8, 2t+9
        const int lo = (mi * 16 + g8) * ldh + k0 + t2, hi = lo + 8 * ldh;
        const unsigned a[4] = {combo2(x1 + lo, x2 + lo, c1, c2), combo2(x1 + hi, x2 + hi, c1, c2),
                               combo2(x1 + lo + 8, x2 + lo + 8, c1, c2),
                               combo2(x1 + hi + 8, x2 + hi + 8, c1, c2)};
        mma_bf16_16816(acc[mi][0], a, b[0][0], b[0][1]);
        mma_bf16_16816(acc[mi][1], a, b[1][0], b[1][1]);
      }
    }
    // accumulator element e: row g8 (+8 for e >= 2), column 2t + e % 2
    float* pp = p_s + p * BM * kCols;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pp[(mi * 16 + g8 + (e / 2) * 8) * kCols + ni * 8 + t2 + e % 2] = acc[mi][ni][e];
  }
};

template <>
struct ScanProduct<float> {
  using T = float;
  __device__ static void run(const T* w_s, const T* h_s, float* p_s, int H, const Scheme8& sch) {
    constexpr int BM = ScanCfg<T>::BM, NH = kCols / 2;
    const int lane = threadIdx.x % 32, p = threadIdx.x / 32;
    const int r = lane % BM, n0 = (lane / BM) * NH;
    const int ldh = H + ScanCfg<T>::kHPad;
    const float c1 = sch.in_c[p][0], c2 = sch.in_c[p][1];
    const float* x1 = h_s + (sch.in_a[p][0] * BM + r) * ldh;
    const float* x2 = h_s + (sch.in_a[p][1] * BM + r) * ldh;
    const float* wp = w_s + p * H * kCols + n0;
    float acc[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) acc[i] = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float x = __fadd_rn(__fmul_rn(c1, x1[k]), __fmul_rn(c2, x2[k]));
      const float4 wa = *reinterpret_cast<const float4*>(wp + k * kCols);
      const float4 wb = *reinterpret_cast<const float4*>(wp + k * kCols + 4);
      acc[0] = fmaf(x, wa.x, acc[0]);
      acc[1] = fmaf(x, wa.y, acc[1]);
      acc[2] = fmaf(x, wa.z, acc[2]);
      acc[3] = fmaf(x, wa.w, acc[3]);
      acc[4] = fmaf(x, wb.x, acc[4]);
      acc[5] = fmaf(x, wb.y, acc[5]);
      acc[6] = fmaf(x, wb.z, acc[6]);
      acc[7] = fmaf(x, wb.w, acc[7]);
    }
    float* pp = p_s + (p * BM + r) * kCols + n0;
#pragma unroll
    for (int i = 0; i < NH; ++i) pp[i] = acc[i];
  }
};

__device__ inline float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(kScanThreads, 1)
qlstm_scan8_kernel(const T* __restrict__ xz, const T* __restrict__ wc8,
                   const int* __restrict__ lengths, T* hs, T* cs, T* __restrict__ gates, int Tn,
                   int D, int B, int H, Scheme8 sch) {
  using C = ScanCfg<T>;
  constexpr int BM = C::BM;
  constexpr int kCells = BM * 4 * kJ / kScanThreads;  // cells a thread updates in a tile
  static_assert(BM * 4 * kJ % kScanThreads == 0, "every thread updates as many cells");
  extern __shared__ __align__(128) unsigned char smem[];
  const ScanLayout<T> L(H);
  T* w_s = reinterpret_cast<T*>(smem);
  T* h_s = reinterpret_cast<T*>(smem + L.h);
  float* p_s = reinterpret_cast<float*>(smem + L.prod);
  const int per_dir = H / kJ;
  const int d = blockIdx.x / per_dir, j0 = (blockIdx.x % per_dir) * kJ;
  const int ldh = H + C::kHPad;
  const size_t h4 = 4 * (size_t)H, h16 = 16 * (size_t)H;
  cg::grid_group grid = cg::this_grid();

  // this block's weight columns, resident for the whole scan: product p,
  // column n = g*kJ + jj <- wc8[d, p, k, g*H + j0 + jj]
  for (int i = threadIdx.x; i < kProds * H * kCols; i += blockDim.x) {
    const int n = i % kCols, k = (i / kCols) % H, p = i / (kCols * H);
    w_s[C::w_at(p, k, n, H)] =
        wc8[((size_t)d * kProds + p) * H * h4 + (size_t)k * h4 + (n / kJ) * H + j0 + n % kJ];
  }

  for (int t = 0; t < Tn; ++t) {
    const T* hprev = t > 0 ? hs + ((size_t)(t - 1) * D + d) * B * h4 : nullptr;
    const int frame = d == 0 ? t : Tn - 1 - t;  // the original time index
    for (int r0 = 0; r0 < B; r0 += BM) {
      __syncthreads();  // the weights are staged; the last tile's h_s and p_s consumed
      // The cells (row, q, jj) of this tile that this thread updates. Their
      // xz, c_{t-1} (which this thread wrote itself) and activity do not
      // depend on h_{t-1}: load them before h is staged, to overlap.
      float xzc[kCells][4], c_prev[kCells], m[kCells];
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        const int e = threadIdx.x + u * kScanThreads;
        const int j = j0 + e % kJ, q = (e / kJ) % 4, b = r0 + e / (4 * kJ);
        const size_t row = ((size_t)t * D + d) * B + b;
        c_prev[u] = m[u] = 0.0f;
#pragma unroll
        for (int g = 0; g < 4; ++g) xzc[u][g] = 0.0f;
        if (b >= B) continue;
#pragma unroll
        for (int g = 0; g < 4; ++g) xzc[u][g] = Elem<T>::to_f(xz[row * h16 + (g * 4 + q) * H + j]);
        if (t > 0) c_prev[u] = Elem<T>::to_f(cs[(row - (size_t)D * B) * h4 + q * H + j]);
        m[u] = (lengths == nullptr || frame < lengths[b]) ? 1.0f : 0.0f;
      }
      stage_h<T>(h_s, hprev, B, r0, H);
      __syncthreads();
      ScanProduct<T>::run(w_s, h_s, p_s, H, sch);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kCells; ++u) {
        const int e = threadIdx.x + u * kScanThreads;
        const int jj = e % kJ, q = (e / kJ) % 4, r = e / (4 * kJ), b = r0 + r;
        if (b >= B) continue;
        const int j = j0 + jj;
        const size_t row = ((size_t)t * D + d) * B + b;
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float proj = 0.0f;
#pragma unroll
          for (int p = 0; p < kProds; ++p)
            proj += sch.out[q][p] * p_s[(p * BM + r) * kCols + g * kJ + jj];
          z[g] = xzc[u][g] + proj;
        }
        const float ig = sigmoid_f(z[0]), fg = sigmoid_f(z[1]), og = sigmoid_f(z[2]);
        const float gg = tanhf(z[3]);
        const float h_prev = Elem<T>::to_f(h_s[(q * BM + r) * ldh + j]);
        const float c_cand = fg * c_prev[u] + ig * gg;
        const float h_cand = og * tanhf(c_cand);
        hs[row * h4 + q * H + j] = Elem<T>::from_f(m[u] * h_cand + (1.0f - m[u]) * h_prev);
        cs[row * h4 + q * H + j] = Elem<T>::from_f(m[u] * c_cand + (1.0f - m[u]) * c_prev[u]);
        T* gt = gates + row * h16 + q * H + j;
        gt[0 * 4 * H] = Elem<T>::from_f(ig);
        gt[1 * 4 * H] = Elem<T>::from_f(fg);
        gt[2 * 4 * H] = Elem<T>::from_f(og);
        gt[3 * 4 * H] = Elem<T>::from_f(gg);
      }
    }
    grid.sync();  // hs[t] is complete before any block stages it
  }
}

template <typename T>
int launch(const void* xz, const void* wc8, const void* lengths, void* hs, void* cs,
           void* gates, int Tn, int D, int B, int H, const Scheme8& s, cudaStream_t stream) {
  const int smem = ScanLayout<T>(H).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qlstm_scan8_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const T* x = static_cast<const T*>(xz);
  const T* w = static_cast<const T*>(wc8);
  const int* lens = static_cast<const int*>(lengths);
  T* h = static_cast<T*>(hs);
  T* c = static_cast<T*>(cs);
  T* g = static_cast<T*>(gates);
  Scheme8 sch = s;
  void* args[] = {&x, &w, &lens, &h, &c, &g, &Tn, &D, &B, &H, &sch};
  // refused (cudaErrorCooperativeLaunchTooLarge) when the grid cannot be
  // co-resident
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(qlstm_scan8_kernel<T>),
                                    dim3(D * H / kJ), dim3(kScanThreads), args, (size_t)smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both directions, D = 2: xz [T,D,B,16H] gate-major, wc8 [D,8,H,4H], lengths
// [B] int32 or null; hs, cs [T,D,B,4H] and gates [T,D,B,16H] are written.
// dtype: 0 = float32, 1 = bfloat16. v8 [8*4] and o8 [4*8] are host pointers.
// Returns a cudaError_t (0 on success).
int qasr_qlstm_scan8(const void* xz, const void* wc8, const void* lengths, void* hs, void* cs,
                     void* gates, int T, int D, int B, int H, int dtype, const float* v8,
                     const float* o8, void* stream) {
  Scheme8 s;
  if (make_scheme(v8, o8, &s) != 0) return (int)cudaErrorInvalidValue;
  if (H < 16 || H % 16 || D != 2 || T < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xz, wc8, lengths, hs, cs, gates, T, D, B, H, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xz, wc8, lengths, hs, cs, gates, T, D, B, H, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
