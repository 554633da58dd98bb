// Kernel I: the weight gradient of the 10-product quaternion GEMM.
//
// Replaces the TPU kernel qasr/ops/pallas/qgemm.py:_qgemm_dw_kernel (reached
// through _dw_pallas when the contraction M is at least 256):
//
//   dw[a] = sum_p W_COMBO[p,a] . (xc_p^T @ dyc_p)
//   xc_p  = sum_a X_COMBO[p,a] x4[a]         (one or two terms)
//   dyc_p = sum_b OUT_COMBO[b,p] dy4[b]      (one to four signed terms)
//
// x4 [4,M,K], dy4 [4,M,N] in the compute dtype -> dw [4,K,N] f32. Rounding
// as the TPU kernel's: both combos in the storage dtype (dyc summed term by
// term in _OUT_TERMS_OF_P's order, rounded after each add), the products
// accumulated in f32, the W_COMBO scatter in f32.
//
// What bounds it on an H100: at the QCNN-256 dense layer (M = 4096, K =
// 3328, N = 256) it executes 7.0e10 FLOP against ~0.14 GB (x4, dy4 once, dw
// in f32), ~500 FLOP/byte: the tensor cores. A block owns a 64 (K) x 64 (N)
// tile of all four outputs; per 16 rows of M a warp's 32 x 16 share of it
// takes 40 mma.sync. In the first version the ten combos around them, formed
// product by product in shared memory behind two barriers each and read back
// by ldmatrix, took the time: forming all ten in shared memory behind one
// barrier was slower still (shared-memory traffic ~4x the tensor cores'
// time), so here they never reach shared memory.
//
// The design:
// - Split M: grid (N/64, K/64, S); block (n, k, s) sums its tile over the
//   s-th run of whole chunks of M into an f32 partial [S,4,K,N], and a
//   second pass (qtile's reduce_splits, shared with kernel J) adds the S
//   partials in ascending s into dw; S = 1 writes dw directly. S comes from
//   the wrapper (dgt.splits: one wave of blocks). No atomics: the same bits
//   every run.
// - The ten combos live in registers. Per 16 rows of M a warp loads the four
//   components of x4 and of dy4 as mma fragments (ldmatrix.trans: x4 is read
//   transposed in place, as ProductAT reads xc), forms the ten dyc_p and, per
//   16 rows of K, the ten xc_p with bf16x2 adds (each rounded once, as the
//   storage dtype's add), and runs the ten products back to back: 12
//   ldmatrix per 40 mma instead of 30 for ten tiles read from shared memory.
//   The scheme is compiled in (the host checks that the tables it is passed
//   are it), so each combo is a fixed add, subtract or negate.
// - Ten f32 accumulators (one a product) stay in registers for the whole
//   run, and W_COMBO's scatter is applied once at the end (16 adds an
//   element, in product order) instead of once a chunk: 160 accumulator
//   registers a thread (238 in all), so one block of 256 threads an SM.
// - One barrier a chunk: x4's and dy4's chunks arrive by cp.async in a ring
//   of stages, all but one in flight. bf16: 64 rows a chunk (four mma steps
//   a barrier), three stages of 72 KB, 216 KB of the 227; 32 rows and four
//   stages were ~12% slower.
// f32 runs the same ring and split on the CUDA cores (16 rows, four stages
// of 34 KB), a thread owning 16 elements of a column (Product<float>'s
// layout) of all ten products.
#include "qtile.cuh"

using namespace qtile;

namespace {

constexpr int P = 10;
constexpr int kMinBlocks = 1;  // 160 accumulators a thread

// The 10-product scheme (qasr_torch/ops/quaternion.py: X_COMBO, OUT_COMBO,
// W_COMBO), dense; qasr_qgemm10_dw refuses tables that differ.
__host__ __device__ constexpr int x_combo(int p, int a) {
  constexpr int t[P][4] = {{1, 0, 0, 0}, {0, 1, 0, 0}, {0, 0, 1, 0}, {0, 0, 0, 1}, {1, 1, 0, 0},
                           {0, 0, 1, 1}, {1, 0, 1, 0}, {0, 1, 0, 1}, {1, 0, 0, 1}, {0, 1, 1, 0}};
  return t[p][a];
}
__host__ __device__ constexpr int out_combo(int b, int p) {
  constexpr int t[4][P] = {{1, -1, -1, -1, 0, 0, 0, 0, 0, 0},
                           {-1, -1, -1, 1, 1, 1, 0, 0, 0, 0},
                           {-1, 1, -1, -1, 0, 0, 1, 1, 0, 0},
                           {-1, -1, 1, -1, 0, 0, 0, 0, 1, 1}};
  return t[b][p];
}
__host__ __device__ constexpr int w_combo(int p, int a) {
  constexpr int t[P][4] = {{1, 0, 0, 0}, {0, 1, 0, 0}, {0, 0, 1, 0}, {0, 0, 0, 1}, {1, 1, 0, 0},
                           {0, 0, 1, -1}, {1, 0, 1, 0}, {0, -1, 0, 1}, {1, 0, 0, 1}, {0, 1, -1, 0}};
  return t[p][a];
}

// 0 when xc [10*4], oc [4*10] and wcmb [10*4] (row-major) are the compiled
// scheme, else -1
int check_scheme(const float* xc, const float* oc, const float* wcmb) {
  for (int p = 0; p < P; ++p)
    for (int a = 0; a < 4; ++a)
      if (xc[p * 4 + a] != (float)x_combo(p, a) || wcmb[p * 4 + a] != (float)w_combo(p, a) ||
          oc[a * P + p] != (float)out_combo(a, p))
        return -1;
  return 0;
}

// a signed sum of v[i] (coefficient c(i) in {-1, 0, 1}), term by term in
// i order, with the storage dtype's add: in bf16 each add rounded once to
// nearest (fma.rn with 1 or -1: the exact sum, rounded), the first term's
// sign exact
__device__ __forceinline__ unsigned bf2_fma1(unsigned acc, unsigned v, unsigned one) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(one), "r"(acc));
  return d;
}

template <typename F>
__device__ __forceinline__ unsigned signed_sum_bf2(const unsigned (&v)[4], F c) {
  unsigned s = 0;
  bool first = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = c(i);
    if (ci == 0) continue;
    if (first)
      s = ci > 0 ? v[i] : v[i] ^ 0x80008000u;
    else
      s = bf2_fma1(s, v[i], ci > 0 ? 0x3f803f80u : 0xbf80bf80u);
    first = false;
  }
  return s;
}

template <typename F>
__device__ __forceinline__ float signed_sum_f32(const float (&v)[4], F c) {
  float s = 0.0f;
  bool first = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = c(i);
    if (ci == 0) continue;
    if (first)
      s = ci > 0 ? v[i] : -v[i];
    else
      s = ci > 0 ? s + v[i] : s - v[i];
    first = false;
  }
  return s;
}

// rows of M a chunk, and the ring's stages: bf16 four steps of the mma's
// contraction a barrier, three stages of 72 KB; f32 16 rows, four stages of
// 34 KB
template <typename T>
struct DwCfg;
template <>
struct DwCfg<__nv_bfloat16> {
  static constexpr int MC = 64, kStages = 3;
};
template <>
struct DwCfg<float> {
  static constexpr int MC = 16, kStages = 4;
};

// One stage of the ring: x4's four components [4][MC][LD] (rows m, columns
// k0..k0+63), then dy4's [4][MC][LD] (columns n0..n0+63). LD is the
// forward's B stride, whose ldmatrix rows fall in distinct bank groups.
template <typename T>
struct DwLayout {
  static constexpr int MC = DwCfg<T>::MC;
  static constexpr int LD = Elem<T>::kLdb;
  static constexpr int tile = 4 * MC * LD;  // elements of one operand's stage
  static constexpr int stage = align128(2 * tile * (int)sizeof(T));
  static constexpr int total = DwCfg<T>::kStages * stage;
};

// The ten products' f32 accumulators over a block's 64 x 64 tile, and one
// chunk's products into them.
template <typename T>
struct DwProducts;

// bf16 on the tensor cores, Product<T, KC, true>'s warp tiling: warp w owns
// rows (w/4)*32 .. +32 (K) and columns (w%4)*16 .. +16 (N); element j of a
// product's accumulator is acc[p][j/4][j%4].
template <>
struct DwProducts<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using Tile = Product<T, 16, true>;
  static constexpr int MC = DwLayout<T>::MC, LD = DwLayout<T>::LD;
  float acc[P][4][4];

  __device__ static int row(int j) { return Tile::row(j); }
  __device__ static int col(int j) { return Tile::col(j); }
  __device__ float at(int p, int j) const { return acc[p][j / 4][j % 4]; }

  __device__ void zero() {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][i][q] = 0.0f;
  }

  // xs, ds: the stage's x4 and dy4 tiles, each [4][MC][LD]
  __device__ void chunk(const T* xs, const T* ds) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4;
    // ldmatrix row addresses: B (dy) rows m; A (x^T) rows m read
    // transposed, the four 8 x 8 matrices in the A registers' order
    const int lr = lane % 16, lc = (lane / 16) * 8;
    const int am = (lane / 16) * 8 + lane % 8, ak = ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < MC / 16; ++kk) {
      unsigned dc[P][4];  // dyc_p's B fragments: (m 0-7 | 8-15) x (n 0-7 | 8-15)
      {
        unsigned d[4][4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          ldmatrix_x4_trans(d[b], ds + (b * MC + kk * 16 + lr) * LD + wn * 16 + lc);
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const unsigned v[4] = {d[0][r], d[1][r], d[2][r], d[3][r]};
            dc[p][r] = signed_sum_bf2(v, [p](int b) { return out_combo(b, p); });
          }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        unsigned x[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          ldmatrix_x4_trans(x[a], xs + (a * MC + kk * 16 + am) * LD + wm * 32 + mi * 16 + ak);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          unsigned xc[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const unsigned v[4] = {x[0][r], x[1][r], x[2][r], x[3][r]};
            xc[r] = signed_sum_bf2(v, [p](int a) { return x_combo(p, a); });
          }
          mma_bf16_16816(acc[p][mi * 2 + 0], xc, dc[p][0], dc[p][1]);
          mma_bf16_16816(acc[p][mi * 2 + 1], xc, dc[p][2], dc[p][3]);
        }
      }
    }
  }
};

// f32 on the CUDA cores, Product<float>'s layout: a thread owns column
// tid%64 and rows tid/64 + 4j; within a warp the x read is a broadcast and
// the dy read contiguous. The combos are formed in f32 as the plain version
// forms them.
template <>
struct DwProducts<float> {
  using Tile = Product<float, 16, false>;
  static constexpr int MC = DwLayout<float>::MC, LD = DwLayout<float>::LD;
  float acc[P][kPerThread];

  __device__ static int row(int j) { return Tile::row(j); }
  __device__ static int col(int j) { return Tile::col(j); }
  __device__ float at(int p, int j) const { return acc[p][j]; }

  __device__ void zero() {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) acc[p][j] = 0.0f;
  }

  __device__ void chunk(const float* xs, const float* ds) {
    const int c = col(0), r0 = row(0);
    constexpr int dr = kThreads / BN;
#pragma unroll 1
    for (int m = 0; m < MC; ++m) {
      float d[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) d[b] = ds[(b * MC + m) * LD + c];
      float dc[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        dc[p] = signed_sum_f32(d, [p](int b) { return out_combo(b, p); });
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        float x[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = xs[(a * MC + m) * LD + r0 + j * dr];
#pragma unroll
        for (int p = 0; p < P; ++p)
          acc[p][j] += signed_sum_f32(x, [p](int a) { return x_combo(p, a); }) * dc[p];
      }
    }
  }
};

// W_COMBO's scatter of the ten accumulators into output component a at
// element j, in product order
template <typename Prod>
__device__ __forceinline__ float fold(const Prod& prod, int a, int j) {
  float y = 0.0f;
  bool first = true;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int w = w_combo(p, a);
    if (w == 0) continue;
    const float v = prod.at(p, j);
    y = first ? (w > 0 ? v : -v) : (w > 0 ? y + v : y - v);
    first = false;
  }
  return y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
qgemm10_dw_kernel(const T* __restrict__ x4, const T* __restrict__ dy4, float* __restrict__ out,
                  int M, int K, int N, int per_split) {
  using L = DwLayout<T>;
  constexpr int V = Elem<T>::kVec, MC = L::MC, LD = L::LD, VPR = BN / V;
  constexpr int kStages = DwCfg<T>::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM;
  const int first = blockIdx.z * per_split;
  const int count = min(per_split, (M + MC - 1) / MC - first);

  // chunk first + i of x4 (columns k0..k0+63) and dy4 (columns n0..n0+63),
  // all four components, into stage i % kStages; rows past M and columns
  // past K or N are zero-filled, so they add nothing
  auto issue = [&](int i) {
    T* xs = reinterpret_cast<T*>(smem + (i % kStages) * L::stage);
    T* ds = xs + L::tile;
    const int v = threadIdx.x % VPR, m0 = (first + i) * MC;
    const int k = k0 + v * V, n = n0 + v * V;
    for (int e = threadIdx.x / VPR; e < 4 * MC; e += kThreads / VPR) {
      const int a = e / MC, m = m0 + e % MC;
      const bool okx = m < M && k < K, okd = m < M && n < N;
      cp_async16(xs + e * LD + v * V, okx ? x4 + ((size_t)a * M + m) * K + k : x4, okx);
      cp_async16(ds + e * LD + v * V, okd ? dy4 + ((size_t)a * M + m) * N + n : dy4, okd);
    }
  };

  DwProducts<T> prod;
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
    const T* xs = reinterpret_cast<const T*>(smem + (i % kStages) * L::stage);
    prod.chunk(xs, xs + L::tile);
  }

  out += (size_t)blockIdx.z * 4 * K * N;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = k0 + prod.row(j), n = n0 + prod.col(j);
    if (k >= K || n >= N) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a) out[((size_t)a * K + k) * N + n] = fold(prod, a, j);
  }
}

template <typename T>
int launch(const void* x4, const void* dy4, float* part, float* dw, int M, int K, int N,
           int splits, cudaStream_t stream) {
  constexpr int MC = DwCfg<T>::MC, smem = DwLayout<T>::total;
  static_assert(smem <= kMaxSmem, "kernel I's stages exceed a block's shared memory");
  // once per instantiation (one device a process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      qgemm10_dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int chunks = (M + MC - 1) / MC;
  const int per_split = (chunks + splits - 1) / splits;
  if (splits < 1 || (splits - 1) * per_split >= chunks) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, splits);
  qgemm10_dw_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x4), static_cast<const T*>(dy4), splits > 1 ? part : dw, M, K, N,
      per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return reduce_splits(part, dw, splits, (size_t)4 * K * N, stream);
}

}  // namespace

extern "C" {

// x4 [4,M,K] and dy4 [4,M,N] in the compute dtype (0 = float32, 1 =
// bfloat16), M >= 1, K and N multiples of 8; part [splits,4,K,N] f32
// scratch (unused when splits = 1), every one of the splits runs of
// ceil(chunks / splits) chunks holding at least one; dw [4,K,N] f32 out.
// xc [10*4] (X_COMBO), oc [4*10] (OUT_COMBO) and wcmb [10*4] (W_COMBO) are
// host pointers and must be the compiled scheme. Returns a cudaError_t (0 on
// success).
int qasr_qgemm10_dw(const void* x4, const void* dy4, void* part, void* dw, int M, int K, int N,
                    int splits, int dtype, const float* xc, const float* oc, const float* wcmb,
                    void* stream) {
  if (check_scheme(xc, oc, wcmb) != 0) return (int)cudaErrorInvalidValue;
  if (M < 1 || K % 8 || N % 8 || (K + BM - 1) / BM > 65535 || splits > 65535 ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(dw);
  if (dtype == 0) return launch<float>(x4, dy4, p, out, M, K, N, splits, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x4, dy4, p, out, M, K, N, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
