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
// in f32), ~500 FLOP/byte: the tensor cores. The design: a block owns a
// 64 (K) x 64 (N) tile of all four f32 outputs and walks the whole of M in
// chunks, so no two blocks write the same output and no atomics are needed:
// the same bits every run. Per chunk, x4's and dy4's four components arrive
// by cp.async one chunk ahead; per product, the two combos are formed in
// shared memory, the product xc^T dyc runs on mma.sync (the transposed A
// operand by ldmatrix.trans, as the forward kernels load B) and is folded
// into the four accumulators with W_COMBO[p, :] in registers. Few blocks at
// a narrow K (16 at K = N = 256) walk a long M serially; splitting M over
// blocks with a second reduction pass is later work.
#include "qtile.cuh"

using namespace qtile;

namespace {

constexpr int P = 10;

// The three tables, sparse, built on the host from the dense ones.
struct DwScheme {
  int x_a[P][2];     // X_COMBO row p: one or two components (a one-term row
  float x_c[P][2];   // keeps its term twice, the second with coefficient 0)
  int d_n[P];        // OUT_COMBO column p: its nonzero terms, b ascending
  int d_b[P][4];
  float d_s[P][4];
  float w[4][P];     // W_COMBO transposed: dw[a] += w[a][p] * prod_p
};

// xc [10][4], oc [4][10], wcmb [10][4], row-major. Returns 0, or -1 when a
// row of xc has no nonzero term or more than two, or a column of oc none.
int make_dw_scheme(const float* xc, const float* oc, const float* wcmb, DwScheme* s) {
  for (int p = 0; p < P; ++p) {
    int n = 0;
    for (int a = 0; a < 4; ++a) {
      if (xc[p * 4 + a] != 0.0f) {
        if (n == 2) return -1;
        s->x_a[p][n] = a;
        s->x_c[p][n] = xc[p * 4 + a];
        ++n;
      }
    }
    if (n == 0) return -1;
    if (n == 1) {
      s->x_a[p][1] = s->x_a[p][0];
      s->x_c[p][1] = 0.0f;
    }
    n = 0;
    for (int b = 0; b < 4; ++b) {
      if (oc[b * P + p] != 0.0f) {
        s->d_b[p][n] = b;
        s->d_s[p][n] = oc[b * P + p];
        ++n;
      }
    }
    if (n == 0) return -1;
    s->d_n[p] = n;
    for (int a = 0; a < 4; ++a) s->w[a][p] = wcmb[p * 4 + a];
  }
  return 0;
}

// M chunk per step (the mma's contraction); two blocks fit on an SM
template <typename T>
struct DwCfg;
template <>
struct DwCfg<__nv_bfloat16> {
  static constexpr int MC = 32, kMinBlocks = 2;
};
template <>
struct DwCfg<float> {
  static constexpr int MC = 16, kMinBlocks = 2;
};

// In order: the scheme; the two combo tiles xc and dyc, each [MC][ld]; two
// chunk buffers of x4 and of dy4, each [4][MC][64]. Every region starts
// 128-byte aligned.
template <typename T>
struct DwLayout {
  static constexpr int MC = DwCfg<T>::MC;
  static constexpr int ld = Elem<T>::kLdb;  // 64 + pad, as the forward's B tile
  static constexpr int xc = align128(sizeof(DwScheme));
  static constexpr int dc = xc + align128(MC * ld * sizeof(T));
  static constexpr int stage = dc + align128(MC * ld * sizeof(T));
  static constexpr int stage_bytes = align128(4 * MC * BN * sizeof(T));  // one of x or dy
  static constexpr int total = stage + 4 * stage_bytes;  // x and dy, two chunks each
};

template <typename T>
__device__ inline float round_to(float v) {
  return Elem<T>::to_f(Elem<T>::from_f(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, DwCfg<T>::kMinBlocks)
qgemm10_dw_kernel(const T* __restrict__ x4, const T* __restrict__ dy4,
                  float* __restrict__ dw, int M, int K, int N, DwScheme scheme) {
  using L = DwLayout<T>;
  constexpr int V = Elem<T>::kVec, MC = L::MC, LD = L::ld, VPR = BN / V;
  extern __shared__ __align__(128) unsigned char smem[];
  DwScheme& sch = *reinterpret_cast<DwScheme*>(smem);
  if (threadIdx.x == 0) sch = scheme;
  T* xc = reinterpret_cast<T*>(smem + L::xc);
  T* dc = reinterpret_cast<T*>(smem + L::dc);

  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * BM;
  const int nchunks = (M + MC - 1) / MC;

  // chunk c of x4 (columns k0..k0+63) and dy4 (columns n0..n0+63), all four
  // components, into buffer c % 2; rows past M and columns past K or N are
  // zero-filled, so they add nothing
  auto issue = [&](int chunk) {
    T* xs = reinterpret_cast<T*>(smem + L::stage + (chunk % 2) * L::stage_bytes);
    T* ds = reinterpret_cast<T*>(smem + L::stage + (2 + chunk % 2) * L::stage_bytes);
    const int v = threadIdx.x % VPR, m0 = chunk * MC;
    for (int i = threadIdx.x / VPR; i < 4 * MC; i += kThreads / VPR) {
      const int a = i / MC, r = i % MC, m = m0 + r;
      const int k = k0 + v * V, n = n0 + v * V;
      const bool okx = m < M && k < K, okd = m < M && n < N;
      cp_async16(xs + (a * MC + r) * BN + v * V,
                 okx ? x4 + ((size_t)a * M + m) * K + k : x4, okx);
      cp_async16(ds + (a * MC + r) * BN + v * V,
                 okd ? dy4 + ((size_t)a * M + m) * N + n : dy4, okd);
    }
  };

  float y[4][kPerThread];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) y[a][j] = 0.0f;

  __syncthreads();  // the scheme
  issue(0);
  cp_async_commit();
  ProductAT<T, MC> prod;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; the last chunk's buffers are consumed
    if (chunk + 1 < nchunks) issue(chunk + 1);
    cp_async_commit();
    const T* xs = reinterpret_cast<const T*>(smem + L::stage + (chunk % 2) * L::stage_bytes);
    const T* ds =
        reinterpret_cast<const T*>(smem + L::stage + (2 + chunk % 2) * L::stage_bytes);
    for (int p = 0; p < P; ++p) {
      // the two combos of product p, each thread one 16-byte column of rows
      const int v = threadIdx.x % VPR;
      for (int r = threadIdx.x / VPR; r < MC; r += kThreads / VPR) {
        float u[V], w[V], c[V];
        load_vec(xs + (sch.x_a[p][0] * MC + r) * BN + v * V, u);
        load_vec(xs + (sch.x_a[p][1] * MC + r) * BN + v * V, w);
        const float c1 = sch.x_c[p][0], c2 = sch.x_c[p][1];
#pragma unroll
        for (int e = 0; e < V; ++e) c[e] = c1 * u[e] + c2 * w[e];
        store_vec(xc + r * LD + v * V, c);
        load_vec(ds + (sch.d_b[p][0] * MC + r) * BN + v * V, u);
#pragma unroll
        for (int e = 0; e < V; ++e) c[e] = sch.d_s[p][0] * u[e];
        for (int i = 1; i < sch.d_n[p]; ++i) {
          load_vec(ds + (sch.d_b[p][i] * MC + r) * BN + v * V, u);
          const float s = sch.d_s[p][i];
#pragma unroll
          for (int e = 0; e < V; ++e) c[e] = round_to<T>(c[e] + s * u[e]);
        }
        store_vec(dc + r * LD + v * V, c);
      }
      __syncthreads();  // the combos are complete
      prod.zero();
      prod.mma_t(xc, dc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float s = sch.w[a][p];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) y[a][j] += s * prod.at(j);
      }
      __syncthreads();  // the combos are consumed
    }
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = k0 + ProductAT<T, MC>::row(j), n = n0 + ProductAT<T, MC>::col(j);
    if (k >= K || n >= N) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a) dw[((size_t)a * K + k) * N + n] = y[a][j];
  }
}

template <typename T>
int launch(const void* x4, const void* dy4, float* dw, int M, int K, int N,
           const DwScheme& s, cudaStream_t stream) {
  constexpr int smem = DwLayout<T>::total;
  static_assert(smem <= kMaxSmem, "kernel I's tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      qgemm10_dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM);
  qgemm10_dw_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x4), static_cast<const T*>(dy4), dw, M, K, N, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x4 [4,M,K] and dy4 [4,M,N] in the compute dtype (0 = float32, 1 =
// bfloat16), K and N multiples of 8; dw [4,K,N] f32 out. xc [10*4]
// (X_COMBO), oc [4*10] (OUT_COMBO) and wcmb [10*4] (W_COMBO) are host
// pointers. Returns a cudaError_t (0 on success).
int qasr_qgemm10_dw(const void* x4, const void* dy4, void* dw, int M, int K, int N,
                    int dtype, const float* xc, const float* oc, const float* wcmb,
                    void* stream) {
  DwScheme s;
  if (make_dw_scheme(xc, oc, wcmb, &s) != 0) return (int)cudaErrorInvalidValue;
  if (K % 8 || N % 8 || (K + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  if (dtype == 0) return launch<float>(x4, dy4, out, M, K, N, s, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x4, dy4, out, M, K, N, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
