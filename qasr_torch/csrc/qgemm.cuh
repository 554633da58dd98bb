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
// The input combos (at most two V terms) are formed in shared memory as each
// input chunk arrives, so they never reach device memory. Each block owns a
// 64x64 tile of all four components; per K chunk the four input components
// stay in shared memory while the P products run over them, each product's
// weights arriving by cp.async one step ahead (mma.sync m16n8k16 bf16, f32
// accumulators; f32 on the CUDA cores), and each product is folded into the
// four outputs with column p of O in registers.
#pragma once

#include "qtile.cuh"

namespace qgemm {

using namespace qtile;

// K chunk per step; two blocks fit on an SM in bf16
template <typename T>
struct GemmCfg;
template <>
struct GemmCfg<__nv_bfloat16> {
  static constexpr int KC = 64, kMinBlocks = 2;
};
template <>
struct GemmCfg<float> {
  static constexpr int KC = 32, kMinBlocks = 1;
};

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, GemmCfg<T>::kMinBlocks)
qgemm_kernel(const T* __restrict__ x4, const T* __restrict__ wc,
             T* __restrict__ y4, int M, int K, int N, Scheme<P> scheme) {
  constexpr int V = Elem<T>::kVec, KC = GemmCfg<T>::KC;
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

template <typename T, int P>
int launch(const void* x4, const void* wc, void* y4, int M, int K, int N,
           const Scheme<P>& s, cudaStream_t stream) {
  const int smem = Layout<T, GemmCfg<T>::KC, P>(BM, 1).total;
  cudaError_t err = cudaFuncSetAttribute(
      qgemm_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qgemm_kernel<T, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x4), static_cast<const T*>(wc), static_cast<T*>(y4), M, K, N, s);
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
  if (K % 8 || N % 8 || (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, P>(x4, wc, y4, M, K, N, s, st);
  if (dtype == 1) return launch<__nv_bfloat16, P>(x4, wc, y4, M, K, N, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace qgemm
