// The rank-8 stacked quaternion conv main loop, shared by kernel A
// (qconv_ft8.cu: the forward, with bias) and kernel C (qconv_dx8.cu: the
// transposed conv of the backward, with the PReLU backward). Each kernel
// supplies its epilogue; everything up to the four f32 output accumulators
// is this file.
//
//   acc[b,:,f,t,n] = sum_p O8[:,p] sum_{dt,df}
//                    (sum_a V8[p,a] act(x[b,a,f+df-pw,t+dt-ph,:])) . wc[p,dt*kw+df,:,n]
//
// x [B,4,F,T,Cin], wc [8,kh*kw,Cin,Cout] (U8-combined, kh over time, kw over
// frequency); act is the optional split-PReLU prologue x>=0 ? x : alpha*x.
// Out-of-range taps read as zero (SAME padding, odd kernels).
//
// One block: a 64-step time tile of one (b, f) row x 64 output channels, an
// implicit GEMM. Per Cin chunk, the four input components over the
// kw x (64+kh-1) halo window stay in shared memory for all eight products;
// per product, the weights of all kh*kw taps arrive by cp.async one step
// ahead, and the combos formed from the window are reused by all taps.
#pragma once

#include "qtile8.cuh"

namespace qconv8 {

using namespace qtile8;

// Cin chunk per step; two blocks fit on an SM at the 3x3 bf16 layer
template <typename T>
struct ConvCfg;
template <>
struct ConvCfg<__nv_bfloat16> {
  static constexpr int KC = 16, kMinBlocks = 2;
};
template <>
struct ConvCfg<float> {
  static constexpr int KC = 8, kMinBlocks = 1;
};

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
template <typename T, typename Epi>
__global__ void __launch_bounds__(kThreads, ConvCfg<T>::kMinBlocks)
qconv8_kernel(const T* __restrict__ x, const T* __restrict__ wc,
              const float* __restrict__ alpha, int F, int T_len, int Cin, int Cout,
              int kh, int kw, Scheme8 scheme, Epi epi) {
  constexpr int V = Elem<T>::kVec, KC = ConvCfg<T>::KC;
  constexpr int LDA = Layout<T, KC>::lda, LDB = Layout<T, KC>::ldb;
  using Prod = Product<T, KC>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int taps = kh * kw;
  const int rows = BM + kh - 1;  // time rows of the halo window
  const int a_rows = kw * rows;  // window row r: input (f + r/rows - pw, t0 - ph + r%rows)
  const Layout<T, KC> L(a_rows, taps);
  Scheme8& sch = *reinterpret_cast<Scheme8*>(smem);
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
  const int nsteps = nchunks * kProds;  // step = chunk * 8 + product

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
    const int p = step % kProds, c0 = (step / kProds) * KC;
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
    const int chunk = step / kProds, p = step % kProds;
    cp_async_wait_all();
    __syncthreads();  // this step's copies have landed; the last step's tiles are consumed
    // the next copies overwrite only what the last step read
    if (step + 1 < nsteps) issue_w(step + 1);
    if (p == kProds - 2 && chunk + 1 < nchunks) issue_x(chunk + 1);
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

// Dynamic shared memory of one block: the main loop's layout, or more when
// the epilogue asks for it (epi_bytes, from the start of shared memory).
template <typename T>
int smem_for(int kh, int kw, int epi_bytes = 0) {
  const int main = Layout<T, ConvCfg<T>::KC>(kw * (BM + kh - 1), kh * kw).total;
  return main > epi_bytes ? main : epi_bytes;
}

// Launch one instantiation over the grid (Cout tiles, T tiles, B*F).
template <typename T, typename Epi>
int launch(const void* x, const void* wc, const float* alpha, int B, int F, int T_len,
           int Cin, int Cout, int kh, int kw, const Scheme8& s, const Epi& epi,
           int epi_bytes, cudaStream_t stream) {
  const int smem = smem_for<T>(kh, kw, epi_bytes);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      qconv8_kernel<T, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Cout + BN - 1) / BN, (T_len + BM - 1) / BM, B * F);
  qconv8_kernel<T, Epi><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wc), alpha, F, T_len, Cin, Cout,
      kh, kw, s, epi);
  return (int)cudaGetLastError();
}

// The shape checks both C entries make (the Python wrappers check first).
inline bool shape_ok(int B, int F, int Cin, int Cout, int kh, int kw) {
  return kh % 2 == 1 && kw % 2 == 1 && Cin % 8 == 0 && Cout % 8 == 0 && B * F <= 65535;
}

}  // namespace qconv8
