// The stacked quaternion conv main loop of P products, shared by kernels A
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
// implicit GEMM. Per Cin chunk, the four input components over the
// kw x (64+kh-1) halo window stay in shared memory for all P products;
// per product, the weights of all kh*kw taps arrive by cp.async one step
// ahead, and the combos formed from the window are reused by all taps.
#pragma once

#include "qtile.cuh"

namespace qconv {

using namespace qtile;

// Cin chunk per step; two blocks fit on an SM at the 3x3 bf16 layer (the
// scheme's size is the only part of the layout that grows with P)
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
template <typename T, int P, typename Epi>
__global__ void __launch_bounds__(kThreads, ConvCfg<T>::kMinBlocks)
qconv_kernel(const T* __restrict__ x, const T* __restrict__ wc,
             const float* __restrict__ alpha, int F, int T_len, int Cin, int Cout,
             int kh, int kw, Scheme<P> scheme, Epi epi) {
  constexpr int V = Elem<T>::kVec, KC = ConvCfg<T>::KC;
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

// Dynamic shared memory of one block: the main loop's layout, or more when
// the epilogue asks for it (epi_bytes, from the start of shared memory).
template <typename T, int P>
int smem_for(int kh, int kw, int epi_bytes = 0) {
  const int main = Layout<T, ConvCfg<T>::KC, P>(kw * (BM + kh - 1), kh * kw).total;
  return main > epi_bytes ? main : epi_bytes;
}

// Launch one instantiation over the grid (Cout tiles, T tiles, B*F).
template <typename T, int P, typename Epi>
int launch(const void* x, const void* wc, const float* alpha, int B, int F, int T_len,
           int Cin, int Cout, int kh, int kw, const Scheme<P>& s, const Epi& epi,
           int epi_bytes, cudaStream_t stream) {
  const int smem = smem_for<T, P>(kh, kw, epi_bytes);
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
