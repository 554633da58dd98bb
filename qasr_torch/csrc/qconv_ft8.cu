// Kernel A: rank-8 quaternion conv2d on the component-stacked, frequency-major
// layout, with the previous layer's split PReLU as an optional prologue and
// the bias as an optional epilogue.
//
// Replaces the TPU kernels qasr/ops/pallas/qconv_ft.py:_ft_kernel (forward
// role, rank-8 scheme) and qasr/ops/pallas/qconv_chain.py:_fwd_kernel (the
// same conv with the PReLU prologue and bias epilogue; its margin-padded
// buffer was a TPU BlockSpec device and is not carried over: out-of-range
// taps read as zero here instead).
//
//   y[b,:,f,t,n] = bias + sum_p O8[:,p] sum_{dt,df}
//                  (sum_a V8[p,a] act(x[b,a,f+df-pw,t+dt-ph,:])) . wc[p,dt*kw+df,:,n]
//
// x [B,4,F,T,Cin], wc [8,kh*kw,Cin,Cout] (U8-combined, kh over time, kw over
// frequency), out [B,4,F,T,Cout]; act is x>=0 ? x : alpha*x per real channel.
//
// What bounds it on an H100: at the QCNN-256 layer (B16 F13 T256 C256, 3x3)
// one layer is 5.0e11 FLOP against ~0.23 GB moved, about 2,000 FLOP/byte, far
// above the bf16 ridge of ~295: the tensor cores bound it. The design is an
// implicit GEMM per block (one 64-step time tile of one (b, f) row x 64
// output channels). Per Cin chunk of 16, the four input components over the
// kw x (64+kh-1) halo window stay in shared memory for all eight products;
// per product, the weights of all kh*kw taps arrive by cp.async one step
// ahead, and the combos formed from the window are reused by all taps
// (mma.sync m16n8k16 bf16, f32 accumulators). No wgmma or TMA yet; those
// are the next steps.
#include "qtile8.cuh"

using namespace qtile8;

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads, ConvCfg<T>::kMinBlocks)
qconv_ft8_kernel(const T* __restrict__ x, const T* __restrict__ wc,
                 const float* __restrict__ bias, const float* __restrict__ alpha,
                 T* __restrict__ out, int F, int T_len, int Cin, int Cout, int kh,
                 int kw, Scheme8 scheme) {
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

  // epilogue: bias, mask the ragged time and channel edges, store
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int t = t0 + Prod::row(j), n = n0 + Prod::col(j);
    if (t >= T_len || n >= Cout) continue;
#pragma unroll
    for (int bo = 0; bo < 4; ++bo) {
      const float bv = bias != nullptr ? bias[bo * Cout + n] : 0.0f;
      out[((((size_t)b * 4 + bo) * F + f) * T_len + t) * Cout + n] =
          Elem<T>::from_f(y[bo][j] + bv);
    }
  }
}

template <typename T>
int smem_for(int kh, int kw) {
  return Layout<T, ConvCfg<T>::KC>(kw * (BM + kh - 1), kh * kw).total;
}

template <typename T>
int launch(const void* x, const void* wc, const float* bias, const float* alpha,
           void* out, int B, int F, int T_len, int Cin, int Cout, int kh, int kw,
           const Scheme8& s, cudaStream_t stream) {
  const int smem = smem_for<T>(kh, kw);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      qconv_ft8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Cout + BN - 1) / BN, (T_len + BM - 1) / BM, B * F);
  qconv_ft8_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wc), bias, alpha,
      static_cast<T*>(out), F, T_len, Cin, Cout, kh, kw, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bias [4*Cout] and alpha [4*Cin] are f32
// device pointers or NULL. v8 [8*4] and o8 [4*8] are host pointers. Returns
// a cudaError_t (0 on success); arguments the kernel does not take come back
// as cudaErrorInvalidValue (the Python wrapper checks them first).
int qasr_qconv_ft8(const void* x, const void* wc, const void* bias,
                   const void* alpha, void* out, int B, int F, int T_len, int Cin,
                   int Cout, int kh, int kw, int dtype, const float* v8,
                   const float* o8, void* stream) {
  Scheme8 s;
  if (make_scheme(v8, o8, &s) != 0) return (int)cudaErrorInvalidValue;
  if (kh % 2 == 0 || kw % 2 == 0 || Cin % 8 || Cout % 8 || B * F > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* a = static_cast<const float*>(alpha);
  if (dtype == 0)
    return launch<float>(x, wc, b, a, out, B, F, T_len, Cin, Cout, kh, kw, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wc, b, a, out, B, F, T_len, Cin, Cout, kh, kw,
                                 s, st);
  return (int)cudaErrorInvalidValue;
}

const char* qasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
