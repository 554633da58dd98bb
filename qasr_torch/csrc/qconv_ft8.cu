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
// above the bf16 ridge of ~295: the tensor cores bound it. The main loop
// (qconv8.cuh) is an implicit GEMM per block (one 64-step time tile of one
// (b, f) row x 64 output channels): per Cin chunk of 16 the four input
// components over the halo window stay in shared memory for all eight
// products; per product the weights of all taps arrive by cp.async one step
// ahead (mma.sync m16n8k16 bf16, f32 accumulators). No wgmma or TMA yet;
// those are the next steps.
#include "qconv8.cuh"

using namespace qtile8;

namespace {

// bias, mask the ragged time and channel edges, store
template <typename T>
struct BiasStore {
  const float* bias;  // [4*Cout] or null
  T* out;             // [B,4,F,T,Cout]

  template <typename Prod>
  __device__ void store(float (&y)[4][kPerThread], unsigned char*,
                        const qconv8::Tile& tl) const {
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

template <typename T>
int launch(const void* x, const void* wc, const float* bias, const float* alpha,
           void* out, int B, int F, int T_len, int Cin, int Cout, int kh, int kw,
           const Scheme8& s, cudaStream_t stream) {
  return qconv8::launch<T>(x, wc, alpha, B, F, T_len, Cin, Cout, kh, kw, s,
                           BiasStore<T>{bias, static_cast<T*>(out)}, 0, stream);
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
  if (!qconv8::shape_ok(B, F, Cin, Cout, kh, kw)) return (int)cudaErrorInvalidValue;
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
