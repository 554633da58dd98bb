// Kernel C: the transposed rank-8 quaternion conv of the backward, with the
// previous layer's PReLU backward fused into its epilogue.
//
// Replaces the TPU kernels qasr/ops/pallas/qconv_chain.py:_dx_kernel (with
// the PReLU backward) and qasr/ops/pallas/qconv_ft.py:_ft_kernel in its dx
// role (_ft_dx_impl; without it).
//
// The adjoint of quaternion left-multiplication is multiplication by the
// conjugate, so the transposed SAME conv is a plain quaternion conv with
// conj(w), Cin and Cout swapped and both tap axes flipped
// (qasr/ops/pallas/qconv_ft.py:_conj_transpose_w). The Python wrapper forms
// those weights' U8 combos; the main loop is kernel A's (qconv8.cuh):
//
//   g[b,:,f,t,c] = convT(dz)  on dz [B,4,F,T,Cout] -> [B,4,F,T,Cin]
//
// Epilogue, when given z_prev [B,4,F,T,Cin] (this layer's input, the
// previous layer's pre-activation) and alpha [4*Cin] (its PReLU slopes):
//
//   neg     = z_prev < 0
//   dx      = neg ? alpha * g : g
//   dalpha += sum over B, F, T of (neg ? g * z_prev : 0)      (f32)
//
// dalpha is reduced without atomics, so it is deterministic: each block sums
// its 64 time rows per channel in a fixed order into a partial row of
// partials [B*F*ceil(T/64), 4*Cin]; a second small launch sums the partial
// rows in order. Without z_prev (the first stacked layer) dx = g and
// neither happens.
//
// What bounds it on an H100: the same work as kernel A (5.0e11 FLOP a
// QCNN-256 layer at B16 F13 T256 C256 3x3, ~2,000 FLOP/byte): the tensor
// cores. The epilogue reads z_prev once and writes dx once (~0.14 GB in
// bf16 at that shape), and the partials are 3.4 MB.
#include "qconv8.cuh"

using namespace qtile8;

namespace {

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
                        const qconv8::Tile& tl) const {
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

// dalpha[i] = sum over partial rows r, in order, of partials[r, i]
__global__ void dalpha_reduce_kernel(const float* __restrict__ partials,
                                     float* __restrict__ dalpha, int rows, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += partials[(size_t)r * n4 + i];
  dalpha[i] = s;
}

int partial_rows(int B, int F, int T_len) { return B * F * ((T_len + BM - 1) / BM); }

template <typename T>
int launch(const void* dz, const void* wc, const void* z, const float* alpha, void* dx,
           float* partials, float* dalpha, int B, int F, int T_len, int Cin, int Cout,
           int kh, int kw, const Scheme8& s, cudaStream_t stream) {
  const PreluBwdStore<T> epi{static_cast<const T*>(z), alpha, static_cast<T*>(dx), partials};
  int err = qconv8::launch<T>(dz, wc, nullptr, B, F, T_len, Cin, Cout, kh, kw, s, epi,
                              z != nullptr ? kRedBytes : 0, stream);
  if (err != 0 || z == nullptr) return err;
  const int n4 = 4 * Cout;
  dalpha_reduce_kernel<<<(n4 + 255) / 256, 256, 0, stream>>>(
      partials, dalpha, partial_rows(B, F, T_len), n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the dalpha partials buffer the caller allocates ([rows, 4*Cout] f32).
int qasr_qconv_dx8_partial_rows(int B, int F, int T_len) { return partial_rows(B, F, T_len); }

// dz [B,4,F,T,Cin] and wc [8,kh*kw,Cin,Cout] (the U8 combos of the
// conj-transposed, flipped weights: Cin here is the forward's Cout) in the
// compute dtype (0 = float32, 1 = bfloat16); dx [B,4,F,T,Cout] out. With
// z [B,4,F,T,Cout] (same dtype) and alpha [4*Cout] f32, also the PReLU
// backward, partials (scratch, see above) and dalpha [4*Cout] f32 out; with
// z NULL, alpha, partials and dalpha are unused. v8 and o8 are host
// pointers. Returns a cudaError_t (0 on success).
int qasr_qconv_dx8(const void* dz, const void* wc, const void* z, const void* alpha,
                   void* dx, void* partials, void* dalpha, int B, int F, int T_len,
                   int Cin, int Cout, int kh, int kw, int dtype, const float* v8,
                   const float* o8, void* stream) {
  Scheme8 s;
  if (make_scheme(v8, o8, &s) != 0) return (int)cudaErrorInvalidValue;
  if (!qconv8::shape_ok(B, F, Cin, Cout, kh, kw)) return (int)cudaErrorInvalidValue;
  if (z != nullptr && (alpha == nullptr || partials == nullptr || dalpha == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  float* p = static_cast<float*>(partials);
  float* da = static_cast<float*>(dalpha);
  if (dtype == 0)
    return launch<float>(dz, wc, z, a, dx, p, da, B, F, T_len, Cin, Cout, kh, kw, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dz, wc, z, a, dx, p, da, B, F, T_len, Cin, Cout, kh, kw,
                                 s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
