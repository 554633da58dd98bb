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
// those weights' U8 combos; the main loop and the epilogue are in qconv.cuh:
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
// What bounds it on an H100: the same main loop as kernel A (qconv.cuh's
// wgmma loop in bf16, qconv_kernel in f32) and the same work (5.0e11 FLOP a
// QCNN-256 layer at B16 F13 T256 C256 3x3): the copies of the weight tiles
// into the SMs. The epilogue reads z_prev once and writes dx once (~0.14 GB
// in bf16 at that shape), and the partials are 3.4 MB.
#include "qconv.cuh"

extern "C" {

// Rows of the dalpha partials buffer the caller allocates ([rows, 4*Cout] f32),
// for kernels C and G alike.
int qasr_qconv_dx8_partial_rows(int B, int F, int T_len) {
  return qconv::partial_rows(B, F, T_len);
}

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
  return qconv::dx_entry<8>(dz, wc, z, alpha, dx, partials, dalpha, B, F, T_len, Cin, Cout,
                            kh, kw, dtype, v8, o8, stream);
}

}  // extern "C"
