// Kernel G: the transposed 10-product quaternion conv of the backward, with
// the previous layer's PReLU backward fused into its epilogue.
//
// Replaces the TPU kernels qasr/ops/pallas/qconv_ft.py:_ft_kernel in its dx
// role with the 10-product scheme (_ft_dx_impl under qconv2d_ft_stacked; no
// PReLU) and qasr/ops/pallas/qconv_chain.py:_dx_kernel with scheme="fast10"
// (op_variant="fusedchain"; with it), as kernel C replaces their rank-8
// forms.
//
// The adjoint of quaternion left-multiplication is multiplication by the
// conjugate, so the transposed SAME conv is a plain quaternion conv with
// conj(w), Cin and Cout swapped and both tap axes flipped
// (qasr/ops/pallas/qconv_ft.py:_conj_transpose_w). The Python wrapper forms
// the W_COMBO combos of those weights, and this runs kernel F's main loop
// (qconv.cuh, P = 10, the forward's X_COMBO input combos and OUT_COMBO
// recombination; in bf16 the wgmma loop) with kernel C's epilogue:
//
//   g       = convT(dz)                                 [B, 4, F, T, Cin]
//   dx      = z_prev < 0 ? alpha * g : g
//   dalpha  = sum over B, F, T of (z_prev < 0 ? g * z_prev : 0)   (f32,
//             two passes in a fixed order: the same bits every run)
//
// The TPU's dx role rotated the scheme's roles instead (input combos from
// OUT_COMBO's columns, flip-transposed W_COMBO weights, output from
// X_COMBO's columns); both compute the same transposed conv.
//
// What bounds it on an H100: kernel F's work (6.3e11 FLOP a QCNN-256 layer
// at B16 F13 T256 C256 3x3) on kernel F's loop, whose weight copies bound
// it. The epilogue reads z_prev once and writes dx once; the partials'
// time tile is the loop's (64 steps), so their row count is kernel C's.
#include "qconv.cuh"

extern "C" {

// Arguments as qasr_qconv_dx8's (the partials buffer has
// qasr_qconv_dx8_partial_rows rows), with the 10-product tables: v [10*4]
// (X_COMBO) and o [4*10] (OUT_COMBO), host pointers.
int qasr_qconv_dx10(const void* dz, const void* wc, const void* z, const void* alpha,
                    void* dx, void* partials, void* dalpha, int B, int F, int T_len,
                    int Cin, int Cout, int kh, int kw, int dtype, const float* v,
                    const float* o, void* stream) {
  return qconv::dx_entry<10>(dz, wc, z, alpha, dx, partials, dalpha, B, F, T_len, Cin,
                             Cout, kh, kw, dtype, v, o, stream);
}

}  // extern "C"
