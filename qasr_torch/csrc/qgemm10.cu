// Kernel H: the 10-product quaternion GEMM on the component-leading layout.
//
// Replaces the TPU kernel qasr/ops/pallas/qgemm.py:_qgemm_kernel, in both of
// its roles: the forward of qgemm_stacked (the dense layers under
// dense_variant="pallas" or use_pallas, and the slice-im2col convs under
// use_pallas) and its dx, the same kernel on the W_COMBO combos of the
// conjugate-transposed weights (qgemm.py:_conj_transpose_w):
//
//   y4[b] = sum_p OUT_COMBO[b,p] ((sum_a X_COMBO[p,a] x4[a]) @ wc[p])
//
// x4 [4,M,K], wc [10,K,N] (W_COMBO-combined), y4 [4,M,N]. The input combos
// (one or two components, coefficient 1) are formed in the storage dtype,
// the products accumulate in f32 and the ±1 recombination runs in f32, with
// one cast at the end, as _qgemm_kernel does.
//
// What bounds it on an H100: the dense layer K=3328 -> N=256 at M = 4096 is
// 7.0e10 executed FLOP (ten products) against ~0.13 GB, ~540 FLOP/byte: the
// tensor cores, just; the 256 -> 256 layers (~300 FLOP/byte) sit at the
// ridge; the im2col convs (M53248 K2304) carry ~9.8 GB of weight-tile and
// ~3.9 GB of x-tile traffic through L2 at 64 x 64 tiles. The design is
// kernel B's (qgemm.cuh with P = 10): two warpgroups of five products each
// on wgmma, the combos (one or two components, coefficient 1: an add in
// bf16) formed in registers, ten accumulators folded with OUT_COMBO once.
// Its input terms are compiled in; the host checks the tables it is
// passed against them.
#include "qgemm.cuh"

extern "C" {

// Arguments as qasr_qgemm8's, with the 10-product tables: v [10*4] (X_COMBO)
// and o [4*10] (OUT_COMBO), host pointers.
int qasr_qgemm10(const void* x4, const void* wc, void* y4, int M, int K, int N, int dtype,
                 const float* v, const float* o, void* stream) {
  return qgemm::entry<10>(x4, wc, y4, M, K, N, dtype, v, o, stream);
}

}  // extern "C"
