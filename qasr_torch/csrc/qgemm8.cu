// Kernel B: rank-8 quaternion GEMM on the component-leading layout.
//
// Replaces the TPU kernel qasr/ops/pallas/qgemm8.py:_qgemm8_kernel (forward
// role, in_kind="fwd"; the dx role runs the same kernel on the U8 combos of
// the conjugate-transposed weights):
//
//   y4[b] = sum_p O8[b,p] ((sum_a V8[p,a] x4[a]) @ wc8[p])
//
// x4 [4,M,K], wc8 [8,K,N] (U8-combined), y4 [4,M,N]; the main loop is
// qgemm.cuh's with P = 8.
//
// What bounds it on an H100: at the QCNN-256 dense layers (M = B*T = 4096)
// the K=3328 -> N=256 layer is 5.6e10 FLOP against ~0.13 GB, about 430
// FLOP/byte, just above the bf16 ridge of ~295; the two 256 -> 256 layers are
// near 240 FLOP/byte, at the ridge. With 64 x 64 tiles, though, the x and
// weight tiles cross L2 once per N and M tile (~1.3 GB at K3328), and that
// traffic, not the products, bounds the call. The design (qgemm.cuh): two
// warpgroups each run four of the eight products over the block's tile with
// wgmma, the V8 combos formed in registers (each coefficient rounded to
// bf16, each scaled term and their sum rounded once, as the TPU kernel's
// _scaled and +), eight f32 accumulators folded with O8 once at the end,
// and a four-stage TMA ring behind one barrier a chunk.
#include "qgemm.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. v8 [8*4] and o8 [4*8] are host pointers.
// Returns a cudaError_t (0 on success).
int qasr_qgemm8(const void* x4, const void* wc8, void* y4, int M, int K, int N,
                int dtype, const float* v8, const float* o8, void* stream) {
  return qgemm::entry<8>(x4, wc8, y4, M, K, N, dtype, v8, o8, stream);
}

}  // extern "C"
