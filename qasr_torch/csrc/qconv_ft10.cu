// Kernel F: the 10-product quaternion conv2d on the component-stacked,
// frequency-major layout, with the previous layer's split PReLU as an
// optional prologue and the bias as an optional epilogue.
//
// Replaces the TPU kernels qasr/ops/pallas/qconv_ft.py:_ft_kernel in its
// forward role with the 10-product scheme (SCHEME10, qconv2d_ft_stacked's
// _ft_fwd_impl) and qasr/ops/pallas/qconv_chain.py:_fwd_kernel with
// scheme="fast10" (op_variant="fusedchain"), as kernel A replaces their
// rank-8 forms:
//
//   y[b,:,f,t,n] = bias + sum_p OUT_COMBO[:,p] sum_{dt,df}
//                  (sum_a X_COMBO[p,a] act(x[b,a,f+df-pw,t+dt-ph,:]))
//                  . wc[p,dt*kw+df,:,n]
//
// x [B,4,F,T,Cin], wc [10,kh*kw,Cin,Cout] (W_COMBO-combined, kh over time,
// kw over frequency), out [B,4,F,T,Cout]; act is x>=0 ? x : alpha*x per real
// channel. The input combos (one or two terms of coefficient 1) are formed
// in the storage dtype, the products accumulate in f32 and the ±1
// recombination runs in f32 registers, as _ft_kernel does.
//
// What bounds it on an H100: at the QCNN-256 layer (B16 F13 T256 C256, 3x3)
// one layer executes 6.3e11 FLOP (0.64 ms of tensor-core work) against ~0.23
// GB moved. In bf16 it runs qconv.cuh's wgmma loop (qconv_wg_kernel: TMA
// windows and weight stages, two warpgroups of five products on wgmma with
// the combos formed in registers, one fold); at one block an SM every block
// pulls all the weights of its 64 output channels from L2, ~9.8 GB a layer:
// the copies bound it, as they bound kernel H. The prologue activates each
// chunk's window in place once, before the chunk's barrier. In f32 it runs
// kernel A's loop (qconv_kernel) with P = 10.
#include "qconv.cuh"

extern "C" {

// Arguments as qasr_qconv_ft8's, with the 10-product tables: v [10*4]
// (X_COMBO) and o [4*10] (OUT_COMBO), host pointers.
int qasr_qconv_ft10(const void* x, const void* wc, const void* bias,
                    const void* alpha, void* out, int B, int F, int T_len, int Cin,
                    int Cout, int kh, int kw, int dtype, const float* v,
                    const float* o, void* stream) {
  return qconv::forward_entry<10>(x, wc, bias, alpha, out, B, F, T_len, Cin, Cout, kh, kw,
                                  dtype, v, o, stream);
}

}  // extern "C"
