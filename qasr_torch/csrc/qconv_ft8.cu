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
// one layer is 5.0e11 FLOP (0.51 ms of tensor-core work) against ~0.23 GB
// moved. In bf16 it runs qconv.cuh's wgmma loop (qconv_wg_kernel: TMA
// windows and weight stages, two warpgroups of four products on wgmma with
// the V8 combos formed in registers by combo2, one fold); at one block an
// SM every block pulls all the weights of its 64 output channels from L2,
// ~7.9 GB a layer: the copies bound it, as they bound kernels F and H. In
// f32 it runs qconv_kernel (CUDA-core products, f32 accuracy).
#include "qconv.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bias [4*Cout] and alpha [4*Cin] are f32
// device pointers or NULL. v8 [8*4] and o8 [4*8] are host pointers. Returns
// a cudaError_t (0 on success); arguments the kernel does not take come back
// as cudaErrorInvalidValue (the Python wrapper checks them first).
int qasr_qconv_ft8(const void* x, const void* wc, const void* bias,
                   const void* alpha, void* out, int B, int F, int T_len, int Cin,
                   int Cout, int kh, int kw, int dtype, const float* v8,
                   const float* o8, void* stream) {
  return qconv::forward_entry<8>(x, wc, bias, alpha, out, B, F, T_len, Cin, Cout, kh, kw,
                                 dtype, v8, o8, stream);
}

const char* qasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
