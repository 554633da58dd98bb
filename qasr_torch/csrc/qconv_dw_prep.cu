// Kernel K: everything the stacked quaternion conv's weight gradient reads,
// in one pass.
//
// Replaces no TPU kernel: the JAX package left dW to XLA
// (qasr/ops/pallas/qconv_ft.py:_ft_dw_impl, P correlation convs on the input
// and output combos). The port runs those P correlations on cuDNN's wgrad
// (ops/kernels/qconv_chain.py:qconv_dw); K makes what they read, which plain
// PyTorch made in some forty launches a layer (the PReLU, the strided combo
// products and adds, an f32 GEMM with K = 4 for the output combos, its cast,
// a second f32 copy of dz for db). From the conv's saved pre-activation
// x [B,4,F,T,Cin], the previous layer's PReLU slopes alpha [4*Cin] (or none,
// for a chain's first layer) and the output cotangent dz [B,4,F,T,Cout]:
//
//   act      = x >= 0 ? x : a * x                 a = alpha rounded to T
//   xc[p]    = sum_a V[p,a] act_a                 [P,B,F,T,Cin]
//   dzc[p]   = sum_b O[b,p] dz_b                  [P,B,F,T,Cout]
//   db[b,n]  = sum over B, F, T of dz_b[.., n]    [4*Cout] f32
//
// with the plain version's rounding (qconv_dw_prep.py:qconv_dw_prep_plain),
// so that the combos are the same bits: the PReLU's product rounded to T; in
// each input combo every coefficient rounded to T, every scaled term rounded
// to T, then their sum rounded to T (qconv_ft.py:_combo); each output combo
// an f32 sum of fused multiply-adds in b order from 0, rounded once to T
// (the f32 GEMM the plain version's einsum runs, then its cast).
//
// What bounds it on an H100: bytes. It reads x and dz once and writes 2P
// combos of the same rows: at QCNN-256's layer (B16 F13 T360 C256 bf16)
// 0.31 GB read and 0.61 GB written, 0.27 ms at 3.35 TB/s, against no
// arithmetic to speak of. The design:
// - A block owns a run of rows of M = B*F*T, across every channel of all
//   four components: kRows rows, or a multiple of it so that the grid
//   stays within kMaxBlocks (one or two waves on 132 SMs). A thread owns
//   one 16-byte vector of channels (8 bf16, 4 f32) and walks the block's
//   rows: per row it loads the four components' vectors once and stores
//   the P combos from registers. Neighbouring threads hold neighbouring
//   vectors, so every load and store is a full 16-byte access of a
//   coalesced run.
// - The scheme is compiled in (V and O below, for P = 8 and P = 10; the
//   host refuses tables that differ), so each combo is a fixed sequence of
//   products and adds, and the zero terms cost nothing.
// - db without atomics: each thread sums its channels over its rows in
//   order, the block adds its threads' sums in row-thread order in shared
//   memory into one partial row of part [blocks, 4*Cout], and a second pass
//   adds the partial rows in a fixed order: 32 lanes a column, each summing
//   every 32nd row in turn, then the lanes in turn. Every run gives the
//   same bits. (qtile's reduce_splits gives each column a single thread,
//   which walks the partial rows one after another: at 64 channels its
//   whole grid is one block of 256 threads.)
#include <utility>

#include "qtile.cuh"

using namespace qtile;

namespace {

constexpr int kRows = 64;          // rows of M a block owns, at the least
constexpr int kMaxBlocks = 1024;   // and blocks in the grid, at the most
constexpr int kRedCols = 32;       // the second pass: columns a block
constexpr int kRedLanes = 32;      // and lanes a column

// The schemes' input (V [P][4]) and output (O [4][P]) tables in f32, as
// qasr_torch/ops/quaternion.py holds them (V8, O8; X_COMBO, OUT_COMBO).
template <int P>
__host__ __device__ constexpr float v_tab(int p, int a);
template <int P>
__host__ __device__ constexpr float o_tab(int b, int p);

template <>
__host__ __device__ constexpr float v_tab<8>(int p, int a) {
  constexpr float t[8][4] = {
      {0.0f, 0.451378644f, 0.0f, 0.892332494f},
      {0.844631851f, -0.535347581f, 0.0f, 0.0f},
      {0.847533524f, 0.0f, -0.53074187f, 0.0f},
      {0.0f, 0.0f, 0.535170138f, 0.844744265f},
      {-0.702836573f, 0.0f, -0.711351395f, 0.0f},
      {-0.682803094f, -0.730602443f, 0.0f, 0.0f},
      {0.0f, 0.78153652f, 0.0f, -0.623859525f},
      {0.0f, 0.0f, 0.682885408f, -0.730525494f},
  };
  return t[p][a];
}

template <>
__host__ __device__ constexpr float o_tab<8>(int b, int p) {
  constexpr float t[4][8] = {
      {0.626146019f, -0.0176747777f, -0.387064666f, -0.164142609f, 0.409447581f,
       -0.0563018918f, 0.44752562f, -0.9720667f},
      {-0.335454881f, 0.964363873f, -0.59301573f, 0.230218753f, 0.736781001f,
       0.0320916064f, -0.30764538f, -0.217218131f},
      {0.345541596f, -0.0615378581f, 0.5731498f, 0.0116627105f, 0.476646036f,
       0.967369199f, -0.476901621f, -0.0543181524f},
      {0.61319834f, 0.256715924f, -0.412325799f, -0.959124863f, -0.249629751f,
       0.244943053f, -0.691115022f, -0.0703718215f},
  };
  return t[b][p];
}

template <>
__host__ __device__ constexpr float v_tab<10>(int p, int a) {
  constexpr float t[10][4] = {
      {1.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 1.0f, 0.0f},
      {0.0f, 0.0f, 0.0f, 1.0f}, {1.0f, 1.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 1.0f, 1.0f},
      {1.0f, 0.0f, 1.0f, 0.0f}, {0.0f, 1.0f, 0.0f, 1.0f}, {1.0f, 0.0f, 0.0f, 1.0f},
      {0.0f, 1.0f, 1.0f, 0.0f},
  };
  return t[p][a];
}

template <>
__host__ __device__ constexpr float o_tab<10>(int b, int p) {
  constexpr float t[4][10] = {
      {1.0f, -1.0f, -1.0f, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
      {-1.0f, -1.0f, -1.0f, 1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f},
      {-1.0f, 1.0f, -1.0f, -1.0f, 0.0f, 0.0f, 1.0f, 1.0f, 0.0f, 0.0f},
      {-1.0f, -1.0f, 1.0f, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 1.0f},
  };
  return t[b][p];
}

// the component of product p's n-th nonzero input term (n = 0, 1), or -1
template <int P>
__host__ __device__ constexpr int in_term(int p, int n) {
  for (int a = 0; a < 4; ++a)
    if (v_tab<P>(p, a) != 0.0f && n-- == 0) return a;
  return -1;
}

// 0 when v [P*4] and o [4*P] (row-major, host memory) are the compiled
// scheme, else -1
template <int P>
int check_tables(const float* v, const float* o) {
  for (int p = 0; p < P; ++p)
    for (int a = 0; a < 4; ++a)
      if (v[p * 4 + a] != v_tab<P>(p, a) || o[a * P + p] != o_tab<P>(a, p)) return -1;
  return 0;
}

// f(std::integral_constant<int, p>) for p = 0..P-1 in order: each
// product's terms and coefficients are constants of its own instance, so
// no register array is indexed at run time
template <int... ps, typename F>
__device__ __forceinline__ void each_prod(std::integer_sequence<int, ps...>, F&& f) {
  (f(std::integral_constant<int, ps>{}), ...);
}

// v rounded to the storage dtype and back
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Elem<T>::to_f(Elem<T>::from_f(v));
}

// Threads of a block laid over one phase's rows and channel vectors: tx_n
// threads across the vectors of a row, ty_n rows at a time.
struct Lanes {
  int vpr, tx_n, ty_n, tx, ty;
  __device__ Lanes(int C, int vec) {
    vpr = C / vec;
    tx_n = min(vpr, kThreads);
    ty_n = kThreads / tx_n;
    tx = threadIdx.x % tx_n;
    ty = threadIdx.x / tx_n;
  }
};

template <typename T, int P, bool kPrelu>
__global__ void __launch_bounds__(kThreads)
qconv_dw_prep_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                     const T* __restrict__ dz, T* __restrict__ xc, T* __restrict__ dzc,
                     float* __restrict__ part, int M, int FT, int Cin, int Cout, int R) {
  constexpr int V = Elem<T>::kVec;
  __shared__ float red[kThreads * 4 * V];
  const int m0 = blockIdx.x * R;
  const int rows = min(R, M - m0);

  // the input combos, after the PReLU
  {
    const Lanes L(Cin, V);
    if (L.ty < L.ty_n) {
      for (int v = L.tx; v < L.vpr; v += L.tx_n) {
        const int c = v * V;
        float a[4][V];
        if constexpr (kPrelu) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            load_vec(alpha + q * Cin + c, a[q]);  // f32: four floats at a time
            if constexpr (V == 8) load_vec(alpha + q * Cin + c + 4, a[q] + 4);
#pragma unroll
            for (int e = 0; e < V; ++e) a[q][e] = rnd<T>(a[q][e]);
          }
        }
#pragma unroll 2
        for (int r = L.ty; r < rows; r += L.ty_n) {
          const int m = m0 + r;
          const int b = m / FT;
          const T* src = x + ((size_t)b * 4 * FT + (m - b * FT)) * Cin + c;
          float u[4][V];
#pragma unroll
          for (int q = 0; q < 4; ++q) load_vec(src + (size_t)q * FT * Cin, u[q]);
          if constexpr (kPrelu) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int e = 0; e < V; ++e)
                if (!(u[q][e] >= 0.0f)) u[q][e] = rnd<T>(__fmul_rn(a[q][e], u[q][e]));
          }
          T* dst = xc + (size_t)m * Cin + c;
          each_prod(std::make_integer_sequence<int, P>{}, [&](auto pc) {
            constexpr int p = decltype(pc)::value;
            constexpr int a1 = in_term<P>(p, 0), a2 = in_term<P>(p, 1);
            const float c1 = rnd<T>(v_tab<P>(p, a1));
            float cmb[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float t1 = rnd<T>(__fmul_rn(u[a1][e], c1));
              if constexpr (a2 < 0) {
                cmb[e] = t1;
              } else {
                const float t2 = rnd<T>(__fmul_rn(u[a2][e], rnd<T>(v_tab<P>(p, a2))));
                cmb[e] = __fadd_rn(t1, t2);  // rounded to T by the store
              }
            }
            store_vec(dst + (size_t)p * M * Cin, cmb);
          });
        }
      }
    }
  }

  // the output combos and db's partial row
  {
    const Lanes L(Cout, V);
    for (int v0 = 0; v0 < L.vpr; v0 += L.tx_n) {
      const int v = v0 + L.tx;
      const int c = v * V;
      float acc[4][V];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[q][e] = 0.0f;
      if (L.ty < L.ty_n && v < L.vpr) {
#pragma unroll 2
        for (int r = L.ty; r < rows; r += L.ty_n) {
          const int m = m0 + r;
          const int b = m / FT;
          const T* src = dz + ((size_t)b * 4 * FT + (m - b * FT)) * Cout + c;
          float g[4][V];
#pragma unroll
          for (int q = 0; q < 4; ++q) load_vec(src + (size_t)q * FT * Cout, g[q]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[q][e] = __fadd_rn(acc[q][e], g[q][e]);
          T* dst = dzc + (size_t)m * Cout + c;
          each_prod(std::make_integer_sequence<int, P>{}, [&](auto pc) {
            constexpr int p = decltype(pc)::value;
            constexpr float o0 = o_tab<P>(0, p), o1 = o_tab<P>(1, p);
            constexpr float o2 = o_tab<P>(2, p), o3 = o_tab<P>(3, p);
            float cmb[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
              float s = 0.0f;
              if constexpr (o0 != 0.0f) s = __fmaf_rn(g[0][e], o0, s);
              if constexpr (o1 != 0.0f) s = __fmaf_rn(g[1][e], o1, s);
              if constexpr (o2 != 0.0f) s = __fmaf_rn(g[2][e], o2, s);
              if constexpr (o3 != 0.0f) s = __fmaf_rn(g[3][e], o3, s);
              cmb[e] = s;
            }
            store_vec(dst + (size_t)p * M * Cout, cmb);
          });
        }
      }
      // the block's sum of each (component, channel): its rows' threads in
      // order
      const int width = L.tx_n * V;
      __syncthreads();  // the previous pass's readers are done with red
      if (L.ty < L.ty_n) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < V; ++e) red[(L.ty * 4 + q) * width + L.tx * V + e] = acc[q][e];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 4 * width; i += kThreads) {
        const int q = i / width, col = i - q * width;
        const int n = v0 * V + col;
        if (n >= Cout) continue;
        float s = red[q * width + col];
        for (int y = 1; y < L.ty_n; ++y) s = __fadd_rn(s, red[(y * 4 + q) * width + col]);
        part[((size_t)blockIdx.x * 4 + q) * Cout + n] = s;
      }
    }
  }
}

// db[i] = the sum of part[r, i] over the partial rows r, in a fixed order:
// lane l of column i sums rows l, l + 32, ... in turn, then lane 0 adds the
// 32 lanes in turn
__global__ void __launch_bounds__(kRedCols * kRedLanes)
db_reduce_kernel(const float* __restrict__ part, float* __restrict__ db, int rows, int count) {
  __shared__ float lanes[kRedLanes][kRedCols + 1];
  const int col = threadIdx.x % kRedCols, lane = threadIdx.x / kRedCols;
  const int i = blockIdx.x * kRedCols + col;
  float s = 0.0f;
  if (i < count)
    for (int r = lane; r < rows; r += kRedLanes) s = __fadd_rn(s, part[(size_t)r * count + i]);
  lanes[lane][col] = s;
  __syncthreads();
  if (lane == 0 && i < count) {
    float t = lanes[0][col];
    for (int l = 1; l < kRedLanes; ++l) t = __fadd_rn(t, lanes[l][col]);
    db[i] = t;
  }
}

// rows a block owns: kRows, times as many as keep the grid within kMaxBlocks
long long block_rows(long long M) {
  const long long chunks = (M + kRows - 1) / kRows;
  return kRows * ((chunks + kMaxBlocks - 1) / kMaxBlocks);
}

template <typename T, int P>
int launch(const void* x, const float* alpha, const void* dz, void* xc, void* dzc, float* part,
           float* db, int M, int FT, int Cin, int Cout, cudaStream_t stream) {
  const int R = (int)block_rows(M);
  const int blocks = (M + R - 1) / R;
  const T* xt = static_cast<const T*>(x);
  const T* dzt = static_cast<const T*>(dz);
  T* xct = static_cast<T*>(xc);
  T* dzct = static_cast<T*>(dzc);
  if (alpha != nullptr)
    qconv_dw_prep_kernel<T, P, true><<<blocks, kThreads, 0, stream>>>(
        xt, alpha, dzt, xct, dzct, part, M, FT, Cin, Cout, R);
  else
    qconv_dw_prep_kernel<T, P, false><<<blocks, kThreads, 0, stream>>>(
        xt, alpha, dzt, xct, dzct, part, M, FT, Cin, Cout, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int count = 4 * Cout;
  db_reduce_kernel<<<(count + kRedCols - 1) / kRedCols, kRedCols * kRedLanes, 0, stream>>>(
      part, db, blocks, count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the db partials buffer the caller allocates ([blocks, 4*Cout] f32):
// one a block, at most kMaxBlocks; 0 for no rows.
int qasr_qconv_dw_prep_blocks(int B, int F, int T_len) {
  const long long M = (long long)B * F * T_len;
  if (M <= 0) return 0;
  const long long R = block_rows(M);
  return (int)((M + R - 1) / R);
}

// x [B,4,F,T,Cin] and dz [B,4,F,T,Cout] in the compute dtype (0 = float32,
// 1 = bfloat16), Cin and Cout multiples of 8; alpha [4*Cin] f32, or NULL for
// no PReLU; out xc [P,B,F,T,Cin] and dzc [P,B,F,T,Cout] in the compute
// dtype, db [4*Cout] f32; part [blocks, 4*Cout] f32 scratch
// (qasr_qconv_dw_prep_blocks). v [P*4] and o [4*P] are host pointers and
// must be the compiled scheme of P = 8 or 10. Returns a cudaError_t (0 on
// success).
int qasr_qconv_dw_prep(const void* x, const void* alpha, const void* dz, void* xc, void* dzc,
                       void* part, void* db, int B, int F, int T_len, int Cin, int Cout, int P,
                       int dtype, const float* v, const float* o, void* stream) {
  if (P == 8 ? check_tables<8>(v, o) != 0
             : (P != 10 || check_tables<10>(v, o) != 0))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * F * T_len;
  if (B < 1 || F < 1 || T_len < 1 || Cin < 8 || Cout < 8 || Cin % 8 || Cout % 8 ||
      M > 0x7fffffffLL / 2 || part == nullptr || db == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(alpha);
  float* pt = static_cast<float*>(part);
  float* out = static_cast<float*>(db);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int FT = F * T_len;
  if (dtype == 0)
    return P == 8 ? launch<float, 8>(x, a, dz, xc, dzc, pt, out, (int)M, FT, Cin, Cout, st)
                  : launch<float, 10>(x, a, dz, xc, dzc, pt, out, (int)M, FT, Cin, Cout, st);
  if (dtype == 1)
    return P == 8
               ? launch<__nv_bfloat16, 8>(x, a, dz, xc, dzc, pt, out, (int)M, FT, Cin, Cout, st)
               : launch<__nv_bfloat16, 10>(x, a, dz, xc, dzc, pt, out, (int)M, FT, Cin, Cout, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
