// Shared machinery of the quaternion conv and GEMM kernels (qconv.cuh,
// qgemm.cuh; the QLSTM kernels use its tiles and the rank-8 scheme):
// cp.async staging, the per-product accumulation on the staged tiles, and
// the recombination into the four output components.
//
// A scheme of P products (qasr/ops/quaternion.py: the rank-8 U8/V8/O8, P = 8,
// or the 10-product W_COMBO/X_COMBO/OUT_COMBO, P = 10):
//   prod_p = (sum_a U[p,a] w_a) . (sum_a V[p,a] x_a),   p = 0..P-1
//   y_b    = sum_p O[b,p] prod_p
// Each row of V has one or two nonzero terms. The weight side (U) is
// combined by the caller into wc[p]. Each block owns
// one BM x BN output tile of all four components. It walks the contraction
// in chunks; for each chunk the four input components stay resident in
// shared memory while the P products run over it one after the other.
// The optional PReLU prologue is applied to the resident chunk once, in
// place. A step is one (chunk, product): its weights arrive by cp.async one
// step ahead, its combos (at most two nonzero V terms: one FMA per element)
// are formed from the resident chunk into the A tile, the product is
// accumulated in f32 over the chunk and folded at once into the four f32
// output accumulators with column p of O — in registers, so only five
// accumulator tiles are ever live.
//
// Two ways to multiply the staged tiles:
//   bf16: mma.sync m16n8k16 on the tensor cores (fragments by ldmatrix),
//         f32 accumulate;
//   f32:  plain FMA in the CUDA cores, so f32 results stay at f32 accuracy.
// Each states where its accumulator elements lie (row(j), col(j)), so the
// recombination and the epilogue are shared.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtile {

constexpr int kProds = 8;  // the rank-8 scheme's products
constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output channels per block
constexpr int kThreads = 256;   // 8 warps
constexpr int kPerThread = BM * BN / kThreads;  // 16 output elements a thread
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

// A scheme of P products, sparse on the input side. Built on the host from
// the dense tables the Python wrapper passes, so the numbers live in one
// place. A one-term combo keeps its term twice, the second with coefficient
// 0 (c * x + 0 * x is c * x for every finite x).
template <int P>
struct Scheme {
  int in_a[P][2];
  float in_c[P][2];
  float out[4][P];
};
using Scheme8 = Scheme<kProds>;

// v: [P][4] row-major; o: [4][P] row-major. Returns 0, or -1 when a row of v
// has no nonzero term or more than two.
template <int P>
inline int make_scheme(const float* v, const float* o, Scheme<P>* s) {
  for (int p = 0; p < P; ++p) {
    int n = 0;
    for (int a = 0; a < 4; ++a) {
      if (v[p * 4 + a] != 0.0f) {
        if (n == 2) return -1;
        s->in_a[p][n] = a;
        s->in_c[p][n] = v[p * 4 + a];
        ++n;
      }
    }
    if (n == 0) return -1;
    if (n == 1) {
      s->in_a[p][1] = s->in_a[p][0];
      s->in_c[p][1] = 0.0f;
    }
  }
  for (int b = 0; b < 4; ++b)
    for (int p = 0; p < P; ++p) s->out[b][p] = o[b * P + p];
  return 0;
}

__host__ __device__ constexpr int align128(int v) { return (v + 127) / 128 * 128; }

// ---------------------------------------------------------------------------
// element types
// ---------------------------------------------------------------------------

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements in one 16-byte access
  static constexpr bool kTensorCore = false;
  static constexpr int lda(int kc) { return kc + 4; }  // rows 16-byte aligned
  static constexpr int kLdb = BN + 4;
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
};

// ldmatrix reads 8 rows of 16 bytes per phase: rows an odd number of 16-byte
// units long (KC + 8 for KC a multiple of 16; 72 for B) land in 8 distinct
// bank groups, so fragment loads are conflict-free.
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr bool kTensorCore = true;
  static constexpr int lda(int kc) { return kc + 8; }
  static constexpr int kLdb = BN + 8;
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
};

// 16-byte vector <-> floats
template <typename T>
__device__ inline void load_vec(const T* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Elem<T>::kVec; ++i) out[i] = Elem<T>::to_f(e[i]);
}

template <typename T>
__device__ inline void store_vec(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Elem<T>::kVec; ++i) e[i] = Elem<T>::from_f(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// ---------------------------------------------------------------------------
// cp.async: 16 bytes global -> shared, zero-filled when !pred (then the
// source is not read)
// ---------------------------------------------------------------------------

__device__ inline void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// shared-memory layout of one block (same arithmetic on host and device)
// ---------------------------------------------------------------------------

// In order: the scheme; the A tile (combos) [a_rows][lda]; two chunk buffers
// of the input, each [4][a_rows][KC]; two weight stages, each
// [taps][KC][ldb]. Every region starts 128-byte aligned.
template <typename T, int KC, int P = kProds>
struct Layout {
  static constexpr int lda = Elem<T>::lda(KC);
  static constexpr int ldb = Elem<T>::kLdb;
  int a, x, x_bytes, w, w_bytes, total;

  __host__ __device__ Layout(int a_rows, int taps) {
    int off = align128((int)sizeof(Scheme<P>));
    a = off;
    off += align128(a_rows * lda * (int)sizeof(T));
    x = off;
    x_bytes = align128(4 * a_rows * KC * (int)sizeof(T));
    off += 2 * x_bytes;
    w = off;
    w_bytes = align128(taps * KC * ldb * (int)sizeof(T));
    total = off + 2 * w_bytes;
  }
};

// ---------------------------------------------------------------------------
// one product over one chunk: accumulate, then fold into y
// ---------------------------------------------------------------------------

template <typename T, int KC, bool TC = Elem<T>::kTensorCore>
struct Product;

// f32 on the CUDA cores. Thread owns rows tid/64 + 4j, column tid%64: within
// a warp the A read is a broadcast and the B read is contiguous.
template <typename T, int KC>
struct Product<T, KC, false> {
  static constexpr int LDA = Layout<T, KC>::lda, LDB = Layout<T, KC>::ldb;
  float acc[kPerThread];

  __device__ float at(int j) const { return acc[j]; }
  __device__ static int row(int j) { return threadIdx.x / BN + j * (kThreads / BN); }
  __device__ static int col(int) { return threadIdx.x % BN; }

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0f;
  }

  // A_s: BM rows of combos (row stride LDA); B_s: KC x BN weights (LDB)
  __device__ void mma(const T* A_s, const T* B_s) {
    const int c = col(0), r0 = row(0);
    constexpr int dr = kThreads / BN;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float bv = Elem<T>::to_f(B_s[k * LDB + c]);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        acc[j] += Elem<T>::to_f(A_s[(r0 + j * dr) * LDA + k]) * bv;
    }
  }
};

__device__ inline void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ inline void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ inline void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                      unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 on the tensor cores. Warp w computes rows (w/4)*32 .. +32 and columns
// (w%4)*16 .. +16: two m16 tiles by two n8 tiles. Element j = (mi*2+ni)*4+q
// is the m16n8 accumulator's element q (rows g, g+8; columns 2t, 2t+1 with
// g = lane/4, t = lane%4).
template <typename T, int KC>
struct Product<T, KC, true> {
  static constexpr int LDA = Layout<T, KC>::lda, LDB = Layout<T, KC>::ldb;
  static_assert(KC % 16 == 0, "the tensor-core path steps K by 16");
  float acc[4][4];  // [mi*2 + ni][q]

  __device__ float at(int j) const { return acc[j / 4][j % 4]; }
  __device__ static int row(int j) {
    const int lane = threadIdx.x % 32, wm = threadIdx.x / 128;
    return wm * 32 + (j / 8) * 16 + lane / 4 + ((j % 4) / 2) * 8;
  }
  __device__ static int col(int j) {
    const int lane = threadIdx.x % 32, wn = (threadIdx.x / 32) % 4;
    return wn * 16 + ((j / 4) % 2) * 8 + (lane % 4) * 2 + j % 2;
  }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  }

  __device__ void mma(const T* A_s, const T* B_s) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4;
    // ldmatrix row addresses: lanes 0-15 rows 0-15 at k (or n) offset 0,
    // lanes 16-31 the same rows at offset 8
    const int lr = lane % 16, lc = (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      unsigned b[4];  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
      ldmatrix_x4_trans(b, B_s + (kk * 16 + lr) * LDB + wn * 16 + lc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        unsigned a[4];
        ldmatrix_x4(a, A_s + (wm * 32 + mi * 16 + lr) * LDA + kk * 16 + lc);
        mma_bf16_16816(acc[mi * 2 + 0], a, b[0], b[1]);
        mma_bf16_16816(acc[mi * 2 + 1], a, b[2], b[3]);
      }
    }
  }
};

// The product xc^T . dyc over one chunk of KC rows m (kernel J): A =
// xc^T, read from xc [KC][kLdb] (rows m) transposed; B = dyc [KC][kLdb] as
// Product's B. The accumulator layout is Product's, so row(j) indexes the
// output's rows (K) and col(j) its columns (N).
template <typename T, int KC, bool TC = Elem<T>::kTensorCore>
struct ProductAT;

// f32 on the CUDA cores: within a warp the A read is a broadcast and the B
// read is contiguous.
template <typename T, int KC>
struct ProductAT<T, KC, false> : Product<T, KC, false> {
  __device__ void mma_t(const T* xc, const T* dc) {
    constexpr int LD = Elem<T>::kLdb, dr = kThreads / BN;
    const int c = this->col(0), r0 = this->row(0);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float bv = Elem<T>::to_f(dc[k * LD + c]);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        this->acc[j] += Elem<T>::to_f(xc[k * LD + r0 + j * dr]) * bv;
    }
  }
};

// bf16 on the tensor cores, the warp tiling of Product<T, KC, true>. The A
// fragment (16 rows of K x 16 of M) comes from xc's rows m by
// ldmatrix.trans: lane l addresses row (l/16)*8 + l%8 of the 16 m rows, at
// K offset ((l/8)%2)*8, so the four 8x8 matrices arrive as (K 0-7, M 0-7),
// (K 8-15, M 0-7), (K 0-7, M 8-15), (K 8-15, M 8-15): the A registers' order.
template <typename T, int KC>
struct ProductAT<T, KC, true> : Product<T, KC, true> {
  __device__ void mma_t(const T* xc, const T* dc) {
    constexpr int LD = Elem<T>::kLdb;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4;
    const int lr = lane % 16, lc = (lane / 16) * 8;  // B, as Product loads it
    const int am = (lane / 16) * 8 + lane % 8, ak = ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      unsigned b[4];
      ldmatrix_x4_trans(b, dc + (kk * 16 + lr) * LD + wn * 16 + lc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        unsigned a[4];
        ldmatrix_x4_trans(a, xc + (kk * 16 + am) * LD + wm * 32 + mi * 16 + ak);
        mma_bf16_16816(this->acc[mi * 2 + 0], a, b[0], b[1]);
        mma_bf16_16816(this->acc[mi * 2 + 1], a, b[2], b[3]);
      }
    }
  }
};

// y[b] += O[b, p] * acc, in registers
template <typename Prod, int P>
__device__ inline void fold(float (&y)[4][kPerThread], const Prod& prod, const Scheme<P>& sch,
                            int p) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float o = sch.out[b][p];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) y[b][j] += o * prod.at(j);
  }
}

// The previous layer's split PReLU, applied once per chunk in place on the
// resident input: x[a][r][k] = x >= 0 ? x : alpha[a*ld_alpha + c0 + k] * x.
// Out-of-range positions were zero-filled by cp.async and stay zero
// (PReLU(0) = 0). A thread's column is fixed, so its slopes are read once,
// as 16-byte vectors.
template <typename T, int KC>
__device__ inline void prelu_chunk(T* xs, int a_rows, const float* __restrict__ alpha,
                                   int ld_alpha, int c0) {
  constexpr int V = Elem<T>::kVec, VPR = KC / V;
  static_assert(kThreads % VPR == 0, "a thread keeps one column");
  const int v = threadIdx.x % VPR, c = c0 + v * V;
  if (c >= ld_alpha) return;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float al[V];
#pragma unroll
    for (int q = 0; q < V; q += 4)
      *reinterpret_cast<float4*>(al + q) =
          *reinterpret_cast<const float4*>(alpha + a * ld_alpha + c + q);
    T* xa = xs + a * a_rows * KC + v * V;
    for (int r = threadIdx.x / VPR; r < a_rows; r += kThreads / VPR) {
      float u[V];
      load_vec(xa + r * KC, u);
#pragma unroll
      for (int e = 0; e < V; ++e) u[e] = u[e] < 0.0f ? u[e] * al[e] : u[e];
      store_vec(xa + r * KC, u);
    }
  }
}

// Combos of product p from the resident chunk into the A tile:
// A[r][k] = c1 * x[a1][r][k] + c2 * x[a2][r][k].
template <typename T, int KC, int P>
__device__ inline void form_combos(T* A, const T* xs, int a_rows, const Scheme<P>& sch,
                                   int p) {
  constexpr int V = Elem<T>::kVec, VPR = KC / V;
  constexpr int LDA = Layout<T, KC>::lda;
  const float c1 = sch.in_c[p][0], c2 = sch.in_c[p][1];
  const int v = threadIdx.x % VPR;
  const T* x1 = xs + sch.in_a[p][0] * a_rows * KC + v * V;
  const T* x2 = xs + sch.in_a[p][1] * a_rows * KC + v * V;
  for (int r = threadIdx.x / VPR; r < a_rows; r += kThreads / VPR) {
    float u[V], w[V], cmb[V];
    load_vec(x1 + r * KC, u);
    load_vec(x2 + r * KC, w);
#pragma unroll
    for (int e = 0; e < V; ++e) cmb[e] = c1 * u[e] + c2 * w[e];
    store_vec(A + r * LDA + v * V, cmb);
  }
}

// ---------------------------------------------------------------------------
// the second pass of a split-M kernel (I, J): out[i] = cast(sum_s part[s][i]),
// s ascending, so every run gives the same bits
// ---------------------------------------------------------------------------

constexpr int kReduceThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
reduce_splits_kernel(const float* __restrict__ part, T* __restrict__ out, int splits,
                     size_t count) {
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= count) return;
  float acc = part[i];
  for (int s = 1; s < splits; ++s) acc += part[(size_t)s * count + i];
  out[i] = Elem<T>::from_f(acc);
}

// part [splits][count] f32 -> out [count]; returns a cudaError_t
template <typename T>
inline int reduce_splits(const float* part, T* out, int splits, size_t count,
                         cudaStream_t stream) {
  const size_t blocks = (count + kReduceThreads - 1) / kReduceThreads;
  reduce_splits_kernel<T><<<(unsigned)blocks, kReduceThreads, 0, stream>>>(part, out, splits,
                                                                           count);
  return (int)cudaGetLastError();
}

}  // namespace qtile
