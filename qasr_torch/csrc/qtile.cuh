// Shared machinery of the quaternion conv and GEMM kernels (qconv.cuh,
// qgemm.cuh; the QLSTM kernels use its tiles, the rank-8 scheme, its
// mbarriers and the direction barrier):
// cp.async staging, the per-product accumulation on the staged tiles, and
// the recombination into the four output components; and, at the end, the
// Hopper pieces of the bf16 wgmma loops (mbarriers, TMA boxes and their
// tensor maps, ldmatrix, wgmma with A from registers, each scheme's
// compiled-in input terms, the fold's store).
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

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is fetched at run time)
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

// ---------------------------------------------------------------------------
// Hopper (bf16 main loops of qgemm.cuh and qconv.cuh; the QLSTM kernels'
// barriers): shared-memory barriers, a barrier across blocks, TMA, ldmatrix,
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's generic-proxy writes to shared memory ordered before later
// async-proxy (TMA) writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// this thread's arrival, and bytes more for the phase to wait for
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; a wait that never ends
// (a fault in the ring's protocol) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}

// A barrier of the blocks of one group sharing `counter` (the QLSTM kernels
// D and E: the blocks of one direction): the n-th call returns once every
// block of the group has made its n-th call (target = n x the group's
// blocks; the counter starts at 0). Every write before it is visible to
// every block after it. A wait that never ends (a fault) traps instead of
// hanging the card.
__device__ inline void dir_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    // the block's writes (ordered before by the block barrier) released,
    // then the arrival without waiting for its answer
    asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.u32 [%0], %1;\n" ::"l"(counter),
                 "r"(1u)
                 : "memory");
    for (long long spin = 0;; ++spin) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
      if (v >= target) break;
      if (spin > (1ll << 25)) __trap();
    }
  }
  __syncthreads();
}

// a box of the tensor map (coordinates innermost first) into this block's
// shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// c1 * u + c2 * v on bf16 pairs, in the storage dtype, as the JAX package
// forms a rank-8 combo (qasr/ops/pallas/qconv_ft.py, qgemm8.py: _scaled):
// each scaled term rounded once, their sum rounded once. The explicit .rn
// keeps ptxas from contracting a multiply and the add into one fma, which
// would round once where the rule rounds twice.
__device__ __forceinline__ unsigned combo2(unsigned u, unsigned v, __nv_bfloat162 c1,
                                           __nv_bfloat162 c2) {
  unsigned t1, t2, s;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(t1) : "r"(u), "r"(*reinterpret_cast<unsigned*>(&c1)));
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(t2) : "r"(v), "r"(*reinterpret_cast<unsigned*>(&c2)));
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(s) : "r"(t1), "r"(t2));
  return s;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// byte offset of the 16-byte unit (row r, unit c) of a tile of 64-byte rows
// (32 bf16) as TMA writes it in the 64-byte swizzle; r counts rows from a
// 512-byte aligned start
__device__ __forceinline__ unsigned x_off(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// Each product's input components, compiled in (a one-term product repeats
// its term, as make_scheme does): V8's nonzeros and X_COMBO's; the host
// checks the scheme it is passed against them
template <int P>
__host__ __device__ constexpr int term(int p, int i);
template <>
__host__ __device__ constexpr int term<8>(int p, int i) {
  constexpr int t[8][2] = {{1, 3}, {0, 1}, {0, 2}, {2, 3}, {0, 2}, {0, 1}, {1, 3}, {2, 3}};
  return t[p][i];
}
template <>
__host__ __device__ constexpr int term<10>(int p, int i) {
  constexpr int t[10][2] = {{0, 0}, {1, 1}, {2, 2}, {3, 3}, {0, 1},
                            {2, 3}, {0, 2}, {1, 3}, {0, 3}, {1, 2}};
  return t[p][i];
}

// Whether a scheme's input coefficients are all 1 (X_COMBO's, P = 10): its
// combos are sums; the rank-8 scheme's (V8) are not, and take combo2
template <int P>
constexpr bool kUnitCombos = P == 10;

// u + v on bf16 pairs, rounded once: combo2's bits with unit coefficients,
// without its two multiplies. The f32 sum of two bf16 values that the plain
// version rounds is exact unless their exponents differ by more than 16,
// and then both roundings give the larger, so the bits are the same.
__device__ __forceinline__ unsigned add_bf2(unsigned u, unsigned v) {
  const __nv_bfloat162 s = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&u),
                                   *reinterpret_cast<const __nv_bfloat162*>(&v));
  return *reinterpret_cast<const unsigned*>(&s);
}

// Register q of product p's input combo, from the four components'
// ldmatrix fragments f: the one term or a sum where the coefficients are 1,
// else combo2 with the product's bf16 coefficients c1, c2 (p a compile-time
// constant after unrolling, so the terms are compiled in)
template <int P>
__device__ __forceinline__ unsigned wg_combo(const unsigned (&f)[4][4], int p, int q,
                                             __nv_bfloat162 c1, __nv_bfloat162 c2) {
  if constexpr (kUnitCombos<P>)
    return term<P>(p, 0) == term<P>(p, 1) ? f[term<P>(p, 0)][q]
                                          : add_bf2(f[term<P>(p, 0)][q], f[term<P>(p, 1)][q]);
  else
    return combo2(f[term<P>(p, 0)][q], f[term<P>(p, 1)][q], c1, c2);
}

// Whether a scheme is one the bf16 wgmma loops compile in: each product's
// terms (term<P>), with coefficient 1 (0 for a one-term product's repeat)
// where the loop forms sums (kUnitCombos), else two nonzero coefficients
template <int P>
bool wg_scheme_ok(const Scheme<P>& s) {
  for (int p = 0; p < P; ++p) {
    if (s.in_a[p][0] != term<P>(p, 0) || s.in_a[p][1] != term<P>(p, 1)) return false;
    const bool one = term<P>(p, 0) == term<P>(p, 1);
    if (kUnitCombos<P> ? (s.in_c[p][0] != 1.0f || s.in_c[p][1] != (one ? 0.0f : 1.0f))
                       : (s.in_c[p][0] == 0.0f || s.in_c[p][1] == 0.0f))
      return false;
  }
  return true;
}

// The shared-memory descriptor of a product's weights for one 16-deep step:
// N contiguous (MN-major), rows of 128 bytes in the 128-byte swizzle, K
// advancing by groups of 8 rows (the stride byte offset, 16-byte units); a
// single 64-wide atom along N (the leading byte offset unused)
constexpr unsigned kDescLbo = 1;
constexpr unsigned kDescSbo = 64;
__device__ __forceinline__ unsigned long long w_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | ((unsigned long long)kDescLbo << 16) |
         ((unsigned long long)kDescSbo << 32) | (1ull << 62);
}

// d (this warpgroup's 64 x 64 f32) += a (this warp's 16 rows x 16 of K, bf16
// registers in mma.sync's A layout) . B (16 x 64 bf16 at desc, transposed)
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], const unsigned (&a)[4],
                                               unsigned long long desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The fold's product tiles: f32 [P][BM][kFoldLd], padded rows
constexpr int kFoldLd = BN + 8;

// Warpgroup G's H products of a 64 x 64 tile on wgmma (acc[j] is product
// G*H + j; warp wr of the group holds rows wr*16 .. +16: row wr*16 + lane/4
// (+8 for i%4 >= 2), column (i/4)*8 + 2*(lane%4) + i%2 of element i) into
// the fold's tiles fs
template <int H, int G>
__device__ __forceinline__ void wg_store(const float (&acc)[H][32], float* fs, int wr, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < H; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = wr * 16 + g + ((i % 4) / 2) * 8, col = (i / 4) * 8 + 2 * t;
      *reinterpret_cast<float2*>(fs + ((G * H + j) * BM + row) * kFoldLd + col) =
          make_float2(acc[j][i], acc[j][i + 1]);
    }
}

// A warpgroup's H = P/2 products over a block's 64 x 64 tile, each in f32
// registers for the whole contraction (acc[j] is product G*H + j, as
// wg_store lays it out), and their input coefficients in bf16 (wg_combo's
// c1, c2): the state of the bf16 loops' products (qgemm.cuh's WgProducts,
// qconv.cuh's WgConv)
template <int P>
struct WgAcc {
  static_assert(P % 2 == 0, "two warpgroups share the products");
  static constexpr int H = P / 2;
  float acc[H][32];
  __nv_bfloat162 c1[H], c2[H];

  template <int G>
  __device__ void init(const Scheme<P>& s) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      c1[j] = __float2bfloat162_rn(s.in_c[G * H + j][0]);
      c2[j] = __float2bfloat162_rn(s.in_c[G * H + j][1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
    }
  }
};

// host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched once (null when missing)
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A tensor map of a contiguous bf16 array of `rank` (<= 5) dims, innermost
// first, read in boxes of `box`, zero fill out of bounds. Returns 0 or -1.
inline int encode_bf16(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                       const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr || rank < 1 || rank > 5) return -1;
  cuuint64_t strides[4];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : -1;
}

}  // namespace qtile
