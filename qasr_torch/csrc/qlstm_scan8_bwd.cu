// Kernel E: the backward of the bidirectional rank-8 QLSTM recurrence, a
// reverse-time scan in one launch.
//
// Replaces the TPU kernel qasr/ops/pallas/qlstm_scan.py:_bwd_kernel. For each
// direction d and row b, t runs from T-1 down to 0 on the scan-order stream
// (direction 1 time-flipped, as in the forward), dh = dc = 0 at the start,
// carried in f32 (as _bwd_xla carries them; the forward carries h and c in
// the storage type). Per step, from the forward's gates (gate-major i, f, o,
// g), c_prev = cs[t-1] (zero at t = 0), the upstream dhs[t] and the mask m:
//
//   th     = tanh(f c_prev + i g)
//   dh_tot = dhs[t] + dh,  dh_c = m dh_tot,  dc_c = m dc + dh_c o (1 - th^2)
//   dz     = [dc_c g i(1-i) | dc_c c_prev f(1-f) | dh_c th o(1-o) | dc_c i (1-g^2)]
//   dprods_p = sum_q O8[q,p] dz[g,q]    from the f32 dz, rounded once
//   dhc_p  = dprods_p @ wc8[d,p]^T       f32 accumulation, [B, H]
//   dh     = (1-m) dh_tot + sum_p V8[p,a] dhc_p,   dc = (1-m) dc + dc_c f
//
// dz is written gate-major in the storage type. Each elementwise expression
// is evaluated in _bwd_xla's order without contraction (__fmul_rn,
// __fadd_rn), so it rounds where the plain version rounds.
//
// What bounds it on an H100, and the design. At B32 T512 H256 (both
// directions, one layer, bf16) the bytes bound it: gates, cs and dhs in, dz
// out, wc8 once: ~680 MB, 0.20 ms at 3.35 TB/s, against 137 GFLOP (0.14 ms
// at the bf16 peak). The TPU kernel kept all of wc8^T (8.4 MB in bf16) in one
// core's VMEM across a sequential grid; no SM holds that. The kernel is
// persistent and cooperative: block (d, k) owns kJ hidden indices j of
// direction d (the cells (b, q, j), whose dh and dc it carries) and, with
// them, the 4 kJ columns N_k = {g H + j} of dprods that its cells' dz gives.
// The product is partitioned by those columns (a reduce-scatter): the block
// holds wc8[d, p, :, N_k] resident in shared memory and multiplies only its
// own columns, dprods_p[:, N_k] [B, 4 kJ] by wc8[d, p, :, N_k]^T [4 kJ, H],
// so no block reads another's dprods. A step:
//   1. dh_rec of the last step for the block's cells: the sum over the
//      direction's blocks, in block order, of their f32 partials (L2-only
//      16-byte loads, 16 in flight a thread); dh = (1-m) dh_tot + dh_rec;
//   2. the elementwise part from the inputs loaded a step ahead (8-byte
//      vectors), dz to device memory (the first tile's after the step's
//      barrier, which then does not wait for those stores), and the block's
//      columns of dprods: the four q of a (b, j) lie in one warp, so the sum
//      over q is formed by shuffles and rounded once into shared memory;
//   3. (t > 0) the inputs of the next step into registers; the products on
//      the block's columns, folded with V8 in f32 in p order, give this
//      block's partial of dh_rec [B, 4, H], stored (L2) into a ping-pong
//      scratch by the parity of t;
//   4. (t > 0) a barrier of the direction's blocks (a release counter a
//      direction; the two directions never exchange data).
// Each SM takes in B 4 H f32 a step (128 KB at B32 H256; the gather of
// dprods it replaces took in 8 B 4 H bf16, 512 KB), and writes as much.
// The carry of the first 32 rows stays in registers; rows past them (a
// second tile) keep it in an f32 scratch [2, D, B, 4H] that only the thread
// owning a cell touches. Row tile of 32: cell e of a thread: r = tid / 8, q
// = (tid / 2) % 4, j = j0 + (tid % 2) kC + e, kC = 8 bytes of the type.
//
// bf16: kJ = 8 (64 blocks at H=256), weights [p][j'][32] and dprods
// [p][row][32] in 64-byte rows in the 64-byte swizzle, fragments by
// ldmatrix, mma.sync m16n8k16 (the 32 columns are two k-steps); each warp
// takes 16 output indices j' of one m16 row tile at a time (two n8 tiles).
// f32: kJ = 4 (128 blocks), CUDA-core FMA so f32 stays at f32 accuracy. The
// f32 sum over the blocks' partials replaces _bwd_xla's one sum over 4H: the
// order differs, the rounding points do not. No atomics in any sum: two runs
// give the same bits. The launch is cooperative, so a grid that cannot be
// co-resident is refused rather than deadlocked; a barrier wait that never
// ends traps. Any B and T: rows past B are zero in shared memory and never
// stored.
#include "qtile.cuh"

using namespace qtile;

namespace {

constexpr int kBwdThreads = 256;  // 8 warps
constexpr int kWarps = kBwdThreads / 32;
constexpr int kRows = 32;         // rows of the batch a tile holds
constexpr int kBatch = 16;        // partials a thread has in flight

__device__ inline float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ inline float fsub(float a, float b) { return __fsub_rn(a, b); }

// Whether product p's i-th V8 term (component term<8>(p, i)) is the first
// term of its dh_rec[a], p ascending: the fold assigns it rather than adds
__host__ __device__ constexpr bool first_term(int p, int i) {
  return p == 0 || (p == 1 && i == 0) || (p == 2 && i == 1);
}
constexpr bool first_terms_ok() {
  for (int p = 0; p < kProds; ++p)
    for (int i = 0; i < 2; ++i) {
      bool first = true;
      for (int q = 0; q < p; ++q)
        first = first && term<8>(q, 0) != term<8>(p, i) && term<8>(q, 1) != term<8>(p, i);
      if (first != first_term(p, i)) return false;
    }
  return true;
}
static_assert(first_terms_ok(), "first_term follows term<8>");

// rec[a] = V8[p, a] v (its first term) or rec[a] + V8[p, a] v, for both of
// product p's components (p a compile-time constant after unrolling)
template <int N>
__device__ inline void fold_v8(float (&rec)[4][N], const float (&v)[N], int p,
                               const Scheme8& sch) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int a = term<8>(p, i);
    const float c = sch.in_c[p][i];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float x = fmul(v[e], c);
      rec[a][e] = first_term(p, i) ? x : fadd(rec[a][e], x);
    }
  }
}

// 8 bytes of T <-> floats
template <typename T>
struct Vec8 {
  static constexpr int N = 8 / (int)sizeof(T);
  __device__ static void unpack(uint2 raw, float (&out)[N]) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = Elem<T>::to_f(e[i]);
  }
  __device__ static void store(T* p, const float (&in)[N]) {
    uint2 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = Elem<T>::from_f(in[i]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// N f32 from L2 (other blocks wrote them since this SM last looked)
template <int N>
__device__ inline void ldcg_f(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    static_assert(N == 2, "4 or 2 floats");
    const float2 x = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = x.x, v[1] = x.y;
  }
}

template <int N>
__device__ inline void ld_f(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = p[i];
}

template <int N>
__device__ inline void st_f(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = v[i];
}

// A block's partial of dh_rec, f32 [4][H / 8][B][8]: element (b, a, j) at
// part_at(a, j - j % 8, b) + j % 8. A warp's accumulator tile (8 rows x 8
// j) is 256 contiguous bytes, and a reader's 8 j of 4 rows 128.
__device__ inline size_t part_at(int a, int j8, int b, int B, int H) {
  return (((size_t)a * (H / 8) + j8 / 8) * B + b) * 8;
}

template <typename T>
struct BwdOps;

// bf16: weights [p][j'][32] (column c = g kJ + jj: wc8[d, p, j', g H + j0 +
// jj]) and dprods [p][row][32], each row 64 bytes, 16-byte unit u of row r
// at u ^ ((r / 2) % 4) (qtile's x_off): ldmatrix's 8 rows a phase fall in 8
// distinct bank groups.
template <>
struct BwdOps<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kJ = 8;
  __host__ __device__ static int w_bytes(int H) { return kProds * H * 64; }
  static constexpr int kABytes = kProds * kRows * 64;

  __device__ static void load_weights(T* w_s, const T* wc8, int d, int j0, int H) {
    const size_t h4 = 4 * (size_t)H;
    for (int i = threadIdx.x; i < kProds * H * 4; i += kBwdThreads) {
      const int g = i % 4, j = (i / 4) % H, p = i / (4 * H);
      const uint4 v = *reinterpret_cast<const uint4*>(
          wc8 + ((size_t)d * kProds + p) * H * h4 + (size_t)j * h4 + (size_t)g * H + j0);
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(w_s) + (size_t)p * H * 64 + x_off(j, g)) =
          v;
    }
  }

  // dprods_p[row][c .. c+4) (c = g kJ + jh 4), rounded once
  __device__ static void put_dprods(T* a_s, int p, int r, int c, const float (&v)[4]) {
    uint2 raw;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
    e[0] = __floats2bfloat162_rn(v[0], v[1]);
    e[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(reinterpret_cast<char*>(a_s) + p * kRows * 64 + x_off(r, c / 8) +
                              (c % 8) * 2) = raw;
  }

  // The units of the partial: 16 j' (two n8 tiles) of one m16 row tile,
  // unit u at j' = (u / 2) 16, rows (u % 2) 16 of the tile. A unit's rec:
  // element (ni, e) = 4 ni + e at row (u % 2) 16 + g8 + (e / 2) 8, j' = jb
  // + ni 8 + t2 + e % 2 (mma's accumulator)
  static constexpr int kRecN = 8;
  __host__ __device__ static int units(int H) { return H / 8; }

  // rec = this block's partial of dh_rec in unit u: the 8 products [16, 16]
  // over the block's 32 columns, folded with V8
  __device__ static void compute(float (&rec)[4][kRecN], const T* w_s, const T* a_s, int u,
                                 int H, const Scheme8& sch) {
    const int lane = threadIdx.x % 32, jb = (u / 2) * 16, mi = u % 2;
    const unsigned wb = smem_u32(w_s), ab = smem_u32(a_s);
    const int ar = lane % 16, au = lane / 16;                        // A: rows, unit
    const int br = (lane / 16) * 8 + lane % 8, bu = (lane / 8) % 2;  // B: j', unit
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < kRecN; ++e) rec[a][e] = 0.0f;
#pragma unroll
    for (int p = 0; p < kProds; ++p) {
      float acc[2][4];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // (j' 0-7, k 0-7), (j' 0-7, k 8-15), (j' 8-15, k 0-7), (j' 8-15, k 8-15)
        unsigned b[4], a[4];
        ldsm_x4(b, wb + p * H * 64 + x_off(jb + br, kk * 2 + bu));
        ldsm_x4(a, ab + p * kRows * 64 + x_off(mi * 16 + ar, kk * 2 + au));
        mma_bf16_16816(acc[0], a, b[0], b[1]);
        mma_bf16_16816(acc[1], a, b[2], b[3]);
      }
      float v[kRecN];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[ni * 4 + e] = acc[ni][e];
      fold_v8(rec, v, p, sch);
    }
  }

  // rec into this block's partial (unit u)
  __device__ static void store(const float (&rec)[4][kRecN], float* part, int B, int r0, int u,
                               int H) {
    const int lane = threadIdx.x % 32, jb = (u / 2) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = r0 + (u % 2) * 16 + lane / 4 + h * 8;
      if (b >= B) continue;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int e = ni * 4 + h * 2;
          __stcg(reinterpret_cast<float2*>(part + part_at(a, jb + ni * 8, b, B, H) +
                                           (lane % 4) * 2),
                 make_float2(rec[a][e], rec[a][e + 1]));
        }
    }
  }
};

// f32: weights [p][c][H] (c = g kJ + jj; a thread reads 8 j' as two
// broadcast float4), dprods [p][row][17] (odd stride: a warp's 32 rows fall
// in distinct banks). Lane = row; warp w takes 8 j' at a time.
template <>
struct BwdOps<float> {
  using T = float;
  static constexpr int kJ = 4, kLd = 4 * kJ + 1;
  __host__ __device__ static int w_bytes(int H) { return kProds * 4 * kJ * H * 4; }
  static constexpr int kABytes = kProds * kRows * kLd * 4;

  __device__ static void load_weights(T* w_s, const T* wc8, int d, int j0, int H) {
    const size_t h4 = 4 * (size_t)H;
    for (int i = threadIdx.x; i < kProds * H * 4; i += kBwdThreads) {
      const int g = i % 4, j = (i / 4) % H, p = i / (4 * H);
      const float4 v = *reinterpret_cast<const float4*>(
          wc8 + ((size_t)d * kProds + p) * H * h4 + (size_t)j * h4 + (size_t)g * H + j0);
      float* w = w_s + ((size_t)p * 4 * kJ + g * kJ) * H + j;
      w[0] = v.x, w[H] = v.y, w[2 * H] = v.z, w[3 * H] = v.w;
    }
  }

  __device__ static void put_dprods(T* a_s, int p, int r, int c, const float (&v)[2]) {
    a_s[(p * kRows + r) * kLd + c] = v[0];
    a_s[(p * kRows + r) * kLd + c + 1] = v[1];
  }

  // The units of the partial: 8 j' of all 32 rows of a tile, unit u at j'
  // = 8 u; lane = row, rec[a][e] at j' = 8 u + e
  static constexpr int kRecN = 8;
  __host__ __device__ static int units(int H) { return H / 8; }

  __device__ static void compute(float (&rec)[4][kRecN], const T* w_s, const T* a_s, int u,
                                 int H, const Scheme8& sch) {
    const int lane = threadIdx.x % 32, jb = u * 8;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < kRecN; ++e) rec[a][e] = 0.0f;
#pragma unroll
    for (int p = 0; p < kProds; ++p) {
      float acc[kRecN];
#pragma unroll
      for (int e = 0; e < kRecN; ++e) acc[e] = 0.0f;
      const float* x = a_s + (p * kRows + lane) * kLd;
      const float* w = w_s + (size_t)p * 4 * kJ * H + jb;
#pragma unroll 4
      for (int c = 0; c < 4 * kJ; ++c) {
        const float xc = x[c];
        const float4 wa = *reinterpret_cast<const float4*>(w + c * H);
        const float4 wv = *reinterpret_cast<const float4*>(w + c * H + 4);
        acc[0] = fmaf(xc, wa.x, acc[0]);
        acc[1] = fmaf(xc, wa.y, acc[1]);
        acc[2] = fmaf(xc, wa.z, acc[2]);
        acc[3] = fmaf(xc, wa.w, acc[3]);
        acc[4] = fmaf(xc, wv.x, acc[4]);
        acc[5] = fmaf(xc, wv.y, acc[5]);
        acc[6] = fmaf(xc, wv.z, acc[6]);
        acc[7] = fmaf(xc, wv.w, acc[7]);
      }
      fold_v8(rec, acc, p, sch);
    }
  }

  __device__ static void store(const float (&rec)[4][kRecN], float* part, int B, int r0, int u,
                               int H) {
    const int b = r0 + threadIdx.x % 32, jb = u * 8;
    if (b >= B) return;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* dst = part + part_at(a, jb, b, B, H);
#pragma unroll
      for (int e = 0; e < kRecN; e += 4)
        __stcg(reinterpret_cast<float4*>(dst + e),
               make_float4(rec[a][e], rec[a][e + 1], rec[a][e + 2], rec[a][e + 3]));
    }
  }
};

// The inputs of a thread's cells at step t, row b (zeros past B): gates
// (4 vectors), cs[t-1] (zero at t = 0), dhs[t], each 8 bytes
template <typename T>
__device__ inline void load_inputs(uint2 (&in)[6], const T* gates, const T* cs, const T* dhs,
                                   int t, int D, int d, int B, int b, size_t lane, int H) {
  const size_t h4 = 4 * (size_t)H, h16 = 16 * (size_t)H;
#pragma unroll
  for (int i = 0; i < 6; ++i) in[i] = make_uint2(0u, 0u);
  if (b >= B) return;
  const size_t row = ((size_t)t * D + d) * B + b;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    in[g] = *reinterpret_cast<const uint2*>(gates + row * h16 + g * h4 + lane);
  if (t > 0) in[4] = *reinterpret_cast<const uint2*>(cs + (row - (size_t)D * B) * h4 + lane);
  in[5] = *reinterpret_cast<const uint2*>(dhs + row * h4 + lane);
}

// The products of a tile, this block's partial of dh_rec: each warp takes
// the units w, w + 8, ... of the partial, each unit its products folded with
// V8 (compute), then stored
template <typename T>
__device__ inline void products(const T* w_s, const T* a_s, float* part, int B, int r0, int H,
                                const Scheme8& sch) {
  using Ops = BwdOps<T>;
  float rec[4][Ops::kRecN];
#pragma unroll 1
  for (int u = threadIdx.x / 32; u < Ops::units(H); u += kWarps) {
    Ops::compute(rec, w_s, a_s, u, H, sch);
    Ops::store(rec, part, B, r0, u, H);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1)
qlstm_scan8_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ cs,
                       const T* __restrict__ dhs, const T* __restrict__ wc8,
                       const int* __restrict__ lengths, T* __restrict__ dz, float* part,
                       float* dh_g, float* dc_g, unsigned* bar, int Tn, int D, int B, int H,
                       Scheme8 sch) {
  using Ops = BwdOps<T>;
  using V = Vec8<T>;
  constexpr int kJ = Ops::kJ, kC = V::N, nj = kJ / kC;
  static_assert(kRows * 4 * kJ == kBwdThreads * kC, "a thread owns kC cells of a tile");
  static_assert(nj == 2, "the four q of a (row, j) lie in one warp, 2 lanes apart");
  extern __shared__ __align__(128) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);
  T* a_s = reinterpret_cast<T*>(smem + align128(Ops::w_bytes(H)));
  const int per_dir = H / kJ;
  const int d = blockIdx.x / per_dir, kb = blockIdx.x % per_dir, j0 = kb * kJ;
  const size_t h4 = 4 * (size_t)H, h16 = 16 * (size_t)H;
  const size_t slab = (size_t)B * h4;  // one block's partial
  const int lane_id = threadIdx.x % 32;
  // this thread's cells: row r of a tile, component q, j = j0 + jg kC + e
  const int jg = threadIdx.x % nj, q = (threadIdx.x / nj) % 4, r = threadIdx.x / (4 * nj);
  const size_t lane = (size_t)q * H + j0 + jg * kC;
  unsigned n_bar = 0;

  Ops::load_weights(w_s, wc8, d, j0, H);
  // the first tile's carry: (1-m) dh_tot, waiting for dh_rec, and dc
  float keep0[kC], dc0[kC];
#pragma unroll
  for (int e = 0; e < kC; ++e) keep0[e] = dc0[e] = 0.0f;
  uint2 next[6];  // the first tile's inputs of the coming step
  float dz0[4][kC];  // the first tile's dz, stored after the step's barrier
  T* dz0_at = nullptr;
  // dz of a thread's cells: 4 gates, kC each, at p (row's gate 0)
  auto store_dz = [&](T* p, const float (&v)[4][kC]) {
#pragma unroll
    for (int g = 0; g < 4; ++g) V::store(p + g * h4, v[g]);
  };
  load_inputs<T>(next, gates, cs, dhs, Tn - 1, D, d, B, r, lane, H);

  for (int t = Tn - 1; t >= 0; --t) {
    const int frame = d == 0 ? t : Tn - 1 - t;  // the original time index
    const float* rec_src = part + ((size_t)((t + 1) & 1) * D + d) * per_dir * slab;
    float* rec_dst = part + ((size_t)(t & 1) * D + d) * per_dir * slab + kb * slab;
    for (int r0 = 0; r0 < B; r0 += kRows) {
      if (r0 > 0) __syncthreads();  // the last tile's products are done with a_s
      const int b = r0 + r;
      const bool first_tile = r0 == 0;
      uint2 in[6];
      if (first_tile) {
#pragma unroll
        for (int i = 0; i < 6; ++i) in[i] = next[i];
      } else {
        load_inputs<T>(in, gates, cs, dhs, t, D, d, B, b, lane, H);
      }
      // 1. dh = (1-m) dh_tot + dh_rec of the last step; dc
      float dh[kC], dc[kC];
#pragma unroll
      for (int e = 0; e < kC; ++e) dh[e] = dc[e] = 0.0f;
      if (t < Tn - 1 && b < B) {
        const size_t ci = ((size_t)d * B + b) * h4 + lane;
        float keep[kC];
        if (first_tile) {
#pragma unroll
          for (int e = 0; e < kC; ++e) keep[e] = keep0[e], dc[e] = dc0[e];
        } else {
          ld_f(dh_g + ci, keep);
          ld_f(dc_g + ci, dc);
        }
        const float* src = rec_src + part_at(q, j0 + jg * kC, b, B, H) + (j0 + jg * kC) % 8;
        float rec[kC];
#pragma unroll
        for (int e = 0; e < kC; ++e) rec[e] = 0.0f;
        for (int k0 = 0; k0 < per_dir; k0 += kBatch) {
          float v[kBatch][kC];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (k0 + u < per_dir) ldcg_f(src + (size_t)(k0 + u) * slab, v[u]);
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (k0 + u < per_dir) {
#pragma unroll
              for (int e = 0; e < kC; ++e) rec[e] = k0 + u == 0 ? v[u][e] : fadd(rec[e], v[u][e]);
            }
        }
#pragma unroll
        for (int e = 0; e < kC; ++e) dh[e] = fadd(keep[e], rec[e]);
      }
      // 2. the elementwise part
      float ig[kC], fg[kC], og[kC], gg[kC], cp[kC], dhu[kC];
      V::unpack(in[0], ig);
      V::unpack(in[1], fg);
      V::unpack(in[2], og);
      V::unpack(in[3], gg);
      V::unpack(in[4], cp);
      V::unpack(in[5], dhu);
      const float m = (b < B && (lengths == nullptr || frame < lengths[b])) ? 1.0f : 0.0f;
      float dzv[4][kC], keep[kC];
#pragma unroll
      for (int e = 0; e < kC; ++e) {
        const float th = tanhf(fadd(fmul(fg[e], cp[e]), fmul(ig[e], gg[e])));
        const float dh_tot = fadd(dhu[e], dh[e]);
        const float dh_c = fmul(m, dh_tot);
        const float dc_c =
            fadd(fmul(m, dc[e]), fmul(fmul(dh_c, og[e]), fsub(1.0f, fmul(th, th))));
        dzv[0][e] = fmul(fmul(fmul(dc_c, gg[e]), ig[e]), fsub(1.0f, ig[e]));
        dzv[1][e] = fmul(fmul(fmul(dc_c, cp[e]), fg[e]), fsub(1.0f, fg[e]));
        dzv[2][e] = fmul(fmul(fmul(dh_c, th), og[e]), fsub(1.0f, og[e]));
        dzv[3][e] = fmul(fmul(dc_c, ig[e]), fsub(1.0f, fmul(gg[e], gg[e])));
        dc[e] = fadd(fmul(fsub(1.0f, m), dc[e]), fmul(dc_c, fg[e]));
        keep[e] = fmul(fsub(1.0f, m), dh_tot);  // dh_rec of this step comes after the barrier
      }
      if (b < B) {
        const size_t row = ((size_t)t * D + d) * B + b;
        if (first_tile) {  // dz after the barrier, which then need not wait for it
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int e = 0; e < kC; ++e) dz0[g][e] = dzv[g][e];
          dz0_at = dz + row * h16 + lane;
#pragma unroll
          for (int e = 0; e < kC; ++e) keep0[e] = keep[e], dc0[e] = dc[e];
        } else {
          store_dz(dz + row * h16 + lane, dzv);
          const size_t ci = ((size_t)d * B + b) * h4 + lane;
          st_f(dh_g + ci, keep);
          st_f(dc_g + ci, dc);
        }
      }
      if (t == 0) continue;  // no step follows: dh_rec is not needed
      // 3. the first tile's inputs of the next step, then this tile's
      // columns of dprods: dprods_p[g][j] = sum_q O8[q,p] dz[g][q][j], over
      // q in order from the f32 dz (the lanes of q' = 0..3 of this (row,
      // j group) are lane - q nj + q' nj), rounded once; this thread forms p
      // = 2q and 2q + 1
      if (first_tile) load_inputs<T>(next, gates, cs, dhs, t - 1, D, d, B, r, lane, H);
      float zq[4][4][kC];  // [q'][g][e]
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int src = (lane_id & ~(3 * nj)) | (qq * nj);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < kC; ++e) zq[qq][g][e] = __shfl_sync(0xffffffffu, dzv[g][e], src);
      }
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        const int p = 2 * q + pp;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float v[kC];
#pragma unroll
          for (int e = 0; e < kC; ++e) {
            float s = fmul(zq[0][g][e], sch.out[0][p]);
#pragma unroll
            for (int qq = 1; qq < 4; ++qq) s = fadd(s, fmul(zq[qq][g][e], sch.out[qq][p]));
            v[e] = s;
          }
          Ops::put_dprods(reinterpret_cast<T*>(a_s), p, r, g * kJ + jg * kC, v);
        }
      }
      __syncthreads();
      products<T>(w_s, a_s, rec_dst, B, r0, H, sch);
    }
    if (t > 0) dir_barrier(bar + d, ++n_bar * (unsigned)per_dir);
    if (dz0_at != nullptr) store_dz(dz0_at, dz0);
    dz0_at = nullptr;
  }
}

template <typename T>
int launch_bwd(const void* gates, const void* cs, const void* dhs, const void* wc8,
               const void* lengths, void* dz, void* part, void* dh, void* dc, void* bar, int Tn,
               int D, int B, int H, const Scheme8& s, cudaStream_t stream) {
  using Ops = BwdOps<T>;
  if (H % Ops::kJ) return (int)cudaErrorInvalidValue;
  const int smem = align128(Ops::w_bytes(H)) + Ops::kABytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qlstm_scan8_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const T* g = static_cast<const T*>(gates);
  const T* c = static_cast<const T*>(cs);
  const T* dh_up = static_cast<const T*>(dhs);
  const T* w = static_cast<const T*>(wc8);
  const int* lens = static_cast<const int*>(lengths);
  T* out = static_cast<T*>(dz);
  float* pp = static_cast<float*>(part);
  float* dhp = static_cast<float*>(dh);
  float* dcp = static_cast<float*>(dc);
  unsigned* bp = static_cast<unsigned*>(bar);
  Scheme8 sch = s;
  void* args[] = {&g, &c, &dh_up, &w, &lens, &out, &pp, &dhp, &dcp, &bp, &Tn, &D, &B, &H, &sch};
  // cooperative: refused (cudaErrorCooperativeLaunchTooLarge) when the grid
  // cannot be co-resident, which the direction barriers need
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(qlstm_scan8_bwd_kernel<T>),
                                    dim3(D * H / Ops::kJ), dim3(kBwdThreads), args, (size_t)smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both directions, D = 2: gates [T,D,B,16H] gate-major, cs and dhs [T,D,B,4H],
// wc8 [D,8,H,4H], lengths [B] int32 or null; dz [T,D,B,16H] is written.
// Scratch: part [2,D,H/kJ,B,4H] f32 (the blocks' partials of dh_rec,
// ping-pong by the parity of t; kJ = 8 in bf16, 4 in f32), dh and dc
// [D,B,4H] f32 (the carry of rows past the first 32), bar [D] uint32 zeroed
// (the direction barriers' counters). dtype: 0 = float32, 1 = bfloat16. v8
// [8*4] and o8 [4*8] are host pointers; v8 must be the rank-8 scheme's
// (qtile's term<8>). Returns a cudaError_t (0 on success).
int qasr_qlstm_scan8_bwd(const void* gates, const void* cs, const void* dhs, const void* wc8,
                         const void* lengths, void* dz, void* part, void* dh, void* dc, void* bar,
                         int T, int D, int B, int H, int dtype, const float* v8, const float* o8,
                         void* stream) {
  Scheme8 s;
  if (make_scheme(v8, o8, &s) != 0 || !wg_scheme_ok(s)) return (int)cudaErrorInvalidValue;
  if (H < 16 || H % 16 || D != 2 || T < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(gates, cs, dhs, wc8, lengths, dz, part, dh, dc, bar, T, D, B, H, s,
                             st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(gates, cs, dhs, wc8, lengths, dz, part, dh, dc, bar, T, D,
                                     B, H, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
