// Kernel D: the whole bidirectional rank-8 QLSTM recurrence in one launch.
//
// Replaces the TPU kernel qasr/ops/pallas/qlstm_scan.py:_fwd_kernel. For each
// direction d, row b and step t in order (direction 1 walks the time-flipped
// stream):
//
//   hc_p   = sum_a V8[p,a] h_{t-1,a}     f32, rounded to the storage type
//   prod_p = hc_p @ wc8[d,p]             f32 accumulation, p = 0..7
//   z      = xz_t + O8 . prod            f32, gate-major lanes [g, q, H]
//   i,f,o  = sigmoid(z_i, z_f, z_o),  g = tanh(z_g)
//   c'     = f c + i g,  h' = o tanh(c') frozen where the row is inactive
//
// h and c are carried in the storage type, rounded every step, as the TPU
// kernel's scratch and its XLA twin _fwd_xla carry them. Outputs: hs, cs
// [T,D,B,4H] component-major [q,H]; gates [T,D,B,16H] gate-major
// [sigmoid(i,f,o) | tanh(g)], which the backward reads.
//
// What bounds it on an H100, and the design. At B32 T512 H256 (both
// directions, one layer) the bytes bound it: ~679 MB of xz, hs, cs, gates and
// weights, 0.20 ms at 3.35 TB/s, against 137 GFLOP (0.14 ms at the bf16
// peak). The TPU kernel kept all of wc8 (8.4 MB bf16 at H=256) in one core's
// VMEM across a sequential grid; no SM holds that. Here the kernel is
// persistent and cooperative: block (d, j0) owns kJ = 4 hidden indices of one
// direction and keeps in shared memory the 32 weight columns they need
// (wc8[d, p, :, g*H + j] for 8 p x 4 g), 66 KB in bf16 at H=256, so the
// weights leave device memory once per launch; 2 x 256 / 4 = 128 blocks, one
// per SM. Every product needs all of h_{t-1} of the direction, so a step
// gathers it (an all-gather; the reduce-scatter kernel E uses would move
// 16H-wide partials instead of the 4H-wide h).
//
// bf16. The block that writes h_t[:, :, j] holds all four components of its
// j, so it also forms the V8 combos hc_p[:, j] (f32, rounded once, without
// contraction: the lanes of a (row, j)'s four q lie in one warp and trade h
// by shuffles) and writes them into an exchange buffer, ping-pong by the
// parity of t: the combos are formed once per (b, j) rather than in every
// block of the direction, for twice the bytes of h. A step, for a tile of 32
// rows: one thread issues 8 bulk copies (cp.async.bulk, one a product, each
// completing on its own mbarrier) of the tile's combos of h_{t-1} into
// shared memory [p][row][H + 8]; meanwhile every thread takes the xz of its
// cells (loaded a step ahead; c_{t-1} and h_{t-1} of its cells it keeps in
// registers). Warp w runs products 2(w/2) and 2(w/2)+1 over the k-steps of
// parity w % 2 (the K split: mma.sync m16n8k16, fragments of the combos by
// ldmatrix), as soon as their copies land; the two halves of each product
// meet in shared memory (over the consumed combos) and are added in a fixed
// order. The fold with O8, the cell update, the combos of h_t, then a
// barrier of the direction's blocks (a release counter a direction: the
// directions never exchange data); hs, cs and gates (4-byte vectors) are
// stored after it, so that it does not wait for those stores.
//
// f32 keeps CUDA-core FMA (so f32 stays at f32 accuracy) on 16-row tiles:
// each block stages h_{t-1} of its direction from hs[t-1] (the exchange in
// f32) and forms the combos while loading the products' operands (warp p
// runs product p). The T dependent steps each pay the barrier and the L2
// round trips: a latency floor far above the bound. The launch is
// cooperative, so a grid that cannot be co-resident is refused rather than
// deadlocked; a barrier wait that never ends traps. Any B and T: rows past B
// are never stored.
#include "qtile.cuh"

using namespace qtile;

namespace {

constexpr int kJ = 4;              // hidden indices a block owns
constexpr int kCols = 4 * kJ;      // its weight columns per product: 4 gates x kJ
constexpr int kScanThreads = 256;  // 8 warps

template <typename T>
struct ScanCfg;

// bf16: 32 rows a tile (two m16 tiles). The weights are stored transposed
// [p][n][H + 8] and the combos as [p][row][H + 8], so every b fragment is a
// 32-bit load and every ldmatrix phase falls in 8 distinct bank groups
// ((H + 8) / 8 16-byte units is odd). The two halves of the products, f32
// [2][p][row][kCols], reuse the combos' space once the products have read it.
template <>
struct ScanCfg<__nv_bfloat16> {
  static constexpr int BM = 32, kHPad = 8, kSplit = 2;
  __host__ __device__ static int w_elems(int H) { return kProds * kCols * (H + 8); }
  __device__ static int w_at(int p, int k, int n, int H) { return (p * kCols + n) * (H + 8) + k; }
};

// f32: 16 rows a tile; lane = (row, half of the columns). The weights are
// stored [p][k][kCols] (two broadcast 16-byte loads a k), h as [q][row][H+1]
// (odd stride: the 16 rows a warp reads fall in distinct banks).
template <>
struct ScanCfg<float> {
  static constexpr int BM = 16, kHPad = 1, kSplit = 1;
  __host__ __device__ static int w_elems(int H) { return kProds * H * kCols; }
  __device__ static int w_at(int p, int k, int n, int H) { return (p * H + k) * kCols + n; }
};

// In order: the resident weights; the operand rows (bf16: the combos
// [p][row][H + 8], the products' halves in their space, which is made large
// enough for them; f32: h [q][row][H + 1], then the products
// [p][row][kCols]); bf16's eight mbarriers. The launcher refuses a layout
// past kMaxSmem.
template <typename T>
struct ScanLayout {
  int x, prod, bar, total;
  __host__ __device__ explicit ScanLayout(int H) {
    using C = ScanCfg<T>;
    constexpr bool kBf16 = sizeof(T) == 2;
    const int prod_bytes = C::kSplit * kProds * C::BM * kCols * (int)sizeof(float);
    const int x_bytes = (kBf16 ? kProds : 4) * C::BM * (H + C::kHPad) * (int)sizeof(T);
    x = align128(C::w_elems(H) * (int)sizeof(T));
    prod = kBf16 ? x : x + align128(x_bytes);
    bar = prod + align128(kBf16 && x_bytes > prod_bytes ? x_bytes : prod_bytes);
    total = bar + (kBf16 ? kProds * 8 : 0);
  }
};

// 4 bytes of T <-> floats
template <typename T>
struct Vec4 {
  static constexpr int N = 4 / (int)sizeof(T);
  __device__ static void unpack(unsigned raw, float (&out)[N]) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = Elem<T>::to_f(e[i]);
  }
  __device__ static void load(const T* p, float (&out)[N]) {
    unpack(*reinterpret_cast<const unsigned*>(p), out);
  }
  __device__ static void store(T* p, const float (&in)[N]) {
    unsigned raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = Elem<T>::from_f(in[i]);
    *reinterpret_cast<unsigned*>(p) = raw;
  }
};

// f32: rows r0 .. r0+BM of h_{t-1} (hprev = hs[t-1, d]) into h_s [q][row][H +
// 1]; rows past B are zeros. L2-only loads: other blocks wrote hprev since
// this SM last looked. A thread issues kBatch loads before it stores any, so
// their round trips overlap.
__device__ inline void stage_h(float* h_s, const float* hprev, int B, int r0, int H) {
  using C = ScanCfg<float>;
  constexpr int V = 4, kBatch = 8;
  const int ldh = H + C::kHPad, vpr = 4 * H / V, n = C::BM * vpr;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kScanThreads) {
    float4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kScanThreads, b = r0 + i / vpr;
      raw[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n && b < B)
        raw[u] = __ldcg(reinterpret_cast<const float4*>(hprev + (size_t)b * 4 * H + (i % vpr) * V));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kScanThreads;
      if (i >= n) break;
      const int r = i / vpr, c = (i % vpr) * V;
      float* dst = h_s + ((c / H) * C::BM + r) * ldh + c % H;
      dst[0] = raw[u].x, dst[1] = raw[u].y, dst[2] = raw[u].z, dst[3] = raw[u].w;
    }
  }
}

// f32, warp p: prods_p [BM, kCols] = combos_p(h_s) @ w_p, into p_s
// [p][row][kCols]; the combos formed in f32 without contraction
__device__ inline void product_f32(const float* w_s, const float* h_s, float* p_s, int H,
                                   const Scheme8& sch) {
  using C = ScanCfg<float>;
  constexpr int BM = C::BM, NH = kCols / 2;
  const int lane = threadIdx.x % 32, p = threadIdx.x / 32;
  const int r = lane % BM, n0 = (lane / BM) * NH;
  const int ldh = H + C::kHPad;
  const float c1 = sch.in_c[p][0], c2 = sch.in_c[p][1];
  const float* x1 = h_s + (sch.in_a[p][0] * BM + r) * ldh;
  const float* x2 = h_s + (sch.in_a[p][1] * BM + r) * ldh;
  const float* wp = w_s + p * H * kCols + n0;
  float acc[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) acc[i] = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float x = __fadd_rn(__fmul_rn(c1, x1[k]), __fmul_rn(c2, x2[k]));
    const float4 wa = *reinterpret_cast<const float4*>(wp + k * kCols);
    const float4 wb = *reinterpret_cast<const float4*>(wp + k * kCols + 4);
    acc[0] = fmaf(x, wa.x, acc[0]);
    acc[1] = fmaf(x, wa.y, acc[1]);
    acc[2] = fmaf(x, wa.z, acc[2]);
    acc[3] = fmaf(x, wa.w, acc[3]);
    acc[4] = fmaf(x, wb.x, acc[4]);
    acc[5] = fmaf(x, wb.y, acc[5]);
    acc[6] = fmaf(x, wb.z, acc[6]);
    acc[7] = fmaf(x, wb.w, acc[7]);
  }
  float* pp = p_s + (p * BM + r) * kCols + n0;
#pragma unroll
  for (int i = 0; i < NH; ++i) pp[i] = acc[i];
}

// bf16, warp w: products p = pb, pb + 1 (pb = 2 (w / 2)) over the k-steps
// of parity w % 2, on the combos xs [p][row][H + 8], into acc[p - pb][mi][ni][e]
__device__ inline void product_bf16(float (&acc)[2][2][2][4], const __nv_bfloat16* w_s,
                                    const __nv_bfloat16* xs, int H) {
  using C = ScanCfg<__nv_bfloat16>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int pb = (warp / 2) * 2, kh = warp % 2;
  const int g8 = lane / 4, t2 = (lane % 4) * 2;
  const int lr = lane % 16, lc = (lane / 16) * 8;  // ldmatrix row addresses
  const int ldx = H + C::kHPad, ldw = H + 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][mi][ni][e] = 0.0f;
#pragma unroll 2
  for (int k0 = kh * 16; k0 < H; k0 += 32) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* wp = w_s + (pb + i) * kCols * ldw;
      // b fragment of n tile ni: (k 2t, 2t+1; n g8) and (k 2t+8, 2t+9; n g8)
      unsigned b[2][2];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const __nv_bfloat16* wn = wp + (ni * 8 + g8) * ldw + k0 + t2;
        b[ni][0] = *reinterpret_cast<const unsigned*>(wn);
        b[ni][1] = *reinterpret_cast<const unsigned*>(wn + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        unsigned a[4];
        ldmatrix_x4(a, xs + ((pb + i) * C::BM + mi * 16 + lr) * ldx + k0 + lc);
        mma_bf16_16816(acc[i][mi][0], a, b[0][0], b[0][1]);
        mma_bf16_16816(acc[i][mi][1], a, b[1][0], b[1][1]);
      }
    }
  }
}

// a bulk copy of `bytes` (a multiple of 16) from global src into this
// block's shared memory at dst, completing on bar
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// this thread's generic-proxy accesses of global memory ordered with the
// async proxy's (the bulk copies)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// bf16, one thread: the tile's rows r0 .. of the 8 products' combos (src =
// product 0's row r0 of the exchange [8][B][ldx]) into xs [p][row][ldx], one
// bulk copy a product, each completing on its mbarrier
__device__ inline void issue_copies(__nv_bfloat16* xs, const __nv_bfloat16* src, unsigned bar0,
                                    int B, int r0, int ldx) {
  constexpr int BM = ScanCfg<__nv_bfloat16>::BM;
  fence_proxy_async_global();
  const int rows = B - r0 < BM ? B - r0 : BM;
  const unsigned bytes = (unsigned)(rows * ldx * 2);
  for (int p = 0; p < kProds; ++p) {
    mbar_expect_tx(bar0 + p * 8, bytes);
    bulk_load(smem_u32(xs + p * BM * ldx), src + (size_t)p * B * ldx, bytes, bar0 + p * 8);
  }
}

// bf16: until the copies of this warp's two products (product_bf16's) land
__device__ inline void wait_copies(unsigned bar0, unsigned parity) {
  const int pb = (threadIdx.x / 64) * 2;
  mbar_wait(bar0 + pb * 8, parity);
  mbar_wait(bar0 + (pb + 1) * 8, parity);
}

__device__ inline float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(kScanThreads, 1)
qlstm_scan8_kernel(const T* __restrict__ xz, const T* __restrict__ wc8,
                   const int* __restrict__ lengths, T* hs, T* cs, T* __restrict__ gates, T* xc,
                   unsigned* bar, int Tn, int D, int B, int H, Scheme8 sch) {
  using C = ScanCfg<T>;
  using V = Vec4<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int BM = C::BM, kC = V::N, nj = kJ / kC;
  static_assert(BM * 4 * kJ == kScanThreads * kC, "a thread owns kC cells of a tile");
  extern __shared__ __align__(128) unsigned char smem[];
  const ScanLayout<T> L(H);
  T* w_s = reinterpret_cast<T*>(smem);
  T* x_s = reinterpret_cast<T*>(smem + L.x);
  float* p_s = reinterpret_cast<float*>(smem + L.prod);
  const unsigned bar0 = smem_u32(smem + L.bar);
  const int per_dir = H / kJ;
  const int d = blockIdx.x / per_dir, j0 = (blockIdx.x % per_dir) * kJ;
  const size_t h4 = 4 * (size_t)H, h16 = 16 * (size_t)H;
  const int ldx = H + C::kHPad;
  const size_t xdir = (size_t)kProds * B * ldx;  // one direction of one exchange half
  // this thread's cells: row r of a tile, component q, j = j0 + jg kC + e
  const int lane_id = threadIdx.x % 32;
  const int jg = threadIdx.x % nj, q = (threadIdx.x / nj) % 4, r = threadIdx.x / (4 * nj);
  const int jl = jg * kC;  // the cells' first column within the block's kJ
  const size_t lane = (size_t)q * H + j0 + jl;
  unsigned n_bar = 0, parity = 0;
  // the four gates' xz of a thread's cells at a row, kC each, raw
  auto load_xz = [&](unsigned (&raw)[4], size_t row) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      raw[g] = *reinterpret_cast<const unsigned*>(xz + row * h16 + g * h4 + lane);
  };
  // hs, cs and gates of a thread's cells at a row
  auto store_cells = [&](size_t row, const float (&h)[kC], const float (&c)[kC],
                         const float (&gt)[4][kC]) {
    V::store(hs + row * h4 + lane, h);
    V::store(cs + row * h4 + lane, c);
#pragma unroll
    for (int g = 0; g < 4; ++g) V::store(gates + row * h16 + g * h4 + lane, gt[g]);
  };
  float o8q[kProds];  // O8[q, p]
#pragma unroll
  for (int p = 0; p < kProds; ++p) o8q[p] = sch.out[q][p];

  // this block's weight columns, resident for the whole scan: product p,
  // column n = g*kJ + jj <- wc8[d, p, k, g*H + j0 + jj]
  for (int i = threadIdx.x; i < kProds * H * kCols; i += blockDim.x) {
    const int n = i % kCols, k = (i / kCols) % H, p = i / (kCols * H);
    w_s[C::w_at(p, k, n, H)] =
        wc8[((size_t)d * kProds + p) * H * h4 + (size_t)k * h4 + (n / kJ) * H + j0 + n % kJ];
  }
  if constexpr (kBf16) {
    if (threadIdx.x == 0) {
      for (int p = 0; p < kProds; ++p) mbar_init(bar0 + p * 8, 1);
      fence_mbar_init();
    }
  }
  __syncthreads();
  // the first tile's h_{t-1} and c_{t-1} (the storage type's values), its
  // xz of the coming step (loaded a step ahead), and its outputs, stored
  // after the step's barrier (which then need not wait for them)
  float h0[kC], c0[kC], out_h[kC], out_c[kC], out_g[4][kC];
#pragma unroll
  for (int e = 0; e < kC; ++e) h0[e] = c0[e] = 0.0f;
  unsigned xz0[4] = {0u, 0u, 0u, 0u};
  if (r < B) load_xz(xz0, (size_t)d * B + r);
  size_t out_row = 0;
  bool out_due = false;

  for (int t = 0; t < Tn; ++t) {
    const int frame = d == 0 ? t : Tn - 1 - t;  // the original time index
    for (int r0 = 0; r0 < B; r0 += BM) {
      if (r0 > 0) __syncthreads();  // the last tile is done with x_s and p_s
      const int b = r0 + r;
      const bool first_tile = r0 == 0;
      if constexpr (kBf16) {
        // the tile's combos of h_{t-1}, one bulk copy a product
        const T* src = xc + ((size_t)((t - 1) & 1) * D + d) * xdir + (size_t)r0 * ldx;
        if (t > 0 && threadIdx.x == 0) issue_copies(x_s, src, bar0, B, r0, ldx);
      } else if (t > 0) {
        stage_h(reinterpret_cast<float*>(x_s),
                reinterpret_cast<const float*>(hs) + ((size_t)(t - 1) * D + d) * B * h4, B, r0,
                H);
      }
      // the cells' xz, h_{t-1}, c_{t-1} and activity; none depends on the
      // products
      float xzc[4][kC], h_prev[kC], c_prev[kC];
      float m = 0.0f;
#pragma unroll
      for (int e = 0; e < kC; ++e) h_prev[e] = c_prev[e] = 0.0f;
      const size_t row = ((size_t)t * D + d) * B + b;
      unsigned xr[4] = {0u, 0u, 0u, 0u};
      if (b < B) {
        if (first_tile) {
#pragma unroll
          for (int g = 0; g < 4; ++g) xr[g] = xz0[g];
          if (t + 1 < Tn) load_xz(xz0, row + (size_t)D * B);
        } else {
          load_xz(xr, row);
        }
        if (first_tile) {
#pragma unroll
          for (int e = 0; e < kC; ++e) h_prev[e] = h0[e], c_prev[e] = c0[e];
        } else if (t > 0) {
          V::load(hs + (row - (size_t)D * B) * h4 + lane, h_prev);
          V::load(cs + (row - (size_t)D * B) * h4 + lane, c_prev);
        }
        m = (lengths == nullptr || frame < lengths[b]) ? 1.0f : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) V::unpack(xr[g], xzc[g]);
      // the products (none at t = 0: h_{-1} = 0)
      if (t > 0) {
        if constexpr (kBf16) {
          float acc[2][2][2][4];
          wait_copies(bar0, parity);
          product_bf16(acc, w_s, x_s, H);
          __syncthreads();  // every warp is done with the combos: p_s takes their space
          const int warp = threadIdx.x / 32, pb = (warp / 2) * 2, kh = warp % 2;
          const int g8 = lane_id / 4, t2 = (lane_id % 4) * 2;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  *reinterpret_cast<float2*>(
                      p_s + ((kh * kProds + pb + i) * BM + mi * 16 + g8 + h * 8) * kCols +
                      ni * 8 + t2) = make_float2(acc[i][mi][ni][2 * h], acc[i][mi][ni][2 * h + 1]);
          parity ^= 1u;
        } else {
          __syncthreads();  // h_s is staged
          product_f32(reinterpret_cast<const float*>(w_s), reinterpret_cast<const float*>(x_s),
                      p_s, H, sch);
        }
      }
      __syncthreads();
      // the fold: proj[g][e] = sum over p ascending of O8[q, p] prod_p at the
      // thread's cells (bf16: the two halves of each product added in order)
      float proj[4][kC];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < kC; ++e) proj[g][e] = 0.0f;
      if (t > 0) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int p = 0; p < kProds; ++p) {
            const float* pr = p_s + (p * BM + r) * kCols + g * kJ + jl;
            float prod[kC];
            if constexpr (kBf16) {
              const float2 h0 = *reinterpret_cast<const float2*>(pr);
              const float2 h1 = *reinterpret_cast<const float2*>(pr + kProds * BM * kCols);
              prod[0] = __fadd_rn(h0.x, h1.x);
              prod[kC - 1] = __fadd_rn(h0.y, h1.y);
            } else {
              prod[0] = pr[0];
            }
#pragma unroll
            for (int e = 0; e < kC; ++e) proj[g][e] += o8q[p] * prod[e];
          }
      }
      // the cell update and the stores
      float hn[kC];
#pragma unroll
      for (int e = 0; e < kC; ++e) {
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] = xzc[g][e] + proj[g][e];
        const float ig = sigmoid_f(z[0]), fg = sigmoid_f(z[1]), og = sigmoid_f(z[2]);
        const float gg = tanhf(z[3]);
        const float c_cand = fg * c_prev[e] + ig * gg;
        const float h_cand = og * tanhf(c_cand);
        const T hv = Elem<T>::from_f(m * h_cand + (1.0f - m) * h_prev[e]);
        const T cv = Elem<T>::from_f(m * c_cand + (1.0f - m) * c_prev[e]);
        hn[e] = Elem<T>::to_f(hv);
        if (first_tile) h0[e] = hn[e], c0[e] = Elem<T>::to_f(cv);
        xzc[0][e] = ig, xzc[1][e] = fg, xzc[2][e] = og, xzc[3][e] = gg;
        h_prev[e] = hn[e], c_prev[e] = Elem<T>::to_f(cv);
      }
      if (b < B && first_tile && kBf16) {  // f32's exchange is hs: stored before the barrier
#pragma unroll
        for (int e = 0; e < kC; ++e) {
          out_h[e] = h_prev[e], out_c[e] = c_prev[e];
#pragma unroll
          for (int g = 0; g < 4; ++g) out_g[g][e] = xzc[g][e];
        }
        out_row = row, out_due = true;
      } else if (b < B) {
        store_cells(row, h_prev, c_prev, xzc);
      }
      if constexpr (kBf16) {
        if (t + 1 < Tn) {
          // the combos of h_t at this thread's (row, j): products 2q and
          // 2q + 1, from the four components (lane - q nj + q' nj)
          float hq[4][kC];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
#pragma unroll
            for (int e = 0; e < kC; ++e)
              hq[qq][e] = __shfl_sync(0xffffffffu, hn[e], (lane_id & ~(3 * nj)) | (qq * nj));
          if (b < B) {
            T* dst = xc + ((size_t)(t & 1) * D + d) * xdir + (size_t)b * ldx + j0 + jl;
#pragma unroll
            for (int p = 0; p < kProds; ++p) {
              if (p / 2 != q) continue;
              const float c1 = sch.in_c[p][0], c2 = sch.in_c[p][1];
              float v[kC];
#pragma unroll
              for (int e = 0; e < kC; ++e)
                v[e] = __fadd_rn(__fmul_rn(c1, hq[term<8>(p, 0)][e]),
                                 __fmul_rn(c2, hq[term<8>(p, 1)][e]));
              V::store(dst + (size_t)p * B * ldx, v);
            }
          }
          fence_proxy_async_global();
        }
      }
    }
    if (t + 1 < Tn) dir_barrier(bar + d, ++n_bar * (unsigned)per_dir);
    if (out_due) store_cells(out_row, out_h, out_c, out_g);
    out_due = false;
  }
}

template <typename T>
int launch(const void* xz, const void* wc8, const void* lengths, void* hs, void* cs,
           void* gates, void* xc, void* bar, int Tn, int D, int B, int H, const Scheme8& s,
           cudaStream_t stream) {
  const int smem = ScanLayout<T>(H).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (sizeof(T) == 2 && xc == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qlstm_scan8_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const T* x = static_cast<const T*>(xz);
  const T* w = static_cast<const T*>(wc8);
  const int* lens = static_cast<const int*>(lengths);
  T* h = static_cast<T*>(hs);
  T* c = static_cast<T*>(cs);
  T* g = static_cast<T*>(gates);
  T* ex = static_cast<T*>(xc);
  unsigned* bp = static_cast<unsigned*>(bar);
  Scheme8 sch = s;
  void* args[] = {&x, &w, &lens, &h, &c, &g, &ex, &bp, &Tn, &D, &B, &H, &sch};
  // cooperative: refused (cudaErrorCooperativeLaunchTooLarge) when the grid
  // cannot be co-resident, which the direction barriers need
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(qlstm_scan8_kernel<T>),
                                    dim3(D * H / kJ), dim3(kScanThreads), args, (size_t)smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both directions, D = 2: xz [T,D,B,16H] gate-major, wc8 [D,8,H,4H], lengths
// [B] int32 or null; hs, cs [T,D,B,4H] and gates [T,D,B,16H] are written.
// Scratch: xc [2,D,8,B,H+8] in bf16 (the combos' exchange, ping-pong by the
// parity of t; null in f32, whose exchange is hs), bar [D] uint32 zeroed
// (the direction barriers' counters). dtype: 0 = float32, 1 = bfloat16. v8
// [8*4] and o8 [4*8] are host pointers; v8 must be the rank-8 scheme's
// (qtile's term<8>). Returns a cudaError_t (0 on success).
int qasr_qlstm_scan8(const void* xz, const void* wc8, const void* lengths, void* hs, void* cs,
                     void* gates, void* xc, void* bar, int T, int D, int B, int H, int dtype,
                     const float* v8, const float* o8, void* stream) {
  Scheme8 s;
  if (make_scheme(v8, o8, &s) != 0 || !wg_scheme_ok(s)) return (int)cudaErrorInvalidValue;
  if (H < 16 || H % 16 || D != 2 || T < 0 || B < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(xz, wc8, lengths, hs, cs, gates, xc, bar, T, D, B, H, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xz, wc8, lengths, hs, cs, gates, xc, bar, T, D, B, H, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
