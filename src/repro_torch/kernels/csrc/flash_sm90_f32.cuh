// Device code shared by the port's two float32 attention kernels on
// Hopper's TF32 tensor cores: flash_prefill_sm90_f32.cu (the forward) and
// flash_backward_sm90_f32.cu (its gradient), the "tc32" routes of
// kernels/flash_attention.py's launch_plan and bwd_launch_plan.
//
// Precision, as l2_sm90.cuh takes it for the verify and assign kernels:
// each float32 operand x is split into x_hi = rna_tf32(x) and x_lo =
// rna_tf32(x - x_hi) (tf32_bits below rounds as its tf32_rna does, in
// integer operations), and every 8-deep k step takes three products, lo.hi,
// hi.lo and hi.hi (lo.lo is below float32's last bit). The tensor cores
// round their float32 sums toward zero, so no accumulator runs over a long
// k walk: a product is taken in chunks of at most 32 deep (4 k steps), each
// chunk's 12 products into a fresh partial sum in one fixed order (the 8
// small ones while the sum is small, then the 4 hi.hi), and the partial is
// added to the running total in float32 by the caller, rounding to nearest.
//
// Operands. tf32 wgmma takes B from shared memory K-major only (no
// transpose flag), and A from registers or K-major shared memory. Here A
// always comes from registers, loaded by each thread from a float32 tile
// in shared memory: either a raw tile, split on the fly (frag_split), or a
// hi/lo pair of tiles read across (frag_t: A = Xᵀ of a tile X stored with
// the depth along its rows). So no tile is ever copied transposed: every
// staged tile is split in place (hi over the raw values, lo beside them,
// the same layout), and a result that feeds a later product as B is
// written from its accumulator fragment straight into a hi/lo pair
// (store_b). Tiles are float32 in panels of 32 columns x R rows of 128
// bytes with the 128-byte swizzle, as TMA lands a box of 32 floats.
#pragma once

#include <climits>
#include <cstdint>
#include <cstring>

#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors and fences

namespace f32sm90 {

using namespace sm90;

constexpr float kNegFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kAbsent = INT_MIN;  // a key index past T

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

// ---- wgmma, A in registers ---------------------------------------------------
// d (64 x N) = scale_d * d + A (64 x 8, tf32 in registers) B (N x 8)^T (tf32,
// K-major in shared memory). A fragment of a warp's 16 rows: a0 (row
// lane/4, col lane%4), a1 (row + 8, col), a2 (row, col + 4), a3 (row + 8,
// col + 4); warp w of the warpgroup holds rows 16w..16w+15.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// ---- tiles -------------------------------------------------------------------
// byte offset of element (r, c) of a float32 tile of R rows: panel c / 32
// of R rows x 128 bytes, 16-byte unit u of row r at position u ^ (r % 8)
__device__ __forceinline__ uint32_t at(int R, int r, int c) {
  return (c >> 5) * R * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
         ((c & 3) << 2);
}

__device__ __forceinline__ float lds(const uint8_t* tile, uint32_t off) {
  return *reinterpret_cast<const float*>(tile + off);
}

// B of k step kk: rows n0.. (a multiple of 8) of a K-major tile of R rows
// at shared address `tile`, the depth along its columns
__device__ __forceinline__ uint64_t bdesc(uint32_t tile, int R, int n0,
                                          int kk) {
  return make_desc(tile + (kk >> 2) * R * 128 + n0 * 128 + (kk & 3) * 32,
                   desc_bits(16));
}

// a finite x rounded to TF32 (10 stored mantissa bits), to nearest with
// ties away from zero, as cvt.rna.tf32.f32 (l2_sm90.cuh's tf32_rna) rounds
// it: half of the 13 dropped bits added to the magnitude, then cleared (a
// carry rounds into the exponent). Two integer operations, where the
// conversion instruction issues at a quarter of their rate: these kernels
// split every staged tile and every A fragment they read raw, and with the
// conversion the splits set their pace.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split1(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// A of k step k0..k0+7 at rows m0.. of a raw row-major (M x K) tile of R
// rows, split on the fly (this thread's 4 elements)
__device__ __forceinline__ void frag_split(const uint8_t* tile, int R, int m0,
                                           int k0, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int m = m0 + 16 * w + (lane >> 2), k = k0 + (lane & 3);
  split1(lds(tile, at(R, m, k)), hi[0], lo[0]);
  split1(lds(tile, at(R, m + 8, k)), hi[1], lo[1]);
  split1(lds(tile, at(R, m, k + 4)), hi[2], lo[2]);
  split1(lds(tile, at(R, m + 8, k + 4)), hi[3], lo[3]);
}

// A = X^T of k step k0..k0+7 at rows m0.. from the hi and lo tiles of X
// (K x M, R rows): element (m, k) of A is (k, m) of X
__device__ __forceinline__ void frag_t(const uint8_t* hi_t,
                                       const uint8_t* lo_t, int R, int m0,
                                       int k0, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int m = m0 + 16 * w + (lane >> 2), k = k0 + (lane & 3);
  const uint32_t o[4] = {at(R, k, m), at(R, k, m + 8), at(R, k + 4, m),
                         at(R, k + 4, m + 8)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = __float_as_uint(lds(hi_t, o[i]));
    lo[i] = __float_as_uint(lds(lo_t, o[i]));
  }
}

// one chunk (KS <= 4 k steps from kk0) of A B^T into the fresh partial
// `part`: the lo.hi and hi.lo products k step by k step, then the hi.hi;
// B rows n0.. of the K-major hi and lo tiles (R rows). Issued, not waited
// for: chunk3_wait retires it, and until then neither `part` nor the A
// registers may be touched.
template <int N, int KS>
__device__ __forceinline__ void chunk3_issue(float (&part)[N / 2],
                                             uint32_t (&ah)[KS][4],
                                             uint32_t (&al)[KS][4],
                                             uint32_t b_hi, uint32_t b_lo,
                                             int R, int n0, int kk0) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_rs<N>(part, al[kk], bdesc(b_hi, R, n0, kk0 + kk), kk > 0);
    wgmma_rs<N>(part, ah[kk], bdesc(b_lo, R, n0, kk0 + kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs<N>(part, ah[kk], bdesc(b_hi, R, n0, kk0 + kk), 1);
  wgmma_commit();
}

template <int N, int KS>
__device__ __forceinline__ void chunk3_wait(float (&part)[N / 2],
                                            uint32_t (&ah)[KS][4],
                                            uint32_t (&al)[KS][4]) {
  wgmma_wait_all();
  fence_regs(part);
  fence_regs(ah);
  fence_regs(al);
}

struct NoShadow {
  __device__ __forceinline__ void operator()() const {}
};

// acc (64 x N) = A B^T over a depth of D: A rows m0.. of a raw row-major
// (M x D) tile of Ra rows (split on the fly), B the N rows of the K-major
// hi/lo tiles (N rows); 32-deep chunks, each a fresh partial added to acc.
// The next chunk's A is loaded while a chunk runs, and `shadow` runs while
// the last one does.
template <int N, int D, class Shadow = NoShadow>
__device__ __forceinline__ void dots(float (&acc)[N / 2], const uint8_t* a,
                                     int Ra, int m0, uint32_t b_hi,
                                     uint32_t b_lo,
                                     Shadow shadow = Shadow()) {
  constexpr int kC = D / 32;
  uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    frag_split(a, Ra, m0, 8 * kk, ah[0][kk], al[0][kk]);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float part[N / 2];
    chunk3_issue<N, 4>(part, ah[c & 1], al[c & 1], b_hi, b_lo, N, 0, 4 * c);
    if (c + 1 < kC) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        frag_split(a, Ra, m0, 32 * (c + 1) + 8 * kk, ah[(c + 1) & 1][kk],
                   al[(c + 1) & 1][kk]);
    } else {
      shadow();
    }
    chunk3_wait<N, 4>(part, ah[c & 1], al[c & 1]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = c == 0 ? part[i] : acc[i] + part[i];
  }
}

// MT m-tiles of 64 rows of X^T B: A = X^T from X's hi/lo tiles (K x M, R
// rows), rows m0 + 64 mt.., k steps 0..KS-1; B rows n0.. of the K-major
// hi/lo tiles of Rb rows. Each m-tile one chunk into a fresh partial,
// handed to update(mt, part); the next m-tile's A is loaded while one
// runs, and `shadow` runs while the last one does.
template <int N, int KS, int MT, class Update, class Shadow>
__device__ __forceinline__ void tiles_t(const uint8_t* x_hi,
                                        const uint8_t* x_lo, int R, int m0,
                                        uint32_t b_hi, uint32_t b_lo, int Rb,
                                        int n0, Update update,
                                        Shadow shadow) {
  uint32_t ah[2][KS][4], al[2][KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    frag_t(x_hi, x_lo, R, m0, 8 * kk, ah[0][kk], al[0][kk]);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float part[N / 2];
    chunk3_issue<N, KS>(part, ah[mt & 1], al[mt & 1], b_hi, b_lo, Rb, n0,
                        0);
    if (mt + 1 < MT) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        frag_t(x_hi, x_lo, R, m0 + 64 * (mt + 1), 8 * kk,
               ah[(mt + 1) & 1][kk], al[(mt + 1) & 1][kk]);
    } else {
      shadow();
    }
    chunk3_wait<N, KS>(part, ah[mt & 1], al[mt & 1]);
    update(mt, part);
  }
}

// the column groups j0.. j0 + NJ - 1 of an accumulator fragment (rows m0 +
// 16 w + lane/4 (+ 8), columns 8j + 2(lane%4) (+ 1)), given as x[4 (j -
// j0) + 2h + e], as hi and lo at the same places of two tiles of R rows
// (the layout a K-major B of those rows reads)
template <int NJ>
__device__ __forceinline__ void store_b(const float (&x)[4 * NJ],
                                        uint8_t* hi_t, uint8_t* lo_t, int R,
                                        int m0, int j0 = 0) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int m = m0 + 16 * w + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t hi0, lo0, hi1, lo1;
      split1(x[4 * jj + 2 * h], hi0, lo0);
      split1(x[4 * jj + 2 * h + 1], hi1, lo1);
      const uint32_t o = at(R, m + 8 * h, 8 * (j0 + jj) + c);
      *reinterpret_cast<uint2*>(hi_t + o) = make_uint2(hi0, hi1);
      *reinterpret_cast<uint2*>(lo_t + o) = make_uint2(lo0, lo1);
    }
}

// a staged raw tile of `bytes` split in place (hi over it, lo at `lo`) by
// the block's NT threads
template <int NT>
__device__ __forceinline__ void split_tile(uint8_t* raw, uint8_t* lo,
                                           int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += NT) {
    float4 x = reinterpret_cast<float4*>(raw)[i];
    uint32_t h[4], l[4];
    split1(x.x, h[0], l[0]);
    split1(x.y, h[1], l[1]);
    split1(x.z, h[2], l[2]);
    split1(x.w, h[3], l[3]);
    reinterpret_cast<uint4*>(raw)[i] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(lo)[i] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// ---- which keys a row sees ---------------------------------------------------
// key c is seen by the query at position q iff p_c >= 0, (causal) q >= p_c
// and (window > 0) p_c > q - window, with p_c = kv_pos[c] (or c if null)
struct Mask {
  const int32_t* kv_pos;
  int T, R, g, causal, window, q_offset;

  __device__ __forceinline__ bool visible(int p, int q) const {
    return p >= 0 && (!causal || q >= p) && (window <= 0 || p > q - window);
  }
  __device__ __forceinline__ int key_pos(int col) const {
    return col >= T ? kAbsent : (kv_pos == nullptr ? col : kv_pos[col]);
  }
  // the query positions [qa, qb] of the rows [row0, row0 + n) that exist
  __device__ __forceinline__ void positions(int row0, int n, int& qa,
                                            int& qb) const {
    qa = q_offset + row0 / g;
    qb = q_offset + (min(row0 + n, R) - 1) / g;
  }
  // some row at a position in [qa, qb] sees no key (kv_pos null): its
  // range is empty, which happens only at the ends
  __device__ __forceinline__ bool empty_row(int qa, int qb) const {
    return kv_pos == nullptr && ((causal && qa + 1 <= 0) ||
                                 (window > 0 && qb - window + 1 >= T));
  }
  // the keys [t_lo, t_hi) that rows at [qa, qb] visit: the hull of their
  // ranges (all keys when positions are given), and all keys when
  // `uniform` and one of them sees none; t_lo a multiple of `tile`
  __device__ __forceinline__ void key_range(int qa, int qb, bool uniform,
                                            int tile, int& t_lo,
                                            int& t_hi) const {
    t_lo = 0;
    t_hi = T;
    if (kv_pos != nullptr || (uniform && empty_row(qa, qb))) return;
    if (causal) t_hi = min(T, qb + 1);
    if (window > 0) t_lo = max(0, qa - window + 1);
    t_lo = (t_lo / tile) * tile;
  }
  // some row of [row0, row0 + n) visits a key of [c0, c1) (uniform rows
  // visit every key)
  __device__ __forceinline__ bool rows_visit(int row0, int n, int c0,
                                             int c1) const {
    if (kv_pos != nullptr) return true;
    int qa, qb;
    positions(row0, n, qa, qb);
    if (empty_row(qa, qb)) return true;
    const int lo = causal ? max(qa, c0) : qa;
    const int hi = window > 0 ? min(qb, c1 + window - 2) : qb;
    return lo <= hi;
  }
  // every row at [qa, qb] sees every key of [c0, c0 + n): no mask needed
  __device__ __forceinline__ bool all_seen(int qa, int qb, int c0,
                                           int n) const {
    return kv_pos == nullptr && c0 + n <= T && (!causal || qa >= c0 + n - 1) &&
           (window <= 0 || c0 > qb - window);
  }
};

// the 1024-byte-aligned base of dynamic shared memory (128-byte swizzling
// repeats every 1024 bytes), as a shared address and a pointer
__device__ __forceinline__ uint32_t aligned_base(uint8_t* raw,
                                                 uint8_t** generic) {
  const uint32_t r = smem_addr(raw);
  const uint32_t base = (r + 1023u) & ~1023u;
  *generic = raw + (base - r);
  return base;
}

// the copies of packed rows [row0, row0 + n) of Q (and dO, when tm_do;
// boxes of g heads x n / g positions) into the raw tiles q_dst and
// do_dst, completing on `bar` (one thread)
template <int D>
__device__ __forceinline__ void tma_rows(const CUtensorMap* tm_q,
                                         const CUtensorMap* tm_do,
                                         uint32_t q_dst, uint32_t do_dst,
                                         uint32_t bar, int row0, int n,
                                         int hk, int b, int g) {
  mbar_expect_tx(bar, (tm_do != nullptr ? 2 : 1) * n * D * 4);
  for (int p = 0; p < D / 32; ++p) {
    tma_load_4d(q_dst + p * n * 128, tm_q, bar, p * 32, hk * g, row0 / g, b);
    if (tm_do != nullptr)
      tma_load_4d(do_dst + p * n * 128, tm_do, bar, p * 32, hk * g, row0 / g,
                  b);
  }
}

// the copies of keys [col0, col0 + n) of K (and V, when tm_v) into k_dst
// and v_dst, completing on `bar` (one thread)
template <int D>
__device__ __forceinline__ void tma_keys(const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v,
                                         uint32_t k_dst, uint32_t v_dst,
                                         uint32_t bar, int col0, int n,
                                         int hk, int b) {
  mbar_expect_tx(bar, (tm_v != nullptr ? 2 : 1) * n * D * 4);
  for (int p = 0; p < D / 32; ++p) {
    tma_load_4d(k_dst + p * n * 128, tm_k, bar, p * 32, hk, col0, b);
    if (tm_v != nullptr)
      tma_load_4d(v_dst + p * n * 128, tm_v, bar, p * 32, hk, col0, b);
  }
}

// packed rows [row0, row0 + n) of a float32 (B, Sq, H, D) tensor read
// through element strides into the raw tile at `dst` (n rows), by plain
// 16-byte loads in the TMA box's layout; rows past R are zeros. The
// block's NT threads take part.
template <int D, int NT>
__device__ __forceinline__ void load_rows(uint8_t* dst, const float* x,
                                          long long sb, long long ss,
                                          long long sh, int b, int hk,
                                          int row0, int n, const Mask& mk) {
  for (int i = threadIdx.x; i < n * (D / 4); i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4, row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < mk.R) {
      const int s = row / mk.g, h = hk * mk.g + row % mk.g;
      v = *reinterpret_cast<const float4*>(x + b * sb + s * ss + h * sh + c);
    }
    *reinterpret_cast<float4*>(dst + at(n, r, c)) = v;
  }
}

// ---- host side ---------------------------------------------------------------
// a float32 (B, steps, heads, D) tensor read through element strides, as a
// 4-D map over (D, heads, steps, B) with a box of 32 x box_heads x
// box_steps x 1 and the 128-byte swizzle; reads past the edges give zeros
inline cudaError_t encode(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                          int d, int heads, int steps, int batch,
                          long long s_h, long long s_s, long long s_b,
                          int box_heads, int box_steps) {
  std::memset(map, 0, sizeof(*map));
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads),
                              cuuint64_t(steps), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(s_h) * 4, cuuint64_t(s_s) * 4,
                                 cuuint64_t(s_b) * 4};
  const cuuint32_t box[4] = {32u, cuuint32_t(box_heads),
                             cuuint32_t(box_steps), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// above 48 KB a block's shared memory must be asked for; once per kernel
// and device
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int dev, int& configured) {
  if (configured == dev) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = dev;
  return err;
}

}  // namespace f32sm90
