// The gradient of grouped-head attention on Hopper's bf16 tensor cores:
// dQ, dK and dV of every bf16 attention backward at head dims 64, 128 and
// 256 (kernels/flash_attention.py::bwd_launch_plan's "tc" route; float32,
// and bf16 at other head dims, take flash_backward.cu on the CUDA cores).
//
// Replaces: nothing on the TPU. The JAX package differentiates its plain
// attention region, src/repro/models/layers.py:134, gqa_scores_chunked,
// with autograd (its Pallas kernel, src/repro/kernels/flash_attention.py:77,
// has no backward). The function is flash_backward.cu's, unchanged: for q
// (B, Sq, H, D), k, v (B, T, Hkv, D), query head h reads KV head h / g;
//   s_c = scale q.k_c, or the fill -1e30 where key c is not seen (p_c >= 0,
//   (causal) q_pos >= p_c, (window > 0) p_c > q_pos - window); P =
//   softmax(s); delta = sum_d dO.O; dS_c = P_c (dO.v_c - delta) where c is
//   seen, 0 where it is masked (the fill passes no gradient); dQ = scale
//   sum_c dS_c k_c, dK_c = scale sum_q dS_c q, dV_c = sum_q P_c dO.
// A row with no visible key has a uniform P over the T keys, as in the
// reference: its dV share is dO / T and its dS 0.
//
// What bounds it on an H100: at qwen3-0.6b's training shape (B 4, S = T
// 2048, H 16, Hkv 8, D 128, causal) the five products (S, dP, dV, dK, dQ)
// are 172 GFLOP at the bf16 rate (0.174 ms at 989 TFLOP/s) against 134 MB
// of operands (0.04 ms): operations bound it. This kernel issues about 11
// product-sized units for those 5 (S in the statistics pass and again in
// dK/dV and dQ, dP twice, and each product that takes P or dS twice, for
// its two bf16 halves), 0.38 ms at the bf16 peak.
//
// Precision. Q, K, V, O and dO are bf16, so every product of two of them is
// exact in float32, and the tensor cores sum them into float32
// accumulators. P and dS are formed in float32 registers and are operands
// of dV = P^T dO, dK = dS^T Q and dQ = dS K: each is split in registers into
// hi = bf16(x) and lo = bf16(x - hi), and each of those products is issued
// twice into the same float32 accumulator (as flash_prefill_sm90.cu does
// for P.V), so P and dS keep about 16 significant bits where one bf16 keeps
// 8. One bf16 P and dS (FA2's, FA3's and SDPA's choice) land past the bf16
// rows' element-wise and norm limits, and so does dropping the lo half
// from any one of the three products (tests/test_torch_flash_bwd_tc.py
// records by how much, in CPU emulation). A row that sees no key has the
// same P = 1/l on every key, so its terms would all carry one relative
// error and a sum keeps it: such rows take no part in the split products,
// and their dV share is added in float32 on the CUDA cores instead.
//
// Design: four launches at most, no atomics, so every gradient is written
// once and the GQA sum over a KV head's g query heads is taken in one fixed
// order (two identical calls give the same bits). Rows are packed as in the
// forward, r = s*g + h%g, in tiles of 64; keys in tiles of 64. Tiles live
// in shared memory as D/64 panels of 64 rows x 128 bytes with the 128-byte
// swizzle, so one tile is read K-major (the depth is D) by S = Q K^T and dP =
// dO V^T and MN-major (the depth is the rows or keys) by the products that
// take P or dS. K and V come by TMA through 4-D tensor maps over
// (D, Hkv, T, B) and their strides; Q and dO by TMA as a box of g heads x
// 64/g positions where g divides 64, else by 16-byte cp.async copies written
// in the same swizzled layout.
//   1. prep, one block (a warpgroup) per (row tile, KV head, batch): S = Q
//      K^T on wgmma m64n64k16, K streamed through a two-stage TMA ring; each
//      row's softmax max m (in base 2, the scale folded with log2 e) and sum
//      l, kept apart as in flash_backward.cu (a row whose scores are all the
//      fill has m = -1e30 and l = T); delta = dO.O in float32.
//   2. dK/dV, one block per (key tile, KV head, batch, row split): K and V
//      stay in shared memory; the block walks its share of the row tiles
//      that can see a key of its tile, Q and dO (and each row's m, 1/l,
//      delta, position) streamed through a two-stage ring; per half (32
//      rows) of a row tile S^T = K Q^T and dP^T = V dO^T (m64n32, both
//      operands from shared memory), P^T and dS^T in float32 registers,
//      then dV += P^T dO and dK += dS^T Q with the split halves as register
//      A operands and dO and Q as MN-major B. Halves, because dK and dV
//      hold 128 registers a thread at D 128: with a whole tile's S^T, dP^T
//      and split P and dS beside them the kernel spilled. When B * Hkv *
//      (T/64) is under the card's 132 SMs (one KV head at B 1), the row
//      walk is split into n_split parts that write float32 partial dK/dV
//      to scratch, and
//   4. a reduction sums the parts in a fixed order and rounds once to bf16.
//   3. dQ, one block per (row tile, KV head, batch): Q and dO loaded once,
//      K and V streamed through a two-stage ring; S, dP, dS as above, then
//      dQ += dS K with K as MN-major B.
// At D 256 the dK/dV (and dQ) accumulators do not fit one warpgroup's
// registers: two warpgroups each own 128 of the D output columns and each
// computes the S and dP it needs itself, so those products run twice
// there. No kernel spills (ptxas: dK/dV 254 registers at D 128 and 256,
// 186 at D 64; dQ 154 and 124; prep 58). Tried and not kept, on an H100:
// blocks of two warpgroups sharing each streamed tile (slower at every
// shape, and it spilled), issuing a half's S^T and dP^T behind the other
// half's products (slower, and it spilled), a four-stage ring in prep
// (slower: fewer blocks an SM), rebuilding the loop-invariant wgmma
// descriptors at each use (more spills).
// Which tiles are visited: a row at query position q sees the keys
// [max(0, q - window + 1), min(T, q + 1)) (causal / window) when key
// positions are the indices, all keys when positions are given (kv_pos) or
// that range is empty (the uniform row). A block visits the hull of its rows'
// ranges and masks inside it; a masked key's P is exp2(-1e30 - m) = 0 for a
// row that sees a key, so a skipped tile changes nothing. Outputs are
// written once in bf16, rounded to nearest even. No TF32 anywhere.
#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kTile = 64;                  // rows of a row tile, keys of a key tile
constexpr int kPanel = 64;                 // bf16 columns of a 128-byte row
constexpr int kPanelBytes = kTile * 128;   // one panel of a 64-row tile
constexpr float kNegFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kAbsent = INT_MIN;           // a key index past T

template <int D>
struct Cfg {
  static constexpr int kWG = D == 256 ? 2 : 1;  // warpgroups of dK/dV and dQ
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kDW = D / kWG;           // output columns a warpgroup owns
  static constexpr int kPanels = D / kPanel;
  static constexpr int kTileBytes = D * 128;    // 64 rows x D bf16
};

struct Args {
  const __nv_bfloat16* q;     // (B, Sq, H, D) through q_s*
  const __nv_bfloat16* o;     // contiguous (B, Sq, H, D)
  const __nv_bfloat16* dout;  // contiguous (B, Sq, H, D)
  __nv_bfloat16* dq;          // contiguous (B, Sq, H, D)
  __nv_bfloat16* dk;          // contiguous (B, T, Hkv, D)
  __nv_bfloat16* dv;
  float* dk_part;             // (n_split, B, T, Hkv, D) when n_split > 1
  float* dv_part;
  float* stats;               // (B, Hkv, Sq*g, 2): m (base 2), l
  float* delta;               // (B, Hkv, Sq*g)
  const int32_t* kv_pos;      // (T,) or null: positions are the indices
  long long q_sb, q_ss, q_sh;
  int B, Sq, T, H, Hkv, g, n_split;
  int causal, window, q_offset, q_tma;
  float scale, scale_log2;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

__device__ __forceinline__ bool visible(int p, int qpos, const Args& a) {
  return p >= 0 && (!a.causal || qpos >= p) &&
         (a.window <= 0 || p > qpos - a.window);
}

__device__ __forceinline__ int key_pos(const Args& a, int col) {
  return col >= a.T ? kAbsent : (a.kv_pos == nullptr ? col : a.kv_pos[col]);
}

// the first and last query positions of the rows [row0, row0 + 64) that
// exist (the caller has row0 < R)
__device__ __forceinline__ void tile_positions(const Args& a, int row0,
                                               int& qa, int& qb) {
  const int last = min(row0 + kTile, a.Sq * a.g) - 1;
  qa = a.q_offset + row0 / a.g;
  qb = a.q_offset + last / a.g;
}

// some row at a position in [qa, qb] sees no key (kv_pos null): its range
// is empty, so it visits every key (the uniform row). Empty ranges lie at
// the ends: q + 1 <= 0 (causal) or q - window + 1 >= T (window)
__device__ __forceinline__ bool has_empty_row(const Args& a, int qa, int qb) {
  return a.kv_pos == nullptr && ((a.causal && qa + 1 <= 0) ||
                                 (a.window > 0 && qb - a.window + 1 >= a.T));
}

// the key tiles [t_lo, t_hi) rows at [qa, qb] visit: the hull of their
// ranges (every key when positions are given), and every key when
// `uniform_rows` and a row of them sees none; t_lo is tile-aligned
__device__ __forceinline__ void key_range(const Args& a, int qa, int qb,
                                          bool uniform_rows, int& t_lo,
                                          int& t_hi) {
  t_lo = 0;
  t_hi = a.T;
  if (a.kv_pos != nullptr || (uniform_rows && has_empty_row(a, qa, qb)))
    return;
  if (a.causal) t_hi = min(a.T, qb + 1);
  if (a.window > 0) t_lo = max(0, qa - a.window + 1);
  t_lo = (t_lo / kTile) * kTile;
}

// some row of row tile `rt` visits a key of [c0, c1)
__device__ __forceinline__ bool tile_visits(const Args& a, int rt, int c0,
                                            int c1) {
  if (a.kv_pos != nullptr) return true;
  int qa, qb;
  tile_positions(a, rt * kTile, qa, qb);
  if (has_empty_row(a, qa, qb)) return true;
  const int lo = a.causal ? max(qa, c0) : qa;
  const int hi = a.window > 0 ? min(qb, c1 + a.window - 2) : qb;
  return lo <= hi;
}

// every row at [qa, qb] sees every key of [c0, c0 + 64): no mask needed
__device__ __forceinline__ bool tile_all_seen(const Args& a, int qa, int qb,
                                              int c0) {
  return a.kv_pos == nullptr && c0 + kTile <= a.T &&
         (!a.causal || qa >= c0 + kTile - 1) &&
         (a.window <= 0 || c0 > qb - a.window);
}

// a register holding two bf16: x in the low half (the lower column); hi =
// bf16(x), lo = bf16(x - hi), both rounded to nearest even
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - back.x, y - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// eight bf16 pairs' products summed into s, in float32 (each bf16 widened
// exactly: it is the top half of a float32)
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float s) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s = fmaf(__uint_as_float(xs[i] << 16), __uint_as_float(ys[i] << 16), s);
    s = fmaf(__uint_as_float(xs[i] & 0xffff0000u),
             __uint_as_float(ys[i] & 0xffff0000u), s);
  }
  return s;
}

// --- cp.async: the rows of Q or dO where g does not divide the tile ---------
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// packed rows [row0, row0 + 64) of a (B, Sq, H, D) tensor read through
// element strides into the swizzled tile at `dst` (chunk c of row r at
// panel c / 8, byte r * 128 + ((c % 8) ^ (r % 8)) * 16, as the TMA box
// lays it); rows past R are zero-filled. All NT threads take part.
template <int D, int NT>
__device__ __forceinline__ void load_rows_async(
    uint32_t dst, const __nv_bfloat16* x, long long sb, long long ss,
    long long sh, int b, int hk, int row0, const Args& a) {
  constexpr int kChunks = D / 8;
  const int R = a.Sq * a.g;
  for (int i = threadIdx.x; i < kTile * kChunks; i += NT) {
    const int r = i / kChunks, c = i % kChunks, row = row0 + r;
    const bool ok = row < R;
    const __nv_bfloat16* src = x;
    if (ok) {
      const int s = row / a.g, h = hk * a.g + row % a.g;
      src = x + b * sb + s * ss + h * sh + c * 8;
    }
    cp_async16(dst + (c / 8) * kPanelBytes + r * 128 + (((c % 8) ^ (r % 8)) * 16),
               src, ok);
  }
}

// the copies of one 64-row tile of Q and one of dO into `dst` (dO after Q)
// by TMA, completing on `bar` (thread 0 only)
template <int D>
__device__ __forceinline__ void tma_rows(const CUtensorMap* tm_q,
                                         const CUtensorMap* tm_do,
                                         uint32_t dst, uint32_t bar,
                                         int row0, int hk, int b, int g) {
  using C = Cfg<D>;
  mbar_expect_tx(bar, 2 * C::kTileBytes);
  for (int p = 0; p < C::kPanels; ++p) {
    tma_load_4d(dst + p * kPanelBytes, tm_q, bar, p * kPanel, hk * g,
                row0 / g, b);
    tma_load_4d(dst + C::kTileBytes + p * kPanelBytes, tm_do, bar,
                p * kPanel, hk * g, row0 / g, b);
  }
}

// the copies of key tile col0 of K (and V after it, when tm_v) into `dst`,
// completing on `bar` (thread 0), and the keys' positions into kpos (the
// first 64 threads)
template <int D>
__device__ __forceinline__ void load_keys(const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v,
                                          uint32_t dst, uint32_t bar,
                                          int* kpos, int col0, int hk, int b,
                                          const Args& a) {
  using C = Cfg<D>;
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, (tm_v != nullptr ? 2 : 1) * C::kTileBytes);
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load_4d(dst + p * kPanelBytes, tm_k, bar, p * kPanel, hk, col0, b);
      if (tm_v != nullptr)
        tma_load_4d(dst + C::kTileBytes + p * kPanelBytes, tm_v, bar,
                    p * kPanel, hk, col0, b);
    }
  }
  if (threadIdx.x < kTile) kpos[threadIdx.x] = key_pos(a, col0 + threadIdx.x);
}

// S (64 x N) = A (64 x 16) B (N x 16)^T, both K-major in shared memory;
// scale_d = 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// d (64 x N) += A (64 x 16, registers) B (16 x N, MN-major in shared memory)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// k16 step kk of a 64-row tile at `tile`, read K-major (depth along D) and
// MN-major (depth along the rows, from column panel p0)
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return make_desc(tile + (kk / 4) * kPanelBytes + (kk % 4) * 32,
                   desc_bits(16));
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int p0, int kk) {
  return make_desc(tile + p0 * kPanelBytes + kk * 16 * 128,
                   desc_bits(kPanelBytes));
}

// acc (64 x N) = A (64 x D) B (N x D)^T, A a 64-row tile and B N rows of
// one (from the address tb), both read K-major
template <int D, int N = 64>
__device__ __forceinline__ void product_ss(float (&acc)[N / 2], uint32_t ta,
                                           uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(acc, kmajor(ta, kk), kmajor(tb, kk), kk > 0);
}

// acc (64 x N) += X (64 x 16 KS, split into hi and lo register fragments)
// B, B the 64 x N columns from panel p0 of a 64-row tile read MN-major
// from its k-step k0 (row 16 k0): the hi half's KS k-steps, then the lo
// half's
template <int N, int KS>
__device__ __forceinline__ void product_rs(float (&acc)[N / 2],
                                           const uint32_t (&hi)[KS][4],
                                           const uint32_t (&lo)[KS][4],
                                           uint32_t tb, int p0, int k0 = 0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs<N>(acc, hi[kk], mnmajor(tb, p0, k0 + kk), 1);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs<N>(acc, lo[kk], mnmajor(tb, p0, k0 + kk), 1);
}

// a 64 x 16 KS C fragment as the A fragments of its KS k16 steps, each
// split: A register r of step kk is C registers 8kk + 2r, 8kk + 2r + 1
template <int KS>
__device__ __forceinline__ void split_fragment(const float (&x)[8 * KS],
                                               uint32_t (&hi)[KS][4],
                                               uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pair(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
}

template <int D>
__device__ __forceinline__ void zero(float (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = 0.f;
}

// the 1024-byte-aligned base of dynamic shared memory (128-byte swizzling
// repeats every 1024 bytes)
__device__ __forceinline__ uint32_t aligned_base(uint8_t* raw,
                                                 uint8_t** generic) {
  const uint32_t r = smem_addr(raw);
  const uint32_t base = (r + 1023u) & ~1023u;
  *generic = raw + (base - r);
  return base;
}

// ---------------------------------------------------------------------------
// 1. prep: each row's m (base 2) and l over the keys it visits; delta
// ---------------------------------------------------------------------------
template <int D>
struct PrepLayout {
  static constexpr int kQ = 0;
  static constexpr int kK = Cfg<D>::kTileBytes;        // [2] stages: K tile
  static constexpr int kPos = 3 * Cfg<D>::kTileBytes;  // int [2][64]
  static constexpr int kBar = kPos + 2 * kTile * 4;    // q, full[2]
  static constexpr int kAlloc = kBar + 24 + 1024;
};

template <int D>
__global__ void __launch_bounds__(128, 1)
    bwd_prep_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k, const Args a) {
  using C = Cfg<D>;
  using L = PrepLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sbase;
  const uint32_t base = aligned_base(smem_raw, &sbase);
  int* const kpos = reinterpret_cast<int*>(sbase + L::kPos);
  const uint32_t bar_q = base + L::kBar, bar_full = bar_q + 8;
  const int row0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.g, R = a.Sq * g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int qa, qb, t_lo, t_hi;
  tile_positions(a, row0, qa, qb);
  key_range(a, qa, qb, true, t_lo, t_hi);
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + kTile - 1) / kTile : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_full, 1);
    mbar_init(bar_full + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && a.q_tma) {
    mbar_expect_tx(bar_q, C::kTileBytes);
    for (int p = 0; p < C::kPanels; ++p)
      tma_load_4d(base + L::kQ + p * kPanelBytes, &tm_q, bar_q, p * kPanel,
                  hk * g, row0 / g, b);
  }
  if (n_tiles > 0)
    load_keys<D>(&tm_k, nullptr, base + L::kK, bar_full, kpos, t_lo, hk, b, a);
  if (a.q_tma) {
    mbar_wait(bar_q, 0);
  } else {
    load_rows_async<D, 128>(base + L::kQ, a.q, a.q_sb, a.q_ss, a.q_sh, b, hk,
                            row0, a);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
  }
  __syncthreads();

  // this thread's two rows (C-fragment rows lane/4 and lane/4 + 8 of its
  // warp's 16) and its columns kq, kq + 1 of every 8
  const int r0 = row0 + 16 * warp + lane / 4, r1 = r0 + 8;
  const int qp0 = a.q_offset + r0 / g, qp1 = a.q_offset + r1 / g;
  const int kq = (lane % 4) * 2;
  float m0 = kNegFill, m1 = kNegFill, l0 = 0.f, l1 = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, col0 = t_lo + it * kTile;
    if (it + 1 < n_tiles)  // into the stage tile it - 1 left
      load_keys<D>(&tm_k, nullptr, base + L::kK + (st ^ 1) * C::kTileBytes,
                   bar_full + 8 * (st ^ 1), kpos + (st ^ 1) * kTile,
                   col0 + kTile, hk, b, a);
    mbar_wait(bar_full + 8 * st, (it >> 1) & 1);
    float s[32];
    zero(s);
    wgmma_fence();
    product_ss<D>(s, base + L::kQ, base + L::kK + st * C::kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    const bool mask = !tile_all_seen(a, qa, qb, col0);
    const int* kp = kpos + st * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * j + e] * a.scale_log2;
        float x1 = s[4 * j + 2 + e] * a.scale_log2;
        if (mask) {
          const int p = kp[8 * j + kq + e];
          if (p == kAbsent) {
            x0 = x1 = neg_inf();
          } else {
            if (!visible(p, qp0, a)) x0 = kNegFill;
            if (!visible(p, qp1, a)) x1 = kNegFill;
          }
        }
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
      }
    // online max and sum; the 4 lanes of a row are lane ^ 1, lane ^ 2
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum0 += exp2f(s[4 * j] - mx0) + exp2f(s[4 * j + 1] - mx0);
      sum1 += exp2f(s[4 * j + 2] - mx1) + exp2f(s[4 * j + 3] - mx1);
    }
    l0 = l0 * exp2f(m0 - mx0) + sum0;
    l1 = l1 * exp2f(m1 - mx1) + sum1;
    m0 = mx0;
    m1 = mx1;
    __syncthreads();  // this stage's K tile and positions are consumed
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const long long bh = static_cast<long long>(b) * a.Hkv + hk;
  if (lane % 4 == 0) {
    if (r0 < R) {
      a.stats[(bh * R + r0) * 2] = m0;
      a.stats[(bh * R + r0) * 2 + 1] = l0;
    }
    if (r1 < R) {
      a.stats[(bh * R + r1) * 2] = m1;
      a.stats[(bh * R + r1) * 2 + 1] = l1;
    }
  }

  // delta: two threads a row, each over half of D, then their sum
  const int r = row0 + tid / 2, half = tid % 2;
  float part = 0.f;
  if (r < R) {
    const int s = r / g, h = hk * g + r % g;
    const long long off =
        ((static_cast<long long>(b) * a.Sq + s) * a.H + h) * D + half * (D / 2);
    const uint4* po = reinterpret_cast<const uint4*>(a.o + off);
    const uint4* pd = reinterpret_cast<const uint4*>(a.dout + off);
#pragma unroll 4
    for (int c = 0; c < D / 16; ++c) part = dot8(pd[c], po[c], part);
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  if (r < R && half == 0) a.delta[bh * R + r] = part;
}

// ---------------------------------------------------------------------------
// 2. dK/dV: per key tile (and row split), dV = P^T dO and dK = scale dS^T Q
//    over its share of the row tiles
// ---------------------------------------------------------------------------
template <int D>
struct DkdvLayout {
  static constexpr int kTB = Cfg<D>::kTileBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kTB;
  static constexpr int kRing = 2 * kTB;        // [2] stages: Q tile, dO tile
  static constexpr int kRows = kRing + 4 * kTB;  // [2] stages: m, 1/l, delta, q_pos
  static constexpr int kUniform = kRows + 2 * 4 * kTile * 4;  // u32 [2][2]
  static constexpr int kBar = kUniform + 16;       // kv, full[2]
  static constexpr int kAlloc = kBar + 24 + 1024;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using C = Cfg<D>;
  using L = DkdvLayout<D>;
  constexpr int NT = C::kThreads, DW = C::kDW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sbase;
  const uint32_t base = aligned_base(smem_raw, &sbase);
  float* const rows = reinterpret_cast<float*>(sbase + L::kRows);
  uint32_t* const uniform = reinterpret_cast<uint32_t*>(sbase + L::kUniform);
  const uint32_t bar_kv = base + L::kBar, bar_full = bar_kv + 8;
  const int c0 = blockIdx.x * kTile, hk = blockIdx.y;
  const int b = blockIdx.z / a.n_split, part = blockIdx.z % a.n_split;
  const int g = a.g, R = a.Sq * g, n_rt = (R + kTile - 1) / kTile;
  const int c1 = min(c0 + kTile, a.T);
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, wq = (tid / 32) % 4;
  const long long bh = static_cast<long long>(b) * a.Hkv + hk;

  // the row tiles that can see a key of this tile, [first, last], and this
  // part's even share of them
  int first = n_rt, last = -1;
  for (int rt = 0; rt < n_rt; ++rt)
    if (tile_visits(a, rt, c0, c1)) {
      first = min(first, rt);
      last = rt;
    }
  const long long n = last >= first ? last - first + 1 : 0;
  const int rt_lo = first + static_cast<int>(n * part / a.n_split);
  const int rt_hi = first + static_cast<int>(n * (part + 1) / a.n_split);
  auto next = [&](int rt) {
    while (rt < rt_hi && !tile_visits(a, rt, c0, c1)) ++rt;
    return rt;
  };
  // the copies of row tile rt into ring stage st: Q and dO (TMA by thread
  // 0, or cp.async by all as one group), and each row's m, 1/l, delta and
  // position and the rows that see no key (the first 64 threads, warps 0
  // and 1, a bit a row); a row past R gets 1/l = 0: its P and dS are 0
  auto issue = [&](int st, int rt) {
    const int row0 = rt * kTile;
    const uint32_t dst = base + L::kRing + st * 2 * C::kTileBytes;
    if (a.q_tma) {
      if (tid == 0)
        tma_rows<D>(&tm_q, &tm_do, dst, bar_full + 8 * st, row0, hk, b, g);
    } else {
      load_rows_async<D, NT>(dst, a.q, a.q_sb, a.q_ss, a.q_sh, b, hk, row0,
                             a);
      load_rows_async<D, NT>(dst + C::kTileBytes, a.dout,
                             static_cast<long long>(a.Sq) * a.H * D,
                             static_cast<long long>(a.H) * D, D, b, hk, row0,
                             a);
      cp_async_commit();
    }
    if (tid < kTile) {
      float* rs = rows + st * 4 * kTile;
      const int row = row0 + tid;
      const bool ok = row < R;
      rs[tid] = ok ? a.stats[(bh * R + row) * 2] : 0.f;
      rs[kTile + tid] =
          ok ? 1.f / fmaxf(a.stats[(bh * R + row) * 2 + 1], 1e-30f) : 0.f;
      rs[2 * kTile + tid] = ok ? a.delta[bh * R + row] : 0.f;
      reinterpret_cast<int*>(rs)[3 * kTile + tid] = a.q_offset + row / g;
      const uint32_t none_seen =
          __ballot_sync(0xffffffffu, ok && rs[tid] == kNegFill);
      if (lane == 0) uniform[2 * st + tid / 32] = none_seen;
    }
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_full, 1);
    mbar_init(bar_full + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * C::kTileBytes);
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load_4d(base + L::kK + p * kPanelBytes, &tm_k, bar_kv, p * kPanel,
                  hk, c0, b);
      tma_load_4d(base + L::kV + p * kPanelBytes, &tm_v, bar_kv, p * kPanel,
                  hk, c0, b);
    }
  }
  int rt = next(rt_lo);
  if (rt < rt_hi) issue(0, rt);
  mbar_wait(bar_kv, 0);
  __syncthreads();  // stage 0's row values

  // this thread's two keys (C-fragment rows of S^T) and its row columns
  // kq, kq + 1 of every 8
  const int k0 = c0 + 16 * wq + lane / 4, k1 = k0 + 8;
  const int pk0 = key_pos(a, k0), pk1 = key_pos(a, k1);
  const int kq = (lane % 4) * 2;
  float dk[DW / 2], dv[DW / 2];
  zero(dk);
  zero(dv);
  for (int it = 0; rt < rt_hi; ++it) {
    const int st = it & 1;
    const int nxt = next(rt + 1);
    if (nxt < rt_hi) issue(st ^ 1, nxt);
    else if (!a.q_tma) cp_async_commit();  // an empty group: wait<1> below
    if (a.q_tma) {
      mbar_wait(bar_full + 8 * st, (it >> 1) & 1);
    } else {
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();
    }
    const uint32_t tq = base + L::kRing + st * 2 * C::kTileBytes;
    const uint32_t tdo = tq + C::kTileBytes;
    int qa, qb;
    tile_positions(a, rt * kTile, qa, qb);
    const bool mask = !tile_all_seen(a, qa, qb, c0);
    const float* rs = rows + st * 4 * kTile;
    const int* rq = reinterpret_cast<const int*>(rs) + 3 * kTile;
    const int p0 = wg * (DW / kPanel);  // this warpgroup's output panels
    // the tile's 64 rows as two halves of 32 (two k-steps of dV and dK
    // each): S^T and dP^T of a half, 32 registers, and its split P and dS,
    // 32 more, are all that is held beside dK and dV
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[16], dp[16];
      zero(s);
      zero(dp);
      wgmma_fence();
      product_ss<D, 32>(s, base + L::kK, tq + half * 32 * 128);   // S^T
      product_ss<D, 32>(dp, base + L::kV, tdo + half * 32 * 128); // dP^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 32 * half + 8 * j + kq + e;
          const float m = rs[c], dl = rs[2 * kTile + c];
          // a row that sees no key takes no part here (below)
          const float il = m == kNegFill ? 0.f : rs[kTile + c];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            float x = s[i] * a.scale_log2;
            bool seen = true;
            if (mask) {
              const int pk = h ? pk1 : pk0;
              if (pk == kAbsent) {
                x = neg_inf();
                seen = false;
              } else if (!visible(pk, rq[c], a)) {
                x = kNegFill;
                seen = false;
              }
            }
            const float p = exp2f(x - m) * il;
            s[i] = p;
            dp[i] = seen ? p * (dp[i] - dl) : 0.f;
          }
        }
      uint32_t ph[2][4], pl[2][4], dh[2][4], dlo[2][4];
      split_fragment(s, ph, pl);
      split_fragment(dp, dh, dlo);
      wgmma_fence();
      product_rs<DW>(dv, ph, pl, tdo, p0, 2 * half);  // dV += P^T dO
      product_rs<DW>(dk, dh, dlo, tq, p0, 2 * half);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(dh);
      fence_regs(dlo);
    }
    // rows that see no key (m = the fill): P = 1/l on each key < T, exactly
    // as the plain version forms it, added to dV in float32 on the CUDA
    // cores (one bf16 P pair would give all of a row's terms the same
    // relative error, which a sum of them keeps)
    for (int half = 0; half < 2; ++half) {
      uint32_t bits = uniform[2 * st + half];
      while (bits != 0u) {
        const int r = 32 * half + __ffs(bits) - 1;
        bits &= bits - 1u;
        const float w = rs[kTile + r];
        const uint8_t* row = sbase + (tdo - base) + r * 128;
#pragma unroll
        for (int j = 0; j < DW / 8; ++j) {
          const int col = wg * DW + 8 * j + kq;
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
              row + (col / kPanel) * kPanelBytes +
              ((((col % kPanel) / 8) ^ (r % 8)) * 16) + (col % 8) * 2);
          const float2 f = __bfloat1622float2(x);
          if (k0 < a.T) {
            dv[4 * j] = fmaf(w, f.x, dv[4 * j]);
            dv[4 * j + 1] = fmaf(w, f.y, dv[4 * j + 1]);
          }
          if (k1 < a.T) {
            dv[4 * j + 2] = fmaf(w, f.x, dv[4 * j + 2]);
            dv[4 * j + 3] = fmaf(w, f.y, dv[4 * j + 3]);
          }
        }
      }
    }
    __syncthreads();  // this stage's tiles and row values are consumed
    rt = nxt;
  }

  // keys k0, k1 (rows of the C fragment), columns wg * DW + 8j + kq, + 1
  const long long n_out = static_cast<long long>(a.B) * a.T * a.Hkv * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = h ? k1 : k0;
    if (key >= a.T) continue;
    const long long row = ((static_cast<long long>(b) * a.T + key) * a.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      const int col = wg * DW + 8 * j + kq;
      const float k_lo = dk[4 * j + 2 * h] * a.scale;
      const float k_hi = dk[4 * j + 2 * h + 1] * a.scale;
      const float v_lo = dv[4 * j + 2 * h], v_hi = dv[4 * j + 2 * h + 1];
      if (a.n_split == 1) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + row + col) =
            __floats2bfloat162_rn(k_lo, k_hi);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + row + col) =
            __floats2bfloat162_rn(v_lo, v_hi);
      } else {
        const long long at = part * n_out + row + col;
        *reinterpret_cast<float2*>(a.dk_part + at) = make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(a.dv_part + at) = make_float2(v_lo, v_hi);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: per row tile, dQ = scale dS K over the key tiles its rows see
// ---------------------------------------------------------------------------
template <int D>
struct DqLayout {
  static constexpr int kTB = Cfg<D>::kTileBytes;
  static constexpr int kQ = 0;
  static constexpr int kDo = kTB;
  static constexpr int kRing = 2 * kTB;        // [2] stages: K tile, V tile
  static constexpr int kPos = kRing + 4 * kTB; // int [2][64]
  static constexpr int kBar = kPos + 2 * kTile * 4;  // q, full[2]
  static constexpr int kAlloc = kBar + 24 + 1024;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using C = Cfg<D>;
  using L = DqLayout<D>;
  constexpr int NT = C::kThreads, DW = C::kDW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sbase;
  const uint32_t base = aligned_base(smem_raw, &sbase);
  int* const kpos = reinterpret_cast<int*>(sbase + L::kPos);
  const uint32_t bar_q = base + L::kBar, bar_full = bar_q + 8;
  const int row0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.g, R = a.Sq * g;
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, wq = (tid / 32) % 4;
  const long long bh = static_cast<long long>(b) * a.Hkv + hk;
  int qa, qb, t_lo, t_hi;
  tile_positions(a, row0, qa, qb);
  key_range(a, qa, qb, false, t_lo, t_hi);  // a row that sees no key: dS 0
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + kTile - 1) / kTile : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_full, 1);
    mbar_init(bar_full + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && a.q_tma)
    tma_rows<D>(&tm_q, &tm_do, base + L::kQ, bar_q, row0, hk, b, g);
  if (n_tiles > 0)
    load_keys<D>(&tm_k, &tm_v, base + L::kRing, bar_full, kpos, t_lo, hk, b,
                 a);
  if (a.q_tma) {
    mbar_wait(bar_q, 0);
  } else {
    load_rows_async<D, NT>(base + L::kQ, a.q, a.q_sb, a.q_ss, a.q_sh, b, hk,
                           row0, a);
    load_rows_async<D, NT>(base + L::kDo, a.dout,
                           static_cast<long long>(a.Sq) * a.H * D,
                           static_cast<long long>(a.H) * D, D, b, hk, row0, a);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
  }
  __syncthreads();

  // this thread's two rows and their m, 1/l, delta, position (a row past R:
  // 1/l = 0, so dS = 0)
  const int r0 = row0 + 16 * wq + lane / 4;
  float m[2], il[2], dl[2];
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const bool ok = row < R;
    m[h] = ok ? a.stats[(bh * R + row) * 2] : 0.f;
    il[h] = ok ? 1.f / fmaxf(a.stats[(bh * R + row) * 2 + 1], 1e-30f) : 0.f;
    dl[h] = ok ? a.delta[bh * R + row] : 0.f;
    qp[h] = a.q_offset + row / g;
  }
  const int kq = (lane % 4) * 2;
  float acc[DW / 2];
  zero(acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, col0 = t_lo + it * kTile;
    if (it + 1 < n_tiles)
      load_keys<D>(&tm_k, &tm_v, base + L::kRing + (st ^ 1) * 2 * C::kTileBytes,
                   bar_full + 8 * (st ^ 1), kpos + (st ^ 1) * kTile,
                   col0 + kTile, hk, b, a);
    mbar_wait(bar_full + 8 * st, (it >> 1) & 1);
    const uint32_t tk = base + L::kRing + st * 2 * C::kTileBytes;
    const uint32_t tv = tk + C::kTileBytes;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wgmma_fence();
    product_ss<D>(s, base + L::kQ, tk);    // S = Q K^T
    product_ss<D>(dp, base + L::kDo, tv);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const bool mask = !tile_all_seen(a, qa, qb, col0);
    const int* kp = kpos + st * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pk = kp[8 * j + kq + e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const bool seen =
              !mask || (pk != kAbsent && visible(pk, qp[h], a));
          dp[i] = seen ? exp2f(s[i] * a.scale_log2 - m[h]) * il[h] *
                             (dp[i] - dl[h])
                       : 0.f;
        }
      }
    uint32_t dh[4][4], dlo[4][4];
    split_fragment(dp, dh, dlo);
    wgmma_fence();
    product_rs<DW>(acc, dh, dlo, tk, wg * (DW / kPanel));  // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(dh);
    fence_regs(dlo);
    __syncthreads();  // this stage's K, V and positions are consumed
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= R) continue;
    const int s = row / g, head = hk * g + row % g;
    __nv_bfloat16* out =
        a.dq + ((static_cast<long long>(b) * a.Sq + s) * a.H + head) * D;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + wg * DW + 8 * j + kq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * a.scale,
                                acc[4 * j + 2 * h + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// 4. the row splits' partial dK and dV summed in split order, rounded once
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
    bwd_reduce_kernel(const float* __restrict__ dk_part,
                      const float* __restrict__ dv_part,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, long long n,
                      int n_split) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x * 4;
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) * 4;
       i < n; i += stride) {
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int p = 0; p < n_split; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(dk_part + p * n + i);
      const float4 y = *reinterpret_cast<const float4*>(dv_part + p * n + i);
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + i);
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + i);
    ok[0] = __floats2bfloat162_rn(sk.x, sk.y);
    ok[1] = __floats2bfloat162_rn(sk.z, sk.w);
    ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
    ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
  }
}

// ---- host side ---------------------------------------------------------------
// a bf16 (B, steps, heads, D) tensor read through element strides, as a
// 4-D map over (D, heads, steps, B) with a box of 64 x box_heads x
// box_steps x 1 and the 128-byte swizzle (flash_prefill_sm90.cu's maps)
cudaError_t encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
                   int heads, int steps, int batch, long long s_h,
                   long long s_s, long long s_b, int box_heads,
                   int box_steps) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads),
                              cuuint64_t(steps), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(s_h) * 2, cuuint64_t(s_s) * 2,
                                 cuuint64_t(s_b) * 2};
  const cuuint32_t box[4] = {cuuint32_t(kPanel), cuuint32_t(box_heads),
                             cuuint32_t(box_steps), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
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

struct Maps {
  CUtensorMap q, dout, k, v;
};

template <int D>
cudaError_t launch(const Maps& m, const Args& a, cudaStream_t stream) {
  using C = Cfg<D>;
  static int prep_for = -1, dkdv_for = -1, dq_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_prep_kernel<D>, PrepLayout<D>::kAlloc, dev, prep_for);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_dkdv_kernel<D>, DkdvLayout<D>::kAlloc, dev, dkdv_for);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_dq_kernel<D>, DqLayout<D>::kAlloc, dev, dq_for);
  if (err != cudaSuccess) return err;
  const int R = a.Sq * a.g;
  const dim3 rows((R + kTile - 1) / kTile, a.Hkv, a.B);
  const dim3 keys((a.T + kTile - 1) / kTile, a.Hkv, a.B * a.n_split);
  bwd_prep_kernel<D><<<rows, 128, PrepLayout<D>::kAlloc, stream>>>(m.q, m.k,
                                                                   a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<D><<<keys, C::kThreads, DkdvLayout<D>::kAlloc, stream>>>(
      m.q, m.dout, m.k, m.v, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<D><<<rows, C::kThreads, DqLayout<D>::kAlloc, stream>>>(
      m.q, m.dout, m.k, m.v, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  const long long n = static_cast<long long>(a.B) * a.T * a.Hkv * D;
  const long long blocks = (n / 4 + 255) / 256;
  bwd_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                      256, 0, stream>>>(a.dk_part, a.dv_part, a.dk, a.dv, n,
                                        a.n_split);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, D), k, v: (B, T, Hkv, D) bf16, read through the element
// strides strides[0..8] = q's (b, s, h), k's (b, t, h), v's (b, t, h) (a
// host array; the last dimension has stride 1); o, dout: contiguous
// (B, Sq, H, D) bf16; dq: contiguous (B, Sq, H, D); dk, dv: contiguous
// (B, T, Hkv, D), bf16. stats: float32 scratch of B * Hkv * Sq * (H / Hkv)
// * 2, delta of B * Hkv * Sq * (H / Hkv); with n_split > 1, dk_part and
// dv_part: float32 scratch of n_split * B * T * Hkv * D each (else
// unused). kv_pos: (T,) int32 on the device or null. D is 64, 128 or 256,
// H % Hkv == 0; base addresses 16-byte aligned and strides multiples of 8
// elements (TMA's rule). Three launches, four with n_split > 1, on `stream`
// without synchronising; returns the first nonzero cudaError_t (0 = all
// launched).
extern "C" int flash_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const int32_t* kv_pos,
    const long long* strides, int B, int Sq, int T, int H, int Hkv, int D,
    int causal, int window, int q_offset, float scale, int n_split,
    float* stats, float* delta, float* dk_part, float* dv_part, int device,
    void* stream) {
  if ((D != 64 && D != 128 && D != 256) || Hkv <= 0 || H % Hkv != 0 ||
      B <= 0 || Sq <= 0 || T <= 0 || n_split < 1 || B * n_split > 65535 ||
      (n_split > 1 && (dk_part == nullptr || dv_part == nullptr)) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      !aligned16(dout) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  EncodeTiled fn = nullptr;
  err = encoder(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int g = H / Hkv;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dk_part = dk_part;
  a.dv_part = dv_part;
  a.stats = stats;
  a.delta = delta;
  a.kv_pos = kv_pos;
  a.q_sb = strides[0];
  a.q_ss = strides[1];
  a.q_sh = strides[2];
  a.B = B;
  a.Sq = Sq;
  a.T = T;
  a.H = H;
  a.Hkv = Hkv;
  a.g = g;
  a.n_split = n_split;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.q_tma = kTile % g == 0;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;

  Maps m;
  std::memset(&m, 0, sizeof(m));
  const long long dh = D, ds = static_cast<long long>(H) * D,
                  db = static_cast<long long>(Sq) * H * D;
  if (a.q_tma) {
    err = encode(fn, &m.q, q, D, H, Sq, B, strides[2], strides[1], strides[0],
                 g, kTile / g);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = encode(fn, &m.dout, dout, D, H, Sq, B, dh, ds, db, g, kTile / g);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = encode(fn, &m.k, k, D, Hkv, T, B, strides[5], strides[4], strides[3],
               1, kTile);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = encode(fn, &m.v, v, D, Hkv, T, B, strides[8], strides[7], strides[6],
               1, kTile);
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) err = launch<64>(m, a, st);
  else if (D == 128) err = launch<128>(m, a, st);
  else err = launch<256>(m, a, st);
  return static_cast<int>(err);
}
