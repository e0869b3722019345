// The gradient of grouped-head attention on Hopper's TF32 tensor cores at
// float32 accuracy: dQ, dK and dV of every float32 attention backward at
// head dims 64, 128 and 256 (kernels/flash_attention.py::bwd_launch_plan's
// "tc32" route; bf16 takes flash_backward_sm90.cu, float32 at other head
// dims flash_backward.cu on the CUDA cores).
//
// Replaces: nothing on the TPU. The JAX package differentiates its plain
// attention region, src/repro/models/layers.py:134, gqa_scores_chunked,
// with autograd (its Pallas kernel, src/repro/kernels/flash_attention.py:77,
// has no backward). The function is flash_backward.cu's, unchanged: for q
// (B, Sq, H, D), k, v (B, T, Hkv, D), query head h reads KV head h / g;
//   s_c = scale q.k_c, or the fill -1e30 where key c is not seen; P =
//   softmax(s); delta = sum_d dO.O; dS_c = P_c (dO.v_c - delta) where c is
//   seen, 0 where it is masked; dQ = scale sum_c dS_c k_c, dK_c = scale
//   sum_q dS_c q, dV_c = sum_q P_c dO.
// A row with no visible key has a uniform P over the T keys, as in the
// reference: its dV share is dO / T and its dS 0.
//
// What bounds it on an H100: at qwen3-0.6b's training shape (B 4, S = T
// 2048, H 16, Hkv 8, D 128, causal) the five products (S, dP, dV, dK, dQ)
// are 172 GFLOP; as three TF32 products each, 516 GFLOP at 494.7 TFLOP/s,
// 1.04 ms, against 201 MB of float32 operands and gradients: operations
// bound it. This kernel issues S twice more (in dK/dV and in dQ, beside the
// statistics pass) and dP twice.
//
// Precision: 3xTF32 with partial sums (flash_sm90_f32.cuh): S and dP over
// D in 32-deep chunks; dV and dK per step of the row walk, dQ per key
// tile, each a fresh partial added to its float32 total. A row that sees
// no key has P = 1/l on every key: it takes no part in the products, and
// its dV share is added in float32 on the CUDA cores.
//
// Design: outputs are computed transposed (dV^T, dK^T, dQ^T: D x keys or
// D x rows), so that every operand of a product is either a tile staged
// as it arrives (split in place) or a result written from an accumulator
// fragment as B (P, dS): no tile is copied transposed. Three launches, and
// a fourth that sums the dK/dV row walk's split parts; no atomics, so two
// calls give the same bits. Rows packed as in the forward, r = s*g + h%g.
//   1. prep, one warpgroup per (64 rows, KV head, batch): S = Q K^T over
//      the key tiles of kBN (A = Q raw, split on the fly; K by TMA into a
//      ring, split in place); each row's max m (base 2, the scale folded
//      with log2 e) and sum l, kept apart (a row whose scores are all the
//      fill has m = -1e30 and l = T); delta = dO.O in float32.
//   2. dK/dV, two warpgroups per (64 keys, KV head, batch, row split): K
//      and V raw stay in shared memory; the block walks its share of the
//      steps of kRS rows that see a key of its tile, Q and dO streamed by
//      TMA into a ring of kStages, split in place (the next step while this
//      one's dV and dK products run). Warpgroup 0 takes S^T = K Q^T (A = K,
//      B = Q), warpgroup 1 dP^T = V dO^T; the two fragments are handed
//      over through shared memory, each warpgroup forms P^T and dS^T for
//      half of the step's rows into shared memory as hi/lo, then
//      warpgroup 0 takes dV^T += dO^T P (A = dO^T read across dO's tiles,
//      B = P^T) and warpgroup 1 dK^T += Q^T dS. When B * Hkv * (T/64) is
//      under the card's 132 SMs the walk is split into n_split parts
//      written as float32 partials, and
//   4. a reduction sums the parts in a fixed order.
//   3. dQ, two warpgroups per (64 rows, KV head, batch): Q and dO raw stay;
//      K and V streamed in tiles of kBN; warpgroup 0 takes S (A = Q, B = K),
//      warpgroup 1 dP (A = dO, B = V), each forms dS for half of the keys
//      into shared memory; then each takes dQ^T += K^T dS^T for 32 of the
//      rows (A = K^T read across K's tiles).
// Byte budget (shared memory; kRS = kBN = 32 and two stages at D 64 and
// 128, 16 and one stage at D 256): prep 64 x D x 4 (Q) + kStages x 2 x kBN
// x D x 4 (K hi, lo); dK/dV 2 x 64 x D x 4 (K, V) + kStages x 4 x kRS x D x
// 4 (Q hi, lo, dO hi, lo) + 4 x 8 KB (P^T, dS^T hi, lo) = 224 KB at D 128
// and 256; dQ 2 x 64 x D x 4 + kStages x 4 x kBN x D x 4 + 16 KB (dS hi,
// lo) = 208 KB at D 128 and 256. The fragments handed between the
// warpgroups lie over the P^T or dS tiles before those are written.
// Registers: dV^T or dK^T 32 a 64 rows of D, a product's partial and two
// chunks' A fragments; at D 256 (accumulators 128) ptxas spills a few in
// dK/dV (chip_smoke.py's [build] lines).
// Which tiles are visited: a row at query position q sees the keys
// [max(0, q - window + 1), min(T, q + 1)) when key positions are the
// indices, all keys when positions are given or that range is empty (the
// uniform row); a block visits the hull of its rows' ranges and masks
// inside it.
#include <cstdint>
#include <cstring>

#include "flash_sm90_f32.cuh"

namespace {

using namespace f32sm90;

constexpr int kTile = 64;  // keys of a dK/dV block, rows of a prep/dQ block

template <int D>
struct Cfg {
  static constexpr int kRS = D == 256 ? 16 : 32;  // rows a dK/dV walk step
  static constexpr int kBN = D == 256 ? 16 : 32;  // keys a prep/dQ tile
  static constexpr int kStages = D == 256 ? 1 : 2;
  static constexpr int kMT = D / 64;              // D's m-tiles of 64
  static constexpr int kRaw = kTile * D * 4;      // a 64-row raw tile
  static constexpr int kKB = kBN * D * 4;         // a key tile, hi or lo
  static constexpr int kRB = kRS * D * 4;         // a row step, hi or lo
};

struct Args {
  const float* q;      // (B, Sq, H, D) through q_s*
  const float* o;      // contiguous (B, Sq, H, D)
  const float* dout;   // contiguous (B, Sq, H, D)
  float* dq;           // contiguous (B, Sq, H, D)
  float* dk;           // contiguous (B, T, Hkv, D)
  float* dv;
  float* dk_part;      // (n_split, B, T, Hkv, D) when n_split > 1
  float* dv_part;
  float* stats;        // (B, Hkv, Sq*g, 2): m (base 2), l
  float* delta;        // (B, Hkv, Sq*g)
  long long q_sb, q_ss, q_sh;
  int B, Sq, H, Hkv, n_split;
  int q_tma_tile, q_tma_step;  // g divides 64 / kRS: Q and dO by TMA
  float scale, scale_log2;
  Mask mk;
};

// a load issued where it stands: the compiler may not sink it towards its
// use (the asm is volatile, as the wgmma instructions after it are)
__device__ __forceinline__ float ld_early(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// Q (and dO) rows [row0, row0 + 64) of a prep or dQ block into their raw
// tiles: by TMA where g divides 64, else by plain loads (NT threads)
template <int D, int NT>
__device__ __forceinline__ void load_row_tiles(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do, uint8_t* sb,
    uint32_t base, int q_off, int do_off, uint32_t bar, int row0, int hk,
    int b, const Args& a) {
  if (a.q_tma_tile) {
    if (threadIdx.x == 0)
      tma_rows<D>(tm_q, tm_do, base + q_off, base + do_off, bar, row0, kTile,
                  hk, b, a.mk.g);
    mbar_wait(bar, 0);
  } else {
    load_rows<D, NT>(sb + q_off, a.q, a.q_sb, a.q_ss, a.q_sh, b, hk, row0,
                     kTile, a.mk);
    if (tm_do != nullptr)
      load_rows<D, NT>(sb + do_off, a.dout,
                       static_cast<long long>(a.Sq) * a.H * D,
                       static_cast<long long>(a.H) * D, D, b, hk, row0,
                       kTile, a.mk);
  }
}

// ---------------------------------------------------------------------------
// 1. prep: each row's m (base 2) and l over the keys it visits; delta
// ---------------------------------------------------------------------------
template <int D>
struct PrepLayout {
  using C = Cfg<D>;
  static constexpr int kQ = 0;
  static constexpr int kRing = C::kRaw;                      // [stage] K hi, lo
  static constexpr int kBar = kRing + C::kStages * 2 * C::kKB;  // q, full[]
  static constexpr int kAlloc = kBar + 8 * (1 + C::kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(128, 1)
    bwd_prep_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ Args a) {
  using C = Cfg<D>;
  using L = PrepLayout<D>;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sb;
  const uint32_t base = aligned_base(smem_raw, &sb);
  const uint32_t bar_q = base + L::kBar, bar_full = bar_q + 8;
  const Mask& mk = a.mk;
  const int row0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int g = mk.g, R = mk.R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int qa, qb, t_lo, t_hi;
  mk.positions(row0, kTile, qa, qb);
  mk.key_range(qa, qb, true, kBN, t_lo, t_hi);
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + kBN - 1) / kBN : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](int it) {  // thread 0: key tile it into its stage
    const int st = it % C::kStages;
    tma_keys<D>(&tm_k, nullptr, base + L::kRing + st * 2 * C::kKB, 0,
                bar_full + 8 * st, t_lo + it * kBN, kBN, hk, b);
  };
  if (tid == 0)
    for (int it = 0; it < min(C::kStages, n_tiles); ++it) load(it);
  load_row_tiles<D, 128>(&tm_q, nullptr, sb, base, L::kQ, 0, bar_q, row0, hk,
                         b, a);
  __syncthreads();

  const int r0 = row0 + 16 * warp + lane / 4, r1 = r0 + 8;
  const int qp0 = mk.q_offset + r0 / g, qp1 = mk.q_offset + r1 / g;
  const int kq = (lane % 4) * 2;
  float m0 = kNegFill, m1 = kNegFill, l0 = 0.f, l1 = 0.f;
  // key tile j's K, once arrived, split in place; with two stages tile j +
  // 1 is split while tile j's last chunk of S runs
  auto split_stage = [&](int j) {
    uint8_t* const kt = sb + L::kRing + (j % C::kStages) * 2 * C::kKB;
    mbar_wait(bar_full + 8 * (j % C::kStages), (j / C::kStages) & 1);
    split_tile<128>(kt, kt + C::kKB, C::kKB);
  };
  constexpr bool kAhead = C::kStages > 1;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % C::kStages, col0 = t_lo + it * kBN;
    if (!kAhead || it == 0) {
      split_stage(it);
      fence_proxy_async();
      __syncthreads();
    }
    float s[kBN / 2];
    const uint32_t k_hi = base + L::kRing + st * 2 * C::kKB;
    dots<kBN, D>(s, sb + L::kQ, kTile, 0, k_hi, k_hi + C::kKB, [&] {
      if (kAhead && it + 1 < n_tiles) split_stage(it + 1);
    });
    const bool mask = !mk.all_seen(qa, qb, col0, kBN);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * j + e] * a.scale_log2;
        float x1 = s[4 * j + 2 + e] * a.scale_log2;
        if (mask) {
          const int p = mk.key_pos(col0 + 8 * j + kq + e);
          if (p == kAbsent) {
            x0 = x1 = neg_inf();
          } else {
            if (!mk.visible(p, qp0)) x0 = kNegFill;
            if (!mk.visible(p, qp1)) x1 = kNegFill;
          }
        }
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
      }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
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
    for (int j = 0; j < kBN / 8; ++j) {
      sum0 += exp2f(s[4 * j] - mx0) + exp2f(s[4 * j + 1] - mx0);
      sum1 += exp2f(s[4 * j + 2] - mx1) + exp2f(s[4 * j + 3] - mx1);
    }
    l0 = l0 * exp2f(m0 - mx0) + sum0;
    l1 = l1 * exp2f(m1 - mx1) + sum1;
    m0 = mx0;
    m1 = mx1;
    fence_proxy_async();
    __syncthreads();  // this stage is consumed
    if (tid == 0 && it + C::kStages < n_tiles) load(it + C::kStages);
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
  // delta: two threads a row, each over half of D in order, then their sum
  const int r = row0 + tid / 2, half = tid % 2;
  float part = 0.f;
  if (r < R) {
    const int s = r / g, h = hk * g + r % g;
    const long long off =
        ((static_cast<long long>(b) * a.Sq + s) * a.H + h) * D + half * (D / 2);
    const float4* po = reinterpret_cast<const float4*>(a.o + off);
    const float4* pd = reinterpret_cast<const float4*>(a.dout + off);
#pragma unroll 4
    for (int c = 0; c < D / 8; ++c) {
      const float4 x = pd[c], y = po[c];
      part = fmaf(x.x, y.x, part);
      part = fmaf(x.y, y.y, part);
      part = fmaf(x.z, y.z, part);
      part = fmaf(x.w, y.w, part);
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  if (r < R && half == 0) a.delta[bh * R + r] = part;
}

// ---------------------------------------------------------------------------
// 2. dK/dV: per key tile (and row split), dV^T = dO^T P and dK^T = scale
//    Q^T dS over its share of the row walk
// ---------------------------------------------------------------------------
template <int D>
struct DkdvLayout {
  using C = Cfg<D>;
  static constexpr int kK = 0;                 // K raw [64][D]
  static constexpr int kV = C::kRaw;           // V raw
  static constexpr int kRing = 2 * C::kRaw;    // [stage] Q hi, lo, dO hi, lo
  static constexpr int kB = kRing + C::kStages * 4 * C::kRB;  // P^T hi, lo,
                                               // dS^T hi, lo: [64][32] each
  static constexpr int kRows = kB + 4 * kTile * 128;  // [stage] m, 1/l,
                                               // delta, q_pos: [kRS] each
  static constexpr int kUniform = kRows + C::kStages * 4 * C::kRS * 4;
  static constexpr int kBar = kUniform + 8 * C::kStages;  // kv, full[]
  static constexpr int kAlloc = kBar + 8 * (1 + C::kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(256, 1)
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ Args a) {
  using C = Cfg<D>;
  using L = DkdvLayout<D>;
  constexpr int kRS = C::kRS, kKS = kRS / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sb;
  const uint32_t base = aligned_base(smem_raw, &sb);
  float* const rows = reinterpret_cast<float*>(sb + L::kRows);
  uint32_t* const uniform = reinterpret_cast<uint32_t*>(sb + L::kUniform);
  // S^T and dP^T handed between the warpgroups, [2][kRS / 2][128], over the
  // P^T and dS^T tiles
  float* const xfer = reinterpret_cast<float*>(sb + L::kB);
  const uint32_t bar_kv = base + L::kBar, bar_full = bar_kv + 8;
  const Mask& mk = a.mk;
  const int c0 = blockIdx.x * kTile, hk = blockIdx.y;
  const int b = blockIdx.z / a.n_split, part = blockIdx.z % a.n_split;
  const int g = mk.g, R = mk.R, n_rs = (R + kRS - 1) / kRS;
  const int c1 = min(c0 + kTile, mk.T);
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, wq = (tid / 32) % 4;
  const long long bh = static_cast<long long>(b) * a.Hkv + hk;

  // the row steps that can see a key of this tile, [first, last], and this
  // part's even share of them
  int first = n_rs, last = -1;
  for (int rs = 0; rs < n_rs; ++rs)
    if (mk.rows_visit(rs * kRS, kRS, c0, c1)) {
      first = min(first, rs);
      last = rs;
    }
  const long long n = last >= first ? last - first + 1 : 0;
  const int rs_lo = first + static_cast<int>(n * part / a.n_split);
  const int rs_hi = first + static_cast<int>(n * (part + 1) / a.n_split);
  auto next = [&](int rs) {
    while (rs < rs_hi && !mk.rows_visit(rs * kRS, kRS, c0, c1)) ++rs;
    return rs;
  };
  // each row's m, l and delta of row step rs into registers of the first
  // kRS threads, a step before they are stored (the loads' latency hidden
  // behind that step's products)
  auto fetch = [&](int rs, float (&v)[3]) {
    const int row = rs * kRS + tid;
    v[0] = v[1] = v[2] = 0.f;
    if (tid < kRS && rs < rs_hi && row < R) {
      v[0] = ld_early(a.stats + (bh * R + row) * 2);
      v[1] = ld_early(a.stats + (bh * R + row) * 2 + 1);
      v[2] = ld_early(a.delta + bh * R + row);
    }
  };
  // row step rs into ring stage st: Q and dO by TMA (thread 0) where g
  // divides kRS, and each row's m, 1/l, delta and position (from `fetch`)
  // and the rows that see no key (warp 0, a bit a row); a row past R gets
  // 1/l = 0
  auto issue = [&](int st, int rs, const float (&v)[3]) {
    const int row0 = rs * kRS;
    if (a.q_tma_step && tid == 0) {
      const uint32_t dst = base + L::kRing + st * 4 * C::kRB;
      tma_rows<D>(&tm_q, &tm_do, dst, dst + 2 * C::kRB, bar_full + 8 * st,
                  row0, kRS, hk, b, g);
    }
    if (tid < 32) {
      float* rv = rows + st * 4 * kRS;
      const int row = row0 + tid;
      const bool ok = tid < kRS && row < R;
      if (tid < kRS) {
        rv[tid] = v[0];
        rv[kRS + tid] = ok ? 1.f / fmaxf(v[1], 1e-30f) : 0.f;
        rv[2 * kRS + tid] = v[2];
        reinterpret_cast<int*>(rv)[3 * kRS + tid] = mk.q_offset + row / g;
      }
      const uint32_t none_seen =
          __ballot_sync(0xffffffffu, ok && v[0] == kNegFill);
      if (tid == 0) uniform[st] = none_seen;
    }
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    tma_keys<D>(&tm_k, &tm_v, base + L::kK, base + L::kV, bar_kv, c0, kTile,
                hk, b);
  int cur = next(rs_lo), issued = cur;
  float vals[3];
  fetch(cur, vals);
  if (cur < rs_hi) issue(0, cur, vals);
  for (int s = 1; s < C::kStages; ++s) {
    issued = next(issued + 1);
    fetch(issued, vals);
    if (issued < rs_hi) issue(s, issued, vals);
  }
  mbar_wait(bar_kv, 0);
  __syncthreads();  // the first stages' row values

  // this thread's keys (C-fragment rows of S^T) and its row columns kq, kq
  // + 1 of every 8
  const int k0 = c0 + 16 * wq + lane / 4, k1 = k0 + 8;
  const int pk0 = mk.key_pos(k0), pk1 = mk.key_pos(k1);
  const int kq = (lane % 4) * 2;
  float acc[C::kMT][32];  // dV^T (warpgroup 0) or dK^T (1): 64 D rows x keys
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

  // every thread: the staged Q and dO of the i-th step of the walk (ring
  // stage i % kStages), once arrived, split in place; with two stages and
  // TMA, step i + 1 is split while step i's dV and dK products run
  auto split_step = [&](int i) {
    uint8_t* const qt = sb + L::kRing + (i % C::kStages) * 4 * C::kRB;
    mbar_wait(bar_full + 8 * (i % C::kStages), (i / C::kStages) & 1);
    split_tile<256>(qt, qt + C::kRB, C::kRB);
    split_tile<256>(qt + 2 * C::kRB, qt + 3 * C::kRB, C::kRB);
  };
  const bool ahead_ok = C::kStages > 1 && a.q_tma_step;
  for (int it = 0; cur < rs_hi; ++it) {
    const int st = it % C::kStages;
    uint8_t* const qt = sb + L::kRing + st * 4 * C::kRB;  // Q hi, lo, dO hi, lo
    const uint32_t q_hi = base + L::kRing + st * 4 * C::kRB;
    if (!a.q_tma_step) {
      load_rows<D, 256>(qt, a.q, a.q_sb, a.q_ss, a.q_sh, b, hk, cur * kRS,
                        kRS, mk);
      load_rows<D, 256>(qt + 2 * C::kRB, a.dout,
                        static_cast<long long>(a.Sq) * a.H * D,
                        static_cast<long long>(a.H) * D, D, b, hk, cur * kRS,
                        kRS, mk);
      __syncthreads();
      split_tile<256>(qt, qt + C::kRB, C::kRB);
      split_tile<256>(qt + 2 * C::kRB, qt + 3 * C::kRB, C::kRB);
      fence_proxy_async();
      __syncthreads();
    } else if (!ahead_ok || it == 0) {
      split_step(it);
      fence_proxy_async();
      __syncthreads();
    }
    const int nxt = next(cur + 1), upcoming = next(issued + 1);
    fetch(upcoming, vals);

    int qa, qb;
    mk.positions(cur * kRS, kRS, qa, qb);
    const bool mask = !mk.all_seen(qa, qb, c0, kTile);
    const float* rv = rows + st * 4 * kRS;
    const int* rq = reinterpret_cast<const int*>(rv) + 3 * kRS;
    // S^T (warpgroup 0) or dP^T (1): 64 keys x kRS rows
    float x[kRS / 2];
    if (wg == 0)
      dots<kRS, D>(x, sb + L::kK, kTile, 0, q_hi, q_hi + C::kRB);
    else
      dots<kRS, D>(x, sb + L::kV, kTile, 0, q_hi + 2 * C::kRB,
                   q_hi + 3 * C::kRB);
    // x[4j + 2h + e]: key k_h, row c = 8j + kq + e of the step. Both
    // fragments go through shared memory (over the P^T and dS^T tiles, which
    // are written only once every thread has read), so that each warpgroup
    // forms P and dS for half of the rows: warpgroup w the column groups j
    // of [w kJ, (w + 1) kJ)
    constexpr int kJ = kRS / 16;
#pragma unroll
    for (int i = 0; i < kRS / 2; ++i)
      xfer[(wg * (kRS / 2) + i) * 128 + tid % 128] = x[i];
    __syncthreads();
    float ps[4 * kJ], ds[4 * kJ];
#pragma unroll
    for (int i = 0; i < 4 * kJ; ++i) {
      ps[i] = xfer[(4 * kJ * wg + i) * 128 + tid % 128];
      ds[i] = xfer[(kRS / 2 + 4 * kJ * wg + i) * 128 + tid % 128];
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (kJ * wg + jj) + kq + e;
        const float m = rv[c], dl = rv[2 * kRS + c];
        const float il = m == kNegFill ? 0.f : rv[kRS + c];  // uniform: 0
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * jj + 2 * h + e;
          float sc = ps[i] * a.scale_log2;
          bool seen = true;
          if (mask) {
            const int pk = h ? pk1 : pk0;
            seen = pk != kAbsent && mk.visible(pk, rq[c]);
            if (pk == kAbsent) sc = neg_inf();
            else if (!seen) sc = kNegFill;
          }
          ps[i] = exp2f(sc - m) * il;
          ds[i] = seen ? ps[i] * (ds[i] - dl) : 0.f;
        }
      }
    store_b<kJ>(ps, sb + L::kB, sb + L::kB + kTile * 128, kTile, 0, kJ * wg);
    store_b<kJ>(ds, sb + L::kB + 2 * kTile * 128,
                sb + L::kB + 3 * kTile * 128, kTile, 0, kJ * wg);
    fence_proxy_async();
    __syncthreads();

    const int p0 = wg;  // 0: dV^T += dO^T P; 1: dK^T += Q^T dS
    // warpgroup 0: A = dO^T (dO's hi/lo tiles), B = P^T; 1: A = Q^T, B =
    // dS^T; the next step split meanwhile
    {
      const uint8_t* at_hi = qt + (p0 ? 0 : 2 * C::kRB);
      const uint32_t b_hi = base + L::kB + (p0 ? 2 : 0) * kTile * 128;
      tiles_t<64, kKS, C::kMT>(
          at_hi, at_hi + C::kRB, kRS, 0, b_hi, b_hi + kTile * 128, kTile, 0,
          [&](int mt, const float (&pt)[32]) {
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[mt][i] += pt[i];
          },
          [&] {
            if (ahead_ok && nxt < rs_hi) split_step(it + 1);
          });
    }
    // rows that see no key (m = the fill): P = 1/l on each key < T, added to
    // dV in float32 on the CUDA cores
    if (wg == 0) {
      uint32_t bits = uniform[st];
      while (bits != 0u) {
        const int r = __ffs(bits) - 1;
        bits &= bits - 1u;
        const float w = rv[kRS + r];
        const uint8_t* d_hi = qt + 2 * C::kRB;
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int d = 64 * mt + 16 * wq + lane / 4 + 8 * h;
            const uint32_t o = at(kRS, r, d);
            const float y = lds(d_hi, o) + lds(d_hi + C::kRB, o);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (c0 + 8 * j + kq + e < mk.T)
                  acc[mt][4 * j + 2 * h + e] =
                      fmaf(w, y, acc[mt][4 * j + 2 * h + e]);
          }
      }
    }
    fence_proxy_async();
    __syncthreads();  // this stage, P^T, dS^T and the row values are consumed
    issued = upcoming;
    if (issued < rs_hi) issue(st, issued, vals);
    cur = nxt;
  }

  // acc[mt][4j + 2h + e]: D row 64 mt + 16 wq + lane/4 + 8h, key c0 + 8j +
  // kq + e
  const long long n_out = static_cast<long long>(a.B) * mk.T * a.Hkv * D;
  float* const out = wg == 0 ? a.dv : a.dk;
  float* const out_part = wg == 0 ? a.dv_part : a.dk_part;
  const float mul = wg == 0 ? 1.f : a.scale;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = c0 + 8 * j + kq + e;
      if (key >= mk.T) continue;
      const long long row = ((static_cast<long long>(b) * mk.T + key) * a.Hkv + hk) * D;
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = 64 * mt + 16 * wq + lane / 4 + 8 * h;
          const float y = acc[mt][4 * j + 2 * h + e] * mul;
          if (a.n_split == 1) out[row + d] = y;
          else out_part[part * n_out + row + d] = y;
        }
    }
}

// ---------------------------------------------------------------------------
// 3. dQ: per row tile, dQ^T = scale K^T dS^T over the key tiles its rows see
// ---------------------------------------------------------------------------
template <int D>
struct DqLayout {
  using C = Cfg<D>;
  static constexpr int kQ = 0;                 // Q raw [64][D]
  static constexpr int kDo = C::kRaw;          // dO raw
  static constexpr int kRing = 2 * C::kRaw;    // [stage] K hi, lo, V hi, lo
  static constexpr int kDs = kRing + C::kStages * 4 * C::kKB;  // dS hi, lo
  static constexpr int kBar = kDs + 2 * kTile * 128;  // q, full[]
  static constexpr int kAlloc = kBar + 8 * (1 + C::kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(256, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ Args a) {
  using C = Cfg<D>;
  using L = DqLayout<D>;
  constexpr int kBN = C::kBN, kKS = kBN / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sb;
  const uint32_t base = aligned_base(smem_raw, &sb);
  // S and dP handed between the warpgroups, [2][kBN / 2][128], over the dS
  // tiles
  float* const xfer = reinterpret_cast<float*>(sb + L::kDs);
  const uint32_t bar_q = base + L::kBar, bar_full = bar_q + 8;
  const Mask& mk = a.mk;
  const int row0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int g = mk.g, R = mk.R;
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, wq = (tid / 32) % 4;
  const long long bh = static_cast<long long>(b) * a.Hkv + hk;
  int qa, qb, t_lo, t_hi;
  mk.positions(row0, kTile, qa, qb);
  mk.key_range(qa, qb, false, kBN, t_lo, t_hi);  // a row that sees no key: dS 0
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + kBN - 1) / kBN : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](int it) {  // thread 0: key tile it into its stage
    const int st = it % C::kStages;
    const uint32_t dst = base + L::kRing + st * 4 * C::kKB;
    tma_keys<D>(&tm_k, &tm_v, dst, dst + 2 * C::kKB, bar_full + 8 * st,
                t_lo + it * kBN, kBN, hk, b);
  };
  if (tid == 0)
    for (int it = 0; it < min(C::kStages, n_tiles); ++it) load(it);
  load_row_tiles<D, 256>(&tm_q, &tm_do, sb, base, L::kQ, L::kDo, bar_q, row0,
                         hk, b, a);
  __syncthreads();

  // this thread's two rows of S and dP and their m, 1/l, delta, position (a
  // row past R: 1/l = 0, so dS = 0)
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
    qp[h] = mk.q_offset + row / g;
  }
  const int kq = (lane % 4) * 2;
  float acc[C::kMT][16];  // dQ^T: 64 D rows x this warpgroup's 32 rows
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[mt][i] = 0.f;
  // key tile j's K and V, once arrived, split in place; with two stages
  // tile j + 1 is split while tile j's dQ products run
  auto split_stage = [&](int j) {
    uint8_t* const kv = sb + L::kRing + (j % C::kStages) * 4 * C::kKB;
    mbar_wait(bar_full + 8 * (j % C::kStages), (j / C::kStages) & 1);
    split_tile<256>(kv, kv + C::kKB, C::kKB);
    split_tile<256>(kv + 2 * C::kKB, kv + 3 * C::kKB, C::kKB);
  };
  constexpr bool kAhead = C::kStages > 1;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % C::kStages, col0 = t_lo + it * kBN;
    uint8_t* const kv = sb + L::kRing + st * 4 * C::kKB;  // K hi, lo, V hi, lo
    const uint32_t k_hi = base + L::kRing + st * 4 * C::kKB;
    if (!kAhead || it == 0) {
      split_stage(it);
      fence_proxy_async();
      __syncthreads();
    }
    const bool mask = !mk.all_seen(qa, qb, col0, kBN);
    // S (warpgroup 0) or dP (1): 64 rows x kBN keys
    float x[kBN / 2];
    if (wg == 0)
      dots<kBN, D>(x, sb + L::kQ, kTile, 0, k_hi, k_hi + C::kKB);
    else
      dots<kBN, D>(x, sb + L::kDo, kTile, 0, k_hi + 2 * C::kKB,
                   k_hi + 3 * C::kKB);
    // both fragments through shared memory (over the dS tiles, written once
    // every thread has read), so that each warpgroup forms dS for half of
    // the keys: warpgroup w the column groups j of [w kJ, (w + 1) kJ)
    constexpr int kJ = kBN / 16;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      xfer[(wg * (kBN / 2) + i) * 128 + tid % 128] = x[i];
    __syncthreads();
    float ds[4 * kJ];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pk = mk.key_pos(col0 + 8 * (kJ * wg + jj) + kq + e);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * jj + 2 * h + e, at_i = 4 * kJ * wg + i;
          const float sc = xfer[at_i * 128 + tid % 128];
          const float dp = xfer[(kBN / 2 + at_i) * 128 + tid % 128];
          const bool seen = !mask || (pk != kAbsent && mk.visible(pk, qp[h]));
          ds[i] = seen ? exp2f(sc * a.scale_log2 - m[h]) * il[h] * (dp - dl[h])
                       : 0.f;
        }
      }
    __syncthreads();
    store_b<kJ>(ds, sb + L::kDs, sb + L::kDs + kTile * 128, kTile, 0, kJ * wg);
    fence_proxy_async();
    __syncthreads();
    // dQ^T += K^T dS^T for rows 32 wg.. of the tile; the next tile split
    // meanwhile
    tiles_t<32, kKS, C::kMT>(
        kv, kv + C::kKB, kBN, 0, base + L::kDs, base + L::kDs + kTile * 128,
        kTile, 32 * wg,
        [&](int mt, const float (&pt)[16]) {
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[mt][i] += pt[i];
        },
        [&] {
          if (kAhead && it + 1 < n_tiles) split_stage(it + 1);
        });
    fence_proxy_async();
    __syncthreads();  // this stage and dS are consumed
    if (tid == 0 && it + C::kStages < n_tiles) load(it + C::kStages);
  }

  // acc[mt][4j + 2h + e]: D row 64 mt + 16 wq + lane/4 + 8h, row 32 wg + 8j
  // + kq + e of the tile
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + 32 * wg + 8 * j + kq + e;
      if (row >= R) continue;
      const int s = row / g, head = hk * g + row % g;
      float* out =
          a.dq + ((static_cast<long long>(b) * a.Sq + s) * a.H + head) * D;
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          out[64 * mt + 16 * wq + lane / 4 + 8 * h] =
              acc[mt][4 * j + 2 * h + e] * a.scale;
    }
}

// ---------------------------------------------------------------------------
// 4. the row splits' partial dK and dV summed in split order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
    bwd_reduce_kernel(const float* __restrict__ dk_part,
                      const float* __restrict__ dv_part,
                      float* __restrict__ dk, float* __restrict__ dv,
                      long long n, int n_split) {
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
    *reinterpret_cast<float4*>(dk + i) = sk;
    *reinterpret_cast<float4*>(dv + i) = sv;
  }
}

// ---- host side ---------------------------------------------------------------
struct Maps {
  CUtensorMap q_tile, do_tile, q_step, do_step, k_tile, v_tile, k_keys,
      v_keys;
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
  const int R = a.mk.R;
  const dim3 rows((R + kTile - 1) / kTile, a.Hkv, a.B);
  const dim3 keys((a.mk.T + kTile - 1) / kTile, a.Hkv, a.B * a.n_split);
  bwd_prep_kernel<D><<<rows, 128, PrepLayout<D>::kAlloc, stream>>>(
      m.q_tile, m.k_keys, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<D><<<keys, 256, DkdvLayout<D>::kAlloc, stream>>>(
      m.q_step, m.do_step, m.k_tile, m.v_tile, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<D><<<rows, 256, DqLayout<D>::kAlloc, stream>>>(
      m.q_tile, m.do_tile, m.k_keys, m.v_keys, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  const long long n = static_cast<long long>(a.B) * a.mk.T * a.Hkv * D;
  const long long blocks = (n / 4 + 255) / 256;
  bwd_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                      256, 0, stream>>>(a.dk_part, a.dv_part, a.dk, a.dv, n,
                                        a.n_split);
  return cudaGetLastError();
}

template <int D>
cudaError_t encode_all(EncodeTiled fn, Maps* m, const void* q,
                       const void* dout, const void* k, const void* v,
                       const long long* strides, int B, int Sq, int T, int H,
                       int Hkv, const Args& a) {
  using C = Cfg<D>;
  const int g = H / Hkv;
  const long long dh = D, ds = static_cast<long long>(H) * D,
                  db = static_cast<long long>(Sq) * H * D;
  cudaError_t err = cudaSuccess;
  if (a.q_tma_tile) {
    err = encode(fn, &m->q_tile, q, D, H, Sq, B, strides[2], strides[1],
                 strides[0], g, kTile / g);
    if (err == cudaSuccess)
      err = encode(fn, &m->do_tile, dout, D, H, Sq, B, dh, ds, db, g,
                   kTile / g);
  }
  if (err == cudaSuccess && a.q_tma_step) {
    err = encode(fn, &m->q_step, q, D, H, Sq, B, strides[2], strides[1],
                 strides[0], g, C::kRS / g);
    if (err == cudaSuccess)
      err = encode(fn, &m->do_step, dout, D, H, Sq, B, dh, ds, db, g,
                   C::kRS / g);
  }
  if (err == cudaSuccess)
    err = encode(fn, &m->k_tile, k, D, Hkv, T, B, strides[5], strides[4],
                 strides[3], 1, kTile);
  if (err == cudaSuccess)
    err = encode(fn, &m->v_tile, v, D, Hkv, T, B, strides[8], strides[7],
                 strides[6], 1, kTile);
  if (err == cudaSuccess)
    err = encode(fn, &m->k_keys, k, D, Hkv, T, B, strides[5], strides[4],
                 strides[3], 1, C::kBN);
  if (err == cudaSuccess)
    err = encode(fn, &m->v_keys, v, D, Hkv, T, B, strides[8], strides[7],
                 strides[6], 1, C::kBN);
  return err;
}

template <int D>
cudaError_t run(EncodeTiled fn, Args& a, const void* q, const void* dout,
                const void* k, const void* v, const long long* strides,
                int B, int Sq, int T, int H, int Hkv, cudaStream_t stream) {
  const int g = H / Hkv;
  a.q_tma_tile = kTile % g == 0;
  a.q_tma_step = Cfg<D>::kRS % g == 0;
  Maps m;
  std::memset(&m, 0, sizeof(m));
  const cudaError_t err =
      encode_all<D>(fn, &m, q, dout, k, v, strides, B, Sq, T, H, Hkv, a);
  if (err != cudaSuccess) return err;
  return launch<D>(m, a, stream);
}

}  // namespace

// q: (B, Sq, H, D), k, v: (B, T, Hkv, D) float32, read through the element
// strides strides[0..8] = q's (b, s, h), k's (b, t, h), v's (b, t, h) (a
// host array; the last dimension has stride 1); o, dout: contiguous
// (B, Sq, H, D) float32; dq: contiguous (B, Sq, H, D); dk, dv: contiguous
// (B, T, Hkv, D), float32. stats: float32 scratch of B * Hkv * Sq * (H /
// Hkv) * 2, delta of B * Hkv * Sq * (H / Hkv); with n_split > 1, dk_part
// and dv_part: float32 scratch of n_split * B * T * Hkv * D each (else
// unused). kv_pos: (T,) int32 on the device or null. D is 64, 128 or 256,
// H % Hkv == 0; base addresses 16-byte aligned and strides multiples of 4
// elements (TMA's rule). Three launches, four with n_split > 1, on
// `stream` without synchronising; returns the first nonzero cudaError_t
// (0 = all launched).
extern "C" int flash_bwd_sm90_f32_launch(
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
    if (strides[i] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  EncodeTiled fn = nullptr;
  err = encoder(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int g = H / Hkv;
  Args a;
  a.q = static_cast<const float*>(q);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dk_part = dk_part;
  a.dv_part = dv_part;
  a.stats = stats;
  a.delta = delta;
  a.q_sb = strides[0];
  a.q_ss = strides[1];
  a.q_sh = strides[2];
  a.B = B;
  a.Sq = Sq;
  a.H = H;
  a.Hkv = Hkv;
  a.n_split = n_split;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.mk = Mask{kv_pos, T, Sq * g, g, causal, window, q_offset};

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    err = run<64>(fn, a, q, dout, k, v, strides, B, Sq, T, H, Hkv, st);
  else if (D == 128)
    err = run<128>(fn, a, q, dout, k, v, strides, B, Sq, T, H, Hkv, st);
  else
    err = run<256>(fn, a, q, dout, k, v, strides, B, Sq, T, H, Hkv, st);
  return static_cast<int>(err);
}
