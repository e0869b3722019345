// Grouped-head attention prefill on Hopper's bf16 tensor cores: every
// attention layer of the LM whose query rows (Sq * g) outnumber a decode
// tile, in bf16, at head dims 64, 128 and 256.
//
// Replaces: src/repro/kernels/flash_attention.py:77, flash_attention (body
// _flash_kernel), and computes the function of the region the JAX model
// runs in its place, src/repro/models/layers.py:134, gqa_scores_chunked.
//
// The function, as flash_attention.cu states it: for q (B, Sq, H, D) and
// k, v (B, T, Hkv, D), query head h reads KV head h / g. With p_c the
// position of key c (kv_pos[c], or c when kv_pos is null) and q_pos =
// q_offset + s, key c is seen by query s iff p_c >= 0, (causal) q_pos >=
// p_c and (window > 0) p_c > q_pos - window. A key not seen takes the
// finite score -1e30, a key past T takes -inf, the softmax sum is clamped
// at 1e-30, and o is written contiguous (B, Sq, H, D) in bf16. Rows with no
// visible key are outside the contract.
//
// What bounds it on an H100: at the prefill shape (B 4, S = T 2048, H 16,
// Hkv 8, D 128, causal) Q.K^T and P.V are 2 x 34.4 GFLOP of tensor-core
// work (0.0695 ms at 989 TFLOP/s) against 67 MB of Q, K, V and O (0.020
// ms at 3.35 TB/s): operations bound it. The split of P below makes the
// tensor cores run P.V twice, so the kernel issues 103 GFLOP for that work.
//
// Design. One block per (128 query rows, KV head, batch): two warpgroups
// of 64 rows each, 256 threads and no separate producer warp, so a thread
// may hold up to 255 registers (wgmma kernels are given registers by whole
// warpgroups: a third, producer warpgroup would cap every thread at
// 65,536 / 384, rounded down to 168, and make D = 256 spill). A row packs
// the g query heads of one KV head (row r = s * g + h % g), so each K/V
// tile is read once per KV head. Thread 0 keeps a two-stage ring of 64-key
// K and V tiles in shared memory filled by TMA, one tile ahead of the one
// being computed. The 4-D tensor maps over (D, Hkv, T, B) are encoded on
// the host per launch, so K and V are read in the model's (B, S, H, D)
// layout or the cache's (B, steps, Hkv, D) layout through their strides,
// with no copy; the 128-byte swizzle lands a row of D bf16 as D / 64
// panels of 128 bytes; completion and release go through mbarriers. Q is
// loaded once per block: by TMA as a box of g heads x 128 / g positions
// when g divides 128, else (g = 3, 6, ...) by plain 16-byte loads written
// in the same swizzled layout. Per key tile each warpgroup runs
//   S = Q K^T: wgmma m64n64k16, bf16 operands from shared memory, float32
//     accumulators (the products are exact; only the order of the sums
//     differs from the reference);
//   the mask, in registers, only on tiles that need one (the causal
//     diagonal, the window's edge, ragged T, or any tile when positions are
//     given), and the online softmax in base 2 (the scale folded with
//     log2 e), the row max and sum over the 4 lanes that share a row;
//   O += P V: P is kept at float32 accuracy by splitting it in registers
//     into P_hi = bf16(P) and P_lo = bf16(P - P_hi) and issuing two
//     register-A wgmma products into the same float32 accumulator (V is
//     bf16 and exact), about 16 significant bits of P where one bf16 keeps
//     8. The sum l comes from the float32 P. O is rescaled only after the
//     previous product has retired (wgmma.wait_group 0).
// No TF32 anywhere. When key positions are the indices (kv_pos null), key
// tiles wholly above the causal diagonal or wholly before the window of
// every row of the block are not loaded, and a warpgroup skips the tiles
// none of its rows sees. Ragged S is masked at the store.
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 128;                  // query rows of a block
constexpr int kThreads = 256;               // two warpgroups
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kPanel = 64;                  // bf16 columns of a 128-byte row
constexpr float kNegFill = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int kBN = 64;               // keys per tile
  static constexpr int kPanels = D / kPanel;
  static constexpr int kQPanel = kRows * 128;  // bytes of one Q panel
  static constexpr int kKVPanel = kBN * 128;   // bytes of one K or V panel
  static constexpr int kQ = 0;                 // [panel][128][64]
  static constexpr int kK = kQ + kPanels * kQPanel;  // [stage][panel][kBN][64]
  static constexpr int kV = kK + kStages * kPanels * kKVPanel;
  static constexpr int kBar = kV + kStages * kPanels * kKVPanel;
  // barriers: q_full, full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  static constexpr uint32_t kStageTx = 2u * kBN * D * 2;
  static constexpr uint32_t kQTx = kRows * D * 2;
};

struct Args {
  const __nv_bfloat16* q;   // read directly only when g does not divide 128
  __nv_bfloat16* o;         // contiguous (B, Sq, H, D)
  const int32_t* kv_pos;    // (T,) or null: positions are the indices
  long long q_sb, q_ss, q_sh;
  int Sq, T, H, g;
  int causal, window, q_offset, q_tma;
  float scale_log2;         // scale * log2(e)
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
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

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


// a register holding two bf16: x in the low half (the lower column)
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - back.x, y - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ bool visible(int p, int qpos, const Args& a) {
  return p >= 0 && (!a.causal || qpos >= p) &&
         (a.window <= 0 || p > qpos - a.window);
}

// the copies of key tile `it` into its ring stage, once both warpgroups
// have released the tile that stage held before
template <int D>
__device__ __forceinline__ void load_tile(const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v,
                                          uint32_t base, int it, int t_lo,
                                          int hk, int b) {
  using L = Tiles<D>;
  const int st = it % kStages;
  const uint32_t full = base + L::kBar + 8 * (1 + st);
  const uint32_t empty = base + L::kBar + 8 * (1 + kStages + st);
  mbar_wait(empty, ((it / kStages) & 1) ^ 1);
  mbar_expect_tx(full, L::kStageTx);
  const int col0 = t_lo + it * L::kBN;
  for (int p = 0; p < L::kPanels; ++p) {
    const int slot = (st * L::kPanels + p) * L::kKVPanel;
    tma_load_4d(base + L::kK + slot, tm_k, full, p * kPanel, hk, col0, b);
    tma_load_4d(base + L::kV + slot, tm_v, full, p * kPanel, hk, col0, b);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const Args a) {
  using L = Tiles<D>;
  constexpr int kBN = L::kBN;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;                  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;    // + 8 * stage

  const int row0 = blockIdx.x * kRows, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.g, R = a.Sq * g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // key tiles to visit: all of them, less (kv_pos null) those wholly above
  // the causal diagonal or wholly before the window of every row here
  int t_lo = 0, t_hi = a.T;
  if (a.kv_pos == nullptr) {
    const int s_lo = row0 / g, s_hi = (min(row0 + kRows, R) - 1) / g;
    if (a.causal) t_hi = min(a.T, a.q_offset + s_hi + 1);
    if (a.window > 0) t_lo = max(0, a.q_offset + s_lo - a.window + 1);
    t_lo = (t_lo / kBN) * kBN;
  }
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + kBN - 1) / kBN : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0 issues every copy: Q, then the ring's first tiles; each
  // iteration below asks for the tile kStages - 1 ahead
  if (threadIdx.x == 0) {
    if (a.q_tma) {
      mbar_expect_tx(bar_q, L::kQTx);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load_4d(base + L::kQ + p * L::kQPanel, &tm_q, bar_q, p * kPanel,
                    hk * g, row0 / g, b);
    }
    for (int it = 0; it < min(kStages - 1, n_tiles); ++it)
      load_tile<D>(&tm_k, &tm_v, base, it, t_lo, hk, b);
  }

  const int wg = warp / 4, wq = warp % 4;
  const int wrow0 = row0 + 64 * wg;  // first packed row of this warpgroup
  if (a.q_tma) {
    mbar_wait(bar_q, 0);
  } else {
    // rows straddle positions: 16-byte loads into the swizzled layout the
    // TMA box would have written (chunk c of row r at c ^ (r % 8))
    constexpr int kChunks = D / 8;
    for (int i = threadIdx.x % 128; i < 64 * kChunks; i += 128) {
      const int r = 64 * wg + i / kChunks, c = i % kChunks, row = row0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < R) {
        const int s = row / g, h = hk * g + row % g;
        x = *reinterpret_cast<const uint4*>(a.q + b * a.q_sb + s * a.q_ss +
                                            h * a.q_sh + c * 8);
      }
      *reinterpret_cast<uint4*>(sbase + L::kQ + (c / 8) * L::kQPanel +
                                r * 128 + (((c % 8) ^ (r % 8)) * 16)) = x;
    }
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
  }

  // this thread's two rows (C-fragment rows lane/4 and lane/4 + 8 of its
  // warp's 16) and its columns kq, kq + 1 of every 8
  const int r0 = wrow0 + 16 * wq + lane / 4, r1 = r0 + 8;
  const int qp0 = a.q_offset + r0 / g, qp1 = a.q_offset + r1 / g;
  const int kq = (lane % 4) * 2;
  const bool wg_rows = wrow0 < R;
  const int s_lo_w = wrow0 / g;
  const int s_hi_w = (min(wrow0 + 64, R) - 1) / g;
  const uint64_t k_bits = desc_bits(16);
  const uint64_t v_bits = desc_bits(L::kKVPanel);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegFill, m1 = kNegFill, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int col0 = t_lo + it * kBN;
    if (threadIdx.x == 0 && it + kStages - 1 < n_tiles)
      load_tile<D>(&tm_k, &tm_v, base, it + kStages - 1, t_lo, hk, b);
    mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
    bool skip = !wg_rows, need_mask = true;
    if (a.kv_pos == nullptr && wg_rows) {
      const int q_lo = a.q_offset + s_lo_w, q_hi = a.q_offset + s_hi_w;
      skip = (a.causal && col0 > q_hi) ||
             (a.window > 0 && col0 + kBN - 1 <= q_lo - a.window);
      need_mask = col0 + kBN > a.T || (a.causal && col0 + kBN - 1 > q_lo) ||
                  (a.window > 0 && col0 <= q_hi - a.window);
    }
    if (!skip) {
      const uint32_t k_st = base + L::kK + st * L::kPanels * L::kKVPanel;
      const uint32_t v_st = base + L::kV + st * L::kPanels * L::kKVPanel;
      float s[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qa = base + L::kQ + (kk / 4) * L::kQPanel +
                            wg * 64 * 128 + (kk % 4) * 32;
        const uint32_t ka = k_st + (kk / 4) * L::kKVPanel + (kk % 4) * 32;
        wgmma_ss<kBN>(s, make_desc(qa, k_bits), make_desc(ka, k_bits),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scores in base-2 units; the mask where a tile needs one
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s[4 * j + e] * a.scale_log2;
          float x1 = s[4 * j + 2 + e] * a.scale_log2;
          if (need_mask) {
            const int c = col0 + 8 * j + kq + e;
            if (c >= a.T) {
              x0 = x1 = neg_inf();
            } else {
              const int p = a.kv_pos != nullptr ? __ldg(a.kv_pos + c) : c;
              if (!visible(p, qp0, a)) x0 = kNegFill;
              if (!visible(p, qp1, a)) x1 = kNegFill;
            }
          }
          s[4 * j + e] = x0;
          s[4 * j + 2 + e] = x1;
        }

      // online softmax; the 4 lanes of a row are lane ^ 1, lane ^ 2
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
      const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        s[4 * j] = exp2f(s[4 * j] - mx0);
        s[4 * j + 1] = exp2f(s[4 * j + 1] - mx0);
        s[4 * j + 2] = exp2f(s[4 * j + 2] - mx1);
        s[4 * j + 3] = exp2f(s[4 * j + 3] - mx1);
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }

      // P as A fragments of 16 keys: a0 (row lane/4, keys 2t, 2t+1),
      // a1 (row + 8, same keys), a2 (row, keys + 8), a3 (row + 8, keys + 8)
      // are C-fragment registers 8kk + {0,1}, {2,3}, {4,5}, {6,7}
      uint32_t ph[kBN / 16][4], pl[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_pair(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r],
                     pl[kk][r]);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D>(o, ph[kk], make_desc(v_st + kk * 16 * 128, v_bits), 1);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D>(o, pl[kk], make_desc(v_st + kk * 16 * 128, v_bits), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
    }
    mbar_arrive(bar_empty + 8 * st);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= R) continue;
    const float den = half ? den1 : den0;
    const int s = row / g, h = (row % g) + (blockIdx.y * g);
    __nv_bfloat16* orow =
        a.o + ((static_cast<long long>(b) * a.Sq + s) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + kq) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] / den,
                                o[4 * j + 2 * half + 1] / den);
  }
}

// ---- host side ---------------------------------------------------------------
// a bf16 (B, steps, heads, D) tensor read through element strides, as a
// 4-D map over (D, heads, steps, B) with a box of 64 x box_heads x
// box_steps x 1 and the 128-byte swizzle
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

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Args& a, int B, int Hkv,
                   cudaStream_t stream) {
  using L = Tiles<D>;
  auto kernel = flash_prefill_kernel<D>;
  static int configured_for = -1;  // once per instantiation and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (configured_for != dev) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kAlloc);
    if (err != cudaSuccess) return err;
    configured_for = dev;
  }
  const dim3 grid((a.Sq * a.g + kRows - 1) / kRows, Hkv, B);
  kernel<<<grid, kThreads, L::kAlloc, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, D), k, v: (B, T, Hkv, D) bf16, read through the element
// strides strides[0..8] = q's (b, s, h), k's (b, t, h), v's (b, t, h) (a
// host array; the last dimension has stride 1); o: contiguous (B, Sq, H,
// D) bf16; kv_pos: (T,) int32 on the device or null. D is 64, 128 or 256,
// H % Hkv == 0; base addresses 16-byte aligned and strides multiples of 8
// elements (TMA's rule). Launches on `stream` without synchronising;
// returns the first nonzero cudaError_t (0 = launched).
extern "C" int flash_prefill_sm90_launch(const void* q, const void* k,
                                         const void* v, void* o,
                                         const int32_t* kv_pos,
                                         const long long* strides, int B,
                                         int Sq, int T, int H, int Hkv, int D,
                                         int causal, int window, int q_offset,
                                         float scale, int device,
                                         void* stream) {
  if ((D != 64 && D != 128 && D != 256) || Hkv <= 0 || H % Hkv != 0 ||
      B <= 0 || Sq <= 0 || T <= 0 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
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
  a.o = static_cast<__nv_bfloat16*>(o);
  a.kv_pos = kv_pos;
  a.q_sb = strides[0];
  a.q_ss = strides[1];
  a.q_sh = strides[2];
  a.Sq = Sq;
  a.T = T;
  a.H = H;
  a.g = g;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.q_tma = kRows % g == 0;
  a.scale_log2 = scale * kLog2e;

  CUtensorMap tq, tk, tv;
  std::memset(&tq, 0, sizeof(tq));
  if (a.q_tma) {
    err = encode(fn, &tq, q, D, H, Sq, B, strides[2], strides[1], strides[0],
                 g, kRows / g);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int bn = Tiles<128>::kBN;
  err = encode(fn, &tk, k, D, Hkv, T, B, strides[5], strides[4], strides[3],
               1, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = encode(fn, &tv, v, D, Hkv, T, B, strides[8], strides[7], strides[6],
               1, bn);
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) err = launch<64>(tq, tk, tv, a, B, Hkv, st);
  else if (D == 128) err = launch<128>(tq, tk, tv, a, B, Hkv, st);
  else err = launch<256>(tq, tk, tv, a, B, Hkv, st);
  return static_cast<int>(err);
}
