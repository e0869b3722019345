// Grouped-head attention prefill on Hopper's TF32 tensor cores at float32
// accuracy: every float32 attention call whose query rows (Sq * g)
// outnumber a decode tile, at head dims 64, 128 and 256 (the "tc32" route
// of kernels/flash_attention.py's launch_plan; float32 at other head dims
// stays on flash_attention.cu, decode on flash_decode.cu).
//
// Replaces: src/repro/kernels/flash_attention.py:77, flash_attention (body
// _flash_kernel), and computes the function of the region the JAX model
// runs in its place, src/repro/models/layers.py:134, gqa_scores_chunked.
//
// The function is flash_attention.cu's, unchanged: for q (B, Sq, H, D) and
// k, v (B, T, Hkv, D), query head h reads KV head h / g; key c is seen by
// query s iff p_c >= 0, (causal) q_pos >= p_c and (window > 0) p_c > q_pos
// - window (p_c = kv_pos[c], or c when kv_pos is null; q_pos = q_offset +
// s); an unseen key takes the finite score -1e30, a key past T -inf; the
// softmax sum is clamped at 1e-30; inputs are read in place through their
// strides and o is written contiguous (B, Sq, H, D) in float32.
//
// What bounds it on an H100: at qwen3's shape (B 4, S = T 2048, H 16/8, D
// 128, causal) Q.K^T and P.V are 68.8 GFLOP; as three TF32 products each
// (the split below) that is 206 GFLOP at 494.7 TFLOP/s, 0.417 ms, against
// 134 MB of float32 Q, K, V and O (0.04 ms): operations bound it.
//
// Precision: 3xTF32 with partial sums (flash_sm90_f32.cuh): S = Q K^T in
// 32-deep chunks over D, each a fresh partial added to S; O is kept
// transposed, O^T (D x rows), and per key tile of 32 takes O^T = alpha *
// O^T + V^T P^T with V^T P^T one fresh chunk (a fused multiply-add per
// element). Each product's next A fragments are loaded while a chunk runs,
// and with two stages the next key tile is split in place while this
// tile's O^T products run.
//
// Design. A block takes 64 * kRG packed query rows (row r = s * g + h % g,
// so each K/V tile is read once per KV head) of one KV head and batch, and
// two warpgroups, 256 threads: at D 64 and 128 each warpgroup owns 64 rows
// (kRG 2); at D 256 both take the same 64 rows and each owns half of D in
// O^T (kRG 1; S is computed by both). Q arrives once, raw, by TMA as a box
// of g heads x rows / g positions when g divides the rows (else by plain
// 16-byte loads in the same layout), and is split on the fly into A
// fragments. K and V arrive by TMA through 4-D maps over (D, Hkv, T, B) and
// their strides into a ring of kStages stages of 32 keys, each split in
// place on arrival. Per key tile each warpgroup runs
//   S = Q K^T (m64n32, A from Q, B = K hi/lo), the mask (only where the
//     tile needs one) and the online softmax in base 2 (scale folded with
//     log2 e), the row max and sum over the 4 lanes that share a row;
//   P (64 x 32) written as hi/lo into shared memory, alpha per row beside;
//   O^T = alpha O^T + V^T P^T per 64 rows of D (m64n64, A = V^T read across
//     the V hi/lo tiles, B = P hi/lo).
// Byte budget (shared memory): Q raw kRows x D x 4, the ring kStages x 4
// x 32 x D x 4 (K hi, K lo, V hi, V lo), P hi/lo 2 x kRows x 128, a float
// a row: D 64 32 + 64 + 32 KB (2 stages, 128 rows), D 128 64 + 128 + 32
// KB = 225.5 KB with the barriers and alignment (2 stages, 128 rows), D
// 256 64 + 128 + 16 KB (1 stage, 64 rows). Registers: O^T 32 a 64 rows of
// D, S and its partial 16 each, two chunks' A fragments 64 (one loaded
// while the other's products run), the O^T partial 32; at D 256 (O^T 64)
// ptxas spills a few of them (chip_smoke.py's [build] lines).
// When key positions are the indices, key tiles wholly above the causal
// diagonal or before the window of every row of the block are not loaded,
// and a warpgroup skips the tiles none of its rows sees. Ragged S is masked
// at the store.
#include <cstdint>
#include <cstring>

#include "flash_sm90_f32.cuh"

namespace {

using namespace f32sm90;

constexpr int kThreads = 256;
constexpr int kBN = 32;  // keys a tile

template <int D>
struct Cfg {
  static constexpr int kRG = D == 256 ? 1 : 2;   // 64-row groups a block
  static constexpr int kDS = D == 256 ? 2 : 1;   // warpgroups a row group
  static constexpr int kRows = 64 * kRG;
  static constexpr int kStages = D == 256 ? 1 : 2;
  static constexpr int kMT = D / 64 / kDS;       // O^T m-tiles a warpgroup
  static constexpr int kKV = kBN * D * 4;        // bytes of K or V, hi or lo
  static constexpr int kQ = 0;                   // Q raw [kRows][D]
  static constexpr int kRing = kRows * D * 4;    // [stage] K hi, lo, V hi, lo
  static constexpr int kP = kRing + kStages * 4 * kKV;  // P hi, P lo
  static constexpr int kRowVal = kP + 2 * kRows * 128;  // float [kRows]
  static constexpr int kBar = kRowVal + kRows * 4;      // q, full[kStages]
  static constexpr int kAlloc = kBar + 8 * (1 + kStages) + 1024;
};

struct Args {
  const float* q;   // read directly only when g does not divide the rows
  float* o;         // contiguous (B, Sq, H, D)
  long long q_sb, q_ss, q_sh;
  int Sq, H, q_tma;
  float scale_log2;  // scale * log2(e)
  Mask mk;
};

// thread 0: the copies of key tile `it` into its ring stage
template <int D>
__device__ __forceinline__ void load_tile(const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v,
                                          uint32_t base, int it, int t_lo,
                                          int hk, int b) {
  using C = Cfg<D>;
  const int st = it % C::kStages;
  const uint32_t dst = base + C::kRing + st * 4 * C::kKV;
  tma_keys<D>(tm_k, tm_v, dst, dst + 2 * C::kKV, base + C::kBar + 8 * (1 + st),
              t_lo + it * kBN, kBN, hk, b);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_prefill_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ Args a) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sb;
  const uint32_t base = aligned_base(smem_raw, &sb);
  float* const rowval = reinterpret_cast<float*>(sb + C::kRowVal);
  const uint32_t bar_q = base + C::kBar, bar_full = bar_q + 8;
  const Mask& mk = a.mk;
  const int row0 = blockIdx.x * C::kRows, hk = blockIdx.y, b = blockIdx.z;
  const int g = mk.g, R = mk.R;
  const int tid = threadIdx.x, lane = tid % 32, wq = (tid / 32) % 4;
  const int wg = tid / 128, rg = wg / C::kDS, dsl = wg % C::kDS;

  int qa, qb, t_lo, t_hi;
  mk.positions(row0, C::kRows, qa, qb);
  mk.key_range(qa, qb, false, kBN, t_lo, t_hi);
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + kBN - 1) / kBN : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    if (a.q_tma)
      tma_rows<D>(&tm_q, nullptr, base + C::kQ, 0, bar_q, row0, C::kRows, hk,
                  b, g);
    for (int it = 0; it < min(C::kStages, n_tiles); ++it)
      load_tile<D>(&tm_k, &tm_v, base, it, t_lo, hk, b);
  }
  if (a.q_tma)
    mbar_wait(bar_q, 0);
  else
    load_rows<D, kThreads>(sb + C::kQ, a.q, a.q_sb, a.q_ss, a.q_sh, b, hk,
                           row0, C::kRows, mk);
  __syncthreads();

  // this warpgroup's rows; this thread's two rows of S (C-fragment rows
  // lane/4 and lane/4 + 8 of its warp's 16) and its key columns kq, kq + 1
  // of every 8
  const int wrow0 = row0 + 64 * rg;
  const bool wg_rows = wrow0 < R;
  int wqa = 0, wqb = 0;
  if (wg_rows) mk.positions(wrow0, 64, wqa, wqb);
  const int r0 = wrow0 + 16 * wq + lane / 4, r1 = r0 + 8;
  const int qp0 = mk.q_offset + r0 / g, qp1 = mk.q_offset + r1 / g;
  const int kq = (lane % 4) * 2;
  const bool writer = dsl == 0;   // writes P and the row values

  float o[C::kMT][32];
#pragma unroll
  for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[mt][i] = 0.f;
  float m0 = kNegFill, m1 = kNegFill, l0 = 0.f, l1 = 0.f;

  // every thread: key tile j's K and V, once arrived, split in place. With
  // two stages tile j + 1 is split while tile j's O^T products run.
  auto split_stage = [&](int j) {
    uint8_t* const kv = sb + C::kRing + (j % C::kStages) * 4 * C::kKV;
    mbar_wait(bar_full + 8 * (j % C::kStages), (j / C::kStages) & 1);
    split_tile<kThreads>(kv, kv + C::kKV, C::kKV);
    split_tile<kThreads>(kv + 2 * C::kKV, kv + 3 * C::kKV, C::kKV);
  };
  constexpr bool kAhead = C::kStages > 1;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % C::kStages;
    const int col0 = t_lo + it * kBN;
    uint8_t* const kv = sb + C::kRing + st * 4 * C::kKV;
    if (!kAhead || it == 0) {
      split_stage(it);
      fence_proxy_async();
      __syncthreads();
    }

    bool skip = !wg_rows, need_mask = true;
    if (mk.kv_pos == nullptr && wg_rows) {
      skip = (mk.causal && col0 > wqb) ||
             (mk.window > 0 && col0 + kBN - 1 <= wqa - mk.window);
      need_mask = !mk.all_seen(wqa, wqb, col0, kBN);
    }
    const uint32_t k_hi = base + C::kRing + st * 4 * C::kKV;
    if (!skip) {
      float s[16];
      dots<kBN, D>(s, sb + C::kQ, C::kRows, 64 * rg, k_hi, k_hi + C::kKV);
      // scores in base-2 units; the mask where the tile needs one
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s[4 * j + e] * a.scale_log2;
          float x1 = s[4 * j + 2 + e] * a.scale_log2;
          if (need_mask) {
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
      if (writer) {
        store_b<kBN / 8>(s, sb + C::kP, sb + C::kP + C::kRows * 128,
                         C::kRows, 64 * rg);
        if (lane % 4 == 0) {
          rowval[64 * rg + 16 * wq + lane / 4] = c0;
          rowval[64 * rg + 16 * wq + lane / 4 + 8] = c1;
        }
      }
    }
    fence_proxy_async();
    __syncthreads();

    auto ahead = [&] {
      if (kAhead && it + 1 < n_tiles) split_stage(it + 1);
    };
    if (!skip) {
      // O^T = alpha O^T + V^T P^T: this thread's O^T columns (rows of the
      // block) 64 rg + 8j + kq + e
      const uint8_t* v_hi = kv + 2 * C::kKV;
      const uint32_t p_hi = base + C::kP;
      auto update = [&](int mt, const float (&part)[32]) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float alpha = rowval[64 * rg + 8 * j + kq + e];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              o[mt][i] = fmaf(alpha, o[mt][i], part[i]);
            }
          }
      };
      tiles_t<64, 4, C::kMT>(v_hi, v_hi + C::kKV, kBN, dsl * C::kMT * 64,
                             p_hi, p_hi + C::kRows * 128, C::kRows, 64 * rg,
                             update, ahead);
    } else {
      ahead();
    }
    fence_proxy_async();
    __syncthreads();  // stage st, P and the row values are consumed
    if (tid == 0 && it + C::kStages < n_tiles)
      load_tile<D>(&tm_k, &tm_v, base, it + C::kStages, t_lo, hk, b);
  }

  // each row's sum, clamped, into the row values; then o = O^T / sum
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (writer && lane % 4 == 0) {
    rowval[64 * rg + 16 * wq + lane / 4] = fmaxf(l0, 1e-30f);
    rowval[64 * rg + 16 * wq + lane / 4 + 8] = fmaxf(l1, 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 64 * rg + 8 * j + kq + e, row = row0 + r;
      if (row >= R) continue;
      const float den = rowval[r];
      const int s = row / g, h = hk * g + row % g;
      float* orow = a.o + ((static_cast<long long>(b) * a.Sq + s) * a.H + h) *
                              D;
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          orow[(dsl * C::kMT + mt) * 64 + 16 * wq + lane / 4 + 8 * hh] =
              o[mt][4 * j + 2 * hh + e] / den;
    }
}

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Args& a, int B, int Hkv,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  static int configured_for = -1;  // once per instantiation and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_prefill_f32_kernel<D>, C::kAlloc, dev,
                   configured_for);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.mk.R + C::kRows - 1) / C::kRows, Hkv, B);
  flash_prefill_f32_kernel<D><<<grid, kThreads, C::kAlloc, stream>>>(tq, tk,
                                                                     tv, a);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, D), k, v: (B, T, Hkv, D) float32, read through the element
// strides strides[0..8] = q's (b, s, h), k's (b, t, h), v's (b, t, h) (a
// host array; the last dimension has stride 1); o: contiguous (B, Sq, H,
// D) float32; kv_pos: (T,) int32 on the device or null. D is 64, 128 or
// 256, H % Hkv == 0; base addresses 16-byte aligned and strides multiples
// of 4 elements (TMA's rule). Launches on `stream` without synchronising;
// returns the first nonzero cudaError_t (0 = launched).
extern "C" int flash_prefill_sm90_f32_launch(
    const void* q, const void* k, const void* v, void* o,
    const int32_t* kv_pos, const long long* strides, int B, int Sq, int T,
    int H, int Hkv, int D, int causal, int window, int q_offset, float scale,
    int device, void* stream) {
  if ((D != 64 && D != 128 && D != 256) || Hkv <= 0 || H % Hkv != 0 ||
      B <= 0 || Sq <= 0 || T <= 0 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  EncodeTiled fn = nullptr;
  err = encoder(&fn);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int g = H / Hkv;
  const int rows = D == 256 ? Cfg<256>::kRows : Cfg<128>::kRows;
  Args a;
  a.q = static_cast<const float*>(q);
  a.o = static_cast<float*>(o);
  a.q_sb = strides[0];
  a.q_ss = strides[1];
  a.q_sh = strides[2];
  a.Sq = Sq;
  a.H = H;
  a.q_tma = rows % g == 0;
  a.scale_log2 = scale * kLog2e;
  a.mk = Mask{kv_pos, T, Sq * g, g, causal, window, q_offset};

  CUtensorMap tq, tk, tv;
  std::memset(&tq, 0, sizeof(tq));
  if (a.q_tma) {
    err = encode(fn, &tq, q, D, H, Sq, B, strides[2], strides[1], strides[0],
                 g, rows / g);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = encode(fn, &tk, k, D, Hkv, T, B, strides[5], strides[4], strides[3],
               1, kBN);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = encode(fn, &tv, v, D, Hkv, T, B, strides[8], strides[7], strides[6],
               1, kBN);
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) err = launch<64>(tq, tk, tv, a, B, Hkv, st);
  else if (D == 128) err = launch<128>(tq, tk, tv, a, B, Hkv, st);
  else err = launch<256>(tq, tk, tv, a, B, Hkv, st);
  return static_cast<int>(err);
}
