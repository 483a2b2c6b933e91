// Shared code of the paged decode-attention kernels K2 (paged_attention.cu)
// and K3 (grouped_paged_attention.cu): one split-over-pages design
// ("flash-decoding") for both.
//
// Layout: pools are head-major [Hkv, N, page_size, D] (page 0 = null page),
// q is [S, Hq, D] with the rep = Hq / Hkv query heads of kv-head h at
// columns h*rep .. h*rep+rep-1 (GQA). A slot attends key positions
// [0, max(seq_len, 1)) of its page-table row; a seated slot of a GRPO group
// (K3) reads the first prefix_len of them from its group's shared prefix
// pages instead, once for the whole group.
//
// Work items. The positions of a row are cut into chunks of C page-table
// columns (CT = C * page_size positions; the wrapper picks C from the
// shapes, never from seq_lens). A suffix item is (chunk c, slot s, kv head
// h, row block rb): up to kItemRows of the slot's rep query rows over
// positions [max(lo, c CT), min(hi, (c + 1) CT)), with hi = max(seq_len, 1)
// and lo = 0 for an ungrouped slot, its group's prefix length for a seated
// one. A prefix item (K3 only) is (chunk c, group g, kv head h, row block
// rb): up to kItemRows of the group's G * rep stacked query rows over the
// group's prefix pages. An item whose range is empty does nothing. Each
// item writes the f32 flash stats of its rows (m, l, unnormalised acc) to
// scratch the wrapper allocates.
//
// Two launches. The split kernel is persistent: its grid is as many blocks
// as fit on the card at once, and block b takes items b, b + grid, ... of a
// fixed order (prefix items, then suffix items, chunk-major), so an empty
// item costs a load, not a block (for_each_item tests 32 at a time). The
// combine kernel, one block per
// (slot, kv head, row block), merges the slot's partials in a fixed order
// (its seat's prefix chunks, then its own chunks) and writes the output.
// No atomics: two identical calls give bitwise-equal outputs. NEG_INF is
// finite (-FLT_MAX, float32 min as in the JAX code): a chunk that saw no key
// merges with weight exp(NEG_INF - m) = 0, never NaN.
//
// Bound on the H100: the KV bytes read (about 1 flop per byte). The bf16
// instance runs an item's products on the tensor cores (flash_mma.cuh's
// mma.sync.m16n8k16 helpers): the item's query rows are the M = 16 rows of
// the product (rep rows padded with zeros for K2, G * rep = 16 stacked rows
// for K3's prefix at G 8, rep 2); 64-key K and V tiles are gathered through
// the item's page ids (read once into shared memory) row by row by cp.async
// into a ring of swizzled shared-memory tiles (rows past the range are
// zero-filled, not read); each of the 4
// warps takes 16 keys of every tile with its own online softmax, P goes to
// P.V as two bf16 terms (gemm_pv), and the warps' states merge through
// shared memory at the end of the item. The f32 instance keeps CUDA-core
// products (attend_tile) on whole staged pages, as K4's f32 instance does.
// Later work: TMA and a producer warp, wgmma, and fusing the combine into
// the last block of each (slot, head).
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mutex>

#include "flash_mma.cuh"

namespace polyrl {

namespace fm = polyrl_flash::mma;
typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -FLT_MAX;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowChunk = 8;    // query rows a thread accumulates in registers (f32)
constexpr int kItemRows = 16;   // query rows of one work item: the mma's M
constexpr int kTile = 64;       // keys of one staged bf16 tile, 16 per warp
constexpr int kStages = 2;      // bf16 tiles in flight per block
constexpr int kBf16Blocks = 3;  // bf16 split blocks meant to share an SM
constexpr int kMaxCols = 256;   // page-table columns of a chunk (C) at most
constexpr size_t kMaxSmem = 232448;  // per block on sm_90 (227 KB)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// The exponential of the stats' domain: the f32 instance keeps m in natural
// units, the bf16 instance in base 2 (its logits carry scale * log2 e).
__device__ __forceinline__ float stat_exp(float x, float) { return expf(x); }
__device__ __forceinline__ float stat_exp(float x, bf16) { return exp2f(x); }

// -- shapes, operands and work items ------------------------------------------------

struct Plan {
  int S, Hq, Hkv, N, ps, D, P, rep;
  int C, NC, RB;        // columns per chunk; suffix chunks ceil(P / C); row blocks of rep
  int NG, G, P_pre;     // group table [NG, G] (NG = 0: K2, no prefix items)
  int NCp, RBp;         // prefix chunks ceil(P_pre / C); row blocks of G * rep
  float scale;
};

template <typename T> struct Args {
  const T* q;
  const T* kp;
  const T* vp;
  const int* page_table;          // [S, P]
  const int* seq_lens;            // [S]
  const int* group_slots;         // [NG, G], -1 = empty seat
  const int* group_prefix_pages;  // [NG, P_pre]
  const int* group_prefix_lens;   // [NG]
  float *m_s, *l_s, *acc_s;       // suffix partials [S, Hkv, NC, rep] (acc: x D)
  float *m_p, *l_p, *acc_p;       // prefix partials [NG, Hkv, NCp, G * rep] (acc: x D)
  T* out;                         // [S, Hq, D]
};

__host__ __device__ inline int n_prefix_items(const Plan& p) {
  return p.NG * p.Hkv * p.RBp * p.NCp;
}
__host__ __device__ inline int n_items(const Plan& p) {
  return n_prefix_items(p) + p.NC * p.S * p.Hkv * p.RB;
}

// Index into the [NG, G] table of the first seat holding slot s, or -1:
// -1 (empty) seats never match, so they are never used as an index. Each
// warp searches 32 seats a step; every lane of the warp must call it.
__device__ __forceinline__ int find_seat(const int* __restrict__ gs, int n, int s) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32) {
    const unsigned hit = __ballot_sync(0xffffffffu, base + lane < n && gs[base + lane] == s);
    if (hit) return base + __ffs(hit) - 1;
  }
  return -1;
}

// Positions [0, prefix_hi) of group g come from its prefix pages.
__device__ __forceinline__ int prefix_hi(const Plan& p, const int* __restrict__ lens, int g) {
  return min(max(lens[g], 0) / p.ps, p.P_pre) * p.ps;
}

// Key range [lo, hi) of slot s past its seat's prefix (hi capped at the
// page table's P * ps positions), and its group (-1 when ungrouped).
template <typename T>
__device__ __forceinline__ void slot_range(const Plan& p, const Args<T>& a, int s, int& grp,
                                           int& seat, int& lo, int& hi) {
  const int i = p.NG > 0 ? find_seat(a.group_slots, p.NG * p.G, s) : -1;
  grp = i >= 0 ? i / p.G : -1;
  seat = i >= 0 ? i - grp * p.G : 0;
  lo = grp >= 0 ? (max(a.group_prefix_lens[grp], 0) / p.ps) * p.ps : 0;
  hi = min(max(a.seq_lens[s], 1), p.P * p.ps);
}

struct Item {
  int lo, hi;           // key positions, lo < hi
  int rows;             // query rows, <= kItemRows
  const int* row;       // page-table row of the keys
  int ncols;            // its columns
  int h;                // kv head
  size_t stat0;         // first row's index into the item's m / l (acc: x D)
  bool prefix;          // a prefix item (its partials are m_p, l_p, acc_p)
  int owner, rb;        // the group (prefix) or slot (suffix); the row block
};

// Decode item i; false when its range is empty (the same on every thread).
template <typename T>
__device__ __forceinline__ bool decode_item(int i, const Plan& p, const Args<T>& a, Item& it) {
  const int ct = p.C * p.ps;
  const int n_pre = n_prefix_items(p);
  if (i < n_pre) {
    const int per = p.NG * p.Hkv * p.RBp;
    const int c = i / per, r = i - c * per;
    const int g = r / (p.Hkv * p.RBp), r2 = r - g * p.Hkv * p.RBp;
    it.h = r2 / p.RBp;
    it.rb = r2 - it.h * p.RBp;
    it.owner = g;
    it.prefix = true;
    it.lo = c * ct;
    it.hi = min(prefix_hi(p, a.group_prefix_lens, g), (c + 1) * ct);
    const int gr = p.G * p.rep;
    it.rows = min(kItemRows, gr - it.rb * kItemRows);
    it.row = a.group_prefix_pages + (size_t)g * p.P_pre;
    it.ncols = p.P_pre;
    it.stat0 = (((size_t)g * p.Hkv + it.h) * p.NCp + c) * gr + (size_t)it.rb * kItemRows;
    return it.lo < it.hi;
  }
  const int j = i - n_pre, per = p.S * p.Hkv * p.RB;
  const int c = j / per, r = j - c * per;
  const int s = r / (p.Hkv * p.RB), r2 = r - s * p.Hkv * p.RB;
  it.h = r2 / p.RB;
  it.rb = r2 - it.h * p.RB;
  it.owner = s;
  it.prefix = false;
  int grp, seat, lo, hi;
  slot_range(p, a, s, grp, seat, lo, hi);
  it.lo = max(lo, c * ct);
  it.hi = min(hi, (c + 1) * ct);
  it.rows = min(kItemRows, p.rep - it.rb * kItemRows);
  it.row = a.page_table + (size_t)s * p.P;
  it.ncols = p.P;
  it.stat0 = (((size_t)s * p.Hkv + it.h) * p.NC + c) * p.rep + (size_t)it.rb * kItemRows;
  return it.lo < it.hi;
}

// False when item i surely has no work: its chunk starts past the prefix
// (prefix item) or past the row's end (suffix item). One load, no seat
// search; decode_item decides the rest.
template <typename T>
__device__ __forceinline__ bool may_have_work(int i, const Plan& p, const Args<T>& a) {
  const int ct = p.C * p.ps, n_pre = n_prefix_items(p);
  if (i < n_pre) {
    const int per = p.NG * p.Hkv * p.RBp, c = i / per;
    return c * ct < prefix_hi(p, a.group_prefix_lens, (i - c * per) / (p.Hkv * p.RBp));
  }
  const int j = i - n_pre, per = p.S * p.Hkv * p.RB, c = j / per;
  const int s = (j - c * per) / (p.Hkv * p.RB);
  return c * ct < min(max(a.seq_lens[s], 1), p.P * p.ps);
}

// Call body(it) for each item i = blockIdx.x, blockIdx.x + gridDim.x, ...
// that has work, in that order. Most items of a long page table lie past
// their row's end: each lane of a warp tests one of the block's next 32
// items, so they are passed over 32 at a time, not one load after another.
// Every thread of the block calls it.
template <typename T, typename F>
__device__ __forceinline__ void for_each_item(const Plan& p, const Args<T>& a, F&& body) {
  const int total = n_items(p), lane = threadIdx.x & 31;
  for (long long base = blockIdx.x; base < total; base += 32LL * gridDim.x) {
    const long long i = base + (long long)lane * gridDim.x;
    unsigned todo = __ballot_sync(0xffffffffu, i < total && may_have_work((int)i, p, a));
    while (todo) {
      const int k = __ffs(todo) - 1;
      todo &= todo - 1;
      Item it;
      if (decode_item((int)(base + (long long)k * gridDim.x), p, a, it)) body(it);
    }
  }
}

// Query row r (< kItemRows) of item it, or nullptr for a padding row or an
// empty seat (both attend as zeros and are never read back).
template <typename T>
__device__ __forceinline__ const T* item_q_row(const Item& it, const Plan& p,
                                               const Args<T>& a, int r) {
  if (r >= it.rows) return nullptr;
  const int rr = it.rb * kItemRows + r;
  if (!it.prefix)
    return a.q + ((size_t)it.owner * p.Hq + (size_t)it.h * p.rep + rr) * p.D;
  const int c = rr / p.rep, j = rr - c * p.rep;
  const int slot = a.group_slots[(size_t)it.owner * p.G + c];
  if (slot < 0 || slot >= p.S) return nullptr;
  return a.q + ((size_t)slot * p.Hq + (size_t)it.h * p.rep + j) * p.D;
}

// The item's partial stats: rows stat0.. of m, l and acc.
template <typename T>
__device__ __forceinline__ void item_stats(const Item& it, const Plan& p, const Args<T>& a,
                                           float*& m, float*& l, float*& acc) {
  m = (it.prefix ? a.m_p : a.m_s) + it.stat0;
  l = (it.prefix ? a.l_p : a.l_s) + it.stat0;
  acc = (it.prefix ? a.acc_p : a.acc_s) + it.stat0 * p.D;
}

// -- bf16 instance: tensor cores ------------------------------------------------------

template <int D> __host__ __device__ constexpr size_t bf16_smem_bytes() {
  return (size_t)kItemRows * D * sizeof(bf16) + (size_t)kStages * 2 * kTile * D * sizeof(bf16) +
         kMaxCols * sizeof(int);
}

// Gather the K and V rows of positions pos0 .. pos0 + kTile - 1 of the item
// into the swizzled tiles ks, vs; positions >= it.hi are zero-filled. spt
// holds the pages of the item's columns, from column it.lo / ps on.
template <int D>
__device__ __forceinline__ void load_kv_tile(bf16* ks, bf16* vs, const bf16* __restrict__ kp,
                                             const bf16* __restrict__ vp, const int* spt,
                                             const Item& it, const Plan& p, int pos0) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  const int col0 = it.lo / p.ps;
#pragma unroll
  for (int k = 0; k < kTile * CH / kThreads; ++k) {
    const int i = k * kThreads + threadIdx.x, r = i / CH, c = i - r * CH, pos = pos0 + r;
    const bool ok = pos < it.hi;
    size_t off = 0;
    if (ok) {
      const int col = pos / p.ps;
      off = (((size_t)it.h * p.N + spt[col - col0]) * p.ps + (pos - col * p.ps)) * D + c * 8;
    }
    fm::cp_async16(ks + fm::swz<D>(r, c), kp + off, ok);
    fm::cp_async16(vs + fm::swz<D>(r, c), vp + off, ok);
  }
}

// Attend the item's rows over its key range and write their stats (base-2
// m) to m_out, l_out, acc_out. The pages of its columns are read once into
// spt, so that no tile's copies wait on a page-table load; the rows are
// staged in the swizzled [16][D] tile sq while the first K/V tiles are in
// flight. Every thread of the block calls it; it ends with a barrier.
template <int D>
__device__ void attend_item_bf16(const Args<bf16>& a, const Item& it, const Plan& p, bf16* sq,
                                 bf16* tiles, int* spt, float* __restrict__ m_out,
                                 float* __restrict__ l_out, float* __restrict__ acc_out) {
  constexpr int TE = kTile * D;  // elements of one K or V tile
  constexpr int CH = D / 8;      // 16-byte chunks of a row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3), k0 = 16 * warp;
  const float sl2 = p.scale * kLog2e;

  // the range starts on a page boundary (chunk starts and prefix lengths
  // are page multiples) and spans at most C <= kMaxCols columns
  const int col0 = it.lo / p.ps, n_cols = (it.hi - 1) / p.ps - col0 + 1;
  for (int k = threadIdx.x; k < n_cols; k += kThreads)
    spt[k] = min(max(it.row[min(col0 + k, it.ncols - 1)], 0), p.N - 1);
  __syncthreads();

  // a ring of kStages tiles, kStages - 1 in flight while one is attended;
  // every step commits a group (empty past the last tile) so that one
  // wait count fits all steps
  const int n_tiles = (it.hi - it.lo + kTile - 1) / kTile;
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      bf16* ks = tiles + (size_t)(tile % kStages) * 2 * TE;
      load_kv_tile<D>(ks, ks + TE, a.kp, a.vp, spt, it, p, it.lo + tile * kTile);
    }
    fm::cp_async_commit();
  };
#pragma unroll
  for (int tile = 0; tile < kStages - 1; ++tile) issue(tile);

  for (int k = threadIdx.x; k < kItemRows * CH; k += kThreads) {
    const int r = k / CH, c = k - r * CH;
    const bf16* src = item_q_row(it, p, a, r);
    *reinterpret_cast<uint4*>(sq + fm::swz<D>(r, c)) =
        src ? *reinterpret_cast<const uint4*>(src + c * 8) : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) fm::frag_a<D>(qa[kk], sq, 0, kk);
  float acc[D / 8][4];
  fm::zero(acc);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  for (int tile = 0; tile < n_tiles; ++tile) {
    issue(tile + kStages - 1);  // into the stage attended one step ago
    fm::cp_async_wait<kStages - 1>();
    __syncthreads();
    const bf16* ks = tiles + (size_t)(tile % kStages) * 2 * TE;
    const bf16* vs = ks + TE;
    // S = Q K^T over this warp's 16 keys: s[j] holds keys k0 + 8 j ..
    float s[2][4];
    fm::zero(s);
    fm::gemm_nt_reg<D, 16>(s, qa, ks, k0);
    const int key0 = it.lo + tile * kTile + k0 + t2;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + 8 * j + (e & 1) < it.hi;
        s[j][e] = ok ? s[j][e] * sl2 : NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
        else mx1 = fmaxf(mx1, s[j][e]);
      }
    const float n0 = fmaxf(m0, fm::quad_max(mx0)), n1 = fmaxf(m1, fm::quad_max(mx1));
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + 8 * j + (e & 1) < it.hi;
        const float pr = ok ? exp2f(s[j][e] - (e < 2 ? n0 : n1)) : 0.f;
        s[j][e] = pr;
        if (e < 2) r0 += pr;
        else r1 += pr;
      }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= a0, acc[dn][1] *= a0;
      acc[dn][2] *= a1, acc[dn][3] *= a1;
    }
    fm::gemm_pv<D, 16>(acc, s, vs, k0);
    __syncthreads();  // this stage is refilled next
  }
  l0 = fm::quad_sum(l0);
  l1 = fm::quad_sum(l1);

  // merge the 4 warps' states through shared memory (the tiles are free)
  constexpr int RS = D + 4;  // padded row of the f32 accumulators
  float* rm = reinterpret_cast<float*>(tiles);  // [warp][16]
  float* rl = rm + kWarps * kItemRows;
  float* racc = rl + kWarps * kItemRows;        // [warp][16][RS]
  if ((lane & 3) == 0) {
    rm[warp * kItemRows + g] = m0, rm[warp * kItemRows + g + 8] = m1;
    rl[warp * kItemRows + g] = l0, rl[warp * kItemRows + g + 8] = l1;
  }
  float* w0 = racc + (size_t)(warp * kItemRows + g) * RS + t2;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    *reinterpret_cast<float2*>(w0 + dn * 8) = make_float2(acc[dn][0], acc[dn][1]);
    *reinterpret_cast<float2*>(w0 + 8 * RS + dn * 8) = make_float2(acc[dn][2], acc[dn][3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < it.rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, rm[w * kItemRows + r]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum += exp2f(rm[w * kItemRows + r] - mx) * racc[(size_t)(w * kItemRows + r) * RS + d];
    acc_out[i] = sum;
    if (d == 0) {
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        lsum += exp2f(rm[w * kItemRows + r] - mx) * rl[w * kItemRows + r];
      m_out[r] = mx;
      l_out[r] = lsum;
    }
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(kThreads, kBf16Blocks)
    paged_split_bf16_kernel(Args<bf16> a, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [16][D] swizzled query rows
  bf16* tiles = sq + kItemRows * D;          // [kStages][K, V][kTile][D] swizzled
  int* spt = reinterpret_cast<int*>(tiles + (size_t)kStages * 2 * kTile * D);  // [kMaxCols]
  for_each_item(p, a, [&](const Item& it) {
    float *m, *l, *acc;
    item_stats(it, p, a, m, l, acc);
    attend_item_bf16<D>(a, it, p, sq, tiles, spt, m, l, acc);
  });
}

// -- f32 instance: CUDA cores ---------------------------------------------------------
//
// Each page's K and V tiles ([page_size, D] each) are staged whole into
// shared memory with 16-byte cp.async copies, double-buffered. Tile rows are
// padded by 16 bytes so that threads reading different key rows hit
// different banks. One block attends the item's R rows with an f32 online
// softmax (m, l, acc) in shared memory.

constexpr int kVec = 4;  // floats in 16 bytes

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory of an f32 block: two stages of K and V page tiles,
// then the online-softmax state of R query rows.
struct Smem {
  float* tiles;  // [2 stages][K, V][ps][D + 4]
  float* q;      // [R, D] query rows
  float* acc;    // [R, D] unnormalised output
  float* m;      // [R] running max
  float* l;      // [R] running denominator
  float* alpha;  // [R] rescale of the current page
  float* p;      // [R, ps] logits, then probabilities
};

__host__ __device__ inline size_t tile_bytes(int D, int ps) {
  return 4 * (size_t)ps * (D * sizeof(float) + 16);
}

inline size_t smem_bytes(int R, int D, int ps) {
  return tile_bytes(D, ps) +
         sizeof(float) * (2 * (size_t)R * D + 3 * (size_t)R + (size_t)R * ps);
}

__device__ __forceinline__ Smem carve(unsigned char* base, int R, int D, int ps) {
  Smem st;
  st.tiles = reinterpret_cast<float*>(base);
  st.q = reinterpret_cast<float*>(base + tile_bytes(D, ps));
  st.acc = st.q + (size_t)R * D;
  st.m = st.acc + (size_t)R * D;
  st.l = st.m + R;
  st.alpha = st.l + R;
  st.p = st.alpha + R;
  return st;
}

// Start the copy of one page's K and V rows (element offset `base` of the
// pools) into stage `stage`, as one cp.async group.
__device__ __forceinline__ void issue_page(const float* __restrict__ kp,
                                           const float* __restrict__ vp, size_t base, int D,
                                           int ps, int stage, Smem st) {
  constexpr int V = kVec;
  const int rs = D + V, vecs = D / V;
  float* ks = st.tiles + (size_t)stage * 2 * ps * rs;
  float* vs = ks + (size_t)ps * rs;
  for (int i = threadIdx.x; i < ps * vecs; i += kThreads) {
    const int t = i / vecs, c = i - t * vecs;
    fm::cp_async16(ks + t * rs + c * V, kp + base + (size_t)t * D + c * V, true);
    fm::cp_async16(vs + t * rs + c * V, vp + base + (size_t)t * D + c * V, true);
  }
  fm::cp_async_commit();
}

// Attend the R query rows in st.q to one staged page whose first position
// is pos0; positions >= limit are masked. Every thread of the block calls it.
__device__ void attend_tile(int stage, int pos0, int limit, int R, int D, int ps, float scale,
                            Smem st) {
  constexpr int V = kVec;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = D + V;
  const float* ks = st.tiles + (size_t)stage * 2 * ps * rs;
  const float* vs = ks + (size_t)ps * rs;
  const int n_chunks = (R + kRowChunk - 1) / kRowChunk;

  // 1. logits: one thread per (key row, chunk of kRowChunk query rows); the
  //    query rows are the same for neighbouring threads (broadcast reads)
  for (int w = tid; w < ps * n_chunks; w += kThreads) {
    const int t = w % ps, r0 = (w / ps) * kRowChunk;
    const int rn = min(kRowChunk, R - r0);
    const float* krow = ks + (size_t)t * rs;
    float dot[kRowChunk];
#pragma unroll
    for (int j = 0; j < kRowChunk; ++j) dot[j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += V) {
      float kv[V];
      load16(krow + d0, kv);
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j) {
        if (j < rn) {
          float qv[V];
          load16(st.q + (size_t)(r0 + j) * D + d0, qv);
          dot[j] += qv[0] * kv[0] + qv[1] * kv[1] + qv[2] * kv[2] + qv[3] * kv[3];
        }
      }
    }
    const bool ok = pos0 + t < limit;
#pragma unroll
    for (int j = 0; j < kRowChunk; ++j)
      if (j < rn) st.p[(size_t)(r0 + j) * ps + t] = ok ? dot[j] * scale : NEG_INF;
  }
  __syncthreads();

  // 2. online-softmax update, one warp per query row
  for (int r = warp; r < R; r += kWarps) {
    float* pr = st.p + (size_t)r * ps;
    float mx = NEG_INF;
    for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, pr[t]);
    mx = warp_max(mx);
    const float m_prev = st.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < ps; t += 32) {
      const float e = pos0 + t < limit ? expf(pr[t] - m_new) : 0.f;
      pr[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      st.alpha[r] = a;
      st.l[r] = a * st.l[r] + sum;
      st.m[r] = m_new;
    }
  }
  __syncthreads();

  // 3. acc[r, d] = alpha[r] * acc[r, d] + sum_t p[r, t] * v[t, d]: one
  //    thread per column d, kRowChunk rows in registers per pass
  for (int r0 = 0; r0 < R; r0 += kRowChunk) {
    const int rn = min(kRowChunk, R - r0);
    for (int d = tid; d < D; d += kThreads) {
      float a[kRowChunk];
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j)
        a[j] = j < rn ? st.acc[(size_t)(r0 + j) * D + d] * st.alpha[r0 + j] : 0.f;
#pragma unroll 4
      for (int t = 0; t < ps; ++t) {
        const float vv = vs[(size_t)t * rs + d];
#pragma unroll
        for (int j = 0; j < kRowChunk; ++j)
          if (j < rn) a[j] += st.p[(size_t)(r0 + j) * ps + t] * vv;
      }
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j)
        if (j < rn) st.acc[(size_t)(r0 + j) * D + d] = a[j];
    }
  }
}

// Attend st.q's R rows over the item's pages (its range starts on a page
// boundary: chunk starts and prefix lengths are page multiples), the next
// page in flight while the current one is attended.
__device__ void attend_item_f32(const float* __restrict__ kp, const float* __restrict__ vp,
                                const Item& it, const Plan& p, Smem st) {
  const int col0 = it.lo / p.ps, n_pages = (it.hi + p.ps - 1) / p.ps - col0;
  auto base_of = [&](int pg) {
    const int page = min(max(it.row[min(col0 + pg, it.ncols - 1)], 0), p.N - 1);
    return ((size_t)it.h * p.N + page) * p.ps * p.D;
  };
  issue_page(kp, vp, base_of(0), p.D, p.ps, 0, st);
  for (int pg = 0; pg < n_pages; ++pg) {
    if (pg + 1 < n_pages) {
      issue_page(kp, vp, base_of(pg + 1), p.D, p.ps, (pg + 1) & 1, st);
      fm::cp_async_wait<1>();
    } else {
      fm::cp_async_wait<0>();
    }
    __syncthreads();
    attend_tile(pg & 1, (col0 + pg) * p.ps, it.hi, it.rows, p.D, p.ps, p.scale, st);
    __syncthreads();  // stage pg & 1 is refilled in the next iteration
  }
}

__global__ void __launch_bounds__(kThreads) paged_split_f32_kernel(Args<float> a, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem st = carve(smem, kItemRows, p.D, p.ps);
  for_each_item(p, a, [&](const Item& it) {
    for (int k = threadIdx.x; k < it.rows * p.D; k += kThreads) {
      const int r = k / p.D;
      const float* src = item_q_row(it, p, a, r);
      st.q[k] = src ? src[k - r * p.D] : 0.f;
      st.acc[k] = 0.f;
    }
    for (int r = threadIdx.x; r < it.rows; r += kThreads) {
      st.m[r] = NEG_INF;
      st.l[r] = 0.f;
    }
    __syncthreads();
    attend_item_f32(a.kp, a.vp, it, p, st);
    float *m, *l, *acc;
    item_stats(it, p, a, m, l, acc);
    for (int k = threadIdx.x; k < it.rows * p.D; k += kThreads) acc[k] = st.acc[k];
    for (int r = threadIdx.x; r < it.rows; r += kThreads) {
      m[r] = st.m[r];
      l[r] = st.l[r];
    }
    __syncthreads();  // st is reused by the next item
  });
}

// -- combine ---------------------------------------------------------------------------

// One block per (slot, kv head, row block): merge the slot's partials, its
// seat's prefix chunks first, then its own chunks, each in chunk order, and
// write out = acc / max(l, 1e-30) in T.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(Args<T> a, Plan p) {
  const int s = blockIdx.x, h = blockIdx.y, rb = blockIdx.z;
  const int rows = min(kItemRows, p.rep - rb * kItemRows);
  const int ct = p.C * p.ps;
  int grp, seat, lo, hi;
  slot_range(p, a, s, grp, seat, lo, hi);
  const int s0 = lo < hi ? lo / ct : 0, s1 = lo < hi ? (hi + ct - 1) / ct : 0;
  const int p1 = grp >= 0 ? (prefix_hi(p, a.group_prefix_lens, grp) + ct - 1) / ct : 0;
  const int gr = p.G * p.rep;
  const size_t pre0 = grp >= 0 ? ((size_t)grp * p.Hkv + h) * p.NCp * gr + (size_t)seat * p.rep : 0;
  const size_t own0 = ((size_t)s * p.Hkv + h) * p.NC * p.rep;
  for (int i = threadIdx.x; i < rows * p.D; i += kThreads) {
    const int r = i / p.D, d = i - r * p.D, rr = rb * kItemRows + r;
    float mx = NEG_INF;
    for (int c = 0; c < p1; ++c) mx = fmaxf(mx, a.m_p[pre0 + (size_t)c * gr + rr]);
    for (int c = s0; c < s1; ++c) mx = fmaxf(mx, a.m_s[own0 + (size_t)c * p.rep + rr]);
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < p1; ++c) {
      const size_t k = pre0 + (size_t)c * gr + rr;
      const float w = stat_exp(a.m_p[k] - mx, T());
      l += w * a.l_p[k];
      acc += w * a.acc_p[k * p.D + d];
    }
    for (int c = s0; c < s1; ++c) {
      const size_t k = own0 + (size_t)c * p.rep + rr;
      const float w = stat_exp(a.m_s[k] - mx, T());
      l += w * a.l_s[k];
      acc += w * a.acc_s[k * p.D + d];
    }
    a.out[((size_t)s * p.Hq + (size_t)h * p.rep + rr) * p.D + d] =
        from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
}

// -- launch ----------------------------------------------------------------------------

// Opt the kernel into `bytes` of dynamic shared memory and the SM's largest
// shared-memory carveout once, and return how many of its blocks fit on the
// card at once (the persistent grid).
template <typename K> inline int resident_blocks(K kernel, size_t bytes, cudaError_t& err) {
  struct Entry {
    const void* fn;
    size_t bytes;
    int dev, blocks;
  };
  static std::mutex mu;
  static Entry cache[16];
  static int n_cache = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_cache; ++i)
    if (cache[i].fn == (const void*)kernel && cache[i].bytes == bytes && cache[i].dev == dev)
      return cache[i].blocks;
  if (bytes > kMaxSmem) {
    err = cudaErrorInvalidValue;
    return 0;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int sms = 0, per = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, bytes);
  if (err != cudaSuccess) return 0;
  const int blocks = sms * (per > 0 ? per : 1);
  if (n_cache < 16) cache[n_cache++] = Entry{(const void*)kernel, bytes, dev, blocks};
  return blocks;
}

// phases: 1 = the split kernel, 2 = the combine kernel, 3 = both (the
// wrapper's call; the others time one launch at a time).
template <typename K, typename T>
inline int launch_pair(K split, size_t smem, const Args<T>& a, const Plan& p, int phases,
                       cudaStream_t stream) {
  if (phases & 1) {
    cudaError_t e;
    const int resident = resident_blocks(split, smem, e);
    if (e != cudaSuccess) return (int)e;
    const int total = n_items(p), grid = total < resident ? total : resident;
    if (grid > 0) split<<<grid, kThreads, smem, stream>>>(a, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (phases & 2) {
    paged_combine_kernel<T><<<dim3(p.S, p.Hkv, p.RB), kThreads, 0, stream>>>(a, p);
    return (int)cudaGetLastError();
  }
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (D 64 or 128). The Python wrapper checks
// the shapes; what reaches here unchecked returns cudaErrorInvalidValue.
inline int launch_attention(const void* q, const void* kp, const void* vp, const void* pt,
                            const void* lens, const void* gslots, const void* gpages,
                            const void* glens, void* stats_s, void* stats_p, void* out,
                            int dtype, Plan p, int phases, cudaStream_t stream) {
  if (p.S <= 0) return 0;
  if (p.Hkv <= 0 || p.Hq % p.Hkv || p.C <= 0 || p.C > kMaxCols || p.ps <= 0 || p.P <= 0 ||
      p.D % 32 ||
      p.D > 256 || (p.NG > 0 && (p.G <= 0 || p.P_pre <= 0)))
    return (int)cudaErrorInvalidValue;
  p.rep = p.Hq / p.Hkv;
  p.NC = (p.P + p.C - 1) / p.C;
  p.RB = (p.rep + kItemRows - 1) / kItemRows;
  p.NCp = p.NG > 0 ? (p.P_pre + p.C - 1) / p.C : 0;
  p.RBp = p.NG > 0 ? (p.G * p.rep + kItemRows - 1) / kItemRows : 0;
  // stats: m [n], l [n], acc [n, D] f32, for n = S Hkv NC rep (suffix) and
  // NG Hkv NCp G rep (prefix)
  const size_t ns = (size_t)p.S * p.Hkv * p.NC * p.rep;
  const size_t np = (size_t)p.NG * p.Hkv * p.NCp * p.G * p.rep;
  float* fs = (float*)stats_s;
  float* fp = (float*)stats_p;
  switch (dtype) {
    case 0: {
      Args<float> a{(const float*)q, (const float*)kp, (const float*)vp, (const int*)pt,
                    (const int*)lens, (const int*)gslots, (const int*)gpages,
                    (const int*)glens, fs + ns * p.D, fs + ns * p.D + ns, fs,
                    fp + np * p.D, fp + np * p.D + np, fp, (float*)out};
      return launch_pair(paged_split_f32_kernel, smem_bytes(kItemRows, p.D, p.ps), a, p,
                         phases, stream);
    }
    case 1: {
      Args<bf16> a{(const bf16*)q, (const bf16*)kp, (const bf16*)vp, (const int*)pt,
                   (const int*)lens, (const int*)gslots, (const int*)gpages,
                   (const int*)glens, fs + ns * p.D, fs + ns * p.D + ns, fs,
                   fp + np * p.D, fp + np * p.D + np, fp, (bf16*)out};
      if (p.D == 64)
        return launch_pair(paged_split_bf16_kernel<64>, bf16_smem_bytes<64>(), a, p, phases,
                           stream);
      if (p.D == 128)
        return launch_pair(paged_split_bf16_kernel<128>, bf16_smem_bytes<128>(), a, p, phases,
                           stream);
      return (int)cudaErrorInvalidValue;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace polyrl
