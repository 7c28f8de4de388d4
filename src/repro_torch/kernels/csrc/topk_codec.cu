// Blockwise magnitude Top-K kernels for Hopper (sm_90a): the wire codec,
// its error-feedback variant, and the dense masks.
//
// Five kernels with a plain C interface, loaded from Python with ctypes
// (repro_torch/kernels/topk_compress.py, whose SIGNATURES table mirrors the
// extern "C" prototypes at the end of this file).  Each replaces one Pallas
// kernel of src/repro/kernels/topk_compress.py:
//
//   topk_encode      encode_topk, _encode_block_kernel (pallas_call :228)
//   topk_ef_encode   ef_encode_topk, _ef_encode_block_kernel (:255)
//   topk_decode      decode_topk, _decode_block_kernel (:279)
//   topk_mask_dense  blockwise_topk_mask, _topk_block_kernel (_grid_call,
//                    pallas_call :108)
//   topk_ef_dense    ef_topk, _ef_topk_block_kernel (_grid_call, :108)
//
// The tensor is cut into blocks of B elements (B a multiple of 32, at most
// 4096); the last block is zero-padded inside the kernel, and the padding
// zeros take part in selection.  Selection runs on the int32 bit patterns
// of |x| as float32, against the block's k-th largest one (thr).
//
// Wire format (encode, ef_encode, decode), per block: a bitmap of B/32
// 32-bit words, least significant bit first, and exactly k kept values in
// index order.  Kept = every element strictly above thr, plus the first
// k - n_above threshold ties in index order.
//
// Dense masks (mask_dense, ef_dense): every element with bits >= thr is
// kept, ties included and uncapped (a superset of k), the rest written as
// +0; with thr = 0 every element is kept.
//
// Error feedback (ef_encode, ef_dense): the block compressed is
// c = x + r rounded to the storage dtype (the float sum, then
// __float2bfloat16_rn / __float2half_rn), as eager PyTorch and the Pallas
// kernels' _force_rounding round it, so magnitudes come from c's own bits.
// ef_encode writes new_r = kept ? +0 : c; ef_dense writes new_r = c - sent
// in the storage dtype.  The two agree on every finite input.
//
// What bounds them on an H100: memory bytes.  Per element the encode reads
// one value (two with error feedback) and the decode writes one, plus the
// wire (1/32 of a word and k/B values); the dense kernels read one or two
// and write one or two.  At the training path's boundary shape (400 blocks
// of 4096 fp32, one wave on 132 SMs) that is about 2 us of HBM time, and
// the rest of a call is each block's chain on chip: with three CTAs of 16
// warps an SM, that chain is bound by the instructions the SM issues and
// the barriers between its phases.  So the design keeps the bytes at that
// minimum and cuts the instructions and barriers of the chain:
//
// - One CTA of 512 threads owns one block.  The block is staged once, in
//   shared memory, with 16-byte vector loads (4 fp32 or 8 bf16/fp16 a
//   thread); a ragged last block, or an input whose address is not 16-byte
//   aligned (a storage-offset view such as x[1:]), is staged one element at
//   a time instead.  Then each thread moves its share into registers in
//   the ballot layout (warp w owns 8 consecutive words, lane l element l of
//   each) and every later phase works from those registers: magnitudes are
//   recomputed from the values, never stored beside them.
// - Selection (select_threshold) is an exact radix select over the 31
//   significant bits of the magnitudes.  The first digit is their top 12
//   bits (sign excluded), histogrammed by the whole CTA into 4096 bins with
//   one shared-memory add an element; a warp whose elements share one
//   digit (all-zero, all-equal blocks) adds once.  A suffix scan over all
//   16 warps finds the digit holding the k-th largest.  The elements with
//   that digit are compacted into a candidate list, usually about 15 at
//   k = 41 of 4096 normal values: one warp ranks a list of at most 64 by
//   comparison, with no barrier.  A longer list (all-zero, all-equal and
//   heavy-tie blocks, up to the whole block) goes to the whole CTA, which
//   takes the candidates' common value when they all agree and otherwise
//   runs two more radix digits (12 and 7 bits) over the list.  The usual
//   path has six barriers, where four 8-bit passes over the block took
//   sixteen.
// - The wire: one __ballot_sync over 32 consecutive elements is one bitmap
//   word.  The tie cap and each word's first value slot come from one
//   block-wide exclusive scan of packed (above, tie) popcounts: each warp
//   scans its own words, then adds the totals of the warps below (one
//   barrier); __popc below a lane gives its slot within the word.  The
//   values, the residual and the dense masks are written from registers,
//   each warp instruction covering 32 consecutive elements.
// - The decode stages a block's k values in shared memory and writes the
//   dense block as 16-byte vectors (see decode_kernel).
//
// Magnitudes are computed from the raw storage bits: clearing the sign bit
// of an f32 or bf16 value gives |x| exactly (bf16 is the top half of an
// f32), and f16 widens exactly through __half2float.  -0.0 has magnitude 0.
//
// Resources (nvcc -Xptxas -v for sm_90a; the build log beside the library
// holds the report): __launch_bounds__(512, 4) caps every kernel at 32
// registers a thread, so that 4 CTAs of 16 warps fit on an SM (64 warps);
// a selecting CTA uses 32.9 KB of shared memory (the staged block or the
// candidate list, 16 KB; the histogram, 16 KB), the decode 16.4 KB (fp32).
// At 400 blocks every block is resident at once, three to an SM (48 warps,
// where the 256-thread CTAs before held 24).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 4096;
constexpr int kThreads = 512;
constexpr int kMinCtas = 4;                  // CTAs an SM must hold
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = kMaxBlock / 32;
constexpr int kMaxPer = kMaxWords / kWarps;  // words a warp owns, at most
constexpr int kDigit1 = 12;                 // first digit: bits 30..19
constexpr int kBins1 = 1 << kDigit1;
constexpr int kBinsPer = kBins1 / kThreads;  // first-pass bins a thread owns
constexpr int kShortList = 64;               // ranked by comparison
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBinsPer == 8, "each thread owns two int4 of bins");
static_assert(kMaxPer <= 32, "a lane holds one of its warp's words");

// KIND: 0 = float32, 1 = bfloat16, 2 = float16 (the wrapper's numbering).
// mag: |x| as float32 bits; add / sub: the float result rounded to the
// storage dtype.
template <int KIND> struct Codec;

template <> struct Codec<0> {
  using Raw = uint32_t;
  __device__ static uint32_t mag(Raw r) { return r & 0x7fffffffu; }
  __device__ static float f(Raw r) { return __uint_as_float(r); }
  __device__ static Raw add(Raw a, Raw b) {
    return __float_as_uint(__fadd_rn(f(a), f(b)));
  }
  __device__ static Raw sub(Raw a, Raw b) {
    return __float_as_uint(__fsub_rn(f(a), f(b)));
  }
};

template <> struct Codec<1> {
  using Raw = uint16_t;
  __device__ static uint32_t mag(Raw r) {
    return static_cast<uint32_t>(r & 0x7fffu) << 16;
  }
  __device__ static float f(Raw r) {
    return __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
  __device__ static Raw round(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static Raw add(Raw a, Raw b) { return round(__fadd_rn(f(a), f(b))); }
  __device__ static Raw sub(Raw a, Raw b) { return round(__fsub_rn(f(a), f(b))); }
};

template <> struct Codec<2> {
  using Raw = uint16_t;
  __device__ static uint32_t mag(Raw r) {
    return __float_as_uint(__half2float(
        __ushort_as_half(static_cast<unsigned short>(r & 0x7fffu))));
  }
  __device__ static float f(Raw r) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(r)));
  }
  __device__ static Raw round(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
  __device__ static Raw add(Raw a, Raw b) { return round(__fadd_rn(f(a), f(b))); }
  __device__ static Raw sub(Raw a, Raw b) { return round(__fsub_rn(f(a), f(b))); }
};

// 16 bytes of a block: 4 fp32 or 8 16-bit elements.
template <typename Raw> union Vec {
  static constexpr int kN = 16 / sizeof(Raw);
  uint4 u;
  Raw e[kN];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Shared memory of one selecting CTA.  The candidate list takes the staged
// block's place: it is written only after every thread has moved its
// share of the block into registers (before the first-pass barrier).
template <typename Raw> struct Smem {
  union {
    __align__(16) Raw vals[kMaxBlock];        // the block (c with EF)
    uint32_t cand[kMaxBlock];                 // then the candidates
  } b;
  __align__(16) int hist[kBins1];             // one radix digit's histogram
  int part[kWarps];                           // per-warp partial sums
  int pick[3];                                // digit, rank, count
  int ncand;
  uint32_t lo, hi;                            // the candidates' extremes
  uint32_t thr;
  int keep_ties;
};

struct Pick {
  int digit, rank, count;
};

struct Select {
  uint32_t thr;    // the block's k-th largest magnitude bit pattern
  int keep_ties;   // threshold ties within the first k, in index order
};

// Inclusive prefix sum over the 32 lanes of a warp.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// Inclusive suffix sum over the 32 lanes of a warp: this lane and above.
__device__ __forceinline__ int warp_suffix(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += u;
  }
  return v;
}

// Sum over the 32 lanes of a warp, in every lane.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Histogram add of digit d for the lanes where ok holds (the long list's
// digits).  A warp whose adding lanes all hold one digit adds once;
// otherwise each lane adds one, and only lanes that share a bin serialise.
// (Aggregating every warp, by __match_any_sync or by one ballot per digit
// bit, was measured slower on the H100 than the conflicts it removes.)
// All 32 lanes call it.
__device__ __forceinline__ void hist_add(int* hist, bool ok, uint32_t d) {
  const unsigned adders = __ballot_sync(kFull, ok);
  const int first = __ffs(adders) - 1;
  const uint32_t d0 = __shfl_sync(kFull, d, first & 31);
  if (__all_sync(kFull, !ok || d == d0)) {
    if (static_cast<int>(threadIdx.x & 31) == first)
      atomicAdd(&hist[d], __popc(adders));
  } else if (ok) {
    atomicAdd(&hist[d], 1);
  }
}

// Stage this CTA's block in shared memory: x, or c = round(x + r) when EF;
// zero past the end of the tensor.
template <int KIND, bool EF>
__device__ void stage(const typename Codec<KIND>::Raw* __restrict__ x,
                      const typename Codec<KIND>::Raw* __restrict__ r,
                      typename Codec<KIND>::Raw* vals, long long base,
                      long long n, int block) {
  using Raw = typename Codec<KIND>::Raw;
  using V = Vec<Raw>;
  const Raw* xb = x + base;
  const Raw* rb = EF ? r + base : nullptr;
  if (base + block <= n && aligned16(xb) && (!EF || aligned16(rb))) {
    for (int q = threadIdx.x; q < block / V::kN; q += kThreads) {
      V a;
      a.u = reinterpret_cast<const uint4*>(xb)[q];
      if constexpr (EF) {
        V b;
        b.u = reinterpret_cast<const uint4*>(rb)[q];
#pragma unroll
        for (int e = 0; e < V::kN; ++e) a.e[e] = Codec<KIND>::add(a.e[e], b.e[e]);
      }
      reinterpret_cast<uint4*>(vals)[q] = a.u;
    }
  } else {
    for (int i = threadIdx.x; i < block; i += kThreads) {
      Raw v = Raw(0);
      if (base + i < n) {
        if constexpr (EF) v = Codec<KIND>::add(xb[i], rb[i]);
        else v = xb[i];
      }
      vals[i] = v;
    }
  }
}

// A radix digit: the CTA's suffix scan over the histogram, each thread
// owning kBinsPer consecutive bins (higher bins are larger magnitudes).
// Returns the digit holding the rank-th largest element, the rank within
// it, and its count.  All threads call it (it holds two barriers).
template <typename Raw>
__device__ __forceinline__ Pick pick_digit(Smem<Raw>& sm, int rank) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int4* h4 = reinterpret_cast<const int4*>(sm.hist) + tid * 2;
  int4 lo = h4[0], hi = h4[1];
  const int own = lo.x + lo.y + lo.z + lo.w + hi.x + hi.y + hi.z + hi.w;
  int suffix = warp_suffix(own, lane);
  if (lane == 0) sm.part[warp] = suffix;
  __syncthreads();
  suffix += warp_sum(lane > warp && lane < kWarps ? sm.part[lane] : 0);
  int above = suffix - own;
  if (above < rank && rank <= suffix) {    // exactly one thread
    lo = h4[0];                            // its bins again, not kept live
    hi = h4[1];
    const int c[kBinsPer] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = kBinsPer - 1; j >= 0; --j) {
      if (above + c[j] >= rank) {
        sm.pick[0] = tid * kBinsPer + j;
        sm.pick[1] = rank - above;
        sm.pick[2] = c[j];
        break;
      }
      above += c[j];
    }
  }
  __syncthreads();
  return Pick{sm.pick[0], sm.pick[1], sm.pick[2]};
}

// The rank-th largest of a short candidate list (at most kShortList: the
// usual case, about 15 candidates at k = 41 of 4096 normal values), and
// the number of its ties to keep, by one warp and no barrier: lane l holds
// candidates l and l + 32 and counts the candidates above and equal to
// each, reading the list as broadcasts.  Writes thr and keep_ties.
template <typename Raw>
__device__ void rank_short_list(Smem<Raw>& sm, int rank, int count) {
  const int lane = threadIdx.x & 31;
  const uint32_t c0 = sm.b.cand[lane];    // past `count`: never chosen
  const uint32_t c1 = sm.b.cand[lane + 32];
  int gt0 = 0, eq0 = 0, gt1 = 0, eq1 = 0;
  for (int j = 0; j < count; ++j) {
    const uint32_t v = sm.b.cand[j];
    gt0 += v > c0;
    eq0 += v == c0;
    gt1 += v > c1;
    eq1 += v == c1;
  }
  const bool at0 = lane < count && gt0 < rank && rank <= gt0 + eq0;
  const bool at1 = lane + 32 < count && gt1 < rank && rank <= gt1 + eq1;
  const unsigned b0 = __ballot_sync(kFull, at0);
  const unsigned b1 = __ballot_sync(kFull, at1);
  // every candidate equal to the threshold qualifies: take one
  const int src = b0 ? __ffs(b0) - 1 : __ffs(b1) - 1;
  const uint32_t thr = __shfl_sync(kFull, b0 ? c0 : c1, src);
  const int gt = __shfl_sync(kFull, b0 ? gt0 : gt1, src);
  if (lane == 0) {
    sm.thr = thr;
    sm.keep_ties = rank - gt;
  }
}

// A long candidate list (all-zero, all-equal and heavy-tie blocks, where
// the list can be the whole block), by the CTA.  When the candidates are
// all one value (their extremes agree) that value is the threshold;
// otherwise two more radix digits run over the list, bits 18..7 and then
// 6..0, each a histogram of the candidates that match the prefix so far
// and a pick.  All threads call it.
template <typename Raw>
__device__ __forceinline__ Select rank_long_list(Smem<Raw>& sm,
                                                 uint32_t prefix, int rank,
                                                 int count) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t lo = kFull, hi = 0u;
  for (int i = tid; i < count; i += kThreads) {
    lo = min(lo, sm.b.cand[i]);
    hi = max(hi, sm.b.cand[i]);
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    atomicMin(&sm.lo, lo);
    atomicMax(&sm.hi, hi);
  }
  __syncthreads();
  if (sm.lo == sm.hi) return Select{sm.lo, rank};
  for (int shift = 7; shift >= 0; shift -= 7) {
    const uint32_t width = shift ? 12u : 7u;
    const uint32_t pmask = ~((1u << (shift + width)) - 1u);
    reinterpret_cast<int4*>(sm.hist)[tid] = make_int4(0, 0, 0, 0);
    reinterpret_cast<int4*>(sm.hist)[tid + kThreads] = make_int4(0, 0, 0, 0);
    __syncthreads();
    // a warp's lanes walk the list together (hist_add is collective)
    for (int i0 = (tid & ~31); i0 < count; i0 += kThreads) {
      const int i = i0 + lane;
      const uint32_t m = i < count ? sm.b.cand[i] : 0u;
      hist_add(sm.hist, i < count && (m & pmask) == (prefix & pmask),
               (m >> shift) & ((1u << width) - 1u));
    }
    __syncthreads();
    const Pick p = pick_digit(sm, rank);
    prefix |= static_cast<uint32_t>(p.digit) << shift;
    rank = p.rank;
  }
  return Select{prefix, rank};
}

// Stage this CTA's block, hand each thread its share of it in v, and find
// the block's exact k-th largest magnitude (see the note at the top).
// Warp w owns words [w0, w0 + per) of the block; v[j] is element
// (w0 + j) * 32 + lane, zero past the block's words.  Shared by every
// selecting kernel; all threads call it.
template <int KIND, bool EF>
__device__ __forceinline__ Select select_threshold(
    const typename Codec<KIND>::Raw* x, const typename Codec<KIND>::Raw* r,
    Smem<typename Codec<KIND>::Raw>& sm, long long n, int block, int k,
    typename Codec<KIND>::Raw (&v)[kMaxPer]) {
  using Raw = typename Codec<KIND>::Raw;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = block >> 5;
  const int per = (words + kWarps - 1) / kWarps;
  const int w0 = warp * per;
  const int own = max(min(per, words - w0), 0);
  constexpr int kShift = 31 - kDigit1;

  reinterpret_cast<int4*>(sm.hist)[tid] = make_int4(0, 0, 0, 0);
  reinterpret_cast<int4*>(sm.hist)[tid + kThreads] = make_int4(0, 0, 0, 0);
  if (tid == 0) {
    sm.ncand = 0;
    sm.lo = kFull;
    sm.hi = 0u;
  }
  stage<KIND, EF>(x, r, sm.b.vals, static_cast<long long>(blockIdx.x) * block,
                  n, block);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j)
    v[j] = j < own ? sm.b.vals[(w0 + j) * 32 + lane] : Raw(0);

  // First digit.  A warp whose elements all share one digit adds them
  // once (all-zero and all-equal blocks); otherwise each element adds one,
  // and only equal digits in one instruction serialise.
  const uint32_t d0 = __shfl_sync(kFull, Codec<KIND>::mag(v[0]) >> kShift, 0);
  bool same = true;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j)
    same &= j >= own || (Codec<KIND>::mag(v[j]) >> kShift) == d0;
  if (__all_sync(kFull, same)) {
    if (lane == 0 && own) atomicAdd(&sm.hist[d0], own * 32);
  } else {
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j)
      if (j < own) atomicAdd(&sm.hist[Codec<KIND>::mag(v[j]) >> kShift], 1);
  }
  __syncthreads();
  const Pick p = pick_digit(sm, k);
  const uint32_t digit = static_cast<uint32_t>(p.digit);

  // candidates: the magnitudes with that first digit, in any order
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const uint32_t m = Codec<KIND>::mag(v[j]);
    const bool hit = j < own && (m >> kShift) == digit;
    const unsigned b = __ballot_sync(kFull, hit);
    if (b) {
      int at = 0;
      if (lane == 0) at = atomicAdd(&sm.ncand, __popc(b));
      at = __shfl_sync(kFull, at, 0);
      if (hit) sm.b.cand[at + __popc(b & ((1u << lane) - 1u))] = m;
    }
  }
  __syncthreads();
  if (p.count > kShortList) {
    const Select sel = rank_long_list(sm, digit << kShift, p.rank, p.count);
    // v again, from device memory: not kept in registers across the long
    // path, which would spill them on the usual one
    const Raw* xb = x + static_cast<long long>(blockIdx.x) * block;
    const Raw* rb = EF ? r + static_cast<long long>(blockIdx.x) * block : nullptr;
    const long long left = n - static_cast<long long>(blockIdx.x) * block;
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j) {
      const int i = (w0 + j) * 32 + lane;
      v[j] = Raw(0);
      if (j < own && i < left) {
        if constexpr (EF) v[j] = Codec<KIND>::add(xb[i], rb[i]);
        else v[j] = xb[i];
      }
    }
    return sel;
  }
  if (warp == 0) rank_short_list(sm, p.rank, p.count);
  __syncthreads();
  return Select{sm.thr, sm.keep_ties};
}

// Wire encode of x (EF false) or of c = round(x + r) (EF true, which also
// writes new_r).  Replaces _encode_block_kernel / _ef_encode_block_kernel.
template <int KIND, bool EF>
__global__ void __launch_bounds__(kThreads, kMinCtas)
encode_kernel(const typename Codec<KIND>::Raw* __restrict__ x,
              const typename Codec<KIND>::Raw* __restrict__ r,
              typename Codec<KIND>::Raw* __restrict__ values,
              uint32_t* __restrict__ bitmap,
              typename Codec<KIND>::Raw* __restrict__ new_r,
              long long n, int block, int k) {
  using Raw = typename Codec<KIND>::Raw;
  __shared__ Smem<Raw> sm;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int words = block >> 5;
  const int per = (words + kWarps - 1) / kWarps;
  const int w0 = warp * per;
  const int own = max(min(per, words - w0), 0);
  Raw v[kMaxPer];
  const Select sel = select_threshold<KIND, EF>(x, r, sm, n, block, k, v);

  // One ballot per 32 consecutive elements: the words of the "above" and
  // "tie" masks, LSB-first.  Lane j keeps word w0 + j.  (The ballots and
  // shuffles here and below stay out of branches the compiler cannot prove
  // uniform: inside one it wraps each in a collective sequence.)
  uint32_t a = 0u, t = 0u;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const uint32_t m = Codec<KIND>::mag(v[j]);
    const uint32_t aj = __ballot_sync(kFull, j < own && m > sel.thr);
    const uint32_t tj = __ballot_sync(kFull, j < own && m == sel.thr);
    if (lane == j) {
      a = aj;
      t = tj;
    }
  }

  // Block-wide exclusive scan of the packed (above << 16 | tie) counts
  // over the words: each warp scans its own, then adds the totals of the
  // warps below.  Ties are kept in index order up to keep_ties, so the
  // kept values before word w number aboves + min(ties, keep_ties).  Both
  // counts are at most 4096.
  const int nt = __popc(t);
  const int packed = (__popc(a) << 16) | nt;
  const int incl = warp_scan(packed, lane);
  if (lane == 31) sm.part[warp] = incl;
  __syncthreads();
  const int before =
      incl - packed + warp_sum(lane < warp ? sm.part[lane] : 0);
  const int ties_before = before & 0xffff;
  const int take = min(max(sel.keep_ties - ties_before, 0), nt);
  uint32_t kept_ties = t;
  if (take < nt) {                 // lowest `take` set bits
    kept_ties = 0u;
    uint32_t rest = t;
    for (int j = 0; j < take; ++j) {
      const uint32_t low = rest & (0u - rest);
      kept_ties |= low;
      rest ^= low;
    }
  }
  const uint32_t keep = a | kept_ties;
  const int off = (before >> 16) + min(ties_before, sel.keep_ties);
  if (lane < own)
    bitmap[static_cast<long long>(blockIdx.x) * words + w0 + lane] = keep;

  // Compaction: each kept value goes to its slot, in index order; with
  // EF, what was not sent is the new residual.
  Raw* out = values + static_cast<long long>(blockIdx.x) * k;
  const long long base = static_cast<long long>(blockIdx.x) * block;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const uint32_t kw = __shfl_sync(kFull, keep, j);
    const int ow = __shfl_sync(kFull, off, j);
    const bool kept = (kw >> lane) & 1u;
    if (j < own && kept) out[ow + __popc(kw & ((1u << lane) - 1u))] = v[j];
    if constexpr (EF) {
      const long long g = base + (w0 + j) * 32 + lane;
      if (j < own && g < n) new_r[g] = kept ? Raw(0) : v[j];
    }
  }
}

// Dense mask of x (EF false: out = sent) or of c = round(x + r) (EF true:
// out = sent, new_r = c - sent).  Keeps every threshold tie.  Replaces
// _topk_block_kernel / _ef_topk_block_kernel.
template <int KIND, bool EF>
__global__ void __launch_bounds__(kThreads, kMinCtas)
dense_kernel(const typename Codec<KIND>::Raw* __restrict__ x,
             const typename Codec<KIND>::Raw* __restrict__ r,
             typename Codec<KIND>::Raw* __restrict__ out,
             typename Codec<KIND>::Raw* __restrict__ new_r,
             long long n, int block, int k) {
  using Raw = typename Codec<KIND>::Raw;
  __shared__ Smem<Raw> sm;

  const int lane = threadIdx.x & 31;
  const int words = block >> 5;
  const int per = (words + kWarps - 1) / kWarps;
  const int w0 = (threadIdx.x >> 5) * per;
  const int own = max(min(per, words - w0), 0);
  Raw v[kMaxPer];
  const Select sel = select_threshold<KIND, EF>(x, r, sm, n, block, k, v);
  const long long base = static_cast<long long>(blockIdx.x) * block;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const long long g = base + (w0 + j) * 32 + lane;
    if (j < own && g < n) {
      const Raw sent = Codec<KIND>::mag(v[j]) >= sel.thr ? v[j] : Raw(0);
      out[g] = sent;
      if constexpr (EF) new_r[g] = Codec<KIND>::sub(v[j], sent);
    }
  }
}

// Wire -> dense.  Replaces _decode_block_kernel.  Bound by its dense
// write.  The k values are staged in shared memory with coalesced loads (a
// row of k values is not 16-byte aligned in general).  Warp w owns words
// [w0, w0 + per), its lane j word w0 + j: the slots before w0 are the
// popcounts of the words below, summed by the warp itself, so the block
// needs one barrier (for the staged values) and no scan in shared memory.
// Each warp writes its words' elements as 16-byte vectors, each vector's
// bits taken from its word, where the block is full and `out` aligned;
// element by element otherwise.
template <typename Raw>
__global__ void __launch_bounds__(kThreads, kMinCtas)
decode_kernel(const Raw* __restrict__ values,
              const uint32_t* __restrict__ bitmap, Raw* __restrict__ out,
              long long n, int block, int k) {
  using V = Vec<Raw>;
  __shared__ Raw s_vals[kMaxBlock];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = block >> 5;
  const int per = (words + kWarps - 1) / kWarps;
  const int w0 = warp * per;
  const int own = max(min(per, words - w0), 0);   // words this warp owns
  const Raw* row = values + static_cast<long long>(blockIdx.x) * k;
  const uint32_t* wrow = bitmap + static_cast<long long>(blockIdx.x) * words;
  for (int i = tid; i < k; i += kThreads) s_vals[i] = row[i];
  const uint32_t word = lane < own ? wrow[w0 + lane] : 0u;
  int below = 0;
  for (int w = lane; w < w0; w += 32) below += __popc(wrow[w]);
  const int nw = __popc(word);
  const int first = warp_sum(below) + warp_scan(nw, lane) - nw;
  __syncthreads();

  // element e of this warp's words: word e / 32, bit e % 32; slots past
  // k - 1 are clamped as the reference clamps a bitmap with more than k
  // bits set
  auto value = [=](int e, uint32_t wd, int slot0) {
    const int b = e & 31;
    if (!((wd >> b) & 1u)) return Raw(0);
    return s_vals[min(slot0 + __popc(wd & ((1u << b) - 1u)), k - 1)];
  };
  const long long base = static_cast<long long>(blockIdx.x) * block + w0 * 32;
  Raw* o = out + base;
  if (static_cast<long long>(blockIdx.x) * block + block <= n && aligned16(o)) {
    const int nvec = own * 32 / V::kN;
#pragma unroll
    for (int q0 = 0; q0 < kMaxPer * 32 / V::kN; q0 += 32) {
      const int q = q0 + lane;
      const int j = min(q * V::kN / 32, kMaxPer - 1);
      const uint32_t wd = __shfl_sync(kFull, word, j);
      const int slot0 = __shfl_sync(kFull, first, j);
      if (q < nvec) {
        V v;
#pragma unroll
        for (int e = 0; e < V::kN; ++e) v.e[e] = value(q * V::kN + e, wd, slot0);
        reinterpret_cast<uint4*>(o)[q] = v.u;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j) {
      const uint32_t wd = __shfl_sync(kFull, word, j);
      const int slot0 = __shfl_sync(kFull, first, j);
      if (j < own && base + j * 32 + lane < n)
        o[j * 32 + lane] = value(j * 32 + lane, wd, slot0);
    }
  }
}

bool bad_args(long long n, int nb, int block, int k, int kind, int device) {
  return n <= 0 || nb <= 0 || block <= 0 || block % 32 != 0 ||
         block > kMaxBlock || k < 1 || k > block || kind < 0 || kind > 2 ||
         device < 0 || n > static_cast<long long>(nb) * block;
}

// Run `launch` with `device` current, as a device guard would: the current
// device is set only when it differs, and restored afterwards.  Returns
// cudaGetLastError() after the launch.
template <typename F>
int on_device(int device, F launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch();
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// Launchers by dtype: one entry per KIND, cast from the C interface's
// untyped pointers.
template <int KIND, bool EF>
void launch_encode(const void* x, const void* r, void* values, void* bitmap,
                   void* new_r, long long n, int nb, int block, int k,
                   cudaStream_t s) {
  using Raw = typename Codec<KIND>::Raw;
  encode_kernel<KIND, EF><<<nb, kThreads, 0, s>>>(
      static_cast<const Raw*>(x), static_cast<const Raw*>(r),
      static_cast<Raw*>(values), static_cast<uint32_t*>(bitmap),
      static_cast<Raw*>(new_r), n, block, k);
}

template <int KIND, bool EF>
void launch_dense(const void* x, const void* r, void* out, void* new_r,
                  long long n, int nb, int block, int k, cudaStream_t s) {
  using Raw = typename Codec<KIND>::Raw;
  dense_kernel<KIND, EF><<<nb, kThreads, 0, s>>>(
      static_cast<const Raw*>(x), static_cast<const Raw*>(r),
      static_cast<Raw*>(out), static_cast<Raw*>(new_r), n, block, k);
}

template <typename Raw>
void launch_decode(const void* values, const void* bitmap, void* out,
                   long long n, int nb, int block, int k, cudaStream_t s) {
  decode_kernel<Raw><<<nb, kThreads, 0, s>>>(
      static_cast<const Raw*>(values), static_cast<const uint32_t*>(bitmap),
      static_cast<Raw*>(out), n, block, k);
}

template <bool EF>
int encode_entry(const void* x, const void* r, void* values, void* bitmap,
                 void* new_r, long long n, int nb, int block, int k, int kind,
                 int device, void* stream) {
  if (bad_args(n, nb, block, k, kind, device))
    return static_cast<int>(cudaErrorInvalidValue);
  using Fn = void (*)(const void*, const void*, void*, void*, void*,
                      long long, int, int, int, cudaStream_t);
  const Fn fns[3] = {launch_encode<0, EF>, launch_encode<1, EF>,
                     launch_encode<2, EF>};
  return on_device(device, [&] {
    fns[kind](x, r, values, bitmap, new_r, n, nb, block, k,
              static_cast<cudaStream_t>(stream));
  });
}

template <bool EF>
int dense_entry(const void* x, const void* r, void* out, void* new_r,
                long long n, int nb, int block, int k, int kind, int device,
                void* stream) {
  if (bad_args(n, nb, block, k, kind, device))
    return static_cast<int>(cudaErrorInvalidValue);
  using Fn = void (*)(const void*, const void*, void*, void*, long long, int,
                      int, int, cudaStream_t);
  const Fn fns[3] = {launch_dense<0, EF>, launch_dense<1, EF>,
                     launch_dense<2, EF>};
  return on_device(device, [&] {
    fns[kind](x, r, out, new_r, n, nb, block, k,
              static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for arguments the kernels do not take.  It
// launches on `device` (made current for the launch only) and `stream`.
// x, r, new_r, out, sent: n elements; values: (nb, k); bitmap: (nb,
// block/32) uint32 words.

int topk_encode(const void* x, void* values, void* bitmap, long long n,
                int nb, int block, int k, int kind, int device,
                void* stream) {
  return encode_entry<false>(x, nullptr, values, bitmap, nullptr, n, nb,
                             block, k, kind, device, stream);
}

int topk_ef_encode(const void* x, const void* r, void* values, void* bitmap,
                   void* new_r, long long n, int nb, int block, int k,
                   int kind, int device, void* stream) {
  return encode_entry<true>(x, r, values, bitmap, new_r, n, nb, block, k,
                            kind, device, stream);
}

int topk_mask_dense(const void* x, void* out, long long n, int nb, int block,
                    int k, int kind, int device, void* stream) {
  return dense_entry<false>(x, nullptr, out, nullptr, n, nb, block, k, kind,
                            device, stream);
}

int topk_ef_dense(const void* x, const void* r, void* sent, void* new_r,
                  long long n, int nb, int block, int k, int kind, int device,
                  void* stream) {
  return dense_entry<true>(x, r, sent, new_r, n, nb, block, k, kind, device,
                           stream);
}

int topk_decode(const void* values, const void* bitmap, void* out,
                long long n, int nb, int block, int k, int kind, int device,
                void* stream) {
  if (bad_args(n, nb, block, k, kind, device))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (kind == 0)
      launch_decode<uint32_t>(values, bitmap, out, n, nb, block, k, s);
    else
      launch_decode<uint16_t>(values, bitmap, out, n, nb, block, k, s);
  });
}

}  // extern "C"
