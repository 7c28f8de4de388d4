// Blockwise magnitude Top-K kernels for Hopper (sm_90a): the wire codec,
// its error-feedback variant, and the dense masks.
//
// Five kernels with a plain C interface, loaded from Python with ctypes
// (repro_torch/kernels/topk_compress.py).  Each replaces one Pallas kernel
// of src/repro/kernels/topk_compress.py:
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
// All five are bound by memory bytes: per element they read one value (two
// with error feedback) and write one dense value per dense output, plus
// 1/32 of a word and k/B values for the wire.  Their design keeps device
// memory traffic at that minimum: one CTA owns one block, reads each input
// from device memory once into shared memory (the decode reads only the
// bitmap and the packed values), does every pass of the selection, the tie
// cap and the compaction on chip, and writes each output once.  The
// padding is made inside the kernel, so the wrappers copy nothing.  The
// k-th largest magnitude is found exactly with a radix select over the bit
// patterns (4 passes of 8 bits, a shared-memory histogram each), where the
// TPU kernels ran a 31-step binary search.  One __ballot_sync over 32
// consecutive elements is one bitmap word; __popc of the words, scanned
// over the block's words by one warp, gives each kept value its slot.
//
// Magnitudes are computed from the raw storage bits: clearing the sign bit
// of an f32 or bf16 value gives |x| exactly (bf16 is the top half of an
// f32), and f16 widens exactly through __half2float.  -0.0 has magnitude 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlock = 4096;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = kMaxBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// Shared memory of one selecting CTA: the block's magnitude bits and
// values, the radix histogram, and the per-word masks and value offsets.
template <typename Raw> struct Smem {
  uint32_t bits[kMaxBlock];
  Raw vals[kMaxBlock];
  int hist[256];
  uint32_t above[kMaxWords];
  uint32_t tie[kMaxWords];
  int off[kMaxWords];
  int sel[2];
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

// Stage this CTA's block in shared memory (x, or c = round(x + r) when EF;
// zero past the end of the tensor) and find the exact k-th largest
// magnitude by a radix select from the top byte.  Shared by every
// selecting kernel.
template <int KIND, bool EF>
__device__ Select stage_and_select(const typename Codec<KIND>::Raw* x,
                                   const typename Codec<KIND>::Raw* r,
                                   Smem<typename Codec<KIND>::Raw>& sm,
                                   long long n, int block, int k) {
  using Raw = typename Codec<KIND>::Raw;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * block;

  for (int i = tid; i < block; i += kThreads) {
    const long long g = base + i;
    Raw v = Raw(0);
    if (g < n) {
      if constexpr (EF) v = Codec<KIND>::add(x[g], r[g]);
      else v = x[g];
    }
    sm.vals[i] = v;
    sm.bits[i] = Codec<KIND>::mag(v);
  }
  __syncthreads();

  // `rank` is the 1-based rank still sought among elements matching
  // `prefix` on the bits decided so far.
  uint32_t prefix = 0, pmask = 0;
  int rank = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) sm.hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < block; i += kThreads) {
      const uint32_t b = sm.bits[i];
      if ((b & pmask) == prefix) atomicAdd(&sm.hist[(b >> shift) & 255u], 1);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins [8l, 8l+8); higher bins are larger magnitudes
      int cnt[8];
      int own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = sm.hist[lane * 8 + j];
        own += cnt[j];
      }
      int suffix = own;  // inclusive suffix sum: this lane and all above
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_down_sync(kFull, suffix, off);
        if (lane + off < 32) suffix += u;
      }
      int above = suffix - own;
      if (above < rank && rank <= suffix) {
        for (int j = 7; j >= 0; --j) {
          if (above + cnt[j] >= rank) {
            sm.sel[0] = lane * 8 + j;
            sm.sel[1] = rank - above;
            break;
          }
          above += cnt[j];
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(sm.sel[0]) << shift;
    pmask |= 255u << shift;
    rank = sm.sel[1];
    __syncthreads();
  }
  return Select{prefix, rank};
}

// Wire encode of x (EF false) or of c = round(x + r) (EF true, which also
// writes new_r).
template <int KIND, bool EF>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const typename Codec<KIND>::Raw* __restrict__ x,
              const typename Codec<KIND>::Raw* __restrict__ r,
              typename Codec<KIND>::Raw* __restrict__ values,
              uint32_t* __restrict__ bitmap,
              typename Codec<KIND>::Raw* __restrict__ new_r,
              long long n, int block, int k) {
  using Raw = typename Codec<KIND>::Raw;
  __shared__ Smem<Raw> sm;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = block >> 5;
  const Select sel = stage_and_select<KIND, EF>(x, r, sm, n, block, k);

  // One ballot per 32 consecutive elements: the words of "above" and
  // "tie" masks, LSB-first.
  for (int w = warp; w < words; w += kWarps) {
    const uint32_t b = sm.bits[w * 32 + lane];
    const uint32_t a = __ballot_sync(kFull, b > sel.thr);
    const uint32_t t = __ballot_sync(kFull, b == sel.thr);
    if (lane == 0) {
      sm.above[w] = a;
      sm.tie[w] = t;
    }
  }
  __syncthreads();

  // One warp walks the words in order: cap the ties, emit each bitmap
  // word, and scan the kept counts into each word's first value slot.
  if (warp == 0) {
    int tie_carry = 0, keep_carry = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
      const int w = w0 + lane;
      const uint32_t a = w < words ? sm.above[w] : 0u;
      const uint32_t t = w < words ? sm.tie[w] : 0u;
      const int nt = __popc(t);
      const int tie_incl = warp_scan(nt, lane);
      const int ties_before = tie_carry + tie_incl - nt;
      const int take = min(max(sel.keep_ties - ties_before, 0), nt);
      uint32_t kept_ties = 0u, rest = t;
      if (take == nt) {
        kept_ties = t;
      } else {
        for (int j = 0; j < take; ++j) {  // lowest `take` set bits
          const uint32_t low = rest & (0u - rest);
          kept_ties |= low;
          rest ^= low;
        }
      }
      const uint32_t keep = a | kept_ties;
      const int nk = __popc(keep);
      const int keep_incl = warp_scan(nk, lane);
      if (w < words) {
        sm.above[w] = keep;
        sm.off[w] = keep_carry + keep_incl - nk;
        bitmap[static_cast<long long>(blockIdx.x) * words + w] = keep;
      }
      tie_carry += __shfl_sync(kFull, tie_incl, 31);
      keep_carry += __shfl_sync(kFull, keep_incl, 31);
    }
  }
  __syncthreads();

  // Compaction: each kept value goes to its slot, in index order.
  Raw* out = values + static_cast<long long>(blockIdx.x) * k;
  for (int w = warp; w < words; w += kWarps) {
    const uint32_t keep = sm.above[w];
    if ((keep >> lane) & 1u) {
      const int slot = sm.off[w] + __popc(keep & ((1u << lane) - 1u));
      out[slot] = sm.vals[w * 32 + lane];
    }
  }

  if constexpr (EF) {
    // new residual: what was not sent, from the keep words in sm.above
    const long long base = static_cast<long long>(blockIdx.x) * block;
    for (int i = tid; i < block; i += kThreads) {
      const long long g = base + i;
      if (g >= n) break;
      const bool kept = (sm.above[i >> 5] >> (i & 31)) & 1u;
      new_r[g] = kept ? Raw(0) : sm.vals[i];
    }
  }
}

// Dense mask of x (EF false: out = sent) or of c = round(x + r) (EF true:
// out = sent, new_r = c - sent).  Keeps every threshold tie.
template <int KIND, bool EF>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const typename Codec<KIND>::Raw* __restrict__ x,
             const typename Codec<KIND>::Raw* __restrict__ r,
             typename Codec<KIND>::Raw* __restrict__ out,
             typename Codec<KIND>::Raw* __restrict__ new_r,
             long long n, int block, int k) {
  using Raw = typename Codec<KIND>::Raw;
  __shared__ Smem<Raw> sm;

  const Select sel = stage_and_select<KIND, EF>(x, r, sm, n, block, k);
  const long long base = static_cast<long long>(blockIdx.x) * block;
  for (int i = threadIdx.x; i < block; i += kThreads) {
    const long long g = base + i;
    if (g >= n) break;
    const Raw v = sm.vals[i];
    const Raw sent = sm.bits[i] >= sel.thr ? v : Raw(0);
    out[g] = sent;
    if constexpr (EF) new_r[g] = Codec<KIND>::sub(v, sent);
  }
}

template <typename Raw>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Raw* __restrict__ values,
              const uint32_t* __restrict__ bitmap, Raw* __restrict__ out,
              long long n, int block, int k) {
  __shared__ uint32_t s_words[kMaxWords];
  __shared__ int s_off[kMaxWords];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = block >> 5;

  for (int w = tid; w < words; w += kThreads)
    s_words[w] = bitmap[static_cast<long long>(blockIdx.x) * words + w];
  __syncthreads();

  // one warp: exclusive scan of the words' popcounts = first slot per word
  if (warp == 0) {
    int carry = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
      const int w = w0 + lane;
      const int c = w < words ? __popc(s_words[w]) : 0;
      const int incl = warp_scan(c, lane);
      if (w < words) s_off[w] = carry + incl - c;
      carry += __shfl_sync(kFull, incl, 31);
    }
  }
  __syncthreads();

  // dense block, trimmed to the tensor's n elements
  const Raw* vals = values + static_cast<long long>(blockIdx.x) * k;
  const long long base = static_cast<long long>(blockIdx.x) * block;
  for (int i = tid; i < block; i += kThreads) {
    const long long g = base + i;
    if (g >= n) break;
    const int w = i >> 5, b = i & 31;
    const uint32_t word = s_words[w];
    Raw v = Raw(0);
    if ((word >> b) & 1u) {
      // clamp as the reference does for a bitmap with more than k bits set
      const int slot = min(s_off[w] + __popc(word & ((1u << b) - 1u)), k - 1);
      v = vals[slot];
    }
    out[g] = v;
  }
}

bool bad_args(long long n, int nb, int block, int k, int kind) {
  return n <= 0 || nb <= 0 || block <= 0 || block % 32 != 0 ||
         block > kMaxBlock || k < 1 || k > block || kind < 0 || kind > 2 ||
         n > static_cast<long long>(nb) * block;
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

template <bool EF>
int encode_entry(const void* x, const void* r, void* values, void* bitmap,
                 void* new_r, long long n, int nb, int block, int k, int kind,
                 void* stream) {
  if (bad_args(n, nb, block, k, kind))
    return static_cast<int>(cudaErrorInvalidValue);
  using Fn = void (*)(const void*, const void*, void*, void*, void*,
                      long long, int, int, int, cudaStream_t);
  const Fn fns[3] = {launch_encode<0, EF>, launch_encode<1, EF>,
                     launch_encode<2, EF>};
  fns[kind](x, r, values, bitmap, new_r, n, nb, block, k,
            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

template <bool EF>
int dense_entry(const void* x, const void* r, void* out, void* new_r,
                long long n, int nb, int block, int k, int kind,
                void* stream) {
  if (bad_args(n, nb, block, k, kind))
    return static_cast<int>(cudaErrorInvalidValue);
  using Fn = void (*)(const void*, const void*, void*, void*, long long, int,
                      int, int, cudaStream_t);
  const Fn fns[3] = {launch_dense<0, EF>, launch_dense<1, EF>,
                     launch_dense<2, EF>};
  fns[kind](x, r, out, new_r, n, nb, block, k,
            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for arguments the kernels do not take.
// x, r, new_r, out, sent: n elements; values: (nb, k); bitmap: (nb,
// block/32) uint32 words.

int topk_encode(const void* x, void* values, void* bitmap, long long n,
                int nb, int block, int k, int kind, void* stream) {
  return encode_entry<false>(x, nullptr, values, bitmap, nullptr, n, nb,
                             block, k, kind, stream);
}

int topk_ef_encode(const void* x, const void* r, void* values, void* bitmap,
                   void* new_r, long long n, int nb, int block, int k,
                   int kind, void* stream) {
  return encode_entry<true>(x, r, values, bitmap, new_r, n, nb, block, k,
                            kind, stream);
}

int topk_mask_dense(const void* x, void* out, long long n, int nb, int block,
                    int k, int kind, void* stream) {
  return dense_entry<false>(x, nullptr, out, nullptr, n, nb, block, k, kind,
                            stream);
}

int topk_ef_dense(const void* x, const void* r, void* sent, void* new_r,
                  long long n, int nb, int block, int k, int kind,
                  void* stream) {
  return dense_entry<true>(x, r, sent, new_r, n, nb, block, k, kind, stream);
}

int topk_decode(const void* values, const void* bitmap, void* out,
                long long n, int nb, int block, int k, int kind,
                void* stream) {
  if (bad_args(n, nb, block, k, kind))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* words = static_cast<const uint32_t*>(bitmap);
  if (kind == 0) {
    decode_kernel<uint32_t><<<nb, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(values), words,
        static_cast<uint32_t*>(out), n, block, k);
  } else {
    decode_kernel<uint16_t><<<nb, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(values), words,
        static_cast<uint16_t*>(out), n, block, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
