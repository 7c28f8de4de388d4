// Blockwise tie-capped Top-K wire codec for Hopper (sm_90a).
//
// Two kernels with a plain C interface, loaded from Python with ctypes
// (repro_torch/kernels/topk_compress.py):
//
//   topk_encode  replaces the TPU kernel `encode_topk`
//                (src/repro/kernels/topk_compress.py, _encode_block_kernel
//                with _kth_threshold_bits / _keep_capped_block /
//                _emit_encoded).
//   topk_decode  replaces the TPU kernel `decode_topk`
//                (src/repro/kernels/topk_compress.py, _decode_block_kernel).
//
// Wire format, per block of B elements (B a multiple of 32, at most 4096):
// a bitmap of B/32 32-bit words, least significant bit first, and exactly
// k kept values in index order.  Kept = every element whose |x| (as
// float32) is strictly above the block's k-th largest magnitude, plus the
// first k - n_above threshold ties in index order.  The last block is
// zero-padded; the padding zeros take part in selection.
//
// Both kernels are bound by memory bytes: per element the encode reads
// one value and writes 1/32 of a word plus k/B values; the decode does the
// reverse.  Their design keeps device memory traffic at that minimum: one
// CTA owns one block, reads it from device memory once into shared memory
// (encode) or reads only the bitmap and the packed values (decode), and
// does every pass of the selection, the tie cap and the compaction on chip.
// The padding of the last block is made inside the kernel, so the wrapper
// copies nothing.  The encode finds the exact k-th largest magnitude with a
// radix select over the int32 bit patterns of |x| (4 passes of 8 bits, a
// shared-memory histogram each), where the TPU kernel ran a 31-step binary
// search.  One __ballot_sync over 32 consecutive elements is one bitmap
// word; __popc of the words, scanned over the block's words by one warp,
// gives each kept value its slot.
//
// Magnitudes are computed from the raw storage bits: clearing the sign bit
// of an f32 or bf16 value gives |x| exactly (bf16 is the top half of an
// f32), and f16 widens exactly through __half2float.

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
template <int KIND> struct Codec;

template <> struct Codec<0> {
  using Raw = uint32_t;
  __device__ static uint32_t mag(Raw r) { return r & 0x7fffffffu; }
};

template <> struct Codec<1> {
  using Raw = uint16_t;
  __device__ static uint32_t mag(Raw r) {
    return static_cast<uint32_t>(r & 0x7fffu) << 16;
  }
};

template <> struct Codec<2> {
  using Raw = uint16_t;
  __device__ static uint32_t mag(Raw r) {
    const float f = __half2float(
        __ushort_as_half(static_cast<unsigned short>(r & 0x7fffu)));
    return static_cast<uint32_t>(__float_as_int(f));
  }
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

template <int KIND>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const typename Codec<KIND>::Raw* __restrict__ x,
              typename Codec<KIND>::Raw* __restrict__ values,
              uint32_t* __restrict__ bitmap, long long n, int block, int k) {
  using Raw = typename Codec<KIND>::Raw;
  __shared__ uint32_t s_bits[kMaxBlock];
  __shared__ Raw s_vals[kMaxBlock];
  __shared__ int s_hist[256];
  __shared__ uint32_t s_above[kMaxWords];
  __shared__ uint32_t s_tie[kMaxWords];
  __shared__ int s_off[kMaxWords];
  __shared__ int s_sel[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = block >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * block;

  // 1. Stage the block in shared memory, zero past the end of the tensor.
  for (int i = tid; i < block; i += kThreads) {
    const long long g = base + i;
    const Raw r = g < n ? x[g] : Raw(0);
    s_vals[i] = r;
    s_bits[i] = Codec<KIND>::mag(r);
  }
  __syncthreads();

  // 2. Exact k-th largest bit pattern: radix select from the top byte.
  //    `rank` is the 1-based rank still sought among elements matching
  //    `prefix` on the bits decided so far.
  uint32_t prefix = 0, pmask = 0;
  int rank = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) s_hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < block; i += kThreads) {
      const uint32_t b = s_bits[i];
      if ((b & pmask) == prefix) atomicAdd(&s_hist[(b >> shift) & 255u], 1);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins [8l, 8l+8); higher bins are larger magnitudes
      int cnt[8];
      int own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = s_hist[lane * 8 + j];
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
            s_sel[0] = lane * 8 + j;
            s_sel[1] = rank - above;
            break;
          }
          above += cnt[j];
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(s_sel[0]) << shift;
    pmask |= 255u << shift;
    rank = s_sel[1];
    __syncthreads();
  }
  const uint32_t thr = prefix;  // the k-th largest bit pattern
  const int keep_ties = rank;   // threshold ties kept, first in index order

  // 3. One ballot per 32 consecutive elements: the words of "above" and
  //    "tie" masks, LSB-first.
  for (int w = warp; w < words; w += kWarps) {
    const uint32_t b = s_bits[w * 32 + lane];
    const uint32_t a = __ballot_sync(kFull, b > thr);
    const uint32_t t = __ballot_sync(kFull, b == thr);
    if (lane == 0) {
      s_above[w] = a;
      s_tie[w] = t;
    }
  }
  __syncthreads();

  // 4. One warp walks the words in order: cap the ties, emit each bitmap
  //    word, and scan the kept counts into each word's first value slot.
  if (warp == 0) {
    int tie_carry = 0, keep_carry = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
      const int w = w0 + lane;
      const uint32_t a = w < words ? s_above[w] : 0u;
      const uint32_t t = w < words ? s_tie[w] : 0u;
      const int nt = __popc(t);
      const int tie_incl = warp_scan(nt, lane);
      const int ties_before = tie_carry + tie_incl - nt;
      const int take = min(max(keep_ties - ties_before, 0), nt);
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
        s_above[w] = keep;
        s_off[w] = keep_carry + keep_incl - nk;
        bitmap[static_cast<long long>(blockIdx.x) * words + w] = keep;
      }
      tie_carry += __shfl_sync(kFull, tie_incl, 31);
      keep_carry += __shfl_sync(kFull, keep_incl, 31);
    }
  }
  __syncthreads();

  // 5. Compaction: each kept value goes to its slot, in index order.
  Raw* out = values + static_cast<long long>(blockIdx.x) * k;
  for (int w = warp; w < words; w += kWarps) {
    const uint32_t keep = s_above[w];
    if ((keep >> lane) & 1u) {
      const int slot = s_off[w] + __popc(keep & ((1u << lane) - 1u));
      out[slot] = s_vals[w * 32 + lane];
    }
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

}  // namespace

extern "C" {

// x: n elements; values: (nb, k); bitmap: (nb, block/32) uint32 words.
// Returns cudaGetLastError() after the launch (0 on success).
int topk_encode(const void* x, void* values, void* bitmap, long long n,
                int nb, int block, int k, int kind, void* stream) {
  if (bad_args(n, nb, block, k, kind)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* words = static_cast<uint32_t*>(bitmap);
  switch (kind) {
    case 0:
      encode_kernel<0><<<nb, kThreads, 0, s>>>(
          static_cast<const uint32_t*>(x), static_cast<uint32_t*>(values),
          words, n, block, k);
      break;
    case 1:
      encode_kernel<1><<<nb, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(x), static_cast<uint16_t*>(values),
          words, n, block, k);
      break;
    default:
      encode_kernel<2><<<nb, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(x), static_cast<uint16_t*>(values),
          words, n, block, k);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// values: (nb, k); bitmap: (nb, block/32) uint32 words; out: n elements.
int topk_decode(const void* values, const void* bitmap, void* out,
                long long n, int nb, int block, int k, int kind,
                void* stream) {
  if (bad_args(n, nb, block, k, kind)) return static_cast<int>(cudaErrorInvalidValue);
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
