// AdamW's update for Hopper (sm_90a): one fused pass over many leaves a
// launch.
//
// It replaces no Pallas kernel: the JAX package leaves AdamW's update to
// XLA, which fuses each leaf's elementwise ops into one loop inside the
// jitted train step.  Eager PyTorch runs the same formula as 16
// elementwise kernels a leaf, each reading and writing whole leaves
// (148 bytes a parameter, and one launch per op per leaf).  This kernel
// is the port's counterpart of XLA's fusion, across leaves as well.
//
// What bounds it on an H100: memory bytes.  Per parameter the update
// needs to read p, g, m and v and to write p', m' and v': 28 bytes, and
// does about 15 float operations on them, far below the card's ratio of
// operations to bytes.  So the design moves those 28 bytes and no more,
// in as few launches as possible:
//
// - Each element is read once and written once: p, g, m, v are loaded,
//   the whole update runs in registers, and p', m', v' are stored.  No
//   intermediate reaches device memory.
// - Many leaves go in one launch.  The leaves' pointers, sizes and first
//   chunks travel by value in the kernel's parameters (Batch, up to
//   32,764 bytes since CUDA 12.1), so no table is copied to the device and
//   nothing synchronises.  p' is written into g, m' over m and v' over v:
//   a leaf takes 4 pointers and a launch up to kCap leaves.  An update
//   that must leave its inputs as they were hands the kernel copies of g,
//   m and v.
// - A leaf is cut into chunks of kChunk elements; one block of kThreads
//   threads takes one chunk, and finds its leaf by a binary search over
//   the leaves' first chunks (the same for every thread of the block).
//   Offsets are 64-bit: a leaf may hold more than 2^31 bytes (a 131k x
//   5120 fp32 embedding is 2.68 GB).
// - Where all of a leaf's pointers are 16-byte aligned, a thread moves 4
//   elements with one 16-byte load or store a tensor, neighbouring threads
//   on neighbouring addresses; the ragged end of a leaf whose size is not
//   a multiple of 4, and a whole leaf that is not aligned, go one element
//   at a time.
//
// The numbers are those of the eager ops in repro_torch.kernels.adamw's
// plain version, bit for bit: the same fp32 operations in the same order,
// each rounded on its own (the __f*_rn intrinsics, which the compiler
// never contracts into an FMA), IEEE square root and division.  PyTorch's
// CUDA division by a CPU scalar multiplies by the scalar's float
// reciprocal, so the bias corrections arrive as reciprocals (inv_bc1,
// inv_bc2), computed on the host in float32.
//
// C interface (repro_torch/kernels/adamw.py calls it): adamw_step takes a
// launch's leaves as flat arrays, fills Batch, launches it and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;     // elements a block; a multiple of 4
constexpr int kCap = 672;               // leaves a launch
constexpr size_t kParamLimit = 32764;   // bytes of kernel parameters

// The step's scalars in float32, as PyTorch's ops round them.
struct Hyper {
  float lr, b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, wd;
};

// One launch's leaves.  t[0..3]: p, g, m, v; p' goes to g, m' to m, v' to
// v.
struct Batch {
  float* t[4][kCap];
  long long n[kCap];            // elements of each leaf
  long long chunk0[kCap + 1];   // first chunk of each leaf; [count]: total
  long long count;              // leaves
  Hyper h;
};

static_assert(sizeof(Batch) <= kParamLimit, "batch too large");

// The plain version's ops, in its order: m' = m b1 + g (1 - b1);
// v' = v b2 + (g g)(1 - b2); u = (m' / bc1) / (sqrt(v' / bc2) + eps);
// p' = p - (u + p wd) lr.
__device__ __forceinline__ void adamw_one(float p, float g, float& m,
                                          float& v, float& out,
                                          const Hyper& h) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps);
  float u = __fdiv_rn(__fmul_rn(m, h.inv_bc1), denom);
  u = __fmul_rn(__fadd_rn(u, __fmul_rn(p, h.wd)), h.lr);
  out = __fsub_rn(p, u);
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ Batch b) {
  const long long c = blockIdx.x;
  int lo = 0, hi = static_cast<int>(b.count) - 1;
  while (lo < hi) {             // the last leaf whose first chunk is <= c
    const int mid = (lo + hi + 1) >> 1;
    if (b.chunk0[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const long long start = (c - b.chunk0[lo]) * kChunk;
  const long long left = b.n[lo] - start;
  const int len = static_cast<int>(left < kChunk ? left : kChunk);
  const float* p = b.t[0][lo] + start;
  float* g = b.t[1][lo] + start;
  float* m = b.t[2][lo] + start;
  float* v = b.t[3][lo] + start;
  const Hyper h = b.h;

  int head = 0;                 // elements done as 16-byte vectors
  const uintptr_t any = reinterpret_cast<uintptr_t>(p) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(m) |
      reinterpret_cast<uintptr_t>(v);
  if ((any & 15) == 0) {
    const int nv = len >> 2;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      const float4 P = reinterpret_cast<const float4*>(p)[i];
      const float4 G = reinterpret_cast<const float4*>(g)[i];
      float4 M = reinterpret_cast<const float4*>(m)[i];
      float4 V = reinterpret_cast<const float4*>(v)[i];
      float4 O;
      adamw_one(P.x, G.x, M.x, V.x, O.x, h);
      adamw_one(P.y, G.y, M.y, V.y, O.y, h);
      adamw_one(P.z, G.z, M.z, V.z, O.z, h);
      adamw_one(P.w, G.w, M.w, V.w, O.w, h);
      reinterpret_cast<float4*>(g)[i] = O;
      reinterpret_cast<float4*>(m)[i] = M;
      reinterpret_cast<float4*>(v)[i] = V;
    }
    head = nv << 2;
  }
  for (int i = head + threadIdx.x; i < len; i += kThreads) {
    const float P = p[i], G = g[i];
    float M = m[i], V = v[i], O;
    adamw_one(P, G, M, V, O, h);
    g[i] = O;
    m[i] = M;
    v[i] = V;
  }
}

}  // namespace

extern "C" {

// One launch over `count` leaves (1..kCap): leaf i's p, g, m, v at
// ptrs[4 i .. 4 i + 3], its n[i] > 0 elements in blocks chunk0[i] ..
// chunk0[i + 1] - 1 (chunk0[0] == 0, a block a kChunk elements); p' into
// g, m' over m, v' over v.  scalars: lr, b1, 1 - b1, b2, 1 - b2, 1 / bc1,
// 1 / bc2, eps, weight decay.  On `device` and `stream`.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// leaves and chunks that do not agree.
int adamw_step(const long long* ptrs, const long long* n,
               const long long* chunk0, int count, const float* scalars,
               int device, void* stream) {
  if (count < 1 || count > kCap || chunk0[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Batch b;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0 || chunk0[i + 1] - chunk0[i] != (n[i] + kChunk - 1) / kChunk)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < 4; ++k)
      b.t[k][i] = reinterpret_cast<float*>(ptrs[4 * i + k]);
    b.n[i] = n[i];
    b.chunk0[i] = chunk0[i];
  }
  b.chunk0[count] = chunk0[count];
  b.count = count;
  b.h = Hyper{scalars[0], scalars[1], scalars[2], scalars[3], scalars[4],
              scalars[5], scalars[6], scalars[7], scalars[8]};
  const long long blocks = chunk0[count];
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  adamw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(b);
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // extern "C"
