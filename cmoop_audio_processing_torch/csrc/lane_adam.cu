// Per-lane masked Adam for Hopper (sm_90a): the population trainer's whole
// optimizer update, every parameter leaf of every lane, in one pass.
//
// Replaces no TPU kernel: the JAX package's Adam is optax's, plain XLA
// (cmoop_audio_processing_tpu/engine/trainer.py, optax.adam under
// jax.vmap). It replaces the port's plain update (engine/lane_adam.py,
// lane_adam_reference): 17 PyTorch ops a leaf, each a kernel of its own
// that reads and writes whole leaves, about 42 leaf-sized passes a step.
//
// Bound: device memory. Each element reads p, g, m and v and writes p, m
// and v, 28 bytes against 14 FLOPs. The design moves those bytes once and
// keeps enough of them in flight: one launch for a tree of up to
// MAX_LEAVES leaves (the templates' trees have at most 51),
// the leaf table passed by value in the kernel parameters (no table copy
// to the device); each block takes BLOCK_ELEMS consecutive elements of one
// leaf, finds its leaf by a binary search over the table's first blocks,
// and issues all of its loads before it computes, 16 bytes a thread and
// access where the leaf's per-lane size and pointers allow (the scalar
// path otherwise, for the output biases of 10 or 11 classes a lane). At
// most 64 registers a thread (ptxas spills a few words to L1 for it), so
// an SM holds 1024 threads and 128 KB of loads in flight. A lane's flag and bias corrections are read per 4
// elements (L1-cached, (P,) each), its index found with one 64-bit
// division a thread.
//
// Arithmetic: the plain path's, operation for operation, in f32 with the
// round-to-nearest intrinsics so that nothing contracts into an FMA:
//   m2 = b1*m + c1*g;  v2 = b2*v + (c2*g)*g;
//   p' = p - lr * ((m2/bc1) / (sqrt(v2/bc2) + eps))
// with c1 = f32(1 - b1), c2 = f32(1 - b2). An inactive lane's p, m and v
// are copied through by a select, so a NaN in its gradient changes nothing.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 2;         // float4 groups of each array a thread moves
constexpr int MIN_BLOCKS = 4;  // blocks an SM holds: at most 64 registers
constexpr long long BLOCK_ELEMS = (long long)THREADS * VEC * 4;
constexpr int MAX_LEAVES = 64;  // the table stays under 4 KB of parameters

// One leaf: its four inputs, where it lies in each output buffer, its
// elements a lane, its first block in this launch (lane_adam_launch fills
// it) and whether it takes 16-byte accesses. Mirrors engine/lane_adam.py LEAF_DTYPE (56 bytes).
struct Leaf {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  long long out;
  long long per_lane;
  int first_block;
  int vec;
};
static_assert(sizeof(Leaf) == 56, "Leaf must match LEAF_DTYPE");

struct Args {
  float* p_out;
  float* m_out;
  float* v_out;
  const unsigned char* active;
  const float* bc1;
  const float* bc2;
  long long lanes;
  float b1, c1, b2, c2, lr, eps;
  int n_leaves;
  int pad_;
  Leaf leaf[MAX_LEAVES];
};
static_assert(sizeof(Args) <= 4096, "the table must fit 4 KB of parameters");

__device__ __forceinline__ void adam(const Args& a, bool on, float bc1,
                                     float bc2, float& p, float g, float& m,
                                     float& v) {
  const float m2 = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.c1, g));
  const float v2 =
      __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.c2, g), g));
  const float step = __fdiv_rn(
      __fdiv_rn(m2, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, bc2)), a.eps));
  const float p2 = __fsub_rn(p, __fmul_rn(a.lr, step));
  p = on ? p2 : p;
  m = on ? m2 : m;
  v = on ? v2 : v;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
lane_adam_kernel(const Args a) {
  const int b = blockIdx.x;
  int lo = 0, hi = a.n_leaves - 1;
  while (lo < hi) {  // the last leaf whose first block is <= b
    const int mid = (lo + hi + 1) >> 1;
    if (a.leaf[mid].first_block <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf& L = a.leaf[lo];
  const long long per_lane = L.per_lane;
  const long long n = a.lanes * per_lane;
  const long long base = (long long)(b - L.first_block) * BLOCK_ELEMS;
  float* __restrict__ pout = a.p_out + L.out;
  float* __restrict__ mout = a.m_out + L.out;
  float* __restrict__ vout = a.v_out + L.out;
  // The block's elements [base, base + BLOCK_ELEMS) start in lane0, at an
  // offset below per_lane from its start: one 64-bit division a thread. A
  // per-lane size of at least BLOCK_ELEMS leaves at most one lane boundary
  // in the block; a smaller one leaves offsets below 2 * BLOCK_ELEMS, which
  // divide in 32 bits.
  auto lane_of = [per_lane](long long lane0, long long i) -> long long {
    const long long off = i - lane0 * per_lane;
    return per_lane >= BLOCK_ELEMS
               ? lane0 + (off >= per_lane)
               : lane0 + (unsigned)off / (unsigned)per_lane;
  };

  if (L.vec) {  // per_lane % 4 == 0: a float4 never straddles two lanes
    float4 P[VEC], G[VEC], M[VEC], V[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const long long i = base + ((long long)k * THREADS + threadIdx.x) * 4;
      if (i < n) {
        P[k] = *reinterpret_cast<const float4*>(L.p + i);
        G[k] = *reinterpret_cast<const float4*>(L.g + i);
        M[k] = *reinterpret_cast<const float4*>(L.m + i);
        V[k] = *reinterpret_cast<const float4*>(L.v + i);
      }
    }
    const long long lane0 = base / per_lane;
    bool on[VEC];
    float c1[VEC], c2[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const long long i = base + ((long long)k * THREADS + threadIdx.x) * 4;
      const long long lane = lane_of(lane0, i < n ? i : base);
      on[k] = a.active[lane] != 0;
      c1[k] = a.bc1[lane];
      c2[k] = a.bc2[lane];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const long long i = base + ((long long)k * THREADS + threadIdx.x) * 4;
      if (i < n) {
        adam(a, on[k], c1[k], c2[k], P[k].x, G[k].x, M[k].x, V[k].x);
        adam(a, on[k], c1[k], c2[k], P[k].y, G[k].y, M[k].y, V[k].y);
        adam(a, on[k], c1[k], c2[k], P[k].z, G[k].z, M[k].z, V[k].z);
        adam(a, on[k], c1[k], c2[k], P[k].w, G[k].w, M[k].w, V[k].w);
        *reinterpret_cast<float4*>(pout + i) = P[k];
        *reinterpret_cast<float4*>(mout + i) = M[k];
        *reinterpret_cast<float4*>(vout + i) = V[k];
      }
    }
  } else {
    constexpr int PER_THREAD = VEC * 4;
    float P[PER_THREAD], G[PER_THREAD], M[PER_THREAD], V[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const long long i = base + (long long)k * THREADS + threadIdx.x;
      if (i < n) {
        P[k] = L.p[i];
        G[k] = L.g[i];
        M[k] = L.m[i];
        V[k] = L.v[i];
      }
    }
    const long long lane0 = base / per_lane;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const long long i = base + (long long)k * THREADS + threadIdx.x;
      if (i < n) {
        const long long lane = lane_of(lane0, i);
        adam(a, a.active[lane] != 0, a.bc1[lane], a.bc2[lane], P[k], G[k],
             M[k], V[k]);
        pout[i] = P[k];
        mout[i] = M[k];
        vout[i] = V[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// One launch over the `n_leaves` (<= MAX_LEAVES) table rows at `leaves`
// (host memory, the Leaf layout; each row's first_block is filled here).
// The outputs are the three flat buffers the rows' `out` offsets index;
// active (lanes,) bool; bc1, bc2 (lanes,) float32. All on the current
// device. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
int lane_adam_launch(const void* leaves, int n_leaves, void* p_out,
                     void* m_out, void* v_out, const void* active,
                     const void* bc1, const void* bc2, long long lanes,
                     float b1, float c1, float b2, float c2, float lr,
                     float eps, void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || lanes < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.p_out = (float*)p_out;
  a.m_out = (float*)m_out;
  a.v_out = (float*)v_out;
  a.active = (const unsigned char*)active;
  a.bc1 = (const float*)bc1;
  a.bc2 = (const float*)bc2;
  a.lanes = lanes;
  a.b1 = b1;
  a.c1 = c1;
  a.b2 = b2;
  a.c2 = c2;
  a.lr = lr;
  a.eps = eps;
  a.n_leaves = n_leaves;
  a.pad_ = 0;
  const Leaf* rows = (const Leaf*)leaves;
  long long blocks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    a.leaf[i] = rows[i];
    a.leaf[i].first_block = (int)blocks;
    blocks += (lanes * rows[i].per_lane + BLOCK_ELEMS - 1) / BLOCK_ELEMS;
    if (rows[i].per_lane < 1 || blocks > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
  }
  lane_adam_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
