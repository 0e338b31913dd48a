// Adam: one pass over the Gaussian parameters' six leaves (AD).
//
// Replaces no Pallas kernel: rain_tpu left Adam to XLA, which fused it
// (rain_tpu/model/adam.py:update). Its plain version is
// model/adam.py:update_plain, which PyTorch runs as some 14 element-wise
// kernels a leaf, each a pass over the whole leaf: about 31 GB of traffic
// a step at 4,194,304 Gaussians, where the update needs 6.9 GB.
//
// Contract. For each leaf: p, g, m and v are contiguous f32 arrays of n
// elements, read once; p_out, m_out and v_out are n-element arrays that
// no input overlaps, written once, every element. lr points to the leaf's
// f32 learning rate, b1c and b2c to the f32 bias corrections 1 - b1^t and
// 1 - b2^t: all three are read from device memory, so a replayed CUDA
// graph uses each step's values. Per element, in update_plain's order and
// each operation rounded on its own as ATen rounds it:
//   m' = (b1 m) + ((1 - b1) g)
//   v' = (b2 v) + ((1 - b2) (g g))
//   p' = p - (lr (m' / b1c)) / (sqrt(v' / b2c) + eps)
// with b1, 1 - b1, b2, 1 - b2 and eps the f32 values ATen casts the
// Python doubles to, passed by the wrapper. Every operation is a
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn, __fsub_rn), which nvcc never contracts or approximates, so
// p', m' and v' equal update_plain's bit for bit whatever the flags. Rows
// with zero g, m and v stay exactly unchanged (p - 0 / eps).
//
// Bound on the H100: bytes. 28 a parameter (4 floats read, 3 written):
// 6.93 GB for the 247.5 M parameters at 4,194,304 Gaussians, 2.07 ms at
// 3.35 TB/s; its 14 operations a parameter are far below the ridge.
// Design: one launch for all six leaves. The leaf table rides in the
// kernel's parameters; blocks are dealt to the leaves by a prefix of
// per-leaf block counts, each block a chunk of kChunk elements of one
// leaf. A thread loads kVec float4s of each of the four inputs before it
// computes (8 x 16 bytes in flight a thread), with streaming hints
// (ld.global.cs, st.global.cs): nothing in the step reads these bytes
// again while they could sit in L2. A leaf whose seven arrays are 16-byte
// aligned takes the vector path on its whole chunks; its last partial
// chunk, and an unaligned leaf, take the scalar path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLeaves = 6;                       // GaussianParams' leaves
constexpr int kThreads = 256;
constexpr int kVec = 2;                          // float4s an array a thread
constexpr int kChunk = kThreads * kVec * 4;      // elements a block: 2048

// one leaf as the wrapper passes it (model/adam.py:_LeafArgs)
struct LeafArgs {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  const float* lr;
  long long n;
};

struct Leaf {
  LeafArgs a;
  long long first_block;   // the leaf's first block in the grid
};

struct Table {
  Leaf leaf[kLeaves];
  const float* b1c;
  const float* b2c;
  float b1, one_minus_b1, b2, one_minus_b2, eps;
};

struct Scalars {
  float b1, omb1, b2, omb2, eps, lr, b1c, b2c;
};

__device__ __forceinline__ void adam(const Scalars& s, float p, float g,
                                     float m, float v, float& p_out,
                                     float& m_out, float& v_out) {
  m_out = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v_out = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float m_hat = __fdiv_rn(m_out, s.b1c);
  const float v_hat = __fdiv_rn(v_out, s.b2c);
  p_out = __fsub_rn(p, __fdiv_rn(__fmul_rn(s.lr, m_hat),
                                 __fadd_rn(__fsqrt_rn(v_hat), s.eps)));
}

__device__ __forceinline__ void adam4(const Scalars& s, const float4& p,
                                      const float4& g, const float4& m,
                                      const float4& v, float4& po,
                                      float4& mo, float4& vo) {
  adam(s, p.x, g.x, m.x, v.x, po.x, mo.x, vo.x);
  adam(s, p.y, g.y, m.y, v.y, po.y, mo.y, vo.y);
  adam(s, p.z, g.z, m.z, v.z, po.z, mo.z, vo.z);
  adam(s, p.w, g.w, m.w, v.w, po.w, mo.w, vo.w);
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const Table t) {
  // the leaf of this block: the last whose first block is not past it
  // (an empty leaf shares its first block with the next and loses to it)
  const long long b = blockIdx.x;
  LeafArgs L = t.leaf[0].a;
  long long first = 0;
#pragma unroll
  for (int i = 1; i < kLeaves; ++i) {
    if (b >= t.leaf[i].first_block) {
      L = t.leaf[i].a;
      first = t.leaf[i].first_block;
    }
  }
  Scalars s;
  s.b1 = t.b1;
  s.omb1 = t.one_minus_b1;
  s.b2 = t.b2;
  s.omb2 = t.one_minus_b2;
  s.eps = t.eps;
  s.lr = *L.lr;
  s.b1c = *t.b1c;
  s.b2c = *t.b2c;
  const long long base = (b - first) * kChunk;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(L.p) | reinterpret_cast<uintptr_t>(L.g) |
        reinterpret_cast<uintptr_t>(L.m) | reinterpret_cast<uintptr_t>(L.v) |
        reinterpret_cast<uintptr_t>(L.p_out) |
        reinterpret_cast<uintptr_t>(L.m_out) |
        reinterpret_cast<uintptr_t>(L.v_out)) & 15) == 0;
  if (aligned && base + kChunk <= L.n) {
    const float4* p4 = reinterpret_cast<const float4*>(L.p + base);
    const float4* g4 = reinterpret_cast<const float4*>(L.g + base);
    const float4* m4 = reinterpret_cast<const float4*>(L.m + base);
    const float4* v4 = reinterpret_cast<const float4*>(L.v + base);
    float4* po4 = reinterpret_cast<float4*>(L.p_out + base);
    float4* mo4 = reinterpret_cast<float4*>(L.m_out + base);
    float4* vo4 = reinterpret_cast<float4*>(L.v_out + base);
    float4 P[kVec], G[kVec], M[kVec], V[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = j * kThreads + threadIdx.x;
      P[j] = __ldcs(p4 + i);
      G[j] = __ldcs(g4 + i);
      M[j] = __ldcs(m4 + i);
      V[j] = __ldcs(v4 + i);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = j * kThreads + threadIdx.x;
      float4 po, mo, vo;
      adam4(s, P[j], G[j], M[j], V[j], po, mo, vo);
      __stcs(po4 + i, po);
      __stcs(mo4 + i, mo);
      __stcs(vo4 + i, vo);
    }
    return;
  }
  const long long end = base + kChunk < L.n ? base + kChunk : L.n;
  for (long long e = base + threadIdx.x; e < end; e += kThreads) {
    float po, mo, vo;
    adam(s, __ldcs(L.p + e), __ldcs(L.g + e), __ldcs(L.m + e),
         __ldcs(L.v + e), po, mo, vo);
    __stcs(L.p_out + e, po);
    __stcs(L.m_out + e, mo);
    __stcs(L.v_out + e, vo);
  }
}

}  // namespace

// One Adam step over the six leaves: `args` points to six LeafArgs in
// host memory; b1c and b2c to the f32 bias corrections on the device;
// b1, one_minus_b1, b2, one_minus_b2 and eps the f32 constants. One
// launch on `stream`, none when every leaf is empty.
extern "C" int rain_adam_update(int device, void* stream, const void* args,
                                const void* b1c, const void* b2c, float b1,
                                float one_minus_b1, float b2,
                                float one_minus_b2, float eps) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Table t = {};
  long long blocks = 0;
  for (int i = 0; i < kLeaves; ++i) {
    t.leaf[i].a = static_cast<const LeafArgs*>(args)[i];
    t.leaf[i].first_block = blocks;
    blocks += (t.leaf[i].a.n + kChunk - 1) / kChunk;
  }
  t.b1c = static_cast<const float*>(b1c);
  t.b2c = static_cast<const float*>(b2c);
  t.b1 = b1;
  t.one_minus_b1 = one_minus_b1;
  t.b2 = b2;
  t.one_minus_b2 = one_minus_b2;
  t.eps = eps;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  adam_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel, into blocks[0].
extern "C" int rain_adam_occupancy(int device, void* stream, void* blocks) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      (int*)blocks, adam_kernel, kThreads, 0);
}
