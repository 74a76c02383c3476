// embedding_bag: the bag-sum lookup of the recsys embedding tables.
//
// Replaces the Pallas TPU kernel `embedding_bag`
// (src/repro/kernels/embedding_bag.py:40, body `_embedding_bag_kernel` :27):
//
//   out[r, :] = sum_i mask[r, i] * round(table[ids[r, i], :])
//
// with `round` the identity or a round to bf16 (the compute dtype the
// reference casts its table to before the take), the products and the sum
// in f32 in bag order, and the result stored as f32 or bf16.  An id in
// [-V, 0) counts from the end of the table and any other id outside [0, V)
// gives a NaN row, as `jnp.take` does; the table is never read there.  The
// mask is a weight: every slot's row is read and multiplied by it.
//
// Bound: bytes.  Each distinct row is read once (D * 4 B), ids and mask
// once (8 B a slot) and the output written once; the multiply-adds are far
// below the card's f32 rate.  The TPU kernel pins a model shard's table in
// VMEM; here the table (26 million rows at full width, 6.66 GB) stays in
// device memory and is only gathered.  Design: one warp per output row,
// each lane loading a float2 of the row (one 256 B row per warp at D = 64,
// coalesced), a loop over the bag.  Every offset is 64-bit: id * D reaches
// 1.66e9 elements and its byte offset passes 2**31.  Sums use __fmul_rn /
// __fadd_rn in bag order, so nothing is contracted into an fma and the
// plain version (the same loop in PyTorch) is reproduced bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // output rows per block, one warp each

__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void load(const float* p, float (&v)[2]) {
  const float2 x = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = x.x;
  v[1] = x.y;
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  p[0] = v[0];
}
__device__ __forceinline__ void store(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
  p[0] = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
}

template <int V, bool kRoundBf16, typename Out>
__global__ void __launch_bounds__(kWarps * 32)
embedding_bag_kernel(const int* __restrict__ ids,
                     const float* __restrict__ mask,
                     const float* __restrict__ table, long long rows, int bag,
                     long long vocab, int d, Out* __restrict__ out) {
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int* id_r = ids + r * bag;
  const float* m_r = mask + r * bag;
  const float nan = __int_as_float(0x7fc00000);
  for (int c = lane * V; c < d; c += 32 * V) {
    float acc[V] = {};
    for (int i = 0; i < bag; ++i) {
      long long id = __ldg(id_r + i);
      const float m = __ldg(m_r + i);
      if (id < 0) id += vocab;
      float v[V];
      if (id >= 0 && id < vocab) {
        load(table + id * d + c, v);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = nan;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float x =
            kRoundBf16 ? __bfloat162float(__float2bfloat16_rn(v[k])) : v[k];
        const float p = __fmul_rn(m, x);
        acc[k] = i == 0 ? p : __fadd_rn(acc[k], p);
      }
    }
    store(out + r * d + c, acc);
  }
}

template <int V, bool kRoundBf16, typename Out>
int launch(const void* ids, const void* mask, const void* table,
           long long rows, int bag, long long vocab, int d, void* out,
           cudaStream_t s) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  embedding_bag_kernel<V, kRoundBf16, Out>
      <<<(unsigned int)blocks, kWarps * 32, 0, s>>>(
      (const int*)ids, (const float*)mask, (const float*)table, rows, bag,
      vocab, d, (Out*)out);
  return (int)cudaGetLastError();
}

template <int V>
int dispatch(const void* ids, const void* mask, const void* table,
             long long rows, int bag, long long vocab, int d, int round_bf16,
             int out_bf16, void* out, cudaStream_t s) {
  if (round_bf16 && out_bf16)
    return launch<V, true, __nv_bfloat16>(ids, mask, table, rows, bag, vocab,
                                          d, out, s);
  if (round_bf16)
    return launch<V, true, float>(ids, mask, table, rows, bag, vocab, d, out,
                                  s);
  if (out_bf16)
    return launch<V, false, __nv_bfloat16>(ids, mask, table, rows, bag,
                                           vocab, d, out, s);
  return launch<V, false, float>(ids, mask, table, rows, bag, vocab, d, out,
                                 s);
}

}  // namespace

// ids int32 [rows, bag], mask f32 [rows, bag], table f32 [vocab, d] -> out
// [rows, d] (bf16 if out_bf16, else f32).  vec2 = 1 loads and stores float2
// (needs an even d and 8-byte aligned table and out).  bag >= 1.
extern "C" int embedding_bag_launch(const void* ids, const void* mask,
                                    const void* table, long long rows,
                                    int bag, long long vocab, int d,
                                    int round_bf16, int out_bf16, int vec2,
                                    void* out, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return vec2 ? dispatch<2>(ids, mask, table, rows, bag, vocab, d,
                            round_bf16, out_bf16, out, s)
              : dispatch<1>(ids, mask, table, rows, bag, vocab, d,
                            round_bf16, out_bf16, out, s);
}
