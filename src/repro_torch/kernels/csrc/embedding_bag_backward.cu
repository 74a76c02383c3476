// embedding_bag_backward: the table gradient of the bag-sum lookup.
//
// Stands for the transpose of the reference's gather
// (src/repro/models/recsys/embedding.py:56, `jnp.take` of the cast table),
// which XLA computes as a scatter-add; the forward is the port of the
// Pallas kernel `embedding_bag` (src/repro/kernels/embedding_bag.py:40).
//
//   grad_table[v, :] = sum over slots s = (r, i) with ids[r, i] == v, in
//                      slot order, of round(grad_out[r, :] * mask[r, i])
//
// with `round` the identity or a round to bf16 (the row dtype the forward
// rounded the gathered rows to), and the running sum rounded to the row
// dtype after every add: XLA's scatter adds bf16 updates into a bf16 zero
// table one at a time.  A null mask is a weight of one.  The sum is stored
// as f32.
//
// The wrapper sorts the slots by id, stably (`torch.sort`), so each run of
// equal ids is contiguous and in slot order; ids outside the table carry
// the key `vocab` and sort last.  It also fills the gradient with zeros
// first, so rows no slot hits are zero.  Here one warp takes one run: the
// warp at a position that starts a run walks the run in order, its lanes
// over the row's columns (four accumulators a lane, 128 columns a pass),
// and writes the row once.  No atomics: two launches give the same bytes.
//
// Bound: bytes.  grad_out is read once (R * D elements), the sorted keys,
// the order and the mask once a slot, and each touched row written once
// (D * 4 B); the fill of the whole [vocab, D] gradient comes before, as a
// memset.  Products and sums use __fmul_rn / __fadd_rn, so nothing is
// contracted into an fma and the plain version is reproduced bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kCols = 4;   // accumulators a lane: 128 columns a pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <bool kRoundBf16>
__device__ __forceinline__ float round_row(float x) {
  return kRoundBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <typename G, bool kRoundBf16, bool kMasked>
__global__ void __launch_bounds__(kWarps * 32) embedding_bag_backward_runs(
    const int* __restrict__ keys, const long long* __restrict__ order,
    const float* __restrict__ mask, const G* __restrict__ grad_out,
    long long slots, int bag, long long vocab, int d,
    float* __restrict__ grad_table) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long p = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       p < slots; p += warps) {
    const int id = keys[p];
    if (id >= vocab) break;                  // keys ascend: only dead ids left
    if (p > 0 && keys[p - 1] == id) continue;  // not the start of a run
    long long end = p + 1;
    while (end < slots && keys[end] == id) ++end;
    float* dst = grad_table + (long long)id * d;
    for (int c0 = 0; c0 < d; c0 += 32 * kCols) {
      float acc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
      for (long long q = p; q < end; ++q) {
        const long long s = order[q];
        const G* src = grad_out + (s / bag) * d;
        const float w = kMasked ? mask[s] : 1.0f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = c0 + j * 32 + lane;
          if (c < d) {
            float x = to_f32(src[c]);
            if (kMasked) x = __fmul_rn(x, w);
            x = round_row<kRoundBf16>(x);
            acc[j] = round_row<kRoundBf16>(__fadd_rn(acc[j], x));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + j * 32 + lane;
        if (c < d) dst[c] = acc[j];
      }
    }
  }
}

template <typename G, bool kRoundBf16>
int launch_typed(const int* keys, const long long* order, const float* mask,
                 const void* grad_out, long long slots, int bag,
                 long long vocab, int d, int blocks, float* out,
                 cudaStream_t s) {
  const G* g = (const G*)grad_out;
  if (mask)
    embedding_bag_backward_runs<G, kRoundBf16, true>
        <<<blocks, kWarps * 32, 0, s>>>(keys, order, mask, g, slots, bag,
                                        vocab, d, out);
  else
    embedding_bag_backward_runs<G, kRoundBf16, false>
        <<<blocks, kWarps * 32, 0, s>>>(keys, order, nullptr, g, slots, bag,
                                        vocab, d, out);
  return (int)cudaGetLastError();
}

}  // namespace

// keys int32 [slots] ascending (ids, `vocab` for an id outside the table),
// order int64 [slots] (the slot of each key, stable), mask f32 [slots] or
// null, grad_out [slots / bag, d] (bf16 if grad_bf16, else f32) ->
// grad_table f32 [vocab, d], which the caller has zeroed; blocks of 256
// threads, a grid stride over the positions.
extern "C" int embedding_bag_backward_launch(
    const void* keys, const void* order, const void* mask,
    const void* grad_out, long long slots, int bag, long long vocab, int d,
    int round_bf16, int grad_bf16, int blocks, void* grad_table,
    void* stream) {
  if (slots <= 0 || d <= 0) return 0;
  if (bag < 1 || vocab < 1 || blocks < 1 || slots % bag != 0)
    return (int)cudaErrorInvalidValue;
  const int* k = (const int*)keys;
  const long long* o = (const long long*)order;
  const float* m = (const float*)mask;
  float* out = (float*)grad_table;
  cudaStream_t s = (cudaStream_t)stream;
  if (grad_bf16 && round_bf16)
    return launch_typed<__nv_bfloat16, true>(k, o, m, grad_out, slots, bag,
                                             vocab, d, blocks, out, s);
  if (grad_bf16)
    return launch_typed<__nv_bfloat16, false>(k, o, m, grad_out, slots, bag,
                                              vocab, d, blocks, out, s);
  if (round_bf16)
    return launch_typed<float, true>(k, o, m, grad_out, slots, bag, vocab, d,
                                     blocks, out, s);
  return launch_typed<float, false>(k, o, m, grad_out, slots, bag, vocab, d,
                                    blocks, out, s);
}
