// MoE down projection + top-k reduce for Hopper (sm_90a), one rank a call:
// out[m] = sum_j weights[m, j] * (act[m k + j] @ W[ids[m k + j]]).
//
// Replaces triton_dist_tpu/ops/moe_reduce_rs.py::_moe_rs_fused_kernel (:72;
// its world = 1 branch :203-205 runs `chunk_gemm` into the output) and
// computes what `moe_reduce_rs(impl="ring"|"xla")` computes at world = 1,
// the one-shot body (:388): `grouped_matmul` of the down projection, then
// `topk_reduce` (moe_utils.py:235-243). At world W the "ring" and "xla"
// bodies (:331-354, :326-329) call this kernel once per rank on its row
// shard of w_down (a strided view) and sum the ranks' partials in plain
// torch (ops/moe_reduce_rs.py); the world-W ring of the fused kernel is
// moe_rs_ring.cu. The two differ in where they round:
//  * round_pairs = 1 ("ring", "xla"): each pair's product rounds to the
//    activation dtype, then the f32 weighted sum rounds once;
//  * round_pairs = 0 ("fused"): f32 through the weighted sum, one rounding
//    (the Pallas kernel's accumulator, :169-196).
// JAX folds the top-k scatter-reduce into a selection matmul, which its
// own docstring (:20-43) calls a TPU workaround; it is not copied.
//
// Shape on the path (Qwen3-30B-A3B, bf16): act (P, 768), W (128, 768,
// 2048), weights (M, 8) f32 -> (M, 2048), P = 8 M; M = 4 at decode, 512 at
// prefill. Least time on an H100 SXM (3.35 TB/s): ~0.027 ms at M = 4 (~29
// live experts' weights) and ~0.12 ms at M = 512 (all 128 experts), bound
// by the bytes of the weights.
//
// Three launches on the caller's stream, no atomics:
//  1. group_gemm.cuh's expert schedule of the pairs;
//  2. its grouped product (plain epilogue) into a (M, k, H) workspace, each
//     pair at its original slot (the store address does the unsort), in
//     the activation dtype (round_pairs) or f32;
//  3. `topk_reduce_rows`: each output element sums slots 0..k-1 in that
//     order, each product weight * value rounded to f32 before the add (as
//     JAX's `topk_reduce` multiplies, then sums), and rounds once.
// Equal inputs give equal bits from run to run.
//
// Plain C entry point `tdt_moe_rs`, loaded with ctypes. A call allocates
// nothing and returns cudaGetLastError().

#include "group_gemm.cuh"

namespace {

constexpr int kRedThreads = 256;

template <typename T, typename WsT>
__global__ void __launch_bounds__(kRedThreads)
topk_reduce_rows(const WsT* __restrict__ ws, const float* __restrict__ w,
                 T* __restrict__ out, int M, int k, int H) {
  const int h = blockIdx.x * kRedThreads + threadIdx.x;
  if (h >= H) return;
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    float s = 0.f;
    for (int j = 0; j < k; ++j) {
      const size_t pair = static_cast<size_t>(m) * k + j;
      s = __fadd_rn(s, __fmul_rn(to_f32(ws[pair * H + h]), w[pair]));
    }
    out[static_cast<size_t>(m) * H + h] = from_f32<T>(s);
  }
}

template <typename T, typename WsT>
cudaError_t run(const GgPlan& p, const void* act, const void* w_down,
                const float* weights, void* ws, void* out, const int* sched,
                int M, int k, int I, int H, long long lda, long long w_estride,
                cudaStream_t s) {
  GgArgs<T, WsT> g = {};
  g.a = static_cast<const T*>(act);
  g.a_div = 1;
  g.b0 = static_cast<const T*>(w_down);
  g.c0 = static_cast<WsT*>(ws);
  g.sched = sched;
  g.P = M * k;
  g.K = I;
  g.N = H;
  g.lda = lda;
  g.ldb = H;
  g.b_estride = w_estride;
  const cudaError_t err = run_group_product<T, WsT, false>(p, g, 1, s);
  if (err != cudaSuccess) return err;
  dim3 grid((H + kRedThreads - 1) / kRedThreads, M < 65535 ? M : 65535);
  topk_reduce_rows<T, WsT><<<grid, kRedThreads, 0, s>>>(
      static_cast<const WsT*>(ws), weights, static_cast<T*>(out), M, k, H);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out (M, H) = sum_j weights[m, j] * (act[m k + j] @ w_down[ids[m k + j]]).
// act (M k, I) with row stride lda and w_down (E, I, H) with contiguous
// rows and expert stride w_estride (elements: a rank's row shard of the
// global (E, I W, H) is a strided view), 16-byte aligned; ids (M k)
// int32 (E = sentinel, run through expert E - 1); weights (M, k) f32. The
// grouped down product is planned as tdt_group_gemm_plan plans P = M k
// pairs (I -> H): sched holds 1 + M k + 3 * max_tiles int32 and ws M k H
// elements (activation dtype with round_pairs, else f32). Returns a
// cudaError_t.
int tdt_moe_rs(const void* act, const int* ids, const float* weights,
               const void* w_down, void* ws, void* out, int* sched, int M,
               int k, int E, int I, int H, long long lda, long long w_estride,
               int round_pairs, int dtype, void* stream) {
  if (M <= 0 || k <= 0 || !gg_args_ok(M * k, E, I, H, dtype) ||
      !gg_strides_ok(I, H, lda, H, w_estride) ||
      ids == nullptr || weights == nullptr || ws == nullptr ||
      out == nullptr || sched == nullptr || !aligned16(act) ||
      !aligned16(w_down))
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = M * k;
  const GgPlan p = gg_make_plan(P, E, I, H, dtype, lda, H, w_estride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_schedule(ids, P, E, p.m_blk, p.max_tiles, sched, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) {
    using T = __nv_bfloat16;
    err = round_pairs
              ? run<T, T>(p, act, w_down, weights, ws, out, sched, M, k, I, H,
                          lda, w_estride, s)
              : run<T, float>(p, act, w_down, weights, ws, out, sched, M, k, I,
                              H, lda, w_estride, s);
  } else {
    err = run<float, float>(p, act, w_down, weights, ws, out, sched, M, k, I,
                            H, lda, w_estride, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
