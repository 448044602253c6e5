// The grouped (per-expert) GEMM for Hopper (sm_90a), one rank a call.
//
// Replaces triton_dist_tpu/ops/group_gemm.py::_ag_group_gemm_kernel (:139,
// entry `_ag_group_gemm_fused`): at world = 1 its ring all-gather of
// tile-aligned, expert-sorted token chunks vanishes and a grouped GEMM over
// the `align_tokens_for_tiles` schedule remains, each (m_blk, K) tile of
// rows belonging to one expert. The same kernel computes every grouped
// product that JAX leaves to `lax.ragged_dot` on this path: the
// `grouped_matmul` of TPMoE's gate and up (group_gemm.py:44-64) and the
// three products of `grouped_expert_ffn` (:67-87, the MoE FFN of mode
// "sp"). Under tensor parallelism at world W, TPMoE calls it once per rank
// on the rank's column shard of the experts, a strided view (the strides
// note of group_gemm.cuh), and so do `ag_group_gemm`'s impls "xla" and
// "ring"; the world-W ring all-gather of `_ag_group_gemm_kernel` with its
// products, impl "fused", is ag_group_gemm.cu, on the same tile bodies.
//
// Shapes on the path (Qwen3-30B-A3B, bf16, E = 128, top-8): gate|up P x 2048
// -> 2 x 768 and down P x 768 -> 2048, with P = 32 pairs at decode (batch
// 4) and 4096 at prefill (4 x 128 tokens). Least time on an H100 SXM
// (3.35 TB/s): gate|up 0.054 ms (P = 32, ~29 live experts) and 0.240 ms
// (P = 4096, all 128 experts); down 0.027 and 0.120 ms, all bound by the
// bytes of the live experts' weights.
//
// The design (schedule kernel, B-streaming tensor-core product over
// per-expert row tiles, the epilogues) is described in group_gemm.cuh,
// which moe_rs.cu shares.
//
// Plain C entry points `tdt_group_gemm_plan` and `tdt_group_gemm`, loaded
// with ctypes. A call runs on the stream it is given, allocates nothing and
// returns cudaGetLastError().

#include "group_gemm.cuh"

namespace {

constexpr int kEpiPlain = 0;
constexpr int kEpiSwiglu = 1;

template <typename T>
cudaError_t run(const GgPlan& p, const void* a, int a_div, const void* b0,
                const void* b1, void* c0, void* c1, int n_b, int epi,
                const int* sched, int P, int K, int N, long long lda,
                long long ldb, long long b_estride, cudaStream_t s) {
  GgArgs<T, T> g = {};
  g.a = static_cast<const T*>(a);
  g.a_div = a_div;
  g.b0 = static_cast<const T*>(b0);
  g.b1 = static_cast<const T*>(b1);
  g.c0 = static_cast<T*>(c0);
  g.c1 = static_cast<T*>(c1);
  g.sched = sched;
  g.P = P;
  g.K = K;
  g.N = N;
  g.lda = lda;
  g.ldb = ldb;
  g.b_estride = b_estride;
  if (epi == kEpiSwiglu) return run_group_product<T, T, true>(p, g, 2, s);
  return run_group_product<T, T, false>(p, g, n_b, s);
}

}  // namespace

extern "C" {

// The plan of a grouped product of P pairs over E experts, (K -> N) each,
// dtype 0 = bfloat16, 1 = float32, with the strides (elements) of A's rows
// (lda), the weights' rows (ldb) and experts (b_estride): *path (0: FMA
// kernel, 1: tensor-core kernel), *m_blk (rows per tile) and *max_tiles
// (tiles of the grid). A call needs a schedule buffer of 1 + P + 3 *
// max_tiles int32. Returns a cudaError_t.
int tdt_group_gemm_plan(int P, int E, int K, int N, int dtype, long long lda,
                        long long ldb, long long b_estride, int* path,
                        int* m_blk, int* max_tiles) {
  if (!gg_args_ok(P, E, K, N, dtype) ||
      !gg_strides_ok(K, N, lda, ldb, b_estride))
    return static_cast<int>(cudaErrorInvalidValue);
  const GgPlan p = gg_make_plan(P, E, K, N, dtype, lda, ldb, b_estride);
  *path = p.path;
  *m_blk = p.m_blk;
  *max_tiles = p.max_tiles;
  return static_cast<int>(cudaSuccess);
}

// out_i[p] = a[p / a_div] @ b_i[ids[p]] for p < P (ids: int32, E = the
// sentinel, run through expert E - 1). epi 0: n_b = 1 or 2 products, each
// rounded into c_i (P, N); epi 1: silu(a @ b0) * (a @ b1) in f32, rounded
// once into c0 (n_b must be 2). a is (P / a_div, K) with row stride lda,
// b_i (E, K, N) with row stride ldb and expert stride b_estride (elements;
// b0 and b1 share them), c_i contiguous; a and b_i 16-byte aligned.
// sched: the int32 buffer of the plan. Returns a cudaError_t.
int tdt_group_gemm(const void* a, int a_div, const int* ids, int P, int E,
                   const void* b0, const void* b1, void* c0, void* c1,
                   int n_b, int epi, int K, int N, long long lda,
                   long long ldb, long long b_estride, int* sched, int dtype,
                   void* stream) {
  if (!gg_args_ok(P, E, K, N, dtype) ||
      !gg_strides_ok(K, N, lda, ldb, b_estride) || a_div <= 0 ||
      P % a_div != 0 ||
      ids == nullptr || sched == nullptr || !aligned16(a) || !aligned16(b0) ||
      c0 == nullptr || (epi != kEpiPlain && epi != kEpiSwiglu) ||
      n_b < 1 || n_b > 2 || (epi == kEpiSwiglu && n_b != 2) ||
      (n_b == 2 && (!aligned16(b1) || (epi == kEpiPlain && c1 == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const GgPlan p = gg_make_plan(P, E, K, N, dtype, lda, ldb, b_estride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_schedule(ids, P, E, p.m_blk, p.max_tiles, sched, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dtype == 0
            ? run<__nv_bfloat16>(p, a, a_div, b0, b1, c0, c1, n_b, epi, sched,
                                 P, K, N, lda, ldb, b_estride, s)
            : run<float>(p, a, a_div, b0, b1, c0, c1, n_b, epi, sched, P, K,
                         N, lda, ldb, b_estride, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
