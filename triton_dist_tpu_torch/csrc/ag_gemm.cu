// AG-GEMM, AG-SwiGLU and the GEMM of GEMM-RS at world = 1 for Hopper
// (sm_90a): C_i = A @ B_i with f32 accumulation and one rounding to A's
// dtype, and act = silu(A @ Wg + bg) * (A @ Wu + bu) in f32, rounded once.
//
// Replaces, at world = 1, where their ring all-gather / reduce-scatter
// halves vanish (the `world == 1` branches of allgather_gemm.py:170, 193,
// 246, 331, 443, 1029 and gemm_reduce_scatter.py:635):
//  * triton_dist_tpu/ops/allgather_gemm.py::_ag_gemm_hbm_nb_kernel (:265),
//    the kernel `ag_gemm_multi` (:643) runs for Qwen3-8B's QKV (n_b = 3) and,
//    when `ag_swiglu` does not fuse, its gate|up (n_b = 2);
//  * triton_dist_tpu/ops/allgather_gemm.py::_ag_swiglu_hbm_kernel (:954):
//    the gate and up products and the bias + SwiGLU epilogue in one kernel,
//    so the (M, 2 I) intermediate never reaches device memory;
//  * triton_dist_tpu/ops/gemm_reduce_scatter.py::_gemm_rs_hbm_kernel (:533),
//    the k-tiled kernel `gemm_rs` (:884) runs for the down projection, and
//    the prefill (M > 64) products of ::_gemm_rs_hbm_nb_kernel (:353), the
//    o_proj. (At M <= 64 gemm_rs runs gemm_ar.cu's kernel.)
// The ring halves come with the multi-GPU slice.
//
// Shapes on the path (Qwen3-8B, bf16, batch 4 x 128-token prompts), with the
// least time on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s):
//   prefill M = 512: QKV 4096 -> 4096|1024|1024 26.1 us, o_proj 4096 -> 4096
//   17.4 us, gate/up 4096 -> 2 x 12288 104.2 us, down 12288 -> 4096 52.1 us,
//   all bound by operations;
//   decode M = 4: QKV 15.0 us, gate|up 60.1 us (bytes of B).
//
// What the design does about it. Three kernels, picked by dtype and shape
// only (ag_plan.cuh's make_plan, exported as tdt_ag_gemm_plan):
//  * Prefill plan, bf16 with K and every width a multiple of 8 and M > 64
//    (or any M for SwiGLU): `tile_wg`, tiles.cuh's tensor-core tile
//    (wgmma fed by TMA through a 6-stage mbarrier ring, one producer warp
//    and two consumer warpgroups, 128 x 128 tiles, 128 x 64 of gate and of
//    up for SwiGLU, whose two accumulators share each A slice). A
//    persistent grid of one block an SM walks the output tiles row tile
//    first, so the SMs at work share B's column tiles through L2 and each
//    block's next loads overlap its epilogue. No split-K: at M = 512 QKV
//    has 4 x 48 = 192 tiles (1.45 waves on 132 SMs: the last wave leaves
//    0.55 of the SMs idle; the smoke prints it), o_proj and down 128 (0.97
//    waves), gate/up 768 (5.8). Every 128 K terms (two stages) the tensor
//    core's sum is added to an f32 register sum, so long K sums stay within
//    one bf16 ulp of the f32 reference.
//  * Decode plan, bf16 aligned as above and M <= 64 (AG-GEMM only):
//    gemm_common.cuh's `stream_mma`, the B-streaming kernel of gemm_ar, run
//    over up to three products at once, split-K to about two blocks per SM
//    and a fixed-order split reduce. B is read from HBM once.
//  * f32, and bf16 at other shapes: `tile_fma`, a 64 x 64 tile of f32 FMAs,
//    4 x 4 outputs per thread, K in slices of 16 through shared memory, every
//    edge masked. Only the f32 test configurations and odd shapes use it.
//  * Several products in one launch: a block finds its product from its
//    column tile (`Segs`), so QKV is one launch and writes three outputs.
//  * Every sum has a fixed order and there are no atomics, so equal inputs
//    give equal bits from run to run.
//  * The tile bodies live in tiles.cuh, shared with the ring kernels of
//    ag_gemm_ring.cu and gemm_rs_ring.cu.
//
// Plain C entry points `tdt_ag_gemm_plan`, `tdt_ag_gemm` and `tdt_ag_swiglu`,
// loaded with ctypes. A launch runs on the stream it is given, allocates
// nothing and returns cudaGetLastError().

#include "ag_plan.cuh"
#include "tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// Prefill: the tensor-core tile of tiles.cuh in a persistent grid of one
// block an SM, each walking output tiles i = blockIdx.x, + gridDim.x, ...,
// row tile fastest (the blocks at work share B's column tiles through L2),
// so a block's next tile's loads overlap its epilogue. SWIGLU: one product
// (segs.b[0] = Wg, segs.c[0] = act) and the view of Wu; the optional biases
// have one entry per column.
template <bool SWIGLU>
__global__ void __launch_bounds__(kPfThreads, 1)
tile_wg(Segs<bf16> segs, const bf16* __restrict__ bias_g,
        const bf16* __restrict__ bias_u, int M, int K,
        const __grid_constant__ TileViews views) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int BN = SWIGLU ? kPfBNSwiglu : kPfBN;
  const WgSmem s = wg_smem(smem_raw);
  wg_init(s);
  __syncthreads();
  const int row_tiles = (M + kPfBM - 1) / kPfBM;
  const int tiles = seg_field(segs.tile0, segs.count) * row_tiles;
  const int nk = (K + kPfBK - 1) / kPfBK;
  if (threadIdx.x < 128) {
    wg_producer_regs();
    if (threadIdx.x != 0) return;
    WgPipe p;
    for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
      const int ct = i / row_tiles;
      const int seg = seg_of_tile(segs, ct);
      const int n0 = (ct - seg_field(segs.tile0, seg)) * BN;
      const CUtensorMap* b = seg_view(views, seg);
      const WgBox b1 = SWIGLU ? WgBox{&views.bu, n0, 0, 0, 0}
                              : WgBox{b, n0 + 64, 0, 0, 0};
      wg_load(s, p, {&views.a, 0, (i % row_tiles) * kPfBM, 0, 0},
              {b, n0, 0, 0, 0}, b1, nk);
    }
    return;
  }
  wg_consumer_regs();
  WgPipe p;
  for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
    const int ct = i / row_tiles;
    const int m0 = (i % row_tiles) * kPfBM;
    const int seg = seg_of_tile(segs, ct);
    const int N = seg_field(segs.n, seg);
    const int n0 = (ct - seg_field(segs.tile0, seg)) * BN;
    const StoreEpi<bf16> epi{
        seg_field(segs.c, seg) + static_cast<size_t>(m0) * N + n0, N};
    wg_mma<SWIGLU>(s, p, nk, min(kPfBM, M - m0), min(BN, N - n0),
                   bias_g != nullptr ? bias_g + n0 : nullptr,
                   bias_u != nullptr ? bias_u + n0 : nullptr, epi, [] {});
  }
}

template <bool SWIGLU>
cudaError_t launch_tile_wg(const bf16* a, const Segs<bf16>& segs,
                           const bf16* bu, const bf16* bias_g,
                           const bf16* bias_u, int M, int K, int sms,
                           cudaStream_t stream) {
  TileViews v = {};
  cudaError_t err = a_view(&v.a, a, M, K, K);
  for (int i = 0; err == cudaSuccess && i < segs.count; ++i)
    err = b_view(&v.b[i], segs.b[i], K, segs.n[i], segs.n[i]);
  if (err == cudaSuccess && SWIGLU)
    err = b_view(&v.bu, bu, K, segs.n[0], segs.n[0]);
  // The attribute belongs to the current device: set it on every launch.
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tile_wg<SWIGLU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPfSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles = segs.tile0[segs.count] * ((M + kPfBM - 1) / kPfBM);
  tile_wg<SWIGLU><<<min(tiles, sms), kPfThreads, kPfSmemBytes, stream>>>(
      segs, bias_g, bias_u, M, K, v);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// f32 and odd shapes: the FMA tile of tiles.cuh (64 x 64), one per block.
template <typename T, bool SWIGLU>
__global__ void __launch_bounds__(kFmThreads)
tile_fma(const T* __restrict__ A, Segs<T> segs, const T* __restrict__ Bu,
         const T* __restrict__ bias_g, const T* __restrict__ bias_u, int M,
         int K) {
  const int seg = seg_of_tile(segs, blockIdx.x);
  const int N = seg_field(segs.n, seg);
  const int n0 = (blockIdx.x - seg_field(segs.tile0, seg)) * kFmBN;
  const int m0 = blockIdx.y * kFmBM;
  Tile<T> t;
  t.a = A + static_cast<size_t>(m0) * K;
  t.lda = K;
  t.b = seg_field(segs.b, seg) + n0;
  t.bu = SWIGLU ? Bu + n0 : nullptr;
  t.ldb = N;
  t.bias_g = bias_g != nullptr ? bias_g + n0 : nullptr;
  t.bias_u = bias_u != nullptr ? bias_u + n0 : nullptr;
  t.rows = min(kFmBM, M - m0);
  t.cols = min(kFmBN, N - n0);
  t.K = K;
  const StoreEpi<T> epi{
      seg_field(segs.c, seg) + static_cast<size_t>(m0) * N + n0, N};
  fma_tile<T, SWIGLU>(t, epi);
}

template <typename T, bool SWIGLU>
void launch_tile_fma(const T* a, const Segs<T>& segs, const T* bu,
                     const T* bias_g, const T* bias_u, int M, int K,
                     cudaStream_t stream) {
  dim3 grid(segs.tile0[segs.count], (M + kFmBM - 1) / kFmBM);
  tile_fma<T, SWIGLU><<<grid, kFmThreads, 0, stream>>>(a, segs, bu, bias_g,
                                                        bias_u, M, K);
}

template <typename T>
cudaError_t run_gemm(const Plan& p, const void* a, const void* const* b,
                     void* const* c, const int* n, int count, void* ws, int M,
                     int K, int sms, cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* bs[kMaxSegs] = {};
  T* cs[kMaxSegs] = {};
  for (int i = 0; i < count; ++i) {
    bs[i] = static_cast<const T*>(b[i]);
    cs[i] = static_cast<T*>(c[i]);
  }
  const Segs<T> segs = make_segs<T>(count, bs, cs, n, tile_cols(p.path, 0));
  if constexpr (sizeof(T) == 2) {
    if (p.path == 1)
      return run_stream(A, segs, static_cast<float*>(ws), M, K, p.splits, s);
    if (p.path == 2)
      return launch_tile_wg<false>(A, segs, nullptr, nullptr, nullptr, M, K,
                                   sms, s);
  }
  launch_tile_fma<T, false>(A, segs, nullptr, nullptr, nullptr, M, K, s);
  return cudaSuccess;
}

template <typename T>
cudaError_t run_swiglu(const Plan& p, const void* a, const void* wg,
                       const void* wu, const void* bg, const void* bu,
                       void* out, int M, int N, int K, int sms,
                       cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* g = static_cast<const T*>(wg);
  T* o = static_cast<T*>(out);
  const Segs<T> segs = make_segs<T>(1, &g, &o, &N,
                                    tile_cols(p.path, kOpSwiglu));
  const T* u = static_cast<const T*>(wu);
  const T* bias_g = static_cast<const T*>(bg);
  const T* bias_u = static_cast<const T*>(bu);
  if constexpr (sizeof(T) == 2) {
    if (p.path == 2)
      return launch_tile_wg<true>(A, segs, u, bias_g, bias_u, M, K, sms, s);
  }
  launch_tile_fma<T, true>(A, segs, u, bias_g, bias_u, M, K, s);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch plan of `op` (0: C_i = A @ B_i for n_b = 1..3 products of
// widths n0, n1, n2; 1: the fused SwiGLU, n_b = 1 and n0 = its width) with A
// (M, K) on a card with `sms` SMs. dtype: 0 = bfloat16, 1 = float32. Fills
// *path (0: tile_fma, 1: stream_mma, 2: tile_wg), *tiles (output tiles)
// and *splits (K splits; with more than one a launch needs a workspace of
// splits * M * (n0 + n1 + n2) floats). Returns a cudaError_t.
int tdt_ag_gemm_plan(int op, int M, int n_b, int n0, int n1, int n2, int K,
                     int sms, int dtype, int* path, int* tiles, int* splits) {
  const int n[kMaxSegs] = {n0, n1, n2};
  if (!plan_args_ok(op, M, n_b, n, K, sms, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(op, M, n_b, n, K, sms, dtype);
  *path = p.path;
  *tiles = p.tiles;
  *splits = p.splits;
  return static_cast<int>(cudaSuccess);
}

// C_i = A @ B_i (i < n_b) as tdt_ag_gemm_plan(0, ...) plans it; B_i is
// (K, n_i) and C_i (M, n_i), row-major. ws holds the workspace the plan asks
// for (may be null with one split). Every operand must be 16-byte aligned.
// Returns a cudaError_t.
int tdt_ag_gemm(const void* a, int n_b, const void* b0, const void* b1,
                const void* b2, void* c0, void* c1, void* c2, int n0, int n1,
                int n2, void* ws, int M, int K, int sms, int dtype,
                void* stream) {
  const int n[kMaxSegs] = {n0, n1, n2};
  const void* b[kMaxSegs] = {b0, b1, b2};
  void* c[kMaxSegs] = {c0, c1, c2};
  if (!plan_args_ok(kOpGemm, M, n_b, n, K, sms, dtype) || !aligned16(a))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_b; ++i)
    if (!aligned16(b[i]) || c[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(kOpGemm, M, n_b, n, K, sms, dtype);
  if (p.splits > 65535 || (p.splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? run_gemm<bf16>(p, a, b, c, n, n_b, ws, M, K, sms, s)
                 : run_gemm<float>(p, a, b, c, n, n_b, ws, M, K, sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// act (M, N) = silu(A @ Wg + bg) * (A @ Wu + bu) as tdt_ag_gemm_plan(1, ...)
// plans it; Wg and Wu are (K, N), the biases (N,) or both null. Every
// operand must be 16-byte aligned. Returns a cudaError_t.
int tdt_ag_swiglu(const void* a, const void* wg, const void* wu,
                  const void* bg, const void* bu, void* out, int M, int N,
                  int K, int sms, int dtype, void* stream) {
  if (!plan_args_ok(kOpSwiglu, M, 1, &N, K, sms, dtype) || !aligned16(a) ||
      !aligned16(wg) || !aligned16(wu) || out == nullptr ||
      (bg == nullptr) != (bu == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(kOpSwiglu, M, 1, &N, K, sms, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? run_swiglu<bf16>(p, a, wg, wu, bg, bu, out, M, N, K, sms, s)
          : run_swiglu<float>(p, a, wg, wu, bg, bu, out, M, N, K, sms, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
