// The launch plan of the AG-GEMM / AG-SwiGLU products, shared by the
// world-1 kernel (ag_gemm.cu, exported as tdt_ag_gemm_plan) and the ring
// kernel (ag_gemm_ring.cu, which plans each rank's column shard with it),
// so the ring's decode body runs exactly where, and with the K splits
// that, the world-1 kernel runs its decode plan on that shard.

#pragma once

#include "tiles.cuh"

namespace {

constexpr int kOpGemm = 0;
constexpr int kOpSwiglu = 1;

// Paths of a plan.
constexpr int kPlanFma = 0;       // tile_fma: f32 and odd shapes
constexpr int kPlanDecode = 1;    // stream_mma: bf16 aligned, M <= kTcBM
constexpr int kPlanPrefill = 2;   // tile_wg: bf16 aligned, larger M / SwiGLU

// How one call is launched. The path depends on the op, the dtype and the
// shape only, never on where the operands lie, so equal inputs give equal
// bits.
struct Plan {
  int path;    // kPlanFma, kPlanDecode or kPlanPrefill
  int tiles;   // output tiles (blocks of one split)
  int splits;  // K splits (stream_mma only)
};

// Column tile width and row tile height of a path.
inline int tile_cols(int path, int op) {
  return path == kPlanFma ? kFmBN
         : path == kPlanDecode ? kTcBN
         : op == kOpSwiglu ? kPfBNSwiglu : kPfBN;
}
inline int tile_rows(int path) {
  return path == kPlanFma ? kFmBM : path == kPlanDecode ? kTcBM : kPfBM;
}

inline bool plan_args_ok(int op, int M, int count, const int* n, int K,
                         int sms, int dtype) {
  // K = 0 is a product of zeros (plus the SwiGLU biases).
  if (M <= 0 || K < 0 || sms <= 0 || (dtype != 0 && dtype != 1))
    return false;
  if (op == kOpSwiglu ? count != 1 : (op != kOpGemm || count < 1 ||
                                      count > kMaxSegs))
    return false;
  for (int i = 0; i < count; ++i)
    if (n[i] <= 0) return false;
  return true;
}

// The plan of op over an (M, K) A and widths n[0..count) on a card with
// `sms` SMs (dtype 0: bf16, 1: f32); the arguments pass plan_args_ok.
inline Plan make_plan(int op, int M, int count, const int* n, int K, int sms,
                      int dtype) {
  bool tc = dtype == 0 && K % 8 == 0;
  for (int i = 0; i < count; ++i) tc = tc && n[i] % 8 == 0;
  Plan p;
  p.path = !tc ? kPlanFma
           : (op == kOpGemm && M <= kTcBM) ? kPlanDecode : kPlanPrefill;
  const int bn = tile_cols(p.path, op);
  int col_tiles = 0;
  for (int i = 0; i < count; ++i) col_tiles += (n[i] + bn - 1) / bn;
  p.tiles = col_tiles * ((M + tile_rows(p.path) - 1) / tile_rows(p.path));
  p.splits = p.path == kPlanDecode ? splitk_count(p.tiles, K, sms) : 1;
  return p;
}

}  // namespace
