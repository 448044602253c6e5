// The decode body: C_i = A @ B_i for M <= 64 rows (larger M over 64-row
// tiles), bf16 with K and every width a multiple of 8, f32 accumulation
// and one rounding. gemm_ar.cu (GEMM-AR at world 1, and gemm_rs at M <=
// 64) and ag_gemm.cu's decode plan (up to three products over one A) run
// its kernel `stream_tc`; the rings (gemm_rs_ring.cu's decode phase 0,
// ag_gemm_ring.cu's `ag_stream_ring_kernel`) run its item `stream_item`
// inside their cooperative launches, on each rank's shard with the
// world-1 plan of that shard, so their partials are this kernel's bits.
//
// What bounds it: the bytes of B. At M <= 64 a product does 2 M operations
// per element of B, far below the ~295 per byte the card needs before its
// tensor cores matter, so the least time is sizeof(B) / 3.35 TB/s (H100
// SXM): 32 MiB of Qwen3-8B's o_proj in 0.010 ms, 201 MB of its gate|up in
// 0.060. What the design does about it:
//  * An item is one 64-column tile of B, one 64-row tile of A and one K
//    split, on one warpgroup (128 threads). Its thread 0 brings B's 64 x 64
//    boxes and A's matching (rows, 64) box by TMA (tiles.cuh's views, the
//    128-byte swizzle) into a ring of StreamCfg::kStages stages, 9-16 KB
//    each (48-54 KB a block, four blocks an SM); a stage is refilled as
//    soon as all four warps have multiplied it. No producer warp: the
//    tensor cores are idle most of the time at decode (a variant that
//    overlapped each stage's products with the next stage's, with
//    per-warp `empty` barriers, ran 2-5 % slower on an H100).
//  * The world-1 launch may start while the stream's previous kernel
//    finishes (programmatic dependent launch): the blocks set up their
//    ring, then wait for that kernel before their first load.
//  * wgmma with the operands swapped: Cᵀ = Bᵀ Aᵀ. The weight box is the
//    64-row side (M of m64nNk16), read MN-major through the transpose bit
//    (B's boxes are N-inner); the tokens are its N = 8, 16, 32 or 64
//    (`MT`, the rows of A rounded up), read K-major. A thread holds MT / 2
//    f32 sums, none of them for a zero row of an m16 fragment.
//  * The sum (the rule of tiles.cuh's tile): the tensor core's own
//    accumulation is not a full IEEE f32 sum over thousands of terms, so
//    each stage's 64 K terms are summed in the tensor core into `part`,
//    which is then added to `acc` in f32, stage by stage.
//  * The K splits of a column tile are one thread-block cluster along K
//    (at most 8 blocks, the portable size), launched with
//    cudaLaunchKernelEx: rank 0 sums the splits' f32 partials through
//    distributed shared memory in split order, from 0.f (the order of
//    gemm_common.cuh's splitk_reduce and of the rings' split sums), then
//    rounds once and stores. No workspace, no second launch, no atomics:
//    equal inputs give equal bits from run to run.
//  * The plan (gemm_common.cuh's stream_splits) fills the card in whole
//    waves: tiles x splits close to a multiple of the SMs, each split a
//    whole number of stages.

#pragma once

#include "tiles.cuh"

namespace {

// The stage ring of an item whose A tile has MT rows (8, 16, 32 or 64): a
// stage holds B's 64 x 64 box (8 KB) and A's MT x 64 box, both in the
// 128-byte swizzle; about 50 KB in all, so four blocks share an SM (on an
// H100, 12 / 11 / 9 / 6 stages, two blocks an SM, and 8 / 7 / 6 / 4, three,
// ran the decode products 2-14 % slower: more items in flight an SM beat
// a deeper ring).
template <int MT>
struct StreamCfg {
  static_assert(MT == 8 || MT == 16 || MT == 32 || MT == 64, "token tile");
  static constexpr int kStages = MT == 8 ? 6 : MT == 16 ? 5 : MT == 32 ? 4 : 3;
  static constexpr int kABytes = MT * kTcBK * 2;
  static constexpr int kStageBytes = kPfBox + kABytes;
  // The stages, their `full` mbarriers, and 1 KB to align the stages to the
  // swizzle pattern's 1024 bytes.
  static constexpr int kSmem = kStages * kStageBytes + kStages * 8 + 1024;
};

// The L2 fetch of the decode views' box rows: 128 bytes, one row of a box
// (the tile's 256 ran every decode product 1-3 % slower on an H100).
constexpr CUtensorMapL2promotion kStreamL2 = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;

// The rows an item's A tile holds for M rows: 8 * ceil(M / 8) rounded up
// to a power of two, 64 above 32.
inline int stream_tokens(int M) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
}

template <int MT>
struct StreamSmem {
  using Cfg = StreamCfg<MT>;
  unsigned char* base;
  __device__ unsigned char* b(int s) const {
    return base + s * Cfg::kStageBytes;
  }
  __device__ unsigned char* a(int s) const { return b(s) + kPfBox; }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + Cfg::kStages * Cfg::kStageBytes) +
           s;
  }
};

// The ring in a block's dynamic shared memory; thread 0 initialises its
// mbarriers (one arrival each: thread 0's, with the stage's bytes). The
// caller syncs the block afterwards.
template <int MT>
__device__ __forceinline__ StreamSmem<MT> stream_smem(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + 1023) &
                      ~static_cast<uintptr_t>(1023);
  const StreamSmem<MT> s{reinterpret_cast<unsigned char*>(p)};
  if (threadIdx.x == 0) {
    for (int i = 0; i < StreamCfg<MT>::kStages; ++i) mbar_init(s.full(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return s;
}

// d (+)= W (64 x 16) @ X (16 x N): W the weight box read MN-major (the
// transpose bit: 64 output columns contiguous), X the tokens' box read
// K-major; scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_stream(float (&d)[N / 2],
                                             uint64_t desc_w,
                                             uint64_t desc_x, int scale_d);

template <>
__device__ __forceinline__ void wgmma_stream<8>(float (&d)[4],
                                                 uint64_t desc_w,
                                                 uint64_t desc_x,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_w), "l"(desc_x), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_stream<16>(float (&d)[8],
                                                 uint64_t desc_w,
                                                 uint64_t desc_x,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_w), "l"(desc_x), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_stream<32>(float (&d)[16],
                                                 uint64_t desc_w,
                                                 uint64_t desc_x,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_w), "l"(desc_x), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_stream<64>(float (&d)[32],
                                                 uint64_t desc_w,
                                                 uint64_t desc_x,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_w), "l"(desc_x), "r"(scale_d));
}

// K stages of the split that starts at k0 of K, k_per_split deep.
__device__ __forceinline__ int stream_stages(int K, int k0, int k_per_split) {
  const int k1 = min(K, k0 + k_per_split);
  return k1 > k0 ? (k1 - k0 + kTcBK - 1) / kTcBK : 0;
}

// The `ready` of an item whose A is in place before it starts.
struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

// One item: acc = the f32 partial of a 64-column tile of B over nk K
// stages, every thread of the warpgroup calling it. `a` is A's box at K
// stage 0 (K in coordinate 0, rows in the view's row coordinate), `b` B's
// (columns in coordinate 0, K in coordinate 1). `seq` counts the stages
// this block has run before (every thread keeps its own, all equal): stage
// q of the item sits in slot (seq + q) % kStages, and the mbarrier
// parities follow from it, so a block runs items one after another without
// resetting the ring. Thread 0 issues the first kStages stages, then
// refills each slot once every warp has multiplied it. kBFirst (for an A
// that other blocks are still writing): B's first stages are issued, then
// `ready()` (every thread calls it; it returns once A may be read), then
// thread 0 orders what it acquired before the TMA reads of A
// (fence.proxy.async) and issues A's boxes. The sums do not change.
template <int MT, bool kBFirst = false, class Ready = NoWait>
__device__ __forceinline__ void stream_item(const StreamSmem<MT>& s, int& seq,
                                            const WgBox& a, const WgBox& b,
                                            int nk, float (&acc)[MT / 2],
                                            const Ready& ready = Ready{}) {
  using Cfg = StreamCfg<MT>;
  constexpr int S = Cfg::kStages;
  const bool issuer = threadIdx.x == 0;
  auto issue_b = [&](int q) {
    const int slot = (seq + q) % S;
    uint64_t* full = s.full(slot);
    mbar_expect(full, Cfg::kStageBytes);
    tma_load(s.b(slot), b.map, full, b.c0, b.c1 + q * kTcBK, b.c2, b.c3);
  };
  auto issue_a = [&](int q) {
    const int slot = (seq + q) % S;
    tma_load(s.a(slot), a.map, s.full(slot), a.c0 + q * kTcBK, a.c1, a.c2,
             a.c3);
  };
  const int pre = min(nk, S);
  if (issuer)
    for (int q = 0; q < pre; ++q) {
      issue_b(q);
      if (!kBFirst) issue_a(q);
    }
  if constexpr (kBFirst) {
    ready();
    if (issuer) {
      fence_proxy_async();
      for (int q = 0; q < pre; ++q) issue_a(q);
    }
  }

  float part[MT / 2];
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) {
    acc[i] = 0.f;
    part[i] = 0.f;
  }
  for (int kc = 0; kc < nk; ++kc) {
    const int slot = (seq + kc) % S;
    mbar_wait(s.full(slot), ((seq + kc) / S) & 1);
    const uint32_t w = smem_addr(s.b(slot));
    const uint32_t x = smem_addr(s.a(slot));
    reg_fence(part);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks)
      // W: 8-deep K groups 1024 bytes apart, a 16-deep step two of them;
      // X: 8-row groups 1024 bytes apart, K step 32 bytes within the
      // swizzled row (tiles.cuh's B and A descriptors).
      wgmma_stream<MT>(part, wg_desc(w + ks * 2048, kPfBox, 1024),
                       wg_desc(x + ks * 32, 16, 1024), ks);
    wg_commit();
    wg_wait_all();
    reg_fence(part);
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) acc[i] += part[i];
    __syncthreads();                      // every warp is done with the slot
    if (issuer && kc + S < nk) {
      issue_b(kc + S);
      issue_a(kc + S);
    }
  }
  seq += nk;
}

// Calls f(n, m, v) for each of this thread's MT / 2 sums of an item: v is
// C's element at row m (< MT) of the item's row tile and column n (< 64)
// of its column tile. The accumulator of m64nN: for each n8 group j,
// d[4j], d[4j+1] at (row g, columns 8j + 2q, + 1) and d[4j+2], d[4j+3] at
// row g + 8, g = lane / 4, q = lane % 4, rows 16 w .. of warp w; its rows
// are C's columns and its columns C's rows.
template <int MT, class F>
__device__ __forceinline__ void stream_frag(const float (&acc)[MT / 2],
                                            F&& f) {
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int r = 0; r < MT / 2; ++r)
    f(16 * w + (lane >> 2) + 8 * ((r >> 1) & 1),
      8 * (r >> 2) + 2 * (lane & 3) + (r & 1), acc[r]);
}

// ---------------------------------------------------------------------------
// The split reduce through distributed shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of `addr` (this block's shared memory) in cluster block
// `rank`'s shared memory.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float cluster_load(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Every block of a cluster of `splits` blocks (cluster rank = its split)
// puts its partial into its shared memory at `buf` (the stage ring's,
// free once the item is done); rank 0 sums the partials in split order
// from 0.f into acc. Returns whether this block holds the sum. No block
// leaves before rank 0 has read it.
template <int R>
__device__ __forceinline__ bool cluster_sum(float (&acc)[R],
                                            unsigned char* buf, int rank,
                                            int splits) {
  float* red = reinterpret_cast<float*>(buf);
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < R; ++r) red[r * kTcThreads + t] = acc[r];
  cluster_sync();
  if (rank == 0) {
    float sum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] = 0.f;
    const uint32_t mine = smem_addr(red + t);
    for (int p = 0; p < splits; ++p) {
      const uint32_t at = cluster_map(mine, p);
#pragma unroll
      for (int r = 0; r < R; ++r)
        sum[r] += cluster_load(at + r * kTcThreads * 4);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = sum[r];
  }
  cluster_sync();
  return rank == 0;
}

// ---------------------------------------------------------------------------
// Returns once the grids this one depends on (the stream's previous
// kernel) have finished and their writes are visible. The world-1 kernel
// is launched with programmatic stream serialization, so its blocks may
// start while the previous kernel's last blocks run: they set up the ring,
// then wait here before they read anything (that kernel may have written
// A or even B) or write C. On an H100 this took 0.0005-0.0015 ms off each
// call; issuing B's first stages before the wait gained no more.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The world-1 kernel: grid = (splits, column tiles of all products, row
// tiles), one cluster per (column tile, row tile) along K. views.a: A (M,
// K) in MT-row boxes; views.b[i]: product i's B.
template <int MT>
__global__ void __launch_bounds__(kTcThreads)
stream_tc(Segs<bf16> segs, int M, int K, int k_per_split,
          const __grid_constant__ TileViews views) {
  extern __shared__ unsigned char smem_raw[];
  const StreamSmem<MT> s = stream_smem<MT>(smem_raw);
  __syncthreads();
  const int z = blockIdx.x;
  const int tile = blockIdx.y;
  const int m0 = blockIdx.z * kTcBM;
  const int seg = seg_of_tile(segs, tile);
  const int n0 = (tile - seg_field(segs.tile0, seg)) * kTcBN;
  const int k0 = z * k_per_split;
  float acc[MT / 2];
  int seq = 0;
  grid_dependency_wait();
  stream_item<MT>(s, seq, {&views.a, k0, m0, 0, 0},
                  {seg_view(views, seg), n0, k0, 0, 0},
                  stream_stages(K, k0, k_per_split), acc);
  if (gridDim.x > 1 && !cluster_sum(acc, s.base, z, gridDim.x)) return;
  const int N = seg_field(segs.n, seg);
  const long long ld = seg_field(segs.ld, seg);
  bf16* C = seg_field(segs.c, seg);
  stream_frag<MT>(acc, [&](int n, int m, float v) {
    if (m0 + m < M && n0 + n < N)
      C[(m0 + m) * ld + n0 + n] = from_f32<bf16>(v);
  });
}

// A (rows, K) row-major (row stride ld) in boxes of 64 K x MT rows.
inline cudaError_t stream_a_view(CUtensorMap* map, const void* a,
                                 long long rows, long long K, long long ld,
                                 int mt) {
  return make_box_view<4>(map, a, {K, rows, 1, 1}, {ld, ld * rows, ld * rows},
                          {64, mt, 1, 1}, kStreamL2);
}

template <int MT>
cudaError_t launch_stream_tc(const bf16* a, const Segs<bf16>& segs, int M,
                             int K, int splits, cudaStream_t stream) {
  TileViews v = {};
  cudaError_t err = stream_a_view(&v.a, a, M, K, K, MT);
  for (int i = 0; err == cudaSuccess && i < segs.count; ++i)
    err = b_view(&v.b[i], segs.b[i], K, segs.n[i], segs.ld[i], kStreamL2);
  constexpr int smem = StreamCfg<MT>::kSmem;
  // The attribute belongs to the current device: set it on every launch.
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stream_tc<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, segs.tile0[segs.count], (M + kTcBM - 1) / kTcBM);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, stream_tc<MT>, segs, M, K,
                            stream_k_per_split(K, splits, 1), v);
}

// The decode products of `segs` (tiles kTcBN wide) in one launch with the
// plan's `splits` (a cluster along K when more than one).
cudaError_t run_stream(const bf16* A, const Segs<bf16>& segs, int M, int K,
                       int splits, cudaStream_t stream) {
  switch (stream_tokens(M)) {
    case 8: return launch_stream_tc<8>(A, segs, M, K, splits, stream);
    case 16: return launch_stream_tc<16>(A, segs, M, K, splits, stream);
    case 32: return launch_stream_tc<32>(A, segs, M, K, splits, stream);
    default: return launch_stream_tc<64>(A, segs, M, K, splits, stream);
  }
}

}  // namespace
