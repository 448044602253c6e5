// One output tile of C = A @ B (or of the fused SwiGLU), shared by the
// world-1 kernels of ag_gemm.cu and the ring kernels of ag_gemm_ring.cu and
// gemm_rs_ring.cu, so a tile sums in the same order whichever kernel runs it.
//
//  * The tensor-core tile (bf16, K and every width a multiple of 8): a 128 x
//    128 tile (SwiGLU: 128 x 64 of gate and of up) of a persistent block of
//    three warpgroups. What bounds it: the products, 2 * 128 * 128 * K
//    operations a tile against the card's 989 TFLOP/s, which only wgmma
//    reaches, fed while the tensor cores work and across tile boundaries.
//    What it does:
//    - `wg_load` (warpgroup 0, one thread): TMA loads
//      (cp.async.bulk.tensor) of 64-deep K slices into a ring of kPfStages
//      stages, each a 128 x 64 slice of A and two 64 x 64 boxes of B (the
//      tile's two 64-column halves, or gate and up), in the 128-byte swizzle
//      the wgmma descriptors read. A stage's `full` mbarrier counts its
//      bytes; its `empty` mbarrier the consumer warps that are done with it.
//      The loads of a persistent block's next tile overlap this tile's last
//      products and its epilogue.
//    - `wg_mma` (warpgroups 1 and 2, rows 0-63 and 64-127): one
//      wgmma.mma_async m64n128k16 (bf16 in, f32 accumulate) a 16-deep step,
//      A K-major, B the (K, N) row-major weight read N-major (the transpose
//      bit), the two 64-column boxes one operand 8 KB apart. A SwiGLU tile
//      holds gate in accumulator columns 0-63 and up in 64-127.
//    - The sum: the tensor core's own accumulation is not a full IEEE f32
//      sum over thousands of terms, so the products of each kPfFold stages
//      (128 K terms) go to `part`, which is then added to `acc` in f32.
//      64 x 128 of acc and part are a consumer thread's 128 f32 registers;
//      ptxas budgets all 384 threads at 168 registers whatever `setmaxnreg`
//      gives the consumers at run time, so BN = 128 is the widest tile that
//      keeps the fold without spilling (a second partial, to hide the
//      fold's drain, spilled and ran 2.5x slower on an H100).
//    - Edges: the views (`make_view`) carry each operand's own extent, so
//      TMA fills rows past a chunk, K past its end and columns past the
//      weight with zeros; stores skip rows past `rows` and columns past
//      `cols`. Pipeline stage and mbarrier parities carry from item to item
//      (`WgPipe`): every item of a launch takes the same K slices on both
//      sides.
//  * `fma_tile`: f32 (and odd bf16 shapes) on FMAs, a 64 x 64 tile, 256
//    threads of 4 x 4 outputs, K in slices of 16.
//
// The f32 results go to an epilogue functor (`pair` for two neighbouring
// columns on the tensor-core path, `one` on the FMA path) that rounds and
// stores. The FMA tile reads A from row 0 of `a` (stride lda) and B from
// column 0 of `b` (stride ldb): callers point them at the tile's first row
// and column, so a rank's shard of a global tensor is read in place; rows
// past `rows` and columns past `cols` are zero-filled on load and never
// stored.

#pragma once

#include <cuda.h>    // CUtensorMap and its enums; the encoder is looked up
                     // at run time (tensor_map_encoder), so no libcuda link

#include "gemm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPfBM = 128;                 // rows per tile
constexpr int kPfBK = 64;                  // K per pipeline stage
constexpr int kPfStages = 6;
constexpr int kPfFold = 2;                 // stages summed in the tensor core
constexpr int kPfThreads = 384;            // producer + two consumer groups
constexpr int kPfBN = 128;                 // columns per tile (plain)
constexpr int kPfBNSwiglu = 64;            // columns per tile (gate and up)
constexpr int kPfBox = 64 * 64 * 2;        // bytes of a 64 x 64 bf16 box
constexpr int kPfStageBytes = kPfBM * kPfBK * 2 + 2 * kPfBox;
// The stages, their 2 x kPfStages mbarriers, and 1 KB to align the stages
// to the swizzle pattern's 1024 bytes.
constexpr int kPfSmemBytes = kPfStages * kPfStageBytes + 2 * kPfStages * 8 +
                             1024;

constexpr int kFmBM = 64;
constexpr int kFmBN = 64;
constexpr int kFmBK = 16;
constexpr int kFmThreads = 256;

// SiLU(g) * u in f32, as the TPU kernel's epilogue (gate * sigmoid(gate) *
// up) computes it; expf, not the fast __expf.
__device__ __forceinline__ float swiglu(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// The operands of one FMA tile. `bu`, `bias_g` and `bias_u` are read only by
// the SwiGLU tile (the biases may be null); `bu` shares `ldb` with `b`.
template <typename T>
struct Tile {
  const T* a;
  long long lda;
  const T* b;
  const T* bu;
  long long ldb;
  const T* bias_g;
  const T* bias_u;
  int rows, cols, K;
};

// Rounds to T and stores at c[r * ldc + col].
template <typename T>
struct StoreEpi {
  T* c;
  long long ldc;
  __device__ __forceinline__ void pair(int r, int col, float v0,
                                       float v1) const {
    __nv_bfloat162 p;
    p.x = from_f32<bf16>(v0);
    p.y = from_f32<bf16>(v1);
    *reinterpret_cast<__nv_bfloat162*>(c + r * ldc + col) = p;
  }
  __device__ __forceinline__ void one(int r, int col, float v) const {
    c[r * ldc + col] = from_f32<T>(v);
  }
};

// ---------------------------------------------------------------------------
// Host: TMA views. cuTensorMapEncodeTiled is a driver function; it is found
// through the runtime (cudaGetDriverEntryPoint), so the build links no
// driver library.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 view of `base` for TMA of rank N (at most 5): extents dim[0..N)
// (dim[0] contiguous), row strides step[0..N-1) of dims 1..N-1 in
// elements, boxes of box[0..N) elements (box[0] = 64: 128 bytes) in the
// 128-byte swizzle; elements outside the extents read as zeros. Every step
// must be a multiple of 8 and base 16-byte aligned. An empty view (an
// extent of 0) is left zeroed: no tile reads it.
template <int N>
inline cudaError_t make_box_view(CUtensorMap* map, const void* base,
                                 const long long (&dim)[N],
                                 const long long (&step)[N - 1],
                                 const int (&box)[N]) {
  *map = CUtensorMap{};
  for (long long d : dim)
    if (d == 0) return cudaSuccess;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t gdim[N], gstride[N - 1];
  cuuint32_t gbox[N], elem[N];
  for (int i = 0; i < N; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dim[i]);
    gbox[i] = static_cast<cuuint32_t>(box[i]);
    elem[i] = 1;
  }
  for (int i = 0; i < N - 1; ++i)
    gstride[i] = static_cast<cuuint64_t>(step[i]) * sizeof(bf16);
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, const_cast<void*>(base),
      gdim, gstride, gbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 4-D view with boxes of 64 x `box_rows` elements of dims 0 and 1.
inline cudaError_t make_view(CUtensorMap* map, const void* base,
                             const long long (&dim)[4],
                             const long long (&step)[3], int box_rows) {
  return make_box_view<4>(map, base, dim, step, {64, box_rows, 1, 1});
}

// A (rows, K) row-major view (row stride ld), 128-row boxes of A.
inline cudaError_t a_view(CUtensorMap* map, const void* a, long long rows,
                          long long K, long long ld) {
  return make_view(map, a, {K, rows, 1, 1}, {ld, ld * rows, ld * rows},
                   kPfBM);
}

// A (K, N) row-major weight (row stride ld), 64 x 64 boxes (N inner).
inline cudaError_t b_view(CUtensorMap* map, const void* b, long long K,
                          long long N, long long ld) {
  return make_view(map, b, {N, K, 1, 1}, {ld, ld * K, ld * K}, 64);
}

// The views of one launch's tensor-core tiles: A, each product's B and
// (SwiGLU) Wu. A kernel takes them as a __grid_constant__ parameter.
struct TileViews {
  CUtensorMap a;
  CUtensorMap b[kMaxSegs];
  CUtensorMap bu;
};

// Product seg's view of B, with constant indices.
__device__ __forceinline__ const CUtensorMap* seg_view(const TileViews& v,
                                                       int seg) {
  return seg == 0 ? &v.b[0] : seg == 1 ? &v.b[1] : &v.b[2];
}

// ---------------------------------------------------------------------------
// Device: mbarriers, TMA and wgmma.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of TMA transfers this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// A 4-D TMA load of one box at coordinates (c0, c1, c2, c3) into dst, its
// bytes counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// The same for a 5-D view, coordinates (c0, ..., c4).
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4) : "memory");
}

// Orders this thread's earlier generic-proxy accesses of global memory
// (the acquire of a signal) before its later TMA reads of it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// A wgmma shared-memory descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of r across this point
// (wgmma writes its registers asynchronously, out of the compiler's sight).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A (64 x 16, K-major) @ B (16 x 128) through descriptors, B read
// N-major (kTransB 1, the transpose bit) or K-major (0); scale_d 0
// overwrites d.
template <int kTransB = 1>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

// ---------------------------------------------------------------------------
// The tensor-core tile. A launcher's kernel takes kPfThreads threads and
// kPfSmemBytes of dynamic shared memory (`wg_smem`), calls `wg_init` and
// syncs the block, then splits: threads 0-127 call `wg_producer_regs` and
// thread 0 runs `wg_load` for each of the block's tiles; threads 128-383
// call `wg_consumer_regs` and run `wg_mma` for the same tiles in the same
// order. The two branches never meet again: consumers sync among
// themselves with `consumers_sync`.

// The stage ring in dynamic shared memory, aligned to 1024 bytes.
struct WgSmem {
  unsigned char* base;
  __device__ unsigned char* a(int s) const { return base + s * kPfStageBytes; }
  __device__ unsigned char* b(int s) const {
    return a(s) + kPfBM * kPfBK * 2;
  }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + kPfStages * kPfStageBytes) + s;
  }
  __device__ uint64_t* empty(int s) const { return full(kPfStages + s); }
};

__device__ __forceinline__ WgSmem wg_smem(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + 1023) &
                      ~static_cast<uintptr_t>(1023);
  return WgSmem{reinterpret_cast<unsigned char*>(p)};
}

// Thread 0 initialises the mbarriers: a stage's `full` takes the
// producer's one arrival (and its bytes), its `empty` one arrival from
// each of the eight consumer warps. The caller syncs the block afterwards.
__device__ __forceinline__ void wg_init(const WgSmem& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kPfStages; ++i) {
      mbar_init(s.full(i), 1);
      mbar_init(s.empty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

__device__ __forceinline__ void wg_producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
}
__device__ __forceinline__ void wg_consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
}

// The 256 consumer threads wait for each other (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// Where a stage ring slot stands in the sequence of K slices; each role
// keeps its own, and both advance once per slice of every tile.
struct WgPipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == kPfStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// A box of a tile's operand: its view and coordinates, K slice 0.
struct WgBox {
  const CUtensorMap* map;
  int c0, c1, c2, c3;
};

// The producer's part of one tile of nk K slices: A's 128 x 64 box (K in
// coordinate 0) and B's two 64 x 64 boxes (K in coordinate 1) of each
// slice. One thread calls it.
__device__ __forceinline__ void wg_load(const WgSmem& s, WgPipe& p,
                                        const WgBox& a, const WgBox& b0,
                                        const WgBox& b1, int nk) {
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(s.empty(p.stage), p.phase ^ 1);
    uint64_t* full = s.full(p.stage);
    mbar_expect(full, kPfStageBytes);
    const int k0 = kc * kPfBK;
    tma_load(s.a(p.stage), a.map, full, a.c0 + k0, a.c1, a.c2, a.c3);
    tma_load(s.b(p.stage), b0.map, full, b0.c0, b0.c1 + k0, b0.c2, b0.c3);
    tma_load(s.b(p.stage) + kPfBox, b1.map, full, b1.c0, b1.c1 + k0, b1.c2,
             b1.c3);
    p.next();
  }
}

// The consumers' part of the same tile: the products of nk K slices, then
// `ready()` (every consumer thread calls it; it returns once the epilogue
// may read what it reads), then the epilogue over rows < `rows` and
// columns < `cols` (SwiGLU: gate and up, plus the biases when not null,
// are read at the same column).
template <bool SWIGLU, class Epi, class Ready>
__device__ __forceinline__ void wg_mma(const WgSmem& s, WgPipe& p, int nk,
                                       int rows, int cols,
                                       const bf16* bias_g,
                                       const bf16* bias_u, const Epi& epi,
                                       Ready&& ready) {
  const int t = threadIdx.x - 128;           // consumer thread 0..255
  const int wg = t >> 7;                      // rows 64 wg .. 64 wg + 63
  const int lane = t & 31;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    part[i] = 0.f;
  }
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(s.full(p.stage), p.phase);
    const uint32_t a = smem_addr(s.a(p.stage)) + wg * 64 * kPfBK * 2;
    const uint32_t b = smem_addr(s.b(p.stage));
    const int first = kc % kPfFold == 0;
    reg_fence(part);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kPfBK / 16; ++ks)
      // A: 8-row groups 1024 bytes apart, K step 32 bytes within the
      // swizzled row; B: 8-deep K groups 1024 bytes apart, K step two of
      // them, its two 64-column boxes kPfBox apart.
      wgmma_m64n128k16(part, wg_desc(a + ks * 32, 16, 1024),
                       wg_desc(b + ks * 2048, kPfBox, 1024),
                       first && ks == 0 ? 0 : 1);
    wg_commit();
    if (kc % kPfFold == kPfFold - 1 || kc == nk - 1) {
      wg_wait_all();
      reg_fence(part);
      if (lane == 0) {                  // this fold's stages are free
        mbar_arrive(s.empty(p.stage));
        if (!first) mbar_arrive(s.empty((p.stage + kPfStages - 1) %
                                        kPfStages));
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    p.next();
  }
  ready();

  // Accumulator of m64nN: for each n8 group j, c[4j], c[4j+1] at (row g,
  // cols 8j + 2q, + 1), c[4j+2], c[4j+3] at row g + 8, with g = lane / 4
  // and q = lane % 4, rows 16 w .. of warp w of the warpgroup. cols is a
  // multiple of 8, so both columns of a pair are in range together.
  const int g = lane >> 2;
  const int q = lane & 3;
  const int m_base = wg * 64 + ((t >> 5) & 3) * 16 + g;
  constexpr int NJ = SWIGLU ? 8 : 16;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = j * 8 + 2 * q;
    if (n >= cols) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m_base + half * 8;
      if (m >= rows) continue;
      float v0 = acc[4 * j + 2 * half];
      float v1 = acc[4 * j + 2 * half + 1];
      if constexpr (SWIGLU) {
        float u0 = acc[4 * (j + 8) + 2 * half];
        float u1 = acc[4 * (j + 8) + 2 * half + 1];
        if (bias_g != nullptr) {
          v0 += to_f32(bias_g[n]);
          v1 += to_f32(bias_g[n + 1]);
          u0 += to_f32(bias_u[n]);
          u1 += to_f32(bias_u[n + 1]);
        }
        v0 = swiglu(v0, u0);
        v1 = swiglu(v1, u1);
      }
      epi.pair(m, n, v0, v1);
    }
  }
}

template <typename T, bool SWIGLU, class Epi>
__device__ __forceinline__ void fma_tile(const Tile<T>& t, const Epi& epi) {
  constexpr int NB = SWIGLU ? 2 : 1;
  __shared__ float As[kFmBK][kFmBM + 4];          // A tile, transposed
  __shared__ float Bs[NB][kFmBK][kFmBN + 4];

  const int K = t.K;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[NB][4][4];
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFmBK) {
    for (int e = tid; e < kFmBM * kFmBK; e += kFmThreads) {
      const int r = e / kFmBK;
      const int kk = e % kFmBK;
      As[kk][r] = (r < t.rows && k0 + kk < K)
                      ? to_f32(t.a[r * t.lda + k0 + kk])
                      : 0.f;
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const T* B = h == 0 ? t.b : t.bu;
      for (int e = tid; e < kFmBK * kFmBN; e += kFmThreads) {
        const int r = e / kFmBN;
        const int c = e % kFmBN;
        Bs[h][r][c] = (k0 + r < K && c < t.cols)
                          ? to_f32(B[(k0 + r) * t.ldb + c])
                          : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmBK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = Bs[h][kk][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[h][i][j] = fmaf(a[i], b, acc[h][i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
    if (m >= t.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx * 4 + j;
      if (n >= t.cols) continue;
      float v = acc[0][i][j];
      if constexpr (SWIGLU) {
        float u = acc[NB - 1][i][j];
        if (t.bias_g != nullptr) {
          v += to_f32(t.bias_g[n]);
          u += to_f32(t.bias_u[n]);
        }
        v = swiglu(v, u);
      }
      epi.one(m, n, v);
    }
  }
}

}  // namespace
