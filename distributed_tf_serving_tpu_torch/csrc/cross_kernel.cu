// Hand-written Hopper (sm_90a) kernels for the DCN-v2 serving step.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * dts_fused_serve   <- distributed_tf_serving_tpu/ops/cross_kernel.py
//                          build_fused_serve (inner `kernel`): embedding
//                          gather + L cross layers + ReLU MLP + f32 head +
//                          sigmoid, per candidate row. Float weights
//                          (fused_serve_{bf16,f32}_kernel) and the int8
//                          {qw, qscale} weights of ops/quantize.py
//                          (fused_serve_int8_{bf16,f32}_kernel).
//   * dts_cross_stack   <- distributed_tf_serving_tpu/ops/cross_kernel.py
//                          fused_cross_apply / _cross_kernel: the DCN-v2
//                          cross stack x = x0 * (x @ W_l + b_l) + x alone.
//
// What bounds them on an H100 SXM (data-sheet peaks: 3.35 TB/s HBM, 989
// TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 without them). At the serving
// width (43 fields x 16 = 688, L = 3, MLP 256/128/64) the fused serve step
// does ~3.3 MFLOP per row. At 2048 rows that is ~6.7 GFLOP against ~9 MB
// (gathered table rows ~5.6 MB, bf16 weights ~3.3 MB): operation-bound. At
// 256 rows it is ~0.84 GFLOP against ~4 MB, so the weight bytes set it.
// The int8 variant streams 1 byte per weight plus f32 scales (~1.64 MB at
// that width against ~3.3 MB of bf16), the same arithmetic otherwise. In
// f32 the same work on split TF32 (3 products at 494.7 TFLOP/s of TF32)
// bounds it at ~0.04 ms for 2048 rows, where f32 FFMA (67 TFLOP/s) would
// take ~0.1 ms; the f32 weights are 5.8 MB.
//
// What bounds the bf16 fused serve kernel in practice is neither peak.
// A 16-row tile re-reads every weight from L2: 3.4 MB per tile, 435 MB at
// 2048 rows, which in the ~0.075 ms it takes is ~5.8 TB/s of L2 reads, so
// there the L2 stream is the likely limit and more rows per block (each
// weight fragment feeding several mmas) the lever. At the small buckets
// few tiles exist,
// and a tile's time is the serial work of one warp: per 32-deep k chunk
// two B loads from L2 and dependent mma.sync, in groups of 4 chunks whose
// loads are issued together (one L2 round trip per group). The cluster
// split below divides that work over up to 8 SMs per tile.
//
// Design (what the TPU kernel did, and what changes here):
//   * A tile of ROWS rows goes through ALL layers in one launch: a layer
//     needs the whole previous row. The tile's x0 (f32) and the carried
//     activation x (compute dtype, double buffered) live in shared memory.
//   * The TPU kernel kept every weight matrix resident in VMEM; a 688x688
//     bf16 matrix alone is 0.95 MB against 227 KB of shared memory per
//     block, so here weights stream from L2 (the 3.3 MB of bf16 weights fit
//     the 50 MB L2 many times over).
//   * Thread-block cluster (every kernel): a tile is served by a
//     cluster of C in {1, 2, 4, 8} blocks on neighbouring SMs. Rank r owns
//     the 8-column output tiles [r*nt/C, (r+1)*nt/C) of every layer (nt =
//     pad_n(N)/8), so it streams 1/C of the weights and its warps' chains
//     shrink by about C. C is the largest with all tiles' clusters resident
//     at once (the host's rule, ops/cross_kernel.py serve_cluster, from
//     cudaOccupancyMaxActiveClusters; one 512-thread block per SM). A cluster must
//     fit one GPC, so an H100 SXM holds 15 clusters of 8, 30 of 4 and 66 of
//     2 (not 132 / C): 256 rows (16 tiles) take C = 4, 512 and 1024 take
//     C = 2 and 2048 keeps the one-block kernel; a second wave would cost
//     more than the smaller C. Every block gathers the whole x0 tile itself
//     (~44 KB of table rows, cheap next to the weights), so layer 0 of the
//     cross stack and of the MLP need no exchange.
//   * Exchange, one cluster barrier per layer: each rank writes its own
//     columns of `nxt` locally, cluster.sync(), then copies every peer's
//     columns of `nxt` from that peer's shared memory into its own (16-byte
//     DSMEM loads; an 8-column tile of one row is exactly 16 bytes), then
//     __syncthreads(). One barrier suffices because of the double buffers
//     and because a rank pulls from a peer only the columns that peer owns:
//     a peer writes its owned columns of buffer X again two layers later
//     (X is `nxt` at layers l and l+2), after the barrier of layer l+1,
//     which no rank passes before every rank has finished the pull of
//     layer l; and the columns a rank writes into its own X while pulling
//     are ones no peer ever reads from it. The last layer of the MLP and of
//     the cross stack is not exchanged: the head needs only own columns.
//   * Head: after a cluster barrier rank 0 sums wo over the whole last
//     cross output and last MLP output, reading each column from the rank
//     that owns it, in the order of C = 1, adds bo and writes the scores;
//     a last barrier keeps every block resident until rank 0 has read its
//     peers' shared memory. So a row's score has the bits of C = 1 at
//     every C, whatever bucket its batch fills. C = 1 takes none of the
//     cluster steps.
//   * bf16 (the serving dtype) runs on the tensor cores: mma.sync m16n8k16
//     with f32 accumulation. The 16 rows are the mma's M; activations sit
//     row-major in shared memory (row stride padded so the fragment loads
//     are bank-conflict free) and weights are pre-laid out by the host as
//     W^T [N8][K32] (N padded to 8, K to 32, zero-filled), so each lane
//     reads 16 contiguous bytes of A and of B per 32-deep k chunk. Within a
//     chunk the k order is permuted identically in A and B, which leaves
//     the sum unchanged. Each warp owns two 8-column output tiles at a time
//     and issues the B loads of four chunks before their mmas. A rank's
//     ~22 cross-layer tiles at C = 4 are 11 pairs for 16 warps; splitting
//     each pair's k chunks over the idle warps (f32 partials added in
//     shared memory) measured no faster at any C the rule picks, so it is
//     not done.
//   * bf16 cross stack (cross_stack_bf16_kernel<R>): the same cluster
//     split, and R = 16 or 32 rows per tile. At R = 32 each warp keeps two
//     m16 A fragments and feeds every B fragment it loads from L2 to both,
//     which halves the L2 weight stream per row (at 2048 rows and R = 16,
//     128 tiles each re-read 2.9 MB of W^T: ~372 MB). Every rank loads the
//     whole x0 tile and stores only its own columns of x_L; with no head,
//     a closing cluster barrier keeps each block resident until its peers'
//     last DSMEM pull is done (see the kernel). R and C come from the host
//     (ops/cross_kernel.py cross_plan, fed by
//     dts_cross_max_active_clusters); R = 32 is planned only where its
//     shared memory fits. Each element's k order is the same at every
//     (R, C), so every plan gives the same bits. The fused serve kernels
//     keep R = 16.
//   * f32 (the AUC-parity mode) runs on the tensor cores as split TF32:
//     mma.sync m16n8k8 .tf32 with f32 accumulation, each f32 operand a
//     split into hi = a rounded to TF32 (cvt.rna.tf32.f32, done with two
//     integer operations) and lo = a - hi (exact in f32), and per 8-deep k
//     step acc += lo_a * hi_b, += hi_a * lo_b, += hi_a * hi_b. The dropped
//     lo * lo term and the mma's truncation of lo to TF32 leave each
//     product within ~2^-21 of its f32 value (tests/test_torch_f32_kernels.py
//     emulates it); plain TF32 alone would miss the 1e-5 parity by three
//     orders. The tensor cores truncate their f32 sums, so each 32-deep
//     chunk accumulates in fresh accumulators that a rounded f32 add puts
//     into the total. An int8 weight widened to f32 is exact in TF32, so
//     int8 B takes two mmas (lo_a * b, hi_a * b). Activations are row-major
//     f32 in shared memory (row stride pad_k(K) + 4 floats, so each 8-lane
//     phase of the 16-byte A loads hits distinct banks) and split in
//     registers; weights use the bf16 kernels' W^T [pad_n(N)][pad_k(K)]
//     layout in f32 or int8 and are split in registers as they arrive (a
//     host-split copy would double the L2 weight stream, 5.7 MB to 11.4 MB
//     per tile at 688). Lane (g, t) reads 8 consecutive k of A's rows g,
//     g + 8 and of B's column g per 32-deep chunk; mma step s takes the k
//     pair (2s, 2s + 1) of them, the same permutation in A and B.
//   * The f32 kernels take the bf16 kernels' cluster split (same partition,
//     one barrier per layer, DSMEM pull of 32 bytes per row and peer tile),
//     with C from the same host rules fed by the f32 kernels' own cluster
//     capacity. The f32 cross stack takes R = 16 or 32 rows: it keeps no x0
//     tile (x0 fills the buffer that layer 1 overwrites, and each update
//     reads its x0 element from global memory), so two 32-row f32 buffers
//     fit (181 KB at 688) and R = 32 halves the L2 weight stream per row,
//     which bounds the f32 cross stack at 2048 rows. The fused serve kernel
//     keeps R = 16 and its x0 tile. Its head is not summed per rank: each
//     rank stores one partial per row and own 8-column tile, and rank 0
//     adds them in tile order, reading each from its owner, so every C
//     gives the bits of C = 1 (as every (R, C) of the cross stacks does).
//   * The update x0 * (x @ W + b) + x is f32 with explicit _rn operations
//     (no FMA contraction), rounded to the compute dtype once per layer,
//     matching the JAX kernel's rounding points.
//   * The gather reads each 64-byte table row as four float4 loads (the TPU
//     issued one DMA per (row, field) pair). Ids arrive host-folded into
//     [0, V), so they are not range-checked here. Rows past n are zero-
//     filled (0 * finite weights stays 0) and never stored.
//   * int8 weights (per-output-channel scale s): the bf16 path reads 8
//     int8 values per lane and 32-deep chunk (one 8-byte load in place of
//     16 bytes of bf16), widens them to bf16 in registers (exact, |q| <=
//     127) in the same k order as A, and runs the same mma. The widening
//     uses byte permutes and one f32 subtract per value, not the
//     conversion unit (I2F/F2F cost ~15 % of the kernel's time on an
//     H100), and a warp keeps 8 chunks of B loads in flight (the registers
//     4 chunks of bf16 take). The f32 path widens each int8 to f32 the same
//     way and keeps 4 chunks in flight (2 of f32). The scale folds into the f32 result in the JAX kernel's order: xw =
//     acc * s, then + b (cross and MLP alike).
//     The head arrives dequantized to f32 by the host. Padded output
//     columns are never stored (the j < N guard), so their scale is
//     irrelevant.
//   * Padded shared-memory columns are zeroed before use: stale values
//     there would meet the zero-padded weights as garbage * 0 (NaN * 0 is
//     NaN), the same reason the TPU kernel zeroes its scratch.
//
// Plain C interface (loaded with ctypes): pointers and the stream are raw
// addresses; every entry returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int ROWS = 16;             // candidate rows per block (= mma M)
constexpr int MAX_MLP = 4;           // MLP layers the fused serve kernel takes
constexpr int THREADS = 512;         // every kernel's block: 16 warps
constexpr int KCHUNK = 32;           // k depth per pair of m16n8k16 mmas
constexpr int KGROUP = 4;            // k chunks of bf16 B loads issued together

__host__ __device__ inline int pad_k(int k) { return (k + KCHUNK - 1) / KCHUNK * KCHUNK; }
__host__ __device__ inline int pad_n(int n) { return (n + 7) / 8 * 8; }
// Rank r of a cluster of c owns the 8-column tiles [tile_begin(nt, c, r),
// tile_begin(nt, c, r + 1)) of a layer with nt tiles; tile_owner inverts it
// (the largest r whose range starts at or before t).
__host__ __device__ inline int tile_begin(int nt, int c, int r) { return r * nt / c; }
__host__ __device__ inline int tile_owner(int t, int nt, int c) { return ((t + 1) * c - 1) / nt; }
// Row stride (elements) of a row-major bf16 activation tile read as mma A:
// a stride of 64 mod 128 bytes keeps each 8-lane phase of the 16-byte
// fragment loads on distinct banks.
__host__ __device__ inline int lda_of(int k) {
  const int kp = pad_k(k);
  return kp % 64 == 0 ? kp + 32 : kp;
}
// Row stride (floats) of a row-major f32 activation tile read as mma A: 4
// mod 8 floats puts rows g and g + 1 of a 16-byte load phase on distinct
// banks (lanes t = 0..3 of a row are 32 bytes apart).
__host__ __device__ inline int ldf_of(int k) { return pad_k(k) + 4; }

__device__ __forceinline__ float f32_of(bf16 v) { return __bfloat162float(v); }

// The f32 matmul result of a weight column j: scaled by s[j] for int8
// weights (per-output-channel scale), as it is for float weights.
template <typename T>
__device__ __forceinline__ float scaled(float acc, const float* s, int j) {
  if constexpr (std::is_same<T, int8_t>::value) {
    return __fmul_rn(acc, s[j]);
  } else {
    return acc;
  }
}

// out[r] = sum_{j < K} v[r][j] * w[j] in f32, one warp per row: lane-
// strided over j, then a butterfly. Element (r, j) of the tile lives at
// v[r * rs + j] in the shared memory of the rank of a cluster of c that
// owns its 8-column tile (of nt), so the sum and its order do not depend
// on c.
template <typename T>
__device__ void rowdot(const T* v, int rs, int K, const float* __restrict__ w, float* out,
                       int nt, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = warp; r < ROWS; r += nw) {
    float s = 0.f;
    if (c == 1) {
      for (int j = lane; j < K; j += 32) s = fmaf(f32_of(v[r * rs + j]), w[j], s);
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      for (int j = lane; j < K; j += 32)
        s = fmaf(f32_of(*cluster.map_shared_rank(v + r * rs + j, tile_owner(j >> 3, nt, c))),
                 w[j], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[r] = s;
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// x0[r, f*D + e] = table[ids[r, f], e] * wts[r, f] (f32) for the block's
// rows; emit(r, j, value) stores one element. Four float4 loads per 64-byte
// table row when D % 4 == 0.
template <typename Emit>
__device__ void gather(const int* ids, const void* wts, int wts_bf16, const float* table,
                       int n, int F, int D, int row0, Emit emit) {
  const int q4 = (D & 3) == 0 ? D >> 2 : 0;  // float4 chunks per table row
  const int per = q4 ? q4 : D;
  const int items = ROWS * F * per;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int q = i % per;
    const int rf = i / per;
    const int f = rf % F;
    const int r = rf / F;
    const int row = row0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    float w = 0.f;
    if (row < n) {
      const size_t e = (size_t)row * F + f;
      const int id = ids[e];
      w = wts_bf16 ? __bfloat162float(static_cast<const bf16*>(wts)[e])
                   : static_cast<const float*>(wts)[e];
      const float* src = table + (size_t)id * D;
      if (q4) {
        const float4 t = reinterpret_cast<const float4*>(src)[q];
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
      } else {
        v[0] = src[q];
      }
    }
    const int j = f * D + (q4 ? 4 * q : q);
    const int cnt = q4 ? 4 : 1;
    for (int c = 0; c < cnt; ++c) emit(r, j + c, __fmul_rn(v[c], w));
  }
}

// ====================================================== bf16: mma.sync path

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four int8 values (the bytes of v, lowest first) as two packed bf16x2
// registers. Each byte b becomes the f32 with bits 0x4B0000(b ^ 0x80), which
// is 2^23 + 128 + b; subtracting 2^23 + 128 leaves b exactly. |b| <= 127 is
// exact in bf16, so its bf16 bits are the f32's high half.
__device__ __forceinline__ float i8_byte_to_f32(uint32_t u, uint32_t sel) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, sel)), 8388736.f);
}
__device__ __forceinline__ uint32_t bf16x2_of(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  lo = bf16x2_of(i8_byte_to_f32(u, 0x7650), i8_byte_to_f32(u, 0x7651));
  hi = bf16x2_of(i8_byte_to_f32(u, 0x7652), i8_byte_to_f32(u, 0x7653));
}

// One lane's B fragment of a 32-deep chunk: the 8 consecutive k values
// k0 .. k0 + 7 of one output column, loaded raw, then expanded to four
// packed bf16x2 registers (k pairs 0-1, 2-3, 4-5, 6-7) in the same k
// order as A's fragment.
template <typename T>
struct BFrag;
template <>
struct BFrag<bf16> {
  typedef uint4 Raw;  // 16 bytes
  static constexpr int kGroup = KGROUP;
  static __device__ __forceinline__ Raw load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ uint4 expand(Raw r) { return r; }
};
template <>
struct BFrag<int8_t> {
  typedef uint2 Raw;  // 8 bytes: rows of pad_k(K) bytes keep it aligned
  static constexpr int kGroup = 2 * KGROUP;  // half the bytes: twice the chunks in flight
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ uint4 expand(Raw r) {
    uint4 o;
    i8x4_to_bf16x4(r.x, o.x, o.y);
    i8x4_to_bf16x4(r.y, o.z, o.w);
    return o;
  }
};

// C[R, N] = A[R, K] @ W[K, N] on the tensor cores, for the 8-column output
// tiles [t0, t1) only; R = 16 or 32 rows, H = R / 16 m16 row halves. A is
// row-major in shared memory (stride lda, columns [K, pad_k(K)) zero); WT
// is W^T laid out [pad_n(N)][pad_k(K)] in global memory, zero-padded, bf16
// or int8. epi(r, j, value) gets every element of those tiles with j < N,
// in f32 (unscaled). Every B fragment loaded from L2 feeds the mmas of all
// H halves, so at R = 32 a row costs half the weight stream it costs at 16.
// Each element's k order is the same at every R and every tile range.
template <int R, typename T, typename Epi>
__device__ __forceinline__ void mma_layer(const bf16* A, int lda, int K,
                                          const T* __restrict__ WT, int N, int t0, int t1,
                                          Epi epi) {
  constexpr int H = R / 16;
  static_assert(R == 16 * H && (H == 1 || H == 2), "R is 16 or 32 rows");
  const int kp = pad_k(K);
  const int nch = kp / KCHUNK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* a_lo = A + g * lda + 8 * t;
  const bf16* a_hi = A + (g + 8) * lda + 8 * t;
  typedef typename BFrag<T>::Raw Raw;
  const Raw zero = {};
  for (int tile = t0 + 2 * warp; tile < t1; tile += 2 * nw) {
    const bool two = tile + 1 < t1;
    float c[2][H][4] = {};
    const T* b0p = WT + (size_t)(tile * 8 + g) * kp + 8 * t;
    const T* b1p = b0p + (size_t)8 * kp;
    constexpr int G = BFrag<T>::kGroup;
    for (int c0 = 0; c0 < nch; c0 += G) {
      Raw bq[G][2];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const bool ok = c0 + u < nch;
        const int off = (c0 + u) * KCHUNK;
        bq[u][0] = ok ? BFrag<T>::load(b0p + off) : zero;
        bq[u][1] = ok && two ? BFrag<T>::load(b1p + off) : zero;
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (c0 + u < nch) {
          const int off = (c0 + u) * KCHUNK;
          // Lane (g, t) holds k = off + 8t .. off + 8t + 7 of rows g and
          // g + 8 of each half: pairs 0-1 feed the first mma, 2-3 the second.
          uint4 lo[H], hi[H];
#pragma unroll
          for (int h = 0; h < H; ++h) {
            lo[h] = *reinterpret_cast<const uint4*>(a_lo + 16 * h * lda + off);
            hi[h] = *reinterpret_cast<const uint4*>(a_hi + 16 * h * lda + off);
          }
          const uint4 b0 = BFrag<T>::expand(bq[u][0]);
#pragma unroll
          for (int h = 0; h < H; ++h) {
            mma_bf16(c[0][h], lo[h].x, hi[h].x, lo[h].y, hi[h].y, b0.x, b0.y);
            mma_bf16(c[0][h], lo[h].z, hi[h].z, lo[h].w, hi[h].w, b0.z, b0.w);
          }
          if (two) {
            const uint4 b1 = BFrag<T>::expand(bq[u][1]);
#pragma unroll
            for (int h = 0; h < H; ++h) {
              mma_bf16(c[1][h], lo[h].x, hi[h].x, lo[h].y, hi[h].y, b1.x, b1.y);
              mma_bf16(c[1][h], lo[h].z, hi[h].z, lo[h].w, hi[h].w, b1.z, b1.w);
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s == 0 || two) {
        const int j = (tile + s) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int r = 16 * h + g;
          if (j < N) {
            epi(r, j, c[s][h][0]);
            epi(r + 8, j, c[s][h][2]);
          }
          if (j + 1 < N) {
            epi(r, j + 1, c[s][h][1]);
            epi(r + 8, j + 1, c[s][h][3]);
          }
        }
      }
    }
  }
}

// Zero a bf16 region of `count` elements (count * 2 a multiple of 16).
__device__ void zero_bf16(bf16* p, int count) {
  uint4* q = reinterpret_cast<uint4*>(p);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < count / 8; i += blockDim.x) q[i] = z;
}

// After cluster.sync(): copy every peer's columns of the row-major R-row
// tile `buf` (stride ld, nt 8-column tiles) from the peer that owns them
// into this block's copy, one 16-byte DSMEM load per row and tile. Only the
// owner's columns are read from a peer (the one-barrier argument in the
// header depends on it).
template <int R>
__device__ void pull_peers(bf16* buf, int ld, int nt, int c, int me) {
  cg::cluster_group cluster = cg::this_cluster();
  const int t0 = tile_begin(nt, c, me), own = tile_begin(nt, c, me + 1) - t0;
  const int other = nt - own;
  for (int i = threadIdx.x; i < R * other; i += blockDim.x) {
    int t = i % other;
    if (t >= t0) t += own;  // skip this block's own tiles
    bf16* p = buf + (i / other) * ld + 8 * t;
    *reinterpret_cast<uint4*>(p) =
        *reinterpret_cast<const uint4*>(cluster.map_shared_rank(p, tile_owner(t, nt, c)));
  }
}

// L cross layers over row-major bf16 R-row tiles (x0 f32 row-major, stride
// d); returns the buffer holding x_L. sc: [L, d] scales of int8 weights.
// Rank `me` of a cluster of c blocks computes its own columns of every
// layer and pulls the others' after each layer but the last (whose own
// columns are all the caller reads). No barrier follows the last pull: a
// caller with c > 1 and L >= 2 must cluster.sync() before its block exits.
template <int R, typename T>
__device__ const bf16* mma_cross(const float* x0, bf16* xb0, bf16* xb1, int d, int ldx,
                                 const T* __restrict__ WcT, const float* __restrict__ bc,
                                 const float* __restrict__ sc, int L, int c, int me) {
  bf16* cur = xb0;
  bf16* nxt = xb1;
  const size_t wstride = (size_t)pad_n(d) * pad_k(d);
  const int nt = pad_n(d) / 8;
  const int t0 = tile_begin(nt, c, me), t1 = tile_begin(nt, c, me + 1);
  for (int l = 0; l < L; ++l) {
    const float* b = bc + (size_t)l * d;
    const float* s = sc ? sc + (size_t)l * d : nullptr;
    mma_layer<R>(cur, ldx, d, WcT + l * wstride, d, t0, t1, [&](int r, int j, float acc) {
      const int o = r * ldx + j;
      const float xw = __fadd_rn(scaled<T>(acc, s, j), b[j]);
      nxt[o] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(x0[r * d + j], xw), __bfloat162float(cur[o])));
    });
    if (c > 1 && l + 1 < L) {
      cg::this_cluster().sync();
      pull_peers<R>(nxt, ldx, nt, c, me);
    }
    __syncthreads();  // every warp read all of `cur`; the next layer overwrites it
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// ============================================= f32: split-TF32 mma.sync path

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded to TF32, half away from zero (cvt.rna.tf32.f32
// for finite x); lo = x - hi is exact in f32, and the mma reads its top 19
// bits (TF32 truncation).
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(__fsub_rn(x, __uint_as_float(hi)))};
}

// One lane's B fragment of a 32-deep chunk for the f32 kernels: the 8
// consecutive k values k0 .. k0 + 7 of one output column, loaded raw, then
// widened to f32 in k order.
template <typename T>
struct TF32Frag;
template <>
struct TF32Frag<float> {
  struct Raw {
    float4 a, b;
  };  // 32 bytes
  static constexpr int kGroup = 2;
  static constexpr bool kExact = false;
  static __device__ __forceinline__ Raw load(const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return {__ldg(q), __ldg(q + 1)};
  }
  static __device__ __forceinline__ void expand(const Raw& r, float (&v)[8]) {
    v[0] = r.a.x, v[1] = r.a.y, v[2] = r.a.z, v[3] = r.a.w;
    v[4] = r.b.x, v[5] = r.b.y, v[6] = r.b.z, v[7] = r.b.w;
  }
};
template <>
struct TF32Frag<int8_t> {
  typedef uint2 Raw;  // 8 bytes
  static constexpr int kGroup = 4;  // a quarter of the bytes: twice the chunks in flight
  static constexpr bool kExact = true;
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void expand(const Raw& r, float (&v)[8]) {
    const uint32_t x = r.x ^ 0x80808080u, y = r.y ^ 0x80808080u;
    v[0] = i8_byte_to_f32(x, 0x7650), v[1] = i8_byte_to_f32(x, 0x7651);
    v[2] = i8_byte_to_f32(x, 0x7652), v[3] = i8_byte_to_f32(x, 0x7653);
    v[4] = i8_byte_to_f32(y, 0x7650), v[5] = i8_byte_to_f32(y, 0x7651);
    v[6] = i8_byte_to_f32(y, 0x7652), v[7] = i8_byte_to_f32(y, 0x7653);
  }
};

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// C[R, N] = A[R, K] @ W[K, N] in split TF32, for the 8-column output
// tiles [t0, t1) only; R = 16 or 32 rows, H = R / 16 m16 row halves. A is
// row-major f32 in shared memory (stride lda, columns [K, pad_k(K)) zero);
// WT is W^T laid out [pad_n(N)][pad_k(K)] in global memory, zero-padded,
// f32 or int8. epi(r, j, value) gets every element of those tiles with
// j < N, in f32 (unscaled). Each warp owns two tiles at a time; every B
// value is split once per step for both halves, every A value once for
// both tiles. Each 32-deep chunk accumulates in fresh mma accumulators,
// one for the small products and one for hi * hi (two chains in flight),
// whose sum is added to the f32 total with a rounded add: the tensor cores
// truncate their f32 sums, and a chunk's partial is far smaller than the
// total. Each element's k order is the same at every R and every tile
// range.
template <int R, typename T, typename Epi>
__device__ __forceinline__ void tf32_layer(const float* A, int lda, int K,
                                           const T* __restrict__ WT, int N, int t0, int t1,
                                           Epi epi) {
  constexpr int H = R / 16;
  static_assert(R == 16 * H && (H == 1 || H == 2), "R is 16 or 32 rows");
  typedef TF32Frag<T> F;
  typedef typename F::Raw Raw;
  constexpr int G = H == 2 ? 1 : F::kGroup;  // two halves: registers for one chunk of B
  const int kp = pad_k(K);
  const int nch = kp / KCHUNK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* a_top = A + g * lda + 8 * t;
  const Raw zero = {};
  for (int tile = t0 + 2 * warp; tile < t1; tile += 2 * nw) {
    const bool two = tile + 1 < t1;
    float sum[2][H][4] = {};
    const T* b0p = WT + (size_t)(tile * 8 + g) * kp + 8 * t;
    const T* b1p = b0p + (size_t)8 * kp;
    for (int c0 = 0; c0 < nch; c0 += G) {
      Raw bq[G][2];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const bool ok = c0 + u < nch;
        const int off = (c0 + u) * KCHUNK;
        bq[u][0] = ok ? F::load(b0p + off) : zero;
        bq[u][1] = ok && two ? F::load(b1p + off) : zero;
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (c0 + u < nch) {
          const int off = (c0 + u) * KCHUNK;
          // Lane (g, t) holds k = off + 8t .. off + 8t + 7 of rows g and
          // g + 8 of each half and of column g of each tile; step s takes
          // the pair 2s, 2s + 1.
          float a[H][2][8], b[2][8];
#pragma unroll
          for (int h = 0; h < H; ++h) {
            load8(a_top + 16 * h * lda + off, a[h][0]);
            load8(a_top + (16 * h + 8) * lda + off, a[h][1]);
          }
          F::expand(bq[u][0], b[0]);
          F::expand(bq[u][1], b[1]);
          float c[2][H][4] = {}, cs[2][H][4] = {};  // hi * hi; the small products
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            Split sb[2][2];
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                sb[q][e] = F::kExact ? Split{__float_as_uint(b[q][2 * s + e]), 0u}
                                     : split_tf32(b[q][2 * s + e]);
#pragma unroll
            for (int h = 0; h < H; ++h) {
              const Split sa[4] = {split_tf32(a[h][0][2 * s]), split_tf32(a[h][1][2 * s]),
                                   split_tf32(a[h][0][2 * s + 1]), split_tf32(a[h][1][2 * s + 1])};
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                if (q == 1 && !two) continue;
                // The small products first; B exact in TF32 has no lo part.
                mma_tf32(cs[q][h], sa[0].lo, sa[1].lo, sa[2].lo, sa[3].lo, sb[q][0].hi,
                         sb[q][1].hi);
                if (!F::kExact)
                  mma_tf32(cs[q][h], sa[0].hi, sa[1].hi, sa[2].hi, sa[3].hi, sb[q][0].lo,
                           sb[q][1].lo);
                mma_tf32(c[q][h], sa[0].hi, sa[1].hi, sa[2].hi, sa[3].hi, sb[q][0].hi,
                         sb[q][1].hi);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int h = 0; h < H; ++h)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                sum[q][h][i] = __fadd_rn(sum[q][h][i], __fadd_rn(cs[q][h][i], c[q][h][i]));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 0 || two) {
        const int j = (tile + q) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int r = 16 * h + g;
          if (j < N) {
            epi(r, j, sum[q][h][0]);
            epi(r + 8, j, sum[q][h][2]);
          }
          if (j + 1 < N) {
            epi(r, j + 1, sum[q][h][1]);
            epi(r + 8, j + 1, sum[q][h][3]);
          }
        }
      }
    }
  }
}

// Zero an f32 region of `count` elements (count a multiple of 4).
__device__ void zero_f32(float* p, int count) {
  float4* q = reinterpret_cast<float4*>(p);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < count / 4; i += blockDim.x) q[i] = z;
}

// pull_peers for a row-major R-row f32 tile (stride ld floats): an
// 8-column tile of one row is 32 bytes, two 16-byte DSMEM loads. Only the
// owner's columns are read from a peer.
template <int R>
__device__ void pull_peers_f32(float* buf, int ld, int nt, int c, int me) {
  cg::cluster_group cluster = cg::this_cluster();
  const int t0 = tile_begin(nt, c, me), own = tile_begin(nt, c, me + 1) - t0;
  const int other = nt - own;
  for (int i = threadIdx.x; i < 2 * R * other; i += blockDim.x) {
    const int q = i >> 1;
    int t = q % other;
    if (t >= t0) t += own;  // skip this block's own tiles
    float* p = buf + (q / other) * ld + 8 * t + 4 * (i & 1);
    *reinterpret_cast<float4*>(p) =
        *reinterpret_cast<const float4*>(cluster.map_shared_rank(p, tile_owner(t, nt, c)));
  }
}

// L cross layers over row-major f32 R-row tiles of stride ld; returns the
// buffer holding x_L. Layer 0 reads `first` (x0 in f32: rounding x0 to
// the compute dtype is the identity), then the layers write xa, xb, xa,
// ...; `first` may be xb. x0_at(r, j) gives x0 for the update. sc: [L, d]
// scales of int8 weights. Rank `me` of a cluster of c computes its own
// columns of every layer and pulls the others' after each layer but the
// last; as for mma_cross, a caller with c > 1 and L >= 2 must
// cluster.sync() before its block exits.
template <int R, typename T, typename X0>
__device__ const float* tf32_cross(const float* first, float* xa, float* xb, int d, int ld,
                                   X0 x0_at, const T* __restrict__ WcT,
                                   const float* __restrict__ bc, const float* __restrict__ sc,
                                   int L, int c, int me) {
  const float* cur = first;
  float* nxt = xa;
  const size_t wstride = (size_t)pad_n(d) * pad_k(d);
  const int nt = pad_n(d) / 8;
  const int t0 = tile_begin(nt, c, me), t1 = tile_begin(nt, c, me + 1);
  for (int l = 0; l < L; ++l) {
    const float* b = bc + (size_t)l * d;
    const float* s = sc ? sc + (size_t)l * d : nullptr;
    tf32_layer<R>(cur, ld, d, WcT + l * wstride, d, t0, t1, [&](int r, int j, float acc) {
      const int o = r * ld + j;
      const float xw = __fadd_rn(scaled<T>(acc, s, j), b[j]);
      nxt[o] = __fadd_rn(__fmul_rn(x0_at(r, j), xw), cur[o]);
    });
    if (c > 1 && l + 1 < L) {
      cg::this_cluster().sync();
      pull_peers_f32<R>(nxt, ld, nt, c, me);
    }
    __syncthreads();  // every warp read all of `cur`; the next layer overwrites it
    cur = nxt;
    nxt = nxt == xa ? xb : xa;
  }
  return cur;
}

// The head of a width-K layer v (16 rows, stride ld) as per-tile partials
// of this rank's own 8-column tiles [t0, t1): part[r * nt + t] = the sum of
// v[r][j] * w[j] over the tile's columns j < K, in j order.
__device__ void tile_dots(const float* v, int ld, int K, const float* __restrict__ w, float* part,
                          int nt, int t0, int t1) {
  const int own = t1 - t0;
  for (int i = threadIdx.x; i < ROWS * own; i += blockDim.x) {
    const int r = i / own, t = t0 + i % own;
    const int j1 = min(8 * t + 8, K);
    float acc = 0.f;
    for (int j = 8 * t; j < j1; ++j) acc = fmaf(v[r * ld + j], w[j], acc);
    part[r * nt + t] = acc;
  }
}

// One row's sum of the nt tile partials of a layer, each read from its
// owner in a cluster of c, by one warp: lane-strided over the tiles, then
// a butterfly. The order does not depend on c.
__device__ float sum_tiles(const float* part, int r, int nt, int c) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int t = lane; t < nt; t += 32)
    acc = __fadd_rn(acc, *cluster.map_shared_rank(part + r * nt + t, tile_owner(t, nt, c)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
}

struct ServeArgs {
  const int* ids;       // [n, F] int32, host-folded into [0, V)
  const void* wts;      // [n, F] bf16 or f32
  int wts_bf16;
  const float* table;   // [V, D] f32
  // Weights: f32 or int8 [K, N] for the f32 kernels; bf16 or int8 W^T
  // [pad_n(N), pad_k(K)] for the bf16 kernels.
  const void* wc;       // cross [L] x [d, d]
  const float* bc;      // [L, d] f32
  const float* sc;      // [L, d] f32 scales (int8 weights only)
  int L;
  const void* wm[MAX_MLP];   // MLP layer m: [K_m, M_m]
  const float* bm[MAX_MLP];  // [M_m] f32
  const float* sm[MAX_MLP];  // [M_m] f32 scales (int8 weights only)
  int mdims[MAX_MLP];
  int n_mlp;
  int mmax;
  const float* wo;      // [d + M_last] f32 head
  const float* bo;      // [1] f32
  float* pred;          // [n] f32
  float* logit;         // [n] f32
  int n, F, D;
};

__device__ void write_scores(const ServeArgs& a, const float* lc, const float* lh, int row0) {
  if (threadIdx.x < ROWS) {
    const int row = row0 + threadIdx.x;
    if (row < a.n) {
      const float lo = __fadd_rn(__fadd_rn(lc[threadIdx.x], lh[threadIdx.x]), a.bo[0]);
      a.logit[row] = lo;
      a.pred[row] = sigmoid(lo);
    }
  }
}

// The columns [j0, j1) of a width-N layer that rank me of c owns.
__device__ __forceinline__ void own_columns(int N, int c, int me, int& j0, int& j1) {
  const int nt = pad_n(N) / 8;
  j0 = 8 * tile_begin(nt, c, me);
  j1 = min(8 * tile_begin(nt, c, me + 1), N);
}

// T: the weights' element type (float, or int8_t with scales). The block
// is rank `me` of a cluster of c serving tile blockIdx.x / c, as in
// serve_bf16, with f32 activations and split-TF32 products. The head is
// summed from per-tile partials in tile order, so every c gives the bits
// of c = 1.
template <typename T>
__device__ __forceinline__ void serve_f32(const ServeArgs& a, unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), me = (int)cluster.block_rank();
  const int d = a.F * a.D;
  const int ldx = ldf_of(d), ldh = ldf_of(a.mmax);
  float* x0 = reinterpret_cast<float*>(smem);
  float* xb0 = x0 + ROWS * ldx;
  float* xb1 = xb0 + ROWS * ldx;
  float* hb0 = xb1 + ROWS * ldx;
  float* hb1 = hb0 + ROWS * ldh;
  float* pc = hb1 + ROWS * ldh;          // [ROWS][pad_n(d) / 8] cross head partials
  float* ph = pc + ROWS * (pad_n(d) / 8);  // [ROWS][pad_n(M_last) / 8] MLP head partials
  const int row0 = (int)(blockIdx.x / c) * ROWS;

  zero_f32(x0, ROWS * (3 * ldx + 2 * ldh));
  __syncthreads();
  gather(a.ids, a.wts, a.wts_bf16, a.table, a.n, a.F, a.D, row0,
         [&](int r, int j, float x) { x0[r * ldx + j] = x; });
  __syncthreads();

  const float* in = x0;
  int lda = ldx, K = d;
  for (int m = 0; m < a.n_mlp; ++m) {
    float* out = (m & 1) ? hb1 : hb0;
    const int M = a.mdims[m];
    const float* b = a.bm[m];
    const float* s = a.sm[m];
    const int nt = pad_n(M) / 8;
    tf32_layer<ROWS>(in, lda, K, static_cast<const T*>(a.wm[m]), M, tile_begin(nt, c, me),
                     tile_begin(nt, c, me + 1), [&](int r, int j, float acc) {
                       const float y = __fadd_rn(scaled<T>(acc, s, j), b[j]);
                       out[r * ldh + j] = y > 0.f ? y : 0.f;
                     });
    // Columns [M, pad_k(M)) feed the next layer's padded k: clear what an
    // earlier, wider layer left there.
    const int gap = pad_k(M) - M;
    for (int i = threadIdx.x; i < ROWS * gap; i += blockDim.x)
      out[(i / gap) * ldh + M + i % gap] = 0.f;
    if (c > 1 && m + 1 < a.n_mlp) {
      cluster.sync();
      pull_peers_f32<ROWS>(out, ldh, nt, c, me);
    }
    __syncthreads();
    in = out;
    lda = ldh;
    K = M;
  }
  const int nth = pad_n(K) / 8, ntc = pad_n(d) / 8;
  tile_dots(in, lda, K, a.wo + d, ph, nth, tile_begin(nth, c, me), tile_begin(nth, c, me + 1));

  const float* xc = tf32_cross<ROWS>(
      x0, xb0, xb1, d, ldx, [&](int r, int j) { return x0[r * ldx + j]; },
      static_cast<const T*>(a.wc), a.bc, a.sc, a.L, c, me);
  tile_dots(xc, ldx, d, a.wo, pc, ntc, tile_begin(ntc, c, me), tile_begin(ntc, c, me + 1));
  // Rank 0 adds the tile partials of both heads in tile order, reading each
  // from its owner: the same sums, in the same order, at every c.
  if (c > 1) cluster.sync(); else __syncthreads();
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int r = warp; me == 0 && r < ROWS; r += nw) {
    const float lo = __fadd_rn(__fadd_rn(sum_tiles(pc, r, ntc, c), sum_tiles(ph, r, nth, c)),
                               a.bo[0]);
    const int row = row0 + r;
    if ((threadIdx.x & 31) == 0 && row < a.n) {
      a.logit[row] = lo;
      a.pred[row] = sigmoid(lo);
    }
  }
  if (c > 1) cluster.sync();  // no block exits while rank 0 may still read its partials
}

// T: the weights' element type (bf16, or int8_t with scales). The block
// is rank `me` of a cluster of c serving tile blockIdx.x / c (header).
template <typename T>
__device__ __forceinline__ void serve_bf16(const ServeArgs& a, unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), me = (int)cluster.block_rank();
  const int d = a.F * a.D;
  const int ldx = lda_of(d), ldh = lda_of(a.mmax);
  float* x0 = reinterpret_cast<float*>(smem);
  bf16* xb0 = reinterpret_cast<bf16*>(x0 + (size_t)ROWS * d);
  bf16* xb1 = xb0 + ROWS * ldx;
  bf16* hb0 = xb1 + ROWS * ldx;
  bf16* hb1 = hb0 + ROWS * ldh;
  float* lh = reinterpret_cast<float*>(hb1 + ROWS * ldh);
  float* lc = lh + ROWS;
  const int row0 = (int)(blockIdx.x / c) * ROWS;

  zero_bf16(xb0, 2 * ROWS * ldx + 2 * ROWS * ldh);
  __syncthreads();
  gather(a.ids, a.wts, a.wts_bf16, a.table, a.n, a.F, a.D, row0, [&](int r, int j, float x) {
    x0[r * d + j] = x;
    xb0[r * ldx + j] = __float2bfloat16_rn(x);
  });
  __syncthreads();

  const bf16* in = xb0;
  int lda = ldx, K = d;
  for (int m = 0; m < a.n_mlp; ++m) {
    bf16* out = (m & 1) ? hb1 : hb0;
    const int M = a.mdims[m];
    const float* b = a.bm[m];
    const float* s = a.sm[m];
    const int nt = pad_n(M) / 8;
    mma_layer<ROWS>(in, lda, K, static_cast<const T*>(a.wm[m]), M, tile_begin(nt, c, me),
              tile_begin(nt, c, me + 1), [&](int r, int j, float acc) {
                const float y = __fadd_rn(scaled<T>(acc, s, j), b[j]);
                out[r * ldh + j] = __float2bfloat16_rn(y > 0.f ? y : 0.f);
              });
    // Columns [M, pad_k(M)) feed the next layer's padded k: clear what an
    // earlier, wider layer left there.
    const int gap = pad_k(M) - M;
    for (int i = threadIdx.x; i < ROWS * gap; i += blockDim.x)
      out[(i / gap) * ldh + M + i % gap] = __float2bfloat16_rn(0.f);
    if (c > 1 && m + 1 < a.n_mlp) {
      cluster.sync();
      pull_peers<ROWS>(out, ldh, nt, c, me);
    }
    __syncthreads();
    in = out;
    lda = ldh;
    K = M;
  }
  const bf16* xc = mma_cross<ROWS>(x0, xb0, xb1, d, ldx, static_cast<const T*>(a.wc), a.bc,
                                   a.sc, a.L, c, me);
  if (c > 1) cluster.sync();  // every rank's columns of both last layers are written
  // Rank 0 sums both heads whole, reading each column from its owner: the
  // sums of C = 1, in its order, at every c.
  if (me == 0) {
    rowdot(in, lda, K, a.wo + d, lh, pad_n(K) / 8, c);
    rowdot(xc, ldx, d, a.wo, lc, pad_n(d) / 8, c);
    __syncthreads();
    write_scores(a, lc, lh, row0);
  }
  if (c > 1) cluster.sync();  // no block exits while rank 0 may still read its columns
}

__global__ void __launch_bounds__(THREADS) fused_serve_f32_kernel(ServeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  serve_f32<float>(a, smem);
}

__global__ void __launch_bounds__(THREADS) fused_serve_int8_f32_kernel(ServeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  serve_f32<int8_t>(a, smem);
}

__global__ void __launch_bounds__(THREADS) fused_serve_bf16_kernel(ServeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  serve_bf16<bf16>(a, smem);
}

__global__ void __launch_bounds__(THREADS) fused_serve_int8_bf16_kernel(ServeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  serve_bf16<int8_t>(a, smem);
}

// The bf16 cross stack: a tile of R rows (16 or 32) served by a cluster of
// c blocks (the launch's cluster size, 1 included). Every rank loads the
// whole x0 tile, computes its own columns of every layer through
// mma_cross (pulling the peers' after each layer but the last) and stores
// its own columns of x_L.
template <int R>
__global__ void __launch_bounds__(THREADS)
    cross_stack_bf16_kernel(const bf16* __restrict__ x0g, const bf16* __restrict__ wT,
                            const float* __restrict__ b, bf16* __restrict__ out, int n, int d,
                            int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), me = (int)cluster.block_rank();
  const int ldx = lda_of(d);
  float* x0 = reinterpret_cast<float*>(smem);
  bf16* xb0 = reinterpret_cast<bf16*>(x0 + (size_t)R * d);
  bf16* xb1 = xb0 + R * ldx;
  const int row0 = (int)(blockIdx.x / c) * R;
  zero_bf16(xb0, 2 * R * ldx);
  __syncthreads();
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, j = i % d, row = row0 + r;
    const bf16 v = row < n ? x0g[(size_t)row * d + j] : __float2bfloat16_rn(0.f);
    x0[r * d + j] = __bfloat162float(v);
    xb0[r * ldx + j] = v;
  }
  __syncthreads();
  const bf16* xc = mma_cross<R>(x0, xb0, xb1, d, ldx, wT, b, nullptr, L, c, me);
  int j0, j1;
  own_columns(d, c, me, j0, j1);
  const int w = j1 - j0;
  for (int i = threadIdx.x; i < R * w; i += blockDim.x) {
    const int r = i / w, j = j0 + i % w, row = row0 + r;
    if (row < n) out[(size_t)row * d + j] = xc[r * ldx + j];
  }
  // Block lifetime: mma_cross's last pull (after layer L - 2) reads the
  // peers' shared memory with no barrier after it, so a rank that got here
  // first could exit while a slower peer still reads its shared memory
  // through DSMEM, which is undefined. The fused serve kernel is covered
  // by its head's closing barrier; this kernel has no head, so it waits
  // for the whole cluster here.
  if (c > 1 && L >= 2) cluster.sync();
}

// The f32 cross stack: a tile of R rows (16 or 32) served by a cluster of
// c blocks (the launch's cluster size, 1 included), as
// cross_stack_bf16_kernel<R> with f32 activations and split-TF32 products.
// A block holds two x buffers and no x0 tile: x0 fills the first buffer for
// layer 0's product, which layer 1 then overwrites, and every update reads
// its x0 element from global memory (R rows x own columns per layer, next
// to the 5.7 MB of W^T each tile streams). So R = 32 fits (181 KB at d =
// 688) and halves the L2 weight stream per row.
template <int R>
__global__ void __launch_bounds__(THREADS)
    cross_stack_f32_kernel(const float* __restrict__ x0g, const float* __restrict__ wT,
                           const float* __restrict__ b, float* __restrict__ out, int n, int d,
                           int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), me = (int)cluster.block_rank();
  const int ld = ldf_of(d);
  float* xa = reinterpret_cast<float*>(smem);
  float* xb = xa + R * ld;
  const int row0 = (int)(blockIdx.x / c) * R;
  zero_f32(xa, 2 * R * ld);
  __syncthreads();
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, j = i % d, row = row0 + r;
    if (row < n) xb[r * ld + j] = x0g[(size_t)row * d + j];
  }
  __syncthreads();
  const float* xc = tf32_cross<R>(
      xb, xa, xb, d, ld,
      [&](int r, int j) { return row0 + r < n ? x0g[(size_t)(row0 + r) * d + j] : 0.f; }, wT, b,
      static_cast<const float*>(nullptr), L, c, me);
  int j0, j1;
  own_columns(d, c, me, j0, j1);
  const int w = j1 - j0;
  for (int i = threadIdx.x; i < R * w; i += blockDim.x) {
    const int r = i / w, j = j0 + i % w, row = row0 + r;
    if (row < n) out[(size_t)row * d + j] = xc[r * ld + j];
  }
  if (c > 1 && L >= 2) cluster.sync();  // block lifetime: see cross_stack_bf16_kernel
}

// ------------------------------------------------------------ host side

// The fused serve kernel of a compute dtype for float or int8 weights.
void (*serve_kernel(int cd_bf16, int w_int8))(ServeArgs) {
  if (cd_bf16) return w_int8 ? fused_serve_int8_bf16_kernel : fused_serve_bf16_kernel;
  return w_int8 ? fused_serve_int8_f32_kernel : fused_serve_f32_kernel;
}

// A launch of `blocks` blocks in clusters of c along x.
void cluster_launch(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks, size_t smem,
                    cudaStream_t s, int c) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// How many clusters of c blocks of `kernel` at `smem` bytes of dynamic
// shared memory the current device holds at once, into *out.
template <typename... Args>
int max_active_clusters(void (*kernel)(Args...), size_t smem, int c, int* out) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch(&cfg, &attr, c, smem, nullptr, c);
  e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  cudaGetLastError();  // a refusal is returned here, not left for the next launch
  return (int)e;
}

// Launch `blocks` blocks of `kernel` in clusters of c; a size the launch
// refuses is returned as its error.
template <typename... Args, typename... Actual>
int launch(void (*kernel)(Args...), size_t smem, int blocks, int c, cudaStream_t s,
           Actual... args) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_launch(&cfg, &attr, blocks, smem, s, c);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // clears a refusal as well
  return (int)(e != cudaSuccess ? e : last);
}

typedef void (*CrossBf16Kernel)(const bf16*, const bf16*, const float*, bf16*, int, int, int);
typedef void (*CrossF32Kernel)(const float*, const float*, const float*, float*, int, int, int);

CrossBf16Kernel bf16_cross_kernel(int rows) {
  return rows == 32 ? cross_stack_bf16_kernel<32> : cross_stack_bf16_kernel<16>;
}
CrossF32Kernel f32_cross_kernel(int rows) {
  return rows == 32 ? cross_stack_f32_kernel<32> : cross_stack_f32_kernel<16>;
}

}  // namespace

extern "C" {

int dts_rows_per_block() { return ROWS; }

int dts_max_mlp_layers() { return MAX_MLP; }

// Warps of a block (the host's cross_plan counts their rounds).
int dts_warps() { return THREADS / 32; }

// Row stride (elements) of the bf16 activation tiles, and the padding the
// host applies to the weights of every kernel: W^T as [pad_n(N)][pad_k(K)].
int dts_bf16_pad_k(int k) { return pad_k(k); }
int dts_bf16_pad_n(int n) { return pad_n(n); }
// Row stride (floats) of the f32 activation tiles.
int dts_f32_ld(int k) { return ldf_of(k); }

// The column partition of the cluster split (the host mirrors it).
int dts_tile_begin(int nt, int c, int r) { return tile_begin(nt, c, r); }
int dts_tile_owner(int t, int nt, int c) { return tile_owner(t, nt, c); }

// x0 (f32), two x and two h buffers; the head partials (bf16: two per
// row; f32: one per row and 8-column tile of the last cross and MLP layers).
size_t dts_serve_smem_bytes(int d, int mmax, int cd_bf16) {
  if (cd_bf16)
    return (size_t)ROWS * d * 4 + 2 * (size_t)ROWS * lda_of(d) * 2 +
           2 * (size_t)ROWS * lda_of(mmax) * 2 + 2 * ROWS * sizeof(float);
  return (size_t)ROWS * 4 * (3 * (size_t)ldf_of(d) + 2 * (size_t)ldf_of(mmax)) +
         (size_t)ROWS * 4 * (pad_n(d) / 8 + pad_n(mmax) / 8);
}

// A `rows`-row cross-stack tile: x0 (f32) and two bf16 x buffers, or two
// f32 x buffers.
size_t dts_cross_smem_bytes(int d, int cd_bf16, int rows) {
  if (cd_bf16) return (size_t)rows * d * 4 + 2 * (size_t)rows * lda_of(d) * 2;
  return (size_t)rows * 4 * 2 * ldf_of(d);
}

const char* dts_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// How many clusters of c fused-serve blocks (width d, widest MLP layer
// mmax, the compute dtype's kernel) the current device holds at once.
int dts_serve_max_active_clusters(int c, int d, int mmax, int cd_bf16, int w_int8, int* out) {
  return max_active_clusters(serve_kernel(cd_bf16, w_int8), dts_serve_smem_bytes(d, mmax, cd_bf16),
                             c, out);
}

// w_int8: the weights are int8 with f32 per-output-channel scales sc
// ([L, d]) and sm[m] ([M_m]); otherwise float in the compute dtype and the
// scale pointers are ignored. cluster: blocks per 16-row tile (>= 1; the
// host picks it); a size the launch refuses is returned as its error.
int dts_fused_serve(const int* ids, const void* wts, int wts_bf16, const float* table,
                    const void* wc, const float* bc, int L, const void* const* wm,
                    const float* const* bm, const int* mdims, int n_mlp, const float* wo,
                    const float* bo, float* pred, float* logit, int n, int F, int D,
                    int cd_bf16, int w_int8, const float* sc, const float* const* sm,
                    int cluster, void* stream) {
  if (n_mlp < 1 || n_mlp > MAX_MLP || n < 0 || cluster < 1) return (int)cudaErrorInvalidValue;
  if (w_int8 && (sc == nullptr || sm == nullptr)) return (int)cudaErrorInvalidValue;
  for (int m = 0; w_int8 && m < n_mlp; ++m)
    if (sm[m] == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ServeArgs a;
  a.ids = ids;
  a.wts = wts;
  a.wts_bf16 = wts_bf16;
  a.table = table;
  a.wc = wc;
  a.bc = bc;
  a.sc = w_int8 ? sc : nullptr;
  a.L = L;
  a.n_mlp = n_mlp;
  a.mmax = 0;
  for (int m = 0; m < MAX_MLP; ++m) {
    a.wm[m] = m < n_mlp ? wm[m] : nullptr;
    a.bm[m] = m < n_mlp ? bm[m] : nullptr;
    a.sm[m] = w_int8 && m < n_mlp ? sm[m] : nullptr;
    a.mdims[m] = m < n_mlp ? mdims[m] : 0;
    if (a.mdims[m] > a.mmax) a.mmax = a.mdims[m];
  }
  a.wo = wo;
  a.bo = bo;
  a.pred = pred;
  a.logit = logit;
  a.n = n;
  a.F = F;
  a.D = D;
  const int grid = (n + ROWS - 1) / ROWS;
  return launch(serve_kernel(cd_bf16, w_int8), dts_serve_smem_bytes(F * D, a.mmax, cd_bf16),
                grid * cluster, cluster, static_cast<cudaStream_t>(stream), a);
}

// How many clusters of c cross-stack blocks of `rows` rows (16 or 32) at
// width d, of the compute dtype's kernel, the current device holds at once,
// into *out.
int dts_cross_max_active_clusters(int c, int d, int rows, int cd_bf16, int* out) {
  if (rows != 16 && rows != 32) return (int)cudaErrorInvalidValue;
  const size_t smem = dts_cross_smem_bytes(d, cd_bf16, rows);
  if (cd_bf16) return max_active_clusters(bf16_cross_kernel(rows), smem, c, out);
  return max_active_clusters(f32_cross_kernel(rows), smem, c, out);
}

// rows, cluster: rows per block (16 or 32) and blocks per tile (>= 1; the
// host picks both). A plan the launch refuses is returned as its error.
int dts_cross_stack(const void* x0, const void* w, const float* b, void* out, int n, int d,
                    int L, int cd_bf16, int rows, int cluster, void* stream) {
  if (n < 0 || cluster < 1 || (rows != 16 && rows != 32)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = dts_cross_smem_bytes(d, cd_bf16, rows);
  const int blocks = (n + rows - 1) / rows * cluster;
  if (cd_bf16)
    return launch(bf16_cross_kernel(rows), smem, blocks, cluster, s, static_cast<const bf16*>(x0),
                  static_cast<const bf16*>(w), b, static_cast<bf16*>(out), n, d, L);
  return launch(f32_cross_kernel(rows), smem, blocks, cluster, s, static_cast<const float*>(x0),
                static_cast<const float*>(w), b, static_cast<float*>(out), n, d, L);
}

}  // extern "C"
