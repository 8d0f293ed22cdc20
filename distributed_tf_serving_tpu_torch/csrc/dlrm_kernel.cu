// Hand-written Hopper (sm_90a) kernel for DLRM's dot interaction.
//
// Replaces no TPU kernel: the JAX package computes DLRM's interaction with
// plain jnp (distributed_tf_serving_tpu/models/dlrm.py apply). It was added
// because the port's eager interaction took about ten launches per batch
// (fold, gather, two casts, multiply, cat, float, bmm into an f32 square,
// index, cat) around the one operator that defines the model.
//
//   * dts_dlrm_interact <- models/dlrm.py apply, the part between the bottom
//     MLP and the top MLP. Per candidate row: the weighted gather of F table
//     rows of D floats (ids folded into [0, V) by modulo), stacked under the
//     bottom MLP's output as Z [F + 1, D], and the dot products of every
//     pair i < j of Z's rows (the upper triangle of Z Z^T without its
//     diagonal, row-major), written after the bottom output: the top MLP's
//     input [bottom ++ interactions], D + (F + 1) F / 2 wide, in bf16.
//
// Numerics (models/dlrm.py's in the bf16 compute dtype): each gathered row
// rounded to bf16 (a bf16 table's rows already are), times its weight (the
// host hands bf16 weights), the product rounded to bf16
// (models/embeddings.py field_embed); the bottom output rounded to bf16;
// each dot a sum of exact bf16 x bf16 products in f32. The eager path hands
// the top MLP an f32 input whose first product rounds it to bf16
// (models/base.py matmul_f32), so writing bf16 here loses nothing. Each dot
// is summed in an order fixed by D alone (16-deep mma k steps in ascending
// k), so a row's bits do not depend on the row count of its call. That
// order is not the eager bmm's, so a dot may round to the neighbouring bf16
// value of the eager path's.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16). At the
// MLPerf widths (F = 26, D = 128) a row reads 26 table rows of 512 bytes
// (13,312 bytes), 104 bytes of ids, 52 of bf16 weights and the 512-byte
// bottom output, and writes 958 bytes: ~14.9 KB against 2 x 351 x 128 =
// 89,856 operations, ~6 operations a byte against the card's ~295, so
// memory bounds it; in practice the latency of random 512-byte reads from
// a table far larger than the 50 MB L2 (12 GB at 23.5M rows), which no two
// rows of a batch are likely to share.
//
// Design:
//   * One warp per candidate row, WARPS warps a block, a grid-stride loop
//     over rows (one row per warp at the serving buckets).
//   * Gather: each lane loads 4 elements of a table row, 16 bytes of an f32
//     table (a whole 512-byte row per warp instruction at D = 128) or 8 of
//     a bf16 one (the kernel is a template on the table's type), GROUP rows
//     requested before any is used, so a warp keeps GROUP rows in flight. Lane
//     f (and f + 32) loads field f's id and weight once per row; the warp
//     passes them round by shuffles.
//   * Z lives in shared memory as bf16: pad16(F + 1) rows with a stride of
//     pad16(D) + 8 elements (an odd multiple of 4 words, so the fragment
//     loads below, 8 rows x 4 consecutive words, hit 32 distinct banks).
//     Padding rows and columns are zeroed once and never written again.
//   * Z Z^T on the tensor cores: mma.sync m16n8k16 bf16 -> f32 with A a
//     16-row tile of Z and B an 8-row tile of Z read as the column-major
//     k x n operand (the columns of Z^T are Z's rows). Only 16 x 8 tiles
//     that hold some element i < j < F + 1 are computed: 6 of the 32 x 32
//     square's 8 at F = 26.
//   * Each lane writes the upper-triangle elements of its accumulators to
//     their place in the output row.
//   * Registers: a block of 128 threads may use up to 255 a thread, and the
//     kernel is not bound by occupancy (one block per SM at 512 rows), so
//     it sets no cap; capped at 128 (4 blocks an SM) ptxas spilled 40 bytes.
//
// Plain C interface (loaded with ctypes, ops/dlrm_kernel.py): pointers and
// the stream are raw addresses; the entry returns cudaGetLastError() after
// its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;               // rows in flight per block
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = 13;              // table rows a lane has in flight (F = 26: two groups)
constexpr int MAX_FEATURES = 64;       // F + 1: two id / weight registers a lane
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }
// Row stride (elements) of Z in shared memory.
__host__ __device__ constexpr int z_ld(int d) { return pad16(d) + 8; }

__host__ __device__ constexpr size_t smem_bytes(int nf, int d) {
  return (size_t)WARPS * pad16(nf) * z_ld(d) * sizeof(bf16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Four values rounded to bf16, as two packed bf16x2 words (lowest first).
__device__ __forceinline__ uint2 bf16x4(float a, float b, float c, float d) {
  return make_uint2(bf16_bits(a) | (bf16_bits(b) << 16), bf16_bits(c) | (bf16_bits(d) << 16));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Four consecutive elements of a table row, as floats: one 16-byte load of
// an f32 table, one 8-byte load of a bf16 one.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Write element (i, j) of Z Z^T to the output row when it is one of the
// pairs the model uses (i < j < nf), at its row-major upper-triangle index.
__device__ __forceinline__ void emit(bf16* orow, int i, int j, int nf, float v) {
  if (i < j && j < nf) orow[i * nf - i * (i + 1) / 2 + (j - i - 1)] = __float2bfloat16_rn(v);
}

}  // namespace

// ids [n, F] int32 (any value: folded into [0, vocab) here, as
// torch.remainder folds); wts [n, F] bf16; table [vocab, D] T (f32, or bf16
// for bf16 params); bottom [n, D] f32; out [n, D + nf (nf - 1) / 2] bf16,
// nf = F + 1. D % 4 == 0 and nf <= MAX_FEATURES (the host checks both).
template <typename T>
__global__ void __launch_bounds__(THREADS)
dlrm_interact_bf16_kernel(const int* __restrict__ ids, const bf16* __restrict__ wts,
                          const T* __restrict__ table, int vocab,
                          const float* __restrict__ bottom, bf16* __restrict__ out, int n,
                          int F, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nf = F + 1;
  const int rows_pad = pad16(nf);
  const int kp = pad16(D);
  const int ld = z_ld(D);
  const int d4 = D / 4;
  const int width = D + nf * (nf - 1) / 2;
  bf16* z = reinterpret_cast<bf16*>(smem_raw) + (size_t)warp * rows_pad * ld;

  // Zero this warp's Z once: its padding rows and columns stay zero.
  {
    uint32_t* zw = reinterpret_cast<uint32_t*>(z);
    const int words = rows_pad * ld / 2;
    for (int i = lane; i < words; i += 32) zw[i] = 0u;
  }
  __syncwarp();

  const int g = lane >> 2;  // the mma fragments' group and thread in group
  const int t = lane & 3;
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long row = (long long)blockIdx.x * WARPS + warp; row < n; row += stride) {
    // This row's ids, folded, and its weights: field f's in lane f % 32,
    // register f / 32.
    const int* idr = ids + row * F;
    int id0 = 0, id1 = 0;
    float w0 = 0.f, w1 = 0.f;
    if (lane < F) {
      id0 = idr[lane] % vocab;
      id0 += id0 < 0 ? vocab : 0;
      w0 = __bfloat162float(wts[row * F + lane]);
    }
    if (lane + 32 < F) {
      id1 = idr[lane + 32] % vocab;
      id1 += id1 < 0 ? vocab : 0;
      w1 = __bfloat162float(wts[row * F + lane + 32]);
    }
    bf16* orow = out + row * width;

    // Z row 0: the bottom output, rounded to bf16; also the output's first D.
    const float4* brow = reinterpret_cast<const float4*>(bottom + row * D);
    for (int c = lane; c < d4; c += 32) {
      const float4 b = brow[c];
      const uint2 p = bf16x4(b.x, b.y, b.z, b.w);
      *reinterpret_cast<uint2*>(z + 4 * c) = p;
      orow[4 * c] = __ushort_as_bfloat16((unsigned short)(p.x & 0xffffu));
      orow[4 * c + 1] = __ushort_as_bfloat16((unsigned short)(p.x >> 16));
      orow[4 * c + 2] = __ushort_as_bfloat16((unsigned short)(p.y & 0xffffu));
      orow[4 * c + 3] = __ushort_as_bfloat16((unsigned short)(p.y >> 16));
    }

    // Z rows 1..F: bf16(bf16(table[id_f]) * bf16(w_f)), GROUP fields at a
    // time, every load of a group started before the first is used. The
    // shuffles run on the whole warp (c0 and f are warp-uniform).
    for (int f0 = 0; f0 < F; f0 += GROUP) {
      for (int c0 = 0; c0 < d4; c0 += 32) {
        const int c = c0 + lane;
        const bool active = c < d4;
        float4 v[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          const int f = f0 + j;
          const int r = __shfl_sync(FULL, f < 32 ? id0 : id1, f & 31);
          if (f < F && active) v[j] = load4(table + (size_t)r * D + 4 * c);
        }
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          const int f = f0 + j;
          const float w = __shfl_sync(FULL, f < 32 ? w0 : w1, f & 31);
          if (f < F && active) {
            *reinterpret_cast<uint2*>(z + (size_t)(1 + f) * ld + 4 * c) =
                bf16x4(__fmul_rn(bf16_round(v[j].x), w), __fmul_rn(bf16_round(v[j].y), w),
                       __fmul_rn(bf16_round(v[j].z), w), __fmul_rn(bf16_round(v[j].w), w));
          }
        }
      }
    }
    __syncwarp();

    // Z Z^T, tile by tile, over the tiles that hold a pair i < j < nf.
    for (int mt = 0; mt < rows_pad / 16; ++mt) {
      for (int nt = 0; 8 * nt < nf; ++nt) {
        if (8 * nt + 7 <= 16 * mt) continue;  // every element on or below the diagonal
        const bf16* a_lo = z + (size_t)(16 * mt + g) * ld + 2 * t;
        const bf16* a_hi = a_lo + 8 * ld;
        const bf16* b = z + (size_t)(8 * nt + g) * ld + 2 * t;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < kp; k0 += 16) {
          mma_bf16(acc, lds32(a_lo + k0), lds32(a_hi + k0), lds32(a_lo + k0 + 8),
                   lds32(a_hi + k0 + 8), lds32(b + k0), lds32(b + k0 + 8));
        }
        const int i0 = 16 * mt + g, j0 = 8 * nt + 2 * t;
        emit(orow + D, i0, j0, nf, acc[0]);
        emit(orow + D, i0, j0 + 1, nf, acc[1]);
        emit(orow + D, i0 + 8, j0, nf, acc[2]);
        emit(orow + D, i0 + 8, j0 + 1, nf, acc[3]);
      }
    }
    __syncwarp();  // the next row's gather overwrites Z
  }
}

namespace {

template <typename T>
int launch(const T* table, const void* ids, const void* wts, int vocab, const void* bottom,
           void* out, int n, int F, int D, void* stream) {
  const size_t smem = smem_bytes(F + 1, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dlrm_interact_bf16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (int)(((long long)n + WARPS - 1) / WARPS);
  dlrm_interact_bf16_kernel<T><<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const bf16*>(wts), table, vocab,
      static_cast<const float*>(bottom), static_cast<bf16*>(out), n, F, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dts_dlrm_warps() { return WARPS; }

int dts_dlrm_max_features() { return MAX_FEATURES; }

// Z of every warp of a block: nf = F + 1 rows of width d.
size_t dts_dlrm_smem_bytes(int nf, int d) { return smem_bytes(nf, d); }

const char* dts_dlrm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int dts_dlrm_interact(const void* ids, const void* wts, const void* table, int table_bf16,
                      int vocab, const void* bottom, void* out, int n, int F, int D,
                      void* stream) {
  if (n <= 0) return 0;
  if (F < 1 || F + 1 > MAX_FEATURES || D < 4 || D % 4 != 0 || vocab < 1)
    return (int)cudaErrorInvalidValue;
  return table_bf16 ? launch(static_cast<const bf16*>(table), ids, wts, vocab, bottom, out, n,
                             F, D, stream)
                    : launch(static_cast<const float*>(table), ids, wts, vocab, bottom, out, n,
                             F, D, stream);
}

}  // extern "C"
