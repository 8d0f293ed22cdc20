// Native host-side hot path for the serving batcher: the fold/pack/pad
// batch assembly that sits between protobuf decode and the host-to-device
// copy. The numpy implementation of the same steps (ops/transfer.py +
// batcher padding) makes several full passes and temporaries per batch;
// these functions do each transform in one pass.
//
// Exposed via a C ABI for ctypes. All functions are thread-safe (pure
// element-wise transforms on caller-owned buffers).

#include <cstdint>
#include <cstring>

namespace {

// THE fold: mathematical mod (result in [0, vocab)), pow2 fast path.
// Shared by fold_i32 and the fused batch pack so the semantics cannot
// drift between them.
inline int64_t fold1(int64_t v, int64_t vocab, bool pow2, int64_t mask) {
  if (pow2) return v & mask;
  int64_t r = v % vocab;
  return r < 0 ? r + vocab : r;
}

inline void write_u24(uint8_t* dst, uint32_t v) {
  dst[0] = static_cast<uint8_t>(v);
  dst[1] = static_cast<uint8_t>(v >> 8);
  dst[2] = static_cast<uint8_t>(v >> 16);
}

// f32 bits -> bf16 bits, round-to-nearest-even with NaN quieting (the rule
// ops/transfer.py f32_to_bf16_bits follows in numpy).
inline uint16_t bf16_bits(uint32_t u) {
  if ((u & 0x7fffffffu) > 0x7f800000u) {   // NaN: keep quiet, drop payload
    return static_cast<uint16_t>((u >> 16) | 0x0040u);
  }
  uint32_t rounding = 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>((u + rounding) >> 16);
}

// CRC32C (Castagnoli, reflected polynomial 0x82F63B78), slicing by 8:
// table k advances a byte that sits k bytes ahead of the running CRC.
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k) {
      for (uint32_t i = 0; i < 256; ++i) {
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xffu];
      }
    }
  }
};

const CrcTables& crc_tables() {
  static const CrcTables tables;  // built once, thread-safe (C++11)
  return tables;
}

}  // namespace

extern "C" {

// CRC32C of n bytes, continuing from `crc` (0 to start): the TFRecord
// checksum of serving/warmup.py. ctypes releases the GIL for the call.
uint32_t dts_crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
  const auto& t = crc_tables().t;
  crc = ~crc;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  for (; n >= 8; n -= 8, p += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xffu] ^ t[6][(lo >> 8) & 0xffu] ^ t[5][(lo >> 16) & 0xffu] ^
          t[4][lo >> 24] ^ t[3][hi & 0xffu] ^ t[2][(hi >> 8) & 0xffu] ^
          t[1][(hi >> 16) & 0xffu] ^ t[0][hi >> 24];
  }
#endif
  for (; n > 0; --n, ++p) crc = t[0][(crc ^ *p) & 0xffu] ^ (crc >> 8);
  return ~crc;
}

// ids[i] -> int32(ids[i] mod vocab) — the uncompressed fold. Power-of-two
// vocabs (the common config) take the mask path: two's-complement AND equals
// the mathematical mod, and skips the 64-bit division.
void fold_i32(const int64_t* ids, int64_t n, int64_t vocab, int32_t* out) {
  const bool pow2 = (vocab & (vocab - 1)) == 0;
  const int64_t mask = vocab - 1;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = static_cast<int32_t>(fold1(ids[i], vocab, pow2, mask));
  }
}

// Fused batch assembly for the flagship combined layout
// ({feat_ids: u24, feat_wts: bf16}, key-sorted so the ids segment precedes
// the weights segment): reads each request's arrays ONCE and writes the
// final padded device buffer directly —
//   out = [bucket*F*3 bytes u24(fold(ids))][bucket*F*2 bytes bf16(wts)]
// replacing the python path's pad copy + fold pass + pack pass + concat
// (4 full passes and 3 temporaries per batch: serving/batcher.py padding
// + ops/transfer.py pack_host_combined). Per part p: ids_ptrs[p] is int64 (wide wire; folded
// here) or int32 when ids_is64[p]==0 (compact wire, pre-folded by the
// client and range-checked by the service; low 3 bytes taken either way,
// matching the numpy path's truncation semantics). wts_ptrs[p] is f32
// (cast here, RNE) or bf16 bits when wts_isf32[p]==0 (compact; copied).
// Rows [total..bucket) are zero in both segments. Thread-safe; ctypes
// releases the GIL for the whole call.
void pack_batch_u24_bf16(const void** ids_ptrs, const uint8_t* ids_is64,
                         const void** wts_ptrs, const uint8_t* wts_isf32,
                         const int64_t* ns, int64_t num_parts,
                         int64_t fields, int64_t bucket, int64_t vocab,
                         uint8_t* out) {
  uint8_t* ids_base = out;
  uint8_t* wts_base = out + bucket * fields * 3;
  const bool pow2 = (vocab & (vocab - 1)) == 0;
  const int64_t mask = vocab - 1;
  int64_t row = 0;
  for (int64_t p = 0; p < num_parts; ++p) {
    const int64_t n = ns[p] * fields;
    uint8_t* idst = ids_base + row * fields * 3;
    if (ids_is64[p]) {
      const int64_t* ids = static_cast<const int64_t*>(ids_ptrs[p]);
      for (int64_t i = 0; i < n; ++i) {
        write_u24(idst + 3 * i,
                  static_cast<uint32_t>(fold1(ids[i], vocab, pow2, mask)));
      }
    } else {
      // int32 (compact wire): pre-folded by contract (service-validated
      // range [0, vocab)), so the low 3 bytes ARE the value — plain
      // truncation, exactly what the python generic path does for an
      // all-int32 group. (For OUT-of-contract ids in a MIXED group the
      // python path widens to int64 and folds while this path truncates —
      // an intentional, documented divergence reachable only by direct
      // submit() callers violating the compact contract.)
      const int32_t* ids = static_cast<const int32_t*>(ids_ptrs[p]);
      for (int64_t i = 0; i < n; ++i) {
        write_u24(idst + 3 * i, static_cast<uint32_t>(ids[i]));
      }
    }
    // Byte-granular stores: the weights segment starts at bucket*fields*3,
    // which is ODD for odd bucket*fields — a uint16_t* store there would be
    // misaligned UB (unreachable with the shipped pow2 buckets, but the
    // layout must be correct for arbitrary configs). memcpy of 2 bytes
    // compiles to a single unaligned store on x86/arm.
    uint8_t* wdst = wts_base + row * fields * 2;
    if (wts_isf32[p]) {
      const uint32_t* bits =
          static_cast<const uint32_t*>(wts_ptrs[p]);
      for (int64_t i = 0; i < n; ++i) {
        uint16_t v = bf16_bits(bits[i]);
        std::memcpy(wdst + 2 * i, &v, 2);
      }
    } else {
      std::memcpy(wdst, wts_ptrs[p], static_cast<size_t>(n) * 2);
    }
    row += ns[p];
  }
  if (row < bucket) {
    std::memset(ids_base + row * fields * 3, 0,
                static_cast<size_t>(bucket - row) * fields * 3);
    std::memset(wts_base + row * fields * 2, 0,
                static_cast<size_t>(bucket - row) * fields * 2);
  }
}

}  // extern "C"
