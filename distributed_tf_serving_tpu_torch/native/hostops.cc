// Native host-side hot path for the serving batcher: the fold/pack/pad
// batch assembly that sits between protobuf decode and the host-to-device
// copy. The numpy implementation of the same steps (ops/transfer.py +
// batcher padding) makes several full passes and temporaries per batch;
// these functions do each transform in one pass. Before them,
// dts_repeated_field reads a request tensor's repeated int64_val / float_val
// from its serialized bytes in place of protobuf's per-element container.
//
// Exposed via a C ABI for ctypes. All functions are thread-safe (pure
// element-wise transforms on caller-owned buffers).

#include <cstdint>
#include <cstring>

namespace {

// One multiply-xor round: full 128-bit product folded to 64 bits. The
// multiply diffuses every input bit across the word; the xor of hi/lo keeps
// both halves.
inline uint64_t mix64(uint64_t a, uint64_t b) {
  __uint128_t m = static_cast<__uint128_t>(a) * b;
  return static_cast<uint64_t>(m) ^ static_cast<uint64_t>(m >> 64);
}

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

// ----------------------------------------------------------------------
// blake2b (RFC 7693), keyless, 16-byte digest — the EXACT function
// hashlib.blake2b(digest_size=16) computes. Unlike hash128 (a fast
// non-cryptographic mix private to the device-input cache), these digests
// are a WIRE contract: the row-cache keys, the dedup row identity, and
// the label-join keys clients compute over the bytes they sent must all
// be byte-identical with or without the compiled host ops — so the native
// batched path must be the real blake2b, not a lookalike.

constexpr uint64_t kB2bIV[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull,
    0xa54ff53a5f1d36f1ull, 0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};

constexpr uint8_t kB2bSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

inline void b2b_g(uint64_t* v, int a, int b, int c, int d, uint64_t x,
                  uint64_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr64(v[d] ^ v[a], 32);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 24);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr64(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr64(v[b] ^ v[c], 63);
}

// One 128-byte block. `t` is the byte counter INCLUDING this block (the
// messages here are < 2^64 bytes, so the high counter word stays 0).
void b2b_compress(uint64_t h[8], const uint8_t block[128], uint64_t t,
                  bool last) {
  uint64_t m[16], v[16];
  for (int i = 0; i < 16; ++i) std::memcpy(&m[i], block + 8 * i, 8);
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = kB2bIV[i];
  }
  v[12] ^= t;
  if (last) v[14] = ~v[14];
  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = kB2bSigma[r];
    b2b_g(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
    b2b_g(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
    b2b_g(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
    b2b_g(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
    b2b_g(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
    b2b_g(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
    b2b_g(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
    b2b_g(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// blake2b-128 of the two-segment message header||body (the row digest's
// shape: a per-batch structure header prefixed to every row's bytes,
// without materializing the concatenation).
void blake2b16_2seg(const uint8_t* s1, int64_t n1, const uint8_t* s2,
                    int64_t n2, uint8_t* out16) {
  uint64_t h[8];
  for (int i = 0; i < 8; ++i) h[i] = kB2bIV[i];
  h[0] ^= 0x01010000ull ^ 16ull;  // digest_length=16, key=0, fanout=depth=1
  uint8_t block[128];
  const int64_t total = n1 + n2;
  if (total == 0) {
    std::memset(block, 0, 128);
    b2b_compress(h, block, 0, true);
  } else {
    int64_t off = 0;
    uint64_t t = 0;
    while (off < total) {
      const int64_t take = (total - off < 128) ? (total - off) : 128;
      int64_t filled = 0;
      while (filled < take) {
        const int64_t pos = off + filled;
        if (pos < n1) {
          const int64_t c =
              (n1 - pos < take - filled) ? (n1 - pos) : (take - filled);
          std::memcpy(block + filled, s1 + pos, static_cast<size_t>(c));
          filled += c;
        } else {
          const int64_t c = take - filled;
          std::memcpy(block + filled, s2 + (pos - n1),
                      static_cast<size_t>(c));
          filled += c;
        }
      }
      if (take < 128) {
        std::memset(block + take, 0, static_cast<size_t>(128 - take));
      }
      off += take;
      t += static_cast<uint64_t>(take);
      b2b_compress(h, block, t, off >= total);
    }
  }
  std::memcpy(out16, h, 16);  // little-endian h[0..1] = the first 16 bytes
}

// One base-128 varint at p (at most 10 bytes, none past end): the low 64
// bits of its value, as protobuf parsers take them; nullptr when it runs
// past end or past 10 bytes.
inline const uint8_t* read_varint(const uint8_t* p, const uint8_t* end, uint64_t* v) {
  uint64_t r = 0;
  for (int i = 0; i < 10 && p < end; ++i) {
    const uint64_t b = *p++;
    r |= (b & 0x7fu) << (7 * i);
    if (!(b & 0x80u)) {
      *v = r;
      return p;
    }
  }
  return nullptr;
}

// Value kinds of dts_repeated_field: how one element is read and written.
enum ScanKind : int32_t {
  kVarint64 = 0,  // int64_val / uint64_val: the varint's 64 bits
  kVarint32 = 1,  // int_val / uint32_val: its low 32 bits
  kFixed32 = 2,   // float_val: 4 bytes, a NaN made quiet as a double round trip makes it
  kFixed64 = 3,   // double_val: 8 bytes
};

// Varints from p to stop into out[*count..n), T their width; false when one
// is cut short or too long, or they overflow n.
template <typename T>
bool scan_varints(const uint8_t* p, const uint8_t* stop, T* out, int64_t* count, int64_t n) {
  int64_t i = *count;
  while (p < stop) {
    uint64_t v;
    if (i >= n || !(p = read_varint(p, stop, &v))) return false;
    out[i++] = static_cast<T>(v);
  }
  *count = i;
  return true;
}

// The bytes of `elems` fixed-width elements at p, into out[*count..); a
// float_val NaN gains its quiet bit, as float -> double -> float sets it.
void copy_fixed(const uint8_t* p, int64_t elems, int32_t kind, void* out, int64_t* count) {
  const int64_t width = kind == kFixed32 ? 4 : 8;
  uint8_t* dst = static_cast<uint8_t*>(out) + *count * width;
  std::memcpy(dst, p, static_cast<size_t>(elems * width));  // little-endian wire and host
  if (kind == kFixed32) {
    uint32_t* u = reinterpret_cast<uint32_t*>(dst);
    for (int64_t i = 0; i < elems; ++i) {
      if ((u[i] & 0x7fffffffu) > 0x7f800000u) u[i] |= 0x00400000u;
    }
  }
  *count += elems;
}

}  // namespace

extern "C" {

// The values of repeated numeric field `field` of a serialized protobuf
// message (a TensorProto: int64_val, float_val, ...), read straight from its
// bytes into out[0..n). Every top-level field is walked; other fields are
// skipped by their wire type; each occurrence of `field` is read, packed
// (wire type 2) or one value at a time (the kind's own wire type), in order.
// Returns the count written, or -1 when the bytes cannot be read: a varint
// cut short or over 10 bytes, a length past the end, a group or unknown wire
// type, a packed payload that is not whole elements, or a count other than
// n (out is never written past n). Thread-safe; ctypes releases the GIL for
// the call.
int64_t dts_repeated_field(const uint8_t* msg, int64_t len, int32_t field, int32_t kind,
                           void* out, int64_t n) {
  if (kind < kVarint64 || kind > kFixed64 || len < 0) return -1;
  const uint32_t own_wire = kind == kFixed32 ? 5 : kind == kFixed64 ? 1 : 0;
  const uint64_t want = static_cast<uint64_t>(static_cast<uint32_t>(field));
  const uint8_t* p = msg;
  const uint8_t* const end = msg + len;
  int64_t count = 0;
  while (p < end) {
    uint64_t tag;
    if (!(p = read_varint(p, end, &tag))) return -1;
    const uint32_t wire = static_cast<uint32_t>(tag & 7u);
    const uint64_t number = tag >> 3;
    if (number == 0) return -1;
    if (number == want && wire == 2) {
      uint64_t size;
      if (!(p = read_varint(p, end, &size))) return -1;
      if (size > static_cast<uint64_t>(end - p)) return -1;
      const uint8_t* const stop = p + size;
      bool ok = true;
      if (kind == kVarint64) {
        ok = scan_varints(p, stop, static_cast<uint64_t*>(out), &count, n);
      } else if (kind == kVarint32) {
        ok = scan_varints(p, stop, static_cast<uint32_t*>(out), &count, n);
      } else {
        const uint64_t width = kind == kFixed32 ? 4 : 8;
        const int64_t elems = static_cast<int64_t>(size / width);
        ok = size % width == 0 && elems <= n - count;
        if (ok) copy_fixed(p, elems, kind, out, &count);
      }
      if (!ok) return -1;
      p = stop;
    } else if (number == want && wire == own_wire) {
      // One value outside a packed run.
      if (count >= n) return -1;
      if (kind == kVarint64 || kind == kVarint32) {
        uint64_t v;
        if (!(p = read_varint(p, end, &v))) return -1;
        if (kind == kVarint64) static_cast<uint64_t*>(out)[count++] = v;
        else static_cast<uint32_t*>(out)[count++] = static_cast<uint32_t>(v);
      } else {
        const int64_t width = kind == kFixed32 ? 4 : 8;
        if (end - p < width) return -1;
        copy_fixed(p, 1, kind, out, &count);
        p += width;
      }
    } else if (number == want) {
      return -1;  // the field under a wire type its values cannot have
    } else {
      uint64_t skip = 0;
      switch (wire) {
        case 0:
          if (!(p = read_varint(p, end, &skip))) return -1;
          continue;
        case 1:
          skip = 8;
          break;
        case 2:
          if (!(p = read_varint(p, end, &skip))) return -1;
          break;
        case 5:
          skip = 4;
          break;
        default:
          return -1;  // 3 / 4 (groups), 6 / 7
      }
      if (skip > static_cast<uint64_t>(end - p)) return -1;
      p += skip;
    }
  }
  return count == n ? count : -1;
}

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


// 128-bit content digest (two independently-keyed 64-bit lanes, 32 bytes
// per iteration) for the batcher's device-input cache. Non-cryptographic
// but well-mixed: at the cache's scale (<=1e6 distinct batches) the
// 128-bit collision probability is ~1e-27. ctypes releases the GIL for
// the call, so hashing a batch never stalls the request handlers.
void hash128(const uint8_t* p, int64_t n, uint64_t* out) {
  const uint64_t K0 = 0x9E3779B185EBCA87ull, K1 = 0xC2B2AE3D27D4EB4Full,
                 K2 = 0x165667B19E3779F9ull, K3 = 0x27D4EB2F165667C5ull;
  uint64_t h0 = K0 ^ static_cast<uint64_t>(n);
  uint64_t h1 = K1 + static_cast<uint64_t>(n);
  int64_t i = 0;
  for (; i + 32 <= n; i += 32) {
    uint64_t a, b, c, d;
    std::memcpy(&a, p + i, 8);
    std::memcpy(&b, p + i + 8, 8);
    std::memcpy(&c, p + i + 16, 8);
    std::memcpy(&d, p + i + 24, 8);
    h0 = mix64(a ^ h0, K2 ^ b);
    h1 = mix64(c ^ h1, K3 ^ d);
  }
  if (i < n) {
    uint8_t tail[32] = {0};
    std::memcpy(tail, p + i, static_cast<size_t>(n - i));
    uint64_t a, b, c, d;
    std::memcpy(&a, tail, 8);
    std::memcpy(&b, tail + 8, 8);
    std::memcpy(&c, tail + 16, 8);
    std::memcpy(&d, tail + 24, 8);
    h0 = mix64(a ^ h0, K2 ^ b);
    h1 = mix64(c ^ h1, K3 ^ d);
  }
  out[0] = mix64(h0 ^ K1, h1 ^ K0);  // cross-mix: each output depends on
  out[1] = mix64(h1 ^ K3, h0 ^ K2);  // both lanes
}

// Batched per-row blake2b-128: N rows of a
// contiguous [n_rows, row_bytes] uint8 matrix -> N 16-byte digests, each
// blake2b(header || row, digest_size=16) — byte-identical to the
// hashlib.blake2b python fallback in cache/row_cache.py digest_rows and
// cache/digest.py row_label_keys (header empty there). ONE ctypes call
// releases the GIL for the whole batch, replacing the per-row python
// hash loop the row-cache plane otherwise pays on every armed batch.
void hash128_rows(const uint8_t* header, int64_t header_len,
                  const uint8_t* rows, int64_t n_rows, int64_t row_bytes,
                  uint8_t* out) {
  for (int64_t r = 0; r < n_rows; ++r) {
    blake2b16_2seg(header, header_len, rows + r * row_bytes, row_bytes,
                   out + r * 16);
  }
}

}  // extern "C"
