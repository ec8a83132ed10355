// A decoder of Zstandard frames (RFC 8878) for the host, with a plain C
// interface, and the CRC-32C that guards OCDBT files.
//
// The JAX package's sharded checkpoints (orbax over tensorstore's OCDBT
// key-value store, zarr v2 arrays) compress every B-tree node and every
// array chunk with zstd.  This file decodes those frames with no library:
//
//   * frames: the header (window, dictionary id -- a non-zero one is
//     refused -- and content size), raw, RLE and compressed blocks, any
//     number of blocks, the XXH64 content checksum when the frame sets it,
//     skippable frames and several frames back to back;
//   * literals: raw, RLE, and Huffman-coded with one or four streams, with
//     the table described (directly or FSE-compressed) or reused from the
//     previous block (treeless);
//   * sequences: predefined, RLE, FSE-compressed and repeated tables for
//     literal lengths, offsets and match lengths, with the three repeat
//     offsets.
//
// The whole output of a frame lands in one caller-owned buffer, so matches
// reach back into it directly and no window is kept.  Every read of the
// input and every write of the output is bounds-checked: corrupt input
// returns a negative error code and never touches memory outside the two
// buffers.  Each call keeps its state to itself (the only globals are
// constant tables), so callers may run calls on many threads at once
// (ctypes releases the GIL).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

enum Error : int {
  kOk = 0,
  kSrcTruncated = -1,       // the input ends inside a frame
  kBadMagic = -2,           // neither a zstd nor a skippable frame
  kReservedBit = -3,        // a reserved header bit or block type is set
  kDictionary = -4,         // the frame needs a dictionary
  kDstTooSmall = -5,        // the output does not fit the buffer
  kCorrupt = -6,            // an entropy table or stream is malformed
  kBadOffset = -7,          // a match reaches before the output's start
  kChecksum = -8,           // the XXH64 content checksum does not match
  kSizeMismatch = -9,       // the frame's stated content size is not met
  kNoTable = -10,           // a table is repeated before any was set
  kBlockTooLarge = -11,     // a block decodes to more than 128 KiB
};

constexpr size_t kMaxBlock = 128 * 1024;
constexpr uint32_t kZstdMagic = 0xFD2FB528u;

inline uint32_t ReadLE16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t ReadLE24(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (uint32_t(p[2]) << 16);
}
inline uint32_t ReadLE32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t ReadLE64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline int HighBit(uint32_t v) {  // v > 0
  return 31 - __builtin_clz(v);
}

// ---------------------------------------------------------------------------
// XXH64 (the frame content checksum keeps its low 32 bits)
// ---------------------------------------------------------------------------

constexpr uint64_t kP1 = 11400714785074694791ull;
constexpr uint64_t kP2 = 14029467366897019727ull;
constexpr uint64_t kP3 = 1609587929392839161ull;
constexpr uint64_t kP4 = 9650029242287828579ull;
constexpr uint64_t kP5 = 2870177450012600261ull;

inline uint64_t Rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t XxRound(uint64_t acc, uint64_t v) {
  return Rotl(acc + v * kP2, 31) * kP1;
}
inline uint64_t XxMerge(uint64_t acc, uint64_t v) {
  return (acc ^ XxRound(0, v)) * kP1 + kP4;
}

uint64_t Xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
    const uint8_t* limit = end - 32;
    do {
      v1 = XxRound(v1, ReadLE64(p));
      v2 = XxRound(v2, ReadLE64(p + 8));
      v3 = XxRound(v3, ReadLE64(p + 16));
      v4 = XxRound(v4, ReadLE64(p + 24));
      p += 32;
    } while (p <= limit);
    h = Rotl(v1, 1) + Rotl(v2, 7) + Rotl(v3, 12) + Rotl(v4, 18);
    h = XxMerge(h, v1);
    h = XxMerge(h, v2);
    h = XxMerge(h, v3);
    h = XxMerge(h, v4);
  } else {
    h = kP5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= XxRound(0, ReadLE64(p));
    h = Rotl(h, 27) * kP1 + kP4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(ReadLE32(p)) * kP1;
    h = Rotl(h, 23) * kP2 + kP3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * kP5;
    h = Rotl(h, 11) * kP1;
  }
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Bit readers
// ---------------------------------------------------------------------------

// Little-endian bits read forward (the FSE table descriptions).  Bits past
// the end read as zero; the caller checks `Overran` once it is done.
struct ForwardBits {
  const uint8_t* p;
  size_t size;
  size_t pos = 0;  // in bits
  ForwardBits(const uint8_t* p_, size_t n) : p(p_), size(n) {}
  uint32_t Read(int n) {  // n <= 16
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++pos) {
      size_t byte = pos >> 3;
      if (byte < size) v |= uint32_t((p[byte] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
  void Rewind(int n) { pos -= n; }
  size_t BytesUsed() const { return (pos + 7) >> 3; }
  bool Overran() const { return BytesUsed() > size; }
};

// Bits read backward from the end of a stream whose last byte holds the
// padding marker (its highest set bit).  A read takes the highest unread
// bits, the first one read being the most significant; bits before the
// start read as zero and drive `left` negative, which is how the FSE
// weight decoder and the end checks see that the stream is spent.
struct BackwardBits {
  const uint8_t* p = nullptr;
  size_t size = 0;
  int64_t left = 0;  // bits not yet read; negative once overread

  int Init(const uint8_t* p_, size_t n) {
    p = p_;
    size = n;
    if (n == 0) return kCorrupt;
    uint8_t last = p[n - 1];
    if (last == 0) return kCorrupt;
    left = int64_t(n - 1) * 8 + HighBit(last);
    return kOk;
  }
  // The `n` (<= 32) bits below position `left`, without consuming them.
  uint64_t Peek(int n) const {
    if (n == 0) return 0;
    int64_t lo = left - n;
    if (lo >= 0) {
      size_t byte = size_t(lo) >> 3;
      int shift = int(lo & 7);
      uint64_t word;
      if (byte + 8 <= size) {
        word = ReadLE64(p + byte);
      } else {
        word = 0;
        for (size_t i = 0; byte + i < size && i < 8; ++i)
          word |= uint64_t(p[byte + i]) << (8 * i);
      }
      return (word >> shift) & ((uint64_t(1) << n) - 1);
    }
    // Fewer than n bits remain: the remaining ones, then zeros.
    if (left <= 0) return 0;
    int have = int(left);
    uint64_t word = 0;
    for (size_t i = 0; i < size && i < 8; ++i)
      word |= uint64_t(p[i]) << (8 * i);
    return (word & ((uint64_t(1) << have) - 1)) << (n - have);
  }
  uint64_t Read(int n) {
    uint64_t v = Peek(n);
    left -= n;
    return v;
  }
  void Skip(int n) { left -= n; }
};

// ---------------------------------------------------------------------------
// FSE tables
// ---------------------------------------------------------------------------

constexpr int kMaxFseLog = 9;

struct FseTable {
  int log = 0;  // accuracy log; 0 for an RLE table
  uint8_t symbol[1 << kMaxFseLog];
  uint8_t bits[1 << kMaxFseLog];
  uint16_t base[1 << kMaxFseLog];
};

int BuildFse(FseTable* t, const int16_t* norm, int num_symbols, int log) {
  const uint32_t size = 1u << log;
  uint16_t next[256];
  uint32_t high = size;
  for (int s = 0; s < num_symbols; ++s) {
    if (norm[s] == -1) {
      t->symbol[--high] = uint8_t(s);
      next[s] = 1;
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3;
  const uint32_t mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < num_symbols; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t->symbol[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) return kCorrupt;
  for (uint32_t i = 0; i < size; ++i) {
    uint16_t state = next[t->symbol[i]]++;
    int nb = log - HighBit(state);
    t->bits[i] = uint8_t(nb);
    t->base[i] = uint16_t((state << nb) - size);
  }
  t->log = log;
  return kOk;
}

void BuildRle(FseTable* t, uint8_t symbol) {
  t->log = 0;
  t->symbol[0] = symbol;
  t->bits[0] = 0;
  t->base[0] = 0;
}

// Read an FSE table description at `src`; `*used` gets its size in bytes.
int ReadFseTable(FseTable* t, const uint8_t* src, size_t n, int max_log,
                 int max_symbol, size_t* used) {
  ForwardBits in(src, n);
  if (n == 0) return kSrcTruncated;
  int log = int(in.Read(4)) + 5;
  if (log > max_log) return kCorrupt;
  int32_t remaining = 1 << log;
  int16_t norm[256];
  int symbol = 0;
  while (remaining > 0 && symbol <= max_symbol) {
    int nbits = HighBit(uint32_t(remaining + 1)) + 1;
    uint32_t val = in.Read(nbits);
    const uint32_t lower_mask = (1u << (nbits - 1)) - 1;
    const uint32_t threshold = (1u << nbits) - 1 - uint32_t(remaining + 1);
    if ((val & lower_mask) < threshold) {
      in.Rewind(1);
      val &= lower_mask;
    } else if (val > lower_mask) {
      val -= threshold;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[symbol++] = int16_t(proba);
    if (proba == 0) {
      for (;;) {
        uint32_t repeat = in.Read(2);
        for (uint32_t i = 0; i < repeat; ++i) {
          if (symbol > max_symbol) return kCorrupt;
          norm[symbol++] = 0;
        }
        if (repeat != 3) break;
      }
    }
  }
  if (remaining != 0 || in.Overran()) return kCorrupt;
  *used = in.BytesUsed();
  return BuildFse(t, norm, symbol, log);
}

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------

constexpr int kMaxHuffBits = 11;

struct HuffTable {
  int max_bits = 0;  // 0: no table yet
  uint8_t symbol[1 << kMaxHuffBits];
  uint8_t bits[1 << kMaxHuffBits];
};

// The Huffman tree description: weights, either FSE-compressed or four
// bits each, the last weight implied.
int ReadHuffTable(HuffTable* t, const uint8_t* src, size_t n, size_t* used) {
  if (n < 1) return kSrcTruncated;
  uint8_t weights[256];
  int num = 0;
  const uint8_t header = src[0];
  if (header < 128) {
    const size_t csize = header;
    if (csize == 0 || 1 + csize > n) return kCorrupt;
    FseTable* fse = new FseTable;  // ~1.3 KB; kept off the stack
    size_t table_size = 0;
    int err = ReadFseTable(fse, src + 1, csize, 6, 255, &table_size);
    if (err == kOk && table_size >= csize) err = kCorrupt;
    BackwardBits in;
    if (err == kOk) err = in.Init(src + 1 + table_size, csize - table_size);
    if (err == kOk) {
      uint32_t s1 = uint32_t(in.Read(fse->log));
      uint32_t s2 = uint32_t(in.Read(fse->log));
      for (;;) {
        if (num >= 255) { err = kCorrupt; break; }
        weights[num++] = fse->symbol[s1];
        s1 = fse->base[s1] + uint32_t(in.Read(fse->bits[s1]));
        if (in.left < 0) {
          if (num >= 255) { err = kCorrupt; break; }
          weights[num++] = fse->symbol[s2];
          break;
        }
        if (num >= 255) { err = kCorrupt; break; }
        weights[num++] = fse->symbol[s2];
        s2 = fse->base[s2] + uint32_t(in.Read(fse->bits[s2]));
        if (in.left < 0) {
          if (num >= 255) { err = kCorrupt; break; }
          weights[num++] = fse->symbol[s1];
          break;
        }
      }
    }
    delete fse;
    if (err != kOk) return err;
    *used = 1 + csize;
  } else {
    num = header - 127;
    const size_t bytes = (size_t(num) + 1) / 2;
    if (1 + bytes > n) return kSrcTruncated;
    for (int i = 0; i < num; i += 2) {
      uint8_t b = src[1 + i / 2];
      weights[i] = b >> 4;
      if (i + 1 < num) weights[i + 1] = b & 15;
    }
    *used = 1 + bytes;
  }
  // The implied last weight completes the sum to a power of two.
  uint32_t total = 0;
  for (int i = 0; i < num; ++i) {
    if (weights[i] > kMaxHuffBits) return kCorrupt;
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) return kCorrupt;
  const int max_bits = HighBit(total) + 1;
  if (max_bits > kMaxHuffBits) return kCorrupt;
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) return kCorrupt;  // not a power of two
  if (num >= 256) return kCorrupt;
  weights[num++] = uint8_t(HighBit(rest) + 1);

  uint8_t nbits[256];
  uint32_t rank_count[kMaxHuffBits + 2] = {0};
  for (int s = 0; s < num; ++s) {
    nbits[s] = weights[s] ? uint8_t(max_bits + 1 - weights[s]) : 0;
    rank_count[nbits[s]]++;
  }
  uint32_t rank_start[kMaxHuffBits + 2];
  rank_start[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    rank_start[b - 1] = rank_start[b] + rank_count[b] * (1u << (max_bits - b));
    if (rank_start[b - 1] > (1u << max_bits)) return kCorrupt;
  }
  if (rank_start[0] != (1u << max_bits)) return kCorrupt;
  for (int s = 0; s < num; ++s) {
    if (!nbits[s]) continue;
    const uint32_t len = 1u << (max_bits - nbits[s]);
    const uint32_t at = rank_start[nbits[s]];
    std::memset(t->symbol + at, s, len);
    std::memset(t->bits + at, nbits[s], len);
    rank_start[nbits[s]] += len;
  }
  t->max_bits = max_bits;
  return kOk;
}

// One Huffman-coded literal.  The fast form needs the table's width of
// bits below `left` and 8 readable bytes from the lowest of them: true in
// a stream's middle, not in its first 8 bytes (read first) nor its last.
inline bool HuffFast(const BackwardBits& in, int mb) {
  return in.left >= mb && (size_t(in.left) >> 3) + 8 <= in.size;
}
inline uint8_t HuffDecodeFast(BackwardBits& in, const HuffTable& t,
                              int mb) {
  const uint64_t lo = uint64_t(in.left - mb);
  const uint32_t idx = uint32_t((ReadLE64(in.p + (lo >> 3)) >> (lo & 7)) &
                                ((1u << mb) - 1));
  in.left -= t.bits[idx];
  return t.symbol[idx];
}
inline uint8_t HuffDecode(BackwardBits& in, const HuffTable& t, int mb) {
  if (HuffFast(in, mb)) return HuffDecodeFast(in, t, mb);
  const uint32_t idx = uint32_t(in.Peek(mb));
  in.Skip(t.bits[idx]);
  return t.symbol[idx];
}

// Decodes `streams` (1 or 4) Huffman streams, stream k's `count[k]`
// literals to out[k]; the four streams of a block run in lockstep through
// their middles, so their dependent bit reads overlap.  Every stream must
// end with its bits spent exactly.
int DecodeHuffStreams(const HuffTable& t, int streams,
                      const uint8_t* const* src, const size_t* n,
                      uint8_t* const* out, const size_t* count) {
  BackwardBits in[4];
  size_t done[4] = {0, 0, 0, 0};
  const int mb = t.max_bits;
  for (int k = 0; k < streams; ++k) {
    int err = in[k].Init(src[k], n[k]);
    if (err != kOk) return err;
    while (done[k] < count[k] && !HuffFast(in[k], mb))
      out[k][done[k]++] = HuffDecode(in[k], t, mb);
  }
  if (streams == 4) {
    while (done[0] < count[0] && done[1] < count[1] && done[2] < count[2] &&
           done[3] < count[3] && HuffFast(in[0], mb) && HuffFast(in[1], mb) &&
           HuffFast(in[2], mb) && HuffFast(in[3], mb)) {
      out[0][done[0]++] = HuffDecodeFast(in[0], t, mb);
      out[1][done[1]++] = HuffDecodeFast(in[1], t, mb);
      out[2][done[2]++] = HuffDecodeFast(in[2], t, mb);
      out[3][done[3]++] = HuffDecodeFast(in[3], t, mb);
    }
  }
  for (int k = 0; k < streams; ++k) {
    while (done[k] < count[k]) out[k][done[k]++] = HuffDecode(in[k], t, mb);
    if (in[k].left != 0) return kCorrupt;
  }
  return kOk;
}

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------

const int16_t kLlDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMlDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1,  1,  1,  1,  1,  1,  1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOfDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLlBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLlBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMlBase[53] = {
    3,  4,  5,  6,  7,  8,  9,   10,  11,  12,   13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23,  24,  25,  26,   27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39,  41,  43,  47,   51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMlBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

enum { kLl = 0, kOf = 1, kMl = 2 };
const int kMaxLog[3] = {9, 8, 9};
const int kMaxSymbol[3] = {35, 31, 52};

struct Predefined {
  FseTable table[3];
  Predefined() {
    BuildFse(&table[kLl], kLlDefault, 36, 6);
    BuildFse(&table[kOf], kOfDefault, 29, 5);
    BuildFse(&table[kMl], kMlDefault, 53, 6);
  }
};

const Predefined kPredefined;

// A frame's tables and repeat offsets, and the block's literals; one a
// call, reused across the frames it decodes.
struct FrameState {
  HuffTable huff;
  FseTable fse[3];
  bool fse_set[3] = {false, false, false};
  uint32_t rep[3] = {1, 4, 8};
  uint8_t literals[kMaxBlock];
};

int ReadTableMode(FrameState* fs, int which, int mode, const uint8_t* src,
                  size_t n, size_t* used) {
  *used = 0;
  switch (mode) {
    case 0: {  // predefined
      fs->fse[which] = kPredefined.table[which];
      break;
    }
    case 1: {  // RLE
      if (n < 1) return kSrcTruncated;
      if (src[0] > kMaxSymbol[which]) return kCorrupt;
      BuildRle(&fs->fse[which], src[0]);
      *used = 1;
      break;
    }
    case 2: {  // FSE-compressed
      int err = ReadFseTable(&fs->fse[which], src, n, kMaxLog[which],
                             kMaxSymbol[which], used);
      if (err != kOk) return err;
      break;
    }
    default:  // repeat
      if (!fs->fse_set[which]) return kNoTable;
      return kOk;
  }
  fs->fse_set[which] = true;
  return kOk;
}

// ---------------------------------------------------------------------------
// Blocks and frames
// ---------------------------------------------------------------------------

struct Output {
  uint8_t* base;  // the frame's first byte
  size_t cap;     // bytes available from base
  size_t pos;     // bytes written from base
};

int DecodeCompressedBlock(FrameState* fs, const uint8_t* src, size_t n,
                          Output* out, uint8_t* lit_buf) {
  const size_t block_start = out->pos;
  // --- literals section ---
  if (n < 1) return kSrcTruncated;
  const int lit_type = src[0] & 3;
  const int size_format = (src[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hsize = 0;
  int streams = 1;
  if (lit_type <= 1) {
    if (size_format == 0 || size_format == 2) {
      hsize = 1;
      regen = src[0] >> 3;
    } else if (size_format == 1) {
      hsize = 2;
      if (n < 2) return kSrcTruncated;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      hsize = 3;
      if (n < 3) return kSrcTruncated;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
  } else {
    if (size_format == 0 || size_format == 1) {
      hsize = 3;
      if (n < 3) return kSrcTruncated;
      uint32_t v = ReadLE24(src);
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
      streams = size_format == 0 ? 1 : 4;
    } else if (size_format == 2) {
      hsize = 4;
      if (n < 4) return kSrcTruncated;
      uint32_t v = ReadLE32(src);
      regen = (v >> 4) & 0x3FFF;
      csize = v >> 18;
      streams = 4;
    } else {
      hsize = 5;
      if (n < 5) return kSrcTruncated;
      uint64_t v = ReadLE32(src) | (uint64_t(src[4]) << 32);
      regen = (v >> 4) & 0x3FFFF;
      csize = (v >> 22) & 0x3FFFF;
      streams = 4;
    }
  }
  if (regen > kMaxBlock) return kCorrupt;
  const uint8_t* literals;
  size_t pos = hsize;
  if (lit_type == 0) {  // raw
    if (pos + regen > n) return kSrcTruncated;
    literals = src + pos;
    pos += regen;
  } else if (lit_type == 1) {  // RLE
    if (pos + 1 > n) return kSrcTruncated;
    std::memset(lit_buf, src[pos], regen);
    literals = lit_buf;
    pos += 1;
  } else {  // Huffman, with a new (2) or the previous (3) table
    if (pos + csize > n) return kSrcTruncated;
    const uint8_t* h = src + pos;
    size_t hn = csize;
    if (lit_type == 2) {
      size_t used = 0;
      int err = ReadHuffTable(&fs->huff, h, hn, &used);
      if (err != kOk) return err;
      h += used;
      hn -= used;
    } else if (fs->huff.max_bits == 0) {
      return kNoTable;
    }
    const uint8_t* srcs[4] = {h, nullptr, nullptr, nullptr};
    size_t sizes[4] = {hn, 0, 0, 0};
    uint8_t* outs[4] = {lit_buf, nullptr, nullptr, nullptr};
    size_t counts[4] = {regen, 0, 0, 0};
    if (streams == 4) {  // a jump table of three sizes, then the streams
      if (hn < 6) return kCorrupt;
      sizes[0] = ReadLE16(h);
      sizes[1] = ReadLE16(h + 2);
      sizes[2] = ReadLE16(h + 4);
      if (6 + sizes[0] + sizes[1] + sizes[2] > hn) return kCorrupt;
      sizes[3] = hn - 6 - sizes[0] - sizes[1] - sizes[2];
      const size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) return kCorrupt;
      srcs[0] = h + 6;
      for (int k = 0; k < 4; ++k) {
        if (k > 0) srcs[k] = srcs[k - 1] + sizes[k - 1];
        counts[k] = k < 3 ? seg : regen - 3 * seg;
        outs[k] = lit_buf + k * seg;
      }
    }
    int err = DecodeHuffStreams(fs->huff, streams, srcs, sizes, outs, counts);
    if (err != kOk) return err;
    literals = lit_buf;
    pos += csize;
  }

  // --- sequences section ---
  if (pos >= n) return kSrcTruncated;
  size_t nseq = src[pos];
  if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    if (pos + 2 > n) return kSrcTruncated;
    nseq = ((nseq - 128) << 8) + src[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) return kSrcTruncated;
    nseq = src[pos + 1] + (size_t(src[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  size_t lit_left = regen;
  const uint8_t* lit = literals;
  if (nseq == 0 && pos != n) return kCorrupt;
  if (nseq > 0) {
    if (pos >= n) return kSrcTruncated;
    const uint8_t modes = src[pos++];
    if (modes & 3) return kReservedBit;
    const int mode[3] = {modes >> 6, (modes >> 4) & 3, (modes >> 2) & 3};
    for (int which = 0; which < 3; ++which) {
      size_t used = 0;
      int err = ReadTableMode(fs, which, mode[which], src + pos, n - pos, &used);
      if (err != kOk) return err;
      pos += used;
    }
    BackwardBits in;
    int err = in.Init(src + pos, n - pos);
    if (err != kOk) return err;
    const FseTable& tl = fs->fse[kLl];
    const FseTable& to = fs->fse[kOf];
    const FseTable& tm = fs->fse[kMl];
    uint32_t sl = uint32_t(in.Read(tl.log));
    uint32_t so = uint32_t(in.Read(to.log));
    uint32_t sm = uint32_t(in.Read(tm.log));
    uint32_t* rep = fs->rep;
    for (size_t i = 0; i < nseq; ++i) {
      const uint8_t lc = tl.symbol[sl], oc = to.symbol[so], mc = tm.symbol[sm];
      if (lc > 35 || mc > 52 || oc > 31) return kCorrupt;
      const uint32_t of_value =
          (1u << oc) + uint32_t(in.Read(oc));  // oc <= 31
      const size_t ml = kMlBase[mc] + size_t(in.Read(kMlBits[mc]));
      const size_t ll = kLlBase[lc] + size_t(in.Read(kLlBits[lc]));
      size_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      } else {
        const uint32_t idx = of_value - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? size_t(rep[0]) - 1 : rep[idx];
          if (offset == 0) return kCorrupt;
          if (idx > 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        }
      }
      if (i + 1 < nseq) {  // state updates: literal lengths, match, offset
        sl = tl.base[sl] + uint32_t(in.Read(tl.bits[sl]));
        sm = tm.base[sm] + uint32_t(in.Read(tm.bits[sm]));
        so = to.base[so] + uint32_t(in.Read(to.bits[so]));
      }
      if (in.left < 0) return kCorrupt;
      // execute: the literals, then the match
      if (ll > lit_left) return kCorrupt;
      if (ll + ml > out->cap - out->pos) return kDstTooSmall;
      std::memcpy(out->base + out->pos, lit, ll);
      out->pos += ll;
      lit += ll;
      lit_left -= ll;
      if (offset > out->pos) return kBadOffset;
      uint8_t* d = out->base + out->pos;
      const uint8_t* m = d - offset;
      if (offset >= ml) {
        std::memcpy(d, m, ml);
      } else {
        for (size_t k = 0; k < ml; ++k) d[k] = m[k];
      }
      out->pos += ml;
    }
    if (in.left != 0) return kCorrupt;
  }
  if (lit_left > out->cap - out->pos) return kDstTooSmall;
  std::memcpy(out->base + out->pos, lit, lit_left);
  out->pos += lit_left;
  if (out->pos - block_start > kMaxBlock) return kBlockTooLarge;
  return kOk;
}

struct FrameHeader {
  bool has_size = false;
  uint64_t content_size = 0;
  bool checksum = false;
  size_t header_size = 0;  // from the magic number to the first block
};

// Parses the header of a zstd frame at `src` (the magic included).
int ParseHeader(const uint8_t* src, size_t n, FrameHeader* h) {
  if (n < 5) return kSrcTruncated;
  if (ReadLE32(src) != kZstdMagic) return kBadMagic;
  const uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6;
  const bool single = (fhd >> 5) & 1;
  if (fhd & 0x08) return kReservedBit;
  h->checksum = (fhd >> 2) & 1;
  const int did_flag = fhd & 3;
  size_t pos = 5;
  if (!single) pos += 1;  // the window descriptor: no window is kept
  const size_t did_size[4] = {0, 1, 2, 4};
  if (pos + did_size[did_flag] > n) return kSrcTruncated;
  uint32_t did = 0;
  for (size_t i = 0; i < did_size[did_flag]; ++i)
    did |= uint32_t(src[pos + i]) << (8 * i);
  if (did != 0) return kDictionary;
  pos += did_size[did_flag];
  const size_t fcs_size[4] = {size_t(single ? 1 : 0), 2, 4, 8};
  const size_t fs = fcs_size[fcs_flag];
  if (pos + fs > n) return kSrcTruncated;
  if (fs > 0) {
    uint64_t v = 0;
    for (size_t i = 0; i < fs; ++i) v |= uint64_t(src[pos + i]) << (8 * i);
    if (fs == 2) v += 256;
    h->has_size = true;
    h->content_size = v;
  }
  h->header_size = pos + fs;
  return kOk;
}

inline bool IsSkippable(uint32_t magic) {
  return (magic & 0xFFFFFFF0u) == 0x184D2A50u;
}

// Decodes one frame (or skips one skippable frame) at `src`; `*consumed`
// gets the frame's input size.
int DecodeFrame(const uint8_t* src, size_t n, Output* out, size_t* consumed,
                FrameState* fs, uint8_t* lit_buf) {
  if (n < 4) return kSrcTruncated;
  const uint32_t magic = ReadLE32(src);
  if (IsSkippable(magic)) {
    if (n < 8) return kSrcTruncated;
    const uint64_t size = ReadLE32(src + 4);
    if (size > n - 8) return kSrcTruncated;
    *consumed = 8 + size_t(size);
    return kOk;
  }
  FrameHeader h;
  int err = ParseHeader(src, n, &h);
  if (err != kOk) return err;
  fs->huff.max_bits = 0;
  fs->fse_set[0] = fs->fse_set[1] = fs->fse_set[2] = false;
  fs->rep[0] = 1;
  fs->rep[1] = 4;
  fs->rep[2] = 8;
  // The frame writes from out->pos on; matches reach only into its bytes.
  Output frame{out->base + out->pos, out->cap - out->pos, 0};
  if (h.has_size && h.content_size > frame.cap) return kDstTooSmall;
  size_t pos = h.header_size;
  for (;;) {
    if (pos + 3 > n) return kSrcTruncated;
    const uint32_t bh = ReadLE24(src + pos);
    pos += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) return kReservedBit;
    if (size > kMaxBlock) return kBlockTooLarge;
    if (type == 1) {  // RLE: one byte, `size` times
      if (pos + 1 > n) return kSrcTruncated;
      if (size > frame.cap - frame.pos) return kDstTooSmall;
      std::memset(frame.base + frame.pos, src[pos], size);
      frame.pos += size;
      pos += 1;
    } else {
      if (pos + size > n) return kSrcTruncated;
      if (type == 0) {  // raw
        if (size > frame.cap - frame.pos) return kDstTooSmall;
        std::memcpy(frame.base + frame.pos, src + pos, size);
        frame.pos += size;
      } else {
        err = DecodeCompressedBlock(fs, src + pos, size, &frame, lit_buf);
        if (err != kOk) return err;
      }
      pos += size;
    }
    if (last) break;
  }
  if (h.checksum) {
    if (pos + 4 > n) return kSrcTruncated;
    const uint32_t want = ReadLE32(src + pos);
    if (uint32_t(Xxh64(frame.base, frame.pos)) != want) return kChecksum;
    pos += 4;
  }
  if (h.has_size && frame.pos != h.content_size) return kSizeMismatch;
  out->pos += frame.pos;
  *consumed = pos;
  return kOk;
}

int Decompress(FrameState* fs, const uint8_t* src, size_t n, uint8_t* dst,
               size_t cap, size_t* written) {
  Output out{dst, cap, 0};
  int err = n == 0 ? kSrcTruncated : kOk;
  size_t pos = 0;
  while (err == kOk && pos < n) {
    size_t consumed = 0;
    err = DecodeFrame(src + pos, n - pos, &out, &consumed, fs, fs->literals);
    pos += consumed;
  }
  *written = out.pos;
  return err;
}

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli), reflected, as OCDBT's file trailers hold it
// ---------------------------------------------------------------------------

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTable kCrcTable;

}  // namespace

extern "C" {

// Decodes the zstd frames of src[0, n) back to back into dst[0, cap);
// `*written` gets the bytes written.  0 on success, else a negative code.
int msa_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                        size_t cap, size_t* written) {
  FrameState* fs = new FrameState;
  const int err = Decompress(fs, src, n, dst, cap, written);
  delete fs;
  return err;
}

// Decodes `count` independent inputs, each into its own buffer; codes[i]
// gets input i's result.  Returns the first non-zero code, else 0.
int msa_zstd_decompress_batch(int count, const uint8_t* const* srcs,
                              const size_t* sizes, uint8_t* const* dsts,
                              const size_t* caps, size_t* written,
                              int* codes) {
  FrameState* fs = new FrameState;
  int first = kOk;
  for (int i = 0; i < count; ++i) {
    codes[i] = Decompress(fs, srcs[i], sizes[i], dsts[i], caps[i],
                          &written[i]);
    if (codes[i] != kOk && first == kOk) first = codes[i];
  }
  delete fs;
  return first;
}

// The content size the frame header at src[0, n) states: 0 and *size set
// when it states one, 1 when it does not, a negative code on a bad header.
int msa_zstd_content_size(const uint8_t* src, size_t n, uint64_t* size) {
  FrameHeader h;
  int err = ParseHeader(src, n, &h);
  if (err != kOk) return err;
  *size = h.content_size;
  return h.has_size ? 0 : 1;
}

uint32_t msa_crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  const auto& t = kCrcTable.t;
  while (n >= 8) {
    const uint32_t lo = ReadLE32(p) ^ c, hi = ReadLE32(p + 4);
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ t[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
