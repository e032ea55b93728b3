// Native tf.train.Example batch parser and crc32c: the hot half of record
// ingest.
//
// The port's copy of the JAX package's native/record_core.cc, built by
// tpu_pipelines_torch/ops/_build.py (g++) and bound with ctypes by
// tpu_pipelines_torch/data/native_record.py; the Python wire parser in
// tpu_pipelines_torch/data/record_io.py stays the semantics reference.
// Beside the reference's ABI it has rec_crc32c, the CRC-32C (Castagnoli)
// that frames every TFRecord (the reference takes it from the
// google_crc32c extension when installed).
//
// Contract: the caller pins the schema (feature names, kinds, per-row
// value counts) with the Python parser, then hands this engine that
// schema plus concatenated record payloads.  The engine parses STRICTLY:
// any deviation (unknown/missing feature, count mismatch, malformed wire
// data) fails the batch with a row index and the caller re-parses that
// chunk in Python, so the native path can never produce different data
// than the Python path, only faster identical data.
//
// Wire format parsed (field-number compatible with the public proto):
//   Example{ features=1 } Features{ feature=1 map } entry{ key=1, value=2 }
//   Feature{ bytes_list=1 / float_list=2 / int64_list=3 } each { value=1 }
//   float packed(len-delim of LE f32) or unpacked(wire 5);
//   int64 packed varints or unpacked(wire 0).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Slice {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t out = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      out |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return out;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  Slice delimited() {
    uint64_t n = varint();
    // Compare against the REMAINING size, never `p + n > end`: a crafted
    // length varint near 2^64 wraps that pointer sum below `end` and the
    // cursor would move backward — an infinite loop on malformed input.
    if (!ok || n > static_cast<uint64_t>(end - p)) {
      ok = false;
      return {end, end, false};
    }
    Slice s{p, p + n, true};
    p += n;
    return s;
  }

  void skip(uint32_t wire_type) {
    switch (wire_type) {
      case 0: varint(); break;
      case 1: p += 8; if (p > end) ok = false; break;
      case 2: delimited(); break;
      case 5: p += 4; if (p > end) ok = false; break;
      default: ok = false;
    }
  }
};

enum Kind { kBytes = 0, kFloat = 1, kInt64 = 2 };

struct FeatureSpec {
  std::string name;
  int kind;
  int64_t count;        // values per row (fixed; schema-pinned)
};

struct Parser {
  std::vector<FeatureSpec> spec;
  // Numeric outputs: caller-owned pointers, filled in place.
  std::vector<float*> f32_out;
  std::vector<int64_t*> i64_out;
  // Bytes outputs: engine-owned, copied out after the batch.
  std::vector<std::vector<uint8_t>> bytes_data;
  std::vector<std::vector<int64_t>> bytes_offsets;
  int64_t error_row = -1;
};

bool parse_float_list(Slice body, float* out, int64_t want) {
  int64_t got = 0;
  while (body.p < body.end && body.ok) {
    uint64_t key = body.varint();
    if (!body.ok) return false;
    uint32_t field = key >> 3, wt = key & 7;
    if (field != 1) { body.skip(wt); continue; }
    if (wt == 2) {                       // packed
      Slice packed = body.delimited();
      if (!body.ok || (packed.end - packed.p) % 4 != 0) return false;
      int64_t n = (packed.end - packed.p) / 4;
      if (got + n > want) return false;
      std::memcpy(out + got, packed.p, n * 4);  // LE host assumed (x86/ARM)
      got += n;
    } else if (wt == 5) {                // unpacked
      if (body.p + 4 > body.end || got >= want) return false;
      std::memcpy(out + got, body.p, 4);
      body.p += 4;
      ++got;
    } else {
      return false;
    }
  }
  return body.ok && got == want;
}

bool parse_int64_list(Slice body, int64_t* out, int64_t want) {
  int64_t got = 0;
  while (body.p < body.end && body.ok) {
    uint64_t key = body.varint();
    if (!body.ok) return false;
    uint32_t field = key >> 3, wt = key & 7;
    if (field != 1) { body.skip(wt); continue; }
    if (wt == 2) {                       // packed varints
      Slice packed = body.delimited();
      if (!body.ok) return false;
      while (packed.p < packed.end) {
        uint64_t v = packed.varint();
        if (!packed.ok || got >= want) return false;
        out[got++] = static_cast<int64_t>(v);
      }
    } else if (wt == 0) {
      uint64_t v = body.varint();
      if (!body.ok || got >= want) return false;
      out[got++] = static_cast<int64_t>(v);
    } else {
      return false;
    }
  }
  return body.ok && got == want;
}

bool parse_bytes_list(Slice body, std::vector<uint8_t>& data,
                      std::vector<int64_t>& offsets, int64_t want) {
  int64_t got = 0;
  while (body.p < body.end && body.ok) {
    uint64_t key = body.varint();
    if (!body.ok) return false;
    uint32_t field = key >> 3, wt = key & 7;
    if (field != 1 || wt != 2) { body.skip(wt); continue; }
    Slice v = body.delimited();
    if (!body.ok || got >= want) return false;
    data.insert(data.end(), v.p, v.end);
    offsets.push_back(static_cast<int64_t>(data.size()));
    ++got;
  }
  return body.ok && got == want;
}

// Parse one record into row slot `row`; strict against the schema.
bool parse_record(Parser& P, const uint8_t* rec, int64_t len, int64_t row) {
  // seen[i]: feature i filled for this row.
  std::vector<bool> seen(P.spec.size(), false);
  Slice top{rec, rec + len, true};
  while (top.p < top.end && top.ok) {
    uint64_t key = top.varint();
    if (!top.ok) return false;
    if ((key >> 3) != 1 || (key & 7) != 2) { top.skip(key & 7); continue; }
    Slice features = top.delimited();
    while (features.p < features.end && features.ok) {
      uint64_t fkey = features.varint();
      if (!features.ok) return false;
      if ((fkey >> 3) != 1 || (fkey & 7) != 2) {
        features.skip(fkey & 7);
        continue;
      }
      Slice entry = features.delimited();
      // Map entry: key=1 (name), value=2 (Feature).
      const uint8_t* name_p = nullptr;
      int64_t name_len = 0;
      Slice feat{nullptr, nullptr, true};
      bool have_feat = false;
      while (entry.p < entry.end && entry.ok) {
        uint64_t ekey = entry.varint();
        if (!entry.ok) return false;
        uint32_t efield = ekey >> 3, ewt = ekey & 7;
        if (efield == 1 && ewt == 2) {
          Slice n = entry.delimited();
          name_p = n.p;
          name_len = n.end - n.p;
        } else if (efield == 2 && ewt == 2) {
          feat = entry.delimited();
          have_feat = true;
        } else {
          entry.skip(ewt);
        }
      }
      if (!entry.ok || name_p == nullptr || !have_feat) return false;
      // Match against the schema (linear scan: feature counts are small).
      int idx = -1;
      for (size_t i = 0; i < P.spec.size(); ++i) {
        const auto& s = P.spec[i];
        if (static_cast<int64_t>(s.name.size()) == name_len &&
            std::memcmp(s.name.data(), name_p, name_len) == 0) {
          idx = static_cast<int>(i);
          break;
        }
      }
      if (idx < 0) return false;          // unknown feature -> python path
      if (seen[idx]) return false;        // duplicate entry
      seen[idx] = true;
      const auto& s = P.spec[idx];
      // Feature: oneof kind, field number == kind tag.
      bool filled = false;
      while (feat.p < feat.end && feat.ok) {
        uint64_t kkey = feat.varint();
        if (!feat.ok) return false;
        uint32_t kfield = kkey >> 3, kwt = kkey & 7;
        if (kwt != 2) { feat.skip(kwt); continue; }
        Slice body = feat.delimited();
        if (!feat.ok) return false;
        if (kfield == 1 && s.kind == kBytes) {
          filled = parse_bytes_list(body, P.bytes_data[idx],
                                    P.bytes_offsets[idx], s.count);
        } else if (kfield == 2 && s.kind == kFloat) {
          filled = parse_float_list(body, P.f32_out[idx] + row * s.count,
                                    s.count);
        } else if (kfield == 3 && s.kind == kInt64) {
          filled = parse_int64_list(body, P.i64_out[idx] + row * s.count,
                                    s.count);
        } else {
          return false;                   // kind mismatch vs pinned schema
        }
        if (!filled) return false;
      }
      if (!feat.ok || !filled) return false;
    }
    if (!features.ok) return false;
  }
  if (!top.ok) return false;
  for (bool s : seen) {
    if (!s) return false;                 // missing feature -> python path
  }
  return true;
}

// ---------------------------------------------------------------- crc32c

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), slicing by 8:
// eight 256-entry tables fold eight input bytes per step.  Portable C++
// (no SSE4.2 instruction, so the shared compiler flags need no CPU check).
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      for (int s = 1; s < 8; ++s) {
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
      }
    }
  }
};

const Crc32cTables kCrc;

uint32_t crc32c_update(uint32_t crc, const uint8_t* p, size_t n) {
  while (n && (reinterpret_cast<uintptr_t>(p) & 7)) {
    crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *p++) & 0xFF];
    --n;
  }
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);               // LE host assumed (x86/ARM)
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^
          kCrc.t[5][(lo >> 16) & 0xFF] ^ kCrc.t[4][lo >> 24] ^
          kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
          kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *p++) & 0xFF];
  return crc;
}

}  // namespace

extern "C" {

// Schema spec as flat arrays: names concatenated with offsets.
void* rec_parser_create(const char* names, const int64_t* name_offsets,
                        const int32_t* kinds, const int64_t* counts,
                        int64_t n_features) {
  auto* P = new Parser();
  P->spec.resize(n_features);
  P->f32_out.assign(n_features, nullptr);
  P->i64_out.assign(n_features, nullptr);
  P->bytes_data.resize(n_features);
  P->bytes_offsets.resize(n_features);
  for (int64_t i = 0; i < n_features; ++i) {
    P->spec[i].name.assign(names + name_offsets[i],
                           names + name_offsets[i + 1]);
    P->spec[i].kind = kinds[i];
    P->spec[i].count = counts[i];
  }
  return P;
}

void rec_parser_destroy(void* h) { delete static_cast<Parser*>(h); }

// Register caller-owned numeric output buffers sized [n_rows * count].
void rec_set_float_out(void* h, int64_t feature, float* out) {
  static_cast<Parser*>(h)->f32_out[feature] = out;
}
void rec_set_int64_out(void* h, int64_t feature, int64_t* out) {
  static_cast<Parser*>(h)->i64_out[feature] = out;
}

// Parse n records (concatenated payloads + offsets).  Returns 0 on success,
// -(row+1) of the first failing record otherwise (caller re-parses the
// chunk in Python).  Bytes outputs accumulate per feature in order.
int64_t rec_parse_batch(void* h, const uint8_t* data, const int64_t* offsets,
                        int64_t n_rows) {
  auto* P = static_cast<Parser*>(h);
  for (size_t i = 0; i < P->spec.size(); ++i) {
    P->bytes_data[i].clear();
    P->bytes_offsets[i].assign(1, 0);
    if (P->spec[i].kind == kBytes) {
      P->bytes_data[i].reserve((offsets[n_rows] - offsets[0]) / 4);
    }
  }
  for (int64_t r = 0; r < n_rows; ++r) {
    if (!parse_record(*P, data + offsets[r], offsets[r + 1] - offsets[r], r)) {
      P->error_row = r;
      return -(r + 1);
    }
  }
  return 0;
}

int64_t rec_bytes_size(void* h, int64_t feature) {
  return static_cast<int64_t>(
      static_cast<Parser*>(h)->bytes_data[feature].size());
}

int64_t rec_bytes_count(void* h, int64_t feature) {
  return static_cast<int64_t>(
      static_cast<Parser*>(h)->bytes_offsets[feature].size() - 1);
}

void rec_copy_bytes(void* h, int64_t feature, uint8_t* data_out,
                    int64_t* offsets_out) {
  auto* P = static_cast<Parser*>(h);
  const auto& d = P->bytes_data[feature];
  const auto& o = P->bytes_offsets[feature];
  if (!d.empty()) std::memcpy(data_out, d.data(), d.size());
  std::memcpy(offsets_out, o.data(), o.size() * sizeof(int64_t));
}

// crc32c of data[0, len), continuing from ``crc`` (0 for a fresh sum):
// the value google_crc32c.value / extend return.
uint32_t rec_crc32c(const uint8_t* data, int64_t len, uint32_t crc) {
  return ~crc32c_update(~crc, data, static_cast<size_t>(len));
}

}  // extern "C"
