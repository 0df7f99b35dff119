// Native data-path library of procyon_tpu_torch: protein tokenization,
// FASTA indexing, MLM masking. The host-side runtime around the model: the
// collators, the MLM stream and ProCyonDataStore's sequence reader.
//
// Exposed through ctypes (procyon_tpu_torch/native.py), which builds it with
// g++ at first use and keeps a pure-python fallback for every entry point.
// A copy of native/procyon_native.cpp of the JAX package: the same
// functions, the same outputs bit for bit (tests/test_torch_native.py).
//
// Build: g++ -O3 -shared -fPIC -o libprocyon_native.so procyon_native.cpp

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ESM alphabet (matches data/protein_tokenizer.py TOKENS exactly)
static int8_t AA_LUT[256];
static bool lut_init = false;

static void init_lut() {
  if (lut_init) return;
  memset(AA_LUT, 3, sizeof(AA_LUT));  // <unk>
  const char* tokens = "LAGVSERTIDPKQNFYMHWCXBUZO.-";
  for (int i = 0; tokens[i]; ++i) {
    AA_LUT[(uint8_t)tokens[i]] = (int8_t)(4 + i);
    AA_LUT[(uint8_t)tolower(tokens[i])] = (int8_t)(4 + i);
  }
  lut_init = true;
}

const int CLS = 0, PAD = 1, EOS = 2, MASK = 32;

// Encode one sequence (no cls/eos). Returns length written.
int encode_seq(const char* seq, int32_t* out, int max_out) {
  init_lut();
  int n = 0;
  for (const char* p = seq; *p && n < max_out; ++p) {
    out[n++] = AA_LUT[(uint8_t)*p];
  }
  return n;
}

// Count rows needed for a batch with chunk splitting.
int count_rows(const char** seqs, int n_seqs, int max_len, int split) {
  int rows = 0;
  for (int i = 0; i < n_seqs; ++i) {
    int len = (int)strlen(seqs[i]);
    if (!split || len <= max_len) rows += 1;
    else rows += (len + max_len - 1) / max_len;
  }
  return rows;
}

// Batch-encode with chunk splitting (batch_encode equivalent).
// tokens: [n_rows, width] pre-allocated (width = min(max(len), max_len)+2).
// Returns number of rows written; fills group_ids and row_valid.
int batch_encode(const char** seqs, int n_seqs, int max_len, int split,
                 int32_t* tokens, int n_rows, int width,
                 int32_t* group_ids, float* row_valid) {
  init_lut();
  for (int r = 0; r < n_rows; ++r) {
    for (int c = 0; c < width; ++c) tokens[r * width + c] = PAD;
    row_valid[r] = 0.0f;
    group_ids[r] = 0;
  }
  int row = 0;
  std::vector<int32_t> buf;
  for (int gi = 0; gi < n_seqs; ++gi) {
    int len = (int)strlen(seqs[gi]);
    buf.resize(len);
    int enc = encode_seq(seqs[gi], buf.data(), len);
    int n_chunks = (!split || enc <= max_len) ? 1
                   : (enc + max_len - 1) / max_len;
    if (!split && enc > max_len) enc = max_len;  // truncate mode
    for (int ch = 0; ch < n_chunks && row < n_rows; ++ch) {
      int start = ch * max_len;
      int clen = enc - start;
      if (clen > max_len) clen = max_len;
      if (clen <= 0) break;
      int32_t* trow = tokens + row * width;
      trow[0] = CLS;
      memcpy(trow + 1, buf.data() + start, clen * sizeof(int32_t));
      trow[1 + clen] = EOS;
      group_ids[row] = gi;
      row_valid[row] = 1.0f;
      ++row;
    }
  }
  return row;
}

// xorshift128+ for deterministic MLM masking
struct Rng {
  uint64_t s0, s1;
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// BERT-style MLM masking (mask_for_mlm equivalent): labels -100 where not
// selected; 80/10/10 mask/random/keep.
void mask_for_mlm(const int32_t* tokens, int n, float mask_prob,
                  uint64_t seed, int32_t* out_tokens, int32_t* out_labels) {
  Rng rng{seed ^ 0x9E3779B97F4A7C15ULL, seed * 0xBF58476D1CE4E5B9ULL + 1};
  for (int i = 0; i < n; ++i) {
    int32_t t = tokens[i];
    out_tokens[i] = t;
    out_labels[i] = -100;
    if (t == PAD || t == CLS || t == EOS) continue;
    if (rng.uniform() < mask_prob) {
      out_labels[i] = t;
      double r = rng.uniform();
      if (r < 0.8) out_tokens[i] = MASK;
      else if (r < 0.9) out_tokens[i] = 4 + (int)(rng.uniform() * 20);
    }
  }
}

// FASTA index: scan for record offsets. Returns count (call with
// offsets=null to size, then again to fill).
long fasta_index(const char* path, int64_t* offsets, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long count = 0;
  int64_t pos = 0;
  char line[1 << 16];
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == '>') {
      if (offsets && count < cap) offsets[count] = pos;
      ++count;
    }
    pos += (int64_t)strlen(line);
  }
  fclose(f);
  return count;
}

// Read one FASTA record's sequence into out (null-terminated).
long fasta_get(const char* path, int64_t offset, char* out, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, (long)offset, SEEK_SET);
  char line[1 << 16];
  long n = 0;
  bool first = true;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == '>') {
      if (!first) break;
      first = false;
      continue;
    }
    long len = (long)strlen(line);
    while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r'))
      --len;
    if (n + len >= cap) len = cap - n - 1;
    memcpy(out + n, line, len);
    n += len;
    if (n >= cap - 1) break;
  }
  out[n] = '\0';
  fclose(f);
  return n;
}

}  // extern "C"
