// Native batch-tokenization core.
//
// A copy of twotowers_tpu/native/tokenizer_core.cpp. The Python wrapper
// (native/tokenize.py) packs a batch of texts into one contiguous buffer;
// this does the two hot conversions in C++:
//
//   * char encoding: UTF-32 codepoints -> ids through a lookup table,
//     truncate/pad to max_len (CharTokenizer semantics: unknown -> 0).
//   * word encoding: byte-level word extraction ([A-Za-z0-9_]+ runs over
//     lowercased ASCII, the common fast path of WordTokenizer's \w+ regex)
//     hashed into an open-addressing vocab table -> ids (unknown -> UNK=1).
//
// Exposed as plain C symbols for ctypes; no Python headers needed.
// Build: c++ -O3 -march=native -shared -fPIC tokenizer_core.cpp -o libtokenizer_core.so

#include <cstdint>
#include <cstring>

extern "C" {

// Char path. codepoints: concatenated UTF-32 texts; offsets: n_texts+1
// prefix offsets into it; lut maps codepoint -> id (0 for unknown/pad);
// out is (n_texts, max_len) int32, zero-padded.
void char_encode_batch(const uint32_t* codepoints,
                       const int64_t* offsets,
                       int64_t n_texts,
                       const int32_t* lut,
                       int64_t lut_size,
                       int64_t max_len,
                       int32_t* out) {
    for (int64_t t = 0; t < n_texts; ++t) {
        const int64_t begin = offsets[t];
        const int64_t end = offsets[t + 1];
        int64_t length = end - begin;
        if (length > max_len) length = max_len;
        int32_t* row = out + t * max_len;
        const uint32_t* src = codepoints + begin;
        for (int64_t i = 0; i < length; ++i) {
            const uint32_t cp = src[i];
            row[i] = (cp < (uint64_t)lut_size) ? lut[cp] : 0;
        }
        for (int64_t i = length; i < max_len; ++i) row[i] = 0;
    }
}

// FNV-1a over a byte range (the wrapper uses the same function via
// fnv1a64() below to build the hash table, so the two always agree).
static inline uint64_t fnv1a(const uint8_t* data, int64_t len) {
    uint64_t hash = 1469598103934665603ULL;
    for (int64_t i = 0; i < len; ++i) {
        hash ^= data[i];
        hash *= 1099511628211ULL;
    }
    return hash;
}

uint64_t fnv1a64(const uint8_t* data, int64_t len) { return fnv1a(data, len); }

static inline bool is_word_byte(uint8_t c) {
    // [A-Za-z0-9_] plus any non-ASCII byte (multi-byte UTF-8 sequences stay
    // part of the word, matching \w over letters)
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '_' || c >= 0x80;
}

static inline uint8_t lower(uint8_t c) {
    return (c >= 'A' && c <= 'Z') ? (uint8_t)(c + 32) : c;
}

// Word path. utf8: concatenated UTF-8 texts; offsets: prefix offsets;
// vocab is an open-addressing table of (hash, id) pairs with `capacity`
// power-of-two slots (hash==0 -> empty; the wrapper rehashes the rare word
// whose fnv1a is 0). lowercase applied to ASCII letters. out zero-padded;
// unknown words -> unk_id.
void word_encode_batch(const uint8_t* utf8,
                       const int64_t* offsets,
                       int64_t n_texts,
                       const uint64_t* vocab_hashes,
                       const int32_t* vocab_ids,
                       int64_t capacity,
                       int32_t unk_id,
                       int64_t max_len,
                       int do_lowercase,
                       int32_t* out) {
    const uint64_t mask = (uint64_t)capacity - 1;
    uint8_t word_buf[256];
    for (int64_t t = 0; t < n_texts; ++t) {
        const int64_t begin = offsets[t];
        const int64_t end = offsets[t + 1];
        int32_t* row = out + t * max_len;
        int64_t n_tokens = 0;
        int64_t i = begin;
        while (i < end && n_tokens < max_len) {
            while (i < end && !is_word_byte(utf8[i])) ++i;
            if (i >= end) break;
            int64_t wlen = 0;
            while (i < end && is_word_byte(utf8[i])) {
                if (wlen < (int64_t)sizeof(word_buf)) {
                    word_buf[wlen] = do_lowercase ? lower(utf8[i]) : utf8[i];
                }
                ++wlen;
                ++i;
            }
            if (wlen > (int64_t)sizeof(word_buf)) wlen = sizeof(word_buf);
            uint64_t hash = fnv1a(word_buf, wlen);
            if (hash == 0) hash = 1;  // 0 marks empty slots
            // linear probe
            int32_t id = unk_id;
            uint64_t slot = hash & mask;
            while (vocab_hashes[slot] != 0) {
                if (vocab_hashes[slot] == hash) { id = vocab_ids[slot]; break; }
                slot = (slot + 1) & mask;
            }
            row[n_tokens++] = id;
        }
        for (int64_t j = n_tokens; j < max_len; ++j) row[j] = 0;
    }
}

}  // extern "C"
