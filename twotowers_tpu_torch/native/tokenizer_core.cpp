// Native batch-tokenization core (char path).
//
// A copy of the char half of twotowers_tpu/native/tokenizer_core.cpp. The
// Python wrapper (native/tokenize.py) packs a batch of texts into one
// UTF-32 buffer; this maps codepoints to ids through a lookup table and
// truncates/pads to max_len (CharTokenizer semantics: unknown -> 0). The
// word half comes with the word tokenizer.
//
// Exposed as plain C symbols for ctypes; no Python headers needed.
// Build: c++ -O3 -march=native -shared -fPIC tokenizer_core.cpp -o libtokenizer_core.so

#include <cstdint>

extern "C" {

// codepoints: concatenated UTF-32 texts; offsets: n_texts+1 prefix offsets
// into it; lut maps codepoint -> id (0 for unknown/pad); out is
// (n_texts, max_len) int32, zero-padded.
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

}  // extern "C"
