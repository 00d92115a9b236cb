// Native text engine: the host tokenizers' hot loop in C++.
//
// Implements the HashingTokenizer semantics (models/tokenizer.py)
// bit-exactly for any text that encodes to UTF-8 (every Python str but
// one holding a lone surrogate), lowercased by the caller:
//
//   * the text is scanned code point by code point, as Python's
//     _WORD_RE = [a-z0-9]+|[^\sa-z0-9] with re.IGNORECASE scans a str:
//     runs of word code points are words, whitespace is skipped, and
//     any other code point is a word of its own (1-4 bytes)
//   * words longer than piece_len code points split into piece_len-sized
//     "##" pieces
//   * id = first_regular + fnv1a(piece's UTF-8 bytes) % (vocab - first_regular)
//   * [CLS] ... [SEP], truncate to max_len-2, zero-pad, 0/1 mask
//
// and, further down, the WordPieceTokenizer's.  Derived from the JAX
// package's native/text_engine.cpp (the same C ABI, at version 3: the
// JAX package's engine, at version 2, takes ASCII only).  Exposed as a
// plain C ABI for ctypes; built with g++ at first use by native/__init__.py.
// Every entry point only reads its inputs (a WordPiece table is read-only
// after te_wp_create/te_wp_set_ids), so calls from several threads at once
// are safe.

#include <cstdint>
#include <cstring>
#include <string>

namespace {

constexpr int PAD_ID = 0;
constexpr int CLS_ID = 101;
constexpr int SEP_ID = 102;
constexpr uint32_t FNV_OFFSET = 0x811C9DC5u;
constexpr uint32_t FNV_PRIME = 0x01000193u;

inline int first_regular(int vocab_size) {
    // mirrors tokenizer._first_regular
    if (vocab_size > 2 * 999) return 999;
    return SEP_ID + 1;
}

// ---------------------------------------------------------------------------
// UTF-8 scanning.  The input is what Python's encoder writes, so it is
// valid UTF-8; a truncated sequence at the end is read no further than
// the text.

inline bool is_cont_byte(char c) {
    return (static_cast<uint8_t>(c) & 0xC0) == 0x80;
}

// The code point at text[i] and its length in bytes.
inline uint32_t code_point(const char* text, int i, int text_len, int& len) {
    const uint8_t b0 = static_cast<uint8_t>(text[i]);
    if (b0 < 0x80) {
        len = 1;
        return b0;
    }
    len = b0 >= 0xF0 ? 4 : b0 >= 0xE0 ? 3 : 2;
    if (len > text_len - i) len = text_len - i;
    uint32_t cp = b0 & (0x7Fu >> len);
    for (int k = 1; k < len; ++k) cp = (cp << 6) | (static_cast<uint8_t>(text[i + k]) & 0x3Fu);
    return cp;
}

// Python's \s on a str: the 29 code points str.isspace() accepts.
inline bool is_space(uint32_t c) {
    if (c < 0x80) return (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x20);
    return c == 0x85 || c == 0xA0 || c == 0x1680 || (c >= 0x2000 && c <= 0x200A) ||
           c == 0x2028 || c == 0x2029 || c == 0x202F || c == 0x205F || c == 0x3000;
}

// [a-z0-9] under re.IGNORECASE: besides A-Z (which a lowercased text
// lacks), the four code points whose case maps into a-z: U+0130 (İ),
// U+0131 (ı), U+017F (ſ) and U+212A (the Kelvin sign).  ı and ſ survive
// str.lower().
inline bool is_word(uint32_t c) {
    if (c < 0x80)
        return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z');
    return c == 0x130 || c == 0x131 || c == 0x17F || c == 0x212A;
}

// Calls on_word(start, bytes, code_points) for each word of the text,
// in order: a run of word code points, or any other non-space code
// point alone.
template <typename F>
inline void scan_words(const char* text, int text_len, F&& on_word) {
    int i = 0;
    while (i < text_len) {
        int len;
        const uint32_t c = code_point(text, i, text_len, len);
        if (is_space(c)) {
            i += len;
        } else if (is_word(c)) {
            const int start = i;
            int chars = 0;
            do {
                i += len;
                ++chars;
            } while (i < text_len && is_word(code_point(text, i, text_len, len)));
            on_word(text + start, i - start, chars);
        } else {
            on_word(text + i, len, 1);
            i += len;
        }
    }
}

// The byte offset `chars` code points past `off` in w (at most wlen).
inline int skip_chars(const char* w, int off, int wlen, int chars) {
    while (off < wlen && chars > 0) {
        ++off;
        while (off < wlen && is_cont_byte(w[off])) ++off;
        --chars;
    }
    return off;
}

// ---------------------------------------------------------------------------
// Hashing tokenization.

// Hash id of `piece` (with optional "##" prefix, hashed as the literal
// bytes '#','#'), FNV-1a over its UTF-8 bytes.
inline int piece_id(const char* piece, int len, bool cont, int vocab_size) {
    const int first = first_regular(vocab_size);
    const int span = vocab_size - first;
    uint32_t h = FNV_OFFSET;
    if (cont) {
        h = (h ^ '#') * FNV_PRIME;
        h = (h ^ '#') * FNV_PRIME;
    }
    for (int i = 0; i < len; ++i) {
        h ^= static_cast<uint8_t>(piece[i]);
        h *= FNV_PRIME;
    }
    return first + static_cast<int>(h % static_cast<uint32_t>(span));
}

// Pieces of a word of `chars` code points: ceil(chars / piece_len).
inline int piece_count(int chars, int piece_len) {
    return chars <= piece_len ? 1 : 1 + (chars - piece_len + piece_len - 1) / piece_len;
}

// Tokenize one lowercased UTF-8 string into ids; returns count of pieces
// produced (may exceed cap; only the first `cap` are stored).
int tokenize_pieces(const char* text, int text_len, int piece_len,
                    int vocab_size, int32_t* out, int cap) {
    int n = 0;
    scan_words(text, text_len, [&](const char* w, int wlen, int chars) {
        if (chars <= piece_len) {
            if (n < cap) out[n] = piece_id(w, wlen, false, vocab_size);
            ++n;
            return;
        }
        for (int off = 0; off < wlen;) {
            const int end = skip_chars(w, off, wlen, piece_len);
            if (n < cap) out[n] = piece_id(w + off, end - off, off > 0, vocab_size);
            ++n;
            off = end;
        }
    });
    return n;
}

}  // namespace

extern "C" {

// Batch tokenization: texts are pre-lowercased UTF-8, concatenated into
// `blob` with per-text (offset, length) pairs in bytes.  Outputs are
// row-major (n, max_len) int32 ids and masks.
void te_tokenize_batch(const char* blob, const int64_t* offsets,
                       const int64_t* lengths, int n_texts, int max_len,
                       int vocab_size, int piece_len, int32_t* ids_out,
                       int32_t* mask_out) {
    const int body_cap = max_len - 2;
    for (int t = 0; t < n_texts; ++t) {
        int32_t* ids = ids_out + static_cast<int64_t>(t) * max_len;
        int32_t* mask = mask_out + static_cast<int64_t>(t) * max_len;
        std::memset(ids, 0, sizeof(int32_t) * max_len);
        std::memset(mask, 0, sizeof(int32_t) * max_len);
        int produced = tokenize_pieces(blob + offsets[t],
                                       static_cast<int>(lengths[t]), piece_len,
                                       vocab_size, ids + 1, body_cap);
        int body = produced < body_cap ? produced : body_cap;
        ids[0] = CLS_ID;
        ids[body + 1] = SEP_ID;
        for (int i = 0; i < body + 2; ++i) mask[i] = 1;
    }
    (void)PAD_ID;
}

// Token count (pieces + CLS + SEP) for the chunker's budget loop.
int64_t te_token_count(const char* text, int64_t len, int piece_len) {
    int64_t n = 0;
    scan_words(text, static_cast<int>(len), [&](const char*, int, int chars) {
        n += piece_count(chars, piece_len);
    });
    return n + 2;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// WordPiece (real-vocab) tokenization: models/tokenizer.py's
// WordPieceTokenizer semantics, bit-exactly for UTF-8 input:
//   * lowercase (by the caller); the words of scan_words (the _WORD_RE
//     pre-tokenization),
//   * greedy longest-match-first against the vocab, stepping back one
//     code point at a time, continuations prefixed "##"; any unmatched
//     position makes the WHOLE word [UNK],
//   * words over 100 code points are [UNK],
//   * [CLS] body-truncated-to-max_len-2 [SEP], zero-pad, 0/1 mask.
// Vocab lookups run against an open-addressing FNV table over the
// pieces' UTF-8 bytes — no per-lookup allocation.

#include <vector>

namespace {

constexpr int WP_MAX_WORD_CHARS = 100;

struct WpVocab {
    std::vector<char> blob;
    std::vector<int32_t> offs, lens, ids;
    std::vector<int32_t> table;  // slot -> piece index, -1 empty
    uint32_t mask = 0;
    int32_t unk = 0, cls = 0, sep = 0, pad = 0;
    // the longest plain piece and continuation (without "##"), in bytes:
    // no longer candidate can match
    int max_plain = 1, max_cont = 1;
};

inline uint32_t wp_hash(const char* a, int alen, bool cont) {
    uint32_t h = FNV_OFFSET;
    if (cont) {
        h = (h ^ '#') * FNV_PRIME;
        h = (h ^ '#') * FNV_PRIME;
    }
    for (int i = 0; i < alen; ++i) {
        h ^= static_cast<uint8_t>(a[i]);
        h *= FNV_PRIME;
    }
    return h;
}

inline int32_t wp_lookup(const WpVocab& v, const char* a, int alen, bool cont) {
    uint32_t slot = wp_hash(a, alen, cont) & v.mask;
    const int want_len = alen + (cont ? 2 : 0);
    while (true) {
        int32_t pi = v.table[slot];
        if (pi < 0) return -1;
        if (v.lens[pi] == want_len) {
            const char* p = v.blob.data() + v.offs[pi];
            bool ok = true;
            if (cont) {
                ok = p[0] == '#' && p[1] == '#';
                p += 2;
            }
            if (ok && std::memcmp(p, a, alen) == 0) return v.ids[pi];
        }
        slot = (slot + 1) & v.mask;
    }
}

// tokenize one word of `wlen` bytes and `chars` code points; appends ids
// to out via the caller's cursor.  A failed match emits exactly one
// [UNK] for the whole word.
inline void wp_word(const WpVocab& v, const char* w, int wlen, int chars,
                    int32_t* out, int cap, int& n) {
    if (chars > WP_MAX_WORD_CHARS) {
        if (n < cap) out[n] = v.unk;
        ++n;
        return;
    }
    int32_t tmp[WP_MAX_WORD_CHARS];
    int m = 0;
    int start = 0;
    while (start < wlen) {
        // the longest candidate no longer than any piece, cut back to a
        // code point's first byte
        const int lim = (start == 0) ? v.max_plain : v.max_cont;
        int end = wlen - start > lim ? start + lim : wlen;
        while (end > start && end < wlen && is_cont_byte(w[end])) --end;
        int32_t id = -1;
        while (end > start) {
            id = wp_lookup(v, w + start, end - start, start > 0);
            if (id >= 0) break;
            do --end; while (end > start && is_cont_byte(w[end]));
        }
        if (id < 0) {
            if (n < cap) out[n] = v.unk;
            ++n;
            return;
        }
        tmp[m++] = id;
        start = end;
    }
    for (int i = 0; i < m; ++i) {
        if (n < cap) out[n] = tmp[i];
        ++n;
    }
}

inline int wp_tokenize(const WpVocab& v, const char* text, int text_len,
                       int32_t* out, int cap) {
    int n = 0;
    scan_words(text, text_len, [&](const char* w, int wlen, int chars) {
        wp_word(v, w, wlen, chars, out, cap, n);
    });
    return n;
}

}  // namespace

extern "C" {

void* te_wp_create(const char* blob, const int64_t* offs,
                   const int64_t* lens, int n_pieces, int unk_id,
                   int cls_id, int sep_id, int pad_id) {
    auto* v = new WpVocab();
    v->unk = unk_id;
    v->cls = cls_id;
    v->sep = sep_id;
    v->pad = pad_id;
    uint32_t cap = 16;
    while (cap < static_cast<uint32_t>(n_pieces) * 2u) cap <<= 1;
    v->mask = cap - 1;
    v->table.assign(cap, -1);
    int64_t total = 0;
    for (int i = 0; i < n_pieces; ++i) total += lens[i];
    v->blob.resize(static_cast<size_t>(total));
    v->offs.resize(n_pieces);
    v->lens.resize(n_pieces);
    v->ids.resize(n_pieces);
    int64_t cur = 0;
    for (int i = 0; i < n_pieces; ++i) {
        const char* p = blob + offs[i];
        const int plen = static_cast<int>(lens[i]);
        std::memcpy(v->blob.data() + cur, p, plen);
        v->offs[i] = static_cast<int32_t>(cur);
        v->lens[i] = plen;
        // the stored id is the piece's position in the caller's order
        v->ids[i] = i;
        cur += plen;
        const bool cont = plen > 2 && p[0] == '#' && p[1] == '#';
        const int bytes = cont ? plen - 2 : plen;
        if (cont) {
            if (bytes > v->max_cont) v->max_cont = bytes;
        } else if (bytes > v->max_plain) {
            v->max_plain = bytes;
        }
        uint32_t slot = wp_hash(p + (cont ? 2 : 0), bytes, cont) & v->mask;
        while (v->table[slot] >= 0) slot = (slot + 1) & v->mask;
        v->table[slot] = i;
    }
    return v;
}

void te_wp_set_ids(void* handle, const int32_t* ids, int n_pieces) {
    auto* v = static_cast<WpVocab*>(handle);
    for (int i = 0; i < n_pieces && i < static_cast<int>(v->ids.size()); ++i)
        v->ids[i] = ids[i];
}

void te_wp_destroy(void* handle) {
    delete static_cast<WpVocab*>(handle);
}

void te_wp_tokenize_batch(void* handle, const char* blob,
                          const int64_t* offsets, const int64_t* lengths,
                          int n_texts, int max_len, int32_t* ids_out,
                          int32_t* mask_out) {
    const auto* v = static_cast<const WpVocab*>(handle);
    const int body_cap = max_len - 2;
    for (int t = 0; t < n_texts; ++t) {
        int32_t* ids = ids_out + static_cast<int64_t>(t) * max_len;
        int32_t* mask = mask_out + static_cast<int64_t>(t) * max_len;
        for (int i = 0; i < max_len; ++i) ids[i] = v->pad;
        std::memset(mask, 0, sizeof(int32_t) * max_len);
        int produced = wp_tokenize(*v, blob + offsets[t],
                                   static_cast<int>(lengths[t]),
                                   ids + 1, body_cap);
        int body = produced < body_cap ? produced : body_cap;
        ids[0] = v->cls;
        ids[body + 1] = v->sep;
        for (int i = 0; i < body + 2; ++i) mask[i] = 1;
    }
}

int64_t te_wp_token_count(void* handle, const char* text, int64_t len) {
    const auto* v = static_cast<const WpVocab*>(handle);
    // counting needs real tokenization (greedy matching), but not the
    // ids themselves: reuse the tokenizer with a zero-capacity sink
    int32_t sink;
    int n = wp_tokenize(*v, text, static_cast<int>(len), &sink, 0);
    return n + 2;
}

int te_abi_version() { return 3; }

}  // extern "C"
