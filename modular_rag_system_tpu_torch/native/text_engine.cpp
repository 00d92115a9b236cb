// Native text engine: the host tokenizers' hot loop in C++.
//
// Implements the HashingTokenizer semantics (models/tokenizer.py)
// bit-exactly for ASCII input:
//
//   * lowercase
//   * runs of [a-z0-9] are words; any other non-space char is its own piece
//   * words longer than piece_len split into piece_len-sized "##" pieces
//   * id = first_regular + fnv1a(piece) % (vocab - first_regular)
//   * [CLS] ... [SEP], truncate to max_len-2, zero-pad, 0/1 mask
//
// and, further down, the WordPieceTokenizer's.  A copy of the JAX
// package's native/text_engine.cpp (same C ABI, version 2).  Exposed as a
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

inline uint32_t fnv1a(const char* data, int len) {
    uint32_t h = FNV_OFFSET;
    for (int i = 0; i < len; ++i) {
        h ^= static_cast<uint8_t>(data[i]);
        h *= FNV_PRIME;
    }
    return h;
}

inline int first_regular(int vocab_size) {
    // mirrors tokenizer._first_regular
    if (vocab_size > 2 * 999) return 999;
    return SEP_ID + 1;
}

inline bool is_word_char(char c) {
    return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
}

inline bool is_space(char c) {
    // must match Python re \s (Unicode) on ASCII inputs: besides the C
    // classics it treats the separator controls 0x1c-0x1f as whitespace
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
           c == '\v' || (c >= '\x1c' && c <= '\x1f');
}

// Emit the hash id of `piece` (with optional "##" prefix) via callback-free
// inline hashing: prefix is hashed as literal bytes '#','#'.
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

// Tokenize one lowercased ASCII string into ids; returns count of pieces
// produced (may exceed cap; only the first `cap` are stored).
int tokenize_pieces(const char* text, int text_len, int piece_len,
                    int vocab_size, int32_t* out, int cap) {
    int n = 0;
    int i = 0;
    while (i < text_len) {
        char c = text[i];
        if (is_space(c)) { ++i; continue; }
        if (is_word_char(c)) {
            int start = i;
            while (i < text_len && is_word_char(text[i])) ++i;
            int wlen = i - start;
            if (wlen <= piece_len) {
                if (n < cap) out[n] = piece_id(text + start, wlen, false, vocab_size);
                ++n;
            } else {
                if (n < cap) out[n] = piece_id(text + start, piece_len, false, vocab_size);
                ++n;
                for (int off = piece_len; off < wlen; off += piece_len) {
                    int plen = (off + piece_len <= wlen) ? piece_len : (wlen - off);
                    if (n < cap) out[n] = piece_id(text + start + off, plen, true, vocab_size);
                    ++n;
                }
            }
        } else {
            if (n < cap) out[n] = piece_id(text + i, 1, false, vocab_size);
            ++n;
            ++i;
        }
    }
    return n;
}

}  // namespace

extern "C" {

// Batch tokenization: texts are pre-lowercased ASCII, concatenated into
// `blob` with per-text (offset, length) pairs.  Outputs are row-major
// (n, max_len) int32 ids and masks.
void te_tokenize_batch(const char* blob, const int64_t* offsets,
                       const int64_t* lengths, int n_texts, int max_len,
                       int vocab_size, int piece_len, int32_t* ids_out,
                       int32_t* mask_out) {
    const int body_cap = max_len - 2;
    // scratch per text lives on the stack of this loop iteration
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
    // count without storing: vocab_size irrelevant for counting
    int n = 0;
    int i = 0;
    int L = static_cast<int>(len);
    while (i < L) {
        char c = text[i];
        if (is_space(c)) { ++i; continue; }
        if (is_word_char(c)) {
            int start = i;
            while (i < L && is_word_char(text[i])) ++i;
            int wlen = i - start;
            if (wlen <= piece_len) {
                n += 1;
            } else {
                // first piece + ceil((wlen - piece_len) / piece_len) continuations
                n += 1 + (wlen - piece_len + piece_len - 1) / piece_len;
            }
        } else {
            ++n;
            ++i;
        }
    }
    return n + 2;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// WordPiece (real-vocab) tokenization: models/tokenizer.py's
// WordPieceTokenizer semantics, bit-exactly for ASCII input:
//   * lowercase; runs of [a-z0-9] are words, other non-space chars are
//     single-char words (the _WORD_RE pre-tokenization),
//   * greedy longest-match-first against the vocab, continuations
//     prefixed "##"; any unmatched position makes the WHOLE word [UNK],
//   * words over 100 chars are [UNK],
//   * [CLS] body-truncated-to-max_len-2 [SEP], zero-pad, 0/1 mask.
// Vocab lookups run against an open-addressing FNV table over the piece
// blob — no per-lookup allocation.

#include <vector>

namespace {

constexpr int WP_MAX_WORD_CHARS = 100;

struct WpVocab {
    std::vector<char> blob;
    std::vector<int32_t> offs, lens, ids;
    std::vector<int32_t> table;  // slot -> piece index, -1 empty
    uint32_t mask = 0;
    int32_t unk = 0, cls = 0, sep = 0, pad = 0;
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

// tokenize one word; appends ids to out via the caller's cursor.  A
// failed match emits exactly one [UNK] for the whole word.
inline void wp_word(const WpVocab& v, const char* w, int wlen,
                    int32_t* out, int cap, int& n) {
    if (wlen > WP_MAX_WORD_CHARS) {
        if (n < cap) out[n] = v.unk;
        ++n;
        return;
    }
    int32_t tmp[WP_MAX_WORD_CHARS];
    int m = 0;
    int start = 0;
    while (start < wlen) {
        const int lim = (start == 0) ? v.max_plain : v.max_cont;
        int end = wlen - start > lim ? start + lim : wlen;
        int32_t id = -1;
        for (; end > start; --end) {
            id = wp_lookup(v, w + start, end - start, start > 0);
            if (id >= 0) break;
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
    int i = 0;
    while (i < text_len) {
        char c = text[i];
        if (is_space(c)) { ++i; continue; }
        if (is_word_char(c)) {
            int start = i;
            while (i < text_len && is_word_char(text[i])) ++i;
            wp_word(v, text + start, i - start, out, cap, n);
        } else {
            wp_word(v, text + i, 1, out, cap, n);
            ++i;
        }
    }
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
        const int chars = cont ? plen - 2 : plen;
        if (cont) {
            if (chars > v->max_cont) v->max_cont = chars;
        } else if (chars > v->max_plain) {
            v->max_plain = chars;
        }
        uint32_t slot = wp_hash(p + (cont ? 2 : 0), chars, cont) & v->mask;
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

int te_abi_version() { return 2; }

}  // extern "C"
