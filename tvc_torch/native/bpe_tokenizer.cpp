// CLIP byte-pair-encoding tokenizer in C++ (the host stage of the serving
// path): the port's own copy of the JAX package's native tokenizer, built
// and loaded by tvc_torch/native/__init__.py.
//
// Why: a defended query tokenizes its caption and every variant (V + 1
// strings), and the pure-Python BPE does one string at a time on one core.
// This library encodes a batch with OpenMP threads and a per-thread word
// cache.
//
// Scope: lowercased ASCII strings without special tokens, with the
// semantics of tvc_torch/models/tokenizer.py BPETokenizer (the
// `'s|'t|'re|'ve|'m|'ll|'d|[\w]+|[^\s\w]+` word pattern, the
// byte-to-unicode map, greedy lowest-rank merges, the </w> end-of-word
// marker). The Python wrapper routes every other string to the Python
// path; token ids are identical on both (tests/test_torch_tokenizer.py).
//
// The vocab and merges are loaded once through bpe_init from buffers the
// Python side prepares out of its parsed encoder / rank tables (no file
// parsing here). The tables are global: one vocab per process.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct BpeState {
    std::unordered_map<std::string, int32_t> encoder;
    std::unordered_map<std::string, int32_t> ranks;  // "first\x01second" -> rank
    std::string byte_to_uni[256];                    // UTF-8 of mapped codepoint
    bool ready = false;
};

BpeState g_state;

// CLIP's bytes_to_unicode mapping (tokenizer.py _bytes_to_unicode).
void build_byte_map(BpeState& st) {
    bool direct[256] = {false};
    for (int b = '!'; b <= '~'; ++b) direct[b] = true;
    for (int b = 0xA1; b <= 0xAC; ++b) direct[b] = true;
    for (int b = 0xAE; b <= 0xFF; ++b) direct[b] = true;
    int n = 0;
    for (int b = 0; b < 256; ++b) {
        int cp = direct[b] ? b : 256 + n++;
        std::string u;
        if (cp < 0x80) {
            u.push_back(static_cast<char>(cp));
        } else {  // all mapped codepoints are < 0x800: 2-byte UTF-8
            u.push_back(static_cast<char>(0xC0 | (cp >> 6)));
            u.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
        }
        st.byte_to_uni[b] = u;
    }
}

inline bool is_word_char(unsigned char c) {
    // python `[\w]` restricted to ASCII after .lower()
    return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_' ||
           (c >= 'A' && c <= 'Z');
}

inline bool is_space(unsigned char c) {
    // python regex \s over str additionally treats the ASCII separator
    // controls \x1c-\x1f as whitespace; omitting them broke bit-parity
    // with the python path on crafted inputs (e.g. "a\x1cb")
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
           c == '\v' || (c >= 0x1c && c <= 0x1f);
}

// Greedy BPE over the unicode-mapped word; returns token ids.
void bpe_word(const std::string& mapped, std::vector<int32_t>& out) {
    // split the UTF-8 mapped string into unicode characters (1-2 bytes
    // here by construction), last one gets "</w>"
    std::vector<std::string> word;
    for (size_t i = 0; i < mapped.size();) {
        size_t len = (static_cast<unsigned char>(mapped[i]) < 0x80) ? 1 : 2;
        word.emplace_back(mapped, i, len);
        i += len;
    }
    if (word.empty()) return;
    word.back() += "</w>";

    std::string key;
    while (word.size() > 1) {
        int32_t best_rank = INT32_MAX;
        size_t best = 0;
        for (size_t i = 0; i + 1 < word.size(); ++i) {
            key.assign(word[i]);
            key.push_back('\x01');
            key.append(word[i + 1]);
            auto it = g_state.ranks.find(key);
            if (it != g_state.ranks.end() && it->second < best_rank) {
                best_rank = it->second;
                best = i;
            }
        }
        if (best_rank == INT32_MAX) break;
        // merge EVERY adjacent (first, second) occurrence, like the
        // python loop
        const std::string first = word[best];
        const std::string second = word[best + 1];
        std::vector<std::string> merged;
        merged.reserve(word.size());
        for (size_t i = 0; i < word.size();) {
            if (i + 1 < word.size() && word[i] == first &&
                word[i + 1] == second) {
                merged.push_back(first + second);
                i += 2;
            } else {
                merged.push_back(word[i]);
                i += 1;
            }
        }
        word.swap(merged);
    }
    for (const auto& piece : word) {
        auto it = g_state.encoder.find(piece);
        out.push_back(it != g_state.encoder.end() ? it->second : 0);
    }
}

// Tokenize one lowercased ASCII string into ids (no SOT/EOT).
void encode_text(const char* s, int64_t len, std::vector<int32_t>& ids,
                 std::unordered_map<std::string, std::vector<int32_t>>& cache) {
    // strip
    int64_t b = 0, e = len;
    while (b < e && is_space(static_cast<unsigned char>(s[b]))) ++b;
    while (e > b && is_space(static_cast<unsigned char>(s[e - 1]))) --e;

    std::string tok;
    int64_t i = b;
    while (i < e) {
        unsigned char c = static_cast<unsigned char>(s[i]);
        if (is_space(c)) {
            ++i;
            continue;
        }
        tok.clear();
        if (c == '\'') {
            // 's|'t|'re|'ve|'m|'ll|'d  (already lowercased)
            static const char* suf[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
            int hit = -1;
            for (int k = 0; k < 7; ++k) {
                size_t sl = std::strlen(suf[k]);
                if (i + static_cast<int64_t>(sl) <= e &&
                    std::strncmp(s + i, suf[k], sl) == 0) {
                    // longest match wins ('re over 'r? python alternation is
                    // ordered; these suffixes are prefix-free except 's/'t
                    // vs 're/'ve/'ll — order below matches python's)
                    hit = k;
                    break;
                }
            }
            if (hit >= 0) {
                tok.assign(suf[hit]);
                i += tok.size();
            } else {
                // punctuation run [^\s\w]+
                while (i < e) {
                    unsigned char p = static_cast<unsigned char>(s[i]);
                    if (is_space(p) || is_word_char(p)) break;
                    tok.push_back(static_cast<char>(p));
                    ++i;
                }
            }
        } else if (is_word_char(c)) {
            while (i < e && is_word_char(static_cast<unsigned char>(s[i]))) {
                tok.push_back(s[i]);
                ++i;
            }
        } else {
            while (i < e) {
                unsigned char p = static_cast<unsigned char>(s[i]);
                if (is_space(p) || is_word_char(p)) break;
                tok.push_back(static_cast<char>(p));
                ++i;
            }
        }
        if (tok.empty()) {  // safety: never stall
            ++i;
            continue;
        }
        auto it = cache.find(tok);
        if (it != cache.end()) {
            ids.insert(ids.end(), it->second.begin(), it->second.end());
            continue;
        }
        std::string mapped;
        mapped.reserve(tok.size() * 2);
        for (unsigned char byte : tok)
            mapped += g_state.byte_to_uni[byte];
        std::vector<int32_t> word_ids;
        bpe_word(mapped, word_ids);
        ids.insert(ids.end(), word_ids.begin(), word_ids.end());
        cache.emplace(tok, std::move(word_ids));
    }
}

}  // namespace

extern "C" {

// vocab: n_vocab tokens as concatenated UTF-8 bytes + offsets[n+1] + ids[n].
// merges: n_merges pairs, each "first\x01second", same blob layout; rank =
// index.
int bpe_init(const char* vocab_blob, const int64_t* vocab_offsets,
             const int32_t* vocab_ids, int32_t n_vocab,
             const char* merge_blob, const int64_t* merge_offsets,
             int32_t n_merges) {
    BpeState st;
    build_byte_map(st);
    st.encoder.reserve(n_vocab * 2);
    for (int32_t i = 0; i < n_vocab; ++i) {
        st.encoder.emplace(
            std::string(vocab_blob + vocab_offsets[i],
                        vocab_blob + vocab_offsets[i + 1]),
            vocab_ids[i]);
    }
    st.ranks.reserve(n_merges * 2);
    for (int32_t i = 0; i < n_merges; ++i) {
        st.ranks.emplace(
            std::string(merge_blob + merge_offsets[i],
                        merge_blob + merge_offsets[i + 1]),
            i);
    }
    st.ready = true;
    g_state = std::move(st);
    return 0;
}

// texts: concatenated LOWERCASED ASCII bytes + offsets[n+1].
// out: int32 [n, context_length], prefilled by caller with pad_id.
// Returns 0, or -1 if bpe_init has not run.
int bpe_encode_batch(const char* text_blob, const int64_t* offsets,
                     int32_t n_texts, int32_t* out, int32_t context_length,
                     int32_t sot_id, int32_t eot_id) {
    if (!g_state.ready) return -1;
#pragma omp parallel
    {
        // per-thread word cache (captions repeat words heavily)
        std::unordered_map<std::string, std::vector<int32_t>> cache;
        std::vector<int32_t> ids;
#pragma omp for schedule(dynamic, 16)
        for (int32_t t = 0; t < n_texts; ++t) {
            ids.clear();
            encode_text(text_blob + offsets[t], offsets[t + 1] - offsets[t],
                        ids, cache);
            int32_t* row = out + static_cast<int64_t>(t) * context_length;
            int32_t maxtok = context_length - 2;
            int32_t n = static_cast<int32_t>(ids.size());
            if (n > maxtok) n = maxtok;
            row[0] = sot_id;
            for (int32_t k = 0; k < n; ++k) row[k + 1] = ids[k];
            row[n + 1] = eot_id;
        }
    }
    return 0;
}

int bpe_ready() { return g_state.ready ? 1 : 0; }

}  // extern "C"
