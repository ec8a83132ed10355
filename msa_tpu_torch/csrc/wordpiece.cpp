// Fast host-side WordPiece encoder (C ABI, loaded via ctypes).
//
// Native replacement for the reference's per-word HF tokenizer hot loop
// (ref train.py:159-176 runs python tokenization over every word of every
// sample at startup).  Handles the ASCII fast path exactly like
// msa_tpu_torch/data/wordpiece.py (lowercase, punctuation split, greedy
// longest-match WordPiece); any word containing a non-ASCII byte is
// rejected with a sentinel so the Python wrapper falls back to the unicode
// implementation -- parity by construction.
//
// Build: msa_tpu_torch/_build.py's host route, at first use.

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
    std::unordered_map<std::string, int32_t> map;
    int32_t unk_id = -1;
    size_t max_token_len = 0;
};

bool is_ascii_punct(unsigned char c) {
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Greedy longest-match-first wordpiece over one clean lowercase chunk.
// Returns false if the chunk cannot be tokenized (emit UNK).
bool wordpiece(const Vocab& v, const std::string& word,
               std::vector<int32_t>& out) {
    if (word.size() > 100) return false;
    size_t start = 0;
    const size_t n = word.size();
    size_t emitted = 0;
    while (start < n) {
        size_t end = n;
        int32_t cur = -1;
        while (start < end) {
            std::string sub = (start > 0 ? "##" : "") + word.substr(start, end - start);
            auto it = v.map.find(sub);
            if (it != v.map.end()) { cur = it->second; break; }
            --end;
        }
        if (cur < 0) {
            out.resize(out.size() - emitted);
            return false;
        }
        out.push_back(cur);
        ++emitted;
        start = end;
    }
    return true;
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_path) {
    std::ifstream f(vocab_path);
    if (!f.good()) return nullptr;
    auto* v = new Vocab();
    std::string line;
    int32_t i = 0;
    while (std::getline(f, line)) {
        if (!line.empty() && line.back() == '\r') line.pop_back();
        if (!line.empty()) {
            v->map.emplace(line, i);
            if (line.size() > v->max_token_len) v->max_token_len = line.size();
        }
        ++i;
    }
    auto it = v->map.find("[UNK]");
    if (it == v->map.end()) { delete v; return nullptr; }
    v->unk_id = it->second;
    return v;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Encode newline-separated words.  Writes token ids and, per token, the
// index of the source word (the featurizer's inversion list).
// Returns the token count, -1 on overflow of max_out, or -2 if any byte is
// non-ASCII (caller must fall back to the unicode tokenizer).
int32_t wp_encode_words(void* handle, const char* text, int32_t* ids_out,
                        int32_t* inv_out, int32_t max_out) {
    const Vocab& v = *static_cast<const Vocab*>(handle);
    int32_t count = 0;
    int32_t word_idx = 0;
    std::vector<int32_t> tmp;
    const char* p = text;

    auto emit = [&](int32_t id) -> bool {
        if (count >= max_out) return false;
        ids_out[count] = id;
        inv_out[count] = word_idx;
        ++count;
        return true;
    };

    while (*p) {
        // one word = up to '\n'
        const char* start = p;
        while (*p && *p != '\n') {
            if (static_cast<unsigned char>(*p) >= 0x80) return -2;
            ++p;
        }
        std::string word(start, p - start);
        if (*p == '\n') ++p;

        // basic tokenize: clean controls/ws, lowercase, split punctuation
        std::string chunk;
        std::vector<std::string> chunks;
        for (unsigned char c : word) {
            if (c == 0 || c < 32 || c == 127) {
                if (c == '\t') { if (!chunk.empty()) { chunks.push_back(chunk); chunk.clear(); } }
                continue;  // control chars dropped, \t handled as ws above
            }
            if (c == ' ') {
                if (!chunk.empty()) { chunks.push_back(chunk); chunk.clear(); }
            } else if (is_ascii_punct(c)) {
                if (!chunk.empty()) { chunks.push_back(chunk); chunk.clear(); }
                chunks.push_back(std::string(1, static_cast<char>(c)));
            } else {
                chunk.push_back(static_cast<char>(
                    (c >= 'A' && c <= 'Z') ? c + 32 : c));
            }
        }
        if (!chunk.empty()) chunks.push_back(chunk);

        for (const auto& ch : chunks) {
            tmp.clear();
            if (wordpiece(v, ch, tmp)) {
                for (int32_t id : tmp) if (!emit(id)) return -1;
            } else {
                if (!emit(v.unk_id)) return -1;
            }
        }
        ++word_idx;
    }
    return count;
}

}  // extern "C"
