// Host runtime of the PyTorch/CUDA port: the serial decoders, the table
// builder, the truncation scan and the encoder's bit-packer, in C++.
//
// The port's own copy of the JAX package's native/huffc.cpp: the same 13
// entry points with the same signatures and semantics, so the tests hold
// the two byte for byte.  Semantics parity (not code) with the reference
// framework's host decoders:
//   simpleDecode            mainrun.c:38-55
//   decodeBigtableV1        mainrun.c:142-195
//   decodeBigtableMultiSym  mainrun.c:197-352
//   jump/lin DFA decode     jumptableapproach.c, linapproach.c (tables
//                           built in numpy; the decode loops live here)
//   setTargetSizes          mainrun.c:361-385
//   encoder bit-pack        (the reference has no encoder)
//
// This is host code, not a kernel: it runs on the CPU beside the card.
// Exposed with a plain C ABI and driven from Python via ctypes; buffers are
// numpy arrays.  All functions return a negative value on error.

#include <cstdint>
#include <cstring>

extern "C" {

// Tree layout: (nodes, 3) int32 rows [sym, izero, ione]; row 0 = root;
// leaf <=> izero == -1.  Bit p of the stream = (data[p>>3] >> (p&7)) & 1.

// Bit-at-a-time tree walk over the whole stream. Returns symbols written.
int64_t huffc_simple_decode(const int32_t* tree, int64_t nodes,
                            const uint8_t* data, int64_t bits,
                            uint8_t* out, int64_t out_capacity) {
    int64_t pos = 0, n = 0;
    while (pos < bits) {
        int64_t node = 0;
        while (tree[node * 3 + 1] != -1) {
            if (pos >= bits) return -2;  // truncated codeword
            int bit = (data[pos >> 3] >> (pos & 7)) & 1;
            node = tree[node * 3 + (bit ? 2 : 1)];
            if (node < 0 || node >= nodes) return -3;
            ++pos;
        }
        if (n >= out_capacity) return -4;
        out[n++] = (uint8_t)tree[node * 3];
    }
    return n;
}

// Register-cached byte variant (simpleDecodeRP semantics, mainrun.c:76-117):
// the current payload byte is held in a local and refreshed on byte crossings.
int64_t huffc_simple_decode_rp(const int32_t* tree, int64_t nodes,
                               const uint8_t* data, int64_t bits,
                               uint8_t* out, int64_t out_capacity) {
    int64_t pos = 0, n = 0;
    int64_t curbyte = -1;
    uint8_t reg = 0;
    while (pos < bits) {
        int64_t node = 0;
        while (tree[node * 3 + 1] != -1) {
            if (pos >= bits) return -2;
            int64_t byte = pos >> 3;
            if (byte != curbyte) { reg = data[byte]; curbyte = byte; }
            int bit = (reg >> (pos & 7)) & 1;
            node = tree[node * 3 + (bit ? 2 : 1)];
            if (node < 0 || node >= nodes) return -3;
            ++pos;
        }
        if (n >= out_capacity) return -4;
        out[n++] = (uint8_t)tree[node * 3];
    }
    return n;
}

// Packed-entry LUT decode (decodeBigtableV1 semantics, mainrun.c:142-195):
// each entry is a uint16 (sym << 8) | codelen.
int64_t huffc_bigtable_decode_packed(const uint16_t* lut, int32_t h,
                                     const uint8_t* data, int64_t bits,
                                     uint8_t* out, int64_t out_capacity) {
    const uint32_t mask = (h >= 32) ? 0xffffffffu : (((uint32_t)1 << h) - 1u);
    int64_t pos = 0, n = 0;
    while (pos < bits) {
        int64_t byte = pos >> 3;
        uint32_t window;
        std::memcpy(&window, data + byte, 4);
        window = (window >> (pos & 7)) & mask;
        uint16_t e = lut[window];
        if (n >= out_capacity) return -4;
        out[n++] = (uint8_t)(e >> 8);
        pos += (e & 0xff);
    }
    return (pos == bits) ? n : -5;
}

// Build the full-height lookup table: for every h-bit window w (LSB-first),
// lut_sym[w] = first decoded symbol, lut_len[w] = its code length.
// Windows that run past a leaf are fine (extra bits ignored); h must be >=
// the tree height so every window resolves to a leaf.
int64_t huffc_build_lut(const int32_t* tree, int64_t nodes, int32_t h,
                        uint8_t* lut_sym, int32_t* lut_len) {
    if (h < 0 || h > 26) return -1;
    int64_t size = (int64_t)1 << h;
    for (int64_t w = 0; w < size; ++w) {
        int64_t node = 0;
        int32_t len = 0;
        while (tree[node * 3 + 1] != -1) {
            if (len >= h) return -2;  // h smaller than tree height
            int bit = (w >> len) & 1;
            node = tree[node * 3 + (bit ? 2 : 1)];
            if (node < 0 || node >= nodes) return -3;
            ++len;
        }
        lut_sym[w] = (uint8_t)tree[node * 3];
        lut_len[w] = len;
    }
    return size;
}

// Full-height-LUT serial decode (decodeBigtableV1 semantics): read a 32-bit
// window at the cursor, one LUT hit per symbol.  `data` must have >= 4 pad
// bytes past ceil(bits/8) (HuffFile.payload_padded).
int64_t huffc_bigtable_decode(const uint8_t* lut_sym, const int32_t* lut_len,
                              int32_t h, const uint8_t* data, int64_t bits,
                              uint8_t* out, int64_t out_capacity) {
    const uint32_t mask = (h >= 32) ? 0xffffffffu : (((uint32_t)1 << h) - 1u);
    int64_t pos = 0, n = 0;
    while (pos < bits) {
        int64_t byte = pos >> 3;
        uint32_t window;
        std::memcpy(&window, data + byte, 4);  // little-endian hosts only
        window = (window >> (pos & 7)) & mask;
        if (n >= out_capacity) return -4;
        out[n++] = lut_sym[window];
        pos += lut_len[window];
    }
    return (pos == bits) ? n : -5;
}

// Multi-symbol LUT decode (decodeBigtableMultiSym semantics): each LUT entry
// carries up to `maxsym` symbols fully contained in the window plus the bits
// they consume.  Entries: ms_syms[(w*maxsym)..], ms_count[w], ms_consumed[w].
int64_t huffc_multisym_decode(const uint8_t* ms_syms, const uint8_t* ms_count,
                              const int32_t* ms_consumed, int32_t maxsym,
                              int32_t h, const uint8_t* data, int64_t bits,
                              uint8_t* out, int64_t out_capacity,
                              int64_t* out_pos) {
    const uint32_t mask = (h >= 32) ? 0xffffffffu : (((uint32_t)1 << h) - 1u);
    int64_t pos = 0, n = 0;
    while (pos + h <= bits) {
        int64_t byte = pos >> 3;
        uint32_t window;
        std::memcpy(&window, data + byte, 4);
        window = (window >> (pos & 7)) & mask;
        int cnt = ms_count[window];
        if (cnt == 0) return -6;  // single codeword longer than window
        if (n + cnt > out_capacity) return -4;
        std::memcpy(out + n, ms_syms + (int64_t)window * maxsym, (size_t)cnt);
        n += cnt;
        pos += ms_consumed[window];
    }
    *out_pos = pos;  // caller finishes the (< h)-bit tail serially
    return n;
}

// DFA decode: state-transition tables built host-side (jump/lin approaches).
// For each k-bit chunk: emit dfa_count[state][chunk] symbols from
// dfa_syms[state][chunk][..], then state = dfa_next[state][chunk].
// Tables are flattened: index = (state << k) | chunk.
int64_t huffc_dfa_decode(const uint8_t* dfa_syms, const uint8_t* dfa_count,
                         const int32_t* dfa_next, int32_t maxsym, int32_t k,
                         const uint8_t* data, int64_t bits,
                         uint8_t* out, int64_t out_capacity,
                         int64_t* out_pos, int64_t* out_state) {
    const uint32_t mask = (((uint32_t)1 << k) - 1u);
    int64_t pos = 0, n = 0;
    int64_t state = 0;
    while (pos + k <= bits) {
        int64_t byte = pos >> 3;
        uint32_t window;
        std::memcpy(&window, data + byte, 4);
        uint32_t chunk = (window >> (pos & 7)) & mask;
        int64_t idx = (state << k) | chunk;
        int cnt = dfa_count[idx];
        if (n + cnt > out_capacity) return -4;
        std::memcpy(out + n, dfa_syms + idx * maxsym, (size_t)cnt);
        n += cnt;
        state = dfa_next[idx];
        pos += k;
    }
    *out_pos = pos;      // caller finishes tail bits from *out_state
    *out_state = state;
    return n;
}

// Byte-aligned DFA fast path for k == 8 (mirrors the reference's specialized
// jumpbits==8 loop, jumptableapproach.c:173-258): chunks are whole payload
// bytes, no shifting.
int64_t huffc_dfa_decode_k8(const uint8_t* dfa_syms, const uint8_t* dfa_count,
                            const int32_t* dfa_next, int32_t maxsym,
                            const uint8_t* data, int64_t bits,
                            uint8_t* out, int64_t out_capacity,
                            int64_t* out_pos, int64_t* out_state) {
    int64_t nbytes = bits >> 3;  // only whole bytes; caller handles the tail
    int64_t n = 0, state = 0;
    for (int64_t i = 0; i < nbytes; ++i) {
        int64_t idx = (state << 8) | data[i];
        int cnt = dfa_count[idx];
        if (n + cnt > out_capacity) return -4;
        std::memcpy(out + n, dfa_syms + idx * maxsym, (size_t)cnt);
        n += cnt;
        state = dfa_next[idx];
    }
    *out_pos = nbytes << 3;
    *out_state = state;
    return n;
}

// Variable-width DFA (linApproach semantics, linapproach.c:16-105: subtree
// roots every k levels plus "telescoped" partial-depth roots for subtrees
// shallower than k).  Each state has its own chunk width and a base offset
// into the flat entry arrays.
int64_t huffc_vdfa_decode(const uint8_t* syms, const uint8_t* count,
                          const int32_t* next, const int32_t* base,
                          const int32_t* width, int32_t maxsym,
                          const uint8_t* data, int64_t bits,
                          uint8_t* out, int64_t out_capacity,
                          int64_t* out_pos, int64_t* out_state) {
    int64_t pos = 0, n = 0, state = 0;
    while (true) {
        int32_t w = width[state];
        if (pos + w > bits) break;
        int64_t byte = pos >> 3;
        uint32_t window;
        std::memcpy(&window, data + byte, 4);
        uint32_t chunk = (window >> (pos & 7)) & ((((uint32_t)1) << w) - 1u);
        int64_t idx = base[state] + chunk;
        int cnt = count[idx];
        if (n + cnt > out_capacity) return -4;
        std::memcpy(out + n, syms + idx * maxsym, (size_t)cnt);
        n += cnt;
        state = next[idx];
        pos += w;
    }
    *out_pos = pos;
    *out_state = state;
    return n;
}

// Finish a partial decode bit by bit from bit `pos`, starting mid-walk at
// tree node `node` (pass node=0 for a fresh codeword boundary).
int64_t huffc_tail_decode(const int32_t* tree, int64_t nodes, int64_t node,
                          const uint8_t* data, int64_t pos, int64_t bits,
                          uint8_t* out, int64_t out_capacity) {
    int64_t n = 0;
    while (pos < bits || node != 0) {
        while (tree[node * 3 + 1] != -1) {
            if (pos >= bits) return -2;  // truncated codeword
            int bit = (data[pos >> 3] >> (pos & 7)) & 1;
            node = tree[node * 3 + (bit ? 2 : 1)];
            if (node < 0 || node >= nodes) return -3;
            ++pos;
        }
        if (n >= out_capacity) return -4;
        out[n++] = (uint8_t)tree[node * 3];
        node = 0;
    }
    return n;
}

// Encoder bit-packer: bytes -> LSB-first bitstream using per-symbol
// (code, length) tables.  Returns total bits written.
// `payload` must be zeroed, sized ceil(total_bits/8) + 8.
int64_t huffc_pack_codes(const uint8_t* data, int64_t n,
                         const uint32_t* code, const int32_t* length,
                         uint8_t* payload) {
    uint64_t acc = 0;
    int fill = 0;
    int64_t out = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t s = data[i];
        acc |= ((uint64_t)code[s]) << fill;
        fill += length[s];
        while (fill >= 8) {
            payload[out++] = (uint8_t)(acc & 0xff);
            acc >>= 8;
            fill -= 8;
        }
    }
    if (fill > 0) payload[out] = (uint8_t)(acc & 0xff);
    int64_t total_bits = out * 8 + fill;
    return total_bits;
}

// Truncation scan (setTargetSizes semantics, mainrun.c:361-385): walk the
// stream up to `target_bits`, tracking the last bit position at which a
// codeword completed and how many symbols completed by then.  Writes
// out_vals[0] = exact bit count of the truncated stream (last completed
// bit position + 1), out_vals[1] = completed symbol count.
int64_t huffc_truncate_scan(const int32_t* tree, int64_t nodes,
                            const uint8_t* data, int64_t target_bits,
                            int64_t* out_vals) {
    int64_t pos = 0, node = 0, nsym = 0, lastokay = -1;
    while (pos < target_bits) {
        int bit = (data[pos >> 3] >> (pos & 7)) & 1;
        node = tree[node * 3 + (bit ? 2 : 1)];
        if (node < 0 || node >= nodes) return -3;
        if (tree[node * 3 + 1] == -1) {  // leaf: codeword completed at pos
            ++nsym;
            node = 0;
            lastokay = pos;
        }
        ++pos;
    }
    out_vals[0] = lastokay + 1;
    out_vals[1] = nsym;
    return nsym;
}

// Bandwidth floor (justreaddata, mainrun.c:28-36): sum all payload bytes.
int64_t huffc_sum_bytes(const uint8_t* data, int64_t n) {
    int64_t s = 0;
    for (int64_t i = 0; i < n; ++i) s += data[i];
    return s;
}

}  // extern "C"
