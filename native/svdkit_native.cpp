/*
 * svdkit_native: native data-plane kernels for svdfeature_tpu.
 *
 * The reference's runtime I/O layer is C++ (text loaders in
 * apex_svd_data.cpp, producer-thread prefetch in apex_buffer_loader.h);
 * this library is its counterpart here: the host-side hot paths
 * (text parsing into 3-segment CSR, padded batch packing) implemented in
 * C++ and exposed through a plain C ABI for ctypes.  Pure-numpy fallbacks
 * exist for every entry point (svdfeature_tpu/data/native.py).
 *
 * Build: make -C native   (produces libsvdkit_native.so)
 */

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <cstdio>

namespace {

// minimal fast float parser for the feature-file token stream; falls back
// to strtod for exotic forms (exponents handled there)
inline const char *skip_ws(const char *p, const char *end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
    return p;
}

inline const char *parse_double(const char *p, const char *end, double *out) {
    p = skip_ws(p, end);
    if (p >= end) return nullptr;
    bool neg = false;
    if (*p == '-') { neg = true; ++p; }
    else if (*p == '+') ++p;
    double v = 0.0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10.0 + (*p - '0'); ++p; any = true; }
    if (p < end && *p == '.') {
        ++p;
        double scale = 0.1;
        while (p < end && *p >= '0' && *p <= '9') { v += (*p - '0') * scale; scale *= 0.1; ++p; any = true; }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        // rare path: exponent
        ++p;
        int es = 1, ev = 0;
        if (p < end && (*p == '-' || *p == '+')) { if (*p == '-') es = -1; ++p; }
        while (p < end && *p >= '0' && *p <= '9') { ev = ev * 10 + (*p - '0'); ++p; }
        v = v * pow(10.0, es * ev);
    }
    if (!any) return nullptr;
    *out = neg ? -v : v;
    return p;
}

}  // namespace

extern "C" {

// Pass 1: count rows and total nnz of the feature text format
// ``label ng nu ni idx:val ...`` (free whitespace token stream, ':' treated
// as whitespace).  Returns 0 on success.
int count_feature_text(const char *buf, int64_t len, int64_t *num_row, int64_t *num_val) {
    const char *p = buf, *end = buf + len;
    int64_t rows = 0, vals = 0;
    double label, ng, nu, ni, tmp;
    while (true) {
        const char *q = parse_double(p, end, &label);
        if (!q) break;
        q = parse_double(q, end, &ng);
        if (!q) return 1;
        q = parse_double(q, end, &nu);
        if (!q) return 1;
        q = parse_double(q, end, &ni);
        if (!q) return 1;
        int64_t tot = (int64_t)ng + (int64_t)nu + (int64_t)ni;
        for (int64_t i = 0; i < 2 * tot; ++i) {
            // idx:val -> ':' needs skipping
            const char *r = q;
            r = skip_ws(r, end);
            if (r < end && *r == ':') ++r;
            r = parse_double(r, end, &tmp);
            if (!r) return 1;
            q = r;
        }
        rows += 1;
        vals += tot;
        p = q;
    }
    *num_row = rows;
    *num_val = vals;
    return 0;
}

// Pass 2: fill labels [R], seg_counts [R*3], index [V] (u32), value [V]
int parse_feature_text(const char *buf, int64_t len, double scale_score,
                       float *labels, int32_t *seg_counts,
                       uint32_t *index, float *value) {
    const char *p = buf, *end = buf + len;
    int64_t r = 0, v = 0;
    double label, ng, nu, ni, iv, vv;
    double inv_scale = 1.0 / scale_score;
    while (true) {
        const char *q = parse_double(p, end, &label);
        if (!q) break;
        q = parse_double(q, end, &ng);
        q = parse_double(q, end, &nu);
        q = parse_double(q, end, &ni);
        if (!q) return 1;
        labels[r] = (float)(label * inv_scale);
        seg_counts[r * 3 + 0] = (int32_t)ng;
        seg_counts[r * 3 + 1] = (int32_t)nu;
        seg_counts[r * 3 + 2] = (int32_t)ni;
        int64_t tot = (int64_t)ng + (int64_t)nu + (int64_t)ni;
        for (int64_t i = 0; i < tot; ++i) {
            q = parse_double(q, end, &iv);
            if (!q) return 1;
            const char *s = skip_ws(q, end);
            if (s < end && *s == ':') ++s;
            s = parse_double(s, end, &vv);
            if (!s) return 1;
            q = s;
            index[v] = (uint32_t)iv;
            value[v] = (float)vv;
            ++v;
        }
        ++r;
        p = q;
    }
    return 0;
}

// Parse the user-feedback file: records ``nline nfeedback idx:val ...``.
// Pass 1 counts records and total feedback entries.
int count_feedback_text(const char *buf, int64_t len, int64_t *num_rec, int64_t *num_fb) {
    const char *p = buf, *end = buf + len;
    int64_t recs = 0, fbs = 0;
    double nline, nfb, tmp;
    while (true) {
        const char *q = parse_double(p, end, &nline);
        if (!q) break;
        q = parse_double(q, end, &nfb);
        if (!q) return 1;
        int64_t n = (int64_t)nfb;
        for (int64_t i = 0; i < 2 * n; ++i) {
            const char *r = skip_ws(q, end);
            if (r < end && *r == ':') ++r;
            r = parse_double(r, end, &tmp);
            if (!r) return 1;
            q = r;
        }
        recs += 1;
        fbs += n;
        p = q;
    }
    *num_rec = recs;
    *num_fb = fbs;
    return 0;
}

// Pass 2: nlines [Nrec], fb_counts [Nrec], fb_index [F], fb_value [F]
int parse_feedback_text(const char *buf, int64_t len,
                        int32_t *nlines, int32_t *fb_counts,
                        uint32_t *fb_index, float *fb_value) {
    const char *p = buf, *end = buf + len;
    int64_t r = 0, v = 0;
    double nline, nfb, iv, vv;
    while (true) {
        const char *q = parse_double(p, end, &nline);
        if (!q) break;
        q = parse_double(q, end, &nfb);
        if (!q) return 1;
        nlines[r] = (int32_t)nline;
        fb_counts[r] = (int32_t)nfb;
        int64_t n = (int64_t)nfb;
        for (int64_t i = 0; i < n; ++i) {
            q = parse_double(q, end, &iv);
            if (!q) return 1;
            const char *s = skip_ws(q, end);
            if (s < end && *s == ':') ++s;
            s = parse_double(s, end, &vv);
            if (!s) return 1;
            q = s;
            fb_index[v] = (uint32_t)iv;
            fb_value[v] = (float)vv;
            ++v;
        }
        ++r;
        p = q;
    }
    return 0;
}

// Pad one CSR segment into [R, S] index/value arrays (dummy-filled), the
// inner loop of batch packing.
void pad_segment(const int64_t *starts, const int64_t *counts, int64_t num_row,
                 const uint32_t *index, const float *value, int64_t off,
                 int64_t S, int64_t dummy, int32_t *out_idx, float *out_val) {
    for (int64_t r = 0; r < num_row; ++r) {
        const int64_t st = starts[r], n = counts[r];
        int32_t *oi = out_idx + r * S;
        float *ov = out_val + r * S;
        int64_t i = 0;
        for (; i < n; ++i) {
            oi[i] = (int32_t)(index[st + i] + off);
            ov[i] = value[st + i];
        }
        for (; i < S; ++i) {
            oi[i] = (int32_t)dummy;
            ov[i] = 0.0f;
        }
    }
}

// Batched per-block Fisher-Yates permutations for the pairwise-rank
// sampler (data/rank.sample_offsets): `rounds` independent uniform
// permutations of each block's candidate set, written as block-LOCAL
// offsets in block-contiguous candidate order ([rounds, total], uint16
// when elem16 else int32).  O(total) per round vs the numpy argsort
// fallback's O(total log total) with large constants — this is what
// keeps the one-ahead producer thread ahead of the device epoch.
void block_shuffle(void *out, int32_t elem16, const int64_t *block_sizes,
                   int64_t nblocks, int64_t rounds, uint64_t seed) {
    // splitmix64 stream; Lemire bounded rand (rejection-free 64->32 mix
    // bias is < 2^-32 for block sizes < 2^16 — far below any observable
    // effect at these scales)
    uint64_t s = seed ? seed : 0x9e3779b97f4a7c15ULL;
    auto next = [&s]() {
        uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
        return z ^ (z >> 31);
    };
    int64_t total = 0;
    for (int64_t b = 0; b < nblocks; ++b) total += block_sizes[b];
    for (int64_t r = 0; r < rounds; ++r) {
        if (elem16) {
            uint16_t *o = (uint16_t *)out + r * total;
            for (int64_t b = 0; b < nblocks; ++b) {
                const int64_t n = block_sizes[b];
                for (int64_t i = 0; i < n; ++i) o[i] = (uint16_t)i;
                for (int64_t i = n - 1; i > 0; --i) {
                    uint64_t j = ((next() >> 32) * (uint64_t)(i + 1)) >> 32;
                    uint16_t t = o[i]; o[i] = o[j]; o[j] = t;
                }
                o += n;
            }
        } else {
            int32_t *o = (int32_t *)out + r * total;
            for (int64_t b = 0; b < nblocks; ++b) {
                const int64_t n = block_sizes[b];
                for (int64_t i = 0; i < n; ++i) o[i] = (int32_t)i;
                for (int64_t i = n - 1; i > 0; --i) {
                    uint64_t j = ((next() >> 32) * (uint64_t)(i + 1)) >> 32;
                    int32_t t = o[i]; o[i] = o[j]; o[j] = t;
                }
                o += n;
            }
        }
    }
}

}  // extern "C"
