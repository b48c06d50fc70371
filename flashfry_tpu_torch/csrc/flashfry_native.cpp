// Native host-side kernels for flashfry_tpu.
//
// The TPU owns the mismatch scan; these routines cover the serial host work
// around it — genome site scanning, window packing and count merging — which
// the reference does with JVM regexes and sorts (ReferenceEncoder.scala,
// BlockReader.scala). Compiled on demand via g++ and loaded with ctypes
// (see flashfry_tpu/native.py).
//
// Base codes: A=0 C=1 G=2 T=3, 255 = invalid (N etc).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#include <parallel/algorithm>
#endif

namespace {

// does the window starting at i match any pattern? (codes validity handled
// separately by the caller loop)
inline bool window_matches(const uint8_t* codes, int64_t i,
                           int32_t n_pat,
                           const int32_t* pat_starts,
                           const int32_t* pat_offsets,
                           const uint8_t* pat_bases) {
    for (int32_t p = 0; p < n_pat; ++p) {
        bool ok = true;
        for (int32_t k = pat_starts[p]; k < pat_starts[p + 1]; ++k) {
            if (codes[i + pat_offsets[k]] != pat_bases[k]) { ok = false; break; }
        }
        if (ok) return true;
    }
    return false;
}

}  // namespace

extern "C" {

// Scan a contig's code array for scan-window matches.
//
// patterns: n_pat patterns, each with fixed-base constraints given as
//   (offset, base) pairs; pat_starts[p]..pat_starts[p+1] indexes into
//   pat_offsets/pat_bases. A window at i matches pattern p iff all fixed
//   bases match; additionally every base in [i, i+L) must be valid (<4).
// Returns the number of matches written to out (ascending, de-duplicated
// across patterns), or -1 if out_cap was too small.
int64_t ff_scan_sites(const uint8_t* codes, int64_t n, int32_t L,
                      int32_t n_pat,
                      const int32_t* pat_starts,
                      const int32_t* pat_offsets,
                      const uint8_t* pat_bases,
                      int64_t* out, int64_t out_cap) {
    if (n < L) return 0;
    const int64_t n_win = n - L + 1;

    int n_threads = 1;
#ifdef _OPENMP
    n_threads = omp_get_max_threads();
    if ((int64_t)n_threads * 65536 > n_win) n_threads = 1;
#endif

    std::vector<std::vector<int64_t>> hits(n_threads);
    const int64_t chunk = (n_win + n_threads - 1) / n_threads;

#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads) schedule(static, 1)
#endif
    for (int t = 0; t < n_threads; ++t) {
        const int64_t lo = (int64_t)t * chunk;
        const int64_t hi = lo + chunk < n_win ? lo + chunk : n_win;
        if (lo >= hi) continue;
        std::vector<int64_t>& mine = hits[t];
        mine.reserve((hi - lo) / 16 + 16);
        // running count of invalid bases in the current window
        int64_t invalid = 0;
        for (int64_t j = lo; j < lo + L - 1; ++j) invalid += (codes[j] >= 4);
        for (int64_t i = lo; i < hi; ++i) {
            invalid += (codes[i + L - 1] >= 4);
            if (invalid == 0 &&
                window_matches(codes, i, n_pat, pat_starts, pat_offsets, pat_bases))
                mine.push_back(i);
            invalid -= (codes[i] >= 4);
        }
    }

    int64_t count = 0;
    for (int t = 0; t < n_threads; ++t) count += (int64_t)hits[t].size();
    if (count > out_cap) return -1;
    int64_t w = 0;
    for (int t = 0; t < n_threads; ++t) {
        if (!hits[t].empty()) {
            std::memcpy(out + w, hits[t].data(), hits[t].size() * sizeof(int64_t));
            w += (int64_t)hits[t].size();
        }
    }
    return count;
}

// Pack L-base windows starting at `starts` into 2-bit uint64s
// (BitEncoding layout: first base in the highest occupied pair). If rc != 0,
// pack the reverse complement of each window.
void ff_pack_windows(const uint8_t* codes, const int64_t* starts,
                     int64_t n_starts, int32_t L, int32_t rc, uint64_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n_starts > 1 << 16)
#endif
    for (int64_t s = 0; s < n_starts; ++s) {
        const uint8_t* w = codes + starts[s];
        uint64_t enc = 0;
        if (rc) {
            for (int32_t j = L - 1; j >= 0; --j)
                enc = (enc << 2) | (uint64_t)(3 - w[j]);
        } else {
            for (int32_t j = 0; j < L; ++j)
                enc = (enc << 2) | (uint64_t)w[j];
        }
        out[s] = enc;
    }
}

// Merge runs of equal values in a sorted uint64 array.
// Writes unique values to uniq, run lengths to counts; returns #groups.
int64_t ff_group_sorted(const uint64_t* sorted, int64_t n,
                        uint64_t* uniq, int64_t* counts) {
    if (n == 0) return 0;
    int64_t g = 0;
    uniq[0] = sorted[0];
    counts[0] = 1;
    for (int64_t i = 1; i < n; ++i) {
        if (sorted[i] == sorted[i - 1]) {
            counts[g] += 1;
        } else {
            ++g;
            uniq[g] = sorted[i];
            counts[g] = 1;
        }
    }
    return g + 1;
}

// One-pass database construction: sort discovered sites into
// (bin, sequence, discovery-order) order, merge duplicate sequences with
// count saturation, pack genomic positions, and emit the columnar CSR
// layout (targets / positions / pos_offsets / bin_start) directly.
//
// Replaces numpy lexsort + grouping, whose large temporaries are slow on
// first-touch; semantics match database.build_database_from_sites exactly
// (reference: BlockReader.scala:87-135, DatabaseWriter.scala:58-111).
//
// seqs:   low-48-bit packed sequences (no count bits)
// bins:   prefix-bin index per site; must satisfy bins[i] < num_bins <= 2^16
// Position packing follows BitPosition.scala:51-62
// (strand<<60 | length<<52 | contig<<32 | position).
//
// Returns number of unique targets; n_positions_out[0] gets the total kept
// position count. Output capacities: targets/positions/pos_offsets need n
// (+1 for offsets) elements; bin_start needs num_bins+1.
int64_t ff_build_index(const uint64_t* seqs, const int64_t* bins,
                       const int64_t* contig_ids, const int64_t* positions,
                       const uint8_t* forward, int32_t target_length,
                       int64_t n, int64_t num_bins, int64_t max_pos,
                       uint64_t* targets_out, uint64_t* positions_out,
                       int64_t* pos_offsets_out, int64_t* bin_start_out,
                       int64_t* n_positions_out) {
    struct KeyIdx { uint64_t key; int64_t idx; };
    // raw new[]: POD stays uninitialized — std::vector(n) value-initializes,
    // which memsets 6 GB at hg38 scale before the fill loop overwrites it
    std::unique_ptr<KeyIdx[]> vbuf(new KeyIdx[n]);
    KeyIdx* v = vbuf.get();
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 1 << 16)
#endif
    for (int64_t i = 0; i < n; ++i) {
        v[i].key = ((uint64_t)bins[i] << 48) | (seqs[i] & 0xFFFFFFFFFFFFULL);
        v[i].idx = i;
    }
    auto cmp = [](const KeyIdx& a, const KeyIdx& b) {
        return a.key != b.key ? a.key < b.key : a.idx < b.idx;
    };
#ifdef _OPENMP
    __gnu_parallel::sort(v, v + n, cmp);
#else
    std::sort(v, v + n, cmp);
#endif

    std::memset(bin_start_out, 0, sizeof(int64_t) * (num_bins + 1));
    int64_t nt = 0, np = 0;
    pos_offsets_out[0] = 0;
    int64_t i = 0;
    while (i < n) {
        const uint64_t key = v[i].key;
        int64_t j = i;
        while (j < n && v[j].key == key) ++j;
        const int64_t cnt = j - i;
        const int64_t kept = cnt < max_pos ? cnt : max_pos;
        targets_out[nt] = (key & 0xFFFFFFFFFFFFULL) | ((uint64_t)kept << 48);
        for (int64_t k = 0; k < kept; ++k) {
            const int64_t src = v[i + k].idx;
            positions_out[np++] =
                (forward[src] ? 0ULL : (1ULL << 60)) |
                ((uint64_t)target_length << 52) |
                ((uint64_t)contig_ids[src] << 32) |
                (uint64_t)positions[src];
        }
        pos_offsets_out[nt + 1] = np;
        bin_start_out[(key >> 48) + 1] += 1;
        ++nt;
        i = j;
    }
    for (int64_t b = 1; b <= num_bins; ++b) bin_start_out[b] += bin_start_out[b - 1];
    n_positions_out[0] = np;
    return nt;
}

// ---------------------------------------------------------------------------
// Off-target token rendering / parsing (targetio hot paths).
//
// The token grammar is the reference's CRISPRHit.toOutput /
// TabDelimitedHandler parser (crispr/CRISPRHit.scala:54-88,
// targetio/TabDelimitedHandler.scala:278-334):
//   SEQ_count_mismatches[<contig:pos^F|contig:pos^R|...>][{k=v!...}]
// joined per guide with ','. At the paper's 1000-guide x 2000-OT workload
// this is ~2M tokens / ~90 MB of text; a JVM renders that in seconds but a
// per-token CPython loop takes minutes, so both directions are native.
// ---------------------------------------------------------------------------

namespace {

inline char* write_u64_dec(char* p, uint64_t v) {
    char tmp[20];
    int k = 0;
    do { tmp[k++] = char('0' + v % 10); v /= 10; } while (v);
    while (k) *p++ = tmp[--k];
    return p;
}

inline int fold_mismatches(uint64_t a, uint64_t b, uint64_t mask) {
    uint64_t x = (a ^ b) & mask;
    x = (x | (x >> 1)) & 0x5555555555555555ULL;
    return __builtin_popcountll(x);
}

constexpr char kBase[4] = {'A', 'C', 'G', 'T'};
constexpr uint64_t kStringMask = 0xFFFFFFFFFFFFULL;

}  // namespace

// Render every guide's comma-joined OT token section.
//
// hit_start[g]..hit_start[g+1] index this guide's hits in the flat arrays.
// coords/coord_offsets: CSR of packed positions (BitPosition layout) per hit.
// contig_buf/contig_offsets: contig-id -> name table (ids index directly).
// score_buf/score_offsets: optional pre-rendered per-hit "{...}" blocks
// (score_offsets == nullptr when no hit carries scores).
// Writes guide g's section at out[guide_out[g]..guide_out[g+1]); returns the
// total byte count, or -1 if out_cap is too small.
int64_t ff_render_ot_tokens(
    const uint64_t* ot_longs, int64_t n_hits,
    const int64_t* hit_start, int64_t n_guides,
    const uint64_t* guide_longs, uint64_t cmp_mask, int32_t L,
    int32_t write_positions,
    const uint64_t* coords, const int64_t* coord_offsets, const uint8_t* valid,
    const char* contig_buf, const int64_t* contig_offsets, int64_t n_contigs,
    const char* score_buf, const int64_t* score_offsets,
    char* out, int64_t out_cap, int64_t* guide_out) {
    char* p = out;
    char* const end = out + out_cap;
    guide_out[0] = 0;
    for (int64_t g = 0; g < n_guides; ++g) {
        const uint64_t gl = guide_longs[g];
        for (int64_t h = hit_start[g]; h < hit_start[g + 1]; ++h) {
            // worst-case token bound: seq + 2 counts + positions + scores
            int64_t bound = L + 24 + 2;
            const int64_t c0 = coord_offsets[h], c1 = coord_offsets[h + 1];
            if (write_positions && valid[h]) bound += (c1 - c0) * 16;
            if (score_offsets) bound += score_offsets[h + 1] - score_offsets[h];
            if (write_positions && valid[h]) {
                for (int64_t c = c0; c < c1; ++c) {
                    const int64_t cid = (int64_t)((coords[c] >> 32) & 0xFFFFFULL);
                    if (cid >= n_contigs) return -2;
                    bound += contig_offsets[cid + 1] - contig_offsets[cid];
                }
            }
            if (p + bound > end) return -1;

            if (h > hit_start[g]) *p++ = ',';
            const uint64_t seq = ot_longs[h] & kStringMask;
            for (int32_t i = 0; i < L; ++i)
                *p++ = kBase[(seq >> (2 * (L - 1 - i))) & 3];
            *p++ = '_';
            p = write_u64_dec(p, ot_longs[h] >> 48);
            *p++ = '_';
            p = write_u64_dec(p, (uint64_t)fold_mismatches(gl, seq, cmp_mask));
            if (write_positions && valid[h] && c1 > c0) {
                *p++ = '<';
                for (int64_t c = c0; c < c1; ++c) {
                    if (c > c0) *p++ = '|';
                    const uint64_t pc = coords[c];
                    const int64_t cid = (int64_t)((pc >> 32) & 0xFFFFFULL);
                    const int64_t nb = contig_offsets[cid], ne = contig_offsets[cid + 1];
                    std::memcpy(p, contig_buf + nb, ne - nb);
                    p += ne - nb;
                    *p++ = ':';
                    p = write_u64_dec(p, pc & 0xFFFFFFFFULL);
                    *p++ = '^';
                    *p++ = (pc >> 60) ? 'R' : 'F';
                }
                *p++ = '>';
            }
            if (write_positions && score_offsets) {
                const int64_t s0 = score_offsets[h], s1 = score_offsets[h + 1];
                if (s1 > s0) { std::memcpy(p, score_buf + s0, s1 - s0); p += s1 - s0; }
            }
        }
        guide_out[g + 1] = p - out;
    }
    return p - out;
}

// Parse every guide's OT token section back into columnar arrays.
//
// buf: the raw file bytes; guide g's token column is buf[col_beg[g],
// col_end[g]) — ranges may be non-contiguous slices of the original file
// (zero-copy parse; no concatenated column buffer is ever built).
// caps: per-guide overflow cap (<=0 = unlimited); hits are appended while
// the accumulated position count stays below the cap (CRISPRSiteOT.addOT).
// max_mm: drop tokens whose recorded mismatch count exceeds it.
// Score blocks are emitted as (hit index, byte range) into score_hit /
// score_beg / score_end (capacity n_score_cap) for the host to attach.
// Returns number of hits, or -1 (an out capacity too small: caller grows) /
// -2 (grammar/contig error: caller falls back to the host parser).
int64_t ff_parse_ot_tokens(
    const char* buf, const int64_t* col_beg, const int64_t* col_end,
    int64_t n_guides,
    const int64_t* caps, int64_t max_mm, int32_t L,
    const char* contig_buf, const int64_t* contig_offsets, int64_t n_contigs,
    uint64_t* out_longs, uint8_t* out_valid, int64_t n_hit_cap,
    uint64_t* out_coords, int64_t* out_coord_offsets, int64_t n_coord_cap,
    int64_t* hit_start,
    int64_t* score_hit, int64_t* score_beg, int64_t* score_end,
    int64_t n_score_cap, int64_t* n_scores_out) {
    std::unordered_map<std::string, int64_t> contig_ids;
    contig_ids.reserve((size_t)n_contigs * 2);
    for (int64_t c = 0; c < n_contigs; ++c)
        contig_ids.emplace(std::string(contig_buf + contig_offsets[c],
                                       contig_buf + contig_offsets[c + 1]), c);

    int64_t nh = 0, nc = 0, ns = 0;
    out_coord_offsets[0] = 0;
    hit_start[0] = 0;
    uint8_t code_of[256];
    std::memset(code_of, 255, sizeof(code_of));
    code_of['A'] = 0; code_of['C'] = 1; code_of['G'] = 2; code_of['T'] = 3;
    code_of['a'] = 0; code_of['c'] = 1; code_of['g'] = 2; code_of['t'] = 3;

    for (int64_t g = 0; g < n_guides; ++g) {
        const char* p = buf + col_beg[g];
        const char* const ge = buf + col_end[g];
        const int64_t cap = caps[g];
        int64_t current = 0;
        while (p < ge) {
            // SEQ
            uint64_t seq = 0;
            int32_t sl = 0;
            while (p < ge && code_of[(uint8_t)*p] < 4) {
                seq = (seq << 2) | code_of[(uint8_t)*p];
                ++p; ++sl;
            }
            if (sl == 0 || sl > 24 || p >= ge || *p != '_') return -2;
            ++p;
            // count
            uint64_t count = 0;
            while (p < ge && *p >= '0' && *p <= '9') { count = count * 10 + (*p - '0'); ++p; }
            if (count > 32767 || p >= ge || *p != '_') return -2;
            ++p;
            // mismatches
            int64_t mm = 0;
            while (p < ge && *p >= '0' && *p <= '9') { mm = mm * 10 + (*p - '0'); ++p; }

            const bool keep = mm <= max_mm &&
                              !(cap > 0 && current >= cap);
            const bool in_range = mm <= max_mm;
            int64_t n_pos = 0;
            if (p < ge && *p == '<') {
                ++p;
                while (p < ge && *p != '>') {
                    const char* ns_ = p;
                    while (p < ge && *p != ':') ++p;
                    if (p >= ge) return -2;
                    auto it = contig_ids.find(std::string(ns_, p));
                    if (it == contig_ids.end()) return -2;
                    ++p;
                    uint64_t pos = 0;
                    while (p < ge && *p >= '0' && *p <= '9') { pos = pos * 10 + (*p - '0'); ++p; }
                    if (p >= ge || *p != '^') return -2;
                    ++p;
                    if (p >= ge || (*p != 'F' && *p != 'R')) return -2;
                    const uint64_t strand = (*p == 'R') ? (1ULL << 60) : 0ULL;
                    ++p;
                    if (keep) {
                        if (nc >= n_coord_cap) return -1;
                        out_coords[nc++] = strand | ((uint64_t)sl << 52) |
                                           ((uint64_t)it->second << 32) | pos;
                    }
                    ++n_pos;
                    if (p < ge && *p == '|') ++p;
                }
                if (p >= ge) return -2;
                ++p;  // '>'
                if (keep) {
                    if (nh >= n_hit_cap) return -1;
                    out_longs[nh] = seq | (count << 48);
                    out_valid[nh] = 1;
                    out_coord_offsets[nh + 1] = nc;
                    current += n_pos;
                    ++nh;
                }
            } else {
                // no positions: a dummy zero-coordinate per count
                if (keep) {
                    if (nh >= n_hit_cap || nc + (int64_t)count > n_coord_cap) return -1;
                    out_longs[nh] = seq | (count << 48);
                    out_valid[nh] = 0;
                    std::memset(out_coords + nc, 0, sizeof(uint64_t) * count);
                    nc += (int64_t)count;
                    out_coord_offsets[nh + 1] = nc;
                    current += (int64_t)count;
                    ++nh;
                }
            }
            if (p < ge && *p == '{') {
                if (!in_range) return -2;  // reference asserts here
                const char* sb = ++p;
                while (p < ge && *p != '}') ++p;
                if (p >= ge) return -2;
                if (keep) {
                    if (ns >= n_score_cap) return -1;
                    score_hit[ns] = nh - 1;
                    score_beg[ns] = sb - buf;
                    score_end[ns] = p - buf;
                    ++ns;
                }
                ++p;
            }
            if (p < ge) {
                if (*p != ',') return -2;
                ++p;
            }
        }
        hit_start[g + 1] = nh;
    }
    n_scores_out[0] = ns;
    return nh;
}

// Masked per-segment left-fold sum and max over double arrays.
//
// For each segment s (offsets[s]..offsets[s+1]): out_sum[s] = strict
// left-to-right sum of weights[i] where mask[i], out_max[s] = max of
// vals[i] where mask[i] (0 if none selected), out_any[s] = 1 iff any
// selected. The LEFT-FOLD order is the contract: the reference aggregates
// per-OT scores with Scala List.sum (Doench2016CFDScore.scala:79,
// CrisprMitEduOffTarget.scala:103), a sequential fold whose last-ulp
// behavior the formatted output depends on; numpy's pairwise reductions
// would diverge.
void ff_segment_fold_f64(const double* vals, const double* weights,
                         const uint8_t* mask, const int64_t* offsets,
                         int64_t n_segments,
                         double* out_sum, double* out_max,
                         uint8_t* out_any) {
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static)
    #endif
    for (int64_t s = 0; s < n_segments; ++s) {
        double acc = 0.0;
        double mx = 0.0;
        uint8_t any = 0;
        for (int64_t i = offsets[s]; i < offsets[s + 1]; ++i) {
            if (mask[i]) {
                acc += weights[i];
                if (!any || vals[i] > mx) mx = vals[i];
                any = 1;
            }
        }
        out_sum[s] = acc;
        out_max[s] = mx;
        out_any[s] = any;
    }
}

// Discover-phase hit collection: group the scan's (target, guide) hit
// stream by guide preserving arrival order (global target-major per guide
// — the order FlashFry applies hits in), apply the overflow-cap accept
// rule, and assemble the accepted hits' packed target longs plus the
// flattened genomic-coordinate lists (global CSR) in one pass.
//
// Cap semantics == CRISPRSiteOT.addOT (crispr/CRISPRSiteOT.scala:41-46):
// a hit is accepted iff the guide's accumulated genomic-position count
// BEFORE it is below the cap (cap <= 0 = unlimited); the position count
// accumulates over every prior hit, which equals the reference's
// accept-while-not-full rule because rejection is terminal.
//
// pos_offsets/positions/targets may point into memory-mapped database
// files. Returns the total accepted coordinate count; if it exceeds
// coords_cap nothing is filled and -(needed) is returned so the caller
// can retry with an exact allocation.
int64_t ff_collect_hits(const int64_t* t, const int64_t* g, int64_t n,
                        const int64_t* pos_offsets, const uint64_t* positions,
                        const uint64_t* targets,
                        const int64_t* caps, int64_t n_guides,
                        int64_t* hit_start,      // (n_guides+1) accepted CSR
                        uint64_t* out_longs,     // capacity n
                        int64_t* coord_offsets,  // capacity n+1, global CSR
                        uint64_t* out_coords, int64_t coords_cap) {
    // stable counting-scatter: tg = targets grouped by guide
    std::vector<int64_t> seg(n_guides + 1, 0);
    for (int64_t i = 0; i < n; ++i) seg[g[i] + 1]++;
    for (int64_t q = 0; q < n_guides; ++q) seg[q + 1] += seg[q];
    std::vector<int64_t> tg(n);
    {
        std::vector<int64_t> w(seg.begin(), seg.end() - 1);
        for (int64_t i = 0; i < n; ++i) tg[w[g[i]]++] = t[i];
    }
    // count pass: accepted hits + accepted coords per guide
    std::vector<int64_t> acc_n(n_guides), acc_c(n_guides);
    #ifdef _OPENMP
    #pragma omp parallel for schedule(dynamic, 256)
    #endif
    for (int64_t q = 0; q < n_guides; ++q) {
        const int64_t cap = caps[q];
        int64_t current = 0, na = 0, nc = 0;
        for (int64_t i = seg[q]; i < seg[q + 1]; ++i) {
            const int64_t tt = tg[i];
            const int64_t c = pos_offsets[tt + 1] - pos_offsets[tt];
            if (cap <= 0 || current < cap) { ++na; nc += c; }
            current += c;
        }
        acc_n[q] = na;
        acc_c[q] = nc;
    }
    hit_start[0] = 0;
    int64_t coords_total = 0;
    std::vector<int64_t> cbase(n_guides);
    for (int64_t q = 0; q < n_guides; ++q) {
        hit_start[q + 1] = hit_start[q] + acc_n[q];
        cbase[q] = coords_total;
        coords_total += acc_c[q];
    }
    if (coords_total > coords_cap) return -coords_total;
    // fill pass
    coord_offsets[0] = 0;
    #ifdef _OPENMP
    #pragma omp parallel for schedule(dynamic, 256)
    #endif
    for (int64_t q = 0; q < n_guides; ++q) {
        const int64_t cap = caps[q];
        int64_t current = 0;
        int64_t h = hit_start[q];
        int64_t co = cbase[q];
        for (int64_t i = seg[q]; i < seg[q + 1]; ++i) {
            const int64_t tt = tg[i];
            const int64_t b = pos_offsets[tt], e = pos_offsets[tt + 1];
            const int64_t c = e - b;
            if (cap <= 0 || current < cap) {
                out_longs[h] = targets[tt];
                std::memcpy(out_coords + co, positions + b,
                            (size_t)c * sizeof(uint64_t));
                co += c;
                coord_offsets[++h] = co;
            }
            current += c;
        }
    }
    return coords_total;
}

// Elementwise masked mismatch counts over packed 2-bit encodings
// (BitEncoding.scala:127-132: XOR, mask, fold bit pairs, popcount).
//
// The numpy SWAR chain allocates ~9 fresh full-size temporaries per call;
// on hosts with slow first-touch page faults that dominates (measured:
// 13 s for 18M pairs vs <0.2 s here). b is indexed by gi when given
// (out[i] = mm(a[i], b[gi[i]])) so the caller skips materializing the
// gather too; gi == null means elementwise b[i].
int64_t ff_mismatches(const uint64_t* a, const uint64_t* b,
                      const int64_t* gi, int64_t n, uint64_t mask,
                      uint8_t* out) {
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static) if (n > 1 << 16)
    #endif
    for (int64_t i = 0; i < n; ++i) {
        uint64_t x = (a[i] ^ (gi ? b[gi[i]] : b[i])) & mask;
        x = (x | (x >> 1)) & 0x5555555555555555ULL;
        out[i] = (uint8_t)__builtin_popcountll(x);
    }
    return 0;
}

// Batched per-off-target activity scores: Doench 2016 CFD, Hsu 2013 and
// Jost&Santos, fused into one pass over the flat OT array.
//
// This is the host fast path of the scoring layer (reference walks each OT
// string character by character, Doench2016CFDScore.scala:132-151,
// CrisprMitEduOffTarget.scala:107-148, JostAndSantosCRISPRi.scala:92-127);
// any model pointer may be null to skip that column. BIT-EXACT parity
// contract with the numpy oracle: every per-OT product is accumulated in
// strict left-to-right position order (numpy's multiply.reduce order, 1.0
// factors included), and the Hsu sub-expressions follow the oracle's exact
// operation order — formatted doubles depend on the last ulp.
//
// flat:   n packed off-target longs (count in bits 48+, sequence low 48);
// gi:     n guide indices into glongs;
// glongs: n_guides packed guide longs; L: scan length (bases);
// act_pos/act_n: enzyme comparison-mask positions (PAM excluded) — differs
//   is the "any mismatch at active positions" flag all three models select
//   on (equals mismatches(flat, guide) != 0 under the enzyme mask);
// cfd_mm: (4 guide, 4 ot, 20 pos) activity, identity=1.0; cfd_pam: (4,4)
//   by the last two PAM bases; hsu_one_minus: (hsu_gs,) 1-coeff;
//   hsu_pam: (4,4); jost_tab: (19 pos, 4 ot, 4 guide), jost_lo = first
//   sequence position keyed as position 1.
// Returns 0.
int64_t ff_score_ots(const uint64_t* flat, const int64_t* gi, int64_t n,
                     const uint64_t* glongs, int64_t n_guides, int32_t L,
                     const int32_t* act_pos, int32_t act_n,
                     const double* cfd_mm, const double* cfd_pam,
                     const double* hsu_one_minus, const double* hsu_pam,
                     int32_t hsu_gs,
                     const double* jost_tab, int32_t jost_lo,
                     double* cfd_out, double* hsu_out, double* jost_out,
                     uint8_t* differs_out) {
    const uint64_t kSeqMask = 0xFFFFFFFFFFFFULL;
    // decode every guide once: gcode[g][p] = base code at position p
    std::vector<uint8_t> gcodes((size_t)n_guides * L);
    for (int64_t g = 0; g < n_guides; ++g) {
        uint64_t s = glongs[g] & kSeqMask;
        for (int32_t p = 0; p < L; ++p)
            gcodes[(size_t)g * L + p] =
                (uint8_t)((s >> (2 * (L - 1 - p))) & 3);
    }
    #ifdef _OPENMP
    #pragma omp parallel for schedule(static)
    #endif
    for (int64_t i = 0; i < n; ++i) {
        uint64_t s = flat[i] & kSeqMask;
        uint8_t oc[32];
        for (int32_t p = 0; p < L; ++p)
            oc[p] = (uint8_t)((s >> (2 * (L - 1 - p))) & 3);
        const uint8_t* gc = &gcodes[(size_t)gi[i] * L];
        uint8_t differs = 0;
        for (int32_t k = 0; k < act_n; ++k)
            if (oc[act_pos[k]] != gc[act_pos[k]]) { differs = 1; break; }
        differs_out[i] = differs;
        if (cfd_mm) {
            double acc = 1.0;
            for (int32_t p = 0; p < 20; ++p)
                acc = acc * cfd_mm[((size_t)gc[p] * 4 + oc[p]) * 20 + p];
            // pam FIRST then candidate product (score = pam * cand, the
            // oracle's multiply order)
            cfd_out[i] = cfd_pam[(size_t)oc[L - 2] * 4 + oc[L - 1]] * acc;
        }
        if (hsu_one_minus) {
            int32_t mmc = 0, first = 0, last = hsu_gs - 1;
            double p1 = 1.0;
            for (int32_t p = 0; p < hsu_gs; ++p) {
                bool m = oc[p] != gc[p];
                if (m) {
                    if (!mmc) first = p;
                    last = p;
                    ++mmc;
                }
                p1 = p1 * (m ? hsu_one_minus[p] : 1.0);
            }
            // no-mismatch rows keep (first=0, last=hsu_gs-1) — the oracle's
            // argmax-of-all-false quirk — but mmc<2 forces p2=p3=1.0 anyway
            double avg_dist =
                (double)(last - first) / (double)(mmc - 1 > 1 ? mmc - 1 : 1);
            double p2 = mmc < 2
                ? 1.0
                : 1.0 / ((((19.0 - avg_dist) / 19.0) * 4.0) + 1.0);
            double mmf = (double)mmc;
            double p3 = mmc == 0 ? 1.0 : 1.0 / (mmf * mmf);
            double total = p1 * p2 * p3 * 100.0;
            hsu_out[i] = total * hsu_pam[(size_t)oc[L - 2] * 4 + oc[L - 1]];
        }
        if (jost_tab) {
            double acc = 1.0;
            for (int32_t p = 0; p < 19; ++p)
                acc = acc * jost_tab[((size_t)p * 4 + oc[jost_lo + p]) * 4 +
                                     gc[jost_lo + p]];
            jost_out[i] = acc;
        }
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// RNA MFE folding (Zuker DP over the Turner-1999 / ViennaRNA-1.8.x model)
// ---------------------------------------------------------------------------
//
// Native port of scoring/rnafold.py::fold_mfe (which is the golden-tested
// source of truth; the energy tables are passed in as one flat int32 blob
// built by _params_blob() so the two implementations can never drift on
// constants). Covers the reference's `folding` metric (RNAFold4j.scala:61-74)
// at batch scale: ~1 ms/guide in pure Python vs ~10 us here, OpenMP-parallel
// over sequences.

namespace rnafold {

constexpr int INF_E = 10000000;
constexpr int MAXLOOP = 30;
constexpr int MAXN = 64;
constexpr int RF_MAGIC = 0x52464031;  // "RF@1"

struct Params {
    int32_t term_au, ml_closing, ml_intern, ml_base, ninio, max_ninio, n_tetra;
    double lxc;
    const int32_t *stack, *hairpin, *bulge, *internal_, *mmh, *mmi, *d5, *d3;
    const int32_t *int11, *int21, *int22, *tetra;
};

inline bool parse_params(const int32_t* q, Params* P) {
    if (q[0] != RF_MAGIC) return false;
    P->term_au = q[1]; P->ml_closing = q[2]; P->ml_intern = q[3];
    P->ml_base = q[4]; P->ninio = q[5]; P->max_ninio = q[6];
    P->lxc = q[7] / 1e6;
    P->n_tetra = q[8];
    const int32_t* cur = q + 10;
    P->stack = cur;     cur += 7 * 7;
    P->hairpin = cur;   cur += 31;
    P->bulge = cur;     cur += 31;
    P->internal_ = cur; cur += 31;
    P->mmh = cur;       cur += 7 * 5 * 5;
    P->mmi = cur;       cur += 7 * 5 * 5;
    P->d5 = cur;        cur += 7 * 5;
    P->d3 = cur;        cur += 7 * 5;
    // int tables are 8x8 in pair type (ViennaRNA NBPAIRS+1, incl. the
    // unused "non-standard" type 7), matching data/rnafold_int.json
    P->int11 = cur;     cur += 8 * 8 * 5 * 5;
    P->int21 = cur;     cur += 8 * 8 * 5 * 5 * 5;
    P->int22 = cur;     cur += 8 * 8 * 5 * 5 * 5 * 5;
    P->tetra = cur;     // n_tetra * 7 (6 base codes + bonus)
    return true;
}

const int RTYPE[7] = {0, 2, 1, 4, 3, 6, 5};

inline int extrap(const int32_t* tab, int size, const Params& P) {
    if (size <= MAXLOOP) return tab[size];
    return tab[MAXLOOP] + (int)(P.lxc * std::log(size / 30.0));
}

// hairpin closed by 1-based pair (i, j) of type t
inline int hairpinE(int i, int j, int t, const uint8_t* s, const Params& P) {
    int size = j - i - 1;
    int e = extrap(P.hairpin, size, P);
    if (size == 4) {
        // tetraloop 6-mer starts at the 5' closing base: s[i..i+5]
        for (int k = 0; k < P.n_tetra; ++k) {
            const int32_t* ent = P.tetra + k * 7;
            bool m = true;
            for (int b = 0; b < 6; ++b)
                if (ent[b] != (int32_t)s[i + b]) { m = false; break; }
            if (m) { e += ent[6]; break; }
        }
    }
    if (size == 3) {
        if (t > 2) e += P.term_au;
    } else {
        e += P.mmh[(t * 5 + s[i + 1]) * 5 + s[j - 1]];
    }
    return e;
}

// stack/bulge/interior between pair of type t and inner pair of REVERSED
// type t2; n1/n2 unpaired 5'/3'; si1..sq1 = mismatch bases
inline int loopE(int n1, int n2, int t, int t2, int si1, int sj1, int sp1,
                 int sq1, const Params& P) {
    int nl = n1 > n2 ? n1 : n2, ns = n1 > n2 ? n2 : n1;
    if (nl == 0) return P.stack[t * 7 + t2];
    if (ns == 0) {  // bulge
        int e = extrap(P.bulge, nl, P);
        if (nl == 1) e += P.stack[t * 7 + t2];
        else {
            if (t > 2) e += P.term_au;
            if (t2 > 2) e += P.term_au;
        }
        return e;
    }
    if (ns == 1) {
        if (nl == 1) return P.int11[((t * 8 + t2) * 5 + si1) * 5 + sj1];
        if (nl == 2) {
            if (n1 == 1)
                return P.int21[(((t * 8 + t2) * 5 + si1) * 5 + sq1) * 5 + sj1];
            return P.int21[(((t2 * 8 + t) * 5 + sq1) * 5 + si1) * 5 + sp1];
        }
    } else if (n1 == 2 && n2 == 2) {
        return P.int22[((((t * 8 + t2) * 5 + si1) * 5 + sp1) * 5 + sq1) * 5 + sj1];
    }
    int e = extrap(P.internal_, n1 + n2, P);
    int d = (nl - ns) * P.ninio;
    e += d < P.max_ninio ? d : P.max_ninio;
    e += P.mmi[(t * 5 + si1) * 5 + sj1] + P.mmi[(t2 * 5 + sq1) * 5 + sp1];
    return e;
}

// pair-type code for (a, b): CG=1 GC=2 GU=3 UG=4 AU=5 UA=6, else 0
inline int pair_of(int a, int b) {
    if (a == 2 && b == 3) return 1;
    if (a == 3 && b == 2) return 2;
    if (a == 3 && b == 4) return 3;
    if (a == 4 && b == 3) return 4;
    if (a == 1 && b == 4) return 5;
    if (a == 4 && b == 1) return 6;
    return 0;
}

// One sequence's MFE in 10 cal/mol. s0 = 0-based codes (0=N,1=A,2=C,3=G,4=U).
// A line-for-line translation of rnafold.py::fold_mfe (see its docstring for
// the model; dangles=1 conditional model, dangles=2 unconditional).
inline int fold_one(const uint8_t* s0, int n, int dangles, const Params& P) {
    if (n < 5) return 0;
    uint8_t s[MAXN + 2];
    s[0] = 0;
    for (int i = 0; i < n; ++i) s[i + 1] = s0[i];
    s[n + 1] = 0;

    static thread_local uint8_t ptype[MAXN + 1][MAXN + 1];
    static thread_local int c[MAXN + 1][MAXN + 1];
    static thread_local int fml[MAXN + 1][MAXN + 1];
    static thread_local int fm1[MAXN + 1][MAXN + 1];
    for (int i = 1; i <= n; ++i)
        for (int j = 1; j <= n; ++j) {
            ptype[i][j] = (uint8_t)(j > i ? pair_of(s[i], s[j]) : 0);
            c[i][j] = fml[i][j] = fm1[i][j] = INF_E;
        }

    for (int span = 4; span < n; ++span) {
        for (int i = 1; i <= n - span; ++i) {
            int j = i + span;
            int t = ptype[i][j];
            if (t) {
                int e = hairpinE(i, j, t, s, P);
                int pmax = std::min(i + MAXLOOP + 2, j - 4);
                for (int p = i + 1; p <= pmax; ++p) {
                    int n1 = p - i - 1;
                    int qmin = std::max(p + 4, j - 1 - (MAXLOOP - n1));
                    for (int q = qmin; q < j; ++q) {
                        int t2 = ptype[p][q];
                        if (!t2) continue;
                        int e2 = loopE(n1, j - q - 1, t, RTYPE[t2],
                                       s[i + 1], s[j - 1], s[p - 1], s[q + 1], P);
                        if (e2 + c[p][q] < e) e = e2 + c[p][q];
                    }
                }
                // multiloop closing
                int tt = RTYPE[t];
                int close_au = tt > 2 ? P.term_au : 0;
                for (int u = i + 1; u < j - 1; ++u) {
                    int base = fml[i + 1][u] + fm1[u + 1][j - 1];
                    if (base < INF_E) {
                        int e_ml = base + P.ml_closing + P.ml_intern + close_au;
                        if (dangles == 2)
                            e_ml += P.d3[tt * 5 + s[i + 1]] + P.d5[tt * 5 + s[j - 1]];
                        if (e_ml < e) e = e_ml;
                    }
                    if (dangles == 1) {
                        if (i + 2 <= u && fml[i + 2][u] + fm1[u + 1][j - 1] < INF_E) {
                            int b2 = fml[i + 2][u] + fm1[u + 1][j - 1] +
                                     P.ml_closing + P.ml_intern + close_au +
                                     P.ml_base + P.d3[tt * 5 + s[i + 1]];
                            if (b2 < e) e = b2;
                        }
                        if (u + 1 <= j - 2 && fml[i + 1][u] + fm1[u + 1][j - 2] < INF_E) {
                            int b3 = fml[i + 1][u] + fm1[u + 1][j - 2] +
                                     P.ml_closing + P.ml_intern + close_au +
                                     P.ml_base + P.d5[tt * 5 + s[j - 1]];
                            if (b3 < e) e = b3;
                        }
                        if (i + 2 <= u && u + 1 <= j - 2 &&
                            fml[i + 2][u] + fm1[u + 1][j - 2] < INF_E) {
                            int b4 = fml[i + 2][u] + fm1[u + 1][j - 2] +
                                     P.ml_closing + P.ml_intern + close_au +
                                     2 * P.ml_base + P.d3[tt * 5 + s[i + 1]] +
                                     P.d5[tt * 5 + s[j - 1]];
                            if (b4 < e) e = b4;
                        }
                    }
                }
                c[i][j] = e;
            }

            // fm1: exactly one multiloop branch with 5' end at i
            {
                int e = fm1[i][j - 1] < INF_E ? fm1[i][j - 1] + P.ml_base : INF_E;
                int tb = ptype[i][j];
                if (tb) {
                    int eb = c[i][j] + P.ml_intern + (tb > 2 ? P.term_au : 0);
                    if (dangles == 2)
                        eb += P.d5[tb * 5 + s[i - 1]] +
                              P.d3[tb * 5 + (j < n ? s[j + 1] : 0)];
                    if (eb < e) e = eb;
                }
                fm1[i][j] = e;
            }

            // fml: >=1 branch in [i, j]; ml_branch inlined below
            {
                int e = fml[i + 1][j] < INF_E ? fml[i + 1][j] + P.ml_base : INF_E;
                if (fml[i][j - 1] < INF_E && fml[i][j - 1] + P.ml_base < e)
                    e = fml[i][j - 1] + P.ml_base;
                int t2 = ptype[i][j];
                if (t2) {
                    int eb = c[i][j] + P.ml_intern + (t2 > 2 ? P.term_au : 0);
                    if (dangles == 2)
                        eb += P.d5[t2 * 5 + s[i - 1]] +
                              P.d3[t2 * 5 + (j < n ? s[j + 1] : 0)];
                    if (eb < e) e = eb;
                }
                if (dangles == 1) {
                    int ta = i + 1 < j ? ptype[i + 1][j] : 0;
                    if (ta) {
                        int eb = c[i + 1][j] + P.ml_intern + P.ml_base +
                                 (ta > 2 ? P.term_au : 0) + P.d5[ta * 5 + s[i]];
                        if (eb < e) e = eb;
                    }
                    ta = i < j - 1 ? ptype[i][j - 1] : 0;
                    if (ta) {
                        int eb = c[i][j - 1] + P.ml_intern + P.ml_base +
                                 (ta > 2 ? P.term_au : 0) + P.d3[ta * 5 + s[j]];
                        if (eb < e) e = eb;
                    }
                    ta = i + 1 < j - 1 ? ptype[i + 1][j - 1] : 0;
                    if (ta) {
                        int eb = c[i + 1][j - 1] + P.ml_intern + 2 * P.ml_base +
                                 (ta > 2 ? P.term_au : 0) +
                                 P.d5[ta * 5 + s[i]] + P.d3[ta * 5 + s[j]];
                        if (eb < e) e = eb;
                    }
                }
                for (int u = i + 4; u < j - 4; ++u) {
                    if (fml[i][u] < INF_E && fml[u + 1][j] < INF_E &&
                        fml[i][u] + fml[u + 1][j] < e)
                        e = fml[i][u] + fml[u + 1][j];
                }
                fml[i][j] = e;
            }
        }
    }

    // exterior loop
    int f5[MAXN + 1];
    for (int k = 0; k <= n; ++k) f5[k] = 0;
    for (int j = 5; j <= n; ++j) {
        int best = f5[j - 1];
        for (int i = 1; i < j - 3; ++i) {
            int prev = f5[i - 1];
            int t = ptype[i][j];
            if (t && c[i][j] < INF_E) {
                int e = prev + c[i][j] + (t > 2 ? P.term_au : 0);
                if (dangles == 2)
                    e += (i > 1 ? P.d5[t * 5 + s[i - 1]] : 0) +
                         (j < n ? P.d3[t * 5 + s[j + 1]] : 0);
                if (e < best) best = e;
            }
            if (dangles == 1) {
                t = i + 1 < j ? ptype[i + 1][j] : 0;
                if (t && c[i + 1][j] < INF_E) {
                    int e = prev + c[i + 1][j] + (t > 2 ? P.term_au : 0) +
                            P.d5[t * 5 + s[i]];
                    if (e < best) best = e;
                }
                t = i < j - 1 ? ptype[i][j - 1] : 0;
                if (t && c[i][j - 1] < INF_E) {
                    int e = prev + c[i][j - 1] + (t > 2 ? P.term_au : 0) +
                            P.d3[t * 5 + s[j]];
                    if (e < best) best = e;
                }
                t = i + 1 < j - 1 ? ptype[i + 1][j - 1] : 0;
                if (t && c[i + 1][j - 1] < INF_E) {
                    int e = prev + c[i + 1][j - 1] + (t > 2 ? P.term_au : 0) +
                            P.d5[t * 5 + s[i]] + P.d3[t * 5 + s[j]];
                    if (e < best) best = e;
                }
            }
        }
        f5[j] = best;
    }
    return f5[n];
}

}  // namespace rnafold

extern "C" {

// Batch MFE fold. seqs: concatenated base codes (0=N,1=A,2=C,3=G,4=U),
// sequence k at [offsets[k], offsets[k+1]). out[k] = MFE in 10 cal/mol.
// Returns 0, or -1 on bad params magic, -2 if any sequence exceeds MAXN
// (caller falls back to the Python fold).
int64_t ff_rnafold_mfe_batch(const int32_t* params, const uint8_t* seqs,
                             const int64_t* offsets, int64_t n_seqs,
                             int32_t dangles, int32_t* out) {
    rnafold::Params P;
    if (!rnafold::parse_params(params, &P)) return -1;
    for (int64_t k = 0; k < n_seqs; ++k)
        if (offsets[k + 1] - offsets[k] > rnafold::MAXN) return -2;
    #ifdef _OPENMP
    #pragma omp parallel for schedule(dynamic, 64)
    #endif
    for (int64_t k = 0; k < n_seqs; ++k) {
        out[k] = rnafold::fold_one(seqs + offsets[k],
                                   (int)(offsets[k + 1] - offsets[k]),
                                   dangles, P);
    }
    return 0;
}

}  // extern "C"
