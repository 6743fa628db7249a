/* Native host runtime for imsame_tpu.
 *
 * The device does the alignment math; these routines are the host side of the
 * pipeline -- index construction and candidate-stream expansion -- where the
 * reference spends its single-threaded C time (dict build src/IMSAME.c:232-281,
 * per-thread k-mer scan src/alignmentFunctions.c:91-121).  They replace the
 * multi-pass numpy formulations with single-pass C: a counting sort over the
 * 4^k key space instead of argsort, and fused rolling-key + bucket-lookup +
 * prefix-sum loops.
 *
 * Semantics are bit-compatible with the numpy paths (tests/test_native.py
 * checks exact equality); layout contracts:
 *   codes  uint8[total_len]   2-bit base codes (A=0 C=1 G=2 T=3)
 *   fresh  uint8[total_len]   1 where the k-mer window restarts (read start
 *                             or preceded by a dropped non-newline char,
 *                             reference src/IMSAME.c:229-231)
 *   bucket_start int32[4^k+1] exclusive prefix table; bucket of key b is
 *                             rows [bucket_start[b], bucket_start[b+1])
 *   index rows sorted by (key asc, pos desc) -- descending pos reproduces
 *   the reference's prepend-on-insert "newest first" hit order
 *   (src/IMSAME.c:263-276, SURVEY.md quirk 6.1).
 *
 * Build: gcc -O3 -shared -fPIC (see native/__init__.py); no dependencies.
 */

#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

static inline uint32_t key_mask(int32_t k) {
    return (k >= 16) ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
}

/* ------------------------------------------------------------------ *
 * Parallel counting-sort index build.
 *
 * Replaces the reference's single-threaded insert loop
 * (src/IMSAME.c:232-281).  The input stream is split into T contiguous
 * window-end ranges; each thread counts its range into a private
 * [n_buckets] array, a parallel pass over the bucket space turns the
 * private counts into per-thread write cursors, and each thread then
 * rescans its range scattering entries.  Per-bucket order: later threads
 * own higher positions and their subrange is placed FIRST in the bucket,
 * and every thread fills its subrange from the end downward as positions
 * ascend -- so the global bucket order is descending pos, the reference's
 * prepend-on-insert "newest first" (src/IMSAME.c:263-276, quirk 6.1).
 *
 * A k-mer ending at p is valid iff its k bases were appended with no
 * window reset: no fresh flag in (p-k+1, p].  Threads warm up their
 * rolling key/run state from p_lo-k+1, so the split is seam-free.
 *
 * Output modes (the scatter is the bandwidth bottleneck, so we only emit
 * what the regime needs; keys/pos/sid are derived lazily in Python):
 *   mode 1 (packable: n_seqs < 2^20 and read lens < 4096):
 *       out_packed[o] = (sid << 12) | (pos - start[sid])
 *   mode 0: out_pos[o] = one-past-kmer-end (src/IMSAME.c:247),
 *           out_sid[o] = read id.
 * Returns the total entry count, or -1 on allocation failure (caller
 * falls back to numpy).
 * ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *codes, *fresh;
    const int64_t *start;
    int64_t n_seqs, n, n_buckets;
    int32_t k, T, tid;
    int64_t p_lo, p_hi;   /* window-end range [p_lo, p_hi) */
    int64_t b_lo, b_hi;   /* bucket range for the cursor pass */
    int32_t **counts;     /* [T][n_buckets] private counts -> cursors */
    int32_t *bucket_start;
    uint32_t *out_packed;
    int32_t *out_pos, *out_sid;
    int64_t range_total;  /* out of the count pass / in of cursor pass */
    int64_t bucket_base;  /* global offset of this thread's bucket range */
    int64_t total;        /* sum over earlier bucket ranges (phase b) */
} IdxTask;

static void *idx_count_pass(void *arg) {
    IdxTask *t = (IdxTask *)arg;
    const uint32_t mask = key_mask(t->k);
    int32_t *cnt = t->counts[t->tid];
    uint32_t key = 0;
    int64_t run = 0;
    int64_t warm = t->p_lo - (t->k - 1);
    if (warm < 0) warm = 0;
    for (int64_t p = warm; p < t->p_hi; p++) {
        key = ((key << 2) | t->codes[p]) & mask;
        run = t->fresh[p] ? 1 : run + 1;
        if (p >= t->p_lo && p >= t->k - 1 && run >= t->k) cnt[key]++;
    }
    return NULL;
}

/* phase 2a: per-bucket-range grand totals (for the cross-range prefix) */
static void *idx_range_total(void *arg) {
    IdxTask *t = (IdxTask *)arg;
    int64_t acc = 0;
    for (int64_t b = t->b_lo; b < t->b_hi; b++)
        for (int32_t j = 0; j < t->T; j++) acc += t->counts[j][b];
    t->range_total = acc;
    return NULL;
}

/* phase 2b: write the global prefix table and turn the private counts
 * into per-thread end-cursors (cursor[tid][b] = one past tid's subrange,
 * later threads placed first within the bucket). */
static void *idx_cursor_pass(void *arg) {
    IdxTask *t = (IdxTask *)arg;
    int64_t acc = t->bucket_base;
    for (int64_t b = t->b_lo; b < t->b_hi; b++) {
        t->bucket_start[b] = (int32_t)acc;
        int64_t suffix = 0;
        for (int32_t j = t->T - 1; j >= 0; j--) {
            suffix += t->counts[j][b];
            t->counts[j][b] = (int32_t)(acc + suffix);
        }
        acc += suffix;
    }
    return NULL;
}

static void *idx_fill_pass(void *arg) {
    IdxTask *t = (IdxTask *)arg;
    const uint32_t mask = key_mask(t->k);
    int32_t *cur = t->counts[t->tid];
    uint32_t key = 0;
    int64_t run = 0;
    int64_t warm = t->p_lo - (t->k - 1);
    if (warm < 0) warm = 0;
    /* read id of the first window start via binary search, then linear */
    int64_t r = 0;
    {
        int64_t ps0 = t->p_lo - (t->k - 1);
        if (ps0 < 0) ps0 = 0;
        int64_t a = 0, b = t->n_seqs;
        while (a < b) { /* upper_bound(start, ps0) - 1 */
            int64_t mid = a + (b - a) / 2;
            if (t->start[mid] <= ps0) a = mid + 1; else b = mid;
        }
        r = a > 0 ? a - 1 : 0;
    }
    const int packed = t->out_packed != NULL;
    for (int64_t p = warm; p < t->p_hi; p++) {
        key = ((key << 2) | t->codes[p]) & mask;
        run = t->fresh[p] ? 1 : run + 1;
        if (p >= t->p_lo && p >= t->k - 1 && run >= t->k) {
            int64_t ps = p - t->k + 1;
            while (r + 1 < t->n_seqs && t->start[r + 1] <= ps) r++;
            int32_t o = --cur[key];
            if (packed)
                t->out_packed[o] =
                    ((uint32_t)r << 12) | (uint32_t)(p + 1 - t->start[r]);
            else {
                t->out_pos[o] = (int32_t)(p + 1);
                t->out_sid[o] = (int32_t)r;
            }
        }
    }
    return NULL;
}

/* Generic task runner: tasks is an array of T task structs of size
 * ``stride`` bytes (passing the typed pointer directly would index with
 * the wrong element size for any struct but the one it was declared
 * for). */
static void run_tasks_s(void *tasks, size_t stride, int T,
                        void *(*fn)(void *)) {
    pthread_t tids[64];
    int spawned = 0;
    char *base = (char *)tasks;
    for (int j = 0; j + 1 < T; j++)
        if (pthread_create(&tids[j], NULL, fn, base + (size_t)j * stride) == 0)
            spawned++;
        else { fn(base + (size_t)j * stride); }  /* degrade: run inline */
    fn(base + (size_t)(T - 1) * stride);
    for (int j = 0; j < spawned; j++) pthread_join(tids[j], NULL);
}

#define run_tasks(tasks, T, fn) \
    run_tasks_s((tasks), sizeof((tasks)[0]), (T), (fn))

EXPORT int64_t imsame_index_build(
    const uint8_t *codes, const uint8_t *fresh,
    const int64_t *start, int64_t n_seqs,
    int64_t n, int32_t k, int64_t n_buckets, int32_t n_threads,
    int32_t *bucket_start /* [n_buckets+1] out: exclusive prefix table */,
    uint32_t *out_packed /* [cap] or dummy */, int32_t mode_packed,
    int32_t *out_pos, int32_t *out_sid /* [cap] each, or dummy */) {
    int T = n_threads < 1 ? 1 : (n_threads > 32 ? 32 : n_threads);
    if (n < (1 << 20)) T = 1; /* thread setup dwarfs tiny inputs */
    if (n < k) {
        memset(bucket_start, 0, (size_t)(n_buckets + 1) * 4);
        return 0;
    }
    /* Fresh calloc per call: the kernel's lazy zero pages beat an
       explicit memset of cached arrays (measured 0.18 s vs 0.23 s steady
       on the 20k-read build with T=2). */
    int32_t *bufs[32] = {0};
    int32_t **counts = bufs;
    for (int j = 0; j < T; j++) {
        counts[j] = (int32_t *)calloc((size_t)n_buckets, 4);
        if (!counts[j]) {
            while (j-- > 0) free(counts[j]);
            return -1;
        }
    }
    IdxTask tasks[32];
    for (int j = 0; j < T; j++) {
        IdxTask *t = &tasks[j];
        t->codes = codes; t->fresh = fresh; t->start = start;
        t->n_seqs = n_seqs; t->n = n; t->n_buckets = n_buckets;
        t->k = k; t->T = T; t->tid = j;
        t->p_lo = n * j / T;
        t->p_hi = n * (j + 1) / T;
        t->b_lo = n_buckets * j / T;
        t->b_hi = n_buckets * (j + 1) / T;
        t->counts = counts; t->bucket_start = bucket_start;
        t->out_packed = mode_packed ? out_packed : NULL;
        t->out_pos = out_pos; t->out_sid = out_sid;
        t->range_total = 0;
    }
    run_tasks(tasks, T, idx_count_pass);
    run_tasks(tasks, T, idx_range_total);
    int64_t total = 0;
    for (int j = 0; j < T; j++) {
        tasks[j].bucket_base = total;
        total += tasks[j].range_total;
    }
    run_tasks(tasks, T, idx_cursor_pass);
    bucket_start[n_buckets] = (int32_t)total;
    run_tasks(tasks, T, idx_fill_pass);
    for (int j = 0; j < T; j++) free(counts[j]);
    return total;
}

/* ------------------------------------------------------------------ *
 * Report-block renderer: per accepted pair, reconstruct the two
 * right-aligned alignment buffers from the device traceback chain and
 * emit the 60-column triplet blocks (db line, query line, '*' match
 * line), counting identities during emission -- the reference counts
 * them at render time too (src/alignmentFunctions.c:230-271; emission
 * order src/alignmentFunctions.c:493-560).  The Python emission loops
 * cost ~0.36 ms/pair; at 10k accepted pairs that dominates the whole
 * render phase, so the inner loops live here.
 *
 * Chain encoding (ops/traceback.py): chain[0] = best cell as
 * px*4096+py; subsequent entries are visited cells, bit 26 flagging a
 * diagonal-run jump whose chars expand one by one.
 * ------------------------------------------------------------------ */

#define ALIGN_COLS 60

static int64_t render_one(
    const int32_t *chain, int32_t n_steps, int32_t xl, int32_t yl,
    const uint8_t *xc, const uint8_t *yc,
    uint8_t *rec_x, uint8_t *rec_y, /* scratch, >= 4*max(xl,yl)+2 */
    uint8_t *out, int32_t *identities_out) {
    const int32_t PACKB = 4096;
    const int32_t RUN_FLAG = 1 << 26;
    int32_t maximum_len = 2 * (xl > yl ? xl : yl);
    int32_t buf_len = 2 * maximum_len + 2;
    memset(rec_x, ' ', (size_t)buf_len);
    memset(rec_y, ' ', (size_t)buf_len);
    int32_t head_x = maximum_len, head_y = maximum_len;
    int32_t bc_x = chain[0] / PACKB, bc_y = chain[0] % PACKB;
    int32_t prev_x = bc_x, prev_y = bc_y;
    for (int32_t k = xl - 1; k > bc_x; k--) rec_x[head_x--] = '-';
    for (int32_t k = yl - 1; k > bc_y; k--) rec_y[head_y--] = '-';
    int32_t curr_x = bc_x, curr_y = bc_y;
    for (int32_t st = 1; st <= n_steps; st++) {
        int32_t e = chain[st];
        int is_run = (e & RUN_FLAG) != 0;
        e &= RUN_FLAG - 1;
        curr_x = e / PACKB;
        curr_y = e % PACKB;
        if (is_run) {
            for (int32_t k = 0; k < prev_x - curr_x; k++) {
                rec_x[head_x--] = xc[prev_x - k];
                rec_y[head_y--] = yc[prev_y - k];
            }
        } else if (curr_x == prev_x - 1 && curr_y == prev_y - 1) {
            rec_x[head_x--] = xc[prev_x];
            rec_y[head_y--] = yc[prev_y];
        } else if ((prev_x - curr_x) > (prev_y - curr_y)) {
            for (int32_t k = prev_x; k > curr_x; k--) {
                rec_y[head_y--] = '-';
                rec_x[head_x--] = xc[k];
            }
        } else {
            for (int32_t k = prev_y; k > curr_y; k--) {
                rec_x[head_x--] = '-';
                rec_y[head_y--] = yc[k];
            }
        }
        prev_x = curr_x;
        prev_y = curr_y;
    }
    int32_t hx = 0, hy = 0; /* leading gap runs; shorter side space-padded */
    for (int32_t k = curr_x - 1; k >= 0; k--) { rec_x[head_x--] = '-'; hx++; }
    for (int32_t k = curr_y - 1; k >= 0; k--) { rec_y[head_y--] = '-'; hy++; }
    if (hx >= hy)
        while (hx-- > 0) rec_y[head_y--] = ' ';
    else
        while (hy-- > 0) rec_x[head_x--] = ' ';

    int32_t identities = 0;
    int64_t o = 0;
    int32_t i = head_x + 1, j = head_y + 1;
    while (i <= maximum_len && j <= maximum_len) {
        int32_t off = 0, before_i = i, before_j = j;
        while (off < ALIGN_COLS && i <= maximum_len) {
            out[o++] = rec_x[i++];
            off++;
        }
        out[o++] = '\n';
        off = 0;
        while (off < ALIGN_COLS && j <= maximum_len) {
            out[o++] = rec_y[j++];
            off++;
        }
        out[o++] = '\n';
        while (before_i < i) {
            uint8_t cx = rec_x[before_i], cy = rec_y[before_j];
            if (cx != '-' && cy != '-' && cx == cy) {
                out[o++] = '*';
                identities++;
            } else
                out[o++] = ' ';
            before_j++;
            before_i++;
        }
        out[o++] = '\n';
    }
    out[o++] = '\n';
    *identities_out = identities;
    return o;
}

EXPORT int32_t imsame_render_blocks(
    const int32_t *chains, int64_t chain_stride, const int32_t *n_steps,
    const int32_t *xlen, const int32_t *ylen,
    const uint8_t *xchars, const int64_t *xoff,
    const uint8_t *ychars, const int64_t *yoff,
    int64_t P,
    uint8_t *out, const int64_t *out_off, int64_t *out_len,
    int32_t *identities) {
    int32_t maxl = 0;
    for (int64_t p = 0; p < P; p++) {
        if (xlen[p] > maxl) maxl = xlen[p];
        if (ylen[p] > maxl) maxl = ylen[p];
    }
    uint8_t *rec_x = (uint8_t *)malloc((size_t)(4 * maxl + 2) * 2);
    if (!rec_x) return -1;
    uint8_t *rec_y = rec_x + (4 * maxl + 2);
    for (int64_t p = 0; p < P; p++) {
        out_len[p] = render_one(
            chains + p * chain_stride, n_steps[p], xlen[p], ylen[p],
            xchars + xoff[p], ychars + yoff[p],
            rec_x, rec_y, out + out_off[p], &identities[p]);
    }
    free(rec_x);
    return 0;
}

/* ------------------------------------------------------------------ *
 * FASTA ingest: one pass replicating io/fasta.py parse semantics
 * (reference ingest, src/IMSAME.c:196-289): header lines ('>' at line
 * start) delimit reads; every other byte after the first header maps
 * through ``lut`` (A/C/G/T upper+lower -> 0..3, else 255); 255 bytes are
 * dropped and set a window-reset flag on the next kept base (reference
 * src/IMSAME.c:229-231); newlines neither reset nor emit.
 *
 * Outputs (caller-allocated): codes/fresh sized >= n; start sized >= the
 * number of '>' bytes in the input (upper bound on reads); hdr_se holds
 * (text_start, text_end) byte offsets per header.  start[r] is -1 for
 * reads with no kept bases (caller back-fills with the next read's
 * start, matching the numpy searchsorted semantics).  Returns the kept
 * base count; read count via n_reads_out.
 * ------------------------------------------------------------------ */
EXPORT int64_t imsame_parse_fasta(
    const uint8_t *raw, int64_t n, const uint8_t *lut,
    uint8_t *codes, uint8_t *fresh,
    int64_t *start, int64_t *hdr_se, int64_t *n_reads_out) {
    int64_t m = 0;
    int64_t r = -1;
    int in_header = 0;
    int at_line_start = 1;
    int pending_fresh = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = raw[i];
        if (c == '\n') {
            if (in_header) {
                hdr_se[2 * r + 1] = i;
                in_header = 0;
            }
            at_line_start = 1;
            continue;
        }
        if (at_line_start) {
            at_line_start = 0;
            if (c == '>') {
                r++;
                start[r] = -1;
                hdr_se[2 * r] = i + 1;
                hdr_se[2 * r + 1] = n; /* header at EOF without newline */
                in_header = 1;
                pending_fresh = 0;
                continue;
            }
        }
        if (in_header || r < 0) continue;
        uint8_t code = lut[c];
        if (code == 255) {
            pending_fresh = 1;
            continue;
        }
        if (start[r] < 0) {
            start[r] = m;
            fresh[m] = 1; /* first base of a read always restarts */
        } else {
            fresh[m] = (uint8_t)pending_fresh;
        }
        pending_fresh = 0;
        codes[m] = code;
        m++;
    }
    *n_reads_out = r + 1;
    return m;
}

/* Query candidate-stream tables: fused rolling key + bucket lookup + prefix
 * sum (the numpy path needs five multi-megabyte temporaries and two random
 * gathers into the 67 MB prefix table).
 *
 * Per read rd, emits n_kmers[rd] consecutive slots starting at stream
 * position qlo[rd] (the caller bakes the reference's boundary-base quirk,
 * SURVEY.md 6.5, into qlo/n_kmers).  For global slot i:
 *   kp[i]   k-mer start position in the concatenated query array
 *   lo[i]   first index row of the k-mer's bucket
 *   cnt[i]  bucket size
 *   Ccum[i] exclusive prefix sum of cnt (Ccum[0]=0, length total+1)
 */
typedef struct {
    const uint8_t *codes;
    const int64_t *qlo, *n_kmers, *slot_off;
    int64_t r0, r1;
    int32_t k;
    const int32_t *bucket_start;
    int64_t *kp;
    int32_t *lo, *cnt;
    int64_t *Ccum;
    int64_t range_total; /* out of scan pass / base for fixup pass */
} KsTask;

/* Per-thread scan of a contiguous read range: reads are independent (each
 * read's slots land at slot_off[rd]), so only the Ccum prefix is global --
 * the scan writes thread-LOCAL cumulatives and a fixup pass adds the
 * cross-range base.  The scan is cache-miss bound on the two adjacent
 * bucket_start words per slot (67 MB table); threads overlap the misses. */
static void *ks_scan(void *arg) {
    KsTask *t = (KsTask *)arg;
    const uint32_t mask = key_mask(t->k);
    int64_t c = 0;
    for (int64_t rd = t->r0; rd < t->r1; rd++) {
        int64_t s = t->qlo[rd], m = t->n_kmers[rd];
        int64_t i = t->slot_off[rd];
        if (m <= 0) continue;
        uint32_t key = 0;
        for (int32_t j = 0; j < t->k - 1; j++)
            key = (key << 2) | t->codes[s + j];
        for (int64_t j = 0; j < m; j++) {
            key = ((key << 2) | t->codes[s + j + t->k - 1]) & mask;
            t->kp[i] = s + j;
            int32_t l = t->bucket_start[key];
            int32_t h = t->bucket_start[key + 1];
            t->lo[i] = l;
            t->cnt[i] = h - l;
            c += h - l;
            t->Ccum[i + 1] = c;
            i++;
        }
    }
    t->range_total = c;
    return NULL;
}

static void *ks_fixup(void *arg) {
    KsTask *t = (KsTask *)arg;
    int64_t base = t->range_total; /* repurposed: prefix of earlier ranges */
    if (base == 0) return NULL;
    int64_t i0 = t->slot_off[t->r0] + 1, i1 = t->slot_off[t->r1] + 1;
    for (int64_t i = i0; i < i1; i++) t->Ccum[i] += base;
    return NULL;
}

EXPORT void imsame_kmer_stream(
    const uint8_t *codes,
    const int64_t *qlo, const int64_t *n_kmers, int64_t n_seqs, int32_t k,
    const int32_t *bucket_start,
    int64_t *kp, int32_t *lo, int32_t *cnt, int64_t *Ccum,
    int32_t n_threads) {
    Ccum[0] = 0;
    int64_t *slot_off = (int64_t *)malloc((size_t)(n_seqs + 1) * 8);
    if (!slot_off) { /* degrade: the original single-threaded scan */
        const uint32_t mask = key_mask(k);
        int64_t i = 0, c = 0;
        for (int64_t rd = 0; rd < n_seqs; rd++) {
            int64_t s = qlo[rd], m = n_kmers[rd];
            if (m <= 0) continue;
            uint32_t key = 0;
            for (int32_t j = 0; j < k - 1; j++) key = (key << 2) | codes[s + j];
            for (int64_t j = 0; j < m; j++) {
                key = ((key << 2) | codes[s + j + k - 1]) & mask;
                kp[i] = s + j;
                int32_t l = bucket_start[key];
                int32_t h = bucket_start[key + 1];
                lo[i] = l;
                cnt[i] = h - l;
                c += h - l;
                Ccum[i + 1] = c;
                i++;
            }
        }
        return;
    }
    int64_t total = 0;
    for (int64_t rd = 0; rd < n_seqs; rd++) {
        slot_off[rd] = total;
        if (n_kmers[rd] > 0) total += n_kmers[rd];
    }
    slot_off[n_seqs] = total;
    int T = n_threads < 1 ? 1 : (n_threads > 32 ? 32 : n_threads);
    if (total < (1 << 18)) T = 1;
    KsTask tasks[32];
    /* split read ranges by slot count for balance */
    int64_t r = 0;
    for (int j = 0; j < T; j++) {
        KsTask *t = &tasks[j];
        t->codes = codes; t->qlo = qlo; t->n_kmers = n_kmers;
        t->slot_off = slot_off; t->k = k; t->bucket_start = bucket_start;
        t->kp = kp; t->lo = lo; t->cnt = cnt; t->Ccum = Ccum;
        t->r0 = r;
        int64_t goal = total * (j + 1) / T;
        while (r < n_seqs && slot_off[r] < goal) r++;
        t->r1 = (j == T - 1) ? n_seqs : r;
        t->range_total = 0;
    }
    run_tasks(tasks, T, ks_scan);
    int64_t acc = 0;
    for (int j = 0; j < T; j++) {
        int64_t rt = tasks[j].range_total;
        tasks[j].range_total = acc; /* repurpose as fixup base */
        acc += rt;
    }
    run_tasks(tasks, T, ks_fixup);
    free(slot_off);
}

/* Expand candidate-rank windows [from_rank[e], to_rank[e]) of the selected
 * reads into flat per-candidate arrays, in stream order (k-mer slots in scan
 * order x bucket hits newest-first -- the order the reference worker walks,
 * src/alignmentFunctions.c:107-186):
 *   out_rids[o]  query read id
 *   out_hits[o]  index row of the hit (lo[slot] + offset, so sid/pos are
 *                direct gathers for the caller)
 *   out_qoffs[o] one past the k-mer's last base, in read-row coordinates
 * Returns the number of candidates emitted; the caller sizes the outputs as
 * sum(max(0, min(to, N_r) - from)).  A binary search per read finds the
 * first slot of the window, so resuming a read mid-stream (the two-stage
 * gate) costs O(log slots), not a rescan. */
EXPORT int64_t imsame_build_flat(
    const int64_t *read_ids, const int64_t *from_rank, const int64_t *to_rank,
    int64_t m,
    const int64_t *K_off, const int64_t *C_off,
    const int64_t *kp, const int32_t *lo, const int32_t *cnt,
    const int64_t *Ccum,
    const int64_t *q_start, int32_t k,
    int32_t *out_rids, int32_t *out_hits, int32_t *out_qoffs) {
    int64_t o = 0;
    for (int64_t e = 0; e < m; e++) {
        int64_t r = read_ids[e];
        int64_t t0 = K_off[r], t1 = K_off[r + 1];
        int64_t base = Ccum[t0];
        int64_t f = from_rank[e], t = to_rank[e];
        int64_t nr = C_off[r + 1] - C_off[r];
        if (t > nr) t = nr;
        if (f >= t) continue;
        /* first slot whose candidate range extends past rank f */
        int64_t a = t0, b = t1;
        while (a < b) {
            int64_t mid = a + (b - a) / 2;
            if (Ccum[mid + 1] - base > f) b = mid;
            else a = mid + 1;
        }
        int64_t rank = Ccum[a] - base;
        int32_t rid32 = (int32_t)r;
        for (int64_t slot = a; slot < t1 && rank < t; slot++) {
            int64_t nh = cnt[slot];
            int32_t qoff = (int32_t)(kp[slot] + k - q_start[r]);
            int32_t l = lo[slot];
            for (int64_t h = 0; h < nh && rank < t; h++, rank++) {
                if (rank >= f) {
                    out_rids[o] = rid32;
                    out_hits[o] = l + (int32_t)h;
                    out_qoffs[o] = qoff;
                    o++;
                }
            }
        }
    }
    return o;
}

/* Segment-encode one candidate chunk for the 4-byte gate format
 * (ops/candidates.py flat_gate_seg): one int32 word per candidate --
 * bit 31 a new-segment flag, bits 25..30 the qoff delta (0..63), bits
 * 0..24 the index-hit row -- plus per-segment (read id, qoff decode
 * base) tables.  Segments break on read change, negative/overflowing
 * qoff delta, or chunk start; rbase[seg] = qoff - inclusive_cumsum(qd)
 * at the segment's first candidate so the device reconstructs
 * qoff = rbase[rix] + cumsum(qd).  Returns the segment count, or -1
 * when it would exceed seg_cap (caller falls back to the 8-byte
 * format).  Single pass; replaces an ~8-pass numpy encoding that cost
 * ~170 ms per 2M-candidate chunk. */
EXPORT int64_t imsame_seg_encode(
    const int32_t *rids, const int32_t *qoffs, const int32_t *hits,
    int64_t n, int64_t seg_cap,
    int32_t *cand, int32_t *rtab, int32_t *rbase) {
    int64_t nseg = 0;
    int64_t cs = 0;
    int32_t prev_r = -1;
    int32_t prev_q = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t r = rids[i];
        int32_t qo = qoffs[i];
        int64_t dq = (int64_t)qo - (int64_t)prev_q;
        uint32_t w;
        if (i == 0 || r != prev_r || dq < 0 || dq > 63) {
            if (nseg >= seg_cap) return -1;
            rtab[nseg] = r;
            rbase[nseg] = (int32_t)((int64_t)qo - cs);
            nseg++;
            w = 0x80000000u | (uint32_t)hits[i];
        } else {
            cs += dq;
            w = ((uint32_t)dq << 25) | (uint32_t)hits[i];
        }
        cand[i] = (int32_t)w;
        prev_r = r;
        prev_q = qo;
    }
    return nseg;
}
