/* Native per-read seeding/collation core.
 *
 * Exact C replicas of the pure-Python reference implementations in
 * smalt_tpu/seed/hitinfo.py, seed/hitlist.py and segment/collate.py,
 * which in turn replicate the reference aligner's semantics
 * (hashhit.c:482-1770, segment.c:396-1057).  These are the per-read
 * hot loops of the exact mapping path; the Python versions stay as
 * the correctness oracle (differential-tested in
 * tests/test_native_core.py).
 *
 * All functions are stateless and fill caller-provided buffers; no
 * allocation happens here except small per-call scratch on the stack
 * or via the caller-provided scratch arrays.
 *
 * Compiled together with swdp.c into one shared object by
 * smalt_tpu/native/__init__.py.
 */
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* from swdp.c (same shared object) */
int nr_sort2(uint32_t *a, uint32_t *b, int n);

/* hit qualifiers (hashhit.h:57-65) */
#define HQ_TERM 0
#define HQ_NORMHIT 1
#define HQ_MULTIHIT 2
#define HQ_REPEAT 3
#define HQ_NOHIT 4
#define HQ_NONSTDNT 5

#define NREPEATS 4            /* hashhit.c:42 */
#define MINSEEDNUM 3          /* hashhit.c:54 */
#define MINHIT_PER_TUPLE 16   /* hashhit.c:43 */
#define QVAL_OFFS 0x21

#define HALFBIT 31
#define HALFMASK 0x7FFFFFFFll
#define OFFBIT (1ull << (HALFBIT + 1))
#define SOFFSMASK 0xFFFFFFFFull

/* ---------------- binary search over the sorted word list ---------------- */

static int64_t word_lookup(const uint64_t *words, int64_t nwords, uint64_t w)
{
    int64_t lo = 0, hi = nwords;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (words[mid] < w) lo = mid + 1; else hi = mid;
    }
    if (lo < nwords && words[lo] == w) return lo;
    return -1;
}

/* ---------------- hit info collection (collectHitInfo) ---------------- */

/* Returns n_seeds >= 0, or -1 for a read shorter than the word.
 * qmask: u8[qlen] out.  qoffs/nhits/slot: i64[qlen] out (seed arrays);
 * `slot` holds each word's first-position OFFSET into pos[] (the
 * count is in nhits).  With a non-NULL direct-address cumulative
 * table (int32 [4^k+1]) the lookup is O(1) like the reference hash
 * table; otherwise a binary search over the sorted word list. */
int64_t mc_hitinfo_collect(
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table,
    int wordlen, int nskip,
    const uint8_t *codes, const uint8_t *qual, int64_t qlen,
    int is_reverse, int64_t maxhit_per_tuple, int basq_thresh,
    int64_t seq_start, int64_t seq_end,
    uint8_t *qmask, int64_t *qoffs, int64_t *nhits, int64_t *slot)
{
    int64_t t, j, n_seeds = 0;
    int k = wordlen;
    uint64_t w = 0, mask2k;
    uint64_t ring[NREPEATS];
    int ring_n = 0, ring_at = 0;
    int64_t badrun;    /* windows remaining with a bad base inside */
    int minq = basq_thresh + QVAL_OFFS;

    (void)nskip;
    if (qlen < k) return -1;
    if (seq_end >= qlen) seq_end = qlen - 1;
    if (seq_end < seq_start + k - 1) { seq_start = 0; seq_end = qlen - 1; }

    memset(qmask, 0, (size_t)qlen);            /* TERM */
    for (t = 0; t < seq_start; t++) qmask[t] = HQ_NOHIT;

    {
        int64_t t0 = seq_start, t1 = seq_end - k + 1;
        if (t1 < t0) return -1;
        mask2k = (2 * k >= 64) ? ~0ull : ((1ull << (2 * k)) - 1);

        /* prime the rolling word over [t0, t0+k-1) */
        badrun = 0;
        for (j = t0; j < t0 + k - 1; j++) {
            uint8_t c = codes[j];
            int bad = (c & 4) != 0 || (qual && qual[j] < minq);
            uint64_t b2 = c & 3;
            if (bad) badrun = k;
            else if (badrun > 0) badrun--;
            if (is_reverse)
                w = (w >> 2) | ((b2 ^ 3ull) << (2 * (k - 1)));
            else
                w = ((w << 2) | b2) & mask2k;
        }
        /* lookahead rolling word PFD positions ahead of t: its only
         * job is issuing a speculative prefetch of the direct-address
         * table line the main walk will load ~PFD iterations later
         * (the table is 4^k ints — every lookup is a cold DRAM line
         * otherwise).  No bad-base tracking: a wasted prefetch on a
         * window the main walk skips is harmless. */
#define HITINFO_PFD 16
        {
            uint64_t wA = 0;
            int64_t tA = t0 + HITINFO_PFD;
            if (table && tA <= t1) {
                for (j = tA; j < tA + k - 1 && j <= seq_end; j++) {
                    uint64_t b2 = codes[j] & 3;
                    if (is_reverse)
                        wA = (wA >> 2) | ((b2 ^ 3ull) << (2 * (k - 1)));
                    else
                        wA = ((wA << 2) | b2) & mask2k;
                }
            }
        for (t = t0; t <= t1; t++) {
            if (table && t + HITINFO_PFD <= t1) {
                uint64_t b2 = codes[t + HITINFO_PFD + k - 1] & 3;
                if (is_reverse)
                    wA = (wA >> 2) | ((b2 ^ 3ull) << (2 * (k - 1)));
                else
                    wA = ((wA << 2) | b2) & mask2k;
                __builtin_prefetch(&table[wA], 0, 1);
            }
            uint8_t c = codes[t + k - 1];
            int bad = (c & 4) != 0 || (qual && qual[t + k - 1] < minq);
            uint64_t b2 = c & 3;
            int ok, rep = 0;
            if (bad) badrun = k;
            else if (badrun > 0) badrun--;
            if (is_reverse)
                w = (w >> 2) | ((b2 ^ 3ull) << (2 * (k - 1)));
            else
                w = ((w << 2) | b2) & mask2k;
            ok = (badrun == 0);
            if (!ok) { qmask[t] = HQ_NONSTDNT; continue; }
            for (j = 0; j < ring_n; j++)
                if (ring[j] == w) { rep = 1; break; }
            ring[ring_at] = w;
            ring_at = (ring_at + 1) % NREPEATS;
            if (ring_n < NREPEATS) ring_n++;
            if (rep) { qmask[t] = HQ_REPEAT; continue; }
            {
                int64_t cnt, base;
                if (table) {
                    base = table[w];
                    cnt = (int64_t)table[w + 1] - base;
                } else {
                    int64_t ix = word_lookup(words, nwords, w);
                    base = (ix >= 0) ? starts[ix] : -1;
                    cnt = (ix >= 0) ? starts[ix + 1] - starts[ix] : 0;
                }
                if (cnt < 1) { qmask[t] = HQ_NOHIT; continue; }
                if (maxhit_per_tuple > 0 && cnt > maxhit_per_tuple) {
                    qmask[t] = HQ_MULTIHIT;
                    continue;
                }
                qmask[t] = HQ_NORMHIT;
                qoffs[n_seeds] = t;
                nhits[n_seeds] = cnt;
                slot[n_seeds] = base;
                n_seeds++;
            }
        }
        }   /* lookahead-word scope */
    }
    return n_seeds;
}

/* ---------------- rank selection (getHitInfoMaxRank) ---------------- */

/* sidx: u32[n_seeds] rank -> seed index (already sorted by caller).
 * qbuf: u8[qlen] scratch.  Returns seed_rank. */
int64_t mc_max_rank(
    const int64_t *qoffs, const int64_t *nhits, const uint32_t *sidx,
    int64_t n_seeds, int64_t qlen, int ktup, int nskip,
    int64_t mincover, int64_t maxcover, int64_t maxhit,
    uint8_t *qbuf)
{
    int64_t i, f, rank, ntot, n, nmax;

    ntot = nhits[sidx[0]];
    i = 1;
    while (i <= n_seeds && ntot <= maxhit) {
        if (i < n_seeds) ntot += nhits[sidx[i]];
        i++;
    }
    n = nmax = i - 1;

    for (f = 0; f < nskip; f++) {
        int64_t cover = 0, last_rank = -1, used = 0;
        memset(qbuf, 0, (size_t)qlen);
        for (rank = 0; rank < n_seeds; rank++) {
            int64_t ix = sidx[rank], qo, e;
            if (qoffs[ix] % nskip != f) continue;
            if (!(cover <= maxcover && (cover < mincover || rank <= n)))
                break;
            qo = qoffs[ix];
            e = qo + ktup - 1;
            if (e > qlen) e = qlen;
            for (i = qo; i < e; i++) {
                if (!qbuf[i]) { cover++; qbuf[i] = 1; }
            }
            last_rank = rank;
            used++;
        }
        if (used > 0 && last_rank > nmax) nmax = last_rank;
    }
    if (nmax < MINSEEDNUM)
        return (MINSEEDNUM < n_seeds) ? MINSEEDNUM : n_seeds;
    return nmax;
}

/* ---------------- cover deficit (hashCalcHitInfoCoverDeficit) -------- */

int64_t mc_cover_deficit(
    const int64_t *qoffs, const uint32_t *sidx, int64_t n_seeds,
    int has_rank, int64_t seed_rank,
    const uint8_t *qmask, int64_t qlen, int ktup, int nskip,
    uint8_t *qbuf)
{
    int64_t f, i, rank;
    if (has_rank) {
        int64_t d = qlen, maxcover = 0;
        for (f = 0; f < nskip; f++) {
            int64_t cover = 0, any = 0;
            memset(qbuf, 0, (size_t)qlen);
            for (rank = 0; rank < n_seeds; rank++) {
                int64_t ix = sidx[rank], qo, e;
                if (qoffs[ix] % nskip != f) continue;
                any = 1;
                if (rank >= seed_rank) break;
                qo = qoffs[ix];
                e = qo + ktup;
                if (e > qlen) e = qlen;
                for (i = qo; i < e; i++)
                    if (!qbuf[i]) { cover++; qbuf[i] = 1; }
            }
            if (!any) continue;
            if (cover < d) d = cover;
            if (cover > maxcover) maxcover = cover;
        }
        return maxcover - d + 1;
    }
    {
        int64_t k = ktup / nskip, deficit = 0, s;
        if (k > 0) k--;
        for (s = 0; s < nskip; s++) {
            int64_t d = 0, ctr = 0;
            for (i = s; i < qlen; i += nskip) {
                if (qmask[i] == HQ_NORMHIT) ctr = k;
                else if (ctr) ctr--;
                else d += nskip;
            }
            if (d > deficit) deficit = d;
        }
        return deficit;
    }
}

/* ---------------- packed hit-list collection ---------------- */

static inline uint64_t pack_hit(uint64_t p, int64_t q, int nskip, int is_rev)
{
    uint64_t qo = (uint64_t)(q / nskip);
    if (is_rev) return ((p + qo) << HALFBIT) + (uint64_t)q;
    return (((p | OFFBIT) - qo) << HALFBIT) + (uint64_t)q;
}

/* Ascending in-place u64 sort (median-of-3 quicksort + insertion tail)
 * without libc qsort's per-comparison indirect call.  Keys here are
 * unique packed hits, and even on duplicates an ascending u64 sort has
 * exactly one result — output is bit-identical to qsort+cmp_u64. */
static void sort_u64(uint64_t *a, int64_t n)
{
    int64_t stack[128][2];
    int sp = 0;
    stack[sp][0] = 0; stack[sp][1] = n - 1; sp++;
    while (sp > 0) {
        int64_t lo, hi;
        sp--;
        lo = stack[sp][0]; hi = stack[sp][1];
        while (hi - lo > 24) {
            int64_t mid = lo + ((hi - lo) >> 1), i = lo, j = hi;
            uint64_t p, t;
            /* median of three to the middle */
            if (a[mid] < a[lo]) { t = a[mid]; a[mid] = a[lo]; a[lo] = t; }
            if (a[hi] < a[lo]) { t = a[hi]; a[hi] = a[lo]; a[lo] = t; }
            if (a[hi] < a[mid]) { t = a[hi]; a[hi] = a[mid]; a[mid] = t; }
            p = a[mid];
            i = lo; j = hi;
            for (;;) {
                while (a[i] < p) i++;
                while (a[j] > p) j--;
                if (i >= j) break;
                t = a[i]; a[i] = a[j]; a[j] = t;
                i++; j--;
            }
            /* recurse into the smaller side, loop on the larger */
            if (j - lo < hi - (j + 1)) {
                /* smaller side pushed: depth <= log2(n), far under 128 */
                stack[sp][0] = j + 1; stack[sp][1] = hi; sp++;
                hi = j;
            } else {
                stack[sp][0] = lo; stack[sp][1] = j; sp++;
                lo = j + 1;
            }
        }
        {
            int64_t i, j;
            for (i = lo + 1; i <= hi; i++) {
                uint64_t v = a[i];
                for (j = i; j > lo && a[j - 1] > v; j--)
                    a[j] = a[j - 1];
                a[j] = v;
            }
        }
    }
}


/* hashCollectHitsUsingCutoff (hashhit.c:1593).  Fills sqdat (cap budget)
 * and qm u8[qlen].  Returns total hit count. */
int64_t mc_collect_cutoff(
    const int64_t *starts, const uint32_t *pos,
    const int64_t *qoffs, const int64_t *nhits, const int64_t *slot,
    const uint32_t *sidx, int64_t n_seeds,
    int64_t qlen, int nskip, int is_reverse,
    int64_t max_nhit_per_tup, int64_t budget,
    uint64_t *sqdat, uint8_t *qm)
{
    int64_t total = 0;
    for (;;) {
        int64_t rank;
        int reached_ceiling = 0;
        total = 0;
        memset(qm, HQ_NOHIT, (size_t)qlen);
        for (rank = 0; rank < n_seeds; rank++) {
            int64_t ix = sidx[rank];
            int64_t nh = nhits[ix], q = qoffs[ix], p0, l;
            if (nh < 1) continue;
            if (max_nhit_per_tup > 0 && nh > max_nhit_per_tup) {
                qm[q] = HQ_MULTIHIT;
                continue;
            }
            if (total + nh > budget) { reached_ceiling = 1; break; }
            qm[q] = HQ_NORMHIT;
            p0 = slot[ix];          /* slot = first-position offset */
            for (l = 0; l < nh; l++)
                sqdat[total + l] = pack_hit(pos[p0 + l], q, nskip, is_reverse);
            total += nh;
        }
        max_nhit_per_tup /= 2;
        if (!(reached_ceiling && max_nhit_per_tup > MINHIT_PER_TUPLE))
            break;
    }
    sort_u64(sqdat, total);
    return total;
}

/* positions p with lo_t <= p < hi_t inside one word's ascending list */
static void pos_range(const uint32_t *pos, int64_t p0, int64_t p1,
                      int64_t lo_t, int64_t hi_t,
                      int64_t *out_a, int64_t *out_b)
{
    int64_t lo = p0, hi = p1, mid;
    while (lo < hi) { mid = (lo + hi) >> 1;
        if ((int64_t)pos[mid] < lo_t) lo = mid + 1; else hi = mid; }
    *out_a = lo;
    hi = p1;
    while (lo < hi) { mid = (lo + hi) >> 1;
        if ((int64_t)pos[mid] < hi_t) lo = mid + 1; else hi = mid; }
    *out_b = lo;
}

/* hashCollectHitsForSegment (hashhit.c:1691). */
int64_t mc_collect_segment(
    const int64_t *starts, const uint32_t *pos,
    const int64_t *qoffs, const int64_t *nhits, const int64_t *slot,
    const uint32_t *sidx, int64_t n_seeds, int use_short,
    int64_t qlen, int nskip, int is_reverse,
    int64_t seg_lo, int64_t seg_hi,
    int64_t nhit_max, int64_t budget,
    uint64_t *sqdat, uint8_t *qm)
{
    int64_t lo_t = seg_lo / nskip, hi_t = seg_hi / nskip;
    int64_t total = 0;
    for (;;) {
        int64_t n;
        int alloc_boundary = 0;
        total = 0;
        memset(qm, HQ_NOHIT, (size_t)qlen);
        for (n = 0; n < n_seeds; n++) {
            int64_t ix = use_short ? (int64_t)sidx[n] : n;
            int64_t key_n = nhits[use_short ? (int64_t)sidx[n] : n];
            int64_t q = qoffs[ix], a, b, nh, l;
            if (nhit_max > 0 && key_n > nhit_max) {
                qm[q] = HQ_MULTIHIT;
                continue;
            }
            pos_range(pos, slot[ix], slot[ix] + nhits[ix],
                      lo_t, hi_t, &a, &b);
            nh = b - a;
            if (total + nh > budget) {
                if (nhit_max > 0) { alloc_boundary = 1; break; }
                qm[q] = HQ_MULTIHIT;
                continue;
            }
            for (l = 0; l < nh; l++)
                sqdat[total + l] = pack_hit(pos[a + l], q, nskip, is_reverse);
            total += nh;
        }
        nhit_max /= 2;
        if (!(alloc_boundary && nhit_max > MINHIT_PER_TUPLE)) break;
    }
    sort_u64(sqdat, total);
    return total;
}

/* ---------------- seeds & segments (segLstFillHits) ---------------- */

#define SEGMENTING_DIFFSHIFT 3

/* outputs sized <= nhits each; returns counts via out params. */
void mc_seg_fill(
    const uint64_t *sqdat, int64_t nhits, const uint8_t *qm,
    int64_t min_ktup, int ktup, int nskip, int64_t qlen,
    uint64_t *seed_sqo, int64_t *seed_len,
    int64_t *seg_ix, int64_t *seg_nseed, int64_t *seg_cover,
    int64_t *hreg_idx, int64_t *hreg_num,
    int64_t *out_nseed, int64_t *out_nseg, int64_t *out_nreg,
    int64_t *out_maxcover)
{
    int64_t i, n_seed = 0, n_seg = 0, n_reg = 0, maxcover = 0;
    int64_t max_dshift, ds;
    uint64_t dsthresh;

    /* min_ktup reduction over qmask (segment.c:778-785) */
    for (i = 0; i < qlen; i++) {
        uint8_t v = qm[i];
        if (v == 0) break;
        if (v == 1) continue;
        if (min_ktup < 2) break;
        min_ktup--;
    }

    max_dshift = (int64_t)ktup * SEGMENTING_DIFFSHIFT / nskip;
    ds = (qlen - ktup) / nskip + 1;
    if (ds < max_dshift) max_dshift = ds;
    dsthresh = (uint64_t)max_dshift << HALFBIT;

    i = 0;
    while (i < nhits) {
        /* region [i, e) by shift-gap splitting */
        int64_t e = i + 1, rs0, rn;
        while (e < nhits && (sqdat[e] - sqdat[e - 1]) < dsthresh) e++;
        if (e - i < min_ktup) { i = e; continue; }

        /* seeds within the region */
        rs0 = n_seed;
        {
            int64_t a = i;
            while (a < e) {
                uint64_t sqo = sqdat[a];
                uint64_t shift = sqo >> HALFBIT;
                int64_t q0 = (int64_t)(sqo & HALFMASK);
                int64_t lastq = q0 + ktup, b = a + 1;
                while (b < e) {
                    uint64_t s2 = sqdat[b];
                    int64_t q2 = (int64_t)(s2 & HALFMASK);
                    if ((s2 >> HALFBIT) != shift) break;
                    if (q2 > lastq || ((q2 - q0) % nskip)) break;
                    lastq = q2 + ktup;
                    b++;
                }
                seed_sqo[n_seed] = sqo;
                seed_len[n_seed] = lastq - q0;
                n_seed++;
                a = b;
            }
        }

        /* constant-shift segments over the region's seeds */
        hreg_idx[n_reg] = n_seg;
        rn = 0;
        {
            int64_t a = rs0;
            while (a < n_seed) {
                uint64_t shift = seed_sqo[a] >> HALFBIT;
                int64_t q0 = (int64_t)(seed_sqo[a] & HALFMASK);
                int64_t cover = seed_len[a], b = a + 1;
                while (b < n_seed) {
                    if ((seed_sqo[b] >> HALFBIT) != shift ||
                        (((int64_t)(seed_sqo[b] & HALFMASK)) - q0) % nskip)
                        break;
                    cover += seed_len[b];
                    b++;
                }
                seg_ix[n_seg] = a;
                seg_nseed[n_seg] = b - a;
                seg_cover[n_seg] = cover;
                if (cover > maxcover) maxcover = cover;
                n_seg++;
                rn++;
                a = b;
            }
        }
        hreg_num[n_reg] = rn;
        n_reg++;
        i = e;
    }
    *out_nseed = n_seed;
    *out_nseg = n_seg;
    *out_nreg = n_reg;
    *out_maxcover = maxcover;
}

/* ---------------- candidates (addCandsFast + derriveSEGCAND) -------- */

#define FLAG_REVERSE 0x01
#define FLAG_MMALI 0x02
#define CAND_FIELDS 10

/* calcSegmentBoundaries (segment.c:637-668) */
static void seg_bounds(const uint64_t *seed_sqo, const int64_t *seed_len,
                       const int64_t *seg_ix, const int64_t *seg_nseed,
                       int64_t seg, int ktup, int nskip, int is_rev,
                       int64_t *oqs, int64_t *oqe, int64_t *ors, int64_t *ore)
{
    int64_t i0 = seg_ix[seg];
    int64_t n = seg_nseed[seg]; if (n < 0) n = -n;
    uint64_t sp = seed_sqo[i0], ep = seed_sqo[i0 + n - 1];
    int64_t ep_len = seed_len[i0 + n - 1];
    int64_t qs = (int64_t)(sp & HALFMASK);
    int64_t qe = (int64_t)(ep & HALFMASK) + ep_len - 1;
    int64_t rs, re;
    if (is_rev) {
        rs = (int64_t)((((ep >> HALFBIT) - (uint64_t)((ep & HALFMASK) / (uint64_t)nskip))) & SOFFSMASK);
        rs -= (ep_len - ktup) / nskip;
        re = (int64_t)(((sp >> HALFBIT) - (uint64_t)(qs / nskip)) & SOFFSMASK);
    } else {
        rs = (int64_t)(((sp >> HALFBIT) + (uint64_t)(qs / nskip)) & SOFFSMASK);
        re = (int64_t)(((ep >> HALFBIT) + (uint64_t)((ep & HALFMASK) / (uint64_t)nskip)) & SOFFSMASK);
        re += (ep_len - ktup) / nskip;
    }
    *oqs = qs; *oqe = qe; *ors = rs; *ore = re;
}

/* out: n_cands x CAND_FIELDS int64 rows
 * {qs,qe,rs,re,shiftoffs,shift2mm,srange,cover,flag,nseg}.
 * maxcov_io: {max_cover, max2nd_cover} updated in place.
 * Returns number of candidates emitted. */
int64_t mc_cands_add(
    const uint64_t *seed_sqo, const int64_t *seed_len,
    const int64_t *seg_ix, int64_t *seg_nseed, const int64_t *seg_cover,
    const int64_t *hreg_idx, const int64_t *hreg_num, int64_t nreg,
    int ktup, int nskip, int64_t qlen, int is_reverse,
    int64_t mincover, uint8_t *maskbuf,
    int64_t *out, int64_t *maxcov_io)
{
    int64_t r, n_out = 0;
    for (r = 0; r < nreg; r++) {
        int64_t base = hreg_idx[r], num = hreg_num[r], i = 0;
        while (i < num) {
            int64_t seg = base + i, j, cover, l, i0, nsd;
            /* seed_cover_init */
            memset(maskbuf, 0, (size_t)qlen);
            i0 = seg_ix[seg];
            nsd = seg_nseed[seg]; if (nsd < 0) nsd = -nsd;
            for (l = 0; l < nsd; l++) {
                int64_t qo = (int64_t)(seed_sqo[i0 + l] & HALFMASK);
                int64_t e = qo + seed_len[i0 + l], t;
                if (e > qlen) e = qlen;
                for (t = qo; t < e; t++) maskbuf[t] = 1;
            }
            cover = seg_cover[seg];
            j = i + 1;
            while (j < num) {
                int64_t sj = base + j, cover_new = 0;
                if (seg_nseed[sj] < 0) break;
                i0 = seg_ix[sj];
                nsd = seg_nseed[sj]; if (nsd < 0) nsd = -nsd;
                for (l = 0; l < nsd; l++) {
                    int64_t qo = (int64_t)(seed_sqo[i0 + l] & HALFMASK);
                    int64_t e = qo + seed_len[i0 + l], t;
                    if (e > qlen) e = qlen;
                    for (t = qo; t < e; t++)
                        if (!maskbuf[t]) { cover_new++; maskbuf[t] = 1; }
                }
                if ((cover_new << 1) < seg_cover[sj] && cover >= mincover)
                    break;
                cover += cover_new;
                j++;
            }
            if (cover >= mincover) {
                /* derriveSEGCAND (segment.c:929-1057) */
                int64_t nseg = j - i, t;
                int64_t qs, qe, rs, re, q1, q2, r1, r2;
                int64_t shift_min, shift_2mm, last_shift, maxcover;
                int64_t shift_start, shift_range, diff_shift, flag = 0;
                int64_t *row;
                seg_bounds(seed_sqo, seed_len, seg_ix, seg_nseed, seg,
                           ktup, nskip, is_reverse, &qs, &qe, &rs, &re);
                shift_min = shift_2mm =
                    (int64_t)(seed_sqo[seg_ix[seg]] >> HALFBIT);
                maxcover = seg_cover[seg];
                last_shift = shift_min;
                for (t = 1; t < nseg; t++) {
                    int64_t sg = seg + t;
                    seg_bounds(seed_sqo, seed_len, seg_ix, seg_nseed, sg,
                               ktup, nskip, is_reverse, &q1, &q2, &r1, &r2);
                    if (seg_cover[sg] > maxcover) {
                        shift_2mm = (int64_t)(seed_sqo[seg_ix[sg]] >> HALFBIT);
                        maxcover = seg_cover[sg];
                    }
                    if (q1 < qs) qs = q1;
                    if (q2 > qe) qe = q2;
                    if (r1 < rs) rs = r1;
                    if (r2 > re) re = r2;
                    last_shift = (int64_t)(seed_sqo[seg_ix[sg]] >> HALFBIT);
                }
                if (is_reverse) {
                    flag |= FLAG_REVERSE;
                    shift_start = rs + (qe - ktup + 1) / nskip;
                } else {
                    shift_start = (int64_t)(((uint64_t)rs | OFFBIT)
                                            - (uint64_t)(qs / nskip));
                }
                shift_range = last_shift - shift_min;
                diff_shift = shift_min - shift_start;

                row = out + n_out * CAND_FIELDS;
                row[0] = qs; row[1] = qe; row[2] = rs; row[3] = re;
                row[4] = diff_shift;
                row[5] = 0;
                row[6] = shift_range;
                row[7] = cover;
                row[8] = flag;
                row[9] = nseg;
                if (maxcover >= mincover) {
                    row[8] |= FLAG_MMALI;
                    row[5] = shift_2mm - shift_start;
                }
                n_out++;

                for (t = i; t < j; t++) {
                    int64_t v = seg_nseed[base + t];
                    seg_nseed[base + t] = (v < 0) ? v : -v;
                }
                if (cover > maxcov_io[1]) {
                    if (cover > maxcov_io[0]) {
                        maxcov_io[1] = maxcov_io[0];
                        maxcov_io[0] = cover;
                    } else if (cover != maxcov_io[0]) {
                        maxcov_io[1] = cover;
                    }
                }
            }
            i = j;
        }
    }
    return n_out;
}

/* ---------------- traceback decode (makeMetaFromTrack) ---------------- */

#define DIFFCOD_M 0
#define DIFFCOD_D 1
#define DIFFCOD_I 2
#define DIFFCOD_S 3
#define MAXMISMATCH 61

/* Decode the banded direction matrix into the reversed diff string.
 * Mirrors alignment.c:628-784 via the Python replica in
 * smalt_tpu/align/core.py (_make_meta_from_track).
 * Returns 0, or -1 on checksum mismatch / bad traceback code.
 * out[0..5] = {nback, prof_start, prof_end, nonprof_start,
 * nonprof_end, checksum}; counts[8] filled when do_counts. */
int64_t mc_traceback(
    const int32_t *W, int64_t qlen, const uint8_t *subj,
    int64_t s_left, int64_t q_left, int64_t l_edge, int64_t band_width,
    int64_t max_i, int64_t max_j, int64_t max_scor,
    const uint8_t *dirm,
    int gap_init, int gap_ext, int do_counts,
    uint8_t *back, int64_t back_cap,
    int64_t *out, int64_t *counts)
{
    int64_t i = max_i, j = max_j;
    int64_t dpos = (max_i - s_left) * (band_width - 1) + max_j - l_edge;
    int64_t checksum = 0, nmatch = 0, nback = 0;
    int is_gap_open = 0;
    if (do_counts) memset(counts, 0, 8 * sizeof(int64_t));

    while (i >= s_left && j >= q_left && dirm[dpos]) {
        uint8_t d = dirm[dpos];
        if (nback + 2 > back_cap) return -1;
        if (d == 3) {                       /* DIA */
            int32_t s = W[(int64_t)(subj[i] & 7) * qlen + j];
            if (s > 0) {
                if (nmatch > MAXMISMATCH) {
                    back[nback++] = (uint8_t)((DIFFCOD_M << 6) | MAXMISMATCH);
                    nmatch -= MAXMISMATCH;
                } else {
                    nmatch++;
                }
            } else {
                back[nback++] = (uint8_t)((DIFFCOD_S << 6) | nmatch);
                nmatch = 0;
            }
            checksum += s;
            if (do_counts) counts[subj[i] & 7]++;
            is_gap_open = 0;
            dpos -= band_width;
            i--; j--;
            continue;
        }
        if (is_gap_open) checksum -= gap_ext;
        else { checksum -= gap_init; is_gap_open = 1; }
        if (d & 1) {                        /* COL: deletion */
            back[nback++] = (uint8_t)((DIFFCOD_D << 6) | nmatch);
            nmatch = 0;
            dpos -= band_width - 1;
            i--;
            continue;
        }
        if (!(d & 2)) return -1;            /* bad traceback code */
        back[nback++] = (uint8_t)((DIFFCOD_I << 6) | nmatch);
        nmatch = 0;
        dpos -= 1;
        j--;
    }
    if (nback + 2 > back_cap) return -1;
    back[nback++] = (uint8_t)((DIFFCOD_S << 6) | nmatch);
    back[nback++] = (uint8_t)(DIFFCOD_M << 6);

    if (checksum != max_scor) return -1;
    out[0] = nback;
    out[1] = j + 1;       /* prof_start */
    out[2] = max_j;       /* prof_end */
    out[3] = i + 1;       /* nonprof_start */
    out[4] = max_i;       /* nonprof_end */
    out[5] = checksum;
    return 0;
}

/* ---------------- fused per-strand collection ---------------- */

/* The whole of fillRMAPBUFF for one strand (rmap.c:1153-1227): hit
 * collection (whole-genome cutoff, or one pass per base interval /
 * reference sequence), seed/segment collation and candidate
 * derivation — one call instead of hundreds of crossings for
 * seq-by-seq references.
 *
 * mode 0: whole-genome cutoff (seqidx -1); mode 1: one pass per
 * ivals[v] = {lo_base, hi_base_excl, seqidx}.
 * out11 rows: {qs,qe,rs,re,shiftoffs,shift2mm,srange,cover,flag,nseg,
 * seqidx}.  Returns candidate count, or -1 if cap would overflow
 * (caller falls back to the unfused path). */
int64_t mc_collect_all(
    const int64_t *starts, const uint32_t *pos,
    const int64_t *qoffs, const int64_t *nhits, const int64_t *slot,
    const uint32_t *sidx, int64_t n_seeds_all, int64_t seed_rank,
    int64_t qlen, int ktup, int nskip, int is_reverse,
    int mode, int use_short, const int64_t *ivals, int64_t nivals,
    int64_t maxhit, int64_t budget,
    int64_t min_ktup, int64_t mincover,
    uint64_t *sqdat, uint8_t *qm,
    uint64_t *seed_sqo, int64_t *seed_len,
    int64_t *seg_ix, int64_t *seg_nseed, int64_t *seg_cover,
    int64_t *hreg_idx, int64_t *hreg_num, uint8_t *maskbuf,
    int64_t *rows10, int64_t rows10_cap,
    int64_t *out11, int64_t cap,
    int64_t *maxcov_io)
{
    int64_t n_out = 0, v;
    int64_t passes = (mode == 0) ? 1 : nivals;
    for (v = 0; v < passes; v++) {
        int64_t nh, nseed, nseg, nreg, maxcover, nc, seqidx, r;
        if (mode == 0) {
            int64_t nsel = seed_rank ? seed_rank : n_seeds_all;
            nh = mc_collect_cutoff(starts, pos, qoffs, nhits, slot, sidx,
                                   nsel, qlen, nskip, is_reverse,
                                   maxhit, budget, sqdat, qm);
            seqidx = -1;
        } else {
            int64_t nsel = (use_short && seed_rank > 0) ? seed_rank
                                                        : n_seeds_all;
            nh = mc_collect_segment(starts, pos, qoffs, nhits, slot, sidx,
                                    nsel, use_short, qlen, nskip,
                                    is_reverse, ivals[v * 3],
                                    ivals[v * 3 + 1], maxhit, budget,
                                    sqdat, qm);
            seqidx = ivals[v * 3 + 2];
        }
        if (nh == 0) continue;
        mc_seg_fill(sqdat, nh, qm, min_ktup, ktup, nskip, qlen,
                    seed_sqo, seed_len, seg_ix, seg_nseed, seg_cover,
                    hreg_idx, hreg_num, &nseed, &nseg, &nreg, &maxcover);
        if (nreg == 0) continue;
        if (nseg > rows10_cap) return -1;
        nc = mc_cands_add(seed_sqo, seed_len, seg_ix, seg_nseed, seg_cover,
                          hreg_idx, hreg_num, nreg, ktup, nskip, qlen,
                          is_reverse, mincover, maskbuf, rows10, maxcov_io);
        if (n_out + nc > cap) return -1;
        for (r = 0; r < nc; r++) {
            memcpy(out11 + n_out * 11, rows10 + r * 10,
                   10 * sizeof(int64_t));
            out11[n_out * 11 + 10] = seqidx;
            n_out++;
        }
    }
    return n_out;
}

/* ---------------- recursive multi-alignment driver ---------------- */

/* from swdp.c (same shared object) */
int sw_band_track(const int32_t *W, int qlen_prof,
                  const uint8_t *subj,
                  int l_edge, int r_edge, int q_left, int q_len,
                  int s_left, int s_len,
                  int gap_init, int gap_ext, int band_width,
                  uint8_t *dirm, int *max_i, int *max_j,
                  int32_t *Hbuf, int32_t *Ebuf);

/* initALIBAND (alignment.c:310-398), mirroring align/band.py.
 * Returns 0 ok, -1 band error.  Exported for the fast-lane's
 * device-assisted pass-1 replay (fastlane.c). */
int mc_ali_band_make(int64_t l_edge, int64_t r_edge,
                         int64_t q_left, int64_t q_right, int64_t q_len,
                         int64_t s_left, int64_t s_right, int64_t s_len,
                         int64_t *o_ledge, int64_t *o_redge,
                         int64_t *o_sleft, int64_t *o_slen,
                         int64_t *o_qleft, int64_t *o_qlen, int64_t *o_bw)
{
    int64_t b_s_len = (s_right < 0 || s_right >= s_len) ? s_len : s_right + 1;
    int64_t b_q_len = (q_right < 0 || q_right >= q_len) ? q_len : q_right + 1;
    int64_t b_s_left = (0 < s_left && s_left < b_s_len) ? s_left : 0;
    int64_t b_q_left = (0 < q_left && q_left < b_q_len) ? q_left : 0;
    int64_t l_orig = l_edge, r_orig = r_edge;
    int64_t bw = r_edge - l_edge + 1;
    if (bw <= 0) {
        l_edge = b_q_left;
        r_edge = b_q_len - 1;
    } else {
        if (l_orig + b_s_len > b_q_len) b_s_len = b_q_len - l_orig;
        l_edge += b_s_left;
        if (l_edge >= b_q_len || r_orig + b_s_len <= b_q_left) return -1;
        r_edge += b_s_left;
        if (r_edge < b_q_left) {
            b_s_left += b_q_left - r_edge;
            l_edge += b_q_left - r_edge;
            r_edge = b_q_left;
        }
        if (r_edge > b_q_len - 1) r_edge = b_q_len - 1;
    }
    bw = r_edge - l_edge + 1;
    if (bw < 0) return -1;
    *o_ledge = l_edge; *o_redge = r_edge;
    *o_sleft = b_s_left; *o_slen = b_s_len;
    *o_qleft = b_q_left; *o_qlen = b_q_len;
    *o_bw = bw;
    return 0;
}

/* diffStrReverse (diffstr.c), mirroring align/diffstr.py. */
static int64_t diff_reverse(const uint8_t *back, int64_t nback,
                            uint8_t *out, int64_t cap)
{
    int64_t l = 0, i, n = 0;
    int64_t count_prev, typ, count;
    while (l < nback && back[l]) l++;
    l--;
    count_prev = back[l] & 63;
    if ((back[l] >> 6) != DIFFCOD_S) return -1;
    for (i = l - 1; i >= 0; i--) {
        count = back[i] & 63;
        typ = back[i] >> 6;
        if (typ == DIFFCOD_M) {
            count_prev = (count_prev + count + 1) & 0xFF;
            if (count_prev > MAXMISMATCH) {
                if (n + 1 > cap) return -1;
                out[n++] = (uint8_t)((DIFFCOD_M << 6) | MAXMISMATCH);
                count_prev -= MAXMISMATCH + 1;
            }
        } else {
            if (n + 1 > cap) return -1;
            out[n++] = (uint8_t)((typ << 6) | count_prev);
            count_prev = count;
        }
    }
    if (n + 2 > cap) return -1;
    out[n++] = (uint8_t)((DIFFCOD_S << 6) | count_prev);
    out[n++] = (uint8_t)(DIFFCOD_M << 6);
    return n;
}

#define REC_STACK 128

/* ALICPLX scale (core.py CplxCounter.scale, alignment.c:81-305):
 * complexity-weight a traceback's score from the matched/mismatched
 * subject letter counts.  Replicates the Python float expression
 * verbatim (same op order, double throughout; int() == trunc). */
static int64_t mc_cplx_scale(const int64_t *cnt, int64_t orig, double lam)
{
    double t_factor = 0.0, t_sum = 0.0;
    int64_t t_counts = 0, adj;
    int i;
    for (i = 0; i < 8; i++) {
        int64_t c = cnt[i];
        if (c) {
            t_factor += (double)c * log((double)c);
            t_sum += (double)c * (-1.386294);   /* LN0P25 alignment.c:71 */
            t_counts += c;
        }
    }
    if (t_counts == 0) return orig;
    t_factor -= (double)t_counts * log((double)t_counts);
    t_sum -= t_factor;
    adj = (int64_t)((double)orig + t_sum / lam + 0.999);
    if (adj > orig) return adj;     /* ERRCODE_CPLXSCOR path */
    if (adj < 0) adj = 0;
    return adj;
}

/* alignSmiWatBandRecursive (alignment.c:1300-1434): after the best
 * local alignment of a band, recurse on the subject intervals left
 * and right of it; iterative worklist in the identical pre-order.
 * use_cplx (-w): rescale each traceback's score by letter-composition
 * complexity (lam = scoreMatrixCalcLambda); the SCALED score gates the
 * result, the recursion anchors stay on the raw alignment.
 *
 * res rows: {score, qs, qe, rs, re, diff_off, diff_len}; diff bytes
 * accumulate (forward-form) in diffpool.
 * Returns n results; -1 on scratch overflow; -2 on checksum error. */
int64_t mc_align_recursive(
    const int32_t *W, int64_t qlen, const uint8_t *subj, int64_t slen,
    int64_t l_edge, int64_t r_edge,
    int64_t q_left, int64_t q_right,
    int64_t s_left0, int64_t s_right0,
    int64_t minscore, int64_t minscorlen,
    int gap_init, int gap_ext,
    int32_t *Hbuf, int32_t *Ebuf,
    uint8_t *dirm, int64_t dirm_cap,
    uint8_t *back, int64_t back_cap,
    uint8_t *diffpool, int64_t diff_cap,
    int64_t *res, int64_t res_cap,
    int use_cplx, double lam)
{
    int64_t stack[REC_STACK][2];
    int sp = 0;
    int64_t n_res = 0, diff_used = 0;

    if (minscorlen < 2) return -2;
    stack[sp][0] = s_left0;
    stack[sp][1] = s_right0;
    sp++;
    while (sp > 0) {
        int64_t sl, sr, bl, br, bsl, bslen, bql, bqlen, bw;
        int max_i_, max_j_;
        int mi, mj;
        int64_t sc, rc, out6[6];
        sp--;
        sl = stack[sp][0];
        sr = stack[sp][1];
        if (mc_ali_band_make(l_edge, r_edge, q_left, q_right, qlen,
                          sl, sr, slen,
                          &bl, &br, &bsl, &bslen, &bql, &bqlen, &bw) != 0)
            continue;
        {
            int64_t nrows = bslen - bsl;
            int64_t ndir = bw * nrows;
            if (ndir < 1) ndir = 1;
            if (ndir > dirm_cap) return -1;
            memset(dirm, 0, (size_t)ndir);
        }
        sc = sw_band_track(W, (int)qlen, subj,
                           (int)bl, (int)br, (int)bql, (int)bqlen,
                           (int)bsl, (int)bslen,
                           gap_init, gap_ext, (int)bw,
                           dirm, &mi, &mj, Hbuf, Ebuf);
        if (sc < minscore) continue;
        max_i_ = mi; max_j_ = mj;
        {
            int64_t cnt8[8];
            rc = mc_traceback(W, qlen, subj, bsl, bql, bl, bw,
                              max_i_, max_j_, sc, dirm,
                              gap_init, gap_ext, use_cplx,
                              back, back_cap, out6, cnt8);
            if (rc != 0) return -2;
            if (use_cplx)
                sc = mc_cplx_scale(cnt8, sc, lam);
        }
        {
            int64_t ps = out6[1], pe = out6[2], ss = out6[3], se = out6[4];
            if (ps + minscorlen > pe + 1) continue;
            if (sc >= minscore) {   /* always true without cplx rescale */
                int64_t dn = diff_reverse(back, out6[0],
                                          diffpool + diff_used,
                                          diff_cap - diff_used);
                if (dn < 0) return -1;
                if (n_res >= res_cap) return -1;
                res[n_res * 7 + 0] = sc;
                res[n_res * 7 + 1] = ps;
                res[n_res * 7 + 2] = pe;
                res[n_res * 7 + 3] = ss;
                res[n_res * 7 + 4] = se;
                res[n_res * 7 + 5] = diff_used;
                res[n_res * 7 + 6] = dn;
                diff_used += dn;
                n_res++;
            }
            /* pre-order: left sub-interval first -> push right, then left */
            if (sp + 2 > REC_STACK) return -1;
            if (sr > se + minscorlen) {
                stack[sp][0] = se + 1;
                stack[sp][1] = sr;
                sp++;
            }
            if (sl + minscorlen < ss) {
                stack[sp][0] = sl;
                stack[sp][1] = ss - 1;
                sp++;
            }
        }
    }
    return n_res;
}

/* ---------------- device pass-2 record decode ---------------- */

/* Decode the device walk records (parallel/exact_pass2.py) into the
 * reversed back codes, replaying mc_traceback's emission against the
 * host profile/subject and verifying the telescoped checksum.  One
 * int16 per subject row i in [final_i, max_i]: (nins << 2) | typ with
 * typ 3 DIA, 1 COL, 2 clean stop, 0 suspect (host dpos-alias hazard:
 * refuse).  Returns 0 ok, -3 on any doubt (caller re-runs the host
 * DP), -1 on back_cap. */
static int64_t dev_walk_decode(
    const int32_t *W, int64_t qlen, const uint8_t *subj,
    int64_t s_left, int64_t q_left,
    int64_t max_i, int64_t max_j, int64_t max_scor,
    const int16_t *rec, int64_t nrows,
    int gap_init, int gap_ext, int do_counts,
    uint8_t *back, int64_t back_cap, int64_t *out6, int64_t *counts)
{
    int64_t i = max_i, j = max_j;
    int64_t checksum = 0, nmatch = 0, nback = 0;
    int is_gap_open = 0;
    if (max_i < 0 || max_i >= nrows || max_j < 0 || max_j >= qlen)
        return -3;
    if (do_counts) memset(counts, 0, 8 * sizeof(int64_t));
    while (i >= s_left && j >= q_left) {
        int64_t v = rec[i], typ = v & 3, nins = v >> 2, t;
        if (j - nins < q_left - 1) return -3;
        for (t = 0; t < nins; t++) {
            if (nback + 2 > back_cap) return -1;
            checksum -= is_gap_open ? gap_ext : gap_init;
            is_gap_open = 1;
            back[nback++] = (uint8_t)((DIFFCOD_I << 6) | nmatch);
            nmatch = 0;
            j--;
        }
        if (typ == 0) return -3;             /* suspect stop */
        if (typ == 2) break;                 /* clean stop */
        if (nback + 2 > back_cap) return -1;
        if (typ == 3) {
            int32_t s = W[(int64_t)(subj[i] & 7) * qlen + j];
            if (s > 0) {
                if (nmatch > MAXMISMATCH) {
                    back[nback++] = (uint8_t)((DIFFCOD_M << 6) |
                                              MAXMISMATCH);
                    nmatch -= MAXMISMATCH;
                } else {
                    nmatch++;
                }
            } else {
                back[nback++] = (uint8_t)((DIFFCOD_S << 6) | nmatch);
                nmatch = 0;
            }
            checksum += s;
            if (do_counts) counts[subj[i] & 7]++;
            is_gap_open = 0;
            i--;
            j--;
        } else {                             /* typ == 1: COL */
            checksum -= is_gap_open ? gap_ext : gap_init;
            is_gap_open = 1;
            back[nback++] = (uint8_t)((DIFFCOD_D << 6) | nmatch);
            nmatch = 0;
            i--;
        }
    }
    if (nback + 2 > back_cap) return -1;
    back[nback++] = (uint8_t)((DIFFCOD_S << 6) | nmatch);
    back[nback++] = (uint8_t)(DIFFCOD_M << 6);
    if (checksum != max_scor) return -3;
    out6[0] = nback;
    out6[1] = j + 1;
    out6[2] = max_j;
    out6[3] = i + 1;
    out6[4] = max_i;
    out6[5] = checksum;
    return 0;
}

/* mc_align_recursive with the FIRST interval's fill + walk supplied by
 * the device (best score, argmax cell, walk records); the recursion's
 * sub-intervals run the normal host DP.  On any decode doubt sets
 * *o_used = 0 and returns 0 WITHOUT touching the outputs — the caller
 * must then run the plain host mc_align_recursive.  Otherwise
 * *o_used = 1 and the result contract matches mc_align_recursive. */
int64_t mc_align_recursive_dev(
    const int32_t *W, int64_t qlen, const uint8_t *subj, int64_t slen,
    int64_t l_edge, int64_t r_edge,
    int64_t q_left, int64_t q_right,
    int64_t s_left0, int64_t s_right0,
    int64_t minscore, int64_t minscorlen,
    int gap_init, int gap_ext,
    int32_t *Hbuf, int32_t *Ebuf,
    uint8_t *dirm, int64_t dirm_cap,
    uint8_t *back, int64_t back_cap,
    uint8_t *diffpool, int64_t diff_cap,
    int64_t *res, int64_t res_cap,
    int use_cplx, double lam,
    int64_t dev_best, int64_t dev_mi, int64_t dev_mj,
    const int16_t *dev_rec, int64_t dev_nrows,
    int64_t *o_used)
{
    int64_t stack[REC_STACK][2];
    int sp = 0, first = 1;
    int64_t n_res = 0, diff_used = 0;

    *o_used = 1;
    if (minscorlen < 2) return -2;
    stack[sp][0] = s_left0;
    stack[sp][1] = s_right0;
    sp++;
    while (sp > 0) {
        int64_t sl, sr, bl, br, bsl, bslen, bql, bqlen, bw;
        int64_t max_i_, max_j_;
        int64_t sc, rc, out6[6];
        int is_first;
        sp--;
        sl = stack[sp][0];
        sr = stack[sp][1];
        is_first = first;
        first = 0;
        if (mc_ali_band_make(l_edge, r_edge, q_left, q_right, qlen,
                          sl, sr, slen,
                          &bl, &br, &bsl, &bslen, &bql, &bqlen, &bw) != 0)
            continue;
        if (is_first) {
            sc = dev_best;
            if (sc < minscore) continue;
            {
                int64_t cnt8[8];
                rc = dev_walk_decode(W, qlen, subj, bsl, bql,
                                     dev_mi, dev_mj, sc,
                                     dev_rec, dev_nrows,
                                     gap_init, gap_ext, use_cplx,
                                     back, back_cap, out6, cnt8);
                if (rc == -3) { *o_used = 0; return 0; }
                if (rc != 0) return rc;
                if (use_cplx)
                    sc = mc_cplx_scale(cnt8, sc, lam);
            }
        } else {
            int mi, mj;
            int64_t nrows = bslen - bsl;
            int64_t ndir = bw * nrows;
            if (ndir < 1) ndir = 1;
            if (ndir > dirm_cap) return -1;
            memset(dirm, 0, (size_t)ndir);
            sc = sw_band_track(W, (int)qlen, subj,
                               (int)bl, (int)br, (int)bql, (int)bqlen,
                               (int)bsl, (int)bslen,
                               gap_init, gap_ext, (int)bw,
                               dirm, &mi, &mj, Hbuf, Ebuf);
            if (sc < minscore) continue;
            {
                int64_t cnt8[8];
                rc = mc_traceback(W, qlen, subj, bsl, bql, bl, bw,
                                  mi, mj, sc, dirm,
                                  gap_init, gap_ext, use_cplx,
                                  back, back_cap, out6, cnt8);
                if (rc != 0) return -2;
                if (use_cplx)
                    sc = mc_cplx_scale(cnt8, sc, lam);
            }
        }
        {
            int64_t ps = out6[1], pe = out6[2], ss = out6[3], se = out6[4];
            if (ps + minscorlen > pe + 1) continue;
            if (sc >= minscore) {
                int64_t dn = diff_reverse(back, out6[0],
                                          diffpool + diff_used,
                                          diff_cap - diff_used);
                if (dn < 0) return -1;
                if (n_res >= res_cap) return -1;
                res[n_res * 7 + 0] = sc;
                res[n_res * 7 + 1] = ps;
                res[n_res * 7 + 2] = pe;
                res[n_res * 7 + 3] = ss;
                res[n_res * 7 + 4] = se;
                res[n_res * 7 + 5] = diff_used;
                res[n_res * 7 + 6] = dn;
                diff_used += dn;
                n_res++;
            }
            if (sp + 2 > REC_STACK) return -1;
            if (sr > se + minscorlen) {
                stack[sp][0] = se + 1;
                stack[sp][1] = sr;
                sp++;
            }
            if (sl + minscorlen < ss) {
                stack[sp][0] = sl;
                stack[sp][1] = ss - 1;
                sp++;
            }
        }
    }
    return n_res;
}

/* ---------------- pass-1 candidate scoring ---------------- */

/* from swdp.c */
int sw_band_fast(const int32_t *W, int qlen_prof, const uint8_t *subj,
                 int l_edge, int r_edge, int q_left, int q_len,
                 int s_left, int s_len, int gap_init, int gap_ext,
                 int32_t *Hbuf, int32_t *Ebuf);
int sw_full(const int32_t *W, int qlen, const uint8_t *subj, int slen,
            int gap_init, int gap_ext, int32_t *Hbuf, int32_t *Ebuf);
/* prepared per-read striped profile (swdp.c): build once per
 * read/strand, score every candidate window against it; identical
 * scores and refusal conditions to sw_full's 8-bit first try */
int sw_prof8_set(int slot, const int32_t *W, int qlen,
                 int gap_init, int gap_ext);
int sw_prof8_score(int slot, const uint8_t *subj, int slen);
int sw_full_wide(const int32_t *W, int qlen, const uint8_t *subj,
                 int slen, int gap_init, int gap_ext,
                 int32_t *Hbuf, int32_t *Ebuf);

#define EDGE_BAND_FACTOR 4     /* segment.c:137 */
#define MAX_BANDEDGE_2POW 4    /* segment.c:142 */
#define MINLEN_QUERY_STRIPED 32
#define BWSCAL_QLEN 48

/* segAliCandsCalcSegmentOffsets (segment.c:1861-1985) for one cand
 * row (edgelen = 0, the SIMD build).  Returns 0 ok, -1 assert-fail.
 * Exported for the fast-lane's device-assisted pass-1 (fastlane.c). */
int mc_calc_seg_offsets(const int64_t *row, int ktup, int nskip,
                            const int64_t *offsets, int64_t nseq,
                            int64_t qlen,
                            int64_t *o_qs, int64_t *o_qe,
                            int64_t *o_rs, int64_t *o_re,
                            int64_t *o_bl, int64_t *o_br)
{
    int64_t c_qs = row[0], c_qe = row[1], c_rs = row[2], c_re = row[3];
    int64_t shiftoffs = row[4], srange = row[6], cover = row[7];
    int64_t flag = row[8], seqidx = row[10];
    int64_t roffs, rlen, rs, re, qs, qe;
    int64_t edge_band, br, bl, q_edge_l, q_edge_r, r_edge_l, r_edge_r;
    int64_t band_offs;

    if (seqidx < 0 || seqidx >= nseq) {
        roffs = 0;
        rlen = offsets[nseq];
    } else {
        roffs = offsets[seqidx];
        rlen = offsets[seqidx + 1] - roffs;
    }
    rs = c_rs * nskip;
    re = c_re * nskip + ktup - 1;
    if (rs < roffs || re < rs) return -1;
    rs -= roffs;
    re -= roffs;
    if (re >= rlen) return -1;
    if (c_qe < c_qs || c_qs >= qlen) return -1;

    if (flag & FLAG_REVERSE) {
        qs = qlen - c_qe - 1;
        qe = qlen - c_qs - 1;
    } else {
        qs = c_qs;
        qe = c_qe;
    }
    edge_band = (qlen - cover) / EDGE_BAND_FACTOR;
    if (edge_band > nskip) {
        if (edge_band > (qlen >> MAX_BANDEDGE_2POW))
            edge_band = qlen >> MAX_BANDEDGE_2POW;
        edge_band -= nskip - 1;
    } else {
        edge_band = 0;
    }
    br = (-shiftoffs + 1) * nskip + edge_band + 1;
    bl = br - (srange + 2) * nskip - 2 * edge_band - 2;

    q_edge_l = qs;          /* edgelen = 0 */
    q_edge_r = qlen - qe - 1;
    qs -= q_edge_l;
    qe += q_edge_r;

    r_edge_l = q_edge_l + br;
    r_edge_r = q_edge_r - bl;

    if (r_edge_l > 0 && rs < r_edge_l) {
        r_edge_l = rs;
        rs = 0;
    } else {
        rs -= r_edge_l;
    }
    if (re + r_edge_r >= rlen) {
        re = rlen - 1;
    } else {
        re += r_edge_r;
    }
    if (re < rs) return -1;

    band_offs = q_edge_l - r_edge_l;
    *o_bl = bl + band_offs + qs;
    *o_br = br + band_offs + qs;
    *o_qs = qs;
    *o_qe = qe;
    *o_rs = rs;
    *o_re = re;
    return 0;
}

/* scoreRMAPCAND (rmap.c:588-788): score the depth-selected candidates
 * with the full-matrix kernel (full-length reads in wide bands) or
 * the banded-fast kernel, applying the early-break coverage logic and
 * running maxima.
 * out rows [i, 10]: {qs,qe,rs,re,band_l,band_r,sqidx,is_rev,swscor,
 * scored(=1)}.  out_max = {max1, max2, n_emitted}.
 * Returns 0, or -1 on a window-geometry assert (caller falls back). */
int64_t mc_score_cands(
    const int64_t *rows, const uint32_t *sort_idx, int64_t n_sort,
    int ktup, int nskip,
    const uint8_t *refcodes, const int64_t *offsets, int64_t nseq,
    int64_t qlen,
    const int32_t *Wf, const int32_t *Wr,
    int gap_init, int gap_ext,
    int64_t match_avg, int64_t mismatch_avg,
    int rmapflg_best, int64_t deficit_f, int64_t deficit_r,
    int32_t *Hbuf, int32_t *Ebuf,
    int64_t *out, int64_t *out_max)
{
    int64_t mmscordiff = match_avg - mismatch_avg;
    int64_t max1 = 0, max2 = 0, min_cover = 0, max_cover = 0;
    int64_t i, n_out = 0;
    int prof_state[2] = {-2, -2};   /* per strand: -2 unbuilt,
                                     * -1 unsuitable, 0 ready */
    for (i = 0; i < n_sort; i++) {
        const int64_t *row = rows + (int64_t)sort_idx[i] * 11;
        int64_t qs, qe, rs, re, bl, br;
        int64_t cover = row[7], seqidx = row[10], cdf;
        int is_rev = (int)(row[8] & FLAG_REVERSE);
        const uint8_t *subj;
        int64_t slen, swscor;
        const int32_t *W = is_rev ? Wr : Wf;
        if (mc_calc_seg_offsets(row, ktup, nskip, offsets, nseq, qlen,
                             &qs, &qe, &rs, &re, &bl, &br) != 0)
            return -1;
        subj = refcodes + ((seqidx >= 0 && seqidx < nseq)
                           ? offsets[seqidx] + rs : rs);
        slen = re - rs + 1;
        if (qlen >= MINLEN_QUERY_STRIPED &&
            (br - bl) * BWSCAL_QLEN > qlen && qs == 0 && qe >= qlen - 1) {
            int sl = is_rev ? 1 : 0, r8 = -1;
            if (prof_state[sl] == -2)
                prof_state[sl] = sw_prof8_set(sl, W, (int)qlen,
                                              gap_init, gap_ext);
            if (prof_state[sl] == 0)
                r8 = sw_prof8_score(sl, subj, (int)slen);
            swscor = (r8 >= 0) ? r8
                     : sw_full_wide(W, (int)qlen, subj, (int)slen,
                                    gap_init, gap_ext, Hbuf, Ebuf);
        } else {
            int64_t abl, abr, asl, aslen, aql, aqlen, abw;
            if (mc_ali_band_make(bl, br, qs, qe, qlen, 0, slen - 1, slen,
                              &abl, &abr, &asl, &aslen, &aql, &aqlen,
                              &abw) != 0)
                swscor = 0;
            else
                swscor = sw_band_fast(W, (int)qlen, subj,
                                      (int)abl, (int)abr, (int)aql,
                                      (int)aqlen, (int)asl, (int)aslen,
                                      gap_init, gap_ext, Hbuf, Ebuf);
        }
        cdf = is_rev ? deficit_r : deficit_f;
        if (rmapflg_best && cover + cdf < min_cover)
            break;                      /* truncate at the break index */
        {
            int64_t *o = out + n_out * 10;
            o[0] = qs; o[1] = qe; o[2] = rs; o[3] = re;
            o[4] = bl; o[5] = br; o[6] = seqidx;
            o[7] = is_rev; o[8] = swscor; o[9] = 1;
            n_out++;
        }
        if (swscor > max2) {
            if (swscor > max1) {
                max2 = max1;
                max1 = swscor;
                if (cover + cdf > max_cover)
                    max_cover = (cover > cdf) ? cover - cdf : 0;
            } else {
                max2 = swscor;
            }
            {
                int64_t dcov = ((max1 - max2) / mmscordiff + 1) * nskip;
                if (dcov + cdf + min_cover < max_cover)
                    min_cover = max_cover - dcov;
            }
        }
    }
    out_max[0] = max1;
    out_max[1] = max2;
    out_max[2] = n_out;
    return 0;
}

/* ---------------- fused two-strand short hit info ---------------- */

/* hashCollectHitInfoShort for BOTH strands in one call (collect, NR
 * sort by hit count, rank selection with the short-variant cover
 * thresholds, hashhit.c:1007-1082).  out = {nF, rankF, nR, rankR}.
 * Returns 0, or -1 for a read shorter than the word. */
int64_t mc_hitinfo_short2(
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table, int wordlen, int nskip,
    const uint8_t *codes, const uint8_t *qual, int64_t qlen,
    int64_t maxhit_per_tuple, int64_t maxhit_total, int basq_thresh,
    uint8_t *qmaskF, int64_t *qoffsF, int64_t *nhitsF, int64_t *slotF,
    uint32_t *sidxF,
    uint8_t *qmaskR, int64_t *qoffsR, int64_t *nhitsR, int64_t *slotR,
    uint32_t *sidxR,
    uint8_t *qbuf, uint32_t *keybuf,
    int64_t *out)
{
    int strand;
    int64_t mincover = 2 * (int64_t)wordlen + nskip;
    int64_t maxcover = qlen * 80 / 100;
    if (maxcover < wordlen + nskip) maxcover = wordlen + nskip;
    else if (maxcover > qlen - nskip) maxcover = qlen - nskip;
    if (mincover > maxcover) { mincover = 0; maxcover = qlen; }

    for (strand = 0; strand < 2; strand++) {
        uint8_t *qmask = strand ? qmaskR : qmaskF;
        int64_t *qoffs = strand ? qoffsR : qoffsF;
        int64_t *nhits = strand ? nhitsR : nhitsF;
        int64_t *slot = strand ? slotR : slotF;
        uint32_t *sidx = strand ? sidxR : sidxF;
        int64_t n, i, rank;
        n = mc_hitinfo_collect(words, starts, nwords, table,
                               wordlen, nskip, codes, qual, qlen,
                               strand, maxhit_per_tuple, basq_thresh,
                               0, 0, qmask, qoffs, nhits, slot);
        if (n < 0) return -1;
        for (i = 0; i < n; i++) sidx[i] = (uint32_t)i;
        if (n <= 1) {
            rank = n;
        } else {
            for (i = 0; i < n; i++) keybuf[i] = (uint32_t)nhits[i];
            if (nr_sort2(keybuf, sidx, (int)n) != 0) return -1;
            rank = mc_max_rank(qoffs, nhits, sidx, n, qlen,
                               wordlen, nskip, mincover, maxcover,
                               maxhit_total, qbuf);
        }
        out[strand * 2] = n;
        out[strand * 2 + 1] = rank;
    }
    return 0;
}

/* ---------------- fast-mode tail: one-call align ---------------- */

/* Fast-mode traceback helper: optional reverse complement, profile
 * build (W[a][j] = matrix[a][alpha(q[j])]) and the recursive banded
 * alignment in a single crossing.  Returns mc_align_recursive's
 * result count / error codes. */
int64_t mc_fast_align(
    const uint8_t *qcodes, int64_t qlen, int do_revcomp,
    const int32_t *matrix,
    const uint8_t *subj, int64_t slen,
    int64_t l_edge, int64_t r_edge,
    int64_t minscore, int64_t minscorlen,
    int gap_init, int gap_ext,
    int32_t *Wbuf,
    int32_t *Hbuf, int32_t *Ebuf,
    uint8_t *dirm, int64_t dirm_cap,
    uint8_t *back, int64_t back_cap,
    uint8_t *diffpool, int64_t diff_cap,
    int64_t *res, int64_t res_cap)
{
    int64_t j;
    int a;
    for (j = 0; j < qlen; j++) {
        uint8_t c = do_revcomp ? qcodes[qlen - 1 - j] : qcodes[j];
        uint8_t al = (uint8_t)((c & 4) ? (c & 7)
                               : (do_revcomp ? ((~c) & 3) : (c & 3)));
        for (a = 0; a < 8; a++)
            Wbuf[(int64_t)a * qlen + j] = matrix[a * 8 + al];
    }
    return mc_align_recursive(Wbuf, qlen, subj, slen,
                              l_edge, r_edge, 0, qlen - 1, 0, slen - 1,
                              minscore, minscorlen, gap_init, gap_ext,
                              Hbuf, Ebuf, dirm, dirm_cap,
                              back, back_cap, diffpool, diff_cap,
                              res, res_cap, 0, 1.0);
}

/* ---------------- device-canonical tail (short-read fast mode) ------ */

/* from swdp.c */
int sw_dev_track(const int32_t *W, int qlen, const uint8_t *subj, int slen,
                 int gap_init, int gap_ext,
                 uint8_t *dirm, int *max_i_out, int *max_j_out,
                 int32_t *Hbuf, int32_t *Ebuf);

/* Exact-cost traceback over sw_dev_track's state bytes.  Walks the
 * H/E/F/H0 state machine from (max_i, max_j), emitting the reversed
 * back codes of mc_traceback's grammar; the checksum must reproduce
 * max_scor exactly (each gap step subtracts gap_init when its state
 * bit says "opened", gap_ext when "chained" — the formation chain the
 * fill recorded, so the telescoped sum is exact by construction).
 * out6 as mc_traceback.  Returns 0, -1 cap, -2 checksum. */
static int64_t mc_dev_walk(const int32_t *W, int64_t qlen,
                           const uint8_t *subj, const uint8_t *dirm,
                           int64_t max_i, int64_t max_j, int64_t max_scor,
                           int gap_init, int gap_ext,
                           uint8_t *back, int64_t back_cap, int64_t *out6)
{
    int64_t i = max_i, j = max_j, checksum = 0, nmatch = 0, nback = 0;
    int state = 0;   /* 0 H, 1 E, 2 F, 3 H0 */
    while (i >= 0 && j >= 0) {
        uint8_t b = dirm[i * qlen + j];
        if (nback + 2 > back_cap) return -1;
        if (state == 0 || state == 3) {
            uint8_t d = (state == 0) ? (uint8_t)(b & 3)
                                     : (uint8_t)((b >> 4) & 3);
            if (d == 0) break;
            if (d == 3) {               /* DIA */
                int32_t s = W[(int64_t)(subj[i] & 7) * qlen + j];
                if (s > 0) {
                    if (nmatch > MAXMISMATCH) {
                        back[nback++] =
                            (uint8_t)((DIFFCOD_M << 6) | MAXMISMATCH);
                        nmatch -= MAXMISMATCH;
                    } else {
                        nmatch++;
                    }
                } else {
                    back[nback++] = (uint8_t)((DIFFCOD_S << 6) | nmatch);
                    nmatch = 0;
                }
                checksum += s;
                i--; j--;
                state = 0;
                continue;
            }
            if (d == 1) { state = 1; continue; }       /* H(0) == E */
            if (state == 3) return -2;                 /* H0 can't be F */
            state = 2;                                 /* H == F */
            continue;
        }
        if (state == 1) {               /* E: one deletion (subject) */
            int eo = (i > 0) ? ((dirm[(i - 1) * qlen + j] >> 2) & 1) : 1;
            back[nback++] = (uint8_t)((DIFFCOD_D << 6) | nmatch);
            nmatch = 0;
            checksum -= eo ? gap_init : gap_ext;
            i--;
            state = eo ? 0 : 1;
            continue;
        }
        /* state == 2, F: one insertion (query) */
        {
            int fo = (b >> 3) & 1;
            back[nback++] = (uint8_t)((DIFFCOD_I << 6) | nmatch);
            nmatch = 0;
            checksum -= fo ? gap_init : gap_ext;
            j--;
            state = fo ? 3 : 2;
        }
    }
    if (nback + 2 > back_cap) return -1;
    back[nback++] = (uint8_t)((DIFFCOD_S << 6) | nmatch);
    back[nback++] = (uint8_t)(DIFFCOD_M << 6);
    if (checksum != max_scor) return -2;
    out6[0] = nback;
    out6[1] = j + 1;
    out6[2] = max_j;
    out6[3] = i + 1;
    out6[4] = max_i;
    out6[5] = checksum;
    return 0;
}

/* One-call fast-mode tail alignment against the device contract.
 *
 * The device kernel reports, per winning window, its score and the
 * row-major-first argmax cell (ti, tj) of T = Hdiag + W.  Given those,
 * the optimal alignment is recovered without any DP whenever the
 * diagonal run ending at (ti, tj) sums to sc_hint with every proper
 * suffix in (0, sc_hint) — then the device-canonical DP provably
 * tracebacks exactly that run (diagonal-preferred ties; a violated
 * precondition would contradict (ti, tj) being the first argmax).
 * Otherwise (gapped alignments, clamped windows, ti < 0) the full
 * device-canonical DP runs host-side (sw_dev_track + mc_dev_walk) —
 * identical recurrence, identical argmax rule, so the two paths agree
 * whenever both apply.
 *
 * res: one 7-int row {sc, ps, pe, ss, se, diff_off(=0), diff_len}.
 * Returns 1 (aligned), 0 (below minscore), -1 cap, -2 internal. */
int64_t mc_dev_align(
    const uint8_t *qcodes, int64_t qlen, int do_revcomp,
    const int32_t *matrix,
    const uint8_t *subj, int64_t slen,
    int64_t ti, int64_t tj, int64_t sc_hint,
    int64_t minscore,
    int gap_init, int gap_ext,
    int32_t *Wbuf, int32_t *Hbuf, int32_t *Ebuf,
    uint8_t *dirm, int64_t dirm_cap,
    uint8_t *back, int64_t back_cap,
    uint8_t *diffpool, int64_t diff_cap,
    int64_t *res)
{
    int64_t j, dn, out6[6];
    int a;
    if (slen < 1 || qlen < 1) return 0;
    for (j = 0; j < qlen; j++) {
        uint8_t c = do_revcomp ? qcodes[qlen - 1 - j] : qcodes[j];
        uint8_t al = (uint8_t)((c & 4) ? (c & 7)
                               : (do_revcomp ? ((~c) & 3) : (c & 3)));
        for (a = 0; a < 8; a++)
            Wbuf[(int64_t)a * qlen + j] = matrix[a * 8 + al];
    }
    if (ti >= 0 && ti < slen && tj >= 0 && tj < qlen &&
        sc_hint >= minscore) {
        int64_t c = 0, k = -1, m;
        int64_t lim = ti < tj ? ti : tj;
        for (m = 0; m <= lim; m++) {
            c += Wbuf[(int64_t)(subj[ti - m] & 7) * qlen + (tj - m)];
            if (c >= sc_hint) {
                if (c == sc_hint) k = m;
                break;      /* c > sc_hint would contradict the max */
            }
            if (c <= 0) break;  /* dead suffix: contradicts first-argmax */
        }
        if (k >= 0) {
            int64_t nback = 0, nmatch = 0, mm;
            for (mm = 0; mm <= k; mm++) {
                int32_t s = Wbuf[(int64_t)(subj[ti - mm] & 7) * qlen +
                                 (tj - mm)];
                if (nback + 2 > back_cap) return -1;
                if (s > 0) {
                    if (nmatch > MAXMISMATCH) {
                        back[nback++] =
                            (uint8_t)((DIFFCOD_M << 6) | MAXMISMATCH);
                        nmatch -= MAXMISMATCH;
                    } else {
                        nmatch++;
                    }
                } else {
                    back[nback++] = (uint8_t)((DIFFCOD_S << 6) | nmatch);
                    nmatch = 0;
                }
            }
            if (nback + 2 > back_cap) return -1;
            back[nback++] = (uint8_t)((DIFFCOD_S << 6) | nmatch);
            back[nback++] = (uint8_t)(DIFFCOD_M << 6);
            dn = diff_reverse(back, nback, diffpool, diff_cap);
            if (dn < 0) return -1;
            res[0] = sc_hint;
            res[1] = tj - k;
            res[2] = tj;
            res[3] = ti - k;
            res[4] = ti;
            res[5] = 0;
            res[6] = dn;
            return 1;
        }
    }
    if (qlen * slen > dirm_cap) return -1;
    {
        int mi, mj;
        int64_t rc;
        int64_t sc = sw_dev_track(Wbuf, (int)qlen, subj, (int)slen,
                                  gap_init, gap_ext, dirm, &mi, &mj,
                                  Hbuf, Ebuf);
        if (sc < minscore) return 0;
        rc = mc_dev_walk(Wbuf, qlen, subj, dirm, mi, mj, sc,
                         gap_init, gap_ext, back, back_cap, out6);
        if (rc != 0) return rc;
        dn = diff_reverse(back, out6[0], diffpool, diff_cap);
        if (dn < 0) return -1;
        res[0] = sc;
        res[1] = out6[1];
        res[2] = out6[2];
        res[3] = out6[3];
        res[4] = out6[4];
        res[5] = 0;
        res[6] = dn;
        return 1;
    }
}
