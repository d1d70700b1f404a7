/* C fast-lane for the exact single-end mapping path.
 *
 * One call maps a whole block of encoded reads to final SAM text,
 * replicating the Python reference path exactly:
 *
 *   rmap_single          map/engine.py:539  (rmap.c:1648)
 *   map_single_read      map/engine.py:447  (rmap.c:1228)
 *   seg_cands_stats      segment/collate.py:419 (segment.c:1616)
 *   ResultSet            results/result.py  (results.c)
 *   add_single_to_report results/pairs.py:521 (results.c:2282)
 *   SAM line             report/report.py:280 (report.c:762-906)
 *   drand48 stream       rand.py            (randef.h:19-20)
 *
 * The Python path stays as the oracle: the pipeline falls back to it
 * for any mode this lane does not cover, and for any block where this
 * lane reports an error (no RNG state is consumed on failure).
 *
 * Coverage: single-end reads, RMAPFLG_BEST, both collection regimes
 * (seq-by-seq under 512 sequences AND whole-genome cutoff collection
 * with post-pass-2 sequence assignment — boundary-spanning alignments
 * fall back for splitMultiSpan), split mode (-p: secondary
 * complement-segment pass + PARTIAL records), SAM, plain-cigar and
 * ssaha output (soft/hard clip, optional -x), complexity weighting
 * (-w via RMAPFLG_CMPLXW + lam); the pair lane additionally covers
 * the -g insert histogram (FLInsHist cumulative bins in
 * flp_assign_prob).
 */
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

/* Env-gated stage profiler (SMALT_FL_TIMING): one quantity a slot,
 * accumulated across calls, fetched (and optionally reset) from Python
 * via fl_prof_fetch (native/__init__.py names every slot, in this
 * order).  Stages, seconds, additive: seed/collate, pass-1 candidate
 * scoring, pass-2 align+mapq+filter, report+SAM render, the pair
 * block's hit-info probe and its pair report.  Sub-splits, seconds
 * WITHIN the stages (not additive with them): hit-info scan, hit
 * collection/collation, candidate stats+deficits, striped-profile
 * build, pass-2 DP+traceback only, pass-2 sort/mapq/filter tail, and
 * the host re-mapping of reads the device-exact lane re-staged (taken
 * batch by batch with fl_prof_take).  Counts: pass-2 gapless-shortcut
 * fires, pass-2 full-DP runs, the fast tail's full-band retries and
 * their summed score gap (-1 a retry without a traceback). */
enum {
    FLP_SEED, FLP_PASS1, FLP_PASS2, FLP_REPORT, FLP_PAIR_PROBE,
    FLP_PAIR_REPORT,
    FLP_HITINFO, FLP_COLLECT, FLP_CANDSTATS, FLP_PROFILES, FLP_P2_DP,
    FLP_P2_POST, FLP_REMAP,
    FLP_SHORTCUT, FLP_DP_RUNS, FLP_FAST_RETRY, FLP_FAST_RETRY_GAP,
    FL_PROF_N
};
static int fl_prof_on = -1;
static double fl_prof_acc[FL_PROF_N];

static double fl_prof_now(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

static int fl_prof(void)
{
    if (fl_prof_on < 0)
        fl_prof_on = getenv("SMALT_FL_TIMING") != NULL;
    return fl_prof_on;
}

int64_t fl_prof_fetch(double *out, int reset)
{
    int i;
    for (i = 0; i < FL_PROF_N; i++) out[i] = fl_prof_acc[i];
    if (reset) memset(fl_prof_acc, 0, sizeof fl_prof_acc);
    return FL_PROF_N;
}

/* The profiler on or off from now on, whatever SMALT_FL_TIMING said
 * when it was first asked (a lane that starts reads the variable). */
void fl_prof_set(int on)
{
    fl_prof_on = on != 0;
}

/* One slot's value since its last take, and the slot set to zero. */
double fl_prof_take(int64_t slot)
{
    double v;
    if (slot < 0 || slot >= FL_PROF_N) return 0.0;
    v = fl_prof_acc[slot];
    fl_prof_acc[slot] = 0.0;
    return v;
}

/* Why fl_exact_post_block re-staged reads, always counted: the
 * fallback flag it was given, the hit-info checksum, the depth stats,
 * the geometry and the SIMD cross-check against the device's scores.
 * Each re-staged read counts under exactly one cause. */
enum { FL_RS_DEV, FL_RS_CK, FL_RS_STATS, FL_RS_GEOM, FL_RS_SIMD, FL_RS_N };
static int64_t fl_restage_acc[FL_RS_N];

int64_t fl_restage_fetch(int64_t *out, int reset)
{
    int i;
    for (i = 0; i < FL_RS_N; i++) out[i] = fl_restage_acc[i];
    if (reset) memset(fl_restage_acc, 0, sizeof fl_restage_acc);
    return FL_RS_N;
}

/* from mapcore.c / swdp.c (same shared object) */
int64_t mc_hitinfo_short2(
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table, int wordlen, int nskip,
    const uint8_t *codes, const uint8_t *qual, int64_t qlen,
    int64_t maxhit_per_tuple, int64_t maxhit_total, int basq_thresh,
    uint8_t *qmaskF, int64_t *qoffsF, int64_t *nhitsF, int64_t *slotF,
    uint32_t *sidxF,
    uint8_t *qmaskR, int64_t *qoffsR, int64_t *nhitsR, int64_t *slotR,
    uint32_t *sidxR,
    uint8_t *qbuf, uint32_t *keybuf, int64_t *out);
int64_t mc_cover_deficit(
    const int64_t *qoffs, const uint32_t *sidx, int64_t n_seeds,
    int has_rank, int64_t seed_rank,
    const uint8_t *qmask, int64_t qlen, int ktup, int nskip,
    uint8_t *qbuf);
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
    int64_t *maxcov_io);
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
    int64_t *out, int64_t *out_max);
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
    int use_cplx, double lam);
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
    int64_t *o_used);
int64_t mc_fast_align(
    const uint8_t *qcodes, int64_t qlen, int do_revcomp,
    const int32_t *matrix,
    const uint8_t *subj, int64_t slen,
    int64_t l_edge, int64_t r_edge,
    int64_t minscore, int64_t minscorlen,
    int gap_init, int gap_ext,
    int32_t *Wbuf, int32_t *Hbuf, int32_t *Ebuf,
    uint8_t *dirm, int64_t dirm_cap,
    uint8_t *back, int64_t back_cap,
    uint8_t *diffpool, int64_t diff_cap,
    int64_t *res, int64_t res_cap);
int64_t mc_hitinfo_collect(
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table,
    int wordlen, int nskip,
    const uint8_t *codes, const uint8_t *qual, int64_t qlen,
    int is_reverse, int64_t maxhit_per_tuple, int basq_thresh,
    int64_t seq_start, int64_t seq_end,
    uint8_t *qmask, int64_t *qoffs, int64_t *nhits, int64_t *slot);
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
    int64_t *res);
int nr_sort2(uint32_t *a, uint32_t *b, int n);
int nr_sort2_64_32(uint64_t *a, uint32_t *b, int n);
int mc_calc_seg_offsets(const int64_t *row, int ktup, int nskip,
                        const int64_t *offsets, int64_t nseq, int64_t qlen,
                        int64_t *o_qs, int64_t *o_qe,
                        int64_t *o_rs, int64_t *o_re,
                        int64_t *o_bl, int64_t *o_br);
int mc_ali_band_make(int64_t l_edge, int64_t r_edge,
                     int64_t q_left, int64_t q_right, int64_t q_len,
                     int64_t s_left, int64_t s_right, int64_t s_len,
                     int64_t *o_ledge, int64_t *o_redge,
                     int64_t *o_sleft, int64_t *o_slen,
                     int64_t *o_qleft, int64_t *o_qlen, int64_t *o_bw);
int sw_prof8_set(int slot, const int32_t *W, int qlen,
                 int gap_init, int gap_ext);
int sw_prof8_score(int slot, const uint8_t *subj, int slen);
int sw_full_wide(const int32_t *W, int qlen, const uint8_t *subj,
                 int slen, int gap_init, int gap_ext,
                 int32_t *Hbuf, int32_t *Ebuf);
int sw_band_fast(const int32_t *W, int qlen_prof, const uint8_t *subj,
                 int l_edge, int r_edge, int q_left, int q_len,
                 int s_left, int s_len, int gap_init, int gap_ext,
                 int32_t *Hbuf, int32_t *Ebuf);

/* ---------------- constants (results.c / rmap.c / segment.c) -------- */

#define FL_ERR_CAP    (-1)   /* scratch capacity exceeded -> fallback */
#define FL_ERR_ASSERT (-2)   /* semantic assert -> fallback           */
#define FL_ERR_TEXT   (-3)   /* output text buffer too small          */

#define MAPSCOR_MAX 60
#define MAPSCOR_DUMMY_COUNT 3
#define MAPSCOR_MAX_RANDOM 3
#define MAPSCOR_MIN_UNIQ 4
#define MAPSCOR_EXPFAC 10
#define QUALSCOR_SCAL 10
#define MINLOGARG 1e-7
#define SAMPLESIZ_MAPQ_RANDOM 9
#define MIN_QSEGOVERLAP_PERCENT 80
#define QVAL_OFFS 0x21
#define ALILEN_MIN 5

#define RSLTFLAG_REVERSE 0x01
#define RSLTFLAG_NOSEQID 0x04
#define RSLTFLAG_SELECT 0x08
#define RSLTFLAG_NOOUTPUT 0x10
#define RSLTFLAG_BELOWRELSW 0x20
#define RSLTFLAG_HASSECOND 0x80
#define RSLTFLAG_REPORTED 0x100

#define RESULTFLG_BEST 0x01
#define RESULTFLG_SINGLE 0x02
#define RESULTFLG_RANDSEL 0x04
#define RESULTFLG_SPLIT 0x08

#define RMAPFLG_CMPLXW 0x01
#define RMAPFLG_BEST 0x02
#define RMAPFLG_SEQBYSEQ 0x04
#define RMAPFLG_SENSITIVE 0x20
#define RMAPFLG_NOSHRTINFO 0x40
#define RMAPFLG_SPLIT 0x80

#define REPFLG_MAPPED 0x01
#define REPFLG_REVERSE 0x02
#define REPFLG_PRIMARY 0x10
#define REPFLG_MULTI 0x40
#define REPFLG_PARTIAL 0x20

#define SAMFLAG_NOMAP 0x0004
#define SAMFLAG_STRAND 0x0010
#define SAMFLAG_NOTPRIMARY 0x0100

#define CANDFLAG_REVERSE 0x01

#define MAXIMUM_DEPTH 8000        /* segment.c:133 */
#define DEFAULT_TARGET_DEPTH 200  /* segment.c:135 */

#define DIFFCOD_M 0
#define DIFFCOD_D 1
#define DIFFCOD_I 2
#define DIFFCOD_S 3
#define MAXMISMATCH 61      /* diffstr.c record count cap (mapcore.c) */

#define RES_MAX 4096
#define DIFFPOOL_CAP (1 << 20)

static const double LOGBASE = (double)(float)2.30259;  /* results.c:104 */

/* ---------------- drand48 replica (rand.py) ---------------- */

static double fl_drand48(uint64_t *x)
{
    *x = (0x5DEECE66Dull * *x + 0xBull) & ((1ull << 48) - 1);
    return (double)*x / 281474976710656.0;   /* 2^48 */
}

/* ---------------- result records ---------------- */

typedef struct {
    int64_t q_start, q_end;     /* 1-based */
    int64_t s_start, s_end;     /* 1-based, within sequence */
    int64_t sidx;
    int64_t swatscor;
    int64_t mapscor;
    double prob;                /* propagateMapQualAsProb (pair model) */
    int32_t status;
    int32_t diff_off, diff_len;
    int32_t swrank, qsegx, tmpord;
    int32_t rsltx;              /* split-read link (findSplitReads) */
} FLRes;

typedef struct {
    FLRes res[RES_MAX];
    int n_res;
    int sortr[RES_MAX];     /* output-ordered selected indices */
    int n_sortr;
    int segsrtr[RES_MAX];   /* per-segment, SW-ordered indices */
    int segnor[RES_MAX + 1];
    int qsegno;
    uint8_t diffpool[DIFFPOOL_CAP];
    int diff_used;
    int64_t swatscor_max, swatscor_2ndmax;
    int64_t n_ali_done, n_ali_tot, n_ali_max;
    int64_t n_hits_used, n_hits_tot;
} FLResultSet;

static void rs_blank(FLResultSet *rs)
{
    rs->n_res = 0;
    rs->n_sortr = 0;
    rs->qsegno = 0;
    rs->diff_used = 0;
    rs->swatscor_max = rs->swatscor_2ndmax = 0;
    rs->n_ali_done = rs->n_ali_tot = rs->n_ali_max = 0;
    rs->n_hits_used = rs->n_hits_tot = 0;
}

/* UPDATE_SWATSCORMAX (result.py:160-167) */
static void rs_update_swatmax(FLResultSet *rs, int64_t sw)
{
    if (sw > rs->swatscor_2ndmax) {
        if (sw > rs->swatscor_max) {
            rs->swatscor_2ndmax = rs->swatscor_max;
            rs->swatscor_max = sw;
        } else if (sw != rs->swatscor_max) {
            rs->swatscor_2ndmax = sw;
        }
    }
}

/* resultSetAddFromAli (result.py:169-198); ali rows from
 * mc_align_recursive: {score, qs, qe, rs, re, diff_off, diff_len} with
 * diff bytes already in rs->diffpool (written there directly). */
static int rs_add_from_ali(FLResultSet *rs, const int64_t *ali, int64_t nali,
                           int64_t soffs, int64_t qlen, int64_t seqidx,
                           int is_reverse)
{
    /* Replicates resultSetAddFromAli's slot/ARRLEN dance VERBATIM
     * (results.c:1852-1942), including its observable bugs: after a
     * duplicate drop (--ARRLEN) the next result reuses the slot without
     * being re-counted, so a new result right after a duplicate at the
     * END of the batch is silently lost (but still bumps the swatscor
     * maxima, which pass-2 min-score dynamics read); the duplicate
     * compare is against the PHYSICAL previous slot (possibly an
     * uncounted zombie after consecutive drops) and is skipped while
     * fewer than two slots are counted. */
    int64_t a, arrlen, rp;
    int is_new;
    if (nali < 1) return 0;
    arrlen = rs->n_res;
    rp = arrlen;                        /* preloop ARRNEXTP */
    if (rp >= RES_MAX) return FL_ERR_CAP;
    arrlen++;
    is_new = 0;
    for (a = 0; a < nali; a++) {
        const int64_t *r = ali + a * 7;
        int64_t q_start, q_end, s_start, s_end;
        FLRes *prev, *nr;
        if (is_new) {
            rp = arrlen;
            if (rp >= RES_MAX) return FL_ERR_CAP;
            arrlen++;
            is_new = 0;
        }
        if (is_reverse) {
            q_start = qlen - r[2];
            q_end = qlen - r[1];
        } else {
            q_start = r[1] + 1;
            q_end = r[2] + 1;
        }
        s_start = soffs + r[3] + 1;
        s_end = soffs + r[4] + 1;
        nr = &rs->res[rp];
        nr->q_start = q_start;
        nr->q_end = q_end;
        nr->s_start = s_start;
        nr->s_end = s_end;
        nr->sidx = seqidx;
        nr->swatscor = r[0];
        nr->mapscor = 0;
        nr->prob = 0.0;
        nr->status = (seqidx < 0 ? RSLTFLAG_NOSEQID : 0);
        nr->swrank = 0;
        nr->qsegx = -1;
        nr->tmpord = 0;
        nr->rsltx = -1;
        prev = (rp >= 1) ? &rs->res[rp - 1] : NULL;
        is_new = (arrlen < 2) ||
                 !(prev->s_start == s_start && prev->s_end == s_end &&
                   prev->q_start == q_start && prev->q_end == q_end &&
                   prev->swatscor == r[0] && prev->sidx == seqidx);
        if (is_new) {
            nr->status |= RSLTFLAG_SELECT
                          | (is_reverse ? RSLTFLAG_REVERSE : 0);
            nr->diff_off = (int32_t)r[5];
            nr->diff_len = (int32_t)r[6];
            rs_update_swatmax(rs, r[0]);
        } else {
            arrlen--;
        }
    }
    rs->n_res = (int)arrlen;
    return 0;
}

/* ---------------- stable sorts over result indices ---------------- */
/* Python list.sort is stable; insertion sort reproduces it exactly
 * (result counts are tiny).  cmp returns <0/0/>0 on the key tuple. */

typedef int (*fl_cmp)(const FLResultSet *, int, int);

static void stable_sort_idx(const FLResultSet *rs, int *idx, int n, fl_cmp cmp)
{
    int i, j;
    for (i = 1; i < n; i++) {
        int v = idx[i];
        j = i - 1;
        while (j >= 0 && cmp(rs, idx[j], v) > 0) {
            idx[j + 1] = idx[j];
            j--;
        }
        idx[j + 1] = v;
    }
}

/* cmpRes (result.py:117-120): (sidx, rev, s_start, -(qe-qs)) */
static int cmp_res(const FLResultSet *rs, int a, int b)
{
    const FLRes *x = &rs->res[a], *y = &rs->res[b];
    int64_t dx, dy;
    if (x->sidx != y->sidx) return x->sidx < y->sidx ? -1 : 1;
    {
        int rx = x->status & RSLTFLAG_REVERSE, ry = y->status & RSLTFLAG_REVERSE;
        if (rx != ry) return rx < ry ? -1 : 1;
    }
    if (x->s_start != y->s_start) return x->s_start < y->s_start ? -1 : 1;
    dx = x->q_end - x->q_start;
    dy = y->q_end - y->q_start;
    if (dx != dy) return dx > dy ? -1 : 1;
    return 0;
}

/* cmpResOutput (result.py:123-126): (-sw, rev, sidx, s_start, -dlen) */
static int cmp_output(const FLResultSet *rs, int a, int b)
{
    const FLRes *x = &rs->res[a], *y = &rs->res[b];
    int64_t dx, dy;
    if (x->swatscor != y->swatscor) return x->swatscor > y->swatscor ? -1 : 1;
    {
        int rx = x->status & RSLTFLAG_REVERSE, ry = y->status & RSLTFLAG_REVERSE;
        if (rx != ry) return rx < ry ? -1 : 1;
    }
    if (x->sidx != y->sidx) return x->sidx < y->sidx ? -1 : 1;
    if (x->s_start != y->s_start) return x->s_start < y->s_start ? -1 : 1;
    dx = x->q_end - x->q_start;
    dy = y->q_end - y->q_start;
    if (dx != dy) return dx > dy ? -1 : 1;
    return 0;
}

/* cmpResSegLen (result.py:129-132): (-sw, -dlen, rev, sidx, s_start) */
static int cmp_seglen(const FLResultSet *rs, int a, int b)
{
    const FLRes *x = &rs->res[a], *y = &rs->res[b];
    int64_t dx = x->q_end - x->q_start, dy = y->q_end - y->q_start;
    if (x->swatscor != y->swatscor) return x->swatscor > y->swatscor ? -1 : 1;
    if (dx != dy) return dx > dy ? -1 : 1;
    {
        int rx = x->status & RSLTFLAG_REVERSE, ry = y->status & RSLTFLAG_REVERSE;
        if (rx != ry) return rx < ry ? -1 : 1;
    }
    if (x->sidx != y->sidx) return x->sidx < y->sidx ? -1 : 1;
    if (x->s_start != y->s_start) return x->s_start < y->s_start ? -1 : 1;
    return 0;
}

/* cmpResSegSW (result.py:135-137): (qsegx, -sw) */
static int cmp_seg_sw(const FLResultSet *rs, int a, int b)
{
    const FLRes *x = &rs->res[a], *y = &rs->res[b];
    if (x->qsegx != y->qsegx) return x->qsegx < y->qsegx ? -1 : 1;
    if (x->swatscor != y->swatscor) return x->swatscor > y->swatscor ? -1 : 1;
    return 0;
}

/* assignSequenceIndex (result.py:231-265, results.c:1695-1780):
 * whole-genome mode (no SEQBYSEQ) resolves global subject offsets to
 * (sidx, within-sequence offsets).  An alignment spanning a
 * concatenated-sequence boundary needs splitMultiSpan's re-alignment
 * (results.c:1474-1695) — that rare branch returns FL_ERR_ASSERT so
 * the caller replays the read/pair through the Python oracle. */
static int rs_assign_seqidx(FLResultSet *rs, const int64_t *ofp,
                            int64_t nseq)
{
    uint64_t keys[RES_MAX];
    uint32_t idxs[RES_MAX];
    int i, n = 0, s = 0;
    for (i = 0; i < rs->n_res; i++) {
        const FLRes *r = &rs->res[i];
        if ((r->status & RSLTFLAG_SELECT) && r->sidx < 0) {
            keys[n] = (uint64_t)r->s_start;
            idxs[n] = (uint32_t)i;
            n++;
        }
    }
    if (n == 0) return 0;
    if (n > 1 && nr_sort2_64_32(keys, idxs, n) != 0) return FL_ERR_CAP;
    for (i = 0; i < n; i++) {
        FLRes *r = &rs->res[idxs[i]];
        int64_t e;
        if (!(r->status & (RSLTFLAG_NOSEQID | RSLTFLAG_SELECT)))
            continue;
        while (s < nseq && r->s_start > ofp[s + 1])
            s++;
        e = s + 1;
        while (e < nseq && r->s_end > ofp[e])
            e++;
        if (r->s_end > ofp[e]) return FL_ERR_ASSERT;
        if (e > s + 1) return FL_ERR_ASSERT;      /* splitMultiSpan */
        r->sidx = s;
        r->s_start -= ofp[s];
        r->s_end -= ofp[s];
        r->status &= ~RSLTFLAG_NOSEQID;
    }
    return 0;
}

/* sortAndPrune (result.py:312-340) */
static void rs_sort_and_prune(FLResultSet *rs)
{
    int i, n_sel = 0;
    for (i = 0; i < rs->n_res; i++)
        rs->res[i].swrank = 0;
    for (i = 0; i < rs->n_res; i++)
        if (rs->res[i].status & RSLTFLAG_SELECT)
            rs->sortr[n_sel++] = i;
    if (n_sel < 2) {
        rs->n_sortr = n_sel;
        return;
    }
    stable_sort_idx(rs, rs->sortr, n_sel, cmp_res);
    {
        int out_n = 1, prev = rs->sortr[0];
        for (i = 1; i < n_sel; i++) {
            FLRes *r = &rs->res[rs->sortr[i]];
            const FLRes *p = &rs->res[prev];
            if (r->s_end > p->s_end || r->swatscor > p->swatscor ||
                r->q_start < p->q_start || r->q_end > p->q_end ||
                r->sidx != p->sidx ||
                (r->status & RSLTFLAG_REVERSE) != (p->status & RSLTFLAG_REVERSE)) {
                rs->sortr[out_n++] = rs->sortr[i];
                prev = rs->sortr[i];
            } else {
                r->status &= ~RSLTFLAG_SELECT;
            }
        }
        n_sel = out_n;
    }
    stable_sort_idx(rs, rs->sortr, n_sel, cmp_output);
    rs->n_sortr = n_sel;
    rs->res[rs->sortr[0]].swrank = 0;
    for (i = 1; i < n_sel; i++) {
        FLRes *cur = &rs->res[rs->sortr[i]];
        const FLRes *prv = &rs->res[rs->sortr[i - 1]];
        cur->swrank = (cur->swatscor < prv->swatscor)
                      ? prv->swrank + 1 : prv->swrank;
    }
}

/* labelComplementarySegments (result.py:342-376) */
static void rs_label_segments(FLResultSet *rs)
{
    int n = rs->n_sortr, i_start = 0, i;
    for (i = 0; i < n; i++)
        rs->res[rs->sortr[i]].qsegx = -1;
    rs->qsegno = 0;
    for (;;) {
        FLRes *r1 = &rs->res[rs->sortr[i_start]];
        int64_t l1 = r1->q_end - r1->q_start;
        r1->qsegx = rs->qsegno;
        i = i_start + 1;
        i_start = 0;
        for (; i < n; i++) {
            FLRes *r2 = &rs->res[rs->sortr[i]];
            if (r2->qsegx < 0) {
                int64_t l2 = r2->q_end - r2->q_start;
                int64_t mn = l1 < l2 ? l1 : l2;
                int64_t min_ovl =
                    (int64_t)((double)mn * (MIN_QSEGOVERLAP_PERCENT / 100.0));
                if (r1->q_start + min_ovl < r2->q_end &&
                    r2->q_start + min_ovl < r1->q_end)
                    r2->qsegx = rs->qsegno;
                else if (i_start == 0)
                    i_start = i;
            }
        }
        rs->qsegno++;
        if (i_start == 0) break;
    }
    memcpy(rs->segsrtr, rs->sortr, (size_t)n * sizeof(int));
    stable_sort_idx(rs, rs->segsrtr, n, cmp_seg_sw);
    rs->segnor[0] = 0;
    {
        int nb = 1;
        for (i = 1; i < n; i++)
            if (rs->res[rs->segsrtr[i]].qsegx > rs->res[rs->segsrtr[i - 1]].qsegx)
                rs->segnor[nb++] = i;
        rs->segnor[nb] = n;
    }
}

/* findSplitReads (result.py:507-525, results.c:1436-1472): link each
 * top-score result to a non-overlapping later result (split-read
 * second fragment).  rsltx/HASSECOND have no SAM-output effect but are
 * kept for parity with the Python result-set state. */
static void rs_find_split_reads(FLResultSet *rs)
{
    int n = rs->n_sortr, i, j;
    int64_t sw1;
    if (n < 1) return;
    sw1 = rs->res[rs->sortr[0]].swatscor;
    for (i = 0; i < n; i++) {
        FLRes *a = &rs->res[rs->sortr[i]];
        if (a->swatscor < sw1) break;
        for (j = i + 1; j < n; j++) {
            FLRes *b = &rs->res[rs->sortr[j]];
            if (b->rsltx >= 0) continue;
            if (a->q_end < b->q_start || a->q_start > b->q_end) {
                b->rsltx = i;
                a->status |= RSLTFLAG_HASSECOND;
                break;
            }
        }
    }
}

/* sumQualOverMisMatch (result.py:92-114); returns sum or <0 error */
static int64_t sum_qual_over_mismatch(const uint8_t *qual,
                                      int64_t pos_start, int64_t pos_end,
                                      const uint8_t *diff, int diff_len)
{
    int64_t qs = 0;
    int64_t spos = pos_start > 0 ? pos_start - 1 : 0;
    int i;
    for (i = 0; i < diff_len; i++) {
        uint8_t b = diff[i];
        int gap, typ;
        if (!b) break;
        gap = b & 0x3F;
        typ = b >> 6;
        spos += gap;
        if (typ == DIFFCOD_D) continue;
        if (typ == DIFFCOD_S) {
            if (i + 1 >= diff_len || !diff[i + 1]) continue;
            if (qual[spos] < QVAL_OFFS) return FL_ERR_ASSERT;
            qs += qual[spos] - QVAL_OFFS;
        }
        spos += 1;
    }
    if (spos != pos_end) return FL_ERR_ASSERT;
    return qs;
}

/* calcPhredScaledMappingQuality (result.py:381-468).
 * Operates in place on the segsrtr slice [lo, hi). */
static int rs_calc_mapq(FLResultSet *rs, int qsegx, const uint8_t *qual,
                        int64_t qlen)
{
    int lo = rs->segnor[qsegx], hi = rs->segnor[qsegx + 1];
    int *rspp = rs->segsrtr + lo;
    int n = hi - lo, i;
    int64_t sw1, sw2, n2, qn, mapscor, maxmapscor;
    double fs, fa;
    if (n < 1) return 0;
    sw1 = rs->res[rspp[0]].swatscor;
    if (sw1 < 1) {
        rs->res[rspp[0]].mapscor = 0;
        return 0;
    }
    fs = (double)rs->n_hits_used / (double)(rs->n_hits_tot + MAPSCOR_DUMMY_COUNT);
    fa = (double)rs->n_ali_done / (double)(rs->n_ali_tot + MAPSCOR_DUMMY_COUNT);
    if (fs > fa) fs = fa;
    fs = (fs > MINLOGARG) ? (-QUALSCOR_SCAL * log(fs) / LOGBASE)
                          : (double)MAPSCOR_MAX;
    maxmapscor = (fs < MAPSCOR_MAX) ? MAPSCOR_MAX - (int64_t)fs : 0;

    if (n > 1) {
        sw2 = rs->res[rspp[1]].swatscor;
        i = 2;
        while (i < n && rs->res[rspp[i]].swatscor == sw2) i++;
        n2 = i - 1;
        qn = (int64_t)(QUALSCOR_SCAL * log((double)n2) / LOGBASE);
    } else {
        sw2 = 0;
        n2 = 0;
        qn = 0;
    }

    if (sw2 == sw1 && n > 1) {
        /* multiple best: longest query segment, then lowest quality sum
         * over mismatches (results.c:1228-1294) */
        int64_t seglen_1st, seglen;
        stable_sort_idx(rs, rspp, (int)(n2 + 1), cmp_seglen);
        {
            const FLRes *h0 = &rs->res[rspp[0]], *h1 = &rs->res[rspp[1]];
            seglen_1st = h0->q_end - h0->q_start;
            seglen = h1->q_end - h1->q_start;
            if (seglen_1st == seglen && qual != NULL) {
                int64_t qv1, qv2, qv;
                int i_min = 1;
                qv1 = sum_qual_over_mismatch(qual, h0->q_start, h0->q_end,
                                             rs->diffpool + h0->diff_off,
                                             h0->diff_len);
                qv2 = sum_qual_over_mismatch(qual, h1->q_start, h1->q_end,
                                             rs->diffpool + h1->diff_off,
                                             h1->diff_len);
                if (qv1 < 0 || qv2 < 0) return FL_ERR_ASSERT;
                i = 2;
                while (i < n && rs->res[rspp[i]].swatscor == sw1) {
                    const FLRes *ri = &rs->res[rspp[i]];
                    int64_t sl = ri->q_end - ri->q_start;
                    if (sl < seglen_1st) break;
                    qv = sum_qual_over_mismatch(qual, ri->q_start, ri->q_end,
                                                rs->diffpool + ri->diff_off,
                                                ri->diff_len);
                    if (qv < 0) return FL_ERR_ASSERT;
                    if (qv < qv2) { qv2 = qv; i_min = i; }
                    i++;
                }
                if (qv1 > qv2) {
                    int t = rspp[i_min];
                    rspp[i_min] = rspp[0];
                    rspp[0] = t;
                    mapscor = MAPSCOR_MIN_UNIQ;
                } else {
                    mapscor = (qv1 == qv2) ? 0 : MAPSCOR_MIN_UNIQ;
                }
            } else if (seglen_1st == seglen) {
                mapscor = 0;
            } else {
                mapscor = MAPSCOR_MIN_UNIQ;
            }
        }
        if (mapscor < 1)
            stable_sort_idx(rs, rspp, (int)(n2 + 1), cmp_output);
    } else {
        /* exponential scaling (results.c:1310-1315) */
        mapscor = (int64_t)(MAPSCOR_MAX *
                  (1.0 - exp((double)((sw2 - sw1) * MAPSCOR_EXPFAC) /
                             (double)qlen)) - (double)qn);
        if (mapscor >= 0) mapscor += MAPSCOR_MIN_UNIQ;
        if (mapscor > maxmapscor) mapscor = maxmapscor;
    }
    if (mapscor > MAPSCOR_MAX) mapscor = MAPSCOR_MAX;
    else if (mapscor < 0) mapscor = 0;
    rs->res[rspp[0]].mapscor = mapscor;
    for (i = 1; i < n; i++)
        rs->res[rspp[i]].mapscor = 0;
    return 0;
}

/* diffStrCalcAliLen (diffstr.py:128-143) */
static void fl_ali_len(const uint8_t *diff, int n, int64_t *alilen,
                       int64_t *matchnum)
{
    int64_t al = 0, mn = 0;
    int typ = DIFFCOD_M, i;
    for (i = 0; i < n; i++) {
        uint8_t b = diff[i];
        if (!b) break;
        typ = b >> 6;
        al += (b & 0x3F) + 1;
        mn += b & 0x3F;
        if (typ == DIFFCOD_M) mn++;
    }
    if (typ == DIFFCOD_S) al--;
    *alilen = al;
    *matchnum = mn;
}

/* resultSetFilterResults (result.py:596-616) */
static void rs_filter(FLResultSet *rs, int64_t qlen, int64_t min_swscor,
                      int64_t below_max, double min_identity)
{
    int64_t minid, maxsw, minrel = 0;
    int i;
    if (rs->n_sortr < 1) return;
    minid = (min_identity <= 1.0) ? (int64_t)(min_identity * (double)qlen)
                                  : (int64_t)min_identity;
    maxsw = rs->res[rs->sortr[0]].swatscor;
    if (below_max >= 0 && min_swscor + below_max < maxsw)
        minrel = maxsw - below_max;
    for (i = 0; i < rs->n_sortr; i++) {
        FLRes *r = &rs->res[rs->sortr[i]];
        int64_t alilen, matchnum;
        fl_ali_len(rs->diffpool + r->diff_off, r->diff_len,
                   &alilen, &matchnum);
        if (r->swatscor < min_swscor || matchnum < minid)
            r->status |= RSLTFLAG_NOOUTPUT;
        else if (r->swatscor < minrel)
            r->status |= RSLTFLAG_BELOWRELSW;
    }
}

/* getNumberOfTopSwatRESULTs (result.py:577-592) */
static void rs_top_count(const FLResultSet *rs, int *is_single, int *ntop)
{
    int n = rs->n_sortr, nb = n;
    *is_single = (n < 2 ||
                  rs->res[rs->sortr[1]].swatscor != rs->res[rs->sortr[0]].swatscor);
    if (n > 2) {
        int64_t thresh = rs->res[rs->sortr[1]].swatscor;
        int i = 2;
        while (i < n && rs->res[rs->sortr[i]].swatscor == thresh) i++;
        nb = i;
    }
    *ntop = nb;
}

/* assignPhredScaledMappingScoreToRandomDraw (result.py:78-89) */
static int64_t mapscor_random_draw(int samplesiz)
{
    int64_t mapq;
    if (samplesiz < 1 || samplesiz > SAMPLESIZ_MAPQ_RANDOM) return 0;
    if (samplesiz == 1) return MAPSCOR_MAX_RANDOM + 1;
    mapq = (int64_t)(-QUALSCOR_SCAL *
                     log10((double)(samplesiz - 1) / (double)samplesiz) + 0.499);
    if (mapq > MAPSCOR_MAX_RANDOM) mapq = MAPSCOR_MAX_RANDOM;
    else if (mapq < 0) mapq = 0;
    return mapq;
}

/* ---------------- stats / depth selection ---------------- */

/* segAliCandsStats (collate.py:419-486).  rows11 = candidate rows,
 * sort keys/idx are u32 scratch.  Returns n_sort; n_mincover via out. */
static int64_t fl_cands_stats(const int64_t *rows11, int64_t ncand,
                              int64_t max_cover, int64_t max2nd_cover,
                              int nskip,
                              int64_t min_cover_below_max,
                              int64_t deficit_f, int64_t deficit_r,
                              int64_t target_depth, int64_t max_depth,
                              int is_sensitive,
                              uint32_t *keys, uint32_t *idxs,
                              int64_t *out_nmincover)
{
    int64_t cdf = 0, min_cover, cda0, cda1, i, j;
    (void)deficit_r;
    if (max_depth < 1 || max_depth > MAXIMUM_DEPTH) max_depth = MAXIMUM_DEPTH;
    if (target_depth < 1) target_depth = DEFAULT_TARGET_DEPTH;
    if (target_depth > max_depth) target_depth = max_depth;

    min_cover = (min_cover_below_max > max_cover)
                ? 0 : max_cover - min_cover_below_max;
    if (min_cover > max2nd_cover) {
        cdf = min_cover - max2nd_cover;
        min_cover = max2nd_cover;
    }
    /* reference quirk: cover_deficit[0] used for BOTH strands
     * (segment.c:1676; collate.py:441-444) */
    cda0 = cda1 = (deficit_f > cdf) ? deficit_f - cdf : 0;

    j = 0;
    for (i = 0; i < ncand; i++) {
        int64_t cover = rows11[i * 11 + 7];
        int64_t cda = (rows11[i * 11 + 8] & CANDFLAG_REVERSE) ? cda1 : cda0;
        if (cover + cda >= min_cover) {
            keys[j] = (uint32_t)(max_cover - cover);
            idxs[j] = (uint32_t)i;
            j++;
        }
    }
    if (j > 1 && nr_sort2(keys, idxs, (int)j) != 0) return FL_ERR_CAP;
    *out_nmincover = j;

    if (j > target_depth) {
        int64_t maxj = j < max_depth ? j : max_depth, jj;
        if (is_sensitive) {
            jj = target_depth;
            while (jj < maxj) {
                /* indexes the UNSORTED candidate order (collate.py:469-474) */
                int is_rev = (rows11[jj * 11 + 8] & CANDFLAG_REVERSE) ? 1 : 0;
                if ((int64_t)keys[jj] >= (is_rev ? cda1 : cda0)) break;
                jj++;
            }
            while (jj < *out_nmincover && (int64_t)keys[jj] < nskip) jj++;
            j = jj;
        } else {
            int64_t cov = keys[j / 2];
            if (cov < nskip) cov = nskip;
            jj = target_depth;
            while (jj < maxj && (int64_t)keys[jj] < cov) jj++;
            j = jj;
        }
    }
    return j;
}

/* ---------------- SAM emission ---------------- */

/* mangled code -> ASCII letter (codec.py decode table) */
static char fl_decode1(uint8_t c)
{
    int offs = c >> 3;
    if (offs > 0 && offs < 32) return (char)('A' + offs - 1);
    return 'N';
}

/* complement letter of a mangled code (codec.py revcomp_codes) */
static char fl_decode1_comp(uint8_t c)
{
    if (c & 4) return fl_decode1(c);          /* non-standard unchanged */
    return "TGCA"[c & 3];
}

/* diffStrGetLevenshteinDistance (diffstr.py:113-125) */
static int64_t fl_levenshtein(const uint8_t *diff, int n)
{
    int64_t ed = 0;
    int typ = DIFFCOD_M, i;
    for (i = 0; i < n; i++) {
        if (!diff[i]) break;
        typ = diff[i] >> 6;
        if (typ != DIFFCOD_M) ed++;
    }
    if (ed > 0 && typ == DIFFCOD_S) ed--;
    return ed;
}

typedef struct {
    char *p;
    char *end;
    int overflow;
} FLText;

static void tx_putc(FLText *t, char c)
{
    if (t->p < t->end) *t->p++ = c;
    else t->overflow = 1;
}

static void tx_puts(FLText *t, const char *s)
{
    while (*s) tx_putc(t, *s++);
}

static void tx_putn(FLText *t, const char *s, int64_t n)
{
    int64_t i;
    for (i = 0; i < n; i++) tx_putc(t, s[i]);
}

static void tx_puti(FLText *t, int64_t v)
{
    char buf[24];
    int n = 0;
    if (v < 0) { tx_putc(t, '-'); v = -v; }
    do { buf[n++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (n) tx_putc(t, buf[--n]);
}

/* writeDiffStrCIGAR (diffstr.py:59-110), extended=True */
static int tx_cigar(FLText *t, const uint8_t *diff, int diff_len,
                    int silent_mismatch, int64_t clip_start, int64_t clip_end,
                    int soft_clip)
{
    static const char symx[4] = {'M', 'D', 'I', 'X'};
    char clipchar = soft_clip ? 'S' : 'H';
    int64_t prev_count = 0;
    int prev_typ = DIFFCOD_M, typ = DIFFCOD_M, i = 0;

    if (diff_len < 1) { tx_putc(t, '*'); return 0; }
    if (clip_start > 0) { tx_puti(t, clip_start); tx_putc(t, clipchar); }

    while (i < diff_len && diff[i]) {
        int64_t count = diff[i] & 0x3F;
        typ = diff[i] >> 6;
        i++;
        if (prev_typ == DIFFCOD_M) {
            prev_count += count;
            if (typ == DIFFCOD_M || (typ == DIFFCOD_S && silent_mismatch)) {
                prev_count += 1;
                continue;
            }
        } else if (typ == prev_typ && count < 1) {
            prev_count += 1;
            continue;
        }
        if (prev_count > 0) {
            tx_puti(t, prev_count);
            tx_putc(t, symx[prev_typ]);
        }
        if (typ == DIFFCOD_M || (typ == DIFFCOD_S && silent_mismatch)) {
            prev_count = count + 1;
            prev_typ = DIFFCOD_M;
        } else {
            if (count > 0 && prev_typ != DIFFCOD_M) {
                tx_puti(t, count);
                tx_putc(t, symx[DIFFCOD_M]);
            }
            prev_count = 1;
            prev_typ = typ;
        }
    }
    if (typ != DIFFCOD_S) return FL_ERR_ASSERT;
    if (prev_count > 1) {
        tx_puti(t, prev_count - 1);
        tx_putc(t, symx[silent_mismatch ? DIFFCOD_M : DIFFCOD_S]);
    }
    if (clip_end > 0) { tx_puti(t, clip_end); tx_putc(t, clipchar); }
    return 0;
}

/* fprintREPALIsam (report.py:280-355), single-end subset: no pairing
 * fields (RNEXT/PNEXT/TLEN = * 0 0).  mateflg = REPFLG_* bits. */
static int tx_sam_line(FLText *t,
                       const char *name, int64_t name_len,
                       const uint8_t *codes, const uint8_t *qual, int64_t qlen,
                       const uint8_t *diffpool, const FLRes *rp, int mateflg,
                       int64_t mapscor,
                       const char *const *seq_names,
                       const int64_t *seq_name_lens,
                       int soft_clip, int x_mismatch)
{
    int samflg = 0;
    int64_t pos = 0, i;
    int mapped = (mateflg & REPFLG_MAPPED) != 0;

    tx_putn(t, name, name_len);
    if (!mapped) samflg |= SAMFLAG_NOMAP;
    if (mapped && (mateflg & REPFLG_REVERSE)) samflg |= SAMFLAG_STRAND;
    if (mapped && (mateflg & REPFLG_PARTIAL)) samflg |= SAMFLAG_NOTPRIMARY;
    if (mapped) pos = rp->s_start;
    tx_putc(t, '\t');
    tx_puti(t, samflg);
    tx_putc(t, '\t');
    if (mapped) tx_putn(t, seq_names[rp->sidx], seq_name_lens[rp->sidx]);
    else tx_putc(t, '*');
    tx_putc(t, '\t');
    tx_puti(t, pos);
    tx_putc(t, '\t');
    tx_puti(t, mapscor);
    tx_putc(t, '\t');

    if (mapped) {
        int is_rev = (mateflg & REPFLG_REVERSE) != 0;
        int64_t clip_start, clip_end, q0, q1;
        int rc2;
        if (is_rev) {
            clip_start = qlen - rp->q_end;
            clip_end = rp->q_start - 1;
        } else {
            clip_start = rp->q_start - 1;
            clip_end = qlen - rp->q_end;
        }
        rc2 = tx_cigar(t, diffpool + rp->diff_off, rp->diff_len,
                       !x_mismatch, clip_start, clip_end, soft_clip);
        if (rc2 != 0) return rc2;
        tx_puts(t, "\t*\t0\t0\t");
        /* SEQ/QUAL: whole read when soft-clipping, the aligned segment
         * when hard-clipping; reverse-complemented on the - strand */
        if (soft_clip) { q0 = 0; q1 = qlen; }
        else { q0 = rp->q_start - 1; q1 = rp->q_end; }
        if (q1 > q0) {
            if (is_rev)
                for (i = q1 - 1; i >= q0; i--)
                    tx_putc(t, fl_decode1_comp(codes[i]));
            else
                for (i = q0; i < q1; i++)
                    tx_putc(t, fl_decode1(codes[i]));
        } else {
            tx_putc(t, '*');
        }
        tx_putc(t, '\t');
        if (qual && q1 > q0) {
            if (is_rev)
                for (i = q1 - 1; i >= q0; i--) tx_putc(t, (char)qual[i]);
            else
                for (i = q0; i < q1; i++) tx_putc(t, (char)qual[i]);
        } else {
            tx_putc(t, '*');
        }
        tx_puts(t, "\tNM:i:");
        tx_puti(t, fl_levenshtein(diffpool + rp->diff_off, rp->diff_len));
        tx_puts(t, "\tAS:i:");
        tx_puti(t, rp->swatscor);
    } else {
        tx_puts(t, "*\t*\t0\t0\t");
        if (soft_clip) {
            for (i = 0; i < qlen; i++) tx_putc(t, fl_decode1(codes[i]));
            tx_putc(t, '\t');
            if (qual) for (i = 0; i < qlen; i++) tx_putc(t, (char)qual[i]);
            else tx_putc(t, '*');
        } else {
            tx_puts(t, "*\t*");
        }
        tx_puts(t, "\tNM:i:0\tAS:i:0");
    }
    tx_putc(t, '\n');
    return 0;
}

/* plain CIGAR: "<op> <count> " tokens (diffstr.py extended=False,
 * silent_mismatch=True), no clip segments */
static int tx_cigar_plain(FLText *t, const uint8_t *diff, int diff_len)
{
    static const char symx[4] = {'M', 'D', 'I', 'X'};
    int64_t prev_count = 0;
    int prev_typ = DIFFCOD_M, typ = DIFFCOD_M, i = 0;

    if (diff_len < 1) { tx_putc(t, '*'); return 0; }

#define TXC_EMIT(ch, ctr) do { \
        if ((ctr) > 0) { \
            tx_putc(t, (ch)); tx_putc(t, ' '); \
            tx_puti(t, (ctr)); tx_putc(t, ' '); \
        } \
    } while (0)

    while (i < diff_len && diff[i]) {
        int64_t count = diff[i] & 0x3F;
        typ = diff[i] >> 6;
        i++;
        if (prev_typ == DIFFCOD_M) {
            prev_count += count;
            if (typ == DIFFCOD_M || typ == DIFFCOD_S) {
                prev_count += 1;
                continue;
            }
        } else if (typ == prev_typ && count < 1) {
            prev_count += 1;
            continue;
        }
        TXC_EMIT(symx[prev_typ], prev_count);
        if (typ == DIFFCOD_M || typ == DIFFCOD_S) {
            prev_count = count + 1;
            prev_typ = DIFFCOD_M;
        } else {
            if (count > 0 && prev_typ != DIFFCOD_M)
                TXC_EMIT(symx[DIFFCOD_M], count);
            prev_count = 1;
            prev_typ = typ;
        }
    }
    if (typ != DIFFCOD_S) return FL_ERR_ASSERT;
    if (prev_count > 1)
        TXC_EMIT(symx[DIFFCOD_M], prev_count - 1);
#undef TXC_EMIT
    return 0;
}

/* copyReadNamStrToREPSTR is_stripped=0 (report.py _qname): cut at the
 * first whitespace, /1 /2 KEPT */
static int64_t fl_cigar_name_len(const char *name, int64_t n)
{
    int64_t i = 0;
    while (i < n && name[i] != ' ' && name[i] != '\t' &&
           name[i] != '\r' && name[i] != '\n' && name[i] != '\v' &&
           name[i] != '\f')
        i++;
    return i;
}

/* getMapLabelFromFlag (report.c:215-246); REPPAIR_* flags defined at
 * the pair section below (0x01 MAPPED, 0x02 CONTIG, 0x04 PROPER,
 * 0x08 WITHIN — report.py REPPAIR).  Single-end callers pass 0. */
static char fl_map_label2(int mateflg, int pairflg)
{
    if (mateflg & REPFLG_MAPPED) {
        if (mateflg & REPFLG_PARTIAL)
            return 'P';
        if (pairflg & 0x01) {               /* REPPAIR_MAPPED */
            if (pairflg & 0x02) {           /* REPPAIR_CONTIG */
                if (pairflg & 0x04)         /* REPPAIR_PROPER */
                    return (pairflg & 0x08) ? 'A' : 'B';  /* WITHIN */
                return 'C';
            }
            return 'D';
        }
        return 'S';
    }
    if (mateflg & REPFLG_MULTI)
        return 'R';
    return 'N';
}

/* fprintREPALIcigar (report.c:712-760 via report.py:380-408);
 * field-level core shared by the single-end (FLRes) and paired
 * (FLRepAli) callers */
static int tx_cigar_fields(FLText *t,
                           const char *name, int64_t name_len,
                           int mateflg, int pairflg, int64_t mapscor,
                           int64_t q_start, int64_t q_end,
                           int64_t s_start, int64_t s_end,
                           int64_t swat, int64_t sidx,
                           const uint8_t *diff, int diff_len,
                           const char *const *seq_names,
                           const int64_t *seq_name_lens)
{
    int mapped = (mateflg & REPFLG_MAPPED) && diff != NULL;
    int64_t qs = 0, qe = 0, rs = 0, re_ = 0, swatscor = 0, ms;
    char dirc = '*';
    ms = mapped ? mapscor : 0;
    if (ms > 99) ms = 99;
    tx_puts(t, "cigar:");
    tx_putc(t, fl_map_label2(mateflg, pairflg));
    tx_putc(t, ':');
    tx_putc(t, (char)('0' + ms / 10));
    tx_putc(t, (char)('0' + ms % 10));
    tx_putc(t, ' ');
    if (name_len > 0) tx_putn(t, name, name_len);
    else tx_putc(t, '*');
    tx_putc(t, ' ');
    if (mapped) {
        if (mateflg & REPFLG_REVERSE) {
            qs = q_end; qe = q_start; dirc = '-';
        } else {
            qs = q_start; qe = q_end; dirc = '+';
        }
        rs = s_start; re_ = s_end;
        swatscor = swat;
    }
    tx_puti(t, qs);
    tx_putc(t, ' ');
    tx_puti(t, qe);
    tx_putc(t, ' ');
    tx_putc(t, dirc);
    tx_putc(t, ' ');
    if (mapped) tx_putn(t, seq_names[sidx], seq_name_lens[sidx]);
    else tx_putc(t, '*');
    tx_putc(t, ' ');
    tx_puti(t, rs);
    tx_putc(t, ' ');
    tx_puti(t, re_);
    tx_puts(t, " + ");
    tx_puti(t, swatscor);
    tx_putc(t, ' ');
    if (mapped) {
        int rc = tx_cigar_plain(t, diff, diff_len);
        if (rc != 0) return rc;
    } else {
        tx_putc(t, '*');
    }
    tx_putc(t, '\n');
    return 0;
}

static int tx_cigar_line(FLText *t,
                         const char *name, int64_t name_len,
                         const uint8_t *diffpool, const FLRes *rp,
                         int mateflg, int64_t mapscor,
                         const char *const *seq_names,
                         const int64_t *seq_name_lens)
{
    if (rp == NULL)
        return tx_cigar_fields(t, name, name_len, mateflg, 0, mapscor,
                               0, 0, 0, 0, 0, 0, NULL, 0,
                               seq_names, seq_name_lens);
    return tx_cigar_fields(t, name, name_len, mateflg, 0, mapscor,
                           rp->q_start, rp->q_end, rp->s_start,
                           rp->s_end, rp->swatscor, rp->sidx,
                           diffpool + rp->diff_off, rp->diff_len,
                           seq_names, seq_name_lens);
}

/* width-padded decimal (Python "{v:Nd}" / "{v:<Nd}") */
static void tx_puti_pad(FLText *t, int64_t v, int width, int left)
{
    char buf[24];
    int n = 0, i, ndig;
    int neg = v < 0;
    uint64_t u = neg ? (uint64_t)(-v) : (uint64_t)v;
    do { buf[n++] = (char)('0' + (u % 10)); u /= 10; } while (u);
    if (neg) buf[n++] = '-';
    ndig = n;
    if (!left)
        for (i = ndig; i < width; i++) tx_putc(t, ' ');
    while (n) tx_putc(t, buf[--n]);
    if (left)
        for (i = ndig; i < width; i++) tx_putc(t, ' ');
}

/* fprintREPALIssaha (report.c:579-648 via report.py:410-447);
 * alilen/matchnum via fl_ali_len above; field-level core shared by
 * the single-end (FLRes) and paired (FLRepAli) callers */
static int tx_ssaha_fields(FLText *t,
                           const char *name, int64_t name_len,
                           int mateflg, int pairflg, int64_t mapscor,
                           int64_t q_start, int64_t q_end,
                           int64_t s_start, int64_t s_end,
                           int64_t swat, int64_t sidx,
                           const uint8_t *diff, int diff_len,
                           const char *const *seq_names,
                           const int64_t *seq_name_lens,
                           const int64_t *offsets, int64_t qlen)
{
    int mapped = (mateflg & REPFLG_MAPPED) && diff != NULL;
    int64_t qs = 0, qe = 0, rs = 0, re_ = 0, swatscor = 0, ms;
    int64_t matchlen = 0, alilen = 0, s_len = 0;
    double idfrac = 0.0;
    char sensechr = '*';
    char fbuf[32];

    ms = mapped ? mapscor : 0;
    if (ms > 99) ms = 99;
    if (mapped) {
        if (mateflg & REPFLG_REVERSE) {
            qs = q_end; qe = q_start; sensechr = 'C';
        } else {
            qs = q_start; qe = q_end; sensechr = 'F';
        }
        rs = s_start; re_ = s_end;
        swatscor = swat;
        s_len = offsets[sidx + 1] - offsets[sidx];
        fl_ali_len(diff, diff_len, &alilen, &matchlen);
        if (alilen > 0)
            idfrac = 100.0 * (double)matchlen / (double)alilen;
    }
    tx_puts(t, "alignment:");
    tx_putc(t, fl_map_label2(mateflg, pairflg));
    tx_putc(t, ':');
    tx_putc(t, (char)('0' + ms / 10));
    tx_putc(t, (char)('0' + ms % 10));
    tx_putc(t, ' ');
    tx_puti_pad(t, swatscor, 5, 1);
    tx_putc(t, ' ');
    if (name_len > 0) tx_putn(t, name, name_len);
    else tx_putc(t, '*');
    tx_putc(t, ' ');
    if (mapped) tx_putn(t, seq_names[sidx], seq_name_lens[sidx]);
    else tx_putc(t, '*');
    tx_putc(t, ' ');
    tx_puti_pad(t, qs, 8, 0);
    tx_putc(t, ' ');
    tx_puti_pad(t, qe, 8, 0);
    tx_putc(t, ' ');
    tx_puti_pad(t, rs, 9, 0);
    tx_putc(t, ' ');
    tx_puti_pad(t, re_, 9, 0);
    tx_puts(t, "   ");
    tx_putc(t, sensechr);
    tx_putc(t, ' ');
    tx_puti_pad(t, matchlen, 7, 0);
    tx_putc(t, ' ');
    snprintf(fbuf, sizeof fbuf, "%5.2f", idfrac);
    tx_puts(t, fbuf);
    tx_putc(t, ' ');
    tx_puti(t, qlen);
    tx_putc(t, ' ');
    tx_puti(t, s_len);
    tx_putc(t, '\n');
    return 0;
}

/* fprintREPALIgff2 (report.c:648-711 via report.py:448-483) with
 * diffStrFindBlocks (diffstr.c:664-707) block decomposition, emitted
 * in place */
static int tx_gff_fields(FLText *t,
                         const char *name, int64_t name_len,
                         int mateflg, int64_t mapscor,
                         int64_t q_start, int64_t q_end,
                         int64_t s_start, int64_t s_end,
                         int64_t swat, int64_t sidx,
                         const uint8_t *diff, int diff_len,
                         const char *const *seq_names,
                         const int64_t *seq_name_lens)
{
    int mapped = (mateflg & REPFLG_MAPPED) && diff != NULL;
    int is_rev = (mateflg & REPFLG_REVERSE) != 0;
    int64_t qs = 0, qe = 0, rs = 0, re_ = 0, swatscor = 0;
    char sensechr = '*';
    int64_t n_blocks = 0;
    (void)mapscor;
    if (mapped) {
        if (is_rev) { qs = q_end; qe = q_start; sensechr = '-'; }
        else { qs = q_start; qe = q_end; sensechr = '+'; }
        rs = s_start; re_ = s_end;
        swatscor = swat;
    }
    tx_puts(t, "gff: ");
    if (name_len > 0) tx_putn(t, name, name_len);
    else tx_putc(t, '*');
    tx_puts(t, "\tSMALT\tsimilarity\t");
    tx_puti(t, qs);
    tx_putc(t, '\t');
    tx_puti(t, qe);
    tx_putc(t, '\t');
    tx_puti(t, swatscor);
    tx_putc(t, '\t');
    tx_putc(t, sensechr);
    tx_puts(t, "\t.\tSubject \"");
    if (mapped) tx_putn(t, seq_names[sidx], seq_name_lens[sidx]);
    else tx_putc(t, '-');
    tx_puts(t, "\" ");
    tx_puti(t, rs);
    tx_putc(t, ' ');
    tx_puti(t, re_);
    tx_puts(t, ";\t");
    if (mapped) {
        /* diffStrFindBlocks: maximal gap-free blocks (u, p, l) */
        int64_t u = 0, pp = 0, l = 0;
        int typ = DIFFCOD_M, i;
        for (i = 0; i < diff_len && diff[i]; i++) {
            int64_t count = diff[i] & 0x3F;
            typ = diff[i] >> 6;
            l += count;
            if (typ == DIFFCOD_I) {
                if (l > 0) {
                    int64_t q0 = is_rev ? q_end - q_start - pp : pp;
                    tx_puts(t, " Align ");
                    tx_puti(t, q0 + 1); tx_putc(t, ' ');
                    tx_puti(t, u + 1); tx_putc(t, ' ');
                    tx_puti(t, l); tx_putc(t, ';');
                    n_blocks++;
                    u += l; pp += l; l = 0;
                }
                pp += 1;
            } else if (typ == DIFFCOD_D) {
                if (l > 0) {
                    int64_t q0 = is_rev ? q_end - q_start - pp : pp;
                    tx_puts(t, " Align ");
                    tx_puti(t, q0 + 1); tx_putc(t, ' ');
                    tx_puti(t, u + 1); tx_putc(t, ' ');
                    tx_puti(t, l); tx_putc(t, ';');
                    n_blocks++;
                    u += l; pp += l; l = 0;
                }
                u += 1;
            } else {
                l += 1;
            }
        }
        l -= 1;
        if (l > 0) {
            int64_t q0 = is_rev ? q_end - q_start - pp : pp;
            tx_puts(t, " Align ");
            tx_puti(t, q0 + 1); tx_putc(t, ' ');
            tx_puti(t, u + 1); tx_putc(t, ' ');
            tx_puti(t, l); tx_putc(t, ';');
            n_blocks++;
        }
    }
    if (n_blocks == 0)
        tx_puts(t, " Align 0 0 0;");
    tx_putc(t, '\n');
    return 0;
}

static int tx_gff_line(FLText *t,
                       const char *name, int64_t name_len,
                       const uint8_t *diffpool, const FLRes *rp,
                       int mateflg, int64_t mapscor,
                       const char *const *seq_names,
                       const int64_t *seq_name_lens)
{
    if (rp == NULL)
        return tx_gff_fields(t, name, name_len, mateflg, mapscor,
                             0, 0, 0, 0, 0, 0, NULL, 0,
                             seq_names, seq_name_lens);
    return tx_gff_fields(t, name, name_len, mateflg, mapscor,
                         rp->q_start, rp->q_end, rp->s_start,
                         rp->s_end, rp->swatscor, rp->sidx,
                         diffpool + rp->diff_off, rp->diff_len,
                         seq_names, seq_name_lens);
}

static int tx_ssaha_line(FLText *t,
                         const char *name, int64_t name_len,
                         const uint8_t *diffpool, const FLRes *rp,
                         int mateflg, int64_t mapscor,
                         const char *const *seq_names,
                         const int64_t *seq_name_lens,
                         const int64_t *offsets, int64_t qlen)
{
    if (rp == NULL)
        return tx_ssaha_fields(t, name, name_len, mateflg, 0, mapscor,
                               0, 0, 0, 0, 0, 0, NULL, 0,
                               seq_names, seq_name_lens, offsets, qlen);
    return tx_ssaha_fields(t, name, name_len, mateflg, 0, mapscor,
                           rp->q_start, rp->q_end, rp->s_start,
                           rp->s_end, rp->swatscor, rp->sidx,
                           diffpool + rp->diff_off, rp->diff_len,
                           seq_names, seq_name_lens, offsets, qlen);
}

/* fprintAlignment (report.c:248-420 via report.py print_alignment):
 * explicit alignment display after a mapping line (-a).  Marker line:
 * transitions 'i', transversions 'v', non-standard '!', gaps '-'.
 * Emitted in 60-column chunks; the reference writes the marker line
 * UNstripped and the right-hand coordinates left-justified to width
 * 10 (trailing spaces kept) — replicated exactly. */
#define ALI_LINWIDTH 60

static int fl_base_class(char ch)
{
    if (ch == 'A' || ch == 'G') return 1;      /* purine */
    if (ch == 'C' || ch == 'T') return 2;      /* pyrimidine */
    return 0;
}

static void tx_pad_i64_cols(FLText *t, int64_t v, int left)
{
    tx_puti_pad(t, v, 10, left);
}

static int tx_align_display(FLText *t,
                            const uint8_t *codes, int64_t qlen,
                            int mateflg,
                            int64_t q_start, int64_t q_end,
                            int64_t s_start, int64_t s_end,
                            int64_t sidx,
                            const uint8_t *diff, int diff_len,
                            const uint8_t *refcodes,
                            const int64_t *offsets)
{
    int is_rev = (mateflg & REPFLG_REVERSE) != 0;
    int64_t qseg_len = q_end - q_start + 1;
    int64_t sseg_len = s_end - s_start + 1;
    const uint8_t *sseg = refcodes + offsets[sidx] + (s_start - 1);
    int64_t q = 0, s = 0, ncols = 0, i;
    int typ = DIFFCOD_M;
    /* column stream: (qchar, marker, schar, dq, ds) built on the fly
     * into chunk buffers of ALI_LINWIDTH */
    char qb[ALI_LINWIDTH], db[ALI_LINWIDTH], sb[ALI_LINWIDTH];
    int dq[ALI_LINWIDTH], dsu[ALI_LINWIDTH];
    int64_t q0 = 0, s0 = 0, fill = 0;
    (void)qlen;

#define ALI_QCH(idx) (is_rev \
        ? fl_decode1_comp(codes[(q_start - 1) + (qseg_len - 1 - (idx))]) \
        : fl_decode1(codes[(q_start - 1) + (idx)]))
#define ALI_SCH(idx) fl_decode1(sseg[idx])

#define ALI_FLUSH() do { \
        int64_t cdq = 0, cds = 0; \
        int64_t qa, qbnd, sa, sbnd; \
        int k; \
        for (k = 0; k < fill; k++) { cdq += dq[k]; cds += dsu[k]; } \
        if (is_rev) { \
            qa = q_end - q0; \
            qbnd = q_end - (q0 + cdq) + 1; \
        } else { \
            qa = q_start + q0; \
            qbnd = q_start + q0 + cdq - 1; \
        } \
        sa = s_start + s0; \
        sbnd = s_start + s0 + cds - 1; \
        tx_puts(t, "    QUERY: "); \
        tx_pad_i64_cols(t, qa, 0); \
        tx_putc(t, ' '); \
        tx_putn(t, qb, fill); \
        tx_putc(t, ' '); \
        tx_pad_i64_cols(t, qbnd, 1); \
        tx_putc(t, '\n'); \
        tx_puts(t, "                      "); \
        tx_putn(t, db, fill); \
        tx_putc(t, '\n'); \
        tx_puts(t, "REFERENCE: "); \
        tx_pad_i64_cols(t, sa, 0); \
        tx_putc(t, ' '); \
        tx_putn(t, sb, fill); \
        tx_putc(t, ' '); \
        tx_pad_i64_cols(t, sbnd, 1); \
        tx_puts(t, "\n\n\n"); \
        q0 += cdq; s0 += cds; \
        fill = 0; \
    } while (0)

#define ALI_COL(qc, dc, sc, a, b) do { \
        qb[fill] = (qc); db[fill] = (dc); sb[fill] = (sc); \
        dq[fill] = (a); dsu[fill] = (b); \
        fill++; ncols++; \
        if (fill == ALI_LINWIDTH) ALI_FLUSH(); \
    } while (0)

    for (i = 0; i < diff_len && diff[i]; i++) {
        int64_t count = diff[i] & 0x3F, c2;
        typ = diff[i] >> 6;
        for (c2 = 0; c2 < count; c2++) {
            if (q >= qseg_len || s >= sseg_len) return FL_ERR_ASSERT;
            ALI_COL(ALI_QCH(q), ' ', ALI_SCH(s), 1, 1);
            q++; s++;
        }
        if (typ == DIFFCOD_M) {
            if (q >= qseg_len || s >= sseg_len) return FL_ERR_ASSERT;
            ALI_COL(ALI_QCH(q), ' ', ALI_SCH(s), 1, 1);
            q++; s++;
        } else if (typ == DIFFCOD_S) {
            if (i + 1 < diff_len && diff[i + 1]) {
                char qc, sc;
                int qcl, scl;
                char d;
                if (q >= qseg_len || s >= sseg_len) return FL_ERR_ASSERT;
                qc = ALI_QCH(q); sc = ALI_SCH(s);
                qcl = fl_base_class(qc); scl = fl_base_class(sc);
                if (qcl == 0 || scl == 0) d = '!';
                else if (qcl == scl) d = 'i';
                else d = 'v';
                ALI_COL(qc, d, sc, 1, 1);
                q++; s++;
            }
        } else if (typ == DIFFCOD_D) {
            if (s >= sseg_len) return FL_ERR_ASSERT;
            ALI_COL('-', '-', ALI_SCH(s), 0, 1);
            s++;
        } else {                                   /* DIFFCOD_I */
            if (q >= qseg_len) return FL_ERR_ASSERT;
            ALI_COL(ALI_QCH(q), '-', '-', 1, 0);
            q++;
        }
    }
    /* the reference's loop (report.c:319-385) spends one extra column
     * slot on the diff-string terminator: with the real columns an
     * exact multiple of the row width, it lands on a fresh row and
     * prints an EMPTY block */
    if (fill > 0 || ncols > 0) ALI_FLUSH();
#undef ALI_COL
#undef ALI_FLUSH
#undef ALI_QCH
#undef ALI_SCH
    return 0;
}

/* ---------------- the per-block report stage ---------------- */

/* One report record queued for output (Report.add_map collapses to a
 * dedup against already-queued records for the single-end case,
 * report.py:98-169 with pp=None). */
typedef struct {
    int mateflg;         /* REPFLG_* incl. MAPPED/REVERSE */
    int res_idx;         /* -1 when unmapped */
    int64_t mapscor;
} FLRepRec;

#define REP_MAX 256

static int rep_add(FLRepRec *rep, int *n_rep, const FLResultSet *rs,
                   int res_idx, int mateflg)
{
    int64_t mapscor = 0;
    if (res_idx >= 0 && !(rs->res[res_idx].status & RSLTFLAG_NOOUTPUT)) {
        const FLRes *r = &rs->res[res_idx];
        int i;
        mateflg |= REPFLG_MAPPED;
        if (r->status & RSLTFLAG_REVERSE) mateflg |= REPFLG_REVERSE;
        mapscor = r->mapscor;
        /* findREPALI dedup (report.py:86-96): same coordinates and
         * REVERSE/MATE2 bits -> known single mapping, ignored */
        for (i = *n_rep - 1; i >= 0; i--) {
            if (rep[i].res_idx >= 0) {
                const FLRes *p = &rs->res[rep[i].res_idx];
                if (p->s_start == r->s_start && p->s_end == r->s_end &&
                    p->sidx == r->sidx && p->q_start == r->q_start &&
                    p->q_end == r->q_end &&
                    (rep[i].mateflg & REPFLG_REVERSE) ==
                        (mateflg & REPFLG_REVERSE))
                    return 0;
            }
        }
    } else {
        res_idx = -1;
        mateflg &= ~(REPFLG_MAPPED | REPFLG_REVERSE);
    }
    if (*n_rep >= REP_MAX) return FL_ERR_CAP;
    rep[*n_rep].mateflg = mateflg;
    rep[*n_rep].res_idx = res_idx;
    rep[*n_rep].mapscor = mapscor;
    (*n_rep)++;
    return 0;
}

/* resultSetAddToReport (pairs.py:521-556) */
static int fl_add_single_to_report(FLResultSet *rs, int rsltouflg,
                                   uint64_t *rng, FLRepRec *rep, int *n_rep)
{
    int mateflg = 0, rc;
    int top = rs->n_sortr ? rs->sortr[0] : -1;
    if (top >= 0) {
        int is_single, ns;
        rs_top_count(rs, &is_single, &ns);
        if (rs->res[top].mapscor == 0 && !is_single && ns > 1 &&
            (rsltouflg & RESULTFLG_BEST) && !(rsltouflg & RESULTFLG_SPLIT)) {
            mateflg |= REPFLG_MULTI;
            if (rsltouflg & RESULTFLG_RANDSEL) {
                int ri = (int)(fl_drand48(rng) * ns);
                top = rs->sortr[ri];
                rs->res[top].mapscor = mapscor_random_draw(ns);
            } else if (rsltouflg & RESULTFLG_SINGLE) {
                top = -1;
            }
        }
    }
    rc = rep_add(rep, n_rep, rs, top, mateflg | REPFLG_PRIMARY);
    if (rc != 0) return rc;
    if (top >= 0) rs->res[top].status |= RSLTFLAG_REPORTED;

    if ((rsltouflg & RESULTFLG_SINGLE) && !(rsltouflg & RESULTFLG_SPLIT))
        return 0;
    {
        int i;
        for (i = 1; i < rs->n_sortr; i++) {
            FLRes *r = &rs->res[rs->sortr[i]];
            if ((rsltouflg & RESULTFLG_BEST) &&
                r->swatscor < rs->res[rs->sortr[i - 1]].swatscor)
                break;
            if (!(r->status & (RSLTFLAG_NOOUTPUT | RSLTFLAG_BELOWRELSW))) {
                rc = rep_add(rep, n_rep, rs, rs->sortr[i], mateflg);
                if (rc != 0) return rc;
                r->status |= RSLTFLAG_REPORTED;
            }
        }
    }
    if ((rsltouflg & RESULTFLG_BEST) && (rsltouflg & RESULTFLG_SPLIT)) {
        /* resultSetAdd2ndaryResultsToReport (results/pairs.py:456-474,
         * results.c:2249-2280): per query segment, report the
         * best-score chain not yet reported, flagged PARTIAL */
        int qsegx;
        for (qsegx = 0; qsegx < rs->qsegno; qsegx++) {
            int64_t swscor = 0;
            int k;
            for (k = rs->segnor[qsegx]; k < rs->segnor[qsegx + 1]; k++) {
                FLRes *r = &rs->res[rs->segsrtr[k]];
                if (r->status & RSLTFLAG_NOOUTPUT) continue;
                if ((r->status & RSLTFLAG_REPORTED) ||
                    (r->swatscor < swscor &&
                     ((rsltouflg & RESULTFLG_BEST) ||
                      (r->status & RSLTFLAG_BELOWRELSW))))
                    break;
                rc = rep_add(rep, n_rep, rs, rs->segsrtr[k],
                             mateflg | REPFLG_PARTIAL);
                if (rc != 0) return rc;
                r->status |= RSLTFLAG_REPORTED;
                swscor = r->swatscor;
            }
        }
    }
    return 0;
}

/* ---------------- per-read mapping driver ---------------- */

typedef struct {
    /* index */
    const uint64_t *words;
    const int64_t *starts;
    int64_t nwords;
    const int32_t *table;
    const uint32_t *pos;
    int wordlen, nskip;
    /* reference */
    const uint8_t *refcodes;
    const int64_t *offsets;
    int64_t nseq;
    const int64_t *seq_ivals;
    /* override: restricted collation intervals [n][3] (global lo,
     * global hi+1, sidx) replacing the seq-by-seq scan — the paired
     * mate-window restriction (engine.py _collect intervals path) */
    const int64_t *ovr_ivals;
    int64_t ovr_nivals;
    /* scoring */
    const int32_t *matrix;      /* 8x8 int32 */
    int gap_init, gap_ext;      /* positive */
    int64_t match_avg, mismatch_avg;
    /* params */
    int64_t ktuple_maxhit, maxhit_total;
    double min_cover_frac;
    int64_t min_swatscor, min_swatscor_below_max;
    int min_basq;
    int64_t target_depth, max_depth;
    int rmapflg, rsltouflg;
    int64_t filter_minscor, filter_belowmax;
    double filter_minid;
    int soft_clip, x_mismatch;
    int use_cplx;               /* -w: complexity-weight SW scores */
    double lam;                 /* scoreMatrixCalcLambda (score.c:253) */
} FLParams;

typedef struct {
    int64_t qmax, budget;
    int32_t *Wf, *Wr;
    uint8_t *qmaskF, *qmaskR, *qbuf, *qm, *maskbuf;
    int64_t *qoffsF, *nhitsF, *slotF, *qoffsR, *nhitsR, *slotR;
    uint32_t *sidxF, *sidxR, *keybuf;
    uint64_t *sqdat, *seed_sqo;
    int64_t *seed_len, *seg_ix, *seg_nseed, *seg_cover, *hreg_idx, *hreg_num;
    int64_t *rows10, *out11, *score_out;
    uint32_t *stat_keys, *stat_idxs;
    uint8_t *enc;
    int32_t *Hbuf, *Ebuf;
    uint8_t *dirm;
    int64_t dirm_cap;
    uint8_t *back;
    int64_t back_cap;
    int64_t *ares;
    int64_t ares_cap;
    /* pass-2 gapless-shortcut data (fl_perfect_prep): per-strand
     * perfect self-scores + the code sequences an exact occurrence
     * must equal.  pf_ok gates the shortcut for the CURRENT read. */
    uint8_t *pf_af, *pf_ar;
    int64_t pf_score_f, pf_score_r;
    int pf_ok;
    FLResultSet *rs;
    FLRepRec rep[REP_MAX];
} FLScratch;

static void *fl_alloc(int64_t n) { return malloc((size_t)(n > 0 ? n : 1)); }

static int fl_scratch_init(FLScratch *s, int64_t qmax)
{
    int64_t budget;
    double t;
    memset(s, 0, sizeof(*s));
    s->qmax = qmax;
    /* _budget (hitlist.py:56-58) on the block's max read length; reads
     * are shorter -> their own budget is <= this one, and the budget
     * only sizes buffers (capacity checks use the per-read value) */
    t = qmax > 1 ? (double)qmax * log((double)qmax) * 32.0 : 0.0;
    budget = t > 8192.0 ? (int64_t)t : 8192;
    s->budget = budget;
    s->Wf = fl_alloc(8 * qmax * 4);
    s->Wr = fl_alloc(8 * qmax * 4);
    s->qmaskF = fl_alloc(qmax);
    s->qmaskR = fl_alloc(qmax);
    s->qbuf = fl_alloc(qmax);
    s->qm = fl_alloc(qmax);
    s->maskbuf = fl_alloc(qmax);
    s->qoffsF = fl_alloc(qmax * 8);
    s->nhitsF = fl_alloc(qmax * 8);
    s->slotF = fl_alloc(qmax * 8);
    s->qoffsR = fl_alloc(qmax * 8);
    s->nhitsR = fl_alloc(qmax * 8);
    s->slotR = fl_alloc(qmax * 8);
    s->sidxF = fl_alloc(qmax * 4);
    s->sidxR = fl_alloc(qmax * 4);
    s->keybuf = fl_alloc(qmax * 4);
    s->sqdat = fl_alloc(budget * 8);
    s->seed_sqo = fl_alloc(budget * 8);
    s->seed_len = fl_alloc(budget * 8);
    s->seg_ix = fl_alloc(budget * 8);
    s->seg_nseed = fl_alloc(budget * 8);
    s->seg_cover = fl_alloc(budget * 8);
    s->hreg_idx = fl_alloc(budget * 8);
    s->hreg_num = fl_alloc(budget * 8);
    s->rows10 = fl_alloc(budget * 10 * 8);
    s->out11 = fl_alloc(2 * budget * 11 * 8);
    s->score_out = fl_alloc(2 * budget * 10 * 8);
    s->stat_keys = fl_alloc(2 * budget * 4);
    s->stat_idxs = fl_alloc(2 * budget * 4);
    s->enc = fl_alloc(qmax);
    s->Hbuf = fl_alloc((qmax + 1) * 4);
    s->Ebuf = fl_alloc((qmax + 1) * 4);
    s->dirm_cap = 1 << 20;
    s->dirm = fl_alloc(s->dirm_cap);
    s->back_cap = 1 << 16;
    s->back = fl_alloc(s->back_cap);
    s->ares_cap = 4096;
    s->ares = fl_alloc(s->ares_cap * 7 * 8);
    s->pf_af = fl_alloc(qmax);
    s->pf_ar = fl_alloc(qmax);
    s->rs = fl_alloc(sizeof(FLResultSet));
    if (!s->Wf || !s->Wr || !s->qmaskF || !s->qmaskR || !s->qbuf || !s->qm ||
        !s->maskbuf || !s->qoffsF || !s->nhitsF || !s->slotF || !s->qoffsR ||
        !s->nhitsR || !s->slotR || !s->sidxF || !s->sidxR || !s->keybuf ||
        !s->sqdat || !s->seed_sqo || !s->seed_len || !s->seg_ix ||
        !s->seg_nseed || !s->seg_cover || !s->hreg_idx || !s->hreg_num ||
        !s->rows10 || !s->out11 || !s->score_out || !s->stat_keys ||
        !s->stat_idxs || !s->enc || !s->Hbuf || !s->Ebuf || !s->dirm || !s->back ||
        !s->ares || !s->pf_af || !s->pf_ar || !s->rs)
        return FL_ERR_CAP;
    return 0;
}

static void fl_scratch_free(FLScratch *s)
{
    free(s->Wf); free(s->Wr); free(s->qmaskF); free(s->qmaskR);
    free(s->qbuf); free(s->qm); free(s->maskbuf);
    free(s->qoffsF); free(s->nhitsF); free(s->slotF);
    free(s->qoffsR); free(s->nhitsR); free(s->slotR);
    free(s->sidxF); free(s->sidxR); free(s->keybuf);
    free(s->sqdat); free(s->seed_sqo); free(s->seed_len);
    free(s->seg_ix); free(s->seg_nseed); free(s->seg_cover);
    free(s->hreg_idx); free(s->hreg_num);
    free(s->rows10); free(s->out11); free(s->score_out);
    free(s->stat_keys); free(s->stat_idxs);
    free(s->enc); free(s->Hbuf); free(s->Ebuf); free(s->dirm); free(s->back);
    free(s->ares); free(s->pf_af); free(s->pf_ar); free(s->rs);
}

static int fl_grow(void **buf, int64_t *cap, int64_t need, int64_t elem)
{
    if (need <= *cap) return 0;
    {
        int64_t ncap = need + (need >> 1);
        void *nb = realloc(*buf, (size_t)(ncap * elem));
        if (!nb) return FL_ERR_CAP;
        *buf = nb;
        *cap = ncap;
    }
    return 0;
}

/* profile build (align/core.py:122-131 via codec alpha/revcomp) */
static void fl_profiles(const FLParams *P, const uint8_t *codes, int64_t qlen,
                        int32_t *Wf, int32_t *Wr)
{
    int64_t j;
    int a;
    for (j = 0; j < qlen; j++) {
        uint8_t c = codes[j];
        uint8_t al = (uint8_t)(c & 7);
        uint8_t cr = codes[qlen - 1 - j];
        uint8_t ar = (uint8_t)((cr & 4) ? (cr & 7) : ((~cr) & 3));
        for (a = 0; a < 8; a++) {
            Wf[(int64_t)a * qlen + j] = P->matrix[a * 8 + al];
            Wr[(int64_t)a * qlen + j] = P->matrix[a * 8 + ar];
        }
    }
}

/* Pass-2 gapless-shortcut precompute: the read's per-strand perfect
 * self-score (sum of diagonal matrix entries) and the code sequence an
 * exact subject occurrence must equal.  Eligible only when every
 * base's diagonal score is the STRICT maximum of its matrix column and
 * positive (then pass-1 score == perfect  <=>  one exact full-length
 * gapless occurrence — any mismatch, gap or clip is strictly worse),
 * all read bases are plain ACGT, and -w complexity weighting is off
 * (it rescales traceback scores).  pf_ok gates per read. */
static void fl_perfect_prep(const FLParams *P, FLScratch *s,
                            const uint8_t *codes, int64_t qlen)
{
    int c, a;
    int64_t j, sf = 0, sr = 0;
    s->pf_ok = 0;
    if (P->use_cplx)
        return;
    for (c = 0; c < 4; c++) {
        int32_t d = P->matrix[c * 8 + c];
        if (d <= 0) return;
        for (a = 0; a < 8; a++)
            if (a != c && P->matrix[a * 8 + c] >= d) return;
    }
    for (j = 0; j < qlen; j++) {
        uint8_t al = (uint8_t)(codes[j] & 7);
        uint8_t cr = codes[qlen - 1 - j];
        uint8_t ar = (uint8_t)((cr & 4) ? (cr & 7) : ((~cr) & 3));
        if (al > 3 || ar > 3) return;
        sf += P->matrix[al * 8 + al];
        sr += P->matrix[ar * 8 + ar];
        s->pf_af[j] = al;
        s->pf_ar[j] = ar;
    }
    s->pf_score_f = sf;
    s->pf_score_r = sr;
    s->pf_ok = 1;
}

/* Everything through depth selection: hit info, candidate collection,
 * deficits, stats (engine.py:539-549 + 447-498 up to pass 1).
 * Leaves candidate rows in s->out11 and the depth order in
 * s->stat_idxs.  shortseq=1 means an empty result set (no error). */
typedef struct {
    int shortseq;
    int64_t n_sort, n_mincover;
    int64_t deficit_f, deficit_r;
    int64_t hits_used, hits_tot;
    int64_t nF, nR;        /* hit-info position counts per strand */
} FLStage1;

/* pre_hout: non-NULL when the hit-info stage already ran on this
 * scratch for this read (the pair flow's probe) — the qmask/qoffs/
 * nhits/slot/sidx arrays are reused as-is and only the collation
 * onward runs (hashhit arrays are read-only downstream). */
/* sec_qs/sec_qe: -1,-1 for a normal read.  sec_qs >= 0 restricts the
 * hit collection to query positions [sec_qs, sec_qe] (mapSecondary,
 * rmap.c:1435-1505); the restricted pass — like the primary pass in
 * RMAPFLG_NOSHRTINFO mode (-p sets it) — uses the FULL hit-info
 * variant (collect_hit_info, hitinfo.py:144: maxhit=0, no seed
 * ranking) instead of the ranked short2 variant. */
static int fl_read_stage1(const FLParams *P, FLScratch *s,
                          const uint8_t *codes, const uint8_t *qual,
                          int64_t qlen, const int64_t *pre_hout,
                          FLStage1 *o, int64_t sec_qs, int64_t sec_qe)
{
    int64_t hout[4], nF, rankF, nR, rankR;
    int has_rankF = 0, has_rankR = 0;
    int64_t min_cover, min_ktup, mincov_below_max;
    int64_t maxcov[2] = {0, 0};
    int64_t ncand = 0, n_sort, n_mincover = 0;
    int64_t budget_rd;
    int64_t mismatchdiff = P->match_avg - P->mismatch_avg;
    int strand;
    int rc;
    double t;
    int prof = fl_prof();
    double tp = prof ? fl_prof_now() : 0.0;

    memset(o, 0, sizeof(*o));
    if (qlen < P->wordlen) {            /* ShortSeq -> empty result set */
        o->shortseq = 1;
        return 0;
    }
    if (pre_hout != NULL) {
        hout[0] = pre_hout[0]; hout[1] = pre_hout[1];
        hout[2] = pre_hout[2]; hout[3] = pre_hout[3];
        has_rankF = (int)pre_hout[4];
        has_rankR = (int)pre_hout[5];
    } else if (sec_qs >= 0 || (P->rmapflg & RMAPFLG_NOSHRTINFO)) {
        /* full variant per strand (engine.py _hitinfo short=False):
         * maxhit_per_tuple 0, no ranking, sidx = arange */
        int64_t q0 = sec_qs >= 0 ? sec_qs : 0;
        int64_t q1 = sec_qs >= 0 ? sec_qe : 0;
        int64_t nFu, nRu, w;
        nFu = mc_hitinfo_collect(P->words, P->starts, P->nwords,
                                 P->table, P->wordlen, P->nskip,
                                 codes, qual, qlen, 0, 0, P->min_basq,
                                 q0, q1,
                                 s->qmaskF, s->qoffsF, s->nhitsF,
                                 s->slotF);
        nRu = mc_hitinfo_collect(P->words, P->starts, P->nwords,
                                 P->table, P->wordlen, P->nskip,
                                 codes, qual, qlen, 1, 0, P->min_basq,
                                 q0, q1,
                                 s->qmaskR, s->qoffsR, s->nhitsR,
                                 s->slotR);
        if (nFu < 0 || nRu < 0) {
            o->shortseq = 1;
            return 0;
        }
        for (w = 0; w < nFu; w++) s->sidxF[w] = (uint32_t)w;
        for (w = 0; w < nRu; w++) s->sidxR[w] = (uint32_t)w;
        hout[0] = nFu; hout[1] = 0;     /* rank 0: all seeds in rank */
        hout[2] = nRu; hout[3] = 0;
        has_rankF = has_rankR = 0;
    } else {
        rc = (int)mc_hitinfo_short2(P->words, P->starts, P->nwords,
                                    P->table,
                                    P->wordlen, P->nskip, codes, qual,
                                    qlen,
                                    P->ktuple_maxhit, P->maxhit_total,
                                    P->min_basq,
                                    s->qmaskF, s->qoffsF, s->nhitsF,
                                    s->slotF, s->sidxF,
                                    s->qmaskR, s->qoffsR, s->nhitsR,
                                    s->slotR, s->sidxR,
                                    s->qbuf, s->keybuf, hout);
        if (rc != 0) {
            o->shortseq = 1;
            return 0;
        }
    }
    if (pre_hout == NULL &&
        !(sec_qs >= 0 || (P->rmapflg & RMAPFLG_NOSHRTINFO))) {
        has_rankF = hout[0] > 1;
        has_rankR = hout[2] > 1;
    }
    nF = hout[0]; rankF = hout[1]; nR = hout[2]; rankR = hout[3];
    o->nF = nF;
    o->nR = nR;
    if (prof) { double t1 = fl_prof_now(); fl_prof_acc[FLP_HITINFO] += t1 - tp; tp = t1; }

    /* _covermin (engine.py:562-568) */
    if (P->min_cover_frac < 1.01) {
        int64_t c = (int64_t)(P->min_cover_frac * (double)qlen);
        min_cover = c < qlen ? c : qlen;
    } else {
        min_cover = (int64_t)P->min_cover_frac;
    }

    /* calcMinKtup (engine.py:464-468) */
    if (min_cover >= P->wordlen + P->nskip)
        min_ktup = (min_cover - P->wordlen) / P->nskip;
    else
        min_ktup = 1;
    min_cover = (min_ktup - 1) * P->nskip + P->wordlen;

    if (P->min_swatscor_below_max < 0) {
        mincov_below_max = qlen - 1;
    } else {
        mincov_below_max = (P->min_swatscor_below_max / mismatchdiff)
                           * P->nskip;
        if (mincov_below_max < P->wordlen || (P->rmapflg & RMAPFLG_BEST))
            mincov_below_max = P->wordlen + 2 * (P->nskip - 1);
    }

    /* _budget for this read (hitlist.py:56-58) */
    t = qlen > 1 ? (double)qlen * log((double)qlen) * 32.0 : 0.0;
    budget_rd = t > 8192.0 ? (int64_t)t : 8192;
    if (budget_rd > s->budget) return FL_ERR_CAP;

    /* collect both strands (engine.py:191-269 _collect_native; fused
     * fillRMAPBUFF).  Modes: explicit intervals (pair remap), seq-by-
     * seq over seq_ivals (< 512 sequences), or whole-genome cutoff
     * collection (mode 0, UNKNOWN seqidx resolved after pass 2 —
     * rmap.c:1153-1227 / engine.py:232-235) */
    for (strand = 0; strand < 2; strand++) {
        int seqbyseq = (P->rmapflg & RMAPFLG_SEQBYSEQ) != 0;
        int cmode = (P->ovr_ivals || seqbyseq) ? 1 : 0;
        int use_short = (!P->ovr_ivals && seqbyseq) ? 1 : 0;
        int64_t cniv = P->ovr_ivals ? P->ovr_nivals
                                    : (seqbyseq ? P->nseq : 0);
        int64_t n = mc_collect_all(
            P->starts, P->pos,
            strand ? s->qoffsR : s->qoffsF,
            strand ? s->nhitsR : s->nhitsF,
            strand ? s->slotR : s->slotF,
            strand ? s->sidxR : s->sidxF,
            strand ? nR : nF,
            strand ? rankR : rankF,
            qlen, P->wordlen, P->nskip, strand,
            cmode, use_short,
            P->ovr_ivals ? P->ovr_ivals : P->seq_ivals,
            cniv,
            P->ktuple_maxhit, budget_rd, min_ktup, min_cover,
            s->sqdat, s->qm,
            s->seed_sqo, s->seed_len,
            s->seg_ix, s->seg_nseed, s->seg_cover,
            s->hreg_idx, s->hreg_num, s->maskbuf,
            s->rows10, s->budget,
            s->out11 + ncand * 11, 2 * s->budget - ncand,
            maxcov);
        if (n < 0) return FL_ERR_CAP;
        ncand += n;
    }
    if (prof) { double t1 = fl_prof_now(); fl_prof_acc[FLP_COLLECT] += t1 - tp; tp = t1; }

    /* cover deficits (engine.py:483) */
    o->deficit_f = mc_cover_deficit(s->qoffsF, s->sidxF, nF, has_rankF,
                                    rankF,
                                    s->qmaskF, qlen, P->wordlen, P->nskip,
                                    s->qbuf);
    o->deficit_r = mc_cover_deficit(s->qoffsR, s->sidxR, nR, has_rankR,
                                    rankR,
                                    s->qmaskR, qlen, P->wordlen, P->nskip,
                                    s->qbuf);

    /* depth selection (engine.py:484-486 -> collate.py:419) */
    n_sort = fl_cands_stats(s->out11, ncand, maxcov[0], maxcov[1],
                            P->nskip, mincov_below_max,
                            o->deficit_f, o->deficit_r,
                            P->target_depth, P->max_depth,
                            (P->rmapflg & RMAPFLG_SENSITIVE) != 0,
                            s->stat_keys, s->stat_idxs, &n_mincover);
    if (n_sort < 0) return (int)n_sort;
    o->n_sort = n_sort;
    o->n_mincover = n_mincover;

    /* hit_numbers per strand (engine.py:493-498) */
    {
        int64_t totF = 0, totR = 0, nrankF = 0, nrankR = 0, i;
        for (i = 0; i < nF; i++) totF += s->nhitsF[i];
        for (i = 0; i < nR; i++) totR += s->nhitsR[i];
        if (rankF > 0)
            for (i = 0; i < rankF; i++) nrankF += s->nhitsF[s->sidxF[i]];
        else
            nrankF = totF;
        if (rankR > 0)
            for (i = 0; i < rankR; i++) nrankR += s->nhitsR[s->sidxR[i]];
        else
            nrankR = totR;
        o->hits_used = nrankF + nrankR;
        o->hits_tot = totF + totR;
    }
    if (prof) fl_prof_acc[FLP_CANDSTATS] += fl_prof_now() - tp;
    return 0;
}

/* Device pass-2 results for one block (parallel/exact_pass2.py):
 * every candidate with pass-1 swscor >= the read's pre-loop
 * min_swatscor has one window, in (read, candidate) order; cursor
 * advances under exactly that predicate so producer (prep) and
 * consumer (fl_read_finish) pair deterministically. */
typedef struct {
    const int64_t *best;
    const int64_t *mi;
    const int64_t *mj;
    const int16_t *rec;        /* [nwin, sp] walk records */
    const uint8_t *valid;      /* geometry ok + fits the device caps */
    int64_t sp;
    int64_t nwin;
    int64_t cursor;
    int64_t preloop_min;       /* set per read by fl_read_finish */
    int64_t n_used, n_fb, n_hit;
} FLDevP2;

/* The pre-pass-2 min-score dynamics (engine.py:509-523), factored so
 * fl_pass2_prep_block computes the IDENTICAL window predicate and
 * band widening as fl_read_finish. */
static void fl_min_dyn(const FLParams *P, int64_t qlen,
                       int64_t max1, int64_t max2,
                       int64_t *o_min, int64_t *o_scorlen_min,
                       int64_t *o_bandwidth_min)
{
    int64_t min_swatscor = P->min_swatscor;
    int64_t min_swatscor_below_max = P->min_swatscor_below_max;
    int64_t scorlen_min = P->wordlen + P->nskip;
    int64_t matchscor = P->match_avg;
    int64_t maxscor_perfect = qlen * matchscor;

    *o_bandwidth_min = (maxscor_perfect - max1) / P->gap_ext;
    if (min_swatscor_below_max >= max1) min_swatscor_below_max = max1;
    if (min_swatscor > max2 && max2 > 0) min_swatscor = max2;
    if (min_swatscor_below_max >= 0) {
        int64_t minswc = max2 > 0 ? max2 : max1;
        if (P->rmapflg & RMAPFLG_BEST) {
            if (minswc > min_swatscor) min_swatscor = minswc;
        } else if (min_swatscor + min_swatscor_below_max < max1) {
            min_swatscor = max1 - min_swatscor_below_max;
            if (min_swatscor > minswc) min_swatscor = minswc;
        }
    }
    if (min_swatscor > scorlen_min * matchscor && matchscor > 0)
        scorlen_min = min_swatscor / matchscor;
    *o_min = min_swatscor;
    *o_scorlen_min = scorlen_min;
}

/* Pass 2 onward: min-score dynamics, full alignment of survivors,
 * result sorting/mapq/filter (engine.py:416-443, 505-529).  Consumes
 * the pass-1 rows in s->score_out. */
/* search_split: run rs_find_split_reads after the per-segment mapq
 * pass (sort_and_assign's search_split arg).  do_filter: run the final
 * rs_filter — rmapSingle filters ONCE after the (optional) secondary
 * mapping pass, so split mode defers it to the caller. */
static int fl_read_finish(const FLParams *P, FLScratch *s,
                          const uint8_t *qual, int64_t qlen,
                          int64_t n_out, int64_t max1, int64_t max2,
                          int search_split, int do_filter,
                          FLDevP2 *dev)
{
    FLResultSet *rs = s->rs;
    int64_t min_swatscor, scorlen_min, bandwidth_min;
    int64_t matchscor = P->match_avg;
    int rc;

    if (max1 < 1) return 0;
    fl_min_dyn(P, qlen, max1, max2, &min_swatscor, &scorlen_min,
               &bandwidth_min);
    if (dev) dev->preloop_min = min_swatscor;

    /* pass 2: alignRMAPCANDFull (engine.py:416-443) */
    {
        int64_t c;
        int prof = fl_prof();
        double tp = prof ? fl_prof_now() : 0.0;
        for (c = 0; c < n_out; c++) {
            const int64_t *o = s->score_out + c * 10;
            int64_t cqs = o[0], cqe = o[1], crs = o[2], cre = o[3];
            int64_t bl = o[4], br = o[5], sqidx = o[6];
            int is_rev = (int)o[7];
            int64_t swscor = o[8];
            const uint8_t *subj;
            int64_t slen, bw, band_l, band_r, minscorlen, nali;
            int64_t ndir_need, back_need, res_need;
            int64_t devw = -1;
            if (dev && swscor >= dev->preloop_min)
                devw = (dev->cursor < dev->nwin) ? dev->cursor++ : -1;
            if (swscor < min_swatscor)   /* scored==1 always on this path */
                continue;
            if (sqidx >= P->nseq) return FL_ERR_ASSERT;
            if (sqidx < 0) {
                /* whole-genome mode (no SEQBYSEQ): global coordinates,
                 * sequence resolved after pass 2 (rs_assign_seqidx) */
                if (P->rmapflg & RMAPFLG_SEQBYSEQ) return FL_ERR_ASSERT;
                subj = P->refcodes + crs;
            } else {
                subj = P->refcodes + P->offsets[sqidx] + crs;
            }
            slen = cre - crs + 1;
            if (P->rmapflg & RMAPFLG_BEST) {
                if (rs->swatscor_2ndmax > min_swatscor)
                    min_swatscor = rs->swatscor_2ndmax;
            }
            bw = br - bl;
            if (bw < bandwidth_min) {
                int64_t ext = (bandwidth_min - bw + 1) / 2;
                band_l = bl - ext;
                band_r = br + ext;
            } else {
                band_l = bl;
                band_r = br;
            }
            /* align_band_recursive preamble (core.py:363-391) */
            if (min_swatscor < 1 || matchscor <= 0) return FL_ERR_ASSERT;
            minscorlen = scorlen_min;
            if (minscorlen * matchscor < min_swatscor)
                minscorlen = min_swatscor / matchscor;
            if (minscorlen < ALILEN_MIN) return FL_ERR_ASSERT;

            /* pass-2 gapless shortcut (fl_perfect_prep): a pass-1
             * score equal to the read's strict-diagonal perfect
             * self-score can only be ONE exact full-length gapless
             * occurrence, so the banded DP + traceback is replaced by
             * a code scan over the band's diagonals.  Fires only when
             * the recursion provably emits exactly one result: a
             * single in-band occurrence whose flanks are too short for
             * the recursion's sub-interval pushes (mc_align_recursive
             * pushes left iff sl + minscorlen < ss, right iff
             * sr > se + minscorlen) and minscorlen <= qlen (else the
             * DP's own result is dropped).  Any doubt falls through to
             * the full DP, so the shortcut cannot change output. */
            nali = -1;
            if (s->pf_ok && cqs <= 0 && (cqe < 0 || cqe >= qlen - 1) &&
                swscor == (is_rev ? s->pf_score_r : s->pf_score_f) &&
                swscor > P->gap_init &&    /* sw_band_track's best gate:
                                            * a perfect score <= gap_init
                                            * is silently dropped by the
                                            * DP (tiny read + huge -S
                                            * gapopen) — must not fire */
                minscorlen <= qlen &&
                (qlen / 62 + 2) <= DIFFPOOL_CAP - rs->diff_used) {
                int64_t bl2, br2, bsl2, bslen2, bql2, bqlen2, bw2;
                if (mc_ali_band_make(band_l, band_r, cqs, cqe, qlen,
                                     0, slen - 1, slen,
                                     &bl2, &br2, &bsl2, &bslen2,
                                     &bql2, &bqlen2, &bw2) == 0 &&
                    bql2 == 0 && bqlen2 == qlen) {
                    /* an occurrence at window offset o runs along band
                     * diagonal d = bsl2 - o (subject row i = o + j,
                     * query col j, d = j - (i - bsl2)); in-band means
                     * bl2 <= d <= br2 and rows o..o+qlen-1 inside
                     * [bsl2, bslen2) */
                    const uint8_t *am = is_rev ? s->pf_ar : s->pf_af;
                    int64_t o_lo = bsl2 - br2, o_hi = bsl2 - bl2;
                    int64_t o2, found = -1;
                    int multi = 0;
                    if (o_lo < bsl2) o_lo = bsl2;
                    if (o_hi > bslen2 - qlen) o_hi = bslen2 - qlen;
                    for (o2 = o_lo; o2 <= o_hi; o2++) {
                        const uint8_t *sp2 = subj + o2;
                        int64_t j2 = 0;
                        while (j2 < qlen &&
                               (uint8_t)(sp2[j2] & 7) == am[j2])
                            j2++;
                        if (j2 == qlen) {
                            if (found >= 0) { multi = 1; break; }
                            found = o2;
                        }
                    }
                    if (!multi && found >= 0 &&
                        slen - 1 <= found + qlen - 1 + minscorlen &&
                        minscorlen >= found) {
                        int64_t r3 = qlen, dn = 0;
                        uint8_t *dp2 = rs->diffpool + rs->diff_used;
                        while (r3 > MAXMISMATCH) {
                            dp2[dn++] = (uint8_t)((DIFFCOD_M << 6) |
                                                  MAXMISMATCH);
                            r3 -= MAXMISMATCH + 1;
                        }
                        dp2[dn++] = (uint8_t)((DIFFCOD_S << 6) | r3);
                        dp2[dn++] = (uint8_t)(DIFFCOD_M << 6);
                        s->ares[0] = swscor;
                        s->ares[1] = 0;
                        s->ares[2] = qlen - 1;
                        s->ares[3] = found;
                        s->ares[4] = found + qlen - 1;
                        s->ares[5] = 0;
                        s->ares[6] = dn;
                        nali = 1;
                        if (fl_prof()) fl_prof_acc[FLP_SHORTCUT] += 1.0;
                    }
                }
            }
            if (nali < 0 && fl_prof()) fl_prof_acc[FLP_DP_RUNS] += 1.0;
            if (nali < 0) {
            ndir_need = (qlen + slen + 2) * (slen + 1);
            if (fl_grow((void **)&s->dirm, &s->dirm_cap, ndir_need, 1) != 0)
                return FL_ERR_CAP;
            back_need = 2 * (qlen + slen) + 8;
            if (fl_grow((void **)&s->back, &s->back_cap, back_need, 1) != 0)
                return FL_ERR_CAP;
            res_need = slen / ALILEN_MIN + 4;
            if (fl_grow((void **)&s->ares, &s->ares_cap, res_need, 7 * 8) != 0)
                return FL_ERR_CAP;

            if (devw >= 0 && dev->valid[devw]) {
                /* device-filled first interval; decode doubt falls
                 * through to the host DP for THIS candidate only */
                int64_t used = 0;
                nali = mc_align_recursive_dev(
                    is_rev ? s->Wr : s->Wf, qlen, subj, slen,
                    band_l, band_r, cqs, cqe, 0, slen - 1,
                    min_swatscor, minscorlen,
                    P->gap_init, P->gap_ext,
                    s->Hbuf, s->Ebuf,
                    s->dirm, s->dirm_cap,
                    s->back, s->back_cap,
                    rs->diffpool + rs->diff_used,
                    DIFFPOOL_CAP - rs->diff_used,
                    s->ares, res_need,
                    P->use_cplx, P->lam,
                    dev->best[devw], dev->mi[devw], dev->mj[devw],
                    dev->rec + devw * dev->sp, dev->sp, &used);
                if (nali < 0) return (int)nali;
                if (used) {
                    dev->n_used++;
                    if (nali > 0) dev->n_hit++;
                } else { dev->n_fb++; nali = -1; }
            }
            if (nali < 0)
            nali = mc_align_recursive(
                is_rev ? s->Wr : s->Wf, qlen, subj, slen,
                band_l, band_r, cqs, cqe, 0, slen - 1,
                min_swatscor, minscorlen,
                P->gap_init, P->gap_ext,
                s->Hbuf, s->Ebuf,
                s->dirm, s->dirm_cap,
                s->back, s->back_cap,
                rs->diffpool + rs->diff_used,
                DIFFPOOL_CAP - rs->diff_used,
                s->ares, res_need,
                P->use_cplx, P->lam);
            if (nali < 0) return (int)nali;   /* -1 cap / -2 checksum */
            }   /* nali < 0: gapless shortcut did not fire */
            {
                /* ares diff offsets are relative to the pool tail */
                int64_t a, base = rs->diff_used, used_max = 0;
                for (a = 0; a < nali; a++) {
                    s->ares[a * 7 + 5] += base;
                    if (s->ares[a * 7 + 5] + s->ares[a * 7 + 6] - base >
                        used_max)
                        used_max = s->ares[a * 7 + 5] + s->ares[a * 7 + 6]
                                   - base;
                }
                rs->diff_used += used_max;
            }
            rc = rs_add_from_ali(rs, s->ares, nali, crs, qlen, sqidx, is_rev);
            if (rc != 0) return rc;
        }
        if (prof) fl_prof_acc[FLP_P2_DP] += fl_prof_now() - tp;
    }

    {
    int prof = fl_prof();
    double tp = prof ? fl_prof_now() : 0.0;
    /* sort_and_assign (engine.py:527-529 -> result.py:210-229); in
     * whole-genome mode the sequence indices resolve here first */
    if (!(P->rmapflg & RMAPFLG_SEQBYSEQ)) {
        rc = rs_assign_seqidx(rs, P->offsets, P->nseq);
        if (rc != 0) return rc;
    }
    rs_sort_and_prune(rs);
    rs->qsegno = 0;
    if (rs->n_sortr) {
        int q;
        rs_label_segments(rs);
        for (q = 0; q < rs->qsegno; q++) {
            rc = rs_calc_mapq(rs, q, qual, qlen);
            if (rc != 0) return rc;
            /* _propagate_prob only feeds the pair model; no effect on
             * single-end output (result.py:472-505) */
        }
        if (search_split)
            rs_find_split_reads(rs);
    }

    /* filter_results (engine.py:559 -> result.py:596) */
    if (do_filter)
        rs_filter(rs, qlen, P->filter_minscor, P->filter_belowmax,
                  P->filter_minid);
    if (prof) fl_prof_acc[FLP_P2_POST] += fl_prof_now() - tp;
    }
    return 0;
}

/* rmapSingle + mapSingleRead (engine.py:539-560, 447-529) for one read,
 * all-host: stage 1, host pass-1 (mc_score_cands), then pass 2 onward.
 * Fills s->rs.  Returns 0 or FL_ERR_*. */
/* One mapSingleRead pass (stage 1 restricted to [sec_qs, sec_qe] when
 * sec_qs >= 0) appending into s->rs; ends at sort_and_assign (no
 * filter).  o_shortseq reports the ShortSeq/empty-stage outcome so the
 * caller can skip stats mirroring. */
static int fl_map_pass(const FLParams *P, FLScratch *s,
                       const uint8_t *codes, const uint8_t *qual,
                       int64_t qlen, int64_t sec_qs, int64_t sec_qe,
                       int search_split, int do_profiles)
{
    FLStage1 st;
    int64_t out_max[3];
    int rc;
    int prof = fl_prof();
    double t0 = prof ? fl_prof_now() : 0.0;

    rc = fl_read_stage1(P, s, codes, qual, qlen, NULL, &st,
                        sec_qs, sec_qe);
    if (prof) { double t1 = fl_prof_now(); fl_prof_acc[FLP_SEED] += t1 - t0; t0 = t1; }
    if (rc != 0) return rc;
    if (st.shortseq) return 0;

    s->rs->n_ali_done = st.n_sort;
    s->rs->n_ali_tot = st.n_mincover;
    s->rs->n_ali_max = P->max_depth;
    s->rs->n_hits_used = st.hits_used;
    s->rs->n_hits_tot = st.hits_tot;

    if (do_profiles) {
        fl_profiles(P, codes, qlen, s->Wf, s->Wr);
        fl_perfect_prep(P, s, codes, qlen);
        if (prof) { double t1 = fl_prof_now(); fl_prof_acc[FLP_PROFILES] += t1 - t0; }
    }

    /* pass 1 (engine.py:500-501 -> mc_score_cands) */
    rc = (int)mc_score_cands(s->out11, s->stat_idxs, st.n_sort,
                             P->wordlen, P->nskip,
                             P->refcodes, P->offsets, P->nseq, qlen,
                             s->Wf, s->Wr, P->gap_init, P->gap_ext,
                             P->match_avg, P->mismatch_avg,
                             (P->rmapflg & RMAPFLG_BEST) != 0,
                             st.deficit_f, st.deficit_r,
                             s->Hbuf, s->Ebuf, s->score_out, out_max);
    if (prof) { double t1 = fl_prof_now(); fl_prof_acc[FLP_PASS1] += t1 - t0; t0 = t1; }
    if (rc != 0) return FL_ERR_ASSERT;
    rc = fl_read_finish(P, s, qual, qlen, out_max[2],
                        out_max[0], out_max[1], search_split, 0, NULL);
    if (prof) fl_prof_acc[FLP_PASS2] += fl_prof_now() - t0;
    return rc;
}

/* mapSecondary (engine.py:571-599, rmap.c:1435-1505): re-map the
 * query segment the top result does NOT cover, appending onto s->rs.
 * Requires the read's profiles already built in s (the pass runs
 * do_profiles=0); a result-less set is a no-op. */
static int fl_secondary_pass(const FLParams *P, FLScratch *s,
                             const uint8_t *codes, const uint8_t *qual,
                             int64_t qlen)
{
    FLResultSet *rs = s->rs;
    int64_t qs, qe;
    if (!(rs->n_sortr && rs->qsegno >= 1))
        return 0;
    {
        const FLRes *top = &rs->res[rs->segsrtr[0]];
        qs = top->q_start;
        qe = top->q_end;
    }
    if (qs + qe > qlen) {
        qe = qs > 1 ? qs - 2 : 0;
        qs = 0;
    } else {
        qs = qe;
        qe = qlen - 1;
    }
    if (qs + P->wordlen + P->nskip <= qe + 1)
        return fl_map_pass(P, s, codes, qual, qlen, qs, qe, 1, 0);
    return 0;
}

static int fl_map_read(const FLParams *P, FLScratch *s,
                       const uint8_t *codes, const uint8_t *qual,
                       int64_t qlen)
{
    FLResultSet *rs = s->rs;
    int split = (P->rmapflg & RMAPFLG_SPLIT) != 0;
    int rc;

    rs_blank(rs);
    if (qlen < P->wordlen) return 0;    /* ShortSeq -> empty set */
    rc = fl_map_pass(P, s, codes, qual, qlen, -1, -1, split, 1);
    if (rc != 0) return rc;

    if (split) {
        rc = fl_secondary_pass(P, s, codes, qual, qlen);
        if (rc != 0) return rc;
    }

    /* filter_results once, after any secondary pass (engine.py:558) */
    rs_filter(rs, qlen, P->filter_minscor, P->filter_belowmax,
              P->filter_minid);
    return 0;
}

/* ---------------- ASCII -> mangled encode (codec.py CODTAB) -------- */

static uint8_t fl_codtab[256];
static int fl_codtab_ready = 0;

static void fl_codtab_init(void)
{
    int i;
    if (fl_codtab_ready) return;
    fl_codtab[0] = 7;  /* CODE_TERM */
    for (i = 1; i < 256; i++) {
        int cu = i;
        int offs;
        if (i < 128 && cu >= 'a' && cu <= 'z') cu -= 32;
        if (cu == 'U') cu = 'T';
        offs = cu - 'A' + 1;
        if (offs > 0 && offs < 32) {
            int a;
            switch (cu) {
            case 'A': a = 0; break;
            case 'C': a = 1; break;
            case 'G': a = 2; break;
            case 'T': a = 3; break;
            default: a = 5; break;
            }
            fl_codtab[i] = (uint8_t)(a + (offs << 3));
        } else {
            fl_codtab[i] = (uint8_t)(5 + (('N' - 'A' + 1) << 3));
        }
    }
    fl_codtab_ready = 1;
}

/* copyReadNamStrToREPSTR semantics (seq/io.py sam_name): cut at first
 * whitespace, strip a trailing /1 or /2.  Returns effective length. */
static int64_t fl_sam_name_len(const char *name, int64_t n)
{
    int64_t i = 0;
    while (i < n && name[i] != ' ' && name[i] != '\t' && name[i] != '\r' &&
           name[i] != '\n' && name[i] != '\v' && name[i] != '\f')
        i++;
    if (i > 2 && name[i - 2] == '/' &&
        (name[i - 1] == '1' || name[i - 1] == '2'))
        i -= 2;
    return i;
}

/* ---------------- block entry ---------------- */

/* Map a block of single-end reads to SAM text.
 *
 * reads: concatenated mangled codes with read_offs[n+1] boundaries;
 * quals: concatenated raw quality bytes, same boundaries, entry used
 * only where has_qual[i] != 0; names: concatenated SAM names with
 * name_offs[n+1] boundaries.  seq_names/name index via two flat
 * buffers (snames concat + sname_offs[nseq+1]).
 *
 * rng_io: drand48 state word (rand.py), updated ONLY on success.
 *
 * Returns the text length written to out_text, or FL_ERR_* (<0); on
 * error nothing is consumed and the caller reruns the block through
 * the Python path. */
int64_t fl_map_block(
    /* index */
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table, const uint32_t *pos, int wordlen, int nskip,
    /* reference */
    const uint8_t *refcodes, const int64_t *offsets, int64_t nseq,
    const int64_t *seq_ivals,
    const char *snames, const int64_t *sname_offs,
    /* scoring */
    const int32_t *matrix, int gap_init, int gap_ext,
    int64_t match_avg, int64_t mismatch_avg,
    /* params */
    int64_t ktuple_maxhit, int64_t maxhit_total,
    double min_cover_frac, int64_t min_swatscor,
    int64_t min_swatscor_below_max, int min_basq,
    int64_t target_depth, int64_t max_depth,
    int rmapflg, int rsltouflg,
    int64_t filter_minscor, int64_t filter_belowmax, double filter_minid,
    int soft_clip, int x_mismatch,
    /* out_fmt: 0 SAM, 1 plain cigar, 2 ssaha, 3 gff2 (report.c) */
    int out_fmt,
    /* -a: explicit alignment display after each mapped record */
    int ali_out,
    /* reads; codes_are_ascii: codes_concat holds raw FASTQ letters to
     * encode here; names_raw: name extents are full header fields to
     * cut at whitespace / trailing mate suffix */
    int codes_are_ascii, int names_raw,
    int64_t n_reads, const uint8_t *codes_concat, const int64_t *read_offs,
    const uint8_t *quals_concat, const uint8_t *has_qual,
    const char *names_concat, const int64_t *name_offs,
    /* rng + output */
    uint64_t *rng_io, char *out_text, int64_t out_cap,
    /* scoreMatrixCalcLambda, used only under RMAPFLG_CMPLXW */
    double lam)
{
    FLParams P;
    FLScratch s;
    FLText t;
    uint64_t rng = *rng_io;
    int64_t i, qmax = 1;
    int rc = 0;
    const char **seq_name_ptr = NULL;
    int64_t *seq_name_len = NULL;

    P.words = words; P.starts = starts; P.nwords = nwords;
    P.table = table; P.pos = pos; P.wordlen = wordlen; P.nskip = nskip;
    P.refcodes = refcodes; P.offsets = offsets; P.nseq = nseq;
    P.seq_ivals = seq_ivals;
    P.ovr_ivals = NULL;
    P.ovr_nivals = 0;
    P.matrix = matrix; P.gap_init = gap_init; P.gap_ext = gap_ext;
    P.match_avg = match_avg; P.mismatch_avg = mismatch_avg;
    P.ktuple_maxhit = ktuple_maxhit; P.maxhit_total = maxhit_total;
    P.min_cover_frac = min_cover_frac; P.min_swatscor = min_swatscor;
    P.min_swatscor_below_max = min_swatscor_below_max;
    P.min_basq = min_basq;
    P.target_depth = target_depth; P.max_depth = max_depth;
    P.rmapflg = rmapflg; P.rsltouflg = rsltouflg;
    P.filter_minscor = filter_minscor; P.filter_belowmax = filter_belowmax;
    P.filter_minid = filter_minid;
    P.soft_clip = soft_clip; P.x_mismatch = x_mismatch;
    P.use_cplx = (rmapflg & RMAPFLG_CMPLXW) ? 1 : 0;
    P.lam = lam;

    for (i = 0; i < n_reads; i++) {
        int64_t ql = read_offs[i + 1] - read_offs[i];
        if (ql > qmax) qmax = ql;
    }
    if (fl_scratch_init(&s, qmax) != 0) {
        fl_scratch_free(&s);
        return FL_ERR_CAP;
    }
    seq_name_ptr = fl_alloc(nseq * (int64_t)sizeof(char *));
    seq_name_len = fl_alloc(nseq * 8);
    if (!seq_name_ptr || !seq_name_len) {
        rc = FL_ERR_CAP;
        goto done;
    }
    for (i = 0; i < nseq; i++) {
        seq_name_ptr[i] = snames + sname_offs[i];
        seq_name_len[i] = sname_offs[i + 1] - sname_offs[i];
    }

    t.p = out_text;
    t.end = out_text + out_cap;
    t.overflow = 0;

    fl_codtab_init();
    for (i = 0; i < n_reads; i++) {
        const uint8_t *codes = codes_concat + read_offs[i];
        const uint8_t *qual = has_qual[i] ? quals_concat + read_offs[i] : NULL;
        int64_t qlen = read_offs[i + 1] - read_offs[i];
        const char *name = names_concat + name_offs[i];
        int64_t name_len = name_offs[i + 1] - name_offs[i];
        int n_rep = 0, r;
        if (codes_are_ascii) {
            int64_t j;
            for (j = 0; j < qlen; j++)
                s.enc[j] = fl_codtab[codes[j]];
            codes = s.enc;
        }
        if (names_raw)
            name_len = out_fmt >= 1 ? fl_cigar_name_len(name, name_len)
                                    : fl_sam_name_len(name, name_len);
        rc = fl_map_read(&P, &s, codes, qual, qlen);
        if (rc != 0) goto done;
        {
            int prof = fl_prof();
            double t0 = prof ? fl_prof_now() : 0.0;
            rc = fl_add_single_to_report(s.rs, rsltouflg, &rng, s.rep,
                                         &n_rep);
            if (rc == 0) {
                for (r = 0; r < n_rep; r++) {
                    const FLRes *rp = s.rep[r].res_idx >= 0
                                      ? &s.rs->res[s.rep[r].res_idx] : NULL;
                    if (out_fmt == 3)
                        rc = tx_gff_line(&t, name, name_len,
                                         s.rs->diffpool, rp,
                                         s.rep[r].mateflg,
                                         rp ? s.rep[r].mapscor : 0,
                                         seq_name_ptr, seq_name_len);
                    else if (out_fmt == 2)
                        rc = tx_ssaha_line(&t, name, name_len,
                                           s.rs->diffpool, rp,
                                           s.rep[r].mateflg,
                                           rp ? s.rep[r].mapscor : 0,
                                           seq_name_ptr, seq_name_len,
                                           offsets, qlen);
                    else if (out_fmt == 1)
                        rc = tx_cigar_line(&t, name, name_len,
                                           s.rs->diffpool, rp,
                                           s.rep[r].mateflg,
                                           rp ? s.rep[r].mapscor : 0,
                                           seq_name_ptr, seq_name_len);
                    else
                        rc = tx_sam_line(&t, name, name_len,
                                         codes, qual, qlen,
                                         s.rs->diffpool, rp,
                                         s.rep[r].mateflg,
                                         rp ? s.rep[r].mapscor : 0,
                                         seq_name_ptr, seq_name_len,
                                         soft_clip, x_mismatch);
                    if (rc == 0 && ali_out && rp != NULL &&
                        (s.rep[r].mateflg & REPFLG_MAPPED))
                        rc = tx_align_display(&t, codes, qlen,
                                              s.rep[r].mateflg,
                                              rp->q_start, rp->q_end,
                                              rp->s_start, rp->s_end,
                                              rp->sidx,
                                              s.rs->diffpool + rp->diff_off,
                                              rp->diff_len,
                                              refcodes, offsets);
                    if (rc != 0) break;
                }
            }
            if (prof) fl_prof_acc[FLP_REPORT] += fl_prof_now() - t0;
            if (rc != 0) goto done;
        }
        if (t.overflow) {
            rc = FL_ERR_TEXT;
            goto done;
        }
    }

done:
    free((void *)seq_name_ptr);
    free(seq_name_len);
    fl_scratch_free(&s);
    if (rc != 0) return rc;
    *rng_io = rng;
    return t.p - out_text;
}

/* ---------------- device-assisted pass 1 (two-phase) ---------------- */

/* Per-read state header written by fl_pass1_block and consumed by
 * fl_pass2_block (all int64):
 *   [0] shortseq  [1] n_sort  [2] n_mincover  [3] deficit_f
 *   [4] deficit_r [5] hits_used [6] hits_tot  [7] reserved
 * followed by n_sort geometry rows of FL_GEOM_FIELDS:
 *   {qs, qe, rs, re, bl, br, sqidx, is_rev, cover, is_simd, win_idx, 0}
 */
#define FL_HDR_FIELDS 8
#define FL_GEOM_FIELDS 12

/* Phase A: seed/collate/depth-select every read and emit the geometry
 * of ALL depth-selected candidates plus window descriptors for the
 * SIMD-eligible ones (the ones the host pass-1 would send through the
 * full-matrix kernel, rmap.c:714-731).  The device scores every such
 * window even past the would-be early break — extra work, identical
 * semantics: fl_pass2_block replays the break logic and simply stops
 * consuming (scoreRMAPCAND truncation, rmap.c:756-783).
 *
 * win_desc rows of 4 int64: {global_start, slen, read_idx, is_rev}.
 * Returns the window count, or FL_ERR_* (<0). */
int64_t fl_pass1_block(
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table, const uint32_t *pos, int wordlen, int nskip,
    const uint8_t *refcodes, const int64_t *offsets, int64_t nseq,
    const int64_t *seq_ivals,
    const int32_t *matrix, int gap_init, int gap_ext,
    int64_t match_avg, int64_t mismatch_avg,
    int64_t ktuple_maxhit, int64_t maxhit_total,
    double min_cover_frac, int64_t min_swatscor,
    int64_t min_swatscor_below_max, int min_basq,
    int64_t target_depth, int64_t max_depth, int rmapflg,
    int codes_are_ascii,
    int64_t n_reads, const uint8_t *codes_concat, const int64_t *read_offs,
    const uint8_t *quals_concat, const uint8_t *has_qual,
    int64_t *state, int64_t state_cap, int64_t *state_offs,
    int64_t *win_desc, int64_t win_cap)
{
    FLParams P;
    FLScratch s;
    int64_t i, qmax = 1, n_win = 0, state_used = 0;
    int rc = 0;

    memset(&P, 0, sizeof(P));
    P.words = words; P.starts = starts; P.nwords = nwords;
    P.table = table; P.pos = pos; P.wordlen = wordlen; P.nskip = nskip;
    P.refcodes = refcodes; P.offsets = offsets; P.nseq = nseq;
    P.seq_ivals = seq_ivals;
    P.ovr_ivals = NULL;
    P.ovr_nivals = 0;
    P.matrix = matrix; P.gap_init = gap_init; P.gap_ext = gap_ext;
    P.match_avg = match_avg; P.mismatch_avg = mismatch_avg;
    P.ktuple_maxhit = ktuple_maxhit; P.maxhit_total = maxhit_total;
    P.min_cover_frac = min_cover_frac; P.min_swatscor = min_swatscor;
    P.min_swatscor_below_max = min_swatscor_below_max;
    P.min_basq = min_basq;
    P.target_depth = target_depth; P.max_depth = max_depth;
    P.rmapflg = rmapflg;

    for (i = 0; i < n_reads; i++) {
        int64_t ql = read_offs[i + 1] - read_offs[i];
        if (ql > qmax) qmax = ql;
    }
    if (fl_scratch_init(&s, qmax) != 0) {
        fl_scratch_free(&s);
        return FL_ERR_CAP;
    }
    fl_codtab_init();

    for (i = 0; i < n_reads; i++) {
        const uint8_t *codes = codes_concat + read_offs[i];
        const uint8_t *qual = has_qual[i] ? quals_concat + read_offs[i] : NULL;
        int64_t qlen = read_offs[i + 1] - read_offs[i];
        FLStage1 st;
        int64_t *hdr, *rows;
        int64_t c;
        if (codes_are_ascii) {
            int64_t j;
            for (j = 0; j < qlen; j++)
                s.enc[j] = fl_codtab[codes[j]];
            codes = s.enc;
        }
        state_offs[i] = state_used;
        rc = fl_read_stage1(&P, &s, codes, qual, qlen, NULL, &st,
                            -1, -1);
        if (rc != 0) goto done;
        if (state_used + FL_HDR_FIELDS + st.n_sort * FL_GEOM_FIELDS >
            state_cap) {
            rc = FL_ERR_CAP;
            goto done;
        }
        hdr = state + state_used;
        rows = hdr + FL_HDR_FIELDS;
        hdr[0] = st.shortseq;
        hdr[1] = st.n_sort;
        hdr[2] = st.n_mincover;
        hdr[3] = st.deficit_f;
        hdr[4] = st.deficit_r;
        hdr[5] = st.hits_used;
        hdr[6] = st.hits_tot;
        hdr[7] = 0;
        state_used += FL_HDR_FIELDS;
        if (st.shortseq) continue;
        for (c = 0; c < st.n_sort; c++) {
            const int64_t *row = s.out11 + (int64_t)s.stat_idxs[c] * 11;
            int64_t qs, qe, rs_, re_, bl, br;
            int64_t *g = rows + c * FL_GEOM_FIELDS;
            int is_simd;
            if (mc_calc_seg_offsets(row, wordlen, nskip, offsets, nseq,
                                    qlen, &qs, &qe, &rs_, &re_,
                                    &bl, &br) != 0) {
                rc = FL_ERR_ASSERT;
                goto done;
            }
            is_simd = (qlen >= 32 && (br - bl) * 48 > qlen &&
                       qs == 0 && qe >= qlen - 1);
            g[0] = qs; g[1] = qe; g[2] = rs_; g[3] = re_;
            g[4] = bl; g[5] = br; g[6] = row[10]; g[7] = row[8] & 1;
            g[8] = row[7]; g[9] = is_simd;
            g[10] = -1; g[11] = 0;
            if (is_simd) {
                int64_t gstart;
                if (g[6] < 0 || g[6] >= nseq) {
                    rc = FL_ERR_ASSERT;
                    goto done;
                }
                gstart = offsets[g[6]] + rs_;
                if (n_win >= win_cap) {
                    rc = FL_ERR_CAP;
                    goto done;
                }
                win_desc[n_win * 4 + 0] = gstart;
                win_desc[n_win * 4 + 1] = re_ - rs_ + 1;
                win_desc[n_win * 4 + 2] = i;
                win_desc[n_win * 4 + 3] = g[7];
                g[10] = n_win;
                n_win++;
            }
        }
        state_used += st.n_sort * FL_GEOM_FIELDS;
    }
    state_offs[n_reads] = state_used;

done:
    fl_scratch_free(&s);
    return rc != 0 ? rc : n_win;
}

/* The fl_pass2_block pass-1 replay (scoreRMAPCAND with device scores
 * for the SIMD windows, host banded-fast for the rest) factored so
 * fl_pass2_prep_block runs the IDENTICAL loop.  Fills s->score_out.
 * Returns 0 or FL_ERR_*. */
static int fl_pass1_replay(const FLParams *P, FLScratch *s,
                           const int64_t *hdr, const int64_t *rows,
                           const int64_t *scores, int64_t n_scores,
                           int64_t qlen,
                           int64_t *o_nout, int64_t *o_max1,
                           int64_t *o_max2)
{
    int64_t n_sort = hdr[1];
    int64_t deficit_f = hdr[3], deficit_r = hdr[4];
    int64_t mmscordiff = P->match_avg - P->mismatch_avg;
    int64_t max1 = 0, max2 = 0, min_cover = 0, max_cover = 0;
    int64_t n_out = 0, c;
    int prof8_state[2] = {-2, -2};  /* per strand, as mc_score_cands */

    for (c = 0; c < n_sort; c++) {
        const int64_t *g = rows + c * FL_GEOM_FIELDS;
        int64_t cover = g[8], cdf, swscor;
        int is_rev = (int)g[7];
        const int32_t *W = is_rev ? s->Wr : s->Wf;
        if (g[9]) {              /* device-scored window */
            int64_t w = g[10];
            if (w < 0 || w >= n_scores)
                return FL_ERR_ASSERT;
            swscor = scores[w];
        } else if (g[11]) {
            /* device DECLINED an oversize SIMD window: score it with
             * the host's striped kernel, exactly mc_score_cands'
             * is_simd arm (8-bit striped, wide fallback) */
            const uint8_t *subj = P->refcodes + P->offsets[g[6]] + g[2];
            int64_t slen = g[3] - g[2] + 1;
            int sl = is_rev ? 1 : 0, r8 = -1;
            if (prof8_state[sl] == -2)
                prof8_state[sl] = sw_prof8_set(sl, W, (int)qlen,
                                               P->gap_init, P->gap_ext);
            if (prof8_state[sl] == 0)
                r8 = sw_prof8_score(sl, subj, (int)slen);
            swscor = (r8 >= 0) ? r8
                     : sw_full_wide(W, (int)qlen, subj, (int)slen,
                                    P->gap_init, P->gap_ext,
                                    s->Hbuf, s->Ebuf);
        } else {
            int64_t slen = g[3] - g[2] + 1;
            const uint8_t *subj = P->refcodes + P->offsets[g[6]] + g[2];
            int64_t abl, abr, asl, aslen, aql, aqlen, abw;
            if (mc_ali_band_make(g[4], g[5], g[0], g[1], qlen,
                                 0, slen - 1, slen,
                                 &abl, &abr, &asl, &aslen,
                                 &aql, &aqlen, &abw) != 0)
                swscor = 0;
            else
                swscor = sw_band_fast(W, (int)qlen, subj,
                                      (int)abl, (int)abr, (int)aql,
                                      (int)aqlen, (int)asl,
                                      (int)aslen, P->gap_init, P->gap_ext,
                                      s->Hbuf, s->Ebuf);
        }
        cdf = is_rev ? deficit_r : deficit_f;
        if ((P->rmapflg & RMAPFLG_BEST) && cover + cdf < min_cover)
            break;               /* truncate at the break index */
        {
            int64_t *o = s->score_out + n_out * 10;
            o[0] = g[0]; o[1] = g[1]; o[2] = g[2]; o[3] = g[3];
            o[4] = g[4]; o[5] = g[5]; o[6] = g[6];
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
                int64_t dcov = ((max1 - max2) / mmscordiff + 1)
                               * P->nskip;
                if (dcov + cdf + min_cover < max_cover)
                    min_cover = max_cover - dcov;
            }
        }
    }
    *o_nout = n_out;
    *o_max1 = max1;
    *o_max2 = max2;
    return 0;
}

/* Phase B: replay pass 1 consuming the device scores for the SIMD
 * windows (host banded-fast for the rest), then pass 2 / results /
 * report / SAM exactly as fl_map_block.  scores: int64[n_windows].
 * Returns SAM text length or FL_ERR_*; rng_io commits on success. */
int64_t fl_pass2_block(
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table, const uint32_t *pos, int wordlen, int nskip,
    const uint8_t *refcodes, const int64_t *offsets, int64_t nseq,
    const int64_t *seq_ivals,
    const char *snames, const int64_t *sname_offs,
    const int32_t *matrix, int gap_init, int gap_ext,
    int64_t match_avg, int64_t mismatch_avg,
    int64_t ktuple_maxhit, int64_t maxhit_total,
    double min_cover_frac, int64_t min_swatscor,
    int64_t min_swatscor_below_max, int min_basq,
    int64_t target_depth, int64_t max_depth,
    int rmapflg, int rsltouflg,
    int64_t filter_minscor, int64_t filter_belowmax, double filter_minid,
    int soft_clip, int x_mismatch, int out_fmt, int ali_out,
    int codes_are_ascii, int names_raw,
    int64_t n_reads, const uint8_t *codes_concat, const int64_t *read_offs,
    const uint8_t *quals_concat, const uint8_t *has_qual,
    const char *names_concat, const int64_t *name_offs,
    const int64_t *state, const int64_t *state_offs,
    const int64_t *scores, int64_t n_scores,
    uint64_t *rng_io, char *out_text, int64_t out_cap,
    double lam,
    const int64_t *pres, const int64_t *phdr,
    const int64_t *dev_best, const int64_t *dev_mi,
    const int64_t *dev_mj, const int16_t *dev_rec,
    const uint8_t *dev_valid, int64_t dev_sp, int64_t dev_nwin,
    int64_t *dev_stats)
{
    FLParams P;
    FLScratch s;
    FLText t;
    FLDevP2 devs;
    FLDevP2 *devp = NULL;
    uint64_t rng = *rng_io;
    int64_t i, qmax = 1;
    int rc = 0;
    const char **seq_name_ptr = NULL;
    int64_t *seq_name_len = NULL;

    if (dev_best != NULL && pres != NULL) {
        memset(&devs, 0, sizeof(devs));
        devs.best = dev_best;
        devs.mi = dev_mi;
        devs.mj = dev_mj;
        devs.rec = dev_rec;
        devs.valid = dev_valid;
        devs.sp = dev_sp;
        devs.nwin = dev_nwin;
        devp = &devs;
    }

    P.words = words; P.starts = starts; P.nwords = nwords;
    P.table = table; P.pos = pos; P.wordlen = wordlen; P.nskip = nskip;
    P.refcodes = refcodes; P.offsets = offsets; P.nseq = nseq;
    P.seq_ivals = seq_ivals;
    P.ovr_ivals = NULL;
    P.ovr_nivals = 0;
    P.matrix = matrix; P.gap_init = gap_init; P.gap_ext = gap_ext;
    P.match_avg = match_avg; P.mismatch_avg = mismatch_avg;
    P.ktuple_maxhit = ktuple_maxhit; P.maxhit_total = maxhit_total;
    P.min_cover_frac = min_cover_frac; P.min_swatscor = min_swatscor;
    P.min_swatscor_below_max = min_swatscor_below_max;
    P.min_basq = min_basq;
    P.target_depth = target_depth; P.max_depth = max_depth;
    P.rmapflg = rmapflg; P.rsltouflg = rsltouflg;
    P.filter_minscor = filter_minscor; P.filter_belowmax = filter_belowmax;
    P.filter_minid = filter_minid;
    P.soft_clip = soft_clip; P.x_mismatch = x_mismatch;
    P.use_cplx = (rmapflg & RMAPFLG_CMPLXW) ? 1 : 0;
    P.lam = lam;

    for (i = 0; i < n_reads; i++) {
        int64_t ql = read_offs[i + 1] - read_offs[i];
        if (ql > qmax) qmax = ql;
    }
    if (fl_scratch_init(&s, qmax) != 0) {
        fl_scratch_free(&s);
        return FL_ERR_CAP;
    }
    seq_name_ptr = fl_alloc(nseq * (int64_t)sizeof(char *));
    seq_name_len = fl_alloc(nseq * 8);
    if (!seq_name_ptr || !seq_name_len) {
        rc = FL_ERR_CAP;
        goto done;
    }
    for (i = 0; i < nseq; i++) {
        seq_name_ptr[i] = snames + sname_offs[i];
        seq_name_len[i] = sname_offs[i + 1] - sname_offs[i];
    }
    t.p = out_text;
    t.end = out_text + out_cap;
    t.overflow = 0;
    fl_codtab_init();

    for (i = 0; i < n_reads; i++) {
        const uint8_t *codes = codes_concat + read_offs[i];
        const uint8_t *qual = has_qual[i] ? quals_concat + read_offs[i] : NULL;
        int64_t qlen = read_offs[i + 1] - read_offs[i];
        const char *name = names_concat + name_offs[i];
        int64_t name_len = name_offs[i + 1] - name_offs[i];
        const int64_t *hdr = state + state_offs[i];
        const int64_t *rows = hdr + FL_HDR_FIELDS;
        int n_rep = 0, r;
        if (codes_are_ascii) {
            int64_t j;
            for (j = 0; j < qlen; j++)
                s.enc[j] = fl_codtab[codes[j]];
            codes = s.enc;
        }
        if (names_raw)
            name_len = out_fmt >= 1 ? fl_cigar_name_len(name, name_len)
                                    : fl_sam_name_len(name, name_len);

        rs_blank(s.rs);
        if (hdr[7] == 1) {
            /* device-exact fallback: full host re-stage of this read
             * (capacity overflow / checksum / geometry mismatch) —
             * identical to the one-phase lane's per-read body */
            int prof = fl_prof();
            double t0 = prof ? fl_prof_now() : 0.0;
            rc = fl_map_pass(&P, &s, codes, qual, qlen, -1, -1, 0, 1);
            if (prof) fl_prof_acc[FLP_REMAP] += fl_prof_now() - t0;
            if (rc != 0) goto done;
        } else if (!hdr[0]) {            /* not shortseq */
            int64_t n_sort = hdr[1];
            int64_t max1 = 0, max2 = 0;
            int64_t n_out = 0, c;
            s.rs->n_ali_done = n_sort;
            s.rs->n_ali_tot = hdr[2];
            s.rs->n_ali_max = max_depth;
            s.rs->n_hits_used = hdr[5];
            s.rs->n_hits_tot = hdr[6];
            fl_profiles(&P, codes, qlen, s.Wf, s.Wr);
            fl_perfect_prep(&P, &s, codes, qlen);

            if (pres != NULL) {
                /* prep already replayed pass 1: consume its scores */
                int64_t poff = phdr[i * 4 + 3];
                n_out = phdr[i * 4 + 0];
                max1 = phdr[i * 4 + 1];
                max2 = phdr[i * 4 + 2];
                for (c = 0; c < n_out; c++) {
                    const int64_t *g = rows + c * FL_GEOM_FIELDS;
                    int64_t *o = s.score_out + c * 10;
                    o[0] = g[0]; o[1] = g[1]; o[2] = g[2]; o[3] = g[3];
                    o[4] = g[4]; o[5] = g[5]; o[6] = g[6];
                    o[7] = g[7] & 1; o[8] = pres[poff + c]; o[9] = 1;
                }
            } else {
                rc = fl_pass1_replay(&P, &s, hdr, rows, scores, n_scores,
                                     qlen, &n_out, &max1, &max2);
                if (rc != 0) goto done;
            }
            rc = fl_read_finish(&P, &s, qual, qlen, n_out, max1, max2,
                                0, 1, devp);
            if (rc != 0) goto done;
        }
        rc = fl_add_single_to_report(s.rs, rsltouflg, &rng, s.rep, &n_rep);
        if (rc != 0) goto done;
        for (r = 0; r < n_rep; r++) {
            const FLRes *rp = s.rep[r].res_idx >= 0
                              ? &s.rs->res[s.rep[r].res_idx] : NULL;
            if (out_fmt == 3)
                rc = tx_gff_line(&t, name, name_len, s.rs->diffpool,
                                 rp, s.rep[r].mateflg,
                                 rp ? s.rep[r].mapscor : 0,
                                 seq_name_ptr, seq_name_len);
            else if (out_fmt == 2)
                rc = tx_ssaha_line(&t, name, name_len, s.rs->diffpool,
                                   rp, s.rep[r].mateflg,
                                   rp ? s.rep[r].mapscor : 0,
                                   seq_name_ptr, seq_name_len,
                                   offsets, qlen);
            else if (out_fmt == 1)
                rc = tx_cigar_line(&t, name, name_len, s.rs->diffpool,
                                   rp, s.rep[r].mateflg,
                                   rp ? s.rep[r].mapscor : 0,
                                   seq_name_ptr, seq_name_len);
            else
                rc = tx_sam_line(&t, name, name_len, codes, qual, qlen,
                                 s.rs->diffpool, rp, s.rep[r].mateflg,
                                 rp ? s.rep[r].mapscor : 0,
                                 seq_name_ptr, seq_name_len,
                                 soft_clip, x_mismatch);
            if (rc == 0 && ali_out && rp != NULL &&
                (s.rep[r].mateflg & REPFLG_MAPPED))
                rc = tx_align_display(&t, codes, qlen, s.rep[r].mateflg,
                                      rp->q_start, rp->q_end,
                                      rp->s_start, rp->s_end, rp->sidx,
                                      s.rs->diffpool + rp->diff_off,
                                      rp->diff_len, refcodes, offsets);
            if (rc != 0) goto done;
        }
        if (t.overflow) {
            rc = FL_ERR_TEXT;
            goto done;
        }
    }

done:
    free((void *)seq_name_ptr);
    free(seq_name_len);
    fl_scratch_free(&s);
    if (dev_stats != NULL) {
        dev_stats[0] = devp ? devs.n_used : 0;
        dev_stats[1] = devp ? devs.n_fb : 0;
        dev_stats[2] = devp ? devs.n_hit : 0;
    }
    if (rc != 0) return rc;
    *rng_io = rng;
    return t.p - out_text;
}

/* Prep for the device pass-2: replay pass 1 (same loop as
 * fl_pass2_block via fl_pass1_replay), compute the pre-loop min-score
 * dynamics (fl_min_dyn), and emit ONE window descriptor per candidate
 * with swscor >= that read's pre-loop min_swatscor — the exact
 * predicate fl_read_finish's cursor pops under.  Also emits the
 * replayed per-candidate scores (pres) + per-read {n_out, max1, max2,
 * pres_off} (phdr) so fl_pass2_block skips its own replay (no double
 * host DP for non-SIMD candidates).
 *
 * win rows of 12 int64: {read_idx, gstart, b_s_len, l_edge, r_edge,
 * q_left, q_len, is_rev, b_s_left, win_len, valid, 0} — the
 * POST-initALIBAND geometry of the main interval (rmap.c:790-928
 * band widening included).  Returns n_win or FL_ERR_*. */
int64_t fl_pass2_prep_block(
    const int32_t *matrix, int gap_init, int gap_ext,
    int64_t match_avg, int64_t mismatch_avg,
    const uint8_t *refcodes, const int64_t *offsets, int64_t nseq,
    int wordlen, int nskip,
    int64_t min_swatscor, int64_t min_swatscor_below_max,
    int rmapflg,
    int codes_are_ascii,
    int64_t n_reads, const uint8_t *codes_concat, const int64_t *read_offs,
    const int64_t *state, const int64_t *state_offs,
    const int64_t *scores, int64_t n_scores,
    int64_t *pres, int64_t *phdr,
    int64_t *win, int64_t win_cap)
{
    FLParams P;
    FLScratch s;
    int64_t i, qmax = 1, n_win = 0, pres_off = 0;
    int rc = 0;

    memset(&P, 0, sizeof(P));
    P.matrix = matrix; P.gap_init = gap_init; P.gap_ext = gap_ext;
    P.match_avg = match_avg; P.mismatch_avg = mismatch_avg;
    P.refcodes = refcodes; P.offsets = offsets; P.nseq = nseq;
    P.wordlen = wordlen; P.nskip = nskip;
    P.min_swatscor = min_swatscor;
    P.min_swatscor_below_max = min_swatscor_below_max;
    P.rmapflg = rmapflg;

    for (i = 0; i < n_reads; i++) {
        int64_t ql = read_offs[i + 1] - read_offs[i];
        if (ql > qmax) qmax = ql;
    }
    if (fl_scratch_init(&s, qmax) != 0) {
        fl_scratch_free(&s);
        return FL_ERR_CAP;
    }
    fl_codtab_init();

    for (i = 0; i < n_reads; i++) {
        const uint8_t *codes = codes_concat + read_offs[i];
        int64_t qlen = read_offs[i + 1] - read_offs[i];
        const int64_t *hdr = state + state_offs[i];
        const int64_t *rows = hdr + FL_HDR_FIELDS;
        int64_t n_out = 0, max1 = 0, max2 = 0, c;
        int64_t preloop_min, scorlen_min, bandwidth_min;

        phdr[i * 4 + 0] = 0;
        phdr[i * 4 + 1] = 0;
        phdr[i * 4 + 2] = 0;
        phdr[i * 4 + 3] = pres_off;
        if (hdr[7] == 1 || hdr[0])
            continue;                /* restage / shortseq: no windows */
        if (codes_are_ascii) {
            int64_t j;
            for (j = 0; j < qlen; j++)
                s.enc[j] = fl_codtab[codes[j]];
            codes = s.enc;
        }
        fl_profiles(&P, codes, qlen, s.Wf, s.Wr);
        rc = fl_pass1_replay(&P, &s, hdr, rows, scores, n_scores,
                             qlen, &n_out, &max1, &max2);
        if (rc != 0) goto done;
        phdr[i * 4 + 0] = n_out;
        phdr[i * 4 + 1] = max1;
        phdr[i * 4 + 2] = max2;
        for (c = 0; c < n_out; c++)
            pres[pres_off + c] = s.score_out[c * 10 + 8];
        pres_off += n_out;
        if (max1 < 1)
            continue;                /* fl_read_finish returns early */
        fl_min_dyn(&P, qlen, max1, max2, &preloop_min, &scorlen_min,
                   &bandwidth_min);
        for (c = 0; c < n_out; c++) {
            const int64_t *o = s.score_out + c * 10;
            int64_t cqs = o[0], cqe = o[1], crs = o[2], cre = o[3];
            int64_t bl = o[4], br = o[5], sqidx = o[6];
            int64_t swscor = o[8];
            int64_t slen, bw, band_l, band_r, gstart;
            int64_t bl2, br2, bsl2, bslen2, bql2, bqlen2, bw2;
            int64_t *w;
            int valid;
            if (swscor < preloop_min)
                continue;
            if (n_win >= win_cap) {
                rc = FL_ERR_CAP;
                goto done;
            }
            slen = cre - crs + 1;
            gstart = (sqidx >= 0 && sqidx < nseq)
                     ? offsets[sqidx] + crs : crs;
            bw = br - bl;
            if (bw < bandwidth_min) {
                int64_t ext = (bandwidth_min - bw + 1) / 2;
                band_l = bl - ext;
                band_r = br + ext;
            } else {
                band_l = bl;
                band_r = br;
            }
            valid = (sqidx < nseq) &&
                    mc_ali_band_make(band_l, band_r, cqs, cqe, qlen,
                                     0, slen - 1, slen,
                                     &bl2, &br2, &bsl2, &bslen2,
                                     &bql2, &bqlen2, &bw2) == 0;
            w = win + n_win * 12;
            if (valid) {
                w[0] = i; w[1] = gstart; w[2] = bslen2;
                w[3] = bl2; w[4] = br2; w[5] = bql2; w[6] = bqlen2;
                w[7] = o[7]; w[8] = bsl2; w[9] = slen;
                w[10] = 1; w[11] = 0;
            } else {
                memset(w, 0, 12 * sizeof(int64_t));
                w[0] = i;
            }
            n_win++;
        }
    }

done:
    fl_scratch_free(&s);
    return rc != 0 ? rc : n_win;
}

/* ---------------- device-exact pre/post blocks ---------------- */

/* One (read, strand) lane's selected hits as packed sort keys (the
 * host hit expansion of fl_exact_pre_block): k1 = p -/+ q/nskip, k2 = q
 * and, with ks, each hit's sequence index. */
static void fl_expand_lane(const int64_t *qo, const int64_t *nh,
                           const int64_t *sl, const uint32_t *sx,
                           int64_t nsel, int strand, int nskip,
                           const uint32_t *pos, const int64_t *seq_offsets,
                           int64_t nseq, int32_t *k1, uint8_t *k2,
                           int32_t *ks)
{
    int64_t tot = 0, r;
    for (r = 0; r < nsel; r++) {
        int64_t ix = sx[r], q = qo[ix], c = nh[ix], l;
        int32_t qd = (int32_t)(q / nskip);
        const uint32_t *pp = pos + sl[ix];
        if (strand) {
            for (l = 0; l < c; l++)
                k1[tot + l] = (int32_t)pp[l] + qd;
        } else {
            for (l = 0; l < c; l++)
                k1[tot + l] = (int32_t)pp[l] - qd;
        }
        memset(k2 + tot, (int)q, (size_t)c);
        if (ks != NULL && c > 0) {
            /* hit p is in sequence v iff
             * offs[v]/nskip <= p < offs[v+1]/nskip (the
             * serial ranges partition: hi_v == lo_{v+1});
             * runs ascend, so bsearch the first hit then
             * advance the boundary pointer */
            int64_t lo_ = 0, hi_ = nseq - 1, sq;
            while (lo_ < hi_) {
                int64_t mid = (lo_ + hi_ + 1) >> 1;
                if ((uint32_t)(seq_offsets[mid] / nskip) <= pp[0])
                    lo_ = mid;
                else
                    hi_ = mid - 1;
            }
            sq = lo_;
            for (l = 0; l < c; l++) {
                while (sq + 1 < nseq &&
                       pp[l] >= (uint32_t)(seq_offsets[sq + 1] / nskip))
                    sq++;
                ks[tot + l] = (int32_t)sq;
            }
        }
        tot += c;
    }
}

/* Host half of the device-exact front end (parallel/exact_collate.py).
 * Per read: hit-info + NR rank selection (mc_hitinfo_short2), cover
 * deficits, hit-number stats, min_cover, and the rank-selected seed
 * mask the device intersects with.  pre rows of 12 int64:
 *   [0] shortseq [1] deficit_f [2] deficit_r [3] hits_used
 *   [4] hits_tot [5] min_cover [6] ckF_n [7] ckF_sum
 *   [8] ckR_n    [9] ckR_sum   [10][11] reserved
 * selmask: u8 [n_reads, 2, Qpad].  Returns 0 or FL_ERR_*. */
int64_t fl_exact_pre_block(
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table, int wordlen, int nskip,
    int64_t ktuple_maxhit, int64_t maxhit_total, int min_basq,
    double min_cover_frac,
    int codes_are_ascii,
    int64_t n_reads, const uint8_t *codes_concat, const int64_t *read_offs,
    const uint8_t *quals_concat, const uint8_t *has_qual,
    int64_t Qpad,
    int64_t *pre, uint8_t *selmask,
    /* optional host-side hit expansion (device gathers from pos[] are
     * the TPU bottleneck — sequential host writes are ~free): packed
     * sort keys per (read, strand) lane, k1 = p -/+ q/nskip (int32),
     * k2 = q (uint8), valid prefix length in tot_out; a lane past
     * Hcap writes no key there but its hit count (> Hcap: the read is
     * not the main step's).  NULL = skip.
     * Requires the seq-by-seq full-cover interval regime (the caller
     * gates on it): the union of in-range slices = the seed's full
     * position run, and each hit's interval id is its sequence.
     * ks_out (optional, int32 [n,2,Hcap]): per-hit sequence index so
     * the device can sort/scan per interval (NULL with nseq == 1:
     * the device substitutes zeros). */
    const uint32_t *pos, int64_t Hcap,
    int32_t *k1_out, uint8_t *k2_out, int32_t *tot_out,
    const int64_t *seq_offsets, int64_t nseq, int32_t *ks_out,
    /* the repeat tier (optional, with the expansion): where both
     * lanes of a read past Hcap fit Ht hits and one of the Bt rows is
     * free, its keys go to the next row of t_k1 / t_k2 / t_ks
     * ([Bt,2,Ht], as above) with t_tot [Bt,2]; t_row [n] names each
     * read's row (-1: not in the tier).  t_k1 NULL = no tier. */
    int64_t Ht, int64_t Bt, int32_t *t_k1, uint8_t *t_k2, int32_t *t_ks,
    int32_t *t_tot, int32_t *t_row)
{
    FLScratch s;
    int64_t i, qmax = 1, nt = 0;
    int rc = 0;

    for (i = 0; i < n_reads; i++) {
        int64_t ql = read_offs[i + 1] - read_offs[i];
        if (ql > qmax) qmax = ql;
    }
    if (qmax > Qpad) return FL_ERR_CAP;
    if (fl_scratch_init(&s, qmax) != 0) {
        fl_scratch_free(&s);
        return FL_ERR_CAP;
    }
    fl_codtab_init();
    memset(selmask, 0, (size_t)(n_reads * 2 * Qpad));

    for (i = 0; i < n_reads; i++) {
        const uint8_t *codes = codes_concat + read_offs[i];
        const uint8_t *qual = has_qual[i] ? quals_concat + read_offs[i]
                                          : NULL;
        int64_t qlen = read_offs[i + 1] - read_offs[i];
        int64_t *p = pre + i * 12;
        int64_t hout[4], nF, rankF, nR, rankR, min_cover;
        int strand;
        memset(p, 0, 12 * 8);
        if (codes_are_ascii) {
            int64_t j;
            for (j = 0; j < qlen; j++)
                s.enc[j] = fl_codtab[codes[j]];
            codes = s.enc;
        }
        if (t_row != NULL) t_row[i] = -1;
        if (qlen < wordlen) {
            p[0] = 1;
            continue;
        }
        rc = (int)mc_hitinfo_short2(words, starts, nwords, table,
                                    wordlen, nskip, codes, qual, qlen,
                                    ktuple_maxhit, maxhit_total,
                                    min_basq,
                                    s.qmaskF, s.qoffsF, s.nhitsF,
                                    s.slotF, s.sidxF,
                                    s.qmaskR, s.qoffsR, s.nhitsR,
                                    s.slotR, s.sidxR,
                                    s.qbuf, s.keybuf, hout);
        if (rc != 0) {
            p[0] = 1;
            rc = 0;
            continue;
        }
        nF = hout[0]; rankF = hout[1]; nR = hout[2]; rankR = hout[3];
        p[1] = mc_cover_deficit(s.qoffsF, s.sidxF, nF, nF > 1, rankF,
                                s.qmaskF, qlen, wordlen, nskip, s.qbuf);
        p[2] = mc_cover_deficit(s.qoffsR, s.sidxR, nR, nR > 1, rankR,
                                s.qmaskR, qlen, wordlen, nskip, s.qbuf);
        {
            int64_t totF = 0, totR = 0, nrankF = 0, nrankR = 0, w;
            for (w = 0; w < nF; w++) totF += s.nhitsF[w];
            for (w = 0; w < nR; w++) totR += s.nhitsR[w];
            if (rankF > 0)
                for (w = 0; w < rankF; w++)
                    nrankF += s.nhitsF[s.sidxF[w]];
            else
                nrankF = totF;
            if (rankR > 0)
                for (w = 0; w < rankR; w++)
                    nrankR += s.nhitsR[s.sidxR[w]];
            else
                nrankR = totR;
            p[3] = nrankF + nrankR;
            p[4] = totF + totR;
        }
        /* _covermin + calcMinKtup (fl_read_stage1) */
        if (min_cover_frac < 1.01) {
            int64_t c = (int64_t)(min_cover_frac * (double)qlen);
            min_cover = c < qlen ? c : qlen;
        } else {
            min_cover = (int64_t)min_cover_frac;
        }
        {
            int64_t min_ktup;
            if (min_cover >= wordlen + nskip)
                min_ktup = (min_cover - wordlen) / nskip;
            else
                min_ktup = 1;
            p[5] = (min_ktup - 1) * nskip + wordlen;
        }
        /* checksums of the host's hit-info view (order-free) */
        {
            int64_t ck = 0, w;
            for (w = 0; w < nF; w++)
                ck += (s.qoffsF[w] + 1) * s.nhitsF[w];
            p[6] = nF;
            p[7] = ck & 0x7FFFFFFF;
            ck = 0;
            for (w = 0; w < nR; w++)
                ck += (s.qoffsR[w] + 1) * s.nhitsR[w];
            p[8] = nR;
            p[9] = ck & 0x7FFFFFFF;
        }
        /* rank-selected seed masks (+ optional hit expansion: each lane
         * that fits Hcap into the main arrays; a read with a lane past
         * Hcap also into a row of the repeat tier where one is free and
         * both lanes fit Ht) */
        {
            const int64_t *qo[2] = {s.qoffsF, s.qoffsR};
            const int64_t *nh[2] = {s.nhitsF, s.nhitsR};
            const int64_t *sl[2] = {s.slotF, s.slotR};
            const uint32_t *sx[2] = {s.sidxF, s.sidxR};
            int64_t nsel[2], tot[2] = {0, 0}, r;
            nsel[0] = rankF > 0 ? rankF : nF;
            nsel[1] = rankR > 0 ? rankR : nR;
            for (strand = 0; strand < 2; strand++) {
                uint8_t *m = selmask + (i * 2 + strand) * Qpad;
                for (r = 0; r < nsel[strand]; r++) {
                    m[qo[strand][sx[strand][r]]] = 1;
                    tot[strand] += nh[strand][sx[strand][r]];
                }
            }
            for (strand = 0; k1_out != NULL && strand < 2; strand++) {
                int64_t lane = i * 2 + strand;
                tot_out[lane] = (int32_t)tot[strand];
                if (tot[strand] <= Hcap)
                    fl_expand_lane(qo[strand], nh[strand], sl[strand],
                                   sx[strand], nsel[strand], strand, nskip,
                                   pos, seq_offsets, nseq,
                                   k1_out + lane * Hcap, k2_out + lane * Hcap,
                                   ks_out ? ks_out + lane * Hcap : NULL);
            }
            if (t_k1 != NULL && (tot[0] > Hcap || tot[1] > Hcap) &&
                tot[0] <= Ht && tot[1] <= Ht && nt < Bt) {
                t_row[i] = (int32_t)nt;
                for (strand = 0; strand < 2; strand++) {
                    int64_t lane = nt * 2 + strand;
                    fl_expand_lane(qo[strand], nh[strand], sl[strand],
                                   sx[strand], nsel[strand], strand, nskip,
                                   pos, seq_offsets, nseq, t_k1 + lane * Ht,
                                   t_k2 + lane * Ht,
                                   t_ks ? t_ks + lane * Ht : NULL);
                    t_tot[lane] = (int32_t)tot[strand];
                }
                nt++;
            }
        }
    }
    fl_scratch_free(&s);
    return rc;
}

/* Host back half: turn the device pool rows + scores into the pass-2
 * state fl_pass2_block consumes.  Per read: verify the checksums, run
 * the NR depth sort (fl_cands_stats), compute geometry, map each
 * SIMD-eligible selected row to its device score slot.  Reads the
 * device could not serve byte-exactly get hdr[7] = 1 (fl_pass2_block
 * re-stages them fully on host).  Returns 0 or FL_ERR_CAP. */
int64_t fl_exact_post_block(
    int wordlen, int nskip,
    const int64_t *offsets, int64_t nseq,
    int64_t min_swatscor_below_max,
    int64_t match_avg, int64_t mismatch_avg,
    int64_t target_depth, int64_t max_depth, int rmapflg,
    int64_t n_reads, const int64_t *read_offs,
    const int64_t *pre,
    const int32_t *pool, const int32_t *counts2,
    const int32_t *scores, int64_t n_pool,
    const uint8_t *dev_fallback, const int32_t *dev_cksum,
    int64_t *state, int64_t state_cap, int64_t *state_offs,
    int64_t *n_restage_out)
{
    int64_t i, state_used = 0, pool_base = 0, n_restage = 0;
    int64_t mismatchdiff = match_avg - mismatch_avg;
    int64_t cap_cand = 0;
    uint32_t *keys = NULL, *idxs = NULL;
    int64_t *rows11 = NULL;

    for (i = 0; i < n_reads; i++) {
        int64_t c = counts2[i * 2] + counts2[i * 2 + 1];
        if (c > cap_cand) cap_cand = c;
    }
    if (cap_cand < 1) cap_cand = 1;
    keys = fl_alloc(cap_cand * 4);
    idxs = fl_alloc(cap_cand * 4);
    rows11 = fl_alloc(cap_cand * 11 * 8);
    if (!keys || !idxs || !rows11) {
        free(keys); free(idxs); free(rows11);
        return FL_ERR_CAP;
    }

    for (i = 0; i < n_reads; i++) {
        const int64_t *p = pre + i * 12;
        int64_t qlen = read_offs[i + 1] - read_offs[i];
        int64_t ncand = counts2[i * 2] + counts2[i * 2 + 1];
        int64_t *hdr, *rows;
        int64_t maxcov1 = 0, maxcov2 = 0, mincov_below_max;
        int64_t n_sort, n_mincover = 0, r;
        int restage = 0;

        state_offs[i] = state_used;
        if (state_used + FL_HDR_FIELDS > state_cap) goto cap;
        hdr = state + state_used;
        memset(hdr, 0, FL_HDR_FIELDS * 8);
        if (p[0]) {                       /* shortseq */
            hdr[0] = 1;
            state_used += FL_HDR_FIELDS;
            pool_base += ncand;
            continue;
        }
        /* divergence guards: device fallback flag + hit-info checksum */
        if (dev_fallback[i]) { restage = 1; fl_restage_acc[FL_RS_DEV]++; }
        else if (dev_cksum[i * 4 + 0] != p[6] ||
                 dev_cksum[i * 4 + 1] != p[7] ||
                 dev_cksum[i * 4 + 2] != p[8] ||
                 dev_cksum[i * 4 + 3] != p[9]) {
            restage = 1;
            fl_restage_acc[FL_RS_CK]++;
        }

        if (!restage) {
            /* unpack pool rows to out11 form; maxcov = top-2 distinct */
            for (r = 0; r < ncand; r++) {
                const int32_t *w = pool + (pool_base + r) * 6;
                int64_t *o = rows11 + r * 11;
                int64_t cover = (w[0] >> 16) & 0xFF;
                int is_rev = r >= counts2[i * 2];
                o[0] = w[0] & 0xFF;
                o[1] = (w[0] >> 8) & 0xFF;
                o[2] = w[1];
                o[3] = w[2];
                o[4] = w[3];
                o[5] = w[4];
                o[6] = w[5] & 0x3FFFFF;
                o[7] = cover;
                o[8] = (is_rev ? CANDFLAG_REVERSE : 0) |
                       (((uint32_t)w[5] >> 31) ? 2 : 0);
                o[9] = (w[0] >> 24) & 0xFF;
                o[10] = ((uint32_t)w[5] >> 22) & 0x1FF;
                if (cover > maxcov2) {
                    if (cover > maxcov1) {
                        maxcov2 = maxcov1;
                        maxcov1 = cover;
                    } else if (cover != maxcov1) {
                        maxcov2 = cover;
                    }
                }
            }
            /* mincov_below_max (fl_read_stage1) */
            if (min_swatscor_below_max < 0) {
                mincov_below_max = qlen - 1;
            } else {
                mincov_below_max = (min_swatscor_below_max / mismatchdiff)
                                   * nskip;
                if (mincov_below_max < wordlen ||
                    (rmapflg & RMAPFLG_BEST))
                    mincov_below_max = wordlen + 2 * (nskip - 1);
            }
            n_sort = fl_cands_stats(rows11, ncand, maxcov1, maxcov2,
                                    nskip, mincov_below_max,
                                    p[1], p[2],
                                    target_depth, max_depth,
                                    (rmapflg & RMAPFLG_SENSITIVE) != 0,
                                    keys, idxs, &n_mincover);
            if (n_sort < 0) { restage = 1; fl_restage_acc[FL_RS_STATS]++; }
            else {
                if (state_used + FL_HDR_FIELDS +
                    n_sort * FL_GEOM_FIELDS > state_cap) goto cap;
                hdr[1] = n_sort;
                hdr[2] = n_mincover;
                hdr[3] = p[1];
                hdr[4] = p[2];
                hdr[5] = p[3];
                hdr[6] = p[4];
                rows = hdr + FL_HDR_FIELDS;
                for (r = 0; r < n_sort; r++) {
                    const int64_t *row = rows11 + (int64_t)idxs[r] * 11;
                    int64_t qs, qe, rs_, re_, bl, br;
                    int64_t *g = rows + r * FL_GEOM_FIELDS;
                    int is_simd;
                    int64_t pidx = pool_base + idxs[r];
                    if (mc_calc_seg_offsets(row, wordlen, nskip, offsets,
                                            nseq, qlen, &qs, &qe, &rs_,
                                            &re_, &bl, &br) != 0) {
                        restage = 1;
                        fl_restage_acc[FL_RS_GEOM]++;
                        break;
                    }
                    is_simd = (qlen >= 32 && (br - bl) * 48 > qlen &&
                               qs == 0 && qe >= qlen - 1);
                    /* geometry/simd cross-check vs the device:
                     * score >= 0 device-scored SIMD row; -2 the
                     * device DECLINED an oversize SIMD window (the
                     * host striped kernel scores it, g[11]); -1
                     * non-SIMD (host banded) */
                    if (pidx >= n_pool ||
                        (is_simd ? scores[pidx] == -1
                                 : scores[pidx] != -1)) {
                        restage = 1;
                        fl_restage_acc[FL_RS_SIMD]++;
                        break;
                    }
                    g[0] = qs; g[1] = qe; g[2] = rs_; g[3] = re_;
                    g[4] = bl; g[5] = br; g[6] = row[10];
                    g[7] = (row[8] & CANDFLAG_REVERSE) ? 1 : 0;
                    g[8] = row[7];
                    g[9] = is_simd && scores[pidx] >= 0;
                    g[10] = g[9] ? pidx : -1;
                    g[11] = (is_simd && scores[pidx] == -2) ? 1 : 0;
                }
            }
        }
        if (restage) {
            hdr[0] = 0;
            hdr[1] = 0;
            hdr[7] = 1;
            n_restage++;
            state_used += FL_HDR_FIELDS;
        } else {
            state_used += FL_HDR_FIELDS + hdr[1] * FL_GEOM_FIELDS;
        }
        pool_base += ncand;
    }
    state_offs[n_reads] = state_used;
    free(keys); free(idxs); free(rows11);
    if (n_restage_out) *n_restage_out = n_restage;
    return 0;
cap:
    free(keys); free(idxs); free(rows11);
    return FL_ERR_CAP;
}

/* ---------------- fast-mode batched tail ---------------- */

/* Byte-replica of map/fastmode.py FastTail.map_one + _finish +
 * fast_mapq + ReportWriter._write_sam (single-end): one native call
 * renders the SAM text of a whole device-pass batch.  Reads the
 * fast-mode device outputs (score/start/strand + completeness
 * counters) and runs the banded traceback (mc_fast_align) only on the
 * winning window of each read.  Python remains the oracle: any error
 * returns <0 and the caller reruns the batch in Python. */

static const double FL_LOG10 = 2.302585092994046;  /* math.log(10) */

static int64_t fl_fast_mapq(int64_t sw1, int64_t sw2, int64_t qlen,
                            int64_t used, int64_t tot, int64_t n2,
                            int ambig)
{
    double m;
    int64_t cap = MAPSCOR_MAX;
    int64_t qn = 0;
    if (sw2 >= sw1)
        return 0;
    if (n2 > 1)
        qn = (int64_t)(10.0 * log((double)n2) / FL_LOG10);
    m = 250.0 * (double)sw1 / (double)qlen *
        (double)(sw1 - sw2) / (double)qlen - (double)qn;
    if (m >= 0.0)
        m += 4.0;                       /* MAPSCOR_MIN_UNIQ */
    if (tot > 0) {
        double fs = (double)used / ((double)tot + 3.0);
        if (fs <= 1e-7) {
            cap = 0;
        } else {
            double deficit = -10.0 * log(fs) / FL_LOG10;
            cap = deficit < (double)MAPSCOR_MAX
                  ? MAPSCOR_MAX - (int64_t)deficit : 0;
        }
    }
    if (ambig && cap > MAPSCOR_MAX_RANDOM)
        cap = MAPSCOR_MAX_RANDOM;
    if (m > (double)cap)
        m = (double)cap;
    if (m > (double)MAPSCOR_MAX)
        return MAPSCOR_MAX;
    return m > 0.0 ? (int64_t)m : 0;
}

/* ================= exact paired-end block =========================
 *
 * C port of the pair layer: pair enumeration (resultpairs.c:1116-1216
 * via results/pairs.py find_pairs/find_proper_pairs), the pair
 * probability model + marginal mapqs (resultpairs.c:753-952), report
 * assembly (resultpairs.c:1008-1311, report.c:1596-1717) and the
 * paired SAM writer (report.c:762-906 via report.py _write_sam).
 * fl_map_pair_block renders whole blocks of pairs; any branch the
 * lane does not cover (remap/rescue/fine-rehash, resultpairs ties
 * beyond caps) stops BEFORE consuming RNG for that pair and reports
 * the pair index so the caller replays just that pair through the
 * Python oracle — output byte-identical either way. */

#define PAIRFLG_PAIRED 0x01
#define PAIRFLG_RAREMATE 0x02
#define PAIRFLG_RESTRICT_2nd 0x04
#define PAIRFLG_RESTRICT_1st 0x08
#define PMF_REVERSE_1st 0x01
#define PMF_REVERSE_2nd 0x02
#define PMF_LEFTMOST2nd 0x04
#define PMF_SAMECONTIG 0x08
#define PMF_NOCONTIG 0x10
#define MAPFLG_WITHIN 0x01
#define MAPFLG_PROPER 0x02
#define MAPFLG_PAIRED 0x04
#define MAPFLG_CONTIG 0x08
#define MAPFLG_MULT1ST 0x10
#define MAPFLG_MULT2ND 0x20
#define RSLTFLAG_SINGLE 0x40
#define FL_MAXPAIRNUM (1028 * 16)
#define FL_PAIRS_TOTAL 1028           /* engine.py MAXNUM_PAIRS_TOTAL */
#define MAPQ_UNIQUE_1ST 20            /* MAPSCORE_UNIQUE_MAPPED_1ST */
#define MINFRACT_MAXSCOR_2ND 0.8
#define FILTERIVALEXT 30
#define CUMULPROB_OUT 3e-3            /* CUMULPROB_PROPER_OUTSIDE */
#define CUMULPROB_IMP 1e-4            /* CUMULPROB_IMPROPER */
#define REPFLG_PAIRED 0x04
#define REPFLG_MATE2 0x08
#define REPPAIR_MAPPED 0x01
#define REPPAIR_CONTIG 0x02
#define REPPAIR_PROPER 0x04
#define REPPAIR_WITHIN 0x08
#define SAMFLAG_PAIRED 0x0001
#define SAMFLAG_PROPER 0x0002
#define SAMFLAG_MATENOMAP 0x0008
#define SAMFLAG_MATESTRAND 0x0020
#define SAMFLAG_MATE1 0x0040
#define SAMFLAG_MATE2 0x0080

/* propagateMapQualAsProb (results.c:1354-1413; result.py
 * _propagate_prob) — float32 intermediate replicated */
static void rs_propagate_prob(FLResultSet *rs, int qsegx)
{
    int lo = rs->segnor[qsegx], hi = rs->segnor[qsegx + 1];
    int *rspp = rs->segsrtr + lo;
    int nn = hi - lo, i, n1, n2 = 0;
    double p1 = 0.0, p2 = 0.0;
    if (nn < 1) return;
    i = 1;
    while (i < nn &&
           rs->res[rspp[i]].swatscor == rs->res[rspp[0]].swatscor)
        i++;
    n1 = i;
    if (i < nn) {
        i++;
        while (i < nn &&
               rs->res[rspp[i]].swatscor == rs->res[rspp[n1]].swatscor)
            i++;
        n2 = i - n1;
    }
    if (n1 == 1) {
        int64_t isc = rs->res[rspp[0]].mapscor;
        double t;
        if (isc < 0) isc = 0;
        t = (double)(float)(-(float)LOGBASE * (float)isc);
        p2 = exp(t / (double)QUALSCOR_SCAL);
        p1 = 1.0 - p2;
        if (n2 > 1) p2 /= (double)n2;
    } else if (n1 > 1) {
        p1 = 1.0 / (double)n1;
        p2 = p1;
    }
    for (i = 0; i < n1; i++) rs->res[rspp[i]].prob = p1;
    for (i = n1; i < n1 + n2; i++) rs->res[rspp[i]].prob = p2;
    for (i = n1 + n2; i < nn; i++) rs->res[rspp[i]].prob = 0.0;
    if (n1 == 1 && n2 == 0)
        rs->res[rspp[0]].status |= RSLTFLAG_SINGLE;
}

/* resultConvertProbabilityToMappingScore (results.c:292-306) */
static int64_t fl_conv_prob_mapscor(double p)
{
    double isc = 1.0 - p, m;
    if (isc < MINLOGARG) isc = MINLOGARG;
    m = -(double)QUALSCOR_SCAL * log10(isc);
    if (m > MAPSCOR_MAX) return MAPSCOR_MAX;
    if (m < 0.0) return 0;
    return (int64_t)m;
}

/* resultSetGetScorStats (result.py:529-543, incl. the reference's
 * fixed-element quirk) */
static void rs_scor_stats(const FLResultSet *rs, int *num_max, int *num_2nd)
{
    int n = rs->n_sortr, i = 0;
    while (i < n && rs->res[rs->sortr[i]].swatscor >= rs->swatscor_max)
        i++;
    *num_max = i;
    if (i < n && rs->res[rs->sortr[i]].swatscor >= rs->swatscor_2ndmax)
        *num_2nd = n - i;
    else
        *num_2nd = 0;
}

static void rs_rank_depth(const FLResultSet *rs, int *is_single,
                          int *max_rank)
{
    int nm, n2;
    rs_scor_stats(rs, &nm, &n2);
    if (nm < 2) { *is_single = (nm == 1); *max_rank = 1; }
    else { *is_single = 0; *max_rank = 0; }
}

/* resultSetGetTopResult (results.c:2516-2540): result index or -1 */
static int rs_get_top(FLResultSet *rs, int is_randsel, uint64_t *rng,
                      int *is_multi)
{
    int is_single, ntop, top = -1;
    rs_top_count(rs, &is_single, &ntop);
    *is_multi = 0;
    if (ntop > 0) {
        if (is_single) {
            top = rs->sortr[0];
            if (rs->res[top].mapscor < 1) *is_multi = 1;
        } else {
            *is_multi = 1;
        }
        if (*is_multi && is_randsel) {
            int rx = (int)(fl_drand48(rng) * ntop);
            top = rs->sortr[rx];
            rs->res[top].mapscor = mapscor_random_draw(ntop);
        }
    }
    return top;
}

/* resultCalcInsertSize (results.c:938-982) */
static int64_t fl_calc_insert(const FLRes *ap, const FLRes *bp, int *flag)
{
    int f = 0;
    int64_t rA, rB, isiz;
    if (ap->status & RSLTFLAG_REVERSE) f |= PMF_REVERSE_1st;
    if (bp->status & RSLTFLAG_REVERSE) f |= PMF_REVERSE_2nd;
    if (bp->s_start < ap->s_start) f |= PMF_LEFTMOST2nd;
    if (ap->sidx < 0 || bp->sidx < 0) f |= PMF_NOCONTIG;
    else if (ap->sidx == bp->sidx) f |= PMF_SAMECONTIG;
    rA = ap->s_start < bp->s_start ? ap->s_start : bp->s_start;
    rB = ap->s_end > bp->s_end ? ap->s_end : bp->s_end;
    isiz = rB - rA + 1;
    if (f & PMF_LEFTMOST2nd) isiz = -isiz;
    *flag = f;
    return isiz;
}

/* testProperPair (resultpairs.c:135-186) */
static int fl_test_proper(int64_t isize, int iflag, int64_t dmin,
                          int64_t dmax, int libcode)
{
    int mapflg = 0;
    int r1 = (iflag & PMF_REVERSE_1st) != 0;
    int r2 = (iflag & PMF_REVERSE_2nd) != 0;
    int lm2 = (iflag & PMF_LEFTMOST2nd) != 0;
    if (isize < 0) {
        if (-dmax <= isize && isize <= -dmin) mapflg |= MAPFLG_WITHIN;
        switch (libcode) {
        case 0: mapflg |= MAPFLG_PROPER; break;               /* all */
        case 1: if (r1 && !r2 && lm2) mapflg |= MAPFLG_PROPER; break;
        case 2: if (!r1 && r2 && lm2) mapflg |= MAPFLG_PROPER; break;
        case 3: if (r1 && r2 && lm2) mapflg |= MAPFLG_PROPER; break;
        }
    } else {
        if (dmin <= isize && isize <= dmax) mapflg |= MAPFLG_WITHIN;
        switch (libcode) {
        case 0: mapflg |= MAPFLG_PROPER; break;
        case 1: if (!r1 && r2 && !lm2) mapflg |= MAPFLG_PROPER; break;
        case 2: if (r1 && !r2 && !lm2) mapflg |= MAPFLG_PROPER; break;
        case 3: if (!r1 && !r2 && !lm2) mapflg |= MAPFLG_PROPER; break;
        }
    }
    return mapflg;
}

typedef struct {
    int a, b;               /* res indices into rsA / rsB */
    int64_t ins;
    int flag, mapflg;
    double pbf;
} FLPair;

typedef struct {
    FLPair *pairs;          /* cap FL_MAXPAIRNUM (heap, per block) */
    int n_pairs, n_proper, n_within;
    int64_t dmin, dmax;
} FLPairs;

static void flp_blank(FLPairs *fp)
{
    fp->n_pairs = fp->n_proper = fp->n_within = 0;
    fp->dmin = fp->dmax = 0;
}

/* one offset interval of generateOFFSIVAL */
typedef struct {
    int64_t lower, upper;
    int64_t sidx;
    int status;
    int res;                /* res index in rsA */
} FLIval;

/* cmpOFFSIVAL (resultpairs.c:432): sidx asc, REVERSE desc, lower asc;
 * stable insertion sort (counts are small) */
static void flp_sort_ivals(FLIval *iv, int n)
{
    int i, j;
    for (i = 1; i < n; i++) {
        FLIval v = iv[i];
        int64_t vr = v.status & RSLTFLAG_REVERSE;
        j = i - 1;
        while (j >= 0) {
            int64_t jr = iv[j].status & RSLTFLAG_REVERSE;
            if (iv[j].sidx > v.sidx ||
                (iv[j].sidx == v.sidx &&
                 (jr < vr ||
                  (jr == vr && iv[j].lower > v.lower)))) {
                iv[j + 1] = iv[j];
                j--;
            } else {
                break;
            }
        }
        iv[j + 1] = v;
    }
}

/* generateOFFSIVAL + setup (resultpairs.c:196-280; pairs.py:219-247).
 * iv must hold 2 * RES_MAX entries.  Returns the count. */
static int flp_gen_ivals(FLResultSet *rsA, int64_t dmin, int64_t dmax,
                         FLIval *iv)
{
    int n = 0, qsegx;
    if (dmin < 0) dmin = 0;
    if (dmax < 0) dmax = 0;
    if (rsA->qsegno < 1) return 0;
    for (qsegx = 0; qsegx < rsA->qsegno; qsegx++) {
        int lo = rsA->segnor[qsegx], hi = rsA->segnor[qsegx + 1], k;
        for (k = lo; k < hi; k++) {
            FLRes *rp = &rsA->res[rsA->segsrtr[k]];
            int64_t r0, lo1, hi1, lo2, hi2;
            if (rp->swrank > 0) break;
            if (rp->status & RSLTFLAG_REVERSE)
                r0 = rp->s_end + rp->q_start - 2;
            else
                r0 = rp->s_start - rp->q_start;
            if (r0 >= dmax) {
                lo1 = r0 - dmax;
                hi1 = r0 - dmin;
            } else {
                lo1 = 0;
                hi1 = r0 > dmin ? r0 - dmin : 0;
            }
            lo2 = r0 + dmin;
            hi2 = r0 + dmax;
            if (lo2 <= hi1) {
                iv[n].lower = lo1; iv[n].upper = hi2;
                iv[n].sidx = rp->sidx; iv[n].status = rp->status;
                iv[n].res = rsA->segsrtr[k];
                n++;
            } else {
                iv[n].lower = lo1; iv[n].upper = hi1;
                iv[n].sidx = rp->sidx; iv[n].status = rp->status;
                iv[n].res = rsA->segsrtr[k];
                n++;
                iv[n].lower = lo2; iv[n].upper = hi2;
                iv[n].sidx = rp->sidx; iv[n].status = rp->status;
                iv[n].res = rsA->segsrtr[k];
                n++;
            }
        }
    }
    flp_sort_ivals(iv, n);
    return n;
}

/* resultSetFindProperPairs (resultpairs.c:1162-1216) */
static void flp_find_proper(FLPairs *fp, int64_t dmin, int64_t dmax,
                            int maxnum, int64_t swscor_min, int libcode,
                            FLResultSet *rsA, FLResultSet *rsB,
                            FLIval *ivbuf)
{
    int nival, ivalx = 0, stop = 0, qsegx;
    flp_blank(fp);
    if (rsA->qsegno < 1 || rsB->qsegno < 1 ||
        rsA->segnor[rsA->qsegno] < 1 || rsB->segnor[rsB->qsegno] < 1)
        return;
    nival = flp_gen_ivals(rsA, dmin, dmax, ivbuf);
    if (swscor_min < 1) {
        swscor_min = rsB->swatscor_2ndmax > 0 ? rsB->swatscor_2ndmax
                                              : rsB->swatscor_max;
    }
    if (dmin > dmax) { fp->dmin = dmax; fp->dmax = dmin; }
    else { fp->dmin = dmin; fp->dmax = dmax; }
    if (maxnum < 1) maxnum = 1;
    if (swscor_min > rsB->swatscor_max) return;
    for (qsegx = 0; qsegx < rsB->qsegno && !stop; qsegx++) {
        int lo = rsB->segnor[qsegx], hi = rsB->segnor[qsegx + 1], k;
        for (k = lo; k < hi && !stop; k++) {
            FLRes *rp = &rsB->res[rsB->segsrtr[k]];
            int64_t r0;
            if (rp->swrank > 0) break;
            if (rp->swatscor < swscor_min) break;
            if (ivalx >= nival) ivalx = 0;
            while (ivalx < nival) {
                const FLIval *ivp = &ivbuf[ivalx];
                if (rp->sidx < ivp->sidx) break;
                if (rp->sidx > ivp->sidx) { ivalx++; continue; }
                if (rp->status & RSLTFLAG_REVERSE) {
                    if (ivp->status & RSLTFLAG_REVERSE) { ivalx++; continue; }
                    r0 = rp->s_end + rp->q_start - 2;
                } else {
                    if (!(ivp->status & RSLTFLAG_REVERSE)) { ivalx++; continue; }
                    r0 = rp->s_start - rp->q_start;
                }
                if (r0 > ivp->upper) { ivalx++; continue; }
                if (r0 < ivp->lower) break;
                {
                    FLPair *mp = &fp->pairs[fp->n_pairs];
                    int64_t isiz;
                    mp->a = ivp->res;
                    mp->b = rsB->segsrtr[k];
                    mp->ins = fl_calc_insert(&rsA->res[mp->a],
                                             &rsB->res[mp->b], &mp->flag);
                    mp->mapflg = fl_test_proper(mp->ins, mp->flag,
                                                fp->dmin, fp->dmax,
                                                libcode);
                    mp->mapflg |= MAPFLG_PAIRED | MAPFLG_CONTIG;
                    mp->pbf = 0.0;
                    isiz = mp->ins < 0 ? -mp->ins : mp->ins;
                    if (fp->dmin <= isiz && isiz <= fp->dmax)
                        fp->n_pairs++;
                    if (fp->n_pairs >= maxnum) { stop = 1; break; }
                }
                ivalx++;
            }
        }
    }
    fp->n_proper = fp->n_pairs;
}

/* resultSetFindPairs (resultpairs.c:1116-1160) */
static void flp_find_pairs(FLPairs *fp, int pairflg, int libcode,
                           int64_t dmin, int64_t dmax,
                           FLResultSet *rsA, FLResultSet *rsB)
{
    int is_sA, is_sB, max_rankA, max_rankB, qA, stop = 0;
    flp_blank(fp);
    if (dmin > dmax) { fp->dmin = dmax; fp->dmax = dmin; }
    else { fp->dmin = dmin; fp->dmax = dmax; }
    rs_rank_depth(rsA, &is_sA, &max_rankA);
    rs_rank_depth(rsB, &is_sB, &max_rankB);
    if ((pairflg & PAIRFLG_RESTRICT_2nd) && is_sA) max_rankA = 0;
    else if ((pairflg & PAIRFLG_RESTRICT_1st) && is_sB) max_rankB = 0;
    for (qA = 0; qA < rsA->qsegno && !stop; qA++) {
        int loA = rsA->segnor[qA], hiA = rsA->segnor[qA + 1], kA;
        for (kA = loA; kA < hiA && !stop; kA++) {
            FLRes *ap = &rsA->res[rsA->segsrtr[kA]];
            int qB;
            if (ap->swrank > max_rankA) break;
            for (qB = 0; qB < rsB->qsegno && !stop; qB++) {
                int loB = rsB->segnor[qB], hiB = rsB->segnor[qB + 1], kB;
                for (kB = loB; kB < hiB; kB++) {
                    FLRes *bp = &rsB->res[rsB->segsrtr[kB]];
                    FLPair *mp;
                    if (bp->swrank > max_rankB) break;
                    mp = &fp->pairs[fp->n_pairs];
                    mp->a = rsA->segsrtr[kA];
                    mp->b = rsB->segsrtr[kB];
                    mp->mapflg = MAPFLG_PAIRED;
                    mp->pbf = 0.0;
                    mp->ins = fl_calc_insert(ap, bp, &mp->flag);
                    if (mp->flag & PMF_SAMECONTIG) {
                        mp->mapflg |= fl_test_proper(mp->ins, mp->flag,
                                                     fp->dmin, fp->dmax,
                                                     libcode);
                        if (mp->mapflg & MAPFLG_WITHIN) {
                            fp->n_within++;
                            if (mp->mapflg & MAPFLG_PROPER)
                                fp->n_proper++;
                        }
                        mp->mapflg |= MAPFLG_CONTIG;
                    }
                    fp->n_pairs++;
                    if (fp->n_pairs >= FL_MAXPAIRNUM) { stop = 1; break; }
                }
            }
        }
    }
}

/* Insert-size histogram (-g): cumulative counts over fixed-width
 * bins, precomputed by the caller from InsHist (insert.py:48-86,
 * insGetHistoCountCumulative).  cum == NULL means no histogram. */
typedef struct {
    const int64_t *cum;     /* [span] inclusive cumulative counts */
    int64_t span, lo, hi, scalfac, num;
} FLInsHist;

/* assignProbabilityToPairs (resultpairs.c:753-826); with -g the
 * within-range likelihood is weighted by the sampled cumulative
 * insert distribution (resultpairs.c:787-801) */
static void flp_assign_prob(FLPairs *fp, int pairflg,
                            const FLResultSet *rsA, const FLResultSet *rsB,
                            const FLInsHist *ih,
                            double *psum_out, double *marga_out,
                            double *margb_out)
{
    double prob_improper = CUMULPROB_IMP;
    double prob_proper = 1.0 - CUMULPROB_IMP;
    double prob_out = CUMULPROB_OUT;
    double prob_in = 1.0 - CUMULPROB_OUT;
    double prob_allout = prob_improper + prob_proper * prob_out;
    double psum = MINLOGARG, marga = 0.0, margb = 0.0;
    int i;
    for (i = 0; i < fp->n_pairs; i++) {
        FLPair *mp = &fp->pairs[i];
        double pa = rsA->res[mp->a].prob;
        double pb = rsB->res[mp->b].prob;
        double iab;
        int flga = rsA->res[mp->a].status;
        int flgb = rsB->res[mp->b].status;
        if (pairflg & PAIRFLG_RESTRICT_1st) {
            if (pa > pb) pa = pb;
        } else if (pairflg & PAIRFLG_RESTRICT_2nd) {
            if (pb > pa) pb = pa;
        }
        if (mp->mapflg & MAPFLG_PROPER) {
            iab = prob_proper;
            if (mp->mapflg & MAPFLG_WITHIN) {
                if (ih->cum == NULL || fp->n_pairs < 2) {
                    iab *= prob_in;
                } else {
                    int64_t ins = mp->ins < 0 ? -mp->ins : mp->ins;
                    int64_t cc = 0, totnum = ih->num;
                    double p;
                    if (ins >= ih->lo && ins <= ih->hi) {
                        int64_t bx = (ins - ih->lo) / ih->scalfac;
                        if (bx > ih->span - 1) bx = ih->span - 1;
                        cc = ih->cum[bx];
                    }
                    if (totnum < 1) { totnum = 1; cc = 1; }
                    p = (double)cc / (double)totnum;
                    if (p >= 0.5) iab = 0.5 - p / 2.0;
                    iab *= p * prob_in + prob_out;
                }
            } else {
                iab *= prob_out;
            }
        } else {
            iab = prob_improper;
        }
        mp->pbf = pa * pb * iab;
        psum += mp->pbf;
        if (flga & RSLTFLAG_SINGLE) {
            double sv = (1.0 - pa) * prob_allout * pb;
            margb += sv;
            psum += sv;
        }
        if (flgb & RSLTFLAG_SINGLE) {
            double sv = pa * prob_allout * (1.0 - pb);
            marga += sv;
            psum += sv;
        }
    }
    *psum_out = psum;
    *marga_out = marga;
    *margb_out = margb;
}

/* stable sort by pbf desc (Python list.sort stability) */
static void flp_sort_pbf(FLPair *p, int n)
{
    int i, j;
    for (i = 1; i < n; i++) {
        FLPair v = p[i];
        j = i - 1;
        while (j >= 0 && p[j].pbf < v.pbf) {
            p[j + 1] = p[j];
            j--;
        }
        p[j + 1] = v;
    }
}

/* drawPairAtRandomByProbability (resultpairs.c:726-752) */
static int flp_draw_random(FLPairs *fp, uint64_t *rng)
{
    double sum = 0.0, pthresh, sv = 0.0;
    int i;
    for (i = 0; i < fp->n_pairs; i++) sum += fp->pairs[i].pbf;
    pthresh = fl_drand48(rng) * sum;
    for (i = 0; i < fp->n_pairs; i++) {
        sv += fp->pairs[i].pbf;
        if (sv + MINLOGARG > pthresh) return i;
    }
    return fp->n_pairs ? fp->n_pairs - 1 : -1;
}

/* scorePairsSimple (resultpairs.c:828-952).  Outputs result indices
 * (-1 = none), marginal mapqs, mapflg, n_max. */
static void flp_score_simple(FLPairs *fp, int pairflg, int rsltouflg,
                             FLResultSet *rsA, FLResultSet *rsB,
                             const FLInsHist *ih, uint64_t *rng,
                             int *ap_out, int *bp_out,
                             int64_t *mapqA_out, int64_t *mapqB_out,
                             int *mapflg_out, int *n_max_out)
{
    int n_pairs = fp->n_pairs, mapflg = 0, i, n_max, sel;
    double psum, marga, margb, maxprob;
    *mapqA_out = *mapqB_out = 0;
    if (n_pairs == 0) {
        int is_randsel = (rsltouflg & RESULTFLG_RANDSEL) != 0;
        int mA, mB;
        *ap_out = rs_get_top(rsA, is_randsel, rng, &mA);
        *bp_out = rs_get_top(rsB, is_randsel, rng, &mB);
        *mapflg_out = 0;
        *n_max_out = 0;
        return;
    }
    flp_assign_prob(fp, pairflg, rsA, rsB, ih, &psum, &marga, &margb);
    if (psum < MINLOGARG) psum = MINLOGARG;
    flp_sort_pbf(fp->pairs, n_pairs);
    i = 1;
    while (i < n_pairs && fp->pairs[i].pbf + MINLOGARG >= fp->pairs[0].pbf)
        i++;
    n_max = i;
    sel = 0;
    maxprob = fp->pairs[0].pbf / psum;
    if (maxprob <= 0.6 && n_pairs > 1) {
        mapflg = MAPFLG_MULT1ST | MAPFLG_MULT2ND;
        if (rsltouflg & RESULTFLG_RANDSEL)
            sel = flp_draw_random(fp, rng);
        else if (!(rsltouflg & RESULTFLG_SINGLE))
            sel = 0;
        else
            sel = -1;
    }
    if (sel < 0) {
        *ap_out = *bp_out = -1;
        *mapflg_out = mapflg;
        *n_max_out = n_max;
        return;
    }
    {
        FLPair *mp = &fp->pairs[sel];
        int a = mp->a, b = mp->b;
        mapflg |= mp->mapflg;
        for (i = 0; i < n_pairs; i++) {
            if (fp->pairs[i].a == a) marga += fp->pairs[i].pbf;
            if (fp->pairs[i].b == b) margb += fp->pairs[i].pbf;
        }
        *ap_out = a;
        *bp_out = b;
        *mapqA_out = fl_conv_prob_mapscor(marga / psum);
        *mapqB_out = fl_conv_prob_mapscor(margb / psum);
        *mapflg_out = mapflg;
        *n_max_out = n_max;
    }
}

/* ---------------- pair report (report.py Report with pairs) -------- */

typedef struct {
    int status;                 /* REPFLG_* */
    int64_t swatscor, mapscor;
    int64_t q_start, q_end, s_start, s_end, s_idx;
    const uint8_t *diff;
    int diff_len;
    int was_output;
} FLRepAli;

typedef struct {
    int iA, iB;
    int64_t isize;
    int pairflg;
} FLRepPair;

#define FLREP_MAX 128

typedef struct {
    FLRepAli arA[FLREP_MAX], arB[FLREP_MAX];
    int nA, nB;
    FLRepPair pairs[FLREP_MAX];
    int n_pairs;
} FLReport;

static void flrep_blank(FLReport *rep)
{
    rep->nA = rep->nB = rep->n_pairs = 0;
}

static int flrep_find(const FLRepAli *arr, int n, int64_t q_start,
                      int64_t q_end, int mateflg, int64_t s_start,
                      int64_t s_end, int64_t s_idx)
{
    int mask = REPFLG_REVERSE | REPFLG_MATE2, i;
    for (i = n - 1; i >= 0; i--) {
        const FLRepAli *r = &arr[i];
        if (s_start == r->s_start && s_end == r->s_end &&
            s_idx == r->s_idx && q_start == r->q_start &&
            q_end == r->q_end && (mateflg & mask) == (r->status & mask))
            return i;
    }
    return -1;
}

/* reportAddMap (report.c:1596-1717; report.py:98-169) */
static int flrep_add_map(FLReport *rep, int pairid, int64_t swatscor,
                         int64_t mapscor, int64_t q_start, int64_t q_end,
                         int64_t s_start, int64_t s_end, int64_t s_idx,
                         const uint8_t *diff, int diff_len, int64_t insiz,
                         int mateflg, int pairflg)
{
    FLRepPair *pp = NULL;
    FLRepAli *rp = NULL;
    if (diff == NULL || diff_len < 1)
        mateflg &= ~REPFLG_MAPPED;
    if ((mateflg & REPFLG_PAIRED) && pairid >= 0) {
        pp = &rep->pairs[pairid];
        if (pp->pairflg == 0) pp->pairflg = pairflg;
        else if (pp->pairflg != pairflg) return FL_ERR_ASSERT;
    }
    if (pp != NULL && (mateflg & REPFLG_MATE2)) {
        if (pp->iA >= 0) {
            int idx;
            if (insiz != pp->isize) return FL_ERR_ASSERT;
            idx = flrep_find(rep->arB, rep->nB, q_start, q_end, mateflg,
                             s_start, s_end, s_idx);
            if (idx < 0) {
                if (rep->nB >= FLREP_MAX) return FL_ERR_CAP;
                pp->iB = rep->nB;
                rp = &rep->arB[rep->nB++];
            } else {
                pp->iB = idx;
                rp = &rep->arB[idx];
            }
        } else {
            pp->isize = insiz;
        }
    } else {
        FLRepAli *arr = rep->arA;
        int *np = &rep->nA;
        int idx;
        if (pp == NULL) {
            if (mateflg & REPFLG_MATE2) { arr = rep->arB; np = &rep->nB; }
        } else {
            if (pp->iB >= 0) {
                if (insiz != pp->isize) return FL_ERR_ASSERT;
            } else {
                pp->isize = insiz;
            }
        }
        idx = flrep_find(arr, *np, q_start, q_end, mateflg, s_start,
                         s_end, s_idx);
        if (idx < 0) {
            if (*np >= FLREP_MAX) return FL_ERR_CAP;
            if (pp != NULL) pp->iA = *np;
            rp = &arr[(*np)++];
        } else {
            if (pp == NULL) rp = NULL;   /* known single mapping */
            else { pp->iA = idx; rp = &arr[idx]; }
        }
    }
    if (rp != NULL) {
        rp->status = mateflg;
        rp->was_output = 0;
        if (mateflg & REPFLG_MAPPED) {
            rp->swatscor = swatscor;
            rp->mapscor = mapscor;
            rp->q_start = q_start;
            rp->q_end = q_end;
            rp->s_start = s_start;
            rp->s_end = s_end;
            rp->s_idx = s_idx;
            rp->diff = diff;
            rp->diff_len = diff_len;
        } else {
            rp->swatscor = rp->mapscor = 0;
            rp->q_start = rp->q_end = rp->s_start = rp->s_end = 0;
            rp->s_idx = 0;
            rp->diff = NULL;
            rp->diff_len = 0;
        }
    }
    return 0;
}

/* resultSetAddResultToReport (results.c:2209-2248) */
static int flrep_add_result(FLReport *rep, int pairid, int64_t mapscor,
                            int mateflg, int pairflg, int64_t isize,
                            const FLResultSet *rs, int res_idx)
{
    if (res_idx < 0 || (rs->res[res_idx].status & RSLTFLAG_NOOUTPUT))
        return flrep_add_map(rep, pairid, 0, 0, 0, 0, 0, 0, 0, NULL, 0,
                            0, mateflg, pairflg);
    {
        const FLRes *rp = &rs->res[res_idx];
        int64_t ms;
        mateflg |= REPFLG_MAPPED;
        if (rp->status & RSLTFLAG_REVERSE) mateflg |= REPFLG_REVERSE;
        ms = pairid < 0 ? rp->mapscor : mapscor;
        return flrep_add_map(rep, pairid, rp->swatscor, ms, rp->q_start,
                            rp->q_end, rp->s_start, rp->s_end, rp->sidx,
                            rs->diffpool + rp->diff_off, rp->diff_len,
                            isize, mateflg, pairflg);
    }
}

/* addPairResultsToReport (resultpairs.c:1008-1068) */
static int flrep_add_pair_results(FLReport *rep, int mapflg, int repmateflg,
                                  int apx, int64_t mapqA, FLResultSet *rsA,
                                  int bpx, int64_t mapqB, FLResultSet *rsB)
{
    int64_t isize = 0;
    int pair_id, reppairflg = 0, rmA, rmB, rc;
    if (rep->n_pairs >= FLREP_MAX) return FL_ERR_CAP;
    pair_id = rep->n_pairs++;
    rep->pairs[pair_id].iA = -1;
    rep->pairs[pair_id].iB = -1;
    rep->pairs[pair_id].isize = 0;
    rep->pairs[pair_id].pairflg = 0;
    repmateflg |= REPFLG_PAIRED;
    if ((mapflg & MAPFLG_PAIRED) && apx >= 0 && bpx >= 0 &&
        !(rsA->res[apx].status & RSLTFLAG_NOOUTPUT) &&
        !(rsB->res[bpx].status & RSLTFLAG_NOOUTPUT)) {
        reppairflg |= REPPAIR_MAPPED;
        if (mapflg & MAPFLG_CONTIG) {
            int f;
            reppairflg |= REPPAIR_CONTIG;
            isize = fl_calc_insert(&rsA->res[apx], &rsB->res[bpx], &f);
            if (mapflg & MAPFLG_WITHIN) reppairflg |= REPPAIR_WITHIN;
            if (mapflg & MAPFLG_PROPER) reppairflg |= REPPAIR_PROPER;
        }
    }
    rmA = repmateflg & ~REPFLG_MATE2;
    if (mapflg & MAPFLG_MULT1ST) rmA |= REPFLG_MULTI;
    rc = flrep_add_result(rep, pair_id, mapqA, rmA, reppairflg, isize,
                          rsA, apx);
    if (rc != 0) return rc;
    rmB = repmateflg | REPFLG_MATE2;
    if (mapflg & MAPFLG_MULT2ND) rmB |= REPFLG_MULTI;
    return flrep_add_result(rep, pair_id, mapqB, rmB, reppairflg, isize,
                            rsB, bpx);
}

/* resultSetAdd2ndaryResultsToReport (resultpairs.c:1293-1310 via
 * results.c:2249-2280; pairs.py _add_2ndary_to_report): per query
 * segment, the best-score chain not yet reported, as unlinked
 * PARTIAL records (pairid -1: mate fields stay unset). */
static int flrep_add_2ndary(FLReport *rep, int mateflg, int rsltouflg,
                            FLResultSet *rs)
{
    int qsegx, rc;
    for (qsegx = 0; qsegx < rs->qsegno; qsegx++) {
        int64_t swscor = 0;
        int k;
        for (k = rs->segnor[qsegx]; k < rs->segnor[qsegx + 1]; k++) {
            FLRes *r = &rs->res[rs->segsrtr[k]];
            if (r->status & RSLTFLAG_NOOUTPUT) continue;
            if ((r->status & RSLTFLAG_REPORTED) ||
                (r->swatscor < swscor &&
                 ((rsltouflg & RESULTFLG_BEST) ||
                  (r->status & RSLTFLAG_BELOWRELSW))))
                break;
            rc = flrep_add_result(rep, -1, 0, mateflg, 0, 0, rs,
                                  rs->segsrtr[k]);
            if (rc != 0) return rc;
            r->status |= RSLTFLAG_REPORTED;
            swscor = r->swatscor;
        }
    }
    return 0;
}

/* resultSetAddPairToReport (resultpairs.c:1222-1311) */
static int flrep_add_pair_to_report(FLReport *rep, FLPairs *fp,
                                    int pairflg, int rsltouflg,
                                    FLResultSet *rsA, FLResultSet *rsB,
                                    const FLInsHist *ih, uint64_t *rng)
{
    int apx, bpx, mapflg, n_max, rc, i;
    int64_t mapqA, mapqB;
    flp_score_simple(fp, pairflg, rsltouflg, rsA, rsB, ih, rng,
                     &apx, &bpx, &mapqA, &mapqB, &mapflg, &n_max);
    if (n_max > 1 && !(rsltouflg & RESULTFLG_RANDSEL) &&
        (rsltouflg & RESULTFLG_SINGLE)) {
        int mA, mB, ax, bx;
        ax = rs_get_top(rsA, 0, rng, &mA);
        bx = rs_get_top(rsB, 0, rng, &mB);
        apx = ax;
        bpx = bx;
        if (!mA) { bpx = -1; mapflg |= MAPFLG_MULT2ND; }
        else if (!mB) { apx = -1; mapflg |= MAPFLG_MULT1ST; }
        else { mapflg |= MAPFLG_MULT1ST | MAPFLG_MULT2ND;
               apx = -1; bpx = -1; }
    }
    rc = flrep_add_pair_results(rep, mapflg,
                                REPFLG_PAIRED | REPFLG_PRIMARY,
                                apx, mapqA, rsA, bpx, mapqB, rsB);
    if (rc != 0) return rc;
    if ((mapflg & (MAPFLG_MULT1ST | MAPFLG_MULT2ND)) &&
        !(rsltouflg & RESULTFLG_RANDSEL) &&
        !(rsltouflg & RESULTFLG_SINGLE)) {
        for (i = 0; i < n_max; i++) {
            FLPair *mp = &fp->pairs[i];
            if (mp->a != apx || mp->b != bpx) {
                int mflg = mp->mapflg |
                           (mapflg & (MAPFLG_MULT1ST | MAPFLG_MULT2ND));
                rc = flrep_add_pair_results(
                    rep, mflg, REPFLG_PAIRED | REPFLG_PRIMARY,
                    mp->a, mapqA, rsA, mp->b, mapqB, rsB);
                if (rc != 0) return rc;
            }
        }
    }
    if ((rsltouflg & RESULTFLG_BEST) && (rsltouflg & RESULTFLG_SPLIT)) {
        rc = flrep_add_2ndary(rep, REPFLG_PAIRED | REPFLG_PARTIAL,
                              rsltouflg, rsA);
        if (rc != 0) return rc;
        rc = flrep_add_2ndary(rep, REPFLG_PAIRED | REPFLG_PARTIAL |
                                   REPFLG_MATE2,
                              rsltouflg, rsB);
        if (rc != 0) return rc;
    }
    return 0;
}

/* fprintREPALIsam for one PAIRED record (report.py:280-355) */
static int tx_sam_line_paired(FLText *t,
                              const char *name, int64_t name_len,
                              const uint8_t *codes, const uint8_t *qual,
                              int64_t qlen,
                              const FLRepAli *rp, const FLRepAli *mp,
                              int64_t isize, int pairflg,
                              const char *const *seq_names,
                              const int64_t *seq_name_lens,
                              int soft_clip, int x_mismatch)
{
    int samflg = 0;
    int64_t pos = 0, mpos = 0, i;
    int mapped = (rp->status & REPFLG_MAPPED) != 0;
    int mate_mapped = 0;
    int64_t ms_idx = -1;

    /* report.py:258-260 quirk: the CONTIG probe does not require the
     * mate record to be mapped (an unmapped mate has s_idx 0) */
    if (mapped && mp != NULL && rp->s_idx == mp->s_idx)
        pairflg |= REPPAIR_CONTIG;
    if (rp->status & REPFLG_PAIRED) {
        samflg |= SAMFLAG_PAIRED;
        if (rp->status & REPFLG_MATE2) {
            samflg |= SAMFLAG_MATE2;
            isize = -isize;
        } else {
            samflg |= SAMFLAG_MATE1;
        }
        if (mp != NULL && (mp->status & REPFLG_MAPPED)) {
            mate_mapped = 1;
            mpos = mp->s_start;
            ms_idx = mp->s_idx;
            if (mp->status & REPFLG_REVERSE) samflg |= SAMFLAG_MATESTRAND;
        } else {
            samflg |= SAMFLAG_MATENOMAP;
            isize = 0;
            mpos = 0;
        }
    }
    if (!mapped) { samflg |= SAMFLAG_NOMAP; isize = 0; }
    else {
        if (rp->status & REPFLG_REVERSE) samflg |= SAMFLAG_STRAND;
        if ((pairflg & REPPAIR_PROPER) && (pairflg & REPPAIR_WITHIN))
            samflg |= SAMFLAG_PROPER;
        if (rp->status & REPFLG_PARTIAL) samflg |= SAMFLAG_NOTPRIMARY;
        pos = rp->s_start;
    }

    tx_putn(t, name, name_len);
    tx_putc(t, '\t');
    tx_puti(t, samflg);
    tx_putc(t, '\t');
    if (mapped) tx_putn(t, seq_names[rp->s_idx], seq_name_lens[rp->s_idx]);
    else tx_putc(t, '*');
    tx_putc(t, '\t');
    tx_puti(t, pos);
    tx_putc(t, '\t');
    tx_puti(t, rp->mapscor);
    tx_putc(t, '\t');
    if (mapped) {
        int is_rev = (rp->status & REPFLG_REVERSE) != 0;
        int64_t clip_start, clip_end, q0, q1;
        int rc2;
        if (is_rev) {
            clip_start = qlen - rp->q_end;
            clip_end = rp->q_start - 1;
        } else {
            clip_start = rp->q_start - 1;
            clip_end = qlen - rp->q_end;
        }
        rc2 = tx_cigar(t, rp->diff, rp->diff_len, !x_mismatch,
                       clip_start, clip_end, soft_clip);
        if (rc2 != 0) return rc2;
        tx_putc(t, '\t');
        if (mate_mapped)
            tx_putn(t, seq_names[ms_idx], seq_name_lens[ms_idx]);
        else
            tx_putc(t, '*');
        tx_putc(t, '\t');
        tx_puti(t, mpos);
        tx_putc(t, '\t');
        tx_puti(t, isize);
        tx_putc(t, '\t');
        if (soft_clip) { q0 = 0; q1 = qlen; }
        else { q0 = rp->q_start - 1; q1 = rp->q_end; }
        if (q1 > q0) {
            if (is_rev)
                for (i = q1 - 1; i >= q0; i--)
                    tx_putc(t, fl_decode1_comp(codes[i]));
            else
                for (i = q0; i < q1; i++)
                    tx_putc(t, fl_decode1(codes[i]));
        } else {
            tx_putc(t, '*');
        }
        tx_putc(t, '\t');
        if (qual && q1 > q0) {
            if (is_rev)
                for (i = q1 - 1; i >= q0; i--) tx_putc(t, (char)qual[i]);
            else
                for (i = q0; i < q1; i++) tx_putc(t, (char)qual[i]);
        } else {
            tx_putc(t, '*');
        }
        tx_puts(t, "\tNM:i:");
        tx_puti(t, fl_levenshtein(rp->diff, rp->diff_len));
        tx_puts(t, "\tAS:i:");
        tx_puti(t, rp->swatscor);
    } else {
        tx_puts(t, "*\t");
        if (mate_mapped)
            tx_putn(t, seq_names[ms_idx], seq_name_lens[ms_idx]);
        else
            tx_putc(t, '*');
        tx_putc(t, '\t');
        tx_puti(t, mpos);
        tx_puts(t, "\t0\t");
        if (soft_clip) {
            for (i = 0; i < qlen; i++) tx_putc(t, fl_decode1(codes[i]));
            tx_putc(t, '\t');
            if (qual) for (i = 0; i < qlen; i++) tx_putc(t, (char)qual[i]);
            else tx_putc(t, '*');
        } else {
            tx_puts(t, "*\t*");
        }
        tx_puts(t, "\tNM:i:0\tAS:i:0");
    }
    tx_putc(t, '\n');
    return 0;
}

/* one paired record in cigar (out_fmt 1) or ssaha (2) form —
 * ReportWriter._write_one's non-SAM arms: per-record CONTIG bit, then
 * the shared field-level emitters */
static int flrep_line_alt(FLText *t, int out_fmt,
                          const char *name, int64_t nlen, int64_t qlen,
                          const FLRepAli *ap, const FLRepAli *mp,
                          int pairflg,
                          const char *const *seq_names,
                          const int64_t *seq_name_lens,
                          const int64_t *offsets)
{
    if ((ap->status & REPFLG_MAPPED) && mp != NULL &&
        ap->s_idx == mp->s_idx)
        pairflg |= 0x02;                       /* REPPAIR_CONTIG */
    if (out_fmt == 3)
        return tx_gff_fields(t, name, nlen, ap->status, ap->mapscor,
                             ap->q_start, ap->q_end, ap->s_start,
                             ap->s_end, ap->swatscor, ap->s_idx,
                             ap->diff, ap->diff_len,
                             seq_names, seq_name_lens);
    if (out_fmt == 2)
        return tx_ssaha_fields(t, name, nlen, ap->status, pairflg,
                               ap->mapscor, ap->q_start, ap->q_end,
                               ap->s_start, ap->s_end, ap->swatscor,
                               ap->s_idx, ap->diff, ap->diff_len,
                               seq_names, seq_name_lens, offsets, qlen);
    return tx_cigar_fields(t, name, nlen, ap->status, pairflg,
                           ap->mapscor, ap->q_start, ap->q_end,
                           ap->s_start, ap->s_end, ap->swatscor,
                           ap->s_idx, ap->diff, ap->diff_len,
                           seq_names, seq_name_lens);
}

/* -a display for one paired record (ReportWriter.write tail) */
static int flrep_ali_display(FLText *t, const FLRepAli *ap,
                             const uint8_t *codes, int64_t qlen,
                             const uint8_t *refcodes,
                             const int64_t *offsets)
{
    if (!(ap->status & REPFLG_MAPPED) || ap->diff == NULL)
        return 0;
    return tx_align_display(t, codes, qlen, ap->status,
                            ap->q_start, ap->q_end,
                            ap->s_start, ap->s_end, ap->s_idx,
                            ap->diff, ap->diff_len, refcodes, offsets);
}

/* ReportWriter.write for a pair (report.py:236-254) */
static int flrep_write(FLText *t, FLReport *rep,
                       const char *nameA, int64_t nlenA,
                       const uint8_t *codesA, const uint8_t *qualA,
                       int64_t qlenA,
                       const char *nameB, int64_t nlenB,
                       const uint8_t *codesB, const uint8_t *qualB,
                       int64_t qlenB,
                       const char *const *seq_names,
                       const int64_t *seq_name_lens,
                       int soft_clip, int x_mismatch,
                       int out_fmt, const int64_t *offsets,
                       int ali_out, const uint8_t *refcodes)
{
    int i, rc, pairflg0 = rep->n_pairs ? rep->pairs[0].pairflg : 0;
    for (i = 0; i < rep->nA; i++) rep->arA[i].was_output = 0;
    for (i = 0; i < rep->nB; i++) rep->arB[i].was_output = 0;
    for (i = 0; i < rep->n_pairs; i++) {
        FLRepPair *pp = &rep->pairs[i];
        FLRepAli *ap = &rep->arA[pp->iA];
        FLRepAli *bp = &rep->arB[pp->iB];
        if (pp->iA < 0 || pp->iB < 0) return FL_ERR_ASSERT;
        ap->was_output = 1;
        bp->was_output = 1;
        if (out_fmt != 0) {
            rc = flrep_line_alt(t, out_fmt, nameA, nlenA, qlenA, ap, bp,
                                pp->pairflg, seq_names, seq_name_lens,
                                offsets);
            if (rc == 0 && ali_out)
                rc = flrep_ali_display(t, ap, codesA, qlenA,
                                       refcodes, offsets);
            if (rc != 0) return rc;
            rc = flrep_line_alt(t, out_fmt, nameB, nlenB, qlenB, bp, ap,
                                pp->pairflg, seq_names, seq_name_lens,
                                offsets);
            if (rc == 0 && ali_out)
                rc = flrep_ali_display(t, bp, codesB, qlenB,
                                       refcodes, offsets);
            if (rc != 0) return rc;
            continue;
        }
        rc = tx_sam_line_paired(t, nameA, nlenA, codesA, qualA, qlenA,
                                ap, bp, pp->isize, pp->pairflg,
                                seq_names, seq_name_lens,
                                soft_clip, x_mismatch);
        if (rc == 0 && ali_out)
            rc = flrep_ali_display(t, ap, codesA, qlenA,
                                   refcodes, offsets);
        if (rc != 0) return rc;
        rc = tx_sam_line_paired(t, nameB, nlenB, codesB, qualB, qlenB,
                                bp, ap, pp->isize, pp->pairflg,
                                seq_names, seq_name_lens,
                                soft_clip, x_mismatch);
        if (rc == 0 && ali_out)
            rc = flrep_ali_display(t, bp, codesB, qlenB,
                                   refcodes, offsets);
        if (rc != 0) return rc;
    }
    for (i = 0; i < rep->nA; i++) {
        if (!rep->arA[i].was_output) {
            if (out_fmt != 0)
                rc = flrep_line_alt(t, out_fmt, nameA, nlenA, qlenA,
                                    &rep->arA[i], NULL, pairflg0,
                                    seq_names, seq_name_lens, offsets);
            else
                rc = tx_sam_line_paired(t, nameA, nlenA, codesA, qualA,
                                        qlenA, &rep->arA[i], NULL, 0,
                                        pairflg0, seq_names,
                                        seq_name_lens,
                                        soft_clip, x_mismatch);
            if (rc == 0 && ali_out)
                rc = flrep_ali_display(t, &rep->arA[i], codesA, qlenA,
                                       refcodes, offsets);
            if (rc != 0) return rc;
        }
    }
    for (i = 0; i < rep->nB; i++) {
        if (!rep->arB[i].was_output) {
            if (out_fmt != 0)
                rc = flrep_line_alt(t, out_fmt, nameB, nlenB, qlenB,
                                    &rep->arB[i], NULL, pairflg0,
                                    seq_names, seq_name_lens, offsets);
            else
                rc = tx_sam_line_paired(t, nameB, nlenB, codesB, qualB,
                                        qlenB, &rep->arB[i], NULL, 0,
                                        pairflg0, seq_names,
                                        seq_name_lens,
                                        soft_clip, x_mismatch);
            if (rc == 0 && ali_out)
                rc = flrep_ali_display(t, &rep->arB[i], codesB, qlenB,
                                       refcodes, offsets);
            if (rc != 0) return rc;
        }
    }
    return 0;
}

/* ---------------- fine re-hash (rmap.c:495-517) ---------------- */

#define FINEHASH_WORDLEN 5            /* engine.py:53 */
#define FINEHASH_MAXKTUPPOS (128 * 1024 * 1024)
#define FL_FINE_CAP (1 << 16)

typedef struct { uint64_t w; uint32_t p; } FLWordPos;

static int flwp_cmp(const void *a, const void *b)
{
    const FLWordPos *x = (const FLWordPos *)a;
    const FLWordPos *y = (const FLWordPos *)b;
    if (x->w != y->w) return x->w < y->w ? -1 : 1;
    if (x->p != y->p) return x->p < y->p ? -1 : 1;
    return 0;
}

/* build_index over LOCAL restrict rows (index/table.py:188-233):
 * sampled words per interval, (word, serial) sort, CSR.  Returns the
 * distinct-word count, or FL_ERR_CAP when over cap. */
static int64_t fl_fine_build(const uint8_t *refcodes,
                             const int64_t *offsets,
                             const int64_t *loc, int64_t nloc,
                             int k, int nskip,
                             uint64_t *words, int64_t *starts,
                             uint32_t *pos, FLWordPos *wp, int64_t cap)
{
    int64_t n = 0, v, i, nw = 0;
    for (v = 0; v < nloc; v++) {
        int64_t lo = loc[v * 3], hi = loc[v * 3 + 1];
        int64_t sx = loc[v * 3 + 2];
        int64_t soffs = offsets[sx] + lo;
        int64_t slen = hi - lo + 1;
        int64_t g0 = ((soffs + nskip - 1) / nskip) * nskip;
        int64_t gs;
        for (gs = g0; gs + k <= soffs + slen; gs += nskip) {
            uint64_t w = 0;
            int ok = 1, j;
            for (j = 0; j < k; j++) {
                uint8_t c = refcodes[gs + j];
                if (c & 4) { ok = 0; break; }
                w = (w << 2) | (uint64_t)(c & 3);
            }
            if (!ok) continue;
            if (n >= cap) return FL_ERR_CAP;
            wp[n].w = w;
            wp[n].p = (uint32_t)(gs / nskip);
            n++;
        }
    }
    qsort(wp, (size_t)n, sizeof(FLWordPos), flwp_cmp);
    for (i = 0; i < n; i++) {
        if (i == 0 || wp[i].w != wp[i - 1].w) {
            words[nw] = wp[i].w;
            starts[nw] = i;
            nw++;
        }
        pos[i] = wp[i].p;
    }
    starts[nw] = n;
    return nw;
}

/* ---------------- pair block driver ---------------- */

#define RMAPFLG_ALLPAIR 0x08
#define RMAPFLG_PAIRED 0x10

/* One single-read mapping with the pair-flow parameters (engine.py
 * _map_single_native: MINSCOR_BELOW_MAX_BEST, rmapflg|PAIRED,
 * optional interval restriction), plus the probability propagation
 * the pair model reads.  Returns 0 ok, 1 shortseq (rs blank), <0 err.
 * nhit_out = cutoff-limited hit count (rare-mate ordering). */
static int fl_pair_map_single(const FLParams *Pbase, FLScratch *s,
                              const uint8_t *codes, const uint8_t *qual,
                              int64_t qlen,
                              const int64_t *ovr, int64_t novr,
                              int blank, const int64_t *pre_hout,
                              int64_t *nhit_out)
{
    FLParams P = *Pbase;
    FLStage1 st;
    int64_t out_max[3], nhit = 0, j;
    int rc, q;
    P.ovr_ivals = ovr;
    P.ovr_nivals = novr;
    P.min_swatscor_below_max = 0;      /* MINSCOR_BELOW_MAX_BEST */
    int prof = fl_prof();
    double t0 = prof ? fl_prof_now() : 0.0;
    P.rmapflg = (Pbase->rmapflg | RMAPFLG_PAIRED) & ~RMAPFLG_ALLPAIR;
    if (blank)
        rs_blank(s->rs);
    rc = fl_read_stage1(&P, s, codes, qual, qlen, pre_hout, &st,
                        -1, -1);
    if (prof) { double t1 = fl_prof_now(); fl_prof_acc[FLP_SEED] += t1 - t0; t0 = t1; }
    if (rc != 0) return rc;
    if (st.shortseq) return 1;
    for (j = 0; j < st.nF; j++)
        if (P.ktuple_maxhit < 1 || s->nhitsF[j] <= P.ktuple_maxhit)
            nhit += s->nhitsF[j];
    for (j = 0; j < st.nR; j++)
        if (P.ktuple_maxhit < 1 || s->nhitsR[j] <= P.ktuple_maxhit)
            nhit += s->nhitsR[j];
    s->rs->n_ali_done = st.n_sort;
    s->rs->n_ali_tot = st.n_mincover;
    s->rs->n_ali_max = P.max_depth;
    s->rs->n_hits_used = st.hits_used;
    s->rs->n_hits_tot = st.hits_tot;
    fl_profiles(&P, codes, qlen, s->Wf, s->Wr);
    fl_perfect_prep(&P, s, codes, qlen);
    rc = (int)mc_score_cands(s->out11, s->stat_idxs, st.n_sort,
                             P.wordlen, P.nskip,
                             P.refcodes, P.offsets, P.nseq, qlen,
                             s->Wf, s->Wr, P.gap_init, P.gap_ext,
                             P.match_avg, P.mismatch_avg,
                             (P.rmapflg & RMAPFLG_BEST) != 0,
                             st.deficit_f, st.deficit_r,
                             s->Hbuf, s->Ebuf, s->score_out, out_max);
    if (prof) { double t1 = fl_prof_now(); fl_prof_acc[FLP_PASS1] += t1 - t0; t0 = t1; }
    if (rc != 0) return FL_ERR_ASSERT;
    rc = fl_read_finish(&P, s, qual, qlen, out_max[2],
                        out_max[0], out_max[1],
                        (P.rmapflg & RMAPFLG_SPLIT) != 0, 1, NULL);
    if (prof) fl_prof_acc[FLP_PASS2] += fl_prof_now() - t0;
    if (rc != 0) return rc;
    for (q = 0; q < s->rs->qsegno; q++)
        rs_propagate_prob(s->rs, q);
    *nhit_out = nhit;
    return 0;
}

/* fl_pair_map_single with stage 1 + pass 1 replaced by the
 * device-exact front half's state (fl_exact_post_block rows in the
 * fl_pass2_block format, plus the device pass-1 scores) — the
 * UNRESTRICTED mapping calls of the pair flow only; interval-
 * restricted and fine-rehash calls stay on host.  Mirrors
 * fl_pair_map_single's parameter mods, rs bookkeeping and finish
 * exactly (rmap.c:1744-2112 common flow).  Returns 0 ok, 1 shortseq,
 * <0 err. */
static int fl_pair_map_single_dev(const FLParams *Pbase, FLScratch *s,
                                  const uint8_t *codes,
                                  const uint8_t *qual, int64_t qlen,
                                  const int64_t *hdr,
                                  const int64_t *scores,
                                  int64_t n_scores, int blank)
{
    FLParams P = *Pbase;
    int64_t n_out, max1, max2;
    int rc, q;
    P.ovr_ivals = NULL;
    P.ovr_nivals = 0;
    P.min_swatscor_below_max = 0;      /* MINSCOR_BELOW_MAX_BEST */
    P.rmapflg = (Pbase->rmapflg | RMAPFLG_PAIRED) & ~RMAPFLG_ALLPAIR;
    if (blank)
        rs_blank(s->rs);
    if (hdr[0])
        return 1;                       /* shortseq */
    s->rs->n_ali_done = hdr[1];
    s->rs->n_ali_tot = hdr[2];
    s->rs->n_ali_max = P.max_depth;
    s->rs->n_hits_used = hdr[5];
    s->rs->n_hits_tot = hdr[6];
    fl_profiles(&P, codes, qlen, s->Wf, s->Wr);
    fl_perfect_prep(&P, s, codes, qlen);
    rc = fl_pass1_replay(&P, s, hdr, hdr + FL_HDR_FIELDS, scores,
                         n_scores, qlen, &n_out, &max1, &max2);
    if (rc != 0)
        return rc;
    rc = fl_read_finish(&P, s, qual, qlen, n_out, max1, max2,
                        (P.rmapflg & RMAPFLG_SPLIT) != 0, 1, NULL);
    if (rc != 0)
        return rc;
    for (q = 0; q < s->rs->qsegno; q++)
        rs_propagate_prob(s->rs, q);
    return 0;
}

/* hashCalcHitInfoNumberOfHits probe (fl_hit_count body).  Returns the
 * cutoff-limited count, or -1 = ShortSeq/hit-info failure. */
/* hout_save: 6 entries {nF, rankF, nR, rankR, has_rankF, has_rankR}
 * — the pre_hout contract of fl_read_stage1. */
static int64_t fl_pair_probe(const FLParams *P, FLScratch *s,
                             const uint8_t *codes, const uint8_t *qual,
                             int64_t qlen, int64_t *hout_save)
{
    int64_t *hout = hout_save;
    int64_t n = 0, j, nF, nR;
    int rc;
    int prof = fl_prof();
    double t0 = prof ? fl_prof_now() : 0.0;
    if (qlen < P->wordlen) return -1;
    if (P->rmapflg & RMAPFLG_NOSHRTINFO) {
        /* -p collects the FULL hit-info variant for the pair flow too
         * (engine.py:863 `short = not NOSHRTINFO` -> collect_hit_info
         * maxhit 0, no seed ranking); the short2 probe under-collects
         * and every pass downstream reuses this hout as pre_hout. */
        int64_t nFu, nRu, w;
        nFu = mc_hitinfo_collect(P->words, P->starts, P->nwords,
                                 P->table, P->wordlen, P->nskip,
                                 codes, qual, qlen, 0, 0, P->min_basq,
                                 0, 0,
                                 s->qmaskF, s->qoffsF, s->nhitsF,
                                 s->slotF);
        nRu = mc_hitinfo_collect(P->words, P->starts, P->nwords,
                                 P->table, P->wordlen, P->nskip,
                                 codes, qual, qlen, 1, 0, P->min_basq,
                                 0, 0,
                                 s->qmaskR, s->qoffsR, s->nhitsR,
                                 s->slotR);
        if (nFu < 0 || nRu < 0) return -1;
        for (w = 0; w < nFu; w++) s->sidxF[w] = (uint32_t)w;
        for (w = 0; w < nRu; w++) s->sidxR[w] = (uint32_t)w;
        hout[0] = nFu; hout[1] = 0;
        hout[2] = nRu; hout[3] = 0;
        hout[4] = hout[5] = 0;          /* rank 0: all seeds in rank */
        nF = nFu;
        nR = nRu;
        for (j = 0; j < nF; j++)
            if (P->ktuple_maxhit < 1 || s->nhitsF[j] <= P->ktuple_maxhit)
                n += s->nhitsF[j];
        for (j = 0; j < nR; j++)
            if (P->ktuple_maxhit < 1 || s->nhitsR[j] <= P->ktuple_maxhit)
                n += s->nhitsR[j];
        if (prof) fl_prof_acc[FLP_PAIR_PROBE] += fl_prof_now() - t0;
        return n;
    }
    rc = (int)mc_hitinfo_short2(P->words, P->starts, P->nwords, P->table,
                                P->wordlen, P->nskip, codes, qual, qlen,
                                P->ktuple_maxhit, P->maxhit_total,
                                P->min_basq,
                                s->qmaskF, s->qoffsF, s->nhitsF, s->slotF,
                                s->sidxF,
                                s->qmaskR, s->qoffsR, s->nhitsR, s->slotR,
                                s->sidxR, s->qbuf, s->keybuf, hout);
    if (rc != 0) return -1;
    nF = hout[0];
    nR = hout[2];
    for (j = 0; j < nF; j++)
        if (P->ktuple_maxhit < 1 || s->nhitsF[j] <= P->ktuple_maxhit)
            n += s->nhitsF[j];
    for (j = 0; j < nR; j++)
        if (P->ktuple_maxhit < 1 || s->nhitsR[j] <= P->ktuple_maxhit)
            n += s->nhitsR[j];
    hout[4] = nF > 1;
    hout[5] = nR > 1;
    if (prof) fl_prof_acc[FLP_PAIR_PROBE] += fl_prof_now() - t0;
    return n;
}

/* setupInterValFromResultSet + interValPrune (rmap.c:354-436;
 * engine.py _intervals_from_results + _map_single_native conversion):
 * emits GLOBAL rows {offs[sx]+lo, offs[sx]+hi+1, sx} into iv[3*cap].
 * Returns the row count or <0 on a seq-index assert. */
static int64_t fl_gen_intervals(const FLParams *P, FLResultSet *rs1,
                                int64_t readlen, int64_t matelen,
                                int64_t dmin, int64_t dmax,
                                int64_t *iv, int64_t cap,
                                int64_t *loc)
{
    int64_t delta = matelen * FILTERIVALEXT / 100;
    int64_t ktup = P->wordlen;
    int nmax, n2, n, i;
    int64_t m = 0, w;
    rs_scor_stats(rs1, &nmax, &n2);
    n = nmax < rs1->n_sortr ? nmax : rs1->n_sortr;
    for (i = 0; i < n; i++) {
        const FLRes *rp = &rs1->res[rs1->sortr[i]];
        int64_t rlen, lo, hi;
        if (rp->sidx < 0 || rp->sidx >= P->nseq) return FL_ERR_ASSERT;
        rlen = P->offsets[rp->sidx + 1] - P->offsets[rp->sidx];
#define FL_ADJ(t) ((t) >= rlen ? rlen - 1 : ((t) < 1 ? 0 : (t)))
        lo = FL_ADJ(rp->s_end + readlen - rp->q_end - dmax);
        hi = FL_ADJ(rp->s_end + readlen + matelen + delta - rp->q_end -
                    dmin - ktup);
        if (lo <= hi) {
            if (m >= cap) return FL_ERR_CAP;
            iv[m * 3] = lo; iv[m * 3 + 1] = hi; iv[m * 3 + 2] = rp->sidx;
            m++;
        }
        lo = FL_ADJ(rp->s_start - rp->q_start + dmin - matelen);
        hi = FL_ADJ(rp->s_start - rp->q_start + dmax - ktup + delta);
        if (lo <= hi) {
            if (m >= cap) return FL_ERR_CAP;
            iv[m * 3] = lo; iv[m * 3 + 1] = hi; iv[m * 3 + 2] = rp->sidx;
            m++;
        }
#undef FL_ADJ
    }
    /* stable insertion sort by (sidx, lo) */
    for (w = 1; w < m; w++) {
        int64_t v0 = iv[w * 3], v1 = iv[w * 3 + 1], v2 = iv[w * 3 + 2];
        int64_t j = w - 1;
        while (j >= 0 && (iv[j * 3 + 2] > v2 ||
                          (iv[j * 3 + 2] == v2 && iv[j * 3] > v0))) {
            iv[(j + 1) * 3] = iv[j * 3];
            iv[(j + 1) * 3 + 1] = iv[j * 3 + 1];
            iv[(j + 1) * 3 + 2] = iv[j * 3 + 2];
            j--;
        }
        iv[(j + 1) * 3] = v0;
        iv[(j + 1) * 3 + 1] = v1;
        iv[(j + 1) * 3 + 2] = v2;
    }
    /* merge overlaps within a sequence */
    {
        int64_t out = 0;
        for (w = 0; w < m; w++) {
            if (out > 0 && iv[(out - 1) * 3 + 2] == iv[w * 3 + 2] &&
                iv[w * 3] <= iv[(out - 1) * 3 + 1]) {
                if (iv[w * 3 + 1] > iv[(out - 1) * 3 + 1])
                    iv[(out - 1) * 3 + 1] = iv[w * 3 + 1];
            } else {
                iv[out * 3] = iv[w * 3];
                iv[out * 3 + 1] = iv[w * 3 + 1];
                iv[out * 3 + 2] = iv[w * 3 + 2];
                out++;
            }
        }
        m = out;
    }
    /* to global rows (lo_global, hi_global + 1, sidx); `loc` keeps the
     * merged LOCAL rows (lo, hi, sidx) for the fine-index build */
    for (w = 0; w < m; w++) {
        int64_t o = P->offsets[iv[w * 3 + 2]];
        if (loc != NULL) {
            loc[w * 3] = iv[w * 3];
            loc[w * 3 + 1] = iv[w * 3 + 1];
            loc[w * 3 + 2] = iv[w * 3 + 2];
        }
        iv[w * 3] += o;
        iv[w * 3 + 1] += o + 1;
    }
    return m;
}

/* scorIsAboveFractMax (rmap.c:176-186) */
static int fl_above_fract_max(int64_t scor_read, int64_t scor_mate,
                              int64_t rlen, int64_t mlen)
{
    return (double)scor_read >=
           (double)(scor_mate * rlen) * MINFRACT_MAXSCOR_2ND /
           (double)mlen;
}

/* Map a block of read pairs to SAM text — the exact engine's
 * rmapPair (rmap.c:1744-2112) common flow plus the full pair layer,
 * all native.  Reads are passed render_block-style: mangled codes,
 * quals, names for the A mates then (same layout) the B mates.
 *
 * Covered flow per pair: hit probes, rare-first single mappings (the
 * second restricted to the implied insert windows), proper-pair gate,
 * full pair enumeration, probability model + marginal mapqs, report
 * + paired SAM.  Any pair hitting an uncovered branch (remap/rescue/
 * fine-rehash path, report caps) stops the block cleanly: pairs
 * [start..k) are rendered (RNG committed), *done_io = k, and the
 * caller replays pair k through the Python oracle.
 *
 * Returns the text length, or FL_ERR_* with nothing consumed. */
int64_t fl_map_pair_block(
    /* index */
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table, const uint32_t *pos, int wordlen, int nskip,
    /* reference */
    const uint8_t *refcodes, const int64_t *offsets, int64_t nseq,
    const int64_t *seq_ivals,
    const char *snames, const int64_t *sname_offs,
    /* scoring */
    const int32_t *matrix, int gap_init, int gap_ext,
    int64_t match_avg, int64_t mismatch_avg,
    /* params */
    int64_t ktuple_maxhit, int64_t maxhit_total,
    double min_cover_frac, int64_t min_swatscor,
    int64_t min_swatscor_below_max, int min_basq,
    int64_t target_depth, int64_t max_depth,
    int rmapflg, int rsltouflg,
    int64_t filter_minscor, int64_t filter_belowmax, double filter_minid,
    int soft_clip, int x_mismatch,
    /* out_fmt: 0 SAM, 1 plain cigar, 2 ssaha, 3 gff2 (report.c) */
    int out_fmt,
    /* -a: explicit alignment display after each mapped record */
    int ali_out,
    /* pair params */
    int64_t insert_min, int64_t insert_max, int pairtyp,
    /* -g insert histogram: cumulative bin counts (NULL = none) */
    const int64_t *ih_cum, int64_t ih_span, int64_t ih_lo,
    int64_t ih_hi, int64_t ih_scalfac, int64_t ih_num,
    /* reads: A mates then B mates; codes_are_ascii: raw FASTQ letters
     * to encode here; names_raw: cut whitespace + /1 /2 here (else
     * names are pre-stripped) */
    int codes_are_ascii, int names_raw,
    int64_t n_pairs,
    const uint8_t *codesA, const int64_t *offsA,
    const uint8_t *qualsA, const uint8_t *has_qualA,
    const char *namesA, const int64_t *name_offsA,
    const uint8_t *codesB, const int64_t *offsB,
    const uint8_t *qualsB, const uint8_t *has_qualB,
    const char *namesB, const int64_t *name_offsB,
    /* rng + output */
    uint64_t *rng_io, char *out_text, int64_t out_cap,
    int64_t *done_io, double lam,
    /* optional device-exact front half (round 5): per-read state in
     * the fl_pass2_block format (A mates bank + B mates bank share
     * dev_state; dev_offs_A[i]/dev_offs_B[i] locate pair i's mates)
     * and the device pass-1 scores.  NULL dev_state = pure host flow.
     * A pair with either mate flagged (hdr[7] == 1: device restage)
     * or shortseq-inconsistent runs fully on host — byte-identity
     * never depends on the device. */
    const int64_t *dev_state, const int64_t *dev_offs_A,
    const int64_t *dev_offs_B,
    const int64_t *dev_scores, int64_t dev_n_scores)
{
    FLParams P;
    FLScratch sA, sB;
    FLText t;
    FLPairs fp;
    FLInsHist ih;
    FLReport rep;
    FLIval *ivbuf = NULL;
    int64_t *oviv = NULL, *lociv = NULL;
    FLWordPos *fine_wp = NULL;
    uint64_t *fine_words = NULL;
    int64_t *fine_starts = NULL;
    uint32_t *fine_pos = NULL;
    uint64_t rng = *rng_io;
    const char **seq_name_ptr = NULL;
    int64_t *seq_name_len = NULL;
    int64_t i, qmaxA = 1, qmaxB = 1, qmax;
    int rc = 0;
    int initA = 0, initB = 0;

    P.words = words; P.starts = starts; P.nwords = nwords;
    P.table = table; P.pos = pos; P.wordlen = wordlen; P.nskip = nskip;
    P.refcodes = refcodes; P.offsets = offsets; P.nseq = nseq;
    P.seq_ivals = seq_ivals;
    P.ovr_ivals = NULL; P.ovr_nivals = 0;
    P.matrix = matrix; P.gap_init = gap_init; P.gap_ext = gap_ext;
    P.match_avg = match_avg; P.mismatch_avg = mismatch_avg;
    P.ktuple_maxhit = ktuple_maxhit; P.maxhit_total = maxhit_total;
    P.min_cover_frac = min_cover_frac; P.min_swatscor = min_swatscor;
    P.min_swatscor_below_max = min_swatscor_below_max;
    P.min_basq = min_basq;
    P.target_depth = target_depth; P.max_depth = max_depth;
    P.rmapflg = rmapflg; P.rsltouflg = rsltouflg;
    P.filter_minscor = filter_minscor; P.filter_belowmax = filter_belowmax;
    P.filter_minid = filter_minid;
    P.soft_clip = soft_clip; P.x_mismatch = x_mismatch;
    P.use_cplx = (rmapflg & RMAPFLG_CMPLXW) ? 1 : 0;
    P.lam = lam;
    ih.cum = ih_cum; ih.span = ih_span; ih.lo = ih_lo; ih.hi = ih_hi;
    ih.scalfac = ih_scalfac > 0 ? ih_scalfac : 1; ih.num = ih_num;

    *done_io = 0;
    for (i = 0; i < n_pairs; i++) {
        int64_t ql = offsA[i + 1] - offsA[i];
        if (ql > qmaxA) qmaxA = ql;
        ql = offsB[i + 1] - offsB[i];
        if (ql > qmaxB) qmaxB = ql;
    }
    qmax = qmaxA > qmaxB ? qmaxA : qmaxB;
    if (fl_scratch_init(&sA, qmax) == 0) initA = 1;
    if (initA && fl_scratch_init(&sB, qmax) == 0) initB = 1;
    fp.pairs = (FLPair *)fl_alloc(FL_MAXPAIRNUM * (int64_t)sizeof(FLPair));
    ivbuf = (FLIval *)fl_alloc(2 * RES_MAX * (int64_t)sizeof(FLIval));
    oviv = (int64_t *)fl_alloc(2 * RES_MAX * 3 *
                               (int64_t)sizeof(int64_t));
    lociv = (int64_t *)fl_alloc(2 * RES_MAX * 3 *
                                (int64_t)sizeof(int64_t));
    fine_wp = (FLWordPos *)fl_alloc(FL_FINE_CAP *
                                    (int64_t)sizeof(FLWordPos));
    fine_words = (uint64_t *)fl_alloc(FL_FINE_CAP *
                                      (int64_t)sizeof(uint64_t));
    fine_starts = (int64_t *)fl_alloc((FL_FINE_CAP + 1) *
                                      (int64_t)sizeof(int64_t));
    fine_pos = (uint32_t *)fl_alloc(FL_FINE_CAP *
                                    (int64_t)sizeof(uint32_t));
    seq_name_ptr = (const char **)fl_alloc(nseq *
                                           (int64_t)sizeof(char *));
    seq_name_len = (int64_t *)fl_alloc(nseq * (int64_t)sizeof(int64_t));
    if (!initA || !initB || !fp.pairs || !ivbuf || !oviv || !lociv ||
        !fine_wp || !fine_words || !fine_starts || !fine_pos ||
        !seq_name_ptr || !seq_name_len) {
        rc = FL_ERR_CAP;
        goto done;
    }
    for (i = 0; i < nseq; i++) {
        seq_name_ptr[i] = snames + sname_offs[i];
        seq_name_len[i] = sname_offs[i + 1] - sname_offs[i];
    }
    t.p = out_text;
    t.end = out_text + out_cap;
    t.overflow = 0;
    fl_codtab_init();

    for (i = 0; i < n_pairs; i++) {
        const uint8_t *cA = codesA + offsA[i];
        const uint8_t *qA = has_qualA[i] ? qualsA + offsA[i] : NULL;
        int64_t qlA = offsA[i + 1] - offsA[i];
        const uint8_t *cB = codesB + offsB[i];
        const uint8_t *qB = has_qualB[i] ? qualsB + offsB[i] : NULL;
        int64_t qlB = offsB[i + 1] - offsB[i];
        if (codes_are_ascii) {
            int64_t j;
            for (j = 0; j < qlA; j++) sA.enc[j] = fl_codtab[cA[j]];
            for (j = 0; j < qlB; j++) sB.enc[j] = fl_codtab[cB[j]];
            cA = sA.enc;
            cB = sB.enc;
        }
        int64_t nhitA, nhitB, nh1;
        int64_t houtA[6], houtB[6];
        uint64_t rng_save = rng;   /* fallback must not consume RNG */
        int pairflg = PAIRFLG_PAIRED;
        FLScratch *s1, *s2;
        const uint8_t *c1, *c2;
        const uint8_t *q1, *q2;
        int64_t ql1, ql2;
        int rare_is_mate, mrc;
        const int64_t *hdrA = NULL, *hdrB = NULL, *hdr1, *hdr2;
        int use_devA = 0, use_devB = 0, use_dev1, use_dev2;

        if (dev_state != NULL) {
            hdrA = dev_state + dev_offs_A[i];
            hdrB = dev_state + dev_offs_B[i];
            /* per-MATE gating: a flagged mate restages alone while
             * its partner keeps the device state (repeat-heavy
             * corpora flag ~40% of mates; pair-level gating restaged
             * ~65% of pairs) */
            use_devA = hdrA[7] == 0 && !hdrA[0];
            use_devB = hdrB[7] == 0 && !hdrB[0];
        }

        rs_blank(sA.rs);
        rs_blank(sB.rs);
        flp_blank(&fp);
        nhitA = fl_pair_probe(&P, &sA, cA, qA, qlA, houtA);
        nhitB = fl_pair_probe(&P, &sB, cB, qB, qlB, houtB);
        if (nhitA < 0 || nhitB < 0)
            use_devA = use_devB = 0;  /* shortseq: host flow */
        if (nhitA < 0 && nhitB < 0) {
            /* both ShortSeq: two empty result sets */
            goto report;
        }
        if (nhitA < 0 || nhitB < 0) {
            FLScratch *st_ = nhitA < 0 ? &sB : &sA;
            const uint8_t *cc = nhitA < 0 ? cB : cA;
            const uint8_t *qq = nhitA < 0 ? qB : qA;
            int64_t qq_l = nhitA < 0 ? qlB : qlA;
            const int64_t *hh = nhitA < 0 ? houtB : houtA;
            const int64_t *hd = nhitA < 0 ? hdrB : hdrA;
            int remap = fl_prof() && hd != NULL && hd[7] == 1;
            double t0 = remap ? fl_prof_now() : 0.0;
            mrc = fl_pair_map_single(&P, st_, cc, qq, qq_l, NULL, 0, 1,
                                     hh, &nh1);
            if (remap) fl_prof_acc[FLP_REMAP] += fl_prof_now() - t0;
            if (mrc < 0) { rng = rng_save; *done_io = i; goto finish; }
            /* mrc == 1 (ShortSeq): the Python flow passes with an
             * empty result set (engine.py: `except ShortSeq: pass`) */
            if (mrc == 1) rs_blank(st_->rs);
            if (mrc == 0 && (P.rmapflg & RMAPFLG_SPLIT)) {
                /* the good mate still gets the mapSecondary pass +
                 * re-propagation + filter of the appended results
                 * (the reference falls through its whole pair flow,
                 * rmap.c:2099) */
                int q;
                mrc = fl_secondary_pass(&P, st_, cc, qq, qq_l);
                if (mrc != 0) { rng = rng_save; *done_io = i;
                                goto finish; }
                for (q = 0; q < st_->rs->qsegno; q++)
                    rs_propagate_prob(st_->rs, q);
                rs_filter(st_->rs, qq_l, P.filter_minscor,
                          P.filter_belowmax, P.filter_minid);
            }
            goto report;
        }
        {
        const int64_t *h1, *h2;
        if (nhitA > nhitB) {
            pairflg |= PAIRFLG_RAREMATE;
            rare_is_mate = 1;
            s1 = &sB; c1 = cB; q1 = qB; ql1 = qlB; h1 = houtB;
            s2 = &sA; c2 = cA; q2 = qA; ql2 = qlA; h2 = houtA;
            hdr1 = hdrB; hdr2 = hdrA;
            use_dev1 = use_devB; use_dev2 = use_devA;
        } else {
            rare_is_mate = 0;
            s1 = &sA; c1 = cA; q1 = qA; ql1 = qlA; h1 = houtA;
            s2 = &sB; c2 = cB; q2 = qB; ql2 = qlB; h2 = houtB;
            hdr1 = hdrA; hdr2 = hdrB;
            use_dev1 = use_devA; use_dev2 = use_devB;
        }
        {
        /* a mate the post block re-staged maps here on the host */
        int remap = fl_prof() && hdr1 != NULL && hdr1[7] == 1;
        double t0 = remap ? fl_prof_now() : 0.0;
        mrc = use_dev1
              ? fl_pair_map_single_dev(&P, s1, c1, q1, ql1, hdr1,
                                       dev_scores, dev_n_scores, 1)
              : fl_pair_map_single(&P, s1, c1, q1, ql1, NULL, 0, 1,
                                   h1, &nh1);
        if (remap) fl_prof_acc[FLP_REMAP] += fl_prof_now() - t0;
        }
        if (mrc != 0) { rng = rng_save; *done_io = i; goto finish; }
        {
            int64_t mapq1 = 0, swscor1 = 0, swscor2r = 0, niv;
            if (s1->rs->n_sortr) {
                mapq1 = s1->rs->res[s1->rs->sortr[0]].mapscor;
                swscor1 = s1->rs->res[s1->rs->sortr[0]].swatscor;
            }
            niv = fl_gen_intervals(&P, s1->rs, ql1, ql2,
                                   insert_min, insert_max,
                                   oviv, 2 * RES_MAX, NULL);
            if (niv < 0) { rng = rng_save; *done_io = i; goto finish; }
            mrc = fl_pair_map_single(&P, s2, c2, q2, ql2, oviv, niv,
                                     1, h2, &nh1);
            if (mrc != 0) { rng = rng_save; *done_io = i; goto finish; }
            flp_find_proper(&fp, insert_min, insert_max, FL_PAIRS_TOTAL,
                            0, pairtyp, sA.rs, sB.rs, ivbuf);
            if (s2->rs->n_sortr)
                swscor2r = s2->rs->res[s2->rs->sortr[0]].swatscor;
            if ((P.rmapflg & RMAPFLG_ALLPAIR) || fp.n_proper < 1 ||
                mapq1 < MAPQ_UNIQUE_1ST ||
                !fl_above_fract_max(swscor2r, swscor1, ql2, ql1)) {
                /* remap branch (rmap.c:1988-2031): read2 remaps
                 * unrestricted — APPENDING onto the restricted results
                 * unless no proper pair was found.  Only the fine-
                 * rehash continuation stays with the Python oracle. */
                int64_t mapq2 = 0, swscor2 = 0;
                int remap = fl_prof() && hdr2 != NULL && hdr2[7] == 1;
                double t0 = remap ? fl_prof_now() : 0.0;
                mrc = use_dev2
                      ? fl_pair_map_single_dev(&P, s2, c2, q2, ql2,
                                               hdr2, dev_scores,
                                               dev_n_scores,
                                               fp.n_proper < 1)
                      : fl_pair_map_single(&P, s2, c2, q2, ql2, NULL,
                                           0, fp.n_proper < 1, h2,
                                           &nh1);
                if (remap) fl_prof_acc[FLP_REMAP] += fl_prof_now() - t0;
                if (mrc != 0) {
                    rng = rng_save;
                    *done_io = i;
                    goto finish;
                }
                if (s2->rs->n_sortr) {
                    mapq2 = s2->rs->res[s2->rs->sortr[0]].mapscor;
                    swscor2 = s2->rs->res[s2->rs->sortr[0]].swatscor;
                }
                if (mapq2 > MAPQ_UNIQUE_1ST || swscor2 > swscor2r ||
                    swscor2 > swscor1) {
                    /* fine re-hash (rmap.c:1996-2060): re-map read1
                     * against an on-the-fly k=5 index of read2's
                     * implied windows, appending onto rs1 */
                    int64_t sw1_2nd = s1->rs->swatscor_2ndmax;
                    int64_t niv1, nw = -1, total = 0, v;
                    niv1 = fl_gen_intervals(&P, s2->rs, ql2, ql1,
                                            insert_min, insert_max,
                                            oviv, 2 * RES_MAX, lociv);
                    if (niv1 < 0) {
                        rng = rng_save; *done_io = i; goto finish;
                    }
                    for (v = 0; v < niv1; v++)
                        total += lociv[v * 3 + 1] - lociv[v * 3] + 1;
                    if (niv1 > 0 && total <= FINEHASH_MAXKTUPPOS &&
                        P.wordlen <= ql1) {
                        nw = fl_fine_build(refcodes, offsets, lociv,
                                           niv1, FINEHASH_WORDLEN, 1,
                                           fine_words, fine_starts,
                                           fine_pos, fine_wp,
                                           FL_FINE_CAP);
                        if (nw < 0) {
                            rng = rng_save; *done_io = i; goto finish;
                        }
                    }
                    if (nw >= 0) {
                        FLParams P2 = P;
                        int64_t hout6[6], nF1, nR1, w;
                        P2.words = fine_words;
                        P2.starts = fine_starts;
                        P2.nwords = nw;
                        P2.table = NULL;
                        P2.pos = fine_pos;
                        P2.wordlen = FINEHASH_WORDLEN;
                        P2.nskip = 1;
                        P2.min_swatscor = sw1_2nd;
                        nF1 = mc_hitinfo_collect(
                            fine_words, fine_starts, nw, NULL,
                            FINEHASH_WORDLEN, 1, c1, q1, ql1,
                            0, 0, P.min_basq, 0, 0,
                            s1->qmaskF, s1->qoffsF, s1->nhitsF,
                            s1->slotF);
                        nR1 = mc_hitinfo_collect(
                            fine_words, fine_starts, nw, NULL,
                            FINEHASH_WORDLEN, 1, c1, q1, ql1,
                            1, 0, P.min_basq, 0, 0,
                            s1->qmaskR, s1->qoffsR, s1->nhitsR,
                            s1->slotR);
                        if (nF1 >= 0 && nR1 >= 0) {
                            for (w = 0; w < nF1; w++)
                                s1->sidxF[w] = (uint32_t)w;
                            for (w = 0; w < nR1; w++)
                                s1->sidxR[w] = (uint32_t)w;
                            hout6[0] = nF1; hout6[1] = 0;
                            hout6[2] = nR1; hout6[3] = 0;
                            hout6[4] = 0; hout6[5] = 0;
                            mrc = fl_pair_map_single(&P2, s1, c1, q1,
                                                     ql1, oviv, niv1, 0,
                                                     hout6, &nh1);
                            if (mrc != 0) {
                                rng = rng_save; *done_io = i;
                                goto finish;
                            }
                        }
                        /* negative: ShortSeq — the Python flow passes */
                    } else {
                        /* fine unavailable: restricted re-map on the
                         * main index (engine.py:963-967) */
                        FLParams P3 = P;
                        P3.min_swatscor = sw1_2nd;
                        mrc = fl_pair_map_single(&P3, s1, c1, q1, ql1,
                                                 oviv, niv1, 0, h1,
                                                 &nh1);
                        if (mrc != 0) {
                            rng = rng_save; *done_io = i; goto finish;
                        }
                    }
                }
            } else {
                pairflg |= rare_is_mate ? PAIRFLG_RESTRICT_1st
                                        : PAIRFLG_RESTRICT_2nd;
            }
            if (P.rmapflg & RMAPFLG_SPLIT) {
                /* mapSecondary on both mates (rmap.c:2099-2110);
                 * each scratch holds its own mate's profiles from the
                 * pair passes above.  The merged sets re-sorted, the
                 * marginal probabilities the pair scoring reads must
                 * be re-propagated (sort_and_assign does both in the
                 * Python flow, result.py:223-227). */
                int q;
                mrc = fl_secondary_pass(&P, &sA, cA, qA, qlA);
                if (mrc == 0)
                    mrc = fl_secondary_pass(&P, &sB, cB, qB, qlB);
                if (mrc != 0) { rng = rng_save; *done_io = i;
                                goto finish; }
                for (q = 0; q < sA.rs->qsegno; q++)
                    rs_propagate_prob(sA.rs, q);
                for (q = 0; q < sB.rs->qsegno; q++)
                    rs_propagate_prob(sB.rs, q);
            }
            flp_find_pairs(&fp, pairflg, pairtyp, insert_min, insert_max,
                           sA.rs, sB.rs);
            rs_filter(sA.rs, qlA, P.filter_minscor, P.filter_belowmax,
                      P.filter_minid);
            rs_filter(sB.rs, qlB, P.filter_minscor, P.filter_belowmax,
                      P.filter_minid);
        }
        }

report:
        {
        int prof = fl_prof();
        double t0 = prof ? fl_prof_now() : 0.0;
        flrep_blank(&rep);
        rc = flrep_add_pair_to_report(&rep, &fp, pairflg, rsltouflg,
                                      sA.rs, sB.rs, &ih, &rng);
        if (rc != 0) { rc = 0; rng = rng_save; *done_io = i;
                       goto finish; }
        {
        int64_t nlA = name_offsA[i + 1] - name_offsA[i];
        int64_t nlB = name_offsB[i + 1] - name_offsB[i];
        if (names_raw) {
            /* SAM strips a trailing /1 /2; cigar/ssaha keep it
             * (copyReadNamStrToREPSTR is_stripped, report.py _qname) */
            if (out_fmt != 0) {
                nlA = fl_cigar_name_len(namesA + name_offsA[i], nlA);
                nlB = fl_cigar_name_len(namesB + name_offsB[i], nlB);
            } else {
                nlA = fl_sam_name_len(namesA + name_offsA[i], nlA);
                nlB = fl_sam_name_len(namesB + name_offsB[i], nlB);
            }
        }
        rc = flrep_write(&t, &rep,
                         namesA + name_offsA[i], nlA,
                         cA, qA, qlA,
                         namesB + name_offsB[i], nlB,
                         cB, qB, qlB,
                         seq_name_ptr, seq_name_len,
                         soft_clip, x_mismatch,
                         out_fmt, offsets, ali_out, refcodes);
        }
        if (prof) fl_prof_acc[FLP_PAIR_REPORT] += fl_prof_now() - t0;
        }
        if (rc != 0) goto done;
        if (t.overflow) { rc = FL_ERR_TEXT; goto done; }
        *done_io = i + 1;
    }

finish:
    rc = 0;
done:
    free(fp.pairs);
    free(ivbuf);
    free(oviv);
    free(lociv);
    free(fine_wp);
    free(fine_words);
    free(fine_starts);
    free(fine_pos);
    free((void *)seq_name_ptr);
    free(seq_name_len);
    if (initA) fl_scratch_free(&sA);
    if (initB) fl_scratch_free(&sB);
    if (rc != 0) return rc;
    *rng_io = rng;
    return t.p - out_text;
}

/* ---------------- bulk FASTQ scan (fast-mode input) ---------------- */

/* Scan strict 4-line FASTQ records from buf[0..len), at most max_rec.
 * Per record r: name_off/name_len (header after '@', cut at the first
 * space/tab — the same cut as fastmode.iter_fastq_batches), seq_off/
 * seq_len, qual_off (qual length must equal seq_len).  Offsets are
 * absolute into buf, so the batched tail renders zero-copy.
 * *consumed = offset one past the last complete record.  Returns the
 * record count, or -1 on any malformed/unsupported shape ('\r' line
 * endings, multi-line records, length mismatch) — the caller then
 * falls back to the Python parser. */
int64_t fl_fastq_scan(const uint8_t *buf, int64_t len, int64_t max_rec,
                      int64_t *name_off, int64_t *name_len,
                      int64_t *seq_off, int64_t *seq_len,
                      int64_t *qual_off, int64_t *consumed)
{
    int64_t p = 0, n = 0;
    *consumed = 0;
    while (n < max_rec) {
        int64_t l1, l2, l3, l4, i;
        const uint8_t *nl;
        if (p >= len) break;
        if (buf[p] != '@') return -1;
        nl = memchr(buf + p, '\n', (size_t)(len - p));
        if (!nl) break;
        l1 = nl - (buf + p);
        if (l1 < 2 || buf[p + l1 - 1] == '\r') return -1;
        name_off[n] = p + 1;
        for (i = p + 1; i < p + l1; i++)
            if (buf[i] == ' ' || buf[i] == '\t') break;
        name_len[n] = i - (p + 1);
        p += l1 + 1;

        if (p >= len) break;
        nl = memchr(buf + p, '\n', (size_t)(len - p));
        if (!nl) break;
        l2 = nl - (buf + p);
        if (l2 < 1 || buf[p + l2 - 1] == '\r') return -1;
        seq_off[n] = p;
        seq_len[n] = l2;
        p += l2 + 1;

        if (p >= len) break;
        if (buf[p] != '+') return -1;
        nl = memchr(buf + p, '\n', (size_t)(len - p));
        if (!nl) break;
        l3 = nl - (buf + p);
        if (l3 > 1 && buf[p + l3 - 1] == '\r') return -1;
        p += l3 + 1;

        if (p >= len) break;
        nl = memchr(buf + p, '\n', (size_t)(len - p));
        if (!nl) {
            /* a final qual line may lack the trailing newline only at
             * end-of-input; accept it if the length matches */
            if (len - p != l2) break;
            l4 = l2;
            qual_off[n] = p;
            p = len;
            n++;
            *consumed = p;
            break;
        }
        l4 = nl - (buf + p);
        if (l4 != l2) return -1;
        qual_off[n] = p;
        p += l4 + 1;
        n++;
        *consumed = p;
    }
    return n;
}

/* Fill the padded [n, Q] device batch (3-bit alpha codes, pad 7) from
 * scanned record extents — one call replaces encode_batch's Python
 * loop. */
int64_t fl_fastq_encode(const uint8_t *buf, int64_t n,
                        const int64_t *seq_off, const int64_t *seq_len,
                        int64_t Q, uint8_t *enc)
{
    int64_t r, j;
    fl_codtab_init();
    memset(enc, 7, (size_t)(n * Q));
    for (r = 0; r < n; r++) {
        const uint8_t *s = buf + seq_off[r];
        int64_t L = seq_len[r] < Q ? seq_len[r] : Q;
        uint8_t *e = enc + r * Q;
        for (j = 0; j < L; j++)
            e[j] = (uint8_t)(fl_codtab[s[j]] & 7);
    }
    return 0;
}

/* ops/sw.py band_width_for: the device banded kernel's width */
static int64_t fl_band_width_for(int64_t qlen, int64_t pad)
{
    int64_t dr = qlen / 32 > 32 ? qlen / 32 : 32;
    int64_t need = 2 * pad + 2 * dr;
    int64_t W = ((need + 127) / 128) * 128;
    int64_t cap = ((qlen + 127) / 128) * 128 + 128;
    if (W < 128) W = 128;
    if (W > cap) W = cap;
    return W;
}

/* refset.find_seqidx: greatest s with offsets[s] <= g (offsets has
 * nseq+1 entries, offsets[nseq] = total length) */
static int64_t fl_find_seqidx(const int64_t *offsets, int64_t nseq,
                              int64_t g)
{
    int64_t lo = 0, hi = nseq - 1;
    while (lo < hi) {
        int64_t mid = (lo + hi + 1) >> 1;
        if (offsets[mid] <= g) lo = mid;
        else hi = mid - 1;
    }
    return lo;
}

int64_t fl_fast_tail_block(
    /* reference */
    const uint8_t *refcodes, const int64_t *offsets, int64_t nseq,
    const char *snames, const int64_t *sname_offs,
    /* scoring */
    const int32_t *matrix, int gap_init, int gap_ext,
    int64_t match_avg, int64_t minscor,
    int soft_clip, int x_mismatch,
    /* window geometry (per batch) */
    int64_t win_len, int64_t pad, int64_t q_padded,
    /* reads: raw ASCII letters + raw FASTQ names, addressed by
     * per-read (offset, length) extents — with fl_fastq_scan's output
     * these point straight into the input chunk, zero copies */
    int64_t n_reads, const uint8_t *seqs_buf, const int64_t *seq_off,
    const int64_t *seq_len,
    const uint8_t *quals_buf, const int64_t *qual_off,
    const uint8_t *has_qual,
    const char *names_buf, const int64_t *name_off,
    const int64_t *name_len_in,
    /* device-pass outputs, int32 per read */
    const int32_t *score, const int32_t *score2, const int32_t *wstart,
    const int32_t *strand, const int32_t *hits_used,
    const int32_t *hits_tot, const int32_t *n2nd, const int32_t *ambig,
    /* device traceback anchors (window row / padded query col of the
     * winning window's argmax; tb_i NULL or tb_i[i] < 0 -> banded
     * host traceback, the long-read path) */
    const int32_t *tb_i, const int32_t *tb_j,
    /* reads to skip (rendered elsewhere, e.g. exact fallback) */
    const uint8_t *skip,
    /* output: text + per-read text extents out_offs[n_reads+1] */
    char *out_text, int64_t out_cap, int64_t *out_offs)
{
    FLText t;
    const char **seq_name_ptr = NULL;
    int64_t *seq_name_len = NULL;
    uint8_t *enc = NULL, *dirm = NULL, *back = NULL, *diffpool = NULL;
    int32_t *Wbuf = NULL, *Hbuf = NULL, *Ebuf = NULL;
    int64_t *ares = NULL;
    int64_t total_len = offsets[nseq];
    int64_t qmax = 1, i, rc = 0;
    int64_t dirm_cap, back_cap, diff_cap, ares_cap;
    int64_t minscore = minscor > 1 ? minscor : 1;
    int64_t minscorlen = ALILEN_MIN;

    if (ALILEN_MIN * match_avg < minscore)
        minscorlen = minscore / match_avg;

    for (i = 0; i < n_reads; i++) {
        if (seq_len[i] > qmax) qmax = seq_len[i];
    }
    dirm_cap = (qmax + win_len + 2) * (win_len + 1);
    back_cap = 2 * (qmax + win_len) + 8;
    diff_cap = 4 * (qmax + win_len) + 1024;
    ares_cap = win_len / ALILEN_MIN + 4;

    seq_name_ptr = (const char **)fl_alloc(nseq * (int64_t)sizeof(char *));
    seq_name_len = (int64_t *)fl_alloc(nseq * (int64_t)sizeof(int64_t));
    enc = (uint8_t *)fl_alloc(qmax);
    Wbuf = (int32_t *)fl_alloc(8 * qmax * (int64_t)sizeof(int32_t));
    Hbuf = (int32_t *)fl_alloc((qmax + 1) * (int64_t)sizeof(int32_t));
    Ebuf = (int32_t *)fl_alloc((qmax + 1) * (int64_t)sizeof(int32_t));
    dirm = (uint8_t *)fl_alloc(dirm_cap);
    back = (uint8_t *)fl_alloc(back_cap);
    diffpool = (uint8_t *)fl_alloc(diff_cap);
    ares = (int64_t *)fl_alloc(ares_cap * 7 * (int64_t)sizeof(int64_t));
    if (!seq_name_ptr || !seq_name_len || !enc || !Wbuf || !Hbuf ||
        !Ebuf || !dirm || !back || !diffpool || !ares) {
        rc = FL_ERR_CAP;
        goto done;
    }
    for (i = 0; i < nseq; i++) {
        seq_name_ptr[i] = snames + sname_offs[i];
        seq_name_len[i] = sname_offs[i + 1] - sname_offs[i];
    }
    fl_codtab_init();
    t.p = out_text;
    t.end = out_text + out_cap;
    t.overflow = 0;

    for (i = 0; i < n_reads; i++) {
        const uint8_t *ascii = seqs_buf + seq_off[i];
        const uint8_t *qual = has_qual[i] ? quals_buf + qual_off[i]
                                          : NULL;
        int64_t qlen = seq_len[i];
        const char *name = names_buf + name_off[i];
        int64_t name_len = fl_sam_name_len(name, name_len_in[i]);
        int64_t sc1 = score[i];
        int is_rev = strand[i] != 0;
        int64_t j, nres = 0;
        int64_t best[6];            /* sw ps pe ss se diff_len */
        int have_tb = 0;
        int64_t w0 = 0;
        FLRes r;
        int mateflg = 0;

        out_offs[i] = t.p - out_text;
        if (skip && skip[i])
            continue;
        for (j = 0; j < qlen; j++)
            enc[j] = fl_codtab[ascii[j]];

        if (sc1 >= minscor && qlen >= 5) {
            /* clamp the alignment window to the contig under the seed
             * diagonal (fastmode.py map_one) */
            int64_t shift = is_rev ? (q_padded - qlen) : 0;
            int64_t ws = wstart[i];
            int64_t anchor = ws + pad + shift + qlen / 2;
            int64_t sidx, c_lo, c_hi, w1;
            if (anchor < 0) anchor = 0;
            if (anchor > total_len - 1) anchor = total_len - 1;
            sidx = fl_find_seqidx(offsets, nseq, anchor);
            c_lo = offsets[sidx];
            c_hi = offsets[sidx + 1];
            w0 = ws > c_lo ? ws : c_lo;
            w1 = ws + win_len < c_hi ? ws + win_len : c_hi;
            if (w1 - w0 >= 1) {
                int64_t slen = w1 - w0;
                int64_t center = -(pad + shift) + (w0 - ws);
                const uint8_t *win = refcodes + w0;
                if (slen >= 1 && qlen >= ALILEN_MIN &&
                    tb_i != NULL && tb_i[i] >= 0 && q_padded <= 512) {
                    /* device-canonical tail (short-read batch): gapless
                     * shortcut from the kernel's argmax cell, else the
                     * same DP host-side (window row/query col translated
                     * to the clamped window / raw-read frames) */
                    int64_t ti_l = (int64_t)tb_i[i] - (w0 - ws);
                    int64_t tj_l = (int64_t)tb_j[i] - shift;
                    if (ti_l < 0 || ti_l >= slen ||
                        tj_l < 0 || tj_l >= qlen)
                        ti_l = tj_l = -1;
                    nres = mc_dev_align(enc, qlen, is_rev, matrix, win,
                                        slen, ti_l, tj_l, sc1, minscore,
                                        gap_init, gap_ext,
                                        Wbuf, Hbuf, Ebuf,
                                        dirm, dirm_cap, back, back_cap,
                                        diffpool, diff_cap, ares);
                    if (nres > 0) {
                        have_tb = 1;
                        best[0] = ares[0]; best[1] = ares[1];
                        best[2] = ares[2]; best[3] = ares[3];
                        best[4] = ares[4]; best[5] = ares[6];
                    }
                } else if (slen >= 1 && qlen >= ALILEN_MIN) {
                    int64_t drift = q_padded > 512
                        ? fl_band_width_for(q_padded, pad) / 2 : 0;
                    if (q_padded > 512 && tb_i != NULL && tb_i[i] >= 0) {
                        /* banded-kernel anchor: a narrow band centred
                         * on the end diagonal suffices (diag wander is
                         * bounded by the path's indels, not the seed
                         * placement slack); score-verified vs the
                         * device, wide-band fallback on a miss */
                        int64_t ti_l = (int64_t)tb_i[i] - (w0 - ws);
                        int64_t tj_l = (int64_t)tb_j[i] - shift;
                        if (ti_l >= 0 && ti_l < slen &&
                            tj_l >= 0 && tj_l < qlen) {
                            int64_t d_end = tj_l - ti_l;
                            int64_t margin = (qlen / 48 < 32
                                              ? 32 : qlen / 48) + 16;
                            nres = mc_fast_align(
                                enc, qlen, is_rev, matrix, win, slen,
                                d_end - margin, d_end + margin,
                                minscore, minscorlen,
                                gap_init, gap_ext, Wbuf, Hbuf, Ebuf,
                                dirm, dirm_cap, back, back_cap,
                                diffpool, diff_cap, ares, ares_cap);
                            if (nres > 0 && ares[0] >= sc1) {
                                have_tb = 1;
                                best[0] = ares[0]; best[1] = ares[1];
                                best[2] = ares[2]; best[3] = ares[3];
                                best[4] = ares[4]; best[5] = ares[6];
                                if (ares[5] != 0)
                                    memmove(diffpool, diffpool + ares[5],
                                            (size_t)ares[6]);
                            }
                        }
                    }
                    if (!have_tb) {
                    /* cover the device band (fastmode.map_one) */
                    nres = mc_fast_align(enc, qlen, is_rev, matrix, win,
                                         slen, center - 24 - drift,
                                         center + 48 + drift,
                                         minscore, minscorlen,
                                         gap_init, gap_ext,
                                         Wbuf, Hbuf, Ebuf,
                                         dirm, dirm_cap, back, back_cap,
                                         diffpool, diff_cap,
                                         ares, ares_cap);
                    if (nres > 0) {
                        have_tb = 1;
                        best[0] = ares[0]; best[1] = ares[1];
                        best[2] = ares[2]; best[3] = ares[3];
                        best[4] = ares[4];
                        /* keep the diff bytes of result 0 at pool
                         * offset ares[5] */
                        best[5] = ares[6];
                        if (ares[5] != 0)
                            memmove(diffpool, diffpool + ares[5],
                                    (size_t)ares[6]);
                    }
                    if (!have_tb || best[0] < sc1) {
                        /* full-band retry in a second pool region */
                        int64_t half = diff_cap / 2;
                        int64_t nf;
                        if (fl_prof()) {
                            fl_prof_acc[FLP_FAST_RETRY] += 1.0;
                            fl_prof_acc[FLP_FAST_RETRY_GAP] += have_tb
                                ? (double)(sc1 - best[0]) : -1.0;
                        }
                        nf = mc_fast_align(
                            enc, qlen, is_rev, matrix, win, slen,
                            -(slen - 1), qlen - 1, minscore, minscorlen,
                            gap_init, gap_ext, Wbuf, Hbuf, Ebuf,
                            dirm, dirm_cap, back, back_cap,
                            diffpool + half, diff_cap - half,
                            ares, ares_cap);
                        if (nf > 0 &&
                            (!have_tb || ares[0] > best[0])) {
                            have_tb = 1;
                            best[0] = ares[0]; best[1] = ares[1];
                            best[2] = ares[2]; best[3] = ares[3];
                            best[4] = ares[4];
                            best[5] = ares[6];
                            memmove(diffpool, diffpool + half + ares[5],
                                    (size_t)ares[6]);
                        }
                    }
                    }   /* !have_tb (narrow-band anchor missed) */
                }
            }
        }

        if (have_tb) {
            int64_t g = w0 + best[3];
            int64_t sidx2 = fl_find_seqidx(offsets, nseq, g);
            r.swatscor = best[0];
            r.mapscor = fl_fast_mapq(sc1, score2[i], qlen,
                                     hits_used[i], hits_tot[i],
                                     n2nd[i], ambig[i] != 0);
            if (is_rev) {
                r.q_start = qlen - best[2];
                r.q_end = qlen - best[1];
            } else {
                r.q_start = best[1] + 1;
                r.q_end = best[2] + 1;
            }
            r.s_start = g - offsets[sidx2] + 1;
            r.s_end = r.s_start + (best[4] - best[3]);
            r.sidx = sidx2;
            r.diff_off = 0;
            r.diff_len = (int32_t)best[5];
            mateflg = REPFLG_MAPPED | (is_rev ? REPFLG_REVERSE : 0);
            rc = tx_sam_line(&t, name, name_len, enc, qual, qlen,
                             diffpool, &r, mateflg, r.mapscor,
                             seq_name_ptr, seq_name_len,
                             soft_clip, x_mismatch);
        } else {
            rc = tx_sam_line(&t, name, name_len, enc, qual, qlen,
                             diffpool, NULL, 0, 0,
                             seq_name_ptr, seq_name_len,
                             soft_clip, x_mismatch);
        }
        if (rc != 0) goto done;
        if (t.overflow) { rc = FL_ERR_TEXT; goto done; }
    }
    out_offs[n_reads] = t.p - out_text;

done:
    free((void *)seq_name_ptr);
    free(seq_name_len);
    free(enc); free(Wbuf); free(Hbuf); free(Ebuf);
    free(dirm); free(back); free(diffpool); free(ares);
    if (rc != 0) return rc;
    return t.p - out_text;
}

/* Persistent scratch handle: the pair flow calls fl_single_rs /
 * fl_hit_count thousands of times per second; per-call allocation of
 * the ~30 scratch buffers (incl. the MB-scale result set) costs more
 * than the seeding itself.  Reads longer than the handle's qmax fall
 * back to per-call scratch. */
void *fl_scratch_new(int64_t qmax)
{
    FLScratch *s = (FLScratch *)malloc(sizeof(FLScratch));
    if (!s) return NULL;
    if (fl_scratch_init(s, qmax > 1 ? qmax : 1) != 0) {
        fl_scratch_free(s);
        free(s);
        return NULL;
    }
    s->qmax = qmax;
    return s;
}

void fl_scratch_del(void *h)
{
    if (!h) return;
    fl_scratch_free((FLScratch *)h);
    free(h);
}

/* ---------------- single-read mapping as a result-set dump ----------
 *
 * The paired-end engine (map/engine.py rmap_pair, rmap.c:1744-2112)
 * keeps its pair logic in Python (few results per read) but delegates
 * each map_single_read to this entry: the full C stage (hit info ->
 * collation -> depth selection -> pass-1 scoring -> exact pass-2 ->
 * sort/prune -> mapq) runs natively and the FLResultSet is serialized
 * back.  Rows (12 int64 per result, in res[] order):
 *   q_start q_end s_start s_end sidx swatscor mapscor status
 *   diff_off diff_len qsegx swrank
 * sortr_out receives the output-ordered selected indices; seg_out
 * receives segnor[0..qsegno] followed by the segsrtr indices;
 * stats_out[12]: swatmax, swat2nd, n_ali_done, n_ali_tot, n_ali_max,
 * n_hits_used, n_hits_tot, n_sortr, qsegno, n_segsrtr, shortseq,
 * nhit_cutoff (total_hits with the ktuple cutoff, for the rare-mate
 * ordering).
 * Returns n_res, or FL_ERR_* (<0; caller falls back to Python). */
int64_t fl_single_rs(
    /* index (may be the fine rehash index of a mate window) */
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table, const uint32_t *pos, int wordlen, int nskip,
    /* reference */
    const uint8_t *refcodes, const int64_t *offsets, int64_t nseq,
    const int64_t *seq_ivals,
    /* restricted collation intervals, NULL for the full scan */
    const int64_t *ovr_ivals, int64_t ovr_nivals,
    /* scoring */
    const int32_t *matrix, int gap_init, int gap_ext,
    int64_t match_avg, int64_t mismatch_avg,
    /* params */
    int64_t ktuple_maxhit, int64_t maxhit_total,
    double min_cover_frac, int64_t min_swatscor,
    int64_t min_swatscor_below_max, int min_basq,
    int64_t target_depth, int64_t max_depth, int rmapflg,
    /* read (mangled codes) */
    const uint8_t *codes, const uint8_t *qual, int64_t qlen,
    /* outputs */
    int64_t *out_rows, int64_t out_cap_rows,
    uint8_t *diff_out, int64_t diff_cap,
    int64_t *sortr_out, int64_t *seg_out, int64_t *stats_out,
    void *scratch_h, double lam)
{
    FLParams P;
    FLScratch local;
    FLScratch *sp;
    int own = 0;
    int rc;
    int64_t i;
    FLResultSet *rs;

    P.words = words; P.starts = starts; P.nwords = nwords;
    P.table = table; P.pos = pos; P.wordlen = wordlen; P.nskip = nskip;
    P.refcodes = refcodes; P.offsets = offsets; P.nseq = nseq;
    P.seq_ivals = seq_ivals;
    P.ovr_ivals = ovr_ivals;
    P.ovr_nivals = ovr_nivals;
    P.matrix = matrix; P.gap_init = gap_init; P.gap_ext = gap_ext;
    P.match_avg = match_avg; P.mismatch_avg = mismatch_avg;
    P.ktuple_maxhit = ktuple_maxhit; P.maxhit_total = maxhit_total;
    P.min_cover_frac = min_cover_frac; P.min_swatscor = min_swatscor;
    P.min_swatscor_below_max = min_swatscor_below_max;
    P.min_basq = min_basq;
    P.target_depth = target_depth; P.max_depth = max_depth;
    P.rmapflg = rmapflg; P.rsltouflg = 0;
    P.filter_minscor = 0; P.filter_belowmax = 0; P.filter_minid = 0.0;
    P.soft_clip = 1; P.x_mismatch = 0;
    P.use_cplx = (rmapflg & RMAPFLG_CMPLXW) ? 1 : 0;
    P.lam = lam;

    if (scratch_h && ((FLScratch *)scratch_h)->qmax >= qlen) {
        sp = (FLScratch *)scratch_h;
    } else {
        rc = fl_scratch_init(&local, qlen > 1 ? qlen : 1);
        if (rc != 0) { fl_scratch_free(&local); return FL_ERR_CAP; }
        sp = &local;
        own = 1;
    }
#define s (*sp)
    {
        /* fl_map_read body, kept open so the stage-1 hit counts are
         * available for the rare-mate ordering stat (total_hits with
         * the ktuple cutoff, hashhit.c:1173-1199) */
        FLStage1 st;
        int64_t out_max[3], nhit_cutoff = 0, j;
        rs_blank(s.rs);
        rc = fl_read_stage1(&P, &s, codes, qual, qlen, NULL, &st,
                            -1, -1);
        if (rc != 0) { if (own) fl_scratch_free(&local); return rc; }
        if (!st.shortseq) {
            for (j = 0; j < st.nF; j++)
                if (ktuple_maxhit < 1 || s.nhitsF[j] <= ktuple_maxhit)
                    nhit_cutoff += s.nhitsF[j];
            for (j = 0; j < st.nR; j++)
                if (ktuple_maxhit < 1 || s.nhitsR[j] <= ktuple_maxhit)
                    nhit_cutoff += s.nhitsR[j];
            s.rs->n_ali_done = st.n_sort;
            s.rs->n_ali_tot = st.n_mincover;
            s.rs->n_ali_max = P.max_depth;
            s.rs->n_hits_used = st.hits_used;
            s.rs->n_hits_tot = st.hits_tot;
            fl_profiles(&P, codes, qlen, s.Wf, s.Wr);
            fl_perfect_prep(&P, &s, codes, qlen);
            rc = (int)mc_score_cands(s.out11, s.stat_idxs, st.n_sort,
                                     P.wordlen, P.nskip,
                                     P.refcodes, P.offsets, P.nseq, qlen,
                                     s.Wf, s.Wr, P.gap_init, P.gap_ext,
                                     P.match_avg, P.mismatch_avg,
                                     (P.rmapflg & RMAPFLG_BEST) != 0,
                                     st.deficit_f, st.deficit_r,
                                     s.Hbuf, s.Ebuf, s.score_out, out_max);
            if (rc != 0) { if (own) fl_scratch_free(&local); return FL_ERR_ASSERT; }
            rc = fl_read_finish(&P, &s, qual, qlen, out_max[2],
                                out_max[0], out_max[1], 0, 1, NULL);
            if (rc != 0) { if (own) fl_scratch_free(&local); return rc; }
        }
        stats_out[10] = st.shortseq;
        stats_out[11] = nhit_cutoff;
    }

    rs = s.rs;
    if (rs->n_res > out_cap_rows || rs->diff_used > diff_cap) {
        if (own) fl_scratch_free(&local);
        return FL_ERR_CAP;
    }
    for (i = 0; i < rs->n_res; i++) {
        const FLRes *r = &rs->res[i];
        int64_t *o = out_rows + i * 12;
        o[0] = r->q_start; o[1] = r->q_end;
        o[2] = r->s_start; o[3] = r->s_end;
        o[4] = r->sidx; o[5] = r->swatscor; o[6] = r->mapscor;
        o[7] = r->status; o[8] = r->diff_off; o[9] = r->diff_len;
        o[10] = r->qsegx; o[11] = r->swrank;
    }
    memcpy(diff_out, rs->diffpool, (size_t)rs->diff_used);
    for (i = 0; i < rs->n_sortr; i++)
        sortr_out[i] = rs->sortr[i];
    stats_out[0] = rs->swatscor_max;
    stats_out[1] = rs->swatscor_2ndmax;
    stats_out[2] = rs->n_ali_done;
    stats_out[3] = rs->n_ali_tot;
    stats_out[4] = rs->n_ali_max;
    stats_out[5] = rs->n_hits_used;
    stats_out[6] = rs->n_hits_tot;
    stats_out[7] = rs->n_sortr;
    stats_out[8] = rs->qsegno;
    {
        int64_t nseg = rs->qsegno > 0 ? rs->segnor[rs->qsegno] : 0;
        int64_t j;
        for (j = 0; j <= rs->qsegno; j++)
            seg_out[j] = rs->segnor[j];
        for (j = 0; j < nseg; j++)
            seg_out[rs->qsegno + 1 + j] = rs->segsrtr[j];
        stats_out[9] = nseg;
    }
    i = rs->n_res;
#undef s
    if (own) fl_scratch_free(&local);
    return i;
}

/* Hit-count-only probe: total hits under the ktuple cutoff
 * (hashCalcHitInfoNumberOfHits, hashhit.c:1173-1199) for the pair
 * flow's rare-mate ordering, without mapping anything. */
int64_t fl_hit_count(
    const uint64_t *words, const int64_t *starts, int64_t nwords,
    const int32_t *table, const uint32_t *pos, int wordlen, int nskip,
    int64_t ktuple_maxhit, int64_t maxhit_total, int min_basq,
    const uint8_t *codes, const uint8_t *qual, int64_t qlen,
    void *scratch_h)
{
    FLScratch local;
    FLScratch *sp;
    int own = 0;
    int64_t hout[4], n = 0, j, nF, nR;
    int rc;
    (void)pos;
    if (qlen < wordlen)
        return -1;                /* ShortSeq marker */
    if (scratch_h && ((FLScratch *)scratch_h)->qmax >= qlen) {
        sp = (FLScratch *)scratch_h;
    } else {
        rc = fl_scratch_init(&local, qlen > 1 ? qlen : 1);
        if (rc != 0) { fl_scratch_free(&local); return FL_ERR_CAP; }
        sp = &local;
        own = 1;
    }
#define s (*sp)
    rc = (int)mc_hitinfo_short2(words, starts, nwords, table,
                                wordlen, nskip, codes, qual, qlen,
                                ktuple_maxhit, maxhit_total, min_basq,
                                s.qmaskF, s.qoffsF, s.nhitsF, s.slotF,
                                s.sidxF,
                                s.qmaskR, s.qoffsR, s.nhitsR, s.slotR,
                                s.sidxR, s.qbuf, s.keybuf, hout);
    if (rc != 0) {
        if (own) fl_scratch_free(&local);
#undef s
        return -1;                /* hit-info failure = ShortSeq */
    }
#define s (*sp)
    nF = hout[0]; nR = hout[2];
    for (j = 0; j < nF; j++)
        if (ktuple_maxhit < 1 || s.nhitsF[j] <= ktuple_maxhit)
            n += s.nhitsF[j];
    for (j = 0; j < nR; j++)
        if (ktuple_maxhit < 1 || s.nhitsR[j] <= ktuple_maxhit)
            n += s.nhitsR[j];
#undef s
    if (own) fl_scratch_free(&local);
    return n;
}

/* ---------------- fast-mode batched tail: paired-end ----------------
 *
 * Byte-replica of map/fastmode.py FastTail.render_pairs (map_one for
 * both mates, insert-window mate rescue, testProperPair geometry for
 * any library code, tied-mate pair-marginal elevation) and the paired
 * ReportWriter._write_sam fields.  The insert-histogram weighting
 * stays in Python (the caller gates on ihist is None). */

typedef struct {
    const uint8_t *refcodes;
    const int64_t *offsets;
    int64_t nseq, total_len;
    const int32_t *matrix;
    int gap_init, gap_ext;
    int64_t minscor, minscore, minscorlen;
    int64_t win_len, pad, q_padded;
    int32_t *Wbuf, *Hbuf, *Ebuf;
    uint8_t *dirm, *back;
    int64_t dirm_cap, back_cap, diff_cap;
    int64_t *ares;
    int64_t ares_cap;
} FTCtx;

typedef struct {
    int mapped, is_rev;
    int64_t q_start, q_end, s_start, s_end, sidx;
    int64_t swatscor, mapscor;
    int64_t diff_len;
    uint8_t *diff;              /* caller-owned pool */
} FTAli;

/* FastTail.map_one minus the mapq (filled by the caller): traceback of
 * the winning window, clamped to the seed's contig.  With a device
 * argmax anchor (ti >= 0) the device-canonical tail runs (gapless
 * shortcut or host replay of the device DP); else the banded
 * narrow+retry path (long reads). */
static int ft_map_one(FTCtx *c, const uint8_t *enc, int64_t qlen,
                      int64_t sc1, int is_rev, int64_t ws,
                      int64_t ti, int64_t tj,
                      uint8_t *pool, FTAli *r)
{
    int64_t shift, anchor, sidx, c_lo, c_hi, w0, w1, slen, center;
    int64_t best[6];
    int have = 0;
    const uint8_t *win;
    int64_t nres;

    r->mapped = 0;
    if (sc1 < c->minscor || qlen < 5)
        return 0;
    shift = is_rev ? (c->q_padded - qlen) : 0;
    anchor = ws + c->pad + shift + qlen / 2;
    if (anchor < 0) anchor = 0;
    if (anchor > c->total_len - 1) anchor = c->total_len - 1;
    sidx = fl_find_seqidx(c->offsets, c->nseq, anchor);
    c_lo = c->offsets[sidx];
    c_hi = c->offsets[sidx + 1];
    w0 = ws > c_lo ? ws : c_lo;
    w1 = ws + c->win_len < c_hi ? ws + c->win_len : c_hi;
    if (w1 - w0 < 1)
        return 0;
    slen = w1 - w0;
    center = -(c->pad + shift) + (w0 - ws);
    win = c->refcodes + w0;
    if (slen >= 1 && qlen >= ALILEN_MIN && ti >= 0 &&
        c->q_padded <= 512) {
        int64_t ti_l = ti - (w0 - ws);
        int64_t tj_l = tj - shift;
        if (ti_l < 0 || ti_l >= slen || tj_l < 0 || tj_l >= qlen)
            ti_l = tj_l = -1;
        nres = mc_dev_align(enc, qlen, is_rev, c->matrix, win, slen,
                            ti_l, tj_l, sc1, c->minscore,
                            c->gap_init, c->gap_ext,
                            c->Wbuf, c->Hbuf, c->Ebuf,
                            c->dirm, c->dirm_cap, c->back, c->back_cap,
                            pool, c->diff_cap, c->ares);
        if (nres > 0) {
            have = 1;
            best[0] = c->ares[0]; best[1] = c->ares[1];
            best[2] = c->ares[2]; best[3] = c->ares[3];
            best[4] = c->ares[4]; best[5] = c->ares[6];
        }
    } else if (slen >= 1 && qlen >= ALILEN_MIN) {
        int64_t half = c->diff_cap / 2;
        int64_t drift = c->q_padded > 512
            ? fl_band_width_for(c->q_padded, c->pad) / 2 : 0;
        if (c->q_padded > 512 && ti >= 0) {
            /* banded-kernel anchor: narrow band on the end diagonal,
             * score-verified vs the device (see fl_fast_tail_block) */
            int64_t ti_l = ti - (w0 - ws);
            int64_t tj_l = tj - shift;
            if (ti_l >= 0 && ti_l < slen && tj_l >= 0 && tj_l < qlen) {
                int64_t d_end = tj_l - ti_l;
                int64_t margin = (qlen / 48 < 32 ? 32 : qlen / 48) + 16;
                nres = mc_fast_align(
                    enc, qlen, is_rev, c->matrix, win, slen,
                    d_end - margin, d_end + margin,
                    c->minscore, c->minscorlen,
                    c->gap_init, c->gap_ext, c->Wbuf, c->Hbuf, c->Ebuf,
                    c->dirm, c->dirm_cap, c->back, c->back_cap,
                    pool, half, c->ares, c->ares_cap);
                if (nres > 0 && c->ares[0] >= sc1) {
                    have = 1;
                    best[0] = c->ares[0]; best[1] = c->ares[1];
                    best[2] = c->ares[2]; best[3] = c->ares[3];
                    best[4] = c->ares[4]; best[5] = c->ares[6];
                    if (c->ares[5] != 0)
                        memmove(pool, pool + c->ares[5],
                                (size_t)c->ares[6]);
                }
            }
        }
        if (!have) {
        nres = mc_fast_align(enc, qlen, is_rev, c->matrix, win, slen,
                             center - 24 - drift, center + 48 + drift,
                             c->minscore, c->minscorlen,
                             c->gap_init, c->gap_ext,
                             c->Wbuf, c->Hbuf, c->Ebuf,
                             c->dirm, c->dirm_cap, c->back, c->back_cap,
                             pool, half, c->ares, c->ares_cap);
        if (nres > 0) {
            have = 1;
            best[0] = c->ares[0]; best[1] = c->ares[1];
            best[2] = c->ares[2]; best[3] = c->ares[3];
            best[4] = c->ares[4]; best[5] = c->ares[6];
            if (c->ares[5] != 0)
                memmove(pool, pool + c->ares[5], (size_t)c->ares[6]);
        }
        if (!have || best[0] < sc1) {
            int64_t nf = mc_fast_align(
                enc, qlen, is_rev, c->matrix, win, slen,
                -(slen - 1), qlen - 1, c->minscore, c->minscorlen,
                c->gap_init, c->gap_ext, c->Wbuf, c->Hbuf, c->Ebuf,
                c->dirm, c->dirm_cap, c->back, c->back_cap,
                pool + half, c->diff_cap - half, c->ares, c->ares_cap);
            if (nf > 0 && (!have || c->ares[0] > best[0])) {
                have = 1;
                best[0] = c->ares[0]; best[1] = c->ares[1];
                best[2] = c->ares[2]; best[3] = c->ares[3];
                best[4] = c->ares[4]; best[5] = c->ares[6];
                memmove(pool, pool + half + c->ares[5],
                        (size_t)c->ares[6]);
            }
        }
        }   /* !have (narrow-band anchor missed) */
    }
    if (!have)
        return 0;
    {
        int64_t g = w0 + best[3];
        int64_t s2 = fl_find_seqidx(c->offsets, c->nseq, g);
        r->mapped = 1;
        r->is_rev = is_rev;
        r->swatscor = best[0];
        if (is_rev) {
            r->q_start = qlen - best[2];
            r->q_end = qlen - best[1];
        } else {
            r->q_start = best[1] + 1;
            r->q_end = best[2] + 1;
        }
        r->s_start = g - c->offsets[s2] + 1;
        r->s_end = r->s_start + (best[4] - best[3]);
        r->sidx = s2;
        r->diff_len = best[5];
        r->diff = pool;
        r->mapscor = 0;
    }
    return 1;
}

/* FastTail.rescue_mate: full-band SW inside the anchor's insert
 * window on the opposite strand; mapq = min(own, anchor). */
static int ft_rescue(FTCtx *c, const uint8_t *enc, int64_t qlen,
                     const FTAli *anchor, int64_t insert_min,
                     int64_t insert_max, uint8_t *pool, FTAli *r)
{
    int64_t a_glob, lo, hi, c_lo, c_hi, nres;
    int is_rev;
    (void)insert_min;
    r->mapped = 0;
    if (qlen < 5)
        return 0;
    a_glob = c->offsets[anchor->sidx] + anchor->s_start - 1;
    if (anchor->is_rev) {
        lo = a_glob + (anchor->s_end - anchor->s_start) - insert_max;
        hi = a_glob + (anchor->s_end - anchor->s_start);
    } else {
        lo = a_glob;
        hi = a_glob + insert_max;
    }
    c_lo = c->offsets[anchor->sidx];
    c_hi = c->offsets[anchor->sidx + 1];
    lo = lo - qlen > c_lo ? lo - qlen : c_lo;
    hi = hi + qlen < c_hi ? hi + qlen : c_hi;
    if (hi - lo < qlen)
        return 0;
    is_rev = !anchor->is_rev;
    if (qlen < ALILEN_MIN)
        return 0;
    nres = mc_fast_align(enc, qlen, is_rev, c->matrix,
                         c->refcodes + lo, hi - lo,
                         -(hi - lo - 1), qlen - 1,
                         c->minscore, c->minscorlen,
                         c->gap_init, c->gap_ext,
                         c->Wbuf, c->Hbuf, c->Ebuf,
                         c->dirm, c->dirm_cap, c->back, c->back_cap,
                         pool, c->diff_cap, c->ares, c->ares_cap);
    if (nres <= 0)
        return 0;
    {
        int64_t g = lo + c->ares[3];
        int64_t s2 = fl_find_seqidx(c->offsets, c->nseq, g);
        int64_t own;
        r->mapped = 1;
        r->is_rev = is_rev;
        r->swatscor = c->ares[0];
        if (is_rev) {
            r->q_start = qlen - c->ares[2];
            r->q_end = qlen - c->ares[1];
        } else {
            r->q_start = c->ares[1] + 1;
            r->q_end = c->ares[2] + 1;
        }
        r->s_start = g - c->offsets[s2] + 1;
        r->s_end = r->s_start + (c->ares[4] - c->ares[3]);
        r->sidx = s2;
        r->diff_len = c->ares[6];
        if (c->ares[5] != 0)
            memmove(pool, pool + c->ares[5], (size_t)c->ares[6]);
        r->diff = pool;
        own = fl_fast_mapq(r->swatscor, 0, qlen, 0, 0, 1, 0);
        r->mapscor = own < anchor->mapscor ? own : anchor->mapscor;
    }
    return 1;
}

/* testProperPair (resultpairs.c:135-186 / results/pairs.py) */
#define FT_WITHIN 1
#define FT_PROPER 2
#define LIBC_PAIREDALL 0
#define LIBC_PAIREDEND 1
#define LIBC_MATEPAIR 2
#define LIBC_SAMESTRAND 3

static int ft_proper(int64_t isize, int revA, int revB, int leftmost2,
                     int64_t dmin, int64_t dmax, int libcode)
{
    int m = 0;
    if (isize < 0) {
        if (-dmax <= isize && isize <= -dmin) m |= FT_WITHIN;
        if (libcode == LIBC_PAIREDALL) m |= FT_PROPER;
        else if (libcode == LIBC_PAIREDEND) {
            if (revA && !revB && leftmost2) m |= FT_PROPER;
        } else if (libcode == LIBC_MATEPAIR) {
            if (!revA && revB && leftmost2) m |= FT_PROPER;
        } else if (libcode == LIBC_SAMESTRAND) {
            if (revA && revB && leftmost2) m |= FT_PROPER;
        }
    } else {
        if (dmin <= isize && isize <= dmax) m |= FT_WITHIN;
        if (libcode == LIBC_PAIREDALL) m |= FT_PROPER;
        else if (libcode == LIBC_PAIREDEND) {
            if (!revA && revB && !leftmost2) m |= FT_PROPER;
        } else if (libcode == LIBC_MATEPAIR) {
            if (revA && !revB && !leftmost2) m |= FT_PROPER;
        } else if (libcode == LIBC_SAMESTRAND) {
            if (!revA && !revB && !leftmost2) m |= FT_PROPER;
        }
    }
    return m;
}

/* FastTail._pair_elevate incl. the -g insert-histogram weighting:
 * hist_cum = per-bin cumulative counts (insert.py count_cumulative),
 * NULL for the flat no-histogram model. */
static void ft_elevate(FTAli *r, const FTAli *other, int64_t n2,
                       int64_t isiz,
                       const int64_t *hist_cum, int64_t hist_span,
                       int64_t hist_lo, int64_t hist_hi,
                       int64_t hist_scal, int64_t hist_num)
{
    double p_prop, p_in, p_allout, marg;
    int64_t elev, cap;
    if (r->mapscor > MAPSCOR_MAX_RANDOM ||
        other->mapscor <= MAPSCOR_MAX_RANDOM)
        return;
    p_prop = 1.0 - 1e-4;                 /* CUMULPROB_IMPROPER */
    p_in = p_prop * (1.0 - 3e-3);        /* CUMULPROB_PROPER_OUTSIDE */
    p_allout = 1e-4 + p_prop * 3e-3;
    if (hist_cum != NULL && hist_num > 0) {
        int64_t x = isiz < 0 ? -isiz : isiz, cc = 0;
        if (hist_lo <= x && x <= hist_hi) {
            int64_t ix = (x - hist_lo) / (hist_scal > 0 ? hist_scal : 1);
            if (ix > hist_span - 1) ix = hist_span - 1;
            cc = hist_cum[ix];
        }
        {
            double pp = (double)cc / (double)hist_num;
            double iab = p_prop;
            if (pp >= 0.5) iab = 0.5 - pp / 2.0;
            p_in = iab * (pp * (1.0 - 3e-3) + 3e-3);
        }
    }
    if (n2 < 1) n2 = 1;
    marg = p_in / (p_in + (double)n2 * p_allout);
    if (marg >= 1.0)
        elev = MAPSCOR_MAX;
    else
        elev = (int64_t)(-10.0 * log(1.0 - marg) / FL_LOG10);
    cap = other->mapscor < MAPSCOR_MAX ? other->mapscor : MAPSCOR_MAX;
    if (elev > cap) elev = cap;
    if (elev > r->mapscor) r->mapscor = elev;
}

/* paired _write_sam line (report.py:281-358) */
static int ft_sam_line_pair(FLText *t,
                            const char *name, int64_t name_len,
                            const uint8_t *codes, const uint8_t *qual,
                            int64_t qlen,
                            const FTAli *r, const FTAli *mp,
                            int is_mate2, int64_t isizeA, int proper,
                            const char *const *seq_name_ptr,
                            const int64_t *seq_name_len,
                            int soft_clip, int x_mismatch)
{
    int samflg = 0x0001 | (is_mate2 ? 0x0080 : 0x0040);
    int64_t pos = 0, mpos = 0, isize = isizeA, i;
    int mate_mapped = mp != NULL && mp->mapped;

    if (is_mate2) isize = -isize;
    if (mate_mapped) {
        mpos = mp->s_start;
        if (mp->is_rev) samflg |= 0x0020;         /* MATESTRAND */
    } else {
        samflg |= 0x0008;                          /* MATENOMAP */
        isize = 0;
        mpos = 0;
    }
    if (!r->mapped) {
        samflg |= SAMFLAG_NOMAP;
        isize = 0;
    } else {
        if (r->is_rev) samflg |= SAMFLAG_STRAND;
        pos = r->s_start;
        if (proper) samflg |= 0x0002;
    }
    tx_putn(t, name, name_len);
    tx_putc(t, '\t');
    tx_puti(t, samflg);
    tx_putc(t, '\t');
    if (r->mapped)
        tx_putn(t, seq_name_ptr[r->sidx], seq_name_len[r->sidx]);
    else
        tx_putc(t, '*');
    tx_putc(t, '\t');
    tx_puti(t, pos);
    tx_putc(t, '\t');
    tx_puti(t, r->mapped ? r->mapscor : 0);
    tx_putc(t, '\t');
    if (r->mapped) {
        int64_t clip_start, clip_end;
        int rc2;
        if (r->is_rev) {
            clip_start = qlen - r->q_end;
            clip_end = r->q_start - 1;
        } else {
            clip_start = r->q_start - 1;
            clip_end = qlen - r->q_end;
        }
        rc2 = tx_cigar(t, r->diff, (int)r->diff_len, !x_mismatch,
                       clip_start, clip_end, soft_clip);
        if (rc2 != 0) return rc2;
        tx_putc(t, '\t');
    } else {
        tx_puts(t, "*\t");
    }
    if (mate_mapped)
        tx_putn(t, seq_name_ptr[mp->sidx], seq_name_len[mp->sidx]);
    else
        tx_putc(t, '*');
    tx_putc(t, '\t');
    tx_puti(t, mpos);
    tx_putc(t, '\t');
    tx_puti(t, isize);
    tx_putc(t, '\t');
    if (r->mapped) {
        int64_t q0, q1;
        if (soft_clip) { q0 = 0; q1 = qlen; }
        else { q0 = r->q_start - 1; q1 = r->q_end; }
        if (q1 > q0) {
            if (r->is_rev)
                for (i = q1 - 1; i >= q0; i--)
                    tx_putc(t, fl_decode1_comp(codes[i]));
            else
                for (i = q0; i < q1; i++)
                    tx_putc(t, fl_decode1(codes[i]));
        } else {
            tx_putc(t, '*');
        }
        tx_putc(t, '\t');
        if (qual && q1 > q0) {
            if (r->is_rev)
                for (i = q1 - 1; i >= q0; i--) tx_putc(t, (char)qual[i]);
            else
                for (i = q0; i < q1; i++) tx_putc(t, (char)qual[i]);
        } else {
            tx_putc(t, '*');
        }
        tx_puts(t, "\tNM:i:");
        tx_puti(t, fl_levenshtein(r->diff, (int)r->diff_len));
        tx_puts(t, "\tAS:i:");
        tx_puti(t, r->swatscor);
    } else {
        if (soft_clip) {
            for (i = 0; i < qlen; i++) tx_putc(t, fl_decode1(codes[i]));
            tx_putc(t, '\t');
            if (qual) for (i = 0; i < qlen; i++) tx_putc(t, (char)qual[i]);
            else tx_putc(t, '*');
        } else {
            tx_puts(t, "*\t*");
        }
        tx_puts(t, "\tNM:i:0\tAS:i:0");
    }
    tx_putc(t, '\n');
    return 0;
}

/* Render a whole PE batch (reads laid out A-block then B-block). */
int64_t fl_fast_tail_pairs(
    const uint8_t *refcodes, const int64_t *offsets, int64_t nseq,
    const char *snames, const int64_t *sname_offs,
    const int32_t *matrix, int gap_init, int gap_ext,
    int64_t match_avg, int64_t minscor,
    int soft_clip, int x_mismatch,
    int64_t win_len, int64_t pad, int64_t q_padded,
    int64_t insert_min, int64_t insert_max, int libcode,
    int64_t n_reads, const uint8_t *seqs_buf, const int64_t *seq_off,
    const int64_t *seq_len,
    const uint8_t *quals_buf, const int64_t *qual_off,
    const uint8_t *has_qual,
    const char *names_buf, const int64_t *name_off,
    const int64_t *name_len_in,
    const int32_t *score, const int32_t *score2, const int32_t *wstart,
    const int32_t *strand, const int32_t *hits_used,
    const int32_t *hits_tot, const int32_t *n2nd, const int32_t *ambig,
    const int32_t *tb_i, const int32_t *tb_j,
    /* -g histogram (NULL = flat model) */
    const int64_t *hist_cum, int64_t hist_span, int64_t hist_lo,
    int64_t hist_hi, int64_t hist_scal, int64_t hist_num,
    /* pairs rendered elsewhere (exact fallback) + per-pair extents */
    const uint8_t *skip, int64_t *pair_offs,
    char *out_text, int64_t out_cap)
{
    FLText t;
    FTCtx c;
    const char **seq_name_ptr = NULL;
    int64_t *seq_name_len = NULL;
    uint8_t *encA = NULL, *encB = NULL, *poolA = NULL, *poolB = NULL;
    int64_t B = n_reads / 2, qmax = 1, i, rc = 0;

    c.refcodes = refcodes; c.offsets = offsets; c.nseq = nseq;
    c.total_len = offsets[nseq];
    c.matrix = matrix; c.gap_init = gap_init; c.gap_ext = gap_ext;
    c.minscor = minscor;
    c.minscore = minscor > 1 ? minscor : 1;
    c.minscorlen = ALILEN_MIN;
    if (ALILEN_MIN * match_avg < c.minscore)
        c.minscorlen = c.minscore / match_avg;
    c.win_len = win_len; c.pad = pad; c.q_padded = q_padded;
    for (i = 0; i < n_reads; i++) {
        if (seq_len[i] > qmax) qmax = seq_len[i];
    }
    {
        /* rescue windows reach insert_max + 2*qmax wide */
        int64_t wmax = win_len > insert_max + 2 * qmax
                       ? win_len : insert_max + 2 * qmax;
        c.dirm_cap = (qmax + wmax + 2) * (wmax + 1);
        c.back_cap = 2 * (qmax + wmax) + 8;
        c.diff_cap = 4 * (qmax + wmax) + 1024;
        c.ares_cap = wmax / ALILEN_MIN + 4;
        c.Wbuf = (int32_t *)fl_alloc(8 * qmax * (int64_t)sizeof(int32_t));
        c.Hbuf = (int32_t *)fl_alloc((qmax + 1) * (int64_t)sizeof(int32_t));
        c.Ebuf = (int32_t *)fl_alloc((qmax + 1) * (int64_t)sizeof(int32_t));
        c.dirm = (uint8_t *)fl_alloc(c.dirm_cap);
        c.back = (uint8_t *)fl_alloc(c.back_cap);
        c.ares = (int64_t *)fl_alloc(c.ares_cap * 7
                                     * (int64_t)sizeof(int64_t));
    }
    seq_name_ptr = (const char **)fl_alloc(nseq * (int64_t)sizeof(char *));
    seq_name_len = (int64_t *)fl_alloc(nseq * (int64_t)sizeof(int64_t));
    encA = (uint8_t *)fl_alloc(qmax);
    encB = (uint8_t *)fl_alloc(qmax);
    poolA = (uint8_t *)fl_alloc(c.diff_cap);
    poolB = (uint8_t *)fl_alloc(c.diff_cap);
    if (!seq_name_ptr || !seq_name_len || !encA || !encB || !poolA ||
        !poolB || !c.Wbuf || !c.Hbuf || !c.Ebuf || !c.dirm || !c.back ||
        !c.ares) {
        rc = FL_ERR_CAP;
        goto done;
    }
    for (i = 0; i < nseq; i++) {
        seq_name_ptr[i] = snames + sname_offs[i];
        seq_name_len[i] = sname_offs[i + 1] - sname_offs[i];
    }
    fl_codtab_init();
    t.p = out_text;
    t.end = out_text + out_cap;
    t.overflow = 0;

    for (i = 0; i < B; i++) {
        int64_t ia = i, ib = B + i, j;
        int64_t qlA = seq_len[ia];
        int64_t qlB = seq_len[ib];
        const uint8_t *asciiA = seqs_buf + seq_off[ia];
        const uint8_t *asciiB = seqs_buf + seq_off[ib];
        const uint8_t *qualA = has_qual[ia]
                               ? quals_buf + qual_off[ia] : NULL;
        const uint8_t *qualB = has_qual[ib]
                               ? quals_buf + qual_off[ib] : NULL;
        const char *nameA = names_buf + name_off[ia];
        int64_t nlenA = fl_sam_name_len(nameA, name_len_in[ia]);
        const char *nameB = names_buf + name_off[ib];
        int64_t nlenB = fl_sam_name_len(nameB, name_len_in[ib]);
        FTAli A, Bm;
        int okA, okB, proper = 0;
        int64_t isizeA = 0;

        if (pair_offs) pair_offs[i] = t.p - out_text;
        if (skip && skip[i])
            continue;
        for (j = 0; j < qlA; j++) encA[j] = fl_codtab[asciiA[j]];
        for (j = 0; j < qlB; j++) encB[j] = fl_codtab[asciiB[j]];
        okA = ft_map_one(&c, encA, qlA, score[ia], strand[ia] != 0,
                         wstart[ia], tb_i ? tb_i[ia] : -1,
                         tb_j ? tb_j[ia] : -1, poolA, &A);
        if (okA)
            A.mapscor = fl_fast_mapq(score[ia], score2[ia], qlA,
                                     hits_used[ia], hits_tot[ia],
                                     n2nd[ia], ambig[ia] != 0);
        okB = ft_map_one(&c, encB, qlB, score[ib], strand[ib] != 0,
                         wstart[ib], tb_i ? tb_i[ib] : -1,
                         tb_j ? tb_j[ib] : -1, poolB, &Bm);
        if (okB)
            Bm.mapscor = fl_fast_mapq(score[ib], score2[ib], qlB,
                                      hits_used[ib], hits_tot[ib],
                                      n2nd[ib], ambig[ib] != 0);
        if (!okA && okB)
            okA = ft_rescue(&c, encA, qlA, &Bm, insert_min, insert_max,
                            poolA, &A);
        else if (!okB && okA)
            okB = ft_rescue(&c, encB, qlB, &A, insert_min, insert_max,
                            poolB, &Bm);
        if (okA && okB && A.sidx == Bm.sidx) {
            /* _pair_geometry: SAM-spec TLEN + testProperPair */
            int64_t rA = A.s_start < Bm.s_start ? A.s_start : Bm.s_start;
            int64_t rB = A.s_end > Bm.s_end ? A.s_end : Bm.s_end;
            int leftmost2 = Bm.s_start < A.s_start;
            int m;
            isizeA = rB - rA + 1;
            if (leftmost2) isizeA = -isizeA;
            m = ft_proper(isizeA, A.is_rev, Bm.is_rev, leftmost2,
                          insert_min, insert_max, libcode);
            proper = (m & FT_PROPER) && (m & FT_WITHIN);
            if (proper) {
                ft_elevate(&A, &Bm, n2nd[ia], isizeA,
                           hist_cum, hist_span, hist_lo, hist_hi,
                           hist_scal, hist_num);
                ft_elevate(&Bm, &A, n2nd[ib], isizeA,
                           hist_cum, hist_span, hist_lo, hist_hi,
                           hist_scal, hist_num);
            }
        }
        if (!okA) A.mapped = 0;
        if (!okB) Bm.mapped = 0;
        rc = ft_sam_line_pair(&t, nameA, nlenA, encA, qualA, qlA,
                              &A, &Bm, 0, isizeA, proper,
                              seq_name_ptr, seq_name_len,
                              soft_clip, x_mismatch);
        if (rc != 0) goto done;
        rc = ft_sam_line_pair(&t, nameB, nlenB, encB, qualB, qlB,
                              &Bm, &A, 1, isizeA, proper,
                              seq_name_ptr, seq_name_len,
                              soft_clip, x_mismatch);
        if (rc != 0) goto done;
        if (t.overflow) { rc = FL_ERR_TEXT; goto done; }
    }
    if (pair_offs) pair_offs[B] = t.p - out_text;

done:
    free((void *)seq_name_ptr); free(seq_name_len);
    free(encA); free(encB); free(poolA); free(poolB);
    free(c.Wbuf); free(c.Hbuf); free(c.Ebuf);
    free(c.dirm); free(c.back); free(c.ares);
    if (rc != 0) return rc;
    return t.p - out_text;
}
