/* Host-side Smith-Waterman kernels.
 *
 * Semantics (NOT code) follow the reference engine: the exact lane's
 * golden byte-parity depends on three OBSERVABLE quirks of its banded
 * affine recurrence (alignment.c:788-1240):
 *   (1) the gap states E (gap in the subject column) and F (gap along
 *       the row) are re-seeded from H only on STRICT diagonal wins
 *       with H > gap_init, and decay by gap_ext each step while
 *       positive;
 *   (2) the running maximum is recorded only at such diagonal wins;
 *   (3) the score-only pass-1 walk (alignSmiWatBandFast,
 *       alignment.c:1219) never advances the LEFT band edge when the
 *       band enters left of the query segment (q_left > l_edge): its
 *       delta_band_start is tested but never decremented — unlike the
 *       tracked pass-2 walk (alignment.c:1006, `dirp += --delta...`) —
 *       so the computed region is a left-pinned triangle, not a
 *       sliding band, and pass-1 can score alignments far off the
 *       nominal diagonals.  Load-bearing for max1/max2 dynamics and
 *       for -m thresholds below the default.
 * Within those constraints the cell update here is our own flat
 * max-then-refresh formulation (sw_cell below), not the reference's
 * nested branch tree; equivalence is enforced by the differential
 * kernel tests (tests/test_sw_simd.py, tests/test_align.py) and the
 * golden SAM corpus.
 *
 *   sw_band_fast : banded score-only pass
 *   sw_band_track: banded pass + direction matrix for traceback
 *   sw_full      : full-matrix affine local SW (scalar + SSE2 striped)
 *   nr_sort2*    : see the provenance note at the sort section
 *
 * Compiled at first import by smalt_tpu/native/__init__.py (cc -O2 -shared).
 */
#include <stdint.h>
#include <string.h>

#define COD_COL 1
#define COD_ROW 2
#define COD_DIA 3

/* W: profile rows, 8 x qlen int32 (row a = scores of subject code a vs query) */
static inline const int32_t *rowscore(const int32_t *W, int qlen, uint8_t a)
{
    return W + (int)(a & 7) * qlen;
}

/* One banded cell, flat form:
 *   cell = max(diag, e, f, 0); e/f decay by gap_ext while positive;
 *   quirk (1): iff the diagonal STRICTLY beat e, f and 0, and exceeds
 *   gap_init, both gap states rise to at least diag - gap_init.
 * *dia_won reports the strict diagonal win (drives quirk (2) and the
 * traceback direction code). */
static inline int32_t sw_cell(int32_t diag, int32_t *e_io, int32_t *f_io,
                              int gap_init, int gap_ext, int *dia_won)
{
    int32_t e = *e_io, f = *f_io;
    int32_t cell = diag > 0 ? diag : 0;
    int won = diag > 0 && diag > e && diag > f;
    if (e > cell) cell = e;
    if (f > cell) cell = f;
    if (e > 0) e -= gap_ext;
    if (f > 0) f -= gap_ext;
    if (won && diag > gap_init) {
        int32_t reseed = diag - gap_init;
        if (e < reseed) e = reseed;
        if (f < reseed) f = reseed;
    }
    *e_io = e;
    *f_io = f;
    *dia_won = won;
    return cell;
}

int sw_band_fast(const int32_t *W, int qlen_prof,
                 const uint8_t *subj,
                 int l_edge, int r_edge, int q_left, int q_len,
                 int s_left, int s_len,
                 int gap_init, int gap_ext,
                 int32_t *Hbuf, int32_t *Ebuf)
{
    /* Quirk (3) above: when the band enters left of the query segment
     * (q_left > l_edge) the left edge NEVER advances — the reference's
     * score-only walk tests its lead-row counter but does not consume
     * it, so [band_lo, band_hi) only grows on the right.  Only when
     * the band starts at or right of q_left does the window slide. */
    int lead_pinned, band_lo, band_hi;
    int i, j, best = 0;
    int32_t diag_carry;
    int32_t *Hrow = Hbuf, *Erow = Ebuf;

    if (q_left > l_edge) {
        lead_pinned = 1;
        band_lo = q_left;
    } else {
        lead_pinned = 0;
        band_lo = l_edge;
    }
    band_hi = r_edge + 1;
    diag_carry = 0;
    for (j = band_lo; j < q_len; j++) Hrow[j] = Erow[j] = 0;

    for (i = s_left; i < s_len; i++) {
        const int32_t *rs = rowscore(W, qlen_prof, subj[i]);
        int32_t open_row = 0;        /* F: gap running along the row */
        for (j = band_lo; j < band_hi; j++) {
            int won;
            int32_t diag = diag_carry + rs[j];
            diag_carry = Hrow[j];
            Hrow[j] = sw_cell(diag, &Erow[j], &open_row,
                              gap_init, gap_ext, &won);
            if (won && diag > gap_init && diag > best)
                best = diag;
        }
        if (lead_pinned) { diag_carry = 0; }
        else { diag_carry = Hrow[band_lo]; band_lo++; }
        if (band_hi < q_len) band_hi++;
    }
    return best;
}

int sw_band_track(const int32_t *W, int qlen_prof,
                  const uint8_t *subj,
                  int l_edge, int r_edge, int q_left, int q_len,
                  int s_left, int s_len,
                  int gap_init, int gap_ext,
                  int band_width,
                  uint8_t *dir, /* band_width * (s_len - s_left), zeroed */
                  int *max_i_out, int *max_j_out,
                  int32_t *Hbuf, int32_t *Ebuf)
{
    /* Sliding band walk plus a direction matrix laid out
     * band_width-wide per subject row; UNLIKE sw_band_fast, the lead
     * rows are consumed so the left edge starts sliding once the band
     * reaches q_left (the reference's tracked walk decrements its
     * counter, alignment.c:1006); trail_cols grows once the right
     * band edge hits the query end (the parallelogram's trailing
     * wedge), mirroring the row-stride walk of the write pointer. */
    int lead_rows, trail_cols = 0, band_lo, band_hi;
    int i, j, max_i = 0, max_j = 0, best = 0;
    int32_t diag_carry;
    int32_t *Hrow = Hbuf, *Erow = Ebuf;
    uint8_t *dp;

    if (q_left > l_edge) {
        lead_rows = q_left - l_edge;
        band_lo = q_left;
    } else {
        lead_rows = 0;
        band_lo = l_edge;
    }
    band_hi = r_edge + 1;
    diag_carry = 0;
    dp = dir + lead_rows;
    for (j = band_lo; j < q_len; j++) Hrow[j] = Erow[j] = 0;

    for (i = s_left; i < s_len; i++) {
        const int32_t *rs = rowscore(W, qlen_prof, subj[i]);
        int32_t open_row = 0;
        for (j = band_lo; j < band_hi; j++, dp++) {
            int won;
            int32_t diag = diag_carry + rs[j];
            int32_t e_before = Erow[j], f_before = open_row;
            int32_t cell;
            diag_carry = Hrow[j];
            cell = sw_cell(diag, &Erow[j], &open_row,
                           gap_init, gap_ext, &won);
            Hrow[j] = cell;
            if (won) {
                *dp = COD_DIA;
                if (diag > gap_init && diag > best) {
                    best = diag;
                    max_i = i;
                    max_j = j;
                }
            } else if (cell > 0) {
                /* gap move; on equal gap states the reference prefers
                 * the subject gap (column) */
                *dp = (e_before >= f_before) ? COD_COL : COD_ROW;
            } else {
                *dp = 0;
            }
        }
        if (lead_rows > 0) {
            diag_carry = 0;
            dp += --lead_rows;
        } else {
            diag_carry = Hrow[band_lo];
            band_lo++;
        }
        if (band_hi < q_len) band_hi++;
        else dp += trail_cols++;
    }
    *max_i_out = max_i;
    *max_j_out = max_j;
    return best;
}

/* Device-canonical standard-affine local DP: the EXACT recurrence of
 * the TPU kernel (smalt_tpu/ops/sw.py _sw_kernel):
 *     T  = H[i-1][j-1] + W[subj_i][q_j]
 *     H0 = max(T, E, 0)
 *     F[j] = max(F[j-1] - ge, H0[j-1] - go)        (H0-anchored)
 *     H  = max(H0, F)
 *     E' = max(E - ge, H - go)                     (unconditional)
 * Tracks the row-major-FIRST argmax of T (strict-greater updates, the
 * same cell the device kernel's track mode reports) and writes one
 * state byte per cell for the exact-cost walker (mc_dev_walk):
 *     b0-1  dir of H   (0 none, 1 E/COL, 2 F/ROW, 3 T/DIA)
 *     b2    E' opened from H - go (else chained E - ge)
 *     b3    F  opened from H0[j-1] - go (else chained F[j-1] - ge)
 *     b4-5  dir of H0  (0 none, 1 E/COL, 3 T/DIA)
 * Ties prefer DIA over COL over ROW (the gapless-shortcut contract:
 * a run whose sum equals the DP max is walked diagonally).
 * dirm: slen rows x qlen cols.  Hbuf/Ebuf: qlen int32 scratch.
 * Returns the clamped best (>= 0). */
int sw_dev_track(const int32_t *W, int qlen, const uint8_t *subj, int slen,
                 int gap_init, int gap_ext,
                 uint8_t *dirm, int *max_i_out, int *max_j_out,
                 int32_t *Hbuf, int32_t *Ebuf)
{
    const int32_t NEGI = -(1 << 28);
    int32_t best = 0;
    int i, j, bi = 0, bj = 0;
    for (j = 0; j < qlen; j++) { Hbuf[j] = 0; Ebuf[j] = 0; }
    for (i = 0; i < slen; i++) {
        const int32_t *rs = rowscore(W, qlen, subj[i]);
        int32_t Hdiag = 0;            /* H[i-1][-1] == 0 */
        int32_t F = NEGI;
        int32_t H0prev = NEGI;
        uint8_t *dp = dirm + (int64_t)i * qlen;
        for (j = 0; j < qlen; j++) {
            int32_t E = Ebuf[j];
            int32_t T = Hdiag + rs[j];
            int32_t H0, Hn, En;
            uint8_t d0 = 0, dn, eo, fo = 0;
            if (j > 0) {
                int32_t fopen = H0prev - gap_init;
                int32_t fchain = F - gap_ext;
                fo = fopen >= fchain;
                F = fo ? fopen : fchain;
            } else {
                F = NEGI;
            }
            H0 = 0;
            if (T > 0) { H0 = T; d0 = 3; }
            if (E > H0) { H0 = E; d0 = 1; }
            Hn = H0; dn = d0;
            if (F > Hn) { Hn = F; dn = 2; }
            if (T > best) { best = T; bi = i; bj = j; }
            En = E - gap_ext;
            {
                int32_t eopen = Hn - gap_init;
                eo = eopen >= En;
                if (eo) En = eopen;
            }
            dp[j] = (uint8_t)(dn | (eo << 2) | (fo << 3) | (d0 << 4));
            Hdiag = Hbuf[j];
            Hbuf[j] = Hn;
            Ebuf[j] = En;
            H0prev = H0;
        }
    }
    *max_i_out = bi;
    *max_j_out = bj;
    return best > 0 ? best : 0;
}

/* Full-matrix affine local SW, score only (mathematically equal to the
 * Farrar striped kernels in swsimd.c: both gaps open from the cell
 * maximum; running max over diagonal H' = Hdiag + W). */
static int sw_full_scalar(const int32_t *W, int qlen,
                          const uint8_t *subj, int slen,
                          int gap_init, int gap_ext,
                          int32_t *Hbuf, int32_t *Ebuf)
{
    int i, j, max_scor = 0;
    int32_t *Hp = Hbuf, *Ep = Ebuf;
    for (j = 0; j < qlen; j++) { Hp[j] = 0; Ep[j] = 0; }
    for (i = 0; i < slen; i++) {
        const int32_t *rs = rowscore(W, qlen, subj[i]);
        int32_t F = 0, Hdiag = 0;
        for (j = 0; j < qlen; j++) {
            int32_t Hprime = Hdiag + rs[j];
            if (Hprime > max_scor) max_scor = Hprime;
            int32_t H = Hprime;
            if (Ep[j] > H) H = Ep[j];
            if (F > H) H = F;
            if (H < 0) H = 0;
            Hdiag = Hp[j];
            Hp[j] = H;
            int32_t hg = H - gap_init;
            Ep[j] = (Ep[j] - gap_ext > hg) ? Ep[j] - gap_ext : hg;
            F = (F - gap_ext > hg) ? F - gap_ext : hg;
        }
    }
    return max_scor;
}

#ifdef __SSE2__
#include <emmintrin.h>
#include <stdlib.h>

/* Striped Smith-Waterman, score only, 8 x int16 lanes (Farrar 2007,
 * the algorithm the reference also builds on, swsimd.c:443-660).
 * Computes the same maximum as sw_full_scalar: the global optimum of
 * a local alignment always ends on a diagonal move, so the max over
 * diagonal-extended values equals the max over corrected H.
 * Returns -1 when the int16 range may have saturated (caller falls
 * back to the scalar kernel).  Query positions beyond qlen are padded
 * with -32768 so their H clamps to <= F < max and never contributes. */
/* Striped SW, score only, 16 x uint8 lanes with bias (Farrar 2007's
 * 8-bit variant, the reference's first-try kernel swsimd.c:207-441).
 * Twice the lanes of the 16-bit kernel; short reads (score < 255 -
 * bias) never saturate.  Returns -1 when the profile range, the gap
 * shape (needs gap_init >= gap_ext so lazy-F needs no re-open), or
 * saturation rules it out -- caller falls through to 16-bit/scalar. */
static int sw_full_sse2_8(const int32_t *W, int qlen,
                          const uint8_t *subj, int slen,
                          int gap_init, int gap_ext)
{
    const int seglen = (qlen + 15) / 16;
    const int nvec = seglen * 16;
    int i, j, a, lane, bias = 0, best;
    uint8_t *mem;
    if (gap_ext > gap_init || gap_init > 127)
        return -1;
    for (j = 0; j < 8 * qlen; j++) {
        if (W[j] > 100 || W[j] < -100) return -1;
        if (-W[j] > bias) bias = -W[j];
    }
    mem = (uint8_t *)malloc((size_t)8 * nvec + 3 * nvec + 32);
    if (!mem) return -1;
    {
    uint8_t *base = (uint8_t *)(((uintptr_t)mem + 15) & ~(uintptr_t)15);
    uint8_t *prof = base;
    __m128i *vprof = (__m128i *)prof;
    __m128i *vHStore = (__m128i *)(prof + 8 * nvec);
    __m128i *vHLoad = vHStore + seglen;
    __m128i *vE = vHLoad + seglen;
    __m128i vzero = _mm_setzero_si128();
    __m128i vBias = _mm_set1_epi8((char)(uint8_t)bias);
    __m128i vGapI = _mm_set1_epi8((char)(uint8_t)gap_init);
    __m128i vGapE = _mm_set1_epi8((char)(uint8_t)gap_ext);
    __m128i vMax = vzero;

    for (a = 0; a < 8; a++) {
        const int32_t *rs = W + a * qlen;
        uint8_t *pp = prof + (size_t)a * nvec;
        for (j = 0; j < seglen; j++)
            for (lane = 0; lane < 16; lane++) {
                int q = j + lane * seglen;
                /* pad lanes get 0 (= score -bias): can never raise the
                 * diagonal max above a real cell */
                pp[j * 16 + lane] =
                    (q < qlen) ? (uint8_t)(rs[q] + bias) : 0;
            }
    }
    for (j = 0; j < seglen; j++) {
        vHStore[j] = vzero;
        vHLoad[j] = vzero;
        vE[j] = vzero;
    }
    for (i = 0; i < slen; i++) {
        const __m128i *vP = vprof + (size_t)(subj[i] & 7) * seglen;
        __m128i vF = vzero;
        __m128i vH = _mm_slli_si128(vHStore[seglen - 1], 1);
        __m128i *tmp = vHLoad; vHLoad = vHStore; vHStore = tmp;
        for (j = 0; j < seglen; j++) {
            __m128i e = vE[j];
            vH = _mm_subs_epu8(_mm_adds_epu8(vH, vP[j]), vBias);
            vMax = _mm_max_epu8(vMax, vH);    /* diagonal-extended max */
            vH = _mm_max_epu8(vH, e);
            vH = _mm_max_epu8(vH, vF);
            vHStore[j] = vH;
            {
                __m128i hg = _mm_subs_epu8(vH, vGapI);
                vE[j] = _mm_max_epu8(_mm_subs_epu8(e, vGapE), hg);
                vF = _mm_max_epu8(_mm_subs_epu8(vF, vGapE), hg);
            }
            vH = vHLoad[j];
        }
        /* lazy-F (unsigned): shifted-in lane-0 byte is 0, and the
         * dominance test vF > H - gap_init is exact in epu8 because
         * H - gap_init clamps at 0, so a zero F never keeps the loop
         * alive; with gap_init >= gap_ext no re-open is needed and vF
         * strictly decays. */
        vF = _mm_slli_si128(vF, 1);
        j = 0;
        for (;;) {
            __m128i h = vHStore[j];
            __m128i hg = _mm_subs_epu8(h, vGapI);
            __m128i excess = _mm_subs_epu8(vF, hg);
            if (_mm_movemask_epi8(_mm_cmpeq_epi8(excess, vzero)) == 0xFFFF)
                break;
            h = _mm_max_epu8(h, vF);
            vHStore[j] = h;
            vE[j] = _mm_max_epu8(vE[j], _mm_subs_epu8(h, vGapI));
            vF = _mm_subs_epu8(vF, vGapE);
            if (++j >= seglen) {
                j = 0;
                vF = _mm_slli_si128(vF, 1);
            }
        }
    }
    best = 0;
    {
        uint8_t out[16];
        _mm_storeu_si128((__m128i *)out, vMax);
        for (lane = 0; lane < 16; lane++)
            if (out[lane] > best) best = out[lane];
    }
    free(mem);
    if (best >= 255 - bias)
        return -1;                  /* possible saturation: retry wider */
    return best;
    }
}

#if defined(__AVX512BW__)
#include <immintrin.h>

/* 512-bit whole-register byte shift left by one (the 64-lane analog of
 * _mm_slli_si128(v, 1)): 128-bit lanes shift with a carry byte from
 * the previous lane, lane 0 shifts in zero. */
static inline __m512i sw8_shl1(__m512i v)
{
    __m512i t = _mm512_maskz_shuffle_i32x4((__mmask16)0xFFF0, v, v,
                                           _MM_SHUFFLE(2, 1, 0, 0));
    return _mm512_alignr_epi8(v, t, 15);
}

/* The 8-bit striped kernel at 64 uint8 lanes (AVX-512BW build of the
 * same Farrar recurrence as sw_full_sse2_8 — identical maxima,
 * identical -1 refusal conditions, 4x the lanes). */
static int sw_full_avx512_8(const int32_t *W, int qlen,
                            const uint8_t *subj, int slen,
                            int gap_init, int gap_ext)
{
    const int seglen = (qlen + 63) / 64;
    const int nvec = seglen * 64;
    int i, j, a, lane, bias = 0, best;
    uint8_t *mem;
    if (gap_ext > gap_init || gap_init > 127)
        return -1;
    for (j = 0; j < 8 * qlen; j++) {
        if (W[j] > 100 || W[j] < -100) return -1;
        if (-W[j] > bias) bias = -W[j];
    }
    mem = (uint8_t *)malloc((size_t)8 * nvec + 3 * nvec + 128);
    if (!mem) return -1;
    {
    uint8_t *base = (uint8_t *)(((uintptr_t)mem + 63) & ~(uintptr_t)63);
    uint8_t *prof = base;
    __m512i *vprof = (__m512i *)prof;
    __m512i *vHStore = (__m512i *)(prof + 8 * nvec);
    __m512i *vHLoad = vHStore + seglen;
    __m512i *vE = vHLoad + seglen;
    __m512i vzero = _mm512_setzero_si512();
    __m512i vBias = _mm512_set1_epi8((char)(uint8_t)bias);
    __m512i vGapI = _mm512_set1_epi8((char)(uint8_t)gap_init);
    __m512i vGapE = _mm512_set1_epi8((char)(uint8_t)gap_ext);
    __m512i vMax = vzero;

    for (a = 0; a < 8; a++) {
        const int32_t *rs = W + a * qlen;
        uint8_t *pp = prof + (size_t)a * nvec;
        for (j = 0; j < seglen; j++)
            for (lane = 0; lane < 64; lane++) {
                int q = j + lane * seglen;
                pp[j * 64 + lane] =
                    (q < qlen) ? (uint8_t)(rs[q] + bias) : 0;
            }
    }
    for (j = 0; j < seglen; j++) {
        vHStore[j] = vzero;
        vHLoad[j] = vzero;
        vE[j] = vzero;
    }
    for (i = 0; i < slen; i++) {
        const __m512i *vP = vprof + (size_t)(subj[i] & 7) * seglen;
        __m512i vF = vzero;
        __m512i vH = sw8_shl1(vHStore[seglen - 1]);
        __m512i *tmp = vHLoad; vHLoad = vHStore; vHStore = tmp;
        for (j = 0; j < seglen; j++) {
            __m512i e = vE[j];
            vH = _mm512_subs_epu8(_mm512_adds_epu8(vH, vP[j]), vBias);
            vMax = _mm512_max_epu8(vMax, vH);  /* diagonal-extended max */
            vH = _mm512_max_epu8(vH, e);
            vH = _mm512_max_epu8(vH, vF);
            vHStore[j] = vH;
            {
                __m512i hg = _mm512_subs_epu8(vH, vGapI);
                vE[j] = _mm512_max_epu8(_mm512_subs_epu8(e, vGapE), hg);
                vF = _mm512_max_epu8(_mm512_subs_epu8(vF, vGapE), hg);
            }
            vH = vHLoad[j];
        }
        /* lazy-F, same dominance argument as the SSE2 kernel */
        vF = sw8_shl1(vF);
        j = 0;
        for (;;) {
            __m512i h = vHStore[j];
            __m512i hg = _mm512_subs_epu8(h, vGapI);
            __m512i excess = _mm512_subs_epu8(vF, hg);
            if (_mm512_cmpneq_epu8_mask(excess, vzero) == 0)
                break;
            h = _mm512_max_epu8(h, vF);
            vHStore[j] = h;
            vE[j] = _mm512_max_epu8(vE[j], _mm512_subs_epu8(h, vGapI));
            vF = _mm512_subs_epu8(vF, vGapE);
            if (++j >= seglen) {
                j = 0;
                vF = sw8_shl1(vF);
            }
        }
    }
    best = 0;
    {
        uint8_t out[64];
        _mm512_storeu_si512((__m512i *)out, vMax);
        for (lane = 0; lane < 64; lane++)
            if (out[lane] > best) best = out[lane];
    }
    free(mem);
    if (best >= 255 - bias)
        return -1;                  /* possible saturation: retry wider */
    return best;
    }
}
#endif /* __AVX512BW__ */

static int sw_full_sse2(const int32_t *W, int qlen,
                        const uint8_t *subj, int slen,
                        int gap_init, int gap_ext)
{
    const int seglen = (qlen + 7) / 8;
    const int nvec = seglen * 8;
    int i, j, a, lane;
    int16_t *mem;
    for (j = 0; j < 8 * qlen; j++)       /* int16-safe profile scores? */
        if (W[j] > 16384 || W[j] < -16384) return -1;
    mem = (int16_t *)malloc(((size_t)8 * nvec + 3 * nvec + 8)
                            * sizeof(int16_t) + 16);
    if (!mem) return -1;
    /* 16-byte align */
    int16_t *base = (int16_t *)(((uintptr_t)mem + 15) & ~(uintptr_t)15);
    int16_t *prof = base;                 /* 8 codes x seglen vectors */
    __m128i *vprof = (__m128i *)prof;
    __m128i *vHStore = (__m128i *)(prof + 8 * nvec);
    __m128i *vHLoad = vHStore + seglen;
    __m128i *vE = vHLoad + seglen;

    for (a = 0; a < 8; a++) {
        const int32_t *rs = W + a * qlen;
        int16_t *p = prof + a * nvec;
        for (j = 0; j < seglen; j++)
            for (lane = 0; lane < 8; lane++) {
                int q = j + lane * seglen;
                p[j * 8 + lane] = (q < qlen) ? (int16_t)rs[q] : -32768;
            }
    }
    {
        __m128i vzero = _mm_setzero_si128();
        for (j = 0; j < seglen; j++) {
            vHStore[j] = vzero;
            vHLoad[j] = vzero;
            vE[j] = vzero;
        }
        __m128i vGapI = _mm_set1_epi16((int16_t)gap_init);
        __m128i vGapE = _mm_set1_epi16((int16_t)gap_ext);
        __m128i vMax = vzero;

        for (i = 0; i < slen; i++) {
            const __m128i *vP = vprof + (size_t)(subj[i] & 7) * seglen;
            __m128i vF = vzero;
            __m128i vH = _mm_slli_si128(vHStore[seglen - 1], 2);
            __m128i *tmp = vHLoad; vHLoad = vHStore; vHStore = tmp;
            for (j = 0; j < seglen; j++) {
                __m128i e = vE[j];
                vH = _mm_adds_epi16(vH, vP[j]);
                vMax = _mm_max_epi16(vMax, vH);   /* diagonal-extended max */
                vH = _mm_max_epi16(vH, e);
                vH = _mm_max_epi16(vH, vF);
                vH = _mm_max_epi16(vH, vzero);
                vHStore[j] = vH;
                {
                    __m128i hg = _mm_subs_epi16(vH, vGapI);
                    vE[j] = _mm_max_epi16(_mm_subs_epi16(e, vGapE), hg);
                    vF = _mm_max_epi16(_mm_subs_epi16(vF, vGapE), hg);
                }
                vH = vHLoad[j];
            }
            /* lazy-F: propagate the lane-wrapped F until it is
             * dominated everywhere by the main pass (vF <= H - ginit:
             * the same contribution already flowed with the same
             * decay, so nothing downstream can change). */
            {
                /* lane-0 inserts must be -inf, not the 0 that
                 * _mm_slli_si128 shifts in: a 0 is an invalid
                 * "free gap from nowhere" that never raises H (H>=0)
                 * but keeps the dominance check alive forever at
                 * cells with H < gap_init. */
                const __m128i vNegInf = _mm_set1_epi16(-32768);
                vF = _mm_slli_si128(vF, 2);
                vF = _mm_insert_epi16(vF, -32768, 0);
                j = 0;
                for (;;) {
                    __m128i h = vHStore[j];
                    __m128i dom = _mm_cmpgt_epi16(vF, _mm_subs_epi16(h, vGapI));
                    __m128i raised;
                    if (_mm_movemask_epi8(dom) == 0) break;
                    raised = _mm_cmpgt_epi16(vF, h);
                    h = _mm_max_epi16(h, vF);
                    vHStore[j] = h;
                    vE[j] = _mm_max_epi16(vE[j], _mm_subs_epi16(h, vGapI));
                    /* a raised H opens a fresh gap (needed when
                     * gap_ext > gap_init); only in raised lanes, else
                     * -inf so vF strictly decreases and terminates */
                    {
                        __m128i open = _mm_or_si128(
                            _mm_and_si128(raised, _mm_subs_epi16(vF, vGapI)),
                            _mm_andnot_si128(raised, vNegInf));
                        vF = _mm_max_epi16(_mm_subs_epi16(vF, vGapE), open);
                    }
                    if (++j >= seglen) {
                        j = 0;
                        vF = _mm_slli_si128(vF, 2);
                        vF = _mm_insert_epi16(vF, -32768, 0);
                    }
                }
            }
        }
        {
            int16_t out[8];
            int m = 0;
            _mm_storeu_si128((__m128i *)out, vMax);
            for (lane = 0; lane < 8; lane++)
                if (out[lane] > m) m = out[lane];
            free(mem);
            if (m >= 32000) return -1;   /* possible saturation: rerun */
            return m;
        }
    }
}
#endif /* __SSE2__ */

int sw_full(const int32_t *W, int qlen,
            const uint8_t *subj, int slen,
            int gap_init, int gap_ext,
            int32_t *Hbuf, int32_t *Ebuf)
{
#ifdef __SSE2__
    if (qlen >= 16) {
        int r;
#ifdef __AVX512BW__
        r = sw_full_avx512_8(W, qlen, subj, slen, gap_init, gap_ext);
#else
        r = sw_full_sse2_8(W, qlen, subj, slen, gap_init, gap_ext);
#endif
        if (r >= 0) return r;
        r = sw_full_sse2(W, qlen, subj, slen, gap_init, gap_ext);
        if (r >= 0) return r;
    }
#endif
    return sw_full_scalar(W, qlen, subj, slen, gap_init, gap_ext, Hbuf, Ebuf);
}

/* sw_full minus the 8-bit first try: the fallback for a prepared-
 * profile caller whose 8-bit run refused (saturation) or whose
 * profile was unsuitable.  Exactly the 16-bit -> scalar tail of
 * sw_full, so routing through here cannot change any score. */
int sw_full_wide(const int32_t *W, int qlen,
                 const uint8_t *subj, int slen,
                 int gap_init, int gap_ext,
                 int32_t *Hbuf, int32_t *Ebuf)
{
#ifdef __SSE2__
    if (qlen >= 16) {
        int r = sw_full_sse2(W, qlen, subj, slen, gap_init, gap_ext);
        if (r >= 0) return r;
    }
#endif
    return sw_full_scalar(W, qlen, subj, slen, gap_init, gap_ext, Hbuf, Ebuf);
}

/* ---- prepared per-read 8-bit striped profile --------------------
 *
 * mc_score_cands scores ~2-10 candidate windows per read with the
 * SAME query profile; the one-shot kernels above rebuild the striped
 * byte profile (plus a malloc and an 8*qlen range scan) on every
 * call, which dominates at short-read sizes where the DP itself is a
 * few hundred vector steps.  These entries split build from run so
 * the build happens once per read/strand.  Scores and refusal
 * conditions are IDENTICAL to sw_full's 8-bit first try.
 *
 * Two thread-local slots (forward/reverse profile of the read in
 * flight).  Worker parallelism forks processes, so thread-locals are
 * effectively per-worker; __thread keeps it correct regardless. */
#ifdef __SSE2__

#ifdef __AVX512BW__
#define SW8_LANES 64
#else
#define SW8_LANES 16
#endif

typedef struct {
    uint8_t *mem;
    size_t cap;
    int qlen, seglen, nvec, bias;
    int gap_init, gap_ext;
} SW8Prof;

static __thread SW8Prof sw8_slot[2];

/* Build the striped profile for slot `slot` (0 fwd / 1 rev).
 * Returns 0, or -1 when the 8-bit kernel would refuse this profile
 * (score range, gap shape) — same conditions as the one-shot entry. */
int sw_prof8_set(int slot, const int32_t *W, int qlen,
                 int gap_init, int gap_ext)
{
    SW8Prof *p = &sw8_slot[slot & 1];
    const int seglen = (qlen + SW8_LANES - 1) / SW8_LANES;
    const int nvec = seglen * SW8_LANES;
    int j, a, lane, bias = 0;
    size_t need;
    if (gap_ext > gap_init || gap_init > 127)
        return -1;
    for (j = 0; j < 8 * qlen; j++) {
        if (W[j] > 100 || W[j] < -100) return -1;
        if (-W[j] > bias) bias = -W[j];
    }
    need = (size_t)8 * nvec + 3 * nvec + 2 * SW8_LANES;
    if (p->cap < need) {
        free(p->mem);
        p->mem = (uint8_t *)malloc(need);
        if (!p->mem) { p->cap = 0; return -1; }
        p->cap = need;
    }
    {
        uint8_t *prof = (uint8_t *)(((uintptr_t)p->mem + SW8_LANES - 1)
                                    & ~(uintptr_t)(SW8_LANES - 1));
        for (a = 0; a < 8; a++) {
            const int32_t *rs = W + a * qlen;
            uint8_t *pp = prof + (size_t)a * nvec;
            for (j = 0; j < seglen; j++)
                for (lane = 0; lane < SW8_LANES; lane++) {
                    int q = j + lane * seglen;
                    pp[j * SW8_LANES + lane] =
                        (q < qlen) ? (uint8_t)(rs[q] + bias) : 0;
                }
        }
    }
    p->qlen = qlen;
    p->seglen = seglen;
    p->nvec = nvec;
    p->bias = bias;
    p->gap_init = gap_init;
    p->gap_ext = gap_ext;
    return 0;
}

/* Score one subject window against the prepared profile.  Returns the
 * exact local-alignment maximum, or -1 on possible 8-bit saturation
 * (caller falls back to sw_full_wide). */
#ifdef __AVX512BW__
/* seglen<=2 fast paths: the whole recurrence state (H, E, F, max)
 * lives in registers — no per-row array traffic, no pointer swap.
 * Identical arithmetic to the general loop below. */
static int sw_prof8_score_seg1(const uint8_t *prof, int bias,
                               int gap_init, int gap_ext,
                               const uint8_t *subj, int slen)
{
    const __m512i *vprof = (const __m512i *)prof;
    __m512i vzero = _mm512_setzero_si512();
    __m512i vBias = _mm512_set1_epi8((char)(uint8_t)bias);
    __m512i vGapI = _mm512_set1_epi8((char)(uint8_t)gap_init);
    __m512i vGapE = _mm512_set1_epi8((char)(uint8_t)gap_ext);
    __m512i vMax = vzero, H0 = vzero, E0 = vzero;
    int i, lane, best;
    for (i = 0; i < slen; i++) {
        __m512i vH = sw8_shl1(H0);
        __m512i e = E0, hg, vF;
        vH = _mm512_subs_epu8(_mm512_adds_epu8(vH, vprof[subj[i] & 7]),
                              vBias);
        vMax = _mm512_max_epu8(vMax, vH);
        vH = _mm512_max_epu8(vH, e);          /* F is 0 at row start */
        hg = _mm512_subs_epu8(vH, vGapI);
        E0 = _mm512_max_epu8(_mm512_subs_epu8(e, vGapE), hg);
        vF = _mm512_max_epu8(_mm512_subs_epu8(vzero, vGapE), hg);
        H0 = vH;
        vF = sw8_shl1(vF);
        for (;;) {
            __m512i excess = _mm512_subs_epu8(
                vF, _mm512_subs_epu8(H0, vGapI));
            if (_mm512_cmpneq_epu8_mask(excess, vzero) == 0)
                break;
            H0 = _mm512_max_epu8(H0, vF);
            E0 = _mm512_max_epu8(E0, _mm512_subs_epu8(H0, vGapI));
            vF = sw8_shl1(_mm512_subs_epu8(vF, vGapE));
        }
    }
    best = 0;
    {
        uint8_t out[64];
        _mm512_storeu_si512((__m512i *)out, vMax);
        for (lane = 0; lane < 64; lane++)
            if (out[lane] > best) best = out[lane];
    }
    if (best >= 255 - bias)
        return -1;
    return best;
}

static int sw_prof8_score_seg2(const uint8_t *prof, int bias,
                               int gap_init, int gap_ext,
                               const uint8_t *subj, int slen)
{
    const __m512i *vprof = (const __m512i *)prof;
    __m512i vzero = _mm512_setzero_si512();
    __m512i vBias = _mm512_set1_epi8((char)(uint8_t)bias);
    __m512i vGapI = _mm512_set1_epi8((char)(uint8_t)gap_init);
    __m512i vGapE = _mm512_set1_epi8((char)(uint8_t)gap_ext);
    __m512i vMax = vzero;
    __m512i H0 = vzero, H1 = vzero, E0 = vzero, E1 = vzero;
    int i, lane, best;
    for (i = 0; i < slen; i++) {
        const __m512i *vP = vprof + (size_t)(subj[i] & 7) * 2;
        __m512i vH = sw8_shl1(H1);
        __m512i Hp0 = H0;
        __m512i vF, e, hg;
        /* j = 0 */
        e = E0;
        vH = _mm512_subs_epu8(_mm512_adds_epu8(vH, vP[0]), vBias);
        vMax = _mm512_max_epu8(vMax, vH);
        vH = _mm512_max_epu8(vH, e);          /* F is 0 at row start */
        H0 = vH;
        hg = _mm512_subs_epu8(vH, vGapI);
        E0 = _mm512_max_epu8(_mm512_subs_epu8(e, vGapE), hg);
        vF = _mm512_max_epu8(_mm512_subs_epu8(vzero, vGapE), hg);
        /* j = 1 */
        e = E1;
        vH = _mm512_subs_epu8(_mm512_adds_epu8(Hp0, vP[1]), vBias);
        vMax = _mm512_max_epu8(vMax, vH);
        vH = _mm512_max_epu8(vH, e);
        vH = _mm512_max_epu8(vH, vF);
        H1 = vH;
        hg = _mm512_subs_epu8(vH, vGapI);
        E1 = _mm512_max_epu8(_mm512_subs_epu8(e, vGapE), hg);
        vF = _mm512_max_epu8(_mm512_subs_epu8(vF, vGapE), hg);
        vF = sw8_shl1(vF);
        for (;;) {
            __m512i excess = _mm512_subs_epu8(
                vF, _mm512_subs_epu8(H0, vGapI));
            if (_mm512_cmpneq_epu8_mask(excess, vzero) == 0)
                break;
            H0 = _mm512_max_epu8(H0, vF);
            E0 = _mm512_max_epu8(E0, _mm512_subs_epu8(H0, vGapI));
            vF = _mm512_subs_epu8(vF, vGapE);
            excess = _mm512_subs_epu8(vF, _mm512_subs_epu8(H1, vGapI));
            if (_mm512_cmpneq_epu8_mask(excess, vzero) == 0)
                break;
            H1 = _mm512_max_epu8(H1, vF);
            E1 = _mm512_max_epu8(E1, _mm512_subs_epu8(H1, vGapI));
            vF = sw8_shl1(_mm512_subs_epu8(vF, vGapE));
        }
    }
    best = 0;
    {
        uint8_t out[64];
        _mm512_storeu_si512((__m512i *)out, vMax);
        for (lane = 0; lane < 64; lane++)
            if (out[lane] > best) best = out[lane];
    }
    if (best >= 255 - bias)
        return -1;
    return best;
}
#endif /* __AVX512BW__ */

int sw_prof8_score(int slot, const uint8_t *subj, int slen)
{
    SW8Prof *p = &sw8_slot[slot & 1];
    const int seglen = p->seglen, nvec = p->nvec, bias = p->bias;
    uint8_t *prof = (uint8_t *)(((uintptr_t)p->mem + SW8_LANES - 1)
                                & ~(uintptr_t)(SW8_LANES - 1));
    int i, j, lane, best;
#ifdef __AVX512BW__
    if (seglen == 1)
        return sw_prof8_score_seg1(prof, bias, p->gap_init, p->gap_ext,
                                   subj, slen);
    if (seglen == 2)
        return sw_prof8_score_seg2(prof, bias, p->gap_init, p->gap_ext,
                                   subj, slen);
    __m512i *vprof = (__m512i *)prof;
    __m512i *vHStore = (__m512i *)(prof + 8 * nvec);
    __m512i *vHLoad = vHStore + seglen;
    __m512i *vE = vHLoad + seglen;
    __m512i vzero = _mm512_setzero_si512();
    __m512i vBias = _mm512_set1_epi8((char)(uint8_t)bias);
    __m512i vGapI = _mm512_set1_epi8((char)(uint8_t)p->gap_init);
    __m512i vGapE = _mm512_set1_epi8((char)(uint8_t)p->gap_ext);
    __m512i vMax = vzero;
    for (j = 0; j < seglen; j++) {
        vHStore[j] = vzero;
        vHLoad[j] = vzero;
        vE[j] = vzero;
    }
    for (i = 0; i < slen; i++) {
        const __m512i *vP = vprof + (size_t)(subj[i] & 7) * seglen;
        __m512i vF = vzero;
        __m512i vH = sw8_shl1(vHStore[seglen - 1]);
        __m512i *tmp = vHLoad; vHLoad = vHStore; vHStore = tmp;
        for (j = 0; j < seglen; j++) {
            __m512i e = vE[j];
            vH = _mm512_subs_epu8(_mm512_adds_epu8(vH, vP[j]), vBias);
            vMax = _mm512_max_epu8(vMax, vH);
            vH = _mm512_max_epu8(vH, e);
            vH = _mm512_max_epu8(vH, vF);
            vHStore[j] = vH;
            {
                __m512i hg = _mm512_subs_epu8(vH, vGapI);
                vE[j] = _mm512_max_epu8(_mm512_subs_epu8(e, vGapE), hg);
                vF = _mm512_max_epu8(_mm512_subs_epu8(vF, vGapE), hg);
            }
            vH = vHLoad[j];
        }
        vF = sw8_shl1(vF);
        j = 0;
        for (;;) {
            __m512i h = vHStore[j];
            __m512i hg = _mm512_subs_epu8(h, vGapI);
            __m512i excess = _mm512_subs_epu8(vF, hg);
            if (_mm512_cmpneq_epu8_mask(excess, vzero) == 0)
                break;
            h = _mm512_max_epu8(h, vF);
            vHStore[j] = h;
            vE[j] = _mm512_max_epu8(vE[j], _mm512_subs_epu8(h, vGapI));
            vF = _mm512_subs_epu8(vF, vGapE);
            if (++j >= seglen) {
                j = 0;
                vF = sw8_shl1(vF);
            }
        }
    }
    best = 0;
    {
        uint8_t out[64];
        _mm512_storeu_si512((__m512i *)out, vMax);
        for (lane = 0; lane < 64; lane++)
            if (out[lane] > best) best = out[lane];
    }
#else /* SSE2 */
    __m128i *vprof = (__m128i *)prof;
    __m128i *vHStore = (__m128i *)(prof + 8 * nvec);
    __m128i *vHLoad = vHStore + seglen;
    __m128i *vE = vHLoad + seglen;
    __m128i vzero = _mm_setzero_si128();
    __m128i vBias = _mm_set1_epi8((char)(uint8_t)bias);
    __m128i vGapI = _mm_set1_epi8((char)(uint8_t)p->gap_init);
    __m128i vGapE = _mm_set1_epi8((char)(uint8_t)p->gap_ext);
    __m128i vMax = vzero;
    for (j = 0; j < seglen; j++) {
        vHStore[j] = vzero;
        vHLoad[j] = vzero;
        vE[j] = vzero;
    }
    for (i = 0; i < slen; i++) {
        const __m128i *vP = vprof + (size_t)(subj[i] & 7) * seglen;
        __m128i vF = vzero;
        __m128i vH = _mm_slli_si128(vHStore[seglen - 1], 1);
        __m128i *tmp = vHLoad; vHLoad = vHStore; vHStore = tmp;
        for (j = 0; j < seglen; j++) {
            __m128i e = vE[j];
            vH = _mm_subs_epu8(_mm_adds_epu8(vH, vP[j]), vBias);
            vMax = _mm_max_epu8(vMax, vH);
            vH = _mm_max_epu8(vH, e);
            vH = _mm_max_epu8(vH, vF);
            vHStore[j] = vH;
            {
                __m128i hg = _mm_subs_epu8(vH, vGapI);
                vE[j] = _mm_max_epu8(_mm_subs_epu8(e, vGapE), hg);
                vF = _mm_max_epu8(_mm_subs_epu8(vF, vGapE), hg);
            }
            vH = vHLoad[j];
        }
        vF = _mm_slli_si128(vF, 1);
        j = 0;
        for (;;) {
            __m128i h = vHStore[j];
            __m128i hg = _mm_subs_epu8(h, vGapI);
            __m128i excess = _mm_subs_epu8(vF, hg);
            if (_mm_movemask_epi8(_mm_cmpeq_epi8(excess, vzero)) == 0xFFFF)
                break;
            h = _mm_max_epu8(h, vF);
            vHStore[j] = h;
            vE[j] = _mm_max_epu8(vE[j], _mm_subs_epu8(h, vGapI));
            vF = _mm_subs_epu8(vF, vGapE);
            if (++j >= seglen) {
                j = 0;
                vF = _mm_slli_si128(vF, 1);
            }
        }
    }
    best = 0;
    {
        uint8_t out[16];
        _mm_storeu_si128((__m128i *)out, vMax);
        for (lane = 0; lane < 16; lane++)
            if (out[lane] > best) best = out[lane];
    }
#endif
    if (best >= 255 - bias)
        return -1;                  /* possible saturation: go wider */
    return best;
}

#else /* !__SSE2__ */

int sw_prof8_set(int slot, const int32_t *W, int qlen,
                 int gap_init, int gap_ext)
{
    (void)slot; (void)W; (void)qlen; (void)gap_init; (void)gap_ext;
    return -1;
}

int sw_prof8_score(int slot, const uint8_t *subj, int slen)
{
    (void)slot; (void)subj; (void)slen;
    return -1;
}

#endif /* __SSE2__ */

/* ---------- quicksort with the Numerical Recipes permutation ----------
 *
 * PROVENANCE NOTE.  This is the classic index-stack quicksort of
 * Numerical Recipes in C (Press et al., 2nd ed., ch. 8.2/8.4,
 * "sort2") — third-party published material that the reference engine
 * also embeds (sort.c:236-330).  It is deliberately kept in the NR
 * shape rather than re-designed, because the UNSTABLE PERMUTATION it
 * produces on tied keys is an observable output contract: candidate
 * and result ordering after tie-ranked sorts decides which of several
 * equal-score mappings becomes the primary record, and the golden SAM
 * corpus (byte-parity vs the reference binary) pins that choice.  The
 * permutation is a function of the exact pivot selection (median-of-
 * three at left+1), the insertion-sort threshold (7) and the stack
 * discipline — any "cleanup" of those is an output change.  See
 * PARITY.md row 3. */

#define NR_MAXSTACK 60
#define NR_MINARR 7

#define NR_SORT_BODY(KT, VT)                                                 \
    int i, j, i_left = 0, i_middle, i_right = n - 1;                         \
    KT pa; VT pb;                                                            \
    int stack[NR_MAXSTACK + 2]; int sp = 0;                                  \
    KT t; VT tv;                                                             \
    if (n < 2) return 0;                                                     \
    for (;;) {                                                               \
        if (i_right - i_left < NR_MINARR) {                                  \
            for (j = i_left + 1; j <= i_right; j++) {                        \
                pa = a[j]; pb = b[j];                                        \
                for (i = j - 1; i >= i_left && a[i] > pa; i--) {             \
                    a[i + 1] = a[i]; b[i + 1] = b[i];                        \
                }                                                            \
                a[i + 1] = pa; b[i + 1] = pb;                                \
            }                                                                \
            if (!sp) return 0;                                               \
            i_right = stack[sp--]; i_left = stack[sp--];                     \
        } else {                                                             \
            i_middle = (i_left + i_right) >> 1;                              \
            t = a[i_middle]; a[i_middle] = a[i_left + 1]; a[i_left + 1] = t; \
            tv = b[i_middle]; b[i_middle] = b[i_left + 1]; b[i_left + 1] = tv;\
            if (a[i_left] > a[i_right]) {                                    \
                t = a[i_left]; a[i_left] = a[i_right]; a[i_right] = t;       \
                tv = b[i_left]; b[i_left] = b[i_right]; b[i_right] = tv;     \
            }                                                                \
            if (a[i_left + 1] > a[i_right]) {                                \
                t = a[i_left + 1]; a[i_left + 1] = a[i_right]; a[i_right] = t;\
                tv = b[i_left + 1]; b[i_left + 1] = b[i_right]; b[i_right] = tv;\
            }                                                                \
            if (a[i_left] > a[i_left + 1]) {                                 \
                t = a[i_left]; a[i_left] = a[i_left + 1]; a[i_left + 1] = t; \
                tv = b[i_left]; b[i_left] = b[i_left + 1]; b[i_left + 1] = tv;\
            }                                                                \
            i = i_left + 1; j = i_right;                                     \
            pa = a[i_left + 1]; pb = b[i_left + 1];                          \
            for (;;) {                                                       \
                do i++; while (a[i] < pa);                                   \
                do j--; while (a[j] > pa);                                   \
                if (j < i) break;                                            \
                t = a[i]; a[i] = a[j]; a[j] = t;                             \
                tv = b[i]; b[i] = b[j]; b[j] = tv;                           \
            }                                                                \
            a[i_left + 1] = a[j]; b[i_left + 1] = b[j];                      \
            a[j] = pa; b[j] = pb;                                            \
            sp += 2;                                                         \
            if (sp > NR_MAXSTACK) return -1;                                 \
            if (i_right - i + 1 >= j - i_left) {                             \
                stack[sp] = i_right; stack[sp - 1] = i;                      \
                i_right = j - 1;                                             \
            } else {                                                         \
                stack[sp] = j - 1; stack[sp - 1] = i_left;                   \
                i_left = i;                                                  \
            }                                                                \
        }                                                                    \
    }

int nr_sort2(uint32_t *a, uint32_t *b, int n) { NR_SORT_BODY(uint32_t, uint32_t) }
int nr_sort2_64_32(uint64_t *a, uint32_t *b, int n) { NR_SORT_BODY(uint64_t, uint32_t) }
int nr_sort64(uint64_t *a, int n)
{
    /* single-array variant (sortUINT64arrayByQuickSort) — keys are unique
     * in our uses, so ordering equals any ascending sort; kept for speed. */
    uint64_t *b = a; (void)b;
    int i, j, i_left = 0, i_middle, i_right = n - 1;
    uint64_t pa, t;
    int stack[NR_MAXSTACK + 2]; int sp = 0;
    if (n < 2) return 0;
    for (;;) {
        if (i_right - i_left < NR_MINARR) {
            for (j = i_left + 1; j <= i_right; j++) {
                pa = a[j];
                for (i = j - 1; i >= i_left && a[i] > pa; i--) a[i + 1] = a[i];
                a[i + 1] = pa;
            }
            if (!sp) return 0;
            i_right = stack[sp--]; i_left = stack[sp--];
        } else {
            i_middle = (i_left + i_right) >> 1;
            t = a[i_middle]; a[i_middle] = a[i_left + 1]; a[i_left + 1] = t;
            if (a[i_left] > a[i_right]) { t = a[i_left]; a[i_left] = a[i_right]; a[i_right] = t; }
            if (a[i_left + 1] > a[i_right]) { t = a[i_left + 1]; a[i_left + 1] = a[i_right]; a[i_right] = t; }
            if (a[i_left] > a[i_left + 1]) { t = a[i_left]; a[i_left] = a[i_left + 1]; a[i_left + 1] = t; }
            i = i_left + 1; j = i_right;
            pa = a[i_left + 1];
            for (;;) {
                do i++; while (a[i] < pa);
                do j--; while (a[j] > pa);
                if (j < i) break;
                t = a[i]; a[i] = a[j]; a[j] = t;
            }
            a[i_left + 1] = a[j]; a[j] = pa;
            sp += 2;
            if (sp > NR_MAXSTACK) return -1;
            if (i_right - i + 1 >= j - i_left) {
                stack[sp] = i_right; stack[sp - 1] = i;
                i_right = j - 1;
            } else {
                stack[sp] = j - 1; stack[sp - 1] = i_left;
                i_left = i;
            }
        }
    }
}
