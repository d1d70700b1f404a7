// The exact lane's seed / segment / candidate scan over one (read,
// strand) lane's sorted hits, as one thread runs it: segcand.cu's kernel
// on the card, and the host build of this header (SEGCAND_HOST) that the
// CPU tests hold against the plain version.
//
// Plain version: _segcand_scan + _compact_rows in
// smalt_tpu_torch/parallel/exact_collate.py (segment.c semantics), which
// this code equals exactly: every quantity int32, floor division and
// the packed row fields as there, the rows in emission order (a region
// break's row before the same hit's region close), the first C kept and
// all of them counted.  The plain version runs H + 1 lane-parallel steps
// and keeps stepping past a lane's last hit, where a step changes
// nothing (no hit merges, starts or closes a seed); here a lane stops
// after its own hits and the closing step.
//
// State a lane: about twenty scalars and two bit masks of the query's
// positions (the open segment's and the open candidate's covered
// bases), NW 32-bit words each (Q <= 32 * NW).
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#include <cstddef>
#include <cstdint>
static inline int segcand_popc(unsigned x) { return __builtin_popcount(x); }
#else
__device__ __forceinline__ int segcand_popc(unsigned x) { return __popc(x); }
#endif

#define SEGCAND_FIELDS 7

// floor division by b > 0 (torch's // on int32)
__host__ __device__ inline int segcand_fdiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// two's-complement int32 difference (torch's int32 arithmetic wraps)
__host__ __device__ inline int segcand_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

struct SegcandCand {
  int cover, qs, qe, rs, re, shiftmin, maxcovseg, shift2mm, lastshift, nseg;
};

// derriveSEGCAND's packed row of candidate c; returns the row's bad flag
__host__ __device__ inline bool segcand_pack(const SegcandCand& c, int ivl,
                                             bool rev, int k, int nskip,
                                             int mincover, int* row) {
  int sh_start = rev ? c.rs + segcand_fdiv(c.qe - k + 1, nskip)
                     : c.rs - segcand_fdiv(c.qs, nskip);
  int srange = c.lastshift - c.shiftmin;
  bool mmali = c.maxcovseg >= mincover;
  int nseg = c.nseg < 255 ? c.nseg : 255;
  row[0] = (int)((unsigned)c.qs | ((unsigned)c.qe << 8) |
                 ((unsigned)c.cover << 16) | ((unsigned)nseg << 24));
  row[1] = c.rs;
  row[2] = c.re;
  row[3] = c.shiftmin - sh_start;
  row[4] = mmali ? c.shift2mm - sh_start : 0;
  row[5] = (int)(((unsigned)srange & 0x3FFFFFu) | (mmali ? 0x80000000u : 0u));
  row[6] = ivl;
  return c.nseg > 255 || srange < 0 || srange >= (1 << 22) ||
         c.cover > 255 || c.qs < 0 || c.qe > 255;
}

// One lane: hits e < tot of k1 / k2 (/ ivl, the sequence id, or null),
// sorted by (ivl,) k1, k2.  Writes the first C candidate rows of
// SEGCAND_FIELDS ints to rows, all of them counted in *count, and
// whether any row is outside the packed fields in *bad.
template <int NW>
__host__ __device__ inline void segcand_lane(
    const int* k1, const int* k2, const int* ivl, int tot, int mdsh,
    int mincover, bool rev, int k, int nskip, int Q, int C, int* rows,
    int* count, int* bad_out) {
  bool open_seed = false, cand_open = false, bad = false;
  int seed_q0 = 0, seed_lastq = 0, seg_shift = 0, seg_q0first = 0;
  int seg_cover_done = 0, seg_covernew = 0, reg_ivl = 0;
  unsigned smask[NW], cmask[NW];
  for (int w = 0; w < NW; w++) smask[w] = cmask[w] = 0u;
  SegcandCand c = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  int ne = 0, pk1 = 0, pk2 = 0, pivl = 0;

  for (int e = 0; e <= tot; e++) {
    const bool force = e == tot;          // the closing step
    const bool val = !force;
    int k1e = 0, k2e = 0, ivl_e = 0;
    bool rstart = false, sshift = false;
    if (val) {
      k1e = k1[e];
      k2e = k2[e];
      ivl_e = ivl ? ivl[e] : 0;
      int d1 = segcand_sub(k1e, pk1);
      bool same_region = d1 < mdsh || (d1 == mdsh && k2e < pk2);
      bool same_shift = d1 == 0 && e > 0;
      if (ivl && ivl_e != pivl && e > 0) same_region = same_shift = false;
      rstart = e == 0 || !same_region;
      sshift = same_shift;
      pk1 = k1e;
      pk2 = k2e;
      pivl = ivl_e;
    }

    // classify the incoming hit
    const bool merge = val && !rstart && sshift && open_seed &&
                       k2e <= seed_lastq && (k2e - seed_q0) % nskip == 0;
    const bool new_seed = val && !merge;
    const bool seg_cont = new_seed && !rstart && open_seed &&
                          k1e == seg_shift &&
                          (k2e - seg_q0first) % nskip == 0;
    const bool close_seg = open_seed && ((new_seed && !seg_cont) || force);
    const bool close_cand = open_seed && ((val && rstart) || force);

    // segment completion + greedy candidate decision
    const int seed_len = seed_lastq - seed_q0;
    const int seg_cover = seg_cover_done + seed_len;
    const int ext = segcand_fdiv(seed_len - k, nskip);
    const int qs_s = seg_q0first, qe_s = seed_q0 + seed_len - 1;
    const int rs_s = rev ? seg_shift - segcand_fdiv(seed_q0, nskip) - ext
                         : seg_shift + segcand_fdiv(qs_s, nskip);
    const int re_s = rev ? seg_shift - segcand_fdiv(qs_s, nskip)
                         : seg_shift + segcand_fdiv(seed_q0, nskip) + ext;
    const bool brk = close_seg && cand_open && 2 * seg_covernew < seg_cover &&
                     c.cover >= mincover;
    const bool fresh = (close_seg && !cand_open) || brk;
    if (brk) {                             // a break always emits
      int row[SEGCAND_FIELDS];
      bad |= segcand_pack(c, reg_ivl, rev, k, nskip, mincover, row);
      if (ne < C)
        for (int f = 0; f < SEGCAND_FIELDS; f++)
          rows[ne * SEGCAND_FIELDS + f] = row[f];
      ne++;
    }
    if (close_seg) {
      const bool upd = fresh || seg_cover > c.maxcovseg;
      SegcandCand n;
      n.cover = fresh ? seg_cover : c.cover + seg_covernew;
      n.qs = fresh ? qs_s : (c.qs < qs_s ? c.qs : qs_s);
      n.qe = fresh ? qe_s : (c.qe > qe_s ? c.qe : qe_s);
      n.rs = fresh ? rs_s : (c.rs < rs_s ? c.rs : rs_s);
      n.re = fresh ? re_s : (c.re > re_s ? c.re : re_s);
      n.shiftmin = fresh ? seg_shift : c.shiftmin;
      n.maxcovseg = upd ? seg_cover : c.maxcovseg;
      n.shift2mm = upd ? seg_shift : c.shift2mm;
      n.lastshift = seg_shift;
      n.nseg = fresh ? 1 : c.nseg + 1;
      c = n;
      for (int w = 0; w < NW; w++)
        cmask[w] = fresh ? smask[w] : (cmask[w] | smask[w]);
    }
    cand_open = cand_open || close_seg;

    // region close: emit the (possibly just-integrated) candidate
    if (close_cand && cand_open && c.cover >= mincover) {
      int row[SEGCAND_FIELDS];
      bad |= segcand_pack(c, reg_ivl, rev, k, nskip, mincover, row);
      if (ne < C)
        for (int f = 0; f < SEGCAND_FIELDS; f++)
          rows[ne * SEGCAND_FIELDS + f] = row[f];
      ne++;
    }
    if (close_cand) {
      cand_open = false;
      for (int w = 0; w < NW; w++) cmask[w] = 0u;
    }

    // start / extend structures with the incoming hit: its bases
    // [lo, hi) of the query
    const int lo = merge ? seed_lastq : k2e;
    const int hi = val ? (k2e + k < Q ? k2e + k : Q) : k2e;
    const bool reset_seg = close_seg || !open_seed;
    int covnew_add = 0;
    for (int w = 0; w < NW; w++) {
      int a = lo - 32 * w, b = hi - 32 * w;
      a = a < 0 ? 0 : a;
      b = b > 32 ? 32 : b;
      unsigned bits = 0u;
      if (val && b > a)
        bits = (b == 32 ? 0xFFFFFFFFu : ((1u << b) - 1u)) & ~((1u << a) - 1u);
      covnew_add += segcand_popc(bits & ~cmask[w]);
      smask[w] = (reset_seg ? 0u : smask[w]) | bits;
    }
    const int covnew = (reset_seg ? 0 : seg_covernew) + covnew_add;
    const int done = (reset_seg ? 0 : seg_cover_done) +
                     (new_seed && open_seed && !close_seg ? seed_len : 0);

    open_seed = (open_seed && !force) || new_seed;
    if (new_seed) seed_q0 = k2e;
    if (val) seed_lastq = k2e + k;
    if (new_seed && !seg_cont) {
      seg_shift = k1e;
      seg_q0first = k2e;
    }
    seg_cover_done = done;
    seg_covernew = covnew;
    if (val && rstart) reg_ivl = ivl_e;
  }
  *count = ne;
  *bad_out = bad ? 1 : 0;
}

#ifdef SEGCAND_HOST
// The host build (tests): every lane of [R, H] hits in turn, with the
// kernel's arguments.
extern "C" int segcand_host(const int* k1, const int* k2, const int* ivl,
                            const int* tot, const int* mdsh,
                            const int* mincov, int R, int H, int C, int k,
                            int nskip, int Q, int* rows, int* counts,
                            int* bad) {
  if (Q > 256) return 1;
  for (int r = 0; r < R; r++) {
    int t = tot[r] < H ? tot[r] : H;
    segcand_lane<8>(k1 + (size_t)r * H, k2 + (size_t)r * H,
                    ivl ? ivl + (size_t)r * H : nullptr, t, mdsh[r],
                    mincov[r], (r & 1) != 0, k, nskip, Q, C,
                    rows + (size_t)r * C * SEGCAND_FIELDS, counts + r,
                    bad + r);
  }
  return 0;
}
#endif
