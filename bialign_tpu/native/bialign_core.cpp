// Native host DP engine for bialign-tpu.
//
// Counterpart of the reference's single native component (the Cython
// extension bialignment.pyx, see SURVEY.md §2.4): the accelerator compute
// path is XLA/CUDA, and this C++ core is the *host* engine — a fast,
// portable fallback used when no accelerator is available and as a second
// independent implementation for cross-checking.  Bit-exact: it evaluates
// the same case tables (shipped from Python, single source of truth in
// bialign_tpu.ops.cases) in the same order as the numpy oracle
// (bialign_tpu/ops/reference_dp.py) and the reference fill loops
// (bialignment.pyx:443-509).
//
// Band layout matches the oracle: H[(q,) i, j, sk, sl] int64 with
// sk = k - i + S, sl = l - j + S.  Cells outside the valid (k, l) range
// are left untouched (the oracle leaves zeros; nothing reads them).
//
// Build: make -C bialign_tpu/native   (or the lazy ctypes builder in
// bialign_tpu/native/__init__.py).

#include <cstdint>
#include <cstdlib>

namespace {

constexpr int64_t NEG_INF = -(int64_t(1) << 30);

inline int imax(int a, int b) { return a > b ? a : b; }
inline int imin(int a, int b) { return a < b ? a : b; }
inline int iabs(int a) { return a < 0 ? -a : a; }

}  // namespace

extern "C" {

// Affine fill: ncases cases per state (15), nstates states (9).
// Tables (row-major):
//   src[q][c]    predecessor state index
//   col[q][c][4] column advance (a, b, c, d)
//   cst[q][c]    parameter-bound constant (n_g*gamma + n_b*beta + n_d*delta)
//   m1c[q][c], m2c[q][c]  mu1/mu2 multipliers
// H: int64[nstates][(n+1)][(m+1)][W][W], caller-zeroed.
void bialign_affine_fill(
    const int32_t* mu1, const int32_t* mu2, int n, int m, int S,
    const int32_t* src, const int32_t* col, const int32_t* cst,
    const int32_t* m1c, const int32_t* m2c, int nstates, int ncases,
    int64_t* H) {
  const int W = 2 * S + 1;
  const int64_t sj = (int64_t)W * W;        // stride of j in H
  const int64_t si = (int64_t)(m + 1) * sj; // stride of i
  const int64_t sq = (int64_t)(n + 1) * si; // stride of q
  const int64_t sm = m + 1;                 // stride of i in mu1

  // origin init (pyx:483-485): only the both-match state is reachable
  for (int q = 0; q < nstates; ++q)
    H[q * sq + (int64_t)S * W + S] = (q == nstates - 1) ? 0 : NEG_INF;

  for (int i = 0; i <= n; ++i) {
    for (int j = 0; j <= m; ++j) {
      const int32_t mu1_ij = mu1[i * sm + j];
      const int klo = imax(0, i - S), khi = imin(n, i + S);
      const int llo = imax(0, j - S), lhi = imin(m, j + S);
      for (int k = klo; k <= khi; ++k) {
        for (int l = llo; l <= lhi; ++l) {
          if (i == 0 && j == 0 && k == 0 && l == 0) continue;
          const int32_t mu2_kl = mu2[k * sm + l];
          for (int q = 0; q < nstates; ++q) {
            int64_t best = NEG_INF;
            bool any = false;
            const int32_t* qcol = col + (int64_t)(q * ncases) * 4;
            const int32_t* qsrc = src + q * ncases;
            const int32_t* qcst = cst + q * ncases;
            const int32_t* qm1 = m1c + q * ncases;
            const int32_t* qm2 = m2c + q * ncases;
            for (int c = 0; c < ncases; ++c) {
              const int a = qcol[c * 4 + 0], b = qcol[c * 4 + 1];
              const int cc = qcol[c * 4 + 2], dd = qcol[c * 4 + 3];
              const int pi = i - a, pj = j - b, pk = k - cc, pl = l - dd;
              if (pi < 0 || pj < 0 || pk < 0 || pl < 0) continue;
              if (iabs(pk - pi) > S || iabs(pl - pj) > S) continue;
              const int64_t val =
                  H[qsrc[c] * sq + pi * si + pj * sj +
                    (int64_t)(pk - pi + S) * W + (pl - pj + S)] +
                  qcst[c] + (int64_t)qm1[c] * mu1_ij +
                  (int64_t)qm2[c] * mu2_kl;
              if (!any || val > best) { best = val; any = true; }
            }
            H[q * sq + i * si + j * sj +
              (int64_t)(k - i + S) * W + (l - j + S)] =
                any ? best : NEG_INF;
          }
        }
      }
    }
  }
}

// Non-affine fill: single matrix, ncases columns (13).
// col[c][4], cst[c], m1c[c], m2c[c]; H: int64[(n+1)][(m+1)][W][W].
void bialign_nonaffine_fill(
    const int32_t* mu1, const int32_t* mu2, int n, int m, int S,
    const int32_t* col, const int32_t* cst, const int32_t* m1c,
    const int32_t* m2c, int ncases, int64_t* H) {
  const int W = 2 * S + 1;
  const int64_t sj = (int64_t)W * W;
  const int64_t si = (int64_t)(m + 1) * sj;
  const int64_t sm = m + 1;

  for (int i = 0; i <= n; ++i) {
    for (int j = 0; j <= m; ++j) {
      const int32_t mu1_ij = mu1[i * sm + j];
      const int klo = imax(0, i - S), khi = imin(n, i + S);
      const int llo = imax(0, j - S), lhi = imin(m, j + S);
      for (int k = klo; k <= khi; ++k) {
        for (int l = llo; l <= lhi; ++l) {
          if (i == 0 && j == 0 && k == 0 && l == 0) continue;  // stays 0
          const int32_t mu2_kl = mu2[k * sm + l];
          int64_t best = NEG_INF;
          bool any = false;
          for (int c = 0; c < ncases; ++c) {
            const int a = col[c * 4 + 0], b = col[c * 4 + 1];
            const int cc = col[c * 4 + 2], dd = col[c * 4 + 3];
            const int pi = i - a, pj = j - b, pk = k - cc, pl = l - dd;
            if (pi < 0 || pj < 0 || pk < 0 || pl < 0) continue;
            if (iabs(pk - pi) > S || iabs(pl - pj) > S) continue;
            const int64_t val =
                H[pi * si + pj * sj + (int64_t)(pk - pi + S) * W +
                  (pl - pj + S)] +
                cst[c] + (int64_t)m1c[c] * mu1_ij +
                (int64_t)m2c[c] * mu2_kl;
            if (!any || val > best) { best = val; any = true; }
          }
          H[i * si + j * sj + (int64_t)(k - i + S) * W + (l - j + S)] =
              any ? best : NEG_INF;
        }
      }
    }
  }
}

}  // extern "C"
