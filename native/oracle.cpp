// f64 reference-semantics END-TO-END ORACLE for score-level parity.
//
// Re-implements, in double precision and the reference's algorithmic
// structure, the four stages of the LIA_RAL speaker-verification chain
// that the JAX pipeline runs in f32/bf16 — so the pipeline's accuracy
// can be measured as "EER delta / score deviation vs the reference's
// math" (the BASELINE.md north star), not just against itself:
//
//   em    — GMM-UBM EM with variance floor/ceil schedule
//           (LIA_SpkTools/src/AccumulateStat.cpp:103-152 accumulate,
//            TrainTools.cpp:993-1028 trainModel loop,
//            TrainTools.cpp:560-592 setItParameter + varianceControl)
//   map   — MAPOccDep mean adaptation, iterated EM-then-combine
//           (TrainTools.cpp:871-905 adaptModel, cpp:445-490 occDep MAP)
//   score — top-K GMM LLR trial scoring with the world-residual
//           completion (LIA_SpkDet/ComputeTest/src/ComputeTest.cpp:90-224,
//            DETERMINE_TOP_DISTRIBS/USE_TOP_DISTRIBS at 163-167; ALIZE
//            LKVector sumNonTopDistribLK semantics)
//   ivec  — Baum-Welch (N,F) stats + exact i-vector extraction
//           (AccumulateTVStat.cpp:281-351 stats; 766 estimateTETt;
//            2103-2267 estimateW: L = I + Σ_c n_c·TΣ⁻¹Tᵀ_c, w = L⁻¹TᵀΣ⁻¹F̄)
//
// This file shares NO code with ALIZE/LIA_RAL; it re-derives the
// arithmetic from the algorithm definitions cited above (same policy as
// em_baseline.cpp / iv_baseline.cpp, whose loops it extends).
//
// I/O: every array is a little-endian binary file
//   [int64 ndim][int64 dims[ndim]][float64 data, C order]
// written/read by scripts/oracle_parity.py.  A GMM model file is one
// (K, 2*D+1) array: row k = [weight_k, mean_k (D), cov_k (D)]
// (variances, not inverses).
//
// Build: see native/Makefile (g++ -O3 -march=native; NO -ffast-math —
// the oracle must be the numerically careful side of the comparison).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <string>
#include <thread>
#include <vector>

namespace {

using std::size_t;

struct Arr {
  std::vector<int64_t> dims;
  std::vector<double> data;
  int64_t dim(int i) const { return dims[i]; }
  int64_t size() const {
    int64_t s = 1;
    for (auto d : dims) s *= d;
    return s;
  }
};

Arr read_arr(const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(2); }
  int64_t nd = 0;
  if (fread(&nd, 8, 1, f) != 1 || nd < 0 || nd > 8) {
    fprintf(stderr, "bad header %s\n", path); exit(2);
  }
  Arr a;
  a.dims.resize(nd);
  if (nd && fread(a.dims.data(), 8, nd, f) != (size_t)nd) {
    fprintf(stderr, "bad dims %s\n", path); exit(2);
  }
  a.data.resize(a.size());
  if (fread(a.data.data(), 8, a.size(), f) != (size_t)a.size()) {
    fprintf(stderr, "short data %s\n", path); exit(2);
  }
  fclose(f);
  return a;
}

void write_arr(const char *path, const std::vector<int64_t> &dims,
               const std::vector<double> &data) {
  FILE *f = fopen(path, "wb");
  if (!f) { fprintf(stderr, "cannot write %s\n", path); exit(2); }
  int64_t nd = dims.size();
  fwrite(&nd, 8, 1, f);
  fwrite(dims.data(), 8, nd, f);
  fwrite(data.data(), 8, data.size(), f);
  fclose(f);
}

struct Gmm {             // (K, 2D+1) rows = [w, mean(D), cov(D)]
  int64_t K, D;
  std::vector<double> w, mu, cov;   // cov = variances (diagonal)
  std::vector<double> ci, lcst;     // derived: 1/cov, log-constant
  void derive() {
    ci.resize(K * D);
    lcst.resize(K);
    const double log2pi = std::log(2.0 * M_PI);
    for (int64_t k = 0; k < K; k++) {
      double ld = 0.0;
      for (int64_t d = 0; d < D; d++) {
        ci[k * D + d] = 1.0 / cov[k * D + d];
        ld += std::log(cov[k * D + d]);
      }
      lcst[k] = -0.5 * (D * log2pi + ld);
    }
  }
};

Gmm load_gmm(const char *path) {
  Arr a = read_arr(path);
  Gmm g;
  g.K = a.dim(0);
  g.D = (a.dim(1) - 1) / 2;
  g.w.resize(g.K); g.mu.resize(g.K * g.D); g.cov.resize(g.K * g.D);
  for (int64_t k = 0; k < g.K; k++) {
    const double *row = &a.data[k * a.dim(1)];
    g.w[k] = row[0];
    std::memcpy(&g.mu[k * g.D], row + 1, g.D * 8);
    std::memcpy(&g.cov[k * g.D], row + 1 + g.D, g.D * 8);
  }
  g.derive();
  return g;
}

void save_gmm(const char *path, const Gmm &g) {
  std::vector<double> out(g.K * (2 * g.D + 1));
  for (int64_t k = 0; k < g.K; k++) {
    double *row = &out[k * (2 * g.D + 1)];
    row[0] = g.w[k];
    std::memcpy(row + 1, &g.mu[k * g.D], g.D * 8);
    std::memcpy(row + 1 + g.D, &g.cov[k * g.D], g.D * 8);
  }
  write_arr(path, {g.K, 2 * g.D + 1}, out);
}

// per-frame weighted log-densities log(w_k) + lcst_k - 0.5*maha —
// the scalar loop of AccumulateStat.cpp:103-152 in log domain
void logdens_frame(const double *x, const Gmm &g, double *out) {
  for (int64_t k = 0; k < g.K; k++) {
    const double *m = &g.mu[k * g.D];
    const double *c = &g.ci[k * g.D];
    double e = 0.0;
    for (int64_t d = 0; d < g.D; d++) {
      double t = x[d] - m[d];
      e += t * t * c[d];
    }
    out[k] = std::log(g.w[k]) + g.lcst[k] - 0.5 * e;
  }
}

double logsumexp(const double *v, int64_t n) {
  double mx = v[0];
  for (int64_t i = 1; i < n; i++) mx = std::max(mx, v[i]);
  double s = 0.0;
  for (int64_t i = 0; i < n; i++) s += std::exp(v[i] - mx);
  return mx + std::log(s);
}

struct EmAcc {
  std::vector<double> occ, sx, sxx;
  double llk = 0.0, count = 0.0;
  EmAcc(int64_t K, int64_t D)
      : occ(K, 0.0), sx(K * D, 0.0), sxx(K * D, 0.0) {}
  void merge(const EmAcc &o) {    // addAccEM (AccumulateStat.cpp:289)
    for (size_t i = 0; i < occ.size(); i++) occ[i] += o.occ[i];
    for (size_t i = 0; i < sx.size(); i++) sx[i] += o.sx[i];
    for (size_t i = 0; i < sxx.size(); i++) sxx[i] += o.sxx[i];
    llk += o.llk;
    count += o.count;
  }
};

void em_accumulate_range(const double *x, int64_t n0, int64_t n1,
                         const Gmm &g, EmAcc *acc) {
  std::vector<double> ld(g.K);
  for (int64_t n = n0; n < n1; n++) {
    const double *f = x + n * g.D;
    logdens_frame(f, g, ld.data());
    double lse = logsumexp(ld.data(), g.K);
    acc->llk += lse;
    acc->count += 1.0;
    for (int64_t k = 0; k < g.K; k++) {
      double p = std::exp(ld[k] - lse);
      acc->occ[k] += p;
      double *sx = &acc->sx[k * g.D];
      double *sxx = &acc->sxx[k * g.D];
      for (int64_t d = 0; d < g.D; d++) {
        double xd = f[d];
        sx[d] += p * xd;
        sxx[d] += p * xd * xd;
      }
    }
  }
}

EmAcc em_accumulate(const double *x, int64_t n, const Gmm &g, int threads) {
  // accumulateStatEMThreaded (cpp:234-299): split frames, merge accs
  std::vector<EmAcc> accs(threads, EmAcc(g.K, g.D));
  std::vector<std::thread> pool;
  int64_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; t++) {
    int64_t a = t * per, b = std::min<int64_t>(a + per, n);
    if (a < b)
      pool.emplace_back(em_accumulate_range, x, a, b, std::cref(g),
                        &accs[t]);
  }
  for (auto &th : pool) th.join();
  for (int t = 1; t < threads; t++) accs[0].merge(accs[t]);
  return std::move(accs[0]);
}

Gmm m_step(const EmAcc &acc, int64_t K, int64_t D) {
  // closed-form getEM (ALIZE MixtureStat::getEM semantics; mirrors
  // lia_ral/gmm/em.py m_step including its guards)
  Gmm g;
  g.K = K; g.D = D;
  g.w.resize(K); g.mu.resize(K * D); g.cov.resize(K * D);
  double wsum = 0.0;
  for (int64_t k = 0; k < K; k++) wsum += acc.occ[k];
  for (int64_t k = 0; k < K; k++) {
    double occ = std::max(acc.occ[k], 1e-6);
    for (int64_t d = 0; d < D; d++) {
      double m = acc.sx[k * D + d] / occ;
      g.mu[k * D + d] = m;
      g.cov[k * D + d] =
          std::max(acc.sxx[k * D + d] / occ - m * m, 1e-8);
    }
    g.w[k] = wsum > 0 ? acc.occ[k] / acc.count / (wsum / acc.count)
                      : 1.0 / K;
  }
  g.derive();
  return g;
}

double schedule(double begin, double end, int nb_it, int it) {
  // setItParameter (TrainTools.cpp:560-564)
  if (nb_it < 2) return begin;
  return begin - (begin - end) / (nb_it - 1) * it;
}

void variance_control(Gmm &g, double floor, double ceil,
                      const std::vector<double> &gcov) {
  // varianceControl (TrainTools.cpp:567-592)
  for (int64_t k = 0; k < g.K; k++)
    for (int64_t d = 0; d < g.D; d++) {
      double lo = floor * gcov[d], hi = ceil * gcov[d];
      g.cov[k * g.D + d] =
          std::min(std::max(g.cov[k * g.D + d], lo), hi);
    }
  g.derive();
}

// ---------------------------------------------------------------- em ----
int cmd_em(int argc, char **argv) {
  // em feats.bin init_model.bin nbIt fI fF cI cF threads out_model.bin
  if (argc < 9) { fprintf(stderr, "em: bad args\n"); return 2; }
  Arr x = read_arr(argv[0]);
  Gmm g = load_gmm(argv[1]);
  int nb_it = atoi(argv[2]);
  double fI = atof(argv[3]), fF = atof(argv[4]);
  double cI = atof(argv[5]), cF = atof(argv[6]);
  int threads = atoi(argv[7]);
  int64_t n = x.dim(0);
  // global data variance (computeMeanCov, TrainTools.cpp:593)
  std::vector<double> gmean(g.D, 0.0), gcov(g.D, 0.0);
  for (int64_t i = 0; i < n; i++)
    for (int64_t d = 0; d < g.D; d++) gmean[d] += x.data[i * g.D + d];
  for (int64_t d = 0; d < g.D; d++) gmean[d] /= n;
  for (int64_t i = 0; i < n; i++)
    for (int64_t d = 0; d < g.D; d++) {
      double t = x.data[i * g.D + d] - gmean[d];
      gcov[d] += t * t;
    }
  for (int64_t d = 0; d < g.D; d++) gcov[d] /= n;

  for (int it = 0; it < nb_it; it++) {
    EmAcc acc = em_accumulate(x.data.data(), n, g, threads);
    g = m_step(acc, g.K, g.D);
    variance_control(g, schedule(fI, fF, nb_it, it),
                     schedule(cI, cF, nb_it, it), gcov);
    fprintf(stderr, "em it %d mean_llk %.6f\n", it, acc.llk / acc.count);
  }
  save_gmm(argv[8], g);
  return 0;
}

// --------------------------------------------------------------- map ----
int cmd_map(int argc, char **argv) {
  // map feats.bin world.bin r nbIt threads out_model.bin
  if (argc < 6) { fprintf(stderr, "map: bad args\n"); return 2; }
  Arr x = read_arr(argv[0]);
  Gmm world = load_gmm(argv[1]);
  double r = atof(argv[2]);
  int nb_it = atoi(argv[3]);
  int threads = atoi(argv[4]);
  int64_t n = x.dim(0);
  Gmm client = world;
  for (int it = 0; it < nb_it; it++) {
    // adaptModel (TrainTools.cpp:871-905): EM stats with CURRENT
    // client, occDep MAP combine with the WORLD prior (cpp:445-490)
    EmAcc acc = em_accumulate(x.data.data(), n, client, threads);
    Gmm em = m_step(acc, world.K, world.D);
    for (int64_t k = 0; k < world.K; k++) {
      double occ = em.w[k] * acc.count;     // weights*frame_count
      double a = occ / (occ + r);
      for (int64_t d = 0; d < world.D; d++)
        client.mu[k * world.D + d] =
            (1.0 - a) * world.mu[k * world.D + d]
            + a * em.mu[k * world.D + d];
    }
    client.derive();
  }
  save_gmm(argv[5], client);
  return 0;
}

// ------------------------------------------------------------- score ----
int cmd_score(int argc, char **argv) {
  // score world.bin clients.bin feats.bin offsets.bin topK out_llr.bin
  //   clients.bin: (C, K, 2D+1) stacked models
  //   offsets.bin: (U+1,) frame offsets of each test file
  // out: (U, C) LLR matrix — client meanLLK − world meanLLK
  if (argc < 6) { fprintf(stderr, "score: bad args\n"); return 2; }
  Gmm world = load_gmm(argv[0]);
  Arr ca = read_arr(argv[1]);
  Arr x = read_arr(argv[2]);
  Arr off = read_arr(argv[3]);
  int top_k = atoi(argv[4]);
  int64_t C = ca.dim(0), K = world.K, D = world.D;
  int64_t U = off.size() - 1;
  std::vector<Gmm> clients(C);
  for (int64_t c = 0; c < C; c++) {
    Gmm g;
    g.K = K; g.D = D;
    g.w.resize(K); g.mu.resize(K * D); g.cov.resize(K * D);
    for (int64_t k = 0; k < K; k++) {
      const double *row = &ca.data[(c * K + k) * (2 * D + 1)];
      g.w[k] = row[0];
      std::memcpy(&g.mu[k * D], row + 1, D * 8);
      std::memcpy(&g.cov[k * D], row + 1 + D, D * 8);
    }
    g.derive();
    clients[c] = std::move(g);
  }
  if (top_k > K) top_k = K;
  std::vector<double> out(U * C, 0.0);
  std::vector<double> wld(K), cld(K);
  std::vector<int> idx(K);
  for (int64_t u = 0; u < U; u++) {
    int64_t f0 = (int64_t)off.data[u], f1 = (int64_t)off.data[u + 1];
    double wsum = 0.0;
    std::vector<double> csum(C, 0.0);
    for (int64_t t = f0; t < f1; t++) {
      const double *f = &x.data[t * D];
      // DETERMINE pass (worldDecime=1: every frame, ComputeTest.cpp:
      // 163-165): full world llk + its top-K set + non-top residual
      logdens_frame(f, world, wld.data());
      double full = logsumexp(wld.data(), K);
      wsum += full;                     // world takes the FULL llk on
                                        // determine frames
      for (int64_t k = 0; k < K; k++) idx[k] = (int)k;
      std::partial_sort(idx.begin(), idx.begin() + top_k, idx.end(),
                        [&](int a, int b) { return wld[a] > wld[b]; });
      // residual = log(exp(full) − exp(lse(top))) — ALIZE
      // sumNonTopDistribLK; stable form matches gmm/scoring.py
      std::vector<double> topv(top_k);
      for (int k = 0; k < top_k; k++) topv[k] = wld[idx[k]];
      double top_lse = logsumexp(topv.data(), top_k);
      double diff = std::min(top_lse - full, -1e-7);
      double residual = full + std::log1p(-std::exp(diff));
      // USE pass per client (ComputeTest.cpp:167): own densities on
      // the world's top set, completed by the world residual
      for (int64_t c = 0; c < C; c++) {
        logdens_frame(f, clients[c], cld.data());
        std::vector<double> sel(top_k + 1);
        for (int k = 0; k < top_k; k++) sel[k] = cld[idx[k]];
        sel[top_k] = residual;
        csum[c] += logsumexp(sel.data(), top_k + 1);
      }
    }
    double nf = (double)(f1 - f0);
    for (int64_t c = 0; c < C; c++)
      out[u * C + c] = csum[c] / nf - wsum / nf;
  }
  write_arr(argv[5], {U, C}, out);
  return 0;
}

// -------------------------------------------------------------- ivec ----
int cmd_ivec(int argc, char **argv) {
  // ivec ubm.bin T.bin tvmean.bin feats.bin offsets.bin out_w.bin
  //   T.bin: (R, K, D); tvmean.bin: (K, D) — the min-divergence mean
  //   estimate the pipeline centres F̄ on (meanEstimate)
  // out: (U, R) i-vectors
  if (argc < 6) { fprintf(stderr, "ivec: bad args\n"); return 2; }
  Gmm ubm = load_gmm(argv[0]);
  Arr T = read_arr(argv[1]);
  Arr tvm = read_arr(argv[2]);
  Arr x = read_arr(argv[3]);
  Arr off = read_arr(argv[4]);
  int64_t K = ubm.K, D = ubm.D, R = T.dim(0);
  int64_t U = off.size() - 1;

  // E_k = T_k Σ_k⁻¹ T_kᵀ per component (estimateTETt, cpp:766)
  std::vector<double> E(K * R * R);
  for (int64_t k = 0; k < K; k++) {
    double *Ek = &E[k * R * R];
    const double *ck = &ubm.ci[k * D];
    for (int64_t i = 0; i < R; i++) {
      const double *Ti = &T.data[(i * K + k) * D];
      for (int64_t j = 0; j <= i; j++) {
        const double *Tj = &T.data[(j * K + k) * D];
        double s = 0.0;
        for (int64_t d = 0; d < D; d++) s += Ti[d] * ck[d] * Tj[d];
        Ek[i * R + j] = s;
        Ek[j * R + i] = s;
      }
    }
  }

  std::vector<double> out(U * R, 0.0);
  std::vector<double> ld(K), nk(K), fk(K * D), L(R * R), aux(R), y(R);
  for (int64_t u = 0; u < U; u++) {
    int64_t f0 = (int64_t)off.data[u], f1 = (int64_t)off.data[u + 1];
    // BW stats: N_k, F_k (computeAndAccumulateTVStat, cpp:332-349)
    std::fill(nk.begin(), nk.end(), 0.0);
    std::fill(fk.begin(), fk.end(), 0.0);
    for (int64_t t = f0; t < f1; t++) {
      const double *f = &x.data[t * D];
      logdens_frame(f, ubm, ld.data());
      double lse = logsumexp(ld.data(), K);
      for (int64_t k = 0; k < K; k++) {
        double p = std::exp(ld[k] - lse);
        nk[k] += p;
        for (int64_t d = 0; d < D; d++) fk[k * D + d] += p * f[d];
      }
    }
    // F̄ = F − N·m (substractM, cpp:1078; m = the TV mean estimate)
    for (int64_t k = 0; k < K; k++)
      for (int64_t d = 0; d < D; d++)
        fk[k * D + d] -= nk[k] * tvm.data[k * D + d];
    // aux = T Σ⁻¹ F̄;  L = I + Σ_k n_k E_k  (estimateW, cpp:2103-2267)
    for (int64_t i = 0; i < R; i++) {
      double s = 0.0;
      for (int64_t k = 0; k < K; k++) {
        const double *Ti = &T.data[(i * K + k) * D];
        const double *ck = &ubm.ci[k * D];
        const double *Fk = &fk[k * D];
        for (int64_t d = 0; d < D; d++) s += Ti[d] * ck[d] * Fk[d];
      }
      aux[i] = s;
    }
    for (int64_t i = 0; i < R; i++)
      for (int64_t j = 0; j <= i; j++)
        L[i * R + j] = (i == j) ? 1.0 : 0.0;
    for (int64_t k = 0; k < K; k++) {
      const double *Ek = &E[k * R * R];
      double n = nk[k];
      for (int64_t i = 0; i < R; i++)
        for (int64_t j = 0; j <= i; j++)
          L[i * R + j] += n * Ek[i * R + j];
    }
    // Cholesky solve (upperCholesky in the reference, cpp:1745)
    for (int64_t i = 0; i < R; i++) {
      for (int64_t j = 0; j < i; j++) {
        double s = L[i * R + j];
        for (int64_t t = 0; t < j; t++) s -= L[i * R + t] * L[j * R + t];
        L[i * R + j] = s / L[j * R + j];
      }
      double s = L[i * R + i];
      for (int64_t t = 0; t < i; t++) s -= L[i * R + t] * L[i * R + t];
      L[i * R + i] = std::sqrt(std::max(s, 1e-12));
    }
    for (int64_t i = 0; i < R; i++) {
      double s = aux[i];
      for (int64_t t = 0; t < i; t++) s -= L[i * R + t] * y[t];
      y[i] = s / L[i * R + i];
    }
    double *wu = &out[u * R];
    for (int64_t i = R - 1; i >= 0; i--) {
      double s = y[i];
      for (int64_t t = i + 1; t < R; t++) s -= L[t * R + i] * wu[t];
      wu[i] = s / L[i * R + i];
    }
  }
  write_arr(argv[5], {U, R}, out);
  return 0;
}

}  // namespace

int main(int argc, char **argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: oracle em|map|score|ivec args...\n");
    return 2;
  }
  std::string cmd = argv[1];
  if (cmd == "em") return cmd_em(argc - 2, argv + 2);
  if (cmd == "map") return cmd_map(argc - 2, argv + 2);
  if (cmd == "score") return cmd_score(argc - 2, argv + 2);
  if (cmd == "ivec") return cmd_ivec(argc - 2, argv + 2);
  fprintf(stderr, "unknown subcommand %s\n", cmd.c_str());
  return 2;
}
