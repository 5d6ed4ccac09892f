// Native dense QP solver: OSQP-style ADMM in double precision.
//
// Plays the role the vendored OsqpEigen/libosqp solver plays in the
// reference (trajectory_planner/third_party/OsqpEigen, used by
// mpcPlanner::solveTraj): a CPU-side solver for
//     min 1/2 x'Px + q'x   s.t.  l <= Ax <= u       (P diagonal here —
// the Intent-MPC cost is diagonal, castMPCToQPHessian).
//
// Self-contained (no Eigen/BLAS): dense Cholesky + triangular solves.
// Algorithm identical to intent_mpc_tpu/oracle/numpy_ref.py:
// Ruiz equilibration + cost scaling, per-row rho (1e3x equality rows,
// 1e-6 loose rows), over-relaxed ADMM with adaptive rho.
//
// Exposed as a C ABI for ctypes (intent_mpc_tpu/oracle/native.py);
// build: g++ -O3 -march=native -shared -fPIC qp_solver.cpp -o libintentqp.so

#include <algorithm>
#include <thread>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Cholesky factorization in place (lower). Returns 0 on success.
int cholesky(std::vector<double>& M, int n) {
    for (int j = 0; j < n; ++j) {
        double d = M[j * n + j];
        for (int k = 0; k < j; ++k) d -= M[j * n + k] * M[j * n + k];
        if (d <= 0.0) return 1;
        const double s = std::sqrt(d);
        M[j * n + j] = s;
        const double inv = 1.0 / s;
        for (int i = j + 1; i < n; ++i) {
            double v = M[i * n + j];
            for (int k = 0; k < j; ++k) v -= M[i * n + k] * M[j * n + k];
            M[i * n + j] = v * inv;
        }
    }
    return 0;
}

// Solve L L^T x = b given lower-triangular L (from cholesky()).
void chol_solve(const std::vector<double>& L, int n, const double* b,
                double* x) {
    std::vector<double> w(n);
    for (int i = 0; i < n; ++i) {
        double v = b[i];
        for (int k = 0; k < i; ++k) v -= L[i * n + k] * w[k];
        w[i] = v / L[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {
        double v = w[i];
        for (int k = i + 1; k < n; ++k) v -= L[k * n + i] * x[k];
        x[i] = v / L[i * n + i];
    }
}

struct Work {
    int n, m;
    std::vector<double> Ah;   // scaled A, row-major (m x n)
    std::vector<double> Ph;   // scaled P diagonal (n)
    std::vector<double> qh, lh, uh, D, E;
    double c;
};

void ruiz(const double* h_diag, const double* q, const double* A,
          const double* l, const double* u, int n, int m, int iters, Work& w) {
    w.n = n; w.m = m; w.c = 1.0;
    w.Ah.assign(A, A + (size_t)m * n);
    w.Ph.assign(h_diag, h_diag + n);
    w.qh.assign(q, q + n);
    w.D.assign(n, 1.0);
    w.E.assign(m, 1.0);
    std::vector<double> cn(n), rn(m);
    for (int it = 0; it < iters; ++it) {
        for (int j = 0; j < n; ++j) cn[j] = std::fabs(w.Ph[j]);
        for (int i = 0; i < m; ++i)
            for (int j = 0; j < n; ++j) {
                const double a = std::fabs(w.Ah[(size_t)i * n + j]);
                if (a > cn[j]) cn[j] = a;
            }
        for (int j = 0; j < n; ++j) {
            const double dd = cn[j] > 1e-12 ? 1.0 / std::sqrt(cn[j]) : 1.0;
            w.Ph[j] *= dd * dd;
            w.qh[j] *= dd;
            w.D[j] *= dd;
            for (int i = 0; i < m; ++i) w.Ah[(size_t)i * n + j] *= dd;
        }
        for (int i = 0; i < m; ++i) {
            double r = 0.0;
            for (int j = 0; j < n; ++j) {
                const double a = std::fabs(w.Ah[(size_t)i * n + j]);
                if (a > r) r = a;
            }
            const double de = r > 1e-12 ? 1.0 / std::sqrt(r) : 1.0;
            w.E[i] *= de;
            for (int j = 0; j < n; ++j) w.Ah[(size_t)i * n + j] *= de;
        }
        double pmean = 0.0, qinf = 0.0;
        for (int j = 0; j < n; ++j) {
            pmean += std::fabs(w.Ph[j]);
            qinf = std::max(qinf, std::fabs(w.qh[j]));
        }
        pmean /= n;
        const double denom = std::max(pmean, qinf);
        const double g = denom > 1e-12 ? 1.0 / denom : 1.0;
        for (int j = 0; j < n; ++j) { w.Ph[j] *= g; w.qh[j] *= g; }
        w.c *= g;
    }
    w.lh.resize(m); w.uh.resize(m);
    for (int i = 0; i < m; ++i) { w.lh[i] = w.E[i] * l[i]; w.uh[i] = w.E[i] * u[i]; }
}

void make_rho(const Work& w, double r, std::vector<double>& rho) {
    rho.resize(w.m);
    for (int i = 0; i < w.m; ++i) {
        const bool eq = std::isfinite(w.lh[i]) && std::isfinite(w.uh[i]) &&
                        std::fabs(w.lh[i] - w.uh[i]) < 1e-12;
        const bool loose = w.lh[i] == -kInf && w.uh[i] == kInf;
        rho[i] = eq ? std::min(std::max(r * 1e3, 1e-6), 1e6)
                    : (loose ? 1e-6 : r);
    }
}

// M = diag(Ph) + sigma I + Ah^T diag(rho) Ah, factorized.
int factorize(const Work& w, const std::vector<double>& rho, double sigma,
              std::vector<double>& L) {
    const int n = w.n, m = w.m;
    L.assign((size_t)n * n, 0.0);
    for (int i = 0; i < m; ++i) {
        const double* ai = &w.Ah[(size_t)i * n];
        const double r = rho[i];
        for (int a = 0; a < n; ++a) {
            if (ai[a] == 0.0) continue;
            const double ra = r * ai[a];
            for (int b = a; b < n; ++b) L[(size_t)a * n + b] += ra * ai[b];
        }
    }
    for (int a = 0; a < n; ++a) {
        for (int b = a + 1; b < n; ++b)
            L[(size_t)b * n + a] = L[(size_t)a * n + b];
        L[(size_t)a * n + a] += w.Ph[a] + sigma;
    }
    return cholesky(L, n);
}

void matvec(const std::vector<double>& A, int m, int n, const double* x,
            double* out) {
    for (int i = 0; i < m; ++i) {
        const double* ai = &A[(size_t)i * n];
        double s = 0.0;
        for (int j = 0; j < n; ++j) s += ai[j] * x[j];
        out[i] = s;
    }
}

void tmatvec(const std::vector<double>& A, int m, int n, const double* y,
             double* out) {
    std::memset(out, 0, sizeof(double) * n);
    for (int i = 0; i < m; ++i) {
        const double yi = y[i];
        if (yi == 0.0) continue;
        const double* ai = &A[(size_t)i * n];
        for (int j = 0; j < n; ++j) out[j] += ai[j] * yi;
    }
}

}  // namespace

extern "C" {

// Returns 0 = solved (residuals < eps), 1 = max_iter reached, <0 = error.
// x0 may be NULL (cold start) or an unscaled primal warm start — the
// reference's OsqpEigen protocol: primal from the previous solution,
// dual zero (mpcPlanner.cpp:485-509).
int imt_solve_qp(int n, int m, const double* h_diag, const double* q,
                 const double* A, const double* l, const double* u,
                 double rho0, double sigma, double alpha, int max_iter,
                 double eps, int scaling, int adapt_interval,
                 double* x_out, double* y_out, int* iters_out,
                 const double* x0) {
    Work w;
    ruiz(h_diag, q, A, l, u, n, m, scaling, w);

    std::vector<double> rho;
    double r = rho0;
    make_rho(w, r, rho);
    std::vector<double> L;
    if (factorize(w, rho, sigma, L) != 0) return -1;

    std::vector<double> x(n, 0.0), z(m, 0.0), y(m, 0.0);
    std::vector<double> rhs(n), xt(n), zt(m), zrel(m), ax(m), aty(n), tmp(n);
    if (x0 != nullptr) {
        for (int j = 0; j < n; ++j) x[j] = x0[j] / w.D[j];
        matvec(w.Ah, m, n, x.data(), z.data());
    }
    int it = 0;
    int status = 1;
    for (it = 0; it < max_iter; ++it) {
        for (int i = 0; i < m; ++i) zt[i] = rho[i] * z[i] - y[i];
        tmatvec(w.Ah, m, n, zt.data(), rhs.data());
        for (int j = 0; j < n; ++j) rhs[j] += sigma * x[j] - w.qh[j];
        chol_solve(L, n, rhs.data(), xt.data());
        matvec(w.Ah, m, n, xt.data(), zt.data());
        for (int j = 0; j < n; ++j) x[j] = alpha * xt[j] + (1 - alpha) * x[j];
        for (int i = 0; i < m; ++i) {
            zrel[i] = alpha * zt[i] + (1 - alpha) * z[i];
            double zn = zrel[i] + y[i] / rho[i];
            if (zn < w.lh[i]) zn = w.lh[i];
            if (zn > w.uh[i]) zn = w.uh[i];
            y[i] += rho[i] * (zrel[i] - zn);
            z[i] = zn;
        }
        if ((it + 1) % adapt_interval == 0) {
            matvec(w.Ah, m, n, x.data(), ax.data());
            tmatvec(w.Ah, m, n, y.data(), aty.data());
            double prim = 0, dual = 0, axn = 0, zn = 0, pxn = 0, atyn = 0, qn = 0;
            for (int i = 0; i < m; ++i) {
                prim = std::max(prim, std::fabs(ax[i] - z[i]));
                axn = std::max(axn, std::fabs(ax[i]));
                zn = std::max(zn, std::fabs(z[i]));
            }
            for (int j = 0; j < n; ++j) {
                const double px = w.Ph[j] * x[j];
                dual = std::max(dual, std::fabs(px + w.qh[j] + aty[j]));
                pxn = std::max(pxn, std::fabs(px));
                atyn = std::max(atyn, std::fabs(aty[j]));
                qn = std::max(qn, std::fabs(w.qh[j]));
            }
            if (prim < eps && dual < eps) { status = 0; break; }
            const double prs = prim / std::max({axn, zn, 1e-10});
            const double drs = dual / std::max({pxn, atyn, qn, 1e-10});
            const double ratio = std::sqrt(prs / std::max(drs, 1e-12));
            if (ratio > 5.0 || ratio < 0.2) {
                r = std::min(std::max(r * ratio, 1e-6), 1e6);
                make_rho(w, r, rho);
                if (factorize(w, rho, sigma, L) != 0) return -1;
            }
        }
    }
    for (int j = 0; j < n; ++j) x_out[j] = w.D[j] * x[j];
    for (int i = 0; i < m; ++i) y_out[i] = w.E[i] * y[i] / w.c;
    if (iters_out) *iters_out = it + 1;
    return status;
}

// Batched entry: solve nprob independent problems (shared diagonal cost,
// per-problem q/A/l/u/x0) across std::thread workers — the native
// executor for oracle-in-the-loop runs, where the 6 intent-candidate
// QPs of every replan cycle were previously solved sequentially through
// ctypes (benchmark/oracle_loop.py). Arrays are C-contiguous stacks.
int imt_solve_qp_batch(int nprob, int n, int m, const double* h_diag,
                       const double* q, const double* A,
                       const double* l, const double* u,
                       double rho0, double sigma, double alpha,
                       int max_iter, double eps, int scaling,
                       int adapt_interval,
                       double* x_out, double* y_out,
                       int* status_out, int* iters_out,
                       const double* x0, int nthreads) {
    if (nthreads <= 0) {
        nthreads = (int)std::thread::hardware_concurrency();
        if (nthreads <= 0) nthreads = 1;
    }
    if (nthreads > nprob) nthreads = nprob;
    auto worker = [&](int t) {
        for (int p = t; p < nprob; p += nthreads) {
            const double* x0p = x0 ? x0 + (size_t)p * n : nullptr;
            status_out[p] = imt_solve_qp(
                n, m, h_diag, q + (size_t)p * n,
                A + (size_t)p * m * n, l + (size_t)p * m,
                u + (size_t)p * m, rho0, sigma, alpha, max_iter, eps,
                scaling, adapt_interval, x_out + (size_t)p * n,
                y_out + (size_t)p * m, iters_out + p, x0p);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker, t);
    worker(0);
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"
