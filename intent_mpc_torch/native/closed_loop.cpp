// Native C++ closed-loop runtime: the full Intent-MPC benchmark trial
// (world -> GT detector -> intent predictor -> 6-candidate QP planning ->
// scoring -> PID controller -> double-integrator plant -> DYNUS metrics)
// as one self-contained shared library, independent of JAX/Python.
//
// Role: the system-level f64 oracle. Component semantics are literal
// transcriptions of the same reference code the JAX framework rebuilds —
//   * world: dynus_obstacles_node.cpp:5-26,73-152 (std::mt19937 native
//     here; the JAX side reimplements it bit-exactly, utils/rng.py)
//   * detector: fakeDetector.cpp:138-258 (0.1 s FD gate), :525-553
//   * predictor: dynamicPredictor.cpp:163-567 (same loops as
//     oracle/predictor_ref.py, including the OOB-iteration skip)
//   * QP cast: mpcPlanner.cpp:891-1146 (same rows as
//     oracle/numpy_ref.build_reference_qp)
//   * candidates/scoring: mpcPlanner.cpp:663-887 with the same quirks
//     the JAX planner reproduces (sorted-position weight indexing,
//     accept-any-iterate)
//   * controller/monitor: trackingController.cpp:426-523 acc mode,
//     run_mpc_benchmark.py:52-593 metrics
// The QP solves use this library's own OSQP-style f64 ADMM
// (qp_solver.cpp, compiled into the same .so), one std::thread per
// candidate.
//
// Build (oracle/native.py does this automatically):
//   g++ -O3 -march=native -shared -fPIC -pthread \
//       qp_solver.cpp closed_loop.cpp -o libintentqp.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <random>
#include <thread>
#include <vector>

extern "C" int imt_solve_qp(int n, int m, const double* h_diag,
                            const double* q, const double* A,
                            const double* l, const double* u, double rho0,
                            double sigma, double alpha, int max_iter,
                            double eps, int scaling, int adapt_interval,
                            double* x_out, double* y_out, int* iters_out,
                            const double* x0);

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();
constexpr double kPi = 3.14159265358979323846;
constexpr int NX = 8, NU = 5;

struct Vec3 {
    double x = 0, y = 0, z = 0;
    Vec3() = default;
    Vec3(double a, double b, double c) : x(a), y(b), z(c) {}
    Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
    Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
    double norm() const { return std::sqrt(x * x + y * y + z * z); }
    double norm2d() const { return std::sqrt(x * x + y * y); }
};

double wrap_angle(double a) {
    while (a > kPi) a -= 2 * kPi;
    while (a <= -kPi) a += 2 * kPi;
    return a;
}

// ---------------------------------------------------------------------
// Benchmark configuration (the reference yaml defaults; mirrors
// utils/config.py field by field)
// ---------------------------------------------------------------------
struct Config {
    // planner (planner_param.yaml)
    int horizon = 30;
    double ts = 0.1;
    double y_lo = -5.0, y_hi = 5.0, z_lo = 0.5, z_hi = 4.5;
    double static_safety = 0.8, dynamic_safety = 1.5;
    double static_slack = 0.01, dynamic_slack = 0.2;
    double pos_w = 1000.0, vel_w = 0.0, acc_w = 10.0;
    double dummy_w[2] = {100.0, 1000.0};
    double slack_w[2] = {1.0, 1.0};
    double max_vel = 5.0, max_acc = 20.0;
    int max_obstacles = 64;
    int consistency_steps = 10;
    double direction_weight_a = 3.0;
    double max_ref_fwd_time = 3.0;
    // predictor (predictor_param.yaml + derived, dynamicPredictor.cpp:66-106)
    int num_pred = 30;
    double pdt = 0.1;
    double z_score = 0.674;
    double min_turn = 2.0, max_turn = 3.0;
    double max_front_prob = 0.5;
    double front_angle = 25.0 * kPi / 180.0;
    double stop_vel = 0.1;
    double pscale = 5.0;
    double fwd_angle_step = 0.1, fwd_speed_step = 0.1;
    double turn_speed_step = 0.2, turn_angvel_step = 0.2, turn_end_step = 0.2;
    // detector (fake_detector_param.yaml / mapping_param.yaml)
    int hist_size = 100;
    double sensor_range = 30.0;
    double robot_size[3] = {0.5, 0.5, 0.3};
    double fd_period = 0.1;
    // engine / monitor
    double control_dt = 0.01;
    int ticks_per_cycle = 10;
    double goal_dist = 0.5, goal_vel = 0.1, goal_stop = 0.3;
    double vlim = 5.0, alim = 20.0, jlim = 100.0, vtol = 1e-3;
    // controller (controller_param.yaml)
    double pp[3] = {2.0, 2.0, 1.8};
    double pi_[3] = {0.0, 0.0, 0.1};
    double vp[3] = {1.0, 1.0, 1.0};
    // solver protocol (converged-oracle semantics, as
    // benchmark/oracle_loop.py uses the native solver)
    int max_iter = 150;
    double eps = 1e-3;
    int adapt_interval = 50;
    int nthreads = 6;

    double param_l() const {
        return (1.0 - max_front_prob) / (3.0 * max_front_prob - 1.0);
    }
    double param_f() const {
        double fa = front_angle, pl = param_l();
        return std::sqrt(fa * fa
                         / (-2.0 * std::log(pl * (1.0 + std::sin(fa)) - pl)));
    }
    double param_s() const { return std::atanh(0.5) / stop_vel; }
    int W() const { return horizon - 1; }
    int nvars() const { return NX * horizon + NU * W(); }
};

// ---------------------------------------------------------------------
// World (dynus_obstacles_node.cpp:73-152; draw order matches
// models/world.generate_scenario)
// ---------------------------------------------------------------------
struct World {
    int n = 0;
    std::vector<Vec3> origin, scale, bbox;
    std::vector<double> offset, slower;
    std::vector<uint8_t> is_static;
};

World gen_world(uint32_t seed, int n, double dyn_ratio) {
    std::mt19937 rng(seed);
    auto uni = [&](double lo, double hi) {
        return std::uniform_real_distribution<double>(lo, hi)(rng);
    };
    World w;
    w.n = n;
    w.origin.resize(n); w.scale.resize(n); w.bbox.resize(n);
    w.offset.assign(n, 0.0); w.slower.assign(n, 0.0);
    w.is_static.assign(n, 0);
    int num_dyn = (int)(n * dyn_ratio);
    int num_static = n - num_dyn;
    for (int i = 0; i < n; ++i) {
        bool st = i >= num_dyn;
        double x = uni(5.0, 105.0);
        double y = uni(-15.0, 15.0);
        double z = uni(0.0, 7.0);
        if (st) {
            int si = i - num_dyn;
            bool vert = si < num_static * 0.35;
            if (vert) { w.bbox[i] = {0.4, 0.4, 4.0}; z = 2.0; }
            else      { w.bbox[i] = {0.4, 4.0, 0.4}; }
            w.origin[i] = {x, y, z};
            w.is_static[i] = 1;
        } else {
            w.bbox[i] = {0.8, 0.8, 0.8};
            w.origin[i] = {x, y, z};
            w.scale[i] = {uni(2.0, 4.0), uni(2.0, 4.0), uni(2.0, 4.0)};
            w.offset[i] = uni(0.0, 3.0);
            w.slower[i] = uni(4.0, 6.0);
        }
    }
    return w;
}

void obstacle_state(const World& w, double t, std::vector<Vec3>& pos) {
    pos.resize(w.n);
    for (int i = 0; i < w.n; ++i) {
        if (w.is_static[i]) { pos[i] = w.origin[i]; continue; }
        double tt = t / w.slower[i] + w.offset[i];
        pos[i] = {
            (w.scale[i].x / 6.0) * (std::sin(tt) + 2.0 * std::sin(2.0 * tt))
                + w.origin[i].x,
            (w.scale[i].y / 5.0) * (std::cos(tt) - 2.0 * std::cos(2.0 * tt))
                + w.origin[i].y,
            (w.scale[i].z / 2.0) * (-std::sin(3.0 * tt)) + w.origin[i].z};
    }
}

// ---------------------------------------------------------------------
// GT detector (fakeDetector.cpp; mirrors models/detector.py)
// ---------------------------------------------------------------------
struct Detector {
    int n = 0, hh = 0, hist_len = 0;
    // ring buffers, newest at index 0: [obstacle][slot]
    std::vector<std::vector<Vec3>> pos_hist, vel_hist;
    std::vector<Vec3> last_pos, vel, acc;
    double last_fd_time = 0.0;
};

Detector detector_init(const Config& c, const std::vector<Vec3>& pos0) {
    Detector d;
    d.n = (int)pos0.size();
    d.hh = c.hist_size;
    d.pos_hist.assign(d.n, std::vector<Vec3>(d.hh));
    d.vel_hist.assign(d.n, std::vector<Vec3>(d.hh));
    d.last_pos = pos0;
    d.vel.assign(d.n, Vec3());
    d.acc.assign(d.n, Vec3());
    return d;
}

void fd_update(const Config& c, Detector& d, const std::vector<Vec3>& p,
               double t) {
    double dT = t - d.last_fd_time;
    if (dT < c.fd_period - 1e-9) return;
    for (int i = 0; i < d.n; ++i) {
        Vec3 v = (p[i] - d.last_pos[i]) * (1.0 / std::max(dT, 1e-9));
        d.acc[i] = (v - d.vel[i]) * (1.0 / std::max(dT, 1e-9));
        d.vel[i] = v;
        d.last_pos[i] = p[i];
    }
    d.last_fd_time = t;
}

void hist_push(Detector& d, const std::vector<Vec3>& p) {
    for (int i = 0; i < d.n; ++i) {
        auto& ph = d.pos_hist[i];
        auto& vh = d.vel_hist[i];
        for (int k = d.hh - 1; k > 0; --k) { ph[k] = ph[k - 1]; vh[k] = vh[k - 1]; }
        ph[0] = p[i];
        vh[0] = d.vel[i];
    }
    d.hist_len = std::min(d.hist_len + 1, d.hh);
}

// ---------------------------------------------------------------------
// Intent predictor (dynamicPredictor.cpp; loops as in
// oracle/predictor_ref.py; empty-map benchmark: occupancy always free)
// ---------------------------------------------------------------------
void transition_vector(const Config& c, double theta, double r,
                       const double scale[4], double out[4]) {
    double pf = scale[0] * (std::exp(-0.5 * std::pow(theta / c.param_f(), 2))
                            + c.param_l());
    double pl = scale[1] * (c.param_l() * (1.0 + std::sin(theta)));
    double pr = scale[2] * (c.param_l() * (1.0 - std::sin(theta)));
    double ps = 1.0 - std::tanh(c.param_s() / scale[3] * r);
    double s = pr + pl + pf;
    out[0] = (1 - ps) * pf / s;  // FORWARD
    out[1] = (1 - ps) * pl / s;  // LEFT
    out[2] = (1 - ps) * pr / s;  // RIGHT
    out[3] = ps;                 // STOP
}

// intent probabilities over one obstacle's newest-first history
// (models/predictor.intent_probabilities semantics: transitions
// k in [0, len-4], folded oldest-to-newest)
void intent_prob(const Config& c, const std::vector<Vec3>& ph,
                 const std::vector<Vec3>& vh, int len, double P[4]) {
    P[0] = P[1] = P[2] = P[3] = 0.25;
    if (len < 4) return;
    for (int k = len - 4; k >= 0; --k) {
        Vec3 s_new = ph[k] - ph[k + 1];     // newer segment
        Vec3 s_old = ph[k + 1] - ph[k + 2];
        double theta = wrap_angle(std::atan2(s_new.y, s_new.x)
                                  - std::atan2(s_old.y, s_old.x));
        double r = vh[k].norm2d();
        double T[4][4];
        for (int i = 0; i < 4; ++i) {
            double scale[4] = {1, 1, 1, 1};
            scale[i] = c.pscale;
            double col[4];
            transition_vector(c, theta, r, scale, col);
            for (int j = 0; j < 4; ++j) T[j][i] = col[j];
        }
        double Pn[4];
        for (int i = 0; i < 4; ++i) {
            Pn[i] = 0;
            for (int j = 0; j < 4; ++j) Pn[i] += T[i][j] * P[j];
        }
        std::memcpy(P, Pn, sizeof(Pn));
    }
}

struct ObstaclePrediction {
    // [intent][step 0..num_pred] mean position + inflated size
    std::vector<Vec3> pos[4], size[4];
    double prob[4];
};

void stop_model(const Config& c, const Vec3& p0, const Vec3& v0,
                const Vec3& s0, std::vector<Vec3>& pos,
                std::vector<Vec3>& size) {
    double v = std::min(v0.norm2d(), c.stop_vel);
    pos.assign(c.num_pred + 1, p0);
    size.resize(c.num_pred + 1);
    Vec3 s = s0;
    for (int i = 0; i <= c.num_pred; ++i) {
        size[i] = s;
        s.x += 2 * v * c.pdt;
        s.y += 2 * v * c.pdt;
    }
}

// mean + z-inflated size over sample trajectories (genTraj :503-538;
// empty map -> no positionCorrection)
void aggregate(const Config& c, const std::vector<std::vector<Vec3>>& trajs,
               const Vec3& p0, const Vec3& s0, std::vector<Vec3>& pos,
               std::vector<Vec3>& size) {
    int P = c.num_pred;
    pos.resize(P + 1);
    size.assign(P + 1, s0);
    int n = (int)trajs.size();
    for (int i = 0; i <= P; ++i) {
        double mx = 0, my = 0;
        for (const auto& t : trajs) { mx += t[i].x; my += t[i].y; }
        mx /= n; my /= n;
        double vx = 0, vy = 0;
        for (const auto& t : trajs) {
            vx += (t[i].x - mx) * (t[i].x - mx);
            vy += (t[i].y - my) * (t[i].y - my);
        }
        vx /= n; vy /= n;
        pos[i] = {mx, my, p0.z};
        size[i].x += 2 * std::sqrt(vx) * c.z_score;
        size[i].y += 2 * std::sqrt(vy) * c.z_score;
    }
}

void forward_model(const Config& c, const Vec3& p0, const Vec3& v0,
                   std::vector<std::vector<Vec3>>& out) {
    double vel = v0.norm2d();
    double ai = std::atan2(v0.y, v0.x);
    for (double i = ai - c.front_angle; i < ai + c.front_angle;
         i += c.fwd_angle_step) {
        for (double j = 0.0; j < 2 * vel; j += c.fwd_speed_step) {
            std::vector<Vec3> traj(c.num_pred + 1);
            traj[0] = p0;
            double x = p0.x, y = p0.y;
            double vx = j * std::cos(i), vy = j * std::sin(i);
            for (int k = 1; k <= c.num_pred; ++k) {
                x += vx * c.pdt;
                y += vy * c.pdt;
                traj[k] = {x, y, p0.z};
            }
            out.push_back(std::move(traj));
        }
    }
}

void turning_model(const Config& c, int intent, const Vec3& p0,
                   const Vec3& v0, std::vector<std::vector<Vec3>>& out) {
    double vel = v0.norm2d();
    double ai = std::atan2(v0.y, v0.x);
    double end_min, end_max, w_min, w_max;
    if (intent == 1) {  // LEFT
        end_min = c.front_angle + ai;
        end_max = (kPi - c.front_angle) + ai;
        w_min = (kPi / 2) / c.max_turn;
        w_max = (kPi / 2) / c.min_turn;
    } else {            // RIGHT
        end_min = -(kPi - c.front_angle) + ai;
        end_max = -c.front_angle + ai;
        w_min = (-kPi / 2) / c.min_turn;
        w_max = (-kPi / 2) / c.max_turn;
    }
    for (double i = 0.0; i < 2 * vel; i += c.turn_speed_step) {
        for (double j = w_min; j < w_max; j += c.turn_angvel_step) {
            for (double end = end_min; end < end_max; end += c.turn_end_step) {
                std::vector<Vec3> traj(c.num_pred + 1);
                traj[0] = p0;
                double angle = ai;
                double x = p0.x, y = p0.y;
                double vx = i * std::cos(angle), vy = i * std::sin(angle);
                for (int k = 1; k <= c.num_pred; ++k) {
                    x += vx * c.pdt;
                    y += vy * c.pdt;
                    traj[k] = {x, y, p0.z};
                    angle += j * c.pdt;
                    angle = (intent == 1) ? std::min(angle, end)
                                          : std::max(angle, end);
                    double v = std::hypot(vx, vy);
                    vx = v * std::cos(angle);
                    vy = v * std::sin(angle);
                }
                out.push_back(std::move(traj));
            }
        }
    }
}

void predict_obstacle(const Config& c, const Vec3& p0, const Vec3& v0,
                      const Vec3& s0, ObstaclePrediction& op) {
    double vel = v0.norm2d();
    for (int intent = 0; intent < 4; ++intent) {
        if (vel <= c.stop_vel || intent == 3) {
            stop_model(c, p0, v0, s0, op.pos[intent], op.size[intent]);
            continue;
        }
        std::vector<std::vector<Vec3>> trajs;
        if (intent == 0) forward_model(c, p0, v0, trajs);
        else turning_model(c, intent, p0, v0, trajs);
        if (!trajs.empty())
            aggregate(c, trajs, p0, s0, op.pos[intent], op.size[intent]);
        else
            stop_model(c, p0, v0, s0, op.pos[intent], op.size[intent]);
    }
}

}  // namespace

#include "closed_loop_engine.inc"
