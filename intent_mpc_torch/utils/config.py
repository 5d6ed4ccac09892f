"""Configuration dataclasses for the PyTorch port of Intent-MPC.

A copy of the JAX reference's `intent_mpc_tpu/utils/config.py`: every
field and default is the same, except `SolverConfig.ew_kernel` (see
there). The port keeps its own copy so that it never imports the JAX
package. Default values mirror the reference benchmark configuration
(`autonomous_flight/cfg/mpc_navigation/*.yaml` in kotakondo/Intent-MPC):

- planner:   planner_param.yaml (mpc_planner/*)
- predictor: predictor_param.yaml
- detector:  fake_detector_param.yaml + mapping_param.yaml (robot_size)
- world:     dynus_obstacles_ros1/src/dynus_obstacles_node.cpp:53-90
- flight:    flight_base.yaml
- control:   tracking_controller/cfg/controller_param.yaml

All configs are frozen (hashable).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
import math
from typing import Tuple


@dataclass(frozen=True)
class WorldConfig:
    """Seeded DYNUS-style obstacle world.

    Reference: dynus_obstacles_ros1/src/dynus_obstacles_node.cpp:53-152.
    """

    num_obstacles: int = 200
    dynamic_ratio: float = 0.65
    x_range: Tuple[float, float] = (5.0, 105.0)
    y_range: Tuple[float, float] = (-15.0, 15.0)
    z_range: Tuple[float, float] = (0.0, 7.0)
    slower_range: Tuple[float, float] = (4.0, 6.0)
    scale_range: Tuple[float, float] = (2.0, 4.0)
    offset_range: Tuple[float, float] = (0.0, 3.0)
    bbox_dynamic: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    bbox_static_vert: Tuple[float, float, float] = (0.4, 0.4, 4.0)
    bbox_static_horiz: Tuple[float, float, float] = (0.4, 4.0, 0.4)
    percentage_vert: float = 0.35  # fraction of static obstacles that are pillars


@dataclass(frozen=True)
class DetectorConfig:
    """Ground-truth detector with finite-difference state estimation.

    Reference: onboard_detector/include/onboard_detector/fakeDetector.cpp:138-258
    (stateCB finite differencing), :525-553 (history getter), and
    fake_detector_param.yaml (history_size=100, color_distance=30).
    """

    history_size: int = 100
    sensor_range: float = 30.0          # color_distance: 2D range gate
    robot_size: Tuple[float, float, float] = (0.5, 0.5, 0.3)  # mapping_param.yaml
    fd_period: float = 0.1              # min dT for velocity/acceleration finite diff
    history_period: float = 1.0 / 30.0  # histCB timer (fakeDetector.cpp:69)


@dataclass(frozen=True)
class RealDetectorConfig:
    """Depth-camera dynamic-detector stack flown in the closed loop
    (EngineConfig.use_fake_detector=False, models/real_detector.py):
    rendered depth -> projected points -> DBSCAN clusters -> AABBs ->
    const-vel KF tracks -> dynamic classification votes -> predictor-format
    histories.

    Reference: onboard_detector/dynamicDetector.cpp detectionCB/trackingCB/
    classificationCB selected over the fake detector by use_fake_detector
    (mpcNavigation.cpp:129-136)."""

    im_h: int = 64
    im_w: int = 96
    fx: float = 80.0
    fy: float = 80.0
    cx: float = 48.0
    cy: float = 32.0
    depth_min: float = 0.3
    depth_max: float = 9.0
    skip: int = 2                     # depth_skip_pixel
    cam_z_offset: float = 0.0         # camera height above body origin
    dbscan_eps: float = 0.5           # dbscan_search_range_epsilon
    dbscan_min_pts: int = 6           # dbscan_min_points_cluster
    min_cluster_pts: int = 6          # cluster -> detection threshold
    min_box_size: float = 0.2         # AABB floor (front-face clusters)
    max_detections: int = 8           # detection slots per frame
    max_tracks: int = 8               # track table size (history slots)
    match_max_dist: float = 1.5       # association gate
    dyn_vote_thresh: float = 2.0      # classification votes -> dynamic
    dyn_vel_thresh: float = 0.3       # dynamic_velocity_threshold
    miss_max: int = 10                # coasting frames before a track dies
    kf_size_inflation: float = 0.0    # inflate each track's reported size
                                      # by this multiple of its KF
                                      # position std (off, as in the
                                      # reference package)
    static_map_veto: bool = False     # veto dynamic classification for
                                      # tracks inside the static map's
                                      # occupied cells (off)


@dataclass(frozen=True)
class PredictorConfig:
    """Markov-chain intent predictor + multi-hypothesis rollouts.

    Reference: dynamic_predictor/include/dynamic_predictor/dynamicPredictor.cpp
    and predictor_param.yaml.
    """

    num_pred: int = 30                # prediction_size
    dt: float = 0.1                   # prediction_time_step
    z_score: float = 0.674            # prediction_z_score
    min_turning_time: float = 2.0
    max_turning_time: float = 3.0
    max_front_prob: float = 0.5
    front_angle_deg: float = 25.0
    stop_vel: float = 0.1             # stop_velocity_thereshold
    pscale: float = 5.0               # prob_scale_param

    # Fixed-shape sample-grid sizes (the reference uses data-dependent
    # `for(double i=min; i<max; i+=step)` loops, dynamicPredictor.cpp:365-366,
    # :438-440; we use padded grids + validity masks).
    forward_angle_step: float = 0.1
    forward_speed_step: float = 0.1
    max_forward_speed_samples: int = 32
    turning_speed_step: float = 0.2
    turning_angvel_step: float = 0.2
    turning_end_step: float = 0.2
    max_turning_speed_samples: int = 16

    # ---- derived parameters (dynamicPredictor.cpp:66-106) ----
    @property
    def front_angle(self) -> float:
        return self.front_angle_deg * math.pi / 180.0

    @property
    def param_l(self) -> float:
        return (1.0 - self.max_front_prob) / (3.0 * self.max_front_prob - 1.0)

    @property
    def param_r(self) -> float:
        return self.param_l

    @property
    def param_f(self) -> float:
        fa = self.front_angle
        pl = self.param_l
        return math.sqrt(fa * fa / (-2.0 * math.log(pl * (1.0 + math.sin(fa)) - pl)))

    @property
    def param_s(self) -> float:
        return math.atanh(0.5) / self.stop_vel

    @property
    def num_forward_angle_samples(self) -> int:
        # for(i=minAngle; i<maxAngle; i+=0.1) over a 2*front_angle span
        return int(math.ceil(2.0 * self.front_angle / self.forward_angle_step - 1e-12))

    @property
    def num_turning_angvel_samples(self) -> int:
        lo = (math.pi / 2.0) / self.max_turning_time
        hi = (math.pi / 2.0) / self.min_turning_time
        return int(math.ceil((hi - lo) / self.turning_angvel_step - 1e-12))

    @property
    def num_turning_end_samples(self) -> int:
        span = math.pi - 2.0 * self.front_angle
        return int(math.ceil(span / self.turning_end_step - 1e-12))


@dataclass(frozen=True)
class SolverConfig:
    """OSQP-style ADMM settings for the batched QP solver.

    The reference vendors OsqpEigen over libosqp, warm-started and
    time-limited to 0.05 s per solve (mpcPlanner.cpp:436-527); the
    wall-clock cap becomes a fixed iteration budget. The port runs the
    fields marked "(ported)" at the values marked; ops/admm.py raises on
    the others.
    """

    rho: float = 0.1                  # (ported)
    rho_eq_scale: float = 1e3         # OSQP uses rho*1e3 on equality rows (ported)
    sigma: float = 1e-6               # (ported)
    alpha: float = 1.6                # (ported)
    max_iter: int = 100               # iteration budget per solve (ported)
    warm_start: bool = True
    scaling_iters: int = 3            # Ruiz equilibration sweeps (ported)
    refine_iters: int = 0             # refinement steps per x-update of a
                                      # per-candidate factor (ported)
    eps_abs: float = 1e-3             # "osqp" truncation tolerances (ported)
    eps_rel: float = 1e-3
    truncation: str = "fixed"         # "fixed": exactly max_iter
                                      # iterations; "osqp": OSQP 0.6.2's
                                      # runtime termination, checked every
                                      # term_check_interval iterations and
                                      # capped at max_iter (both ported)
    term_check_interval: int = 25     # iterations between termination checks
    factor_drift_refresh: float = 0.0  # drift-aware factor refresh: a
                                      # scenario also refactors when its
                                      # active obstacle gradients drift
                                      # past this relative threshold; 0
                                      # keeps the counter rule (ported)
    adaptive_rho: bool = False        # in-solve rho adaptation with
                                      # refactorization, with a factor per
                                      # candidate (ported)
    adapt_interval: int = 25
    structured_factor: bool = True    # block-tridiagonal factorization of
                                      # the x-update normal matrix
                                      # (ops/block_chol.py) (ported)
    shared_factor: bool = True        # one factor per scenario (candidate-
                                      # mean QP), candidates refine against
                                      # their own normal matrix; False: a
                                      # factor per candidate (both ported)
    fused_solve: bool = False         # solve every candidate QP of a cycle
                                      # with the fleet kernel: one launch of
                                      # csrc/fleet_admm.cu (ops/fleet.py),
                                      # stationary refinement, a fresh
                                      # factor every cycle (ported)
    woodbury_candidates: bool = False  # exact Woodbury x-update over the
                                      # two slots the candidates differ in
                                      # (a fresh base factor every cycle)
    block_refine: bool = False        # refinement operator through the
                                      # (H, 13, 13) blocks (block_apply)
    folded_refine: bool = False       # refinement operator with the
                                      # scalings folded in (make_folded_m_op)
    shared_refine_mode: str = "cg"    # "cg" or "stationary"
    shared_refine_warm_frac: float = 0.0  # two-phase refinement: this share
                                      # of the iterations refines
                                      # shared_refine_warm times
    shared_refine_warm: int = 1
    shared_refine_x0: str = "prev"    # CG initial guess: "prev" = previous
                                      # ADMM x-tilde, "minv" = Minv @ rhs
                                      # (ported)
    shared_refine_iters: int = 2      # refinement steps per x-update with a
                                      # shared factor (ported)
    minv_dtype: str = "f32"           # "f32" or "bf16": the shared factor's
                                      # storage (products read it as f32)
    ew_kernel: bool = True            # run each ADMM iteration's elementwise
                                      # tail (x blend, z relax, projection,
                                      # dual update, next rho*z - y) as one
                                      # hand-written CUDA kernel
                                      # (ops/ew_chain.py, csrc/ew_chain.cu).
                                      # The JAX reference defaults this to
                                      # False from a TPU measurement; the
                                      # math is identical to the grouped
                                      # step (tests/test_torch_admm.py pins
                                      # it), so the port turns it on. False
                                      # runs the grouped torch step.
    flat_iter: bool = False           # flat constraint-space iteration
                                      # with a shared factor; launches no
                                      # ew_chain (ported)
    factor_reuse_cycles: int = 4      # refresh the shared factor only every
                                      # k-th replan cycle and reuse the
                                      # carried one in between (ported)
    temporal_rho: bool = False        # carry OSQP's rho suggestion across
                                      # cycles (ported)
    # --- OSQP-style active-set polish of the chosen candidate (ported) ---
    polish: bool = False
    polish_reg: float = 3e-6
    polish_iters: int = 12
    polish_rounds: int = 2
    polish_tol: float = 1e-5
    polish_accept_tol: float = 1e-4


@dataclass(frozen=True)
class PlannerConfig:
    """MPC planner parameters.

    Reference: planner_param.yaml (mpc_planner/*) and flight_base.yaml
    (desired_velocity/acceleration become max_vel/max_acc, mpcNavigation.cpp:161-162).
    """

    horizon: int = 30
    ts: float = 0.1
    y_range: Tuple[float, float] = (-5.0, 5.0)
    z_range: Tuple[float, float] = (0.5, 4.5)
    static_safety_dist: float = 0.8
    dynamic_safety_dist: float = 1.5
    static_slack: float = 0.01        # static_constraint_slack_ratio
    dynamic_slack: float = 0.2        # dynamic_constraint_slack_ratio
    position_weight: float = 1000.0
    velocity_weight: float = 0.0
    acceleration_weight: float = 10.0
    dummy_state_weights: Tuple[float, float] = (100.0, 1000.0)  # mpcPlanner.cpp:928
    slack_control_weights: Tuple[float, float] = (1.0, 1.0)     # mpcPlanner.cpp:930
    max_vel: float = 5.0
    max_acc: float = 20.0
    max_obstacles: int = 64           # padded obstacle-slot count (fixed shapes)
    static_clustering: bool = False   # cluster the local static map into
                                      # rotated-box MPC rows (the
                                      # real-perception composition; the
                                      # DYNUS GT bench disables it,
                                      # mpcPlanner.cpp:191-193)
    cluster_window: Tuple[int, int, int] = (48, 48, 24)
    cluster_points: int = 512
    cluster_slots: int = 16
    num_intent_candidates: int = 6    # intent combos per replan (mpcPlanner.cpp:715)
    consistency_steps: int = 10       # getConsistencyScore (mpcPlanner.cpp:781)
    direction_weight_a: float = 3.0   # findClosestObstacle (mpcPlanner.cpp:696)
    max_ref_forward_time: float = 3.0 # getReferenceTraj window (mpcPlanner.cpp:1210)
    solver: SolverConfig = SolverConfig()

    @property
    def mpc_window(self) -> int:
        return self.horizon - 1

    @property
    def num_vars(self) -> int:
        return 8 * self.horizon + 5 * self.mpc_window


@dataclass(frozen=True)
class ControlConfig:
    """Cascaded PID tracking controller (acceleration output mode).

    Reference: tracking_controller/cfg/controller_param.yaml and
    trackingController.cpp:426-523 (computeAttitudeAndAccRef).
    """

    position_p: Tuple[float, float, float] = (2.0, 2.0, 1.8)
    position_i: Tuple[float, float, float] = (0.0, 0.0, 0.1)
    position_d: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity_p: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    velocity_i: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    velocity_d: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class EngineConfig:
    """Closed-loop engine timing and termination.

    The reference runs mpcCB at 10 Hz, trajExeCB/controller at 100 Hz,
    detector history at 30 Hz (mpcNavigation.cpp:176-188, fakeDetector.cpp:69).
    The engine uses a 100 Hz base tick with an outer loop over 10 Hz MPC
    cycles and an inner loop of `ticks_per_cycle` control ticks. The port
    runs the values marked "ported"; engine/closed_loop.py raises on the
    others.
    """

    control_dt: float = 0.01
    ticks_per_cycle: int = 10            # MPC every 10 control ticks (10 Hz)
    hist_ticks: Tuple[int, ...] = (0, 3, 6)  # ~30 Hz history snapshots per cycle
    timeout: float = 100.0               # run_mpc_benchmark.py --timeout default
    goal_dist_threshold: float = 0.5     # run_mpc_benchmark.py:269
    goal_vel_threshold: float = 0.1
    goal_stop_threshold: float = 0.3     # replanCheckCB goal-dist (mpcNavigation.cpp:423)
    plant: str = "double_integrator"     # "double_integrator" or
                                         # "quadrotor", the rigid-body
                                         # quadcopterPlugin model (both
                                         # ported)
    perfect_tracking: bool = False       # True: odom == commanded target
                                         # (ported)
    use_predictor: bool = True           # False -> constant-obstacle MPC
                                         # (ported)
    use_fake_detector: bool = True       # GT fake detector; False flies
                                         # the real perception stack (both
                                         # ported)
    use_fov: bool = False                # FOV half-space rows (ported)
    repeat_path: int = 1                 # execute_path_times (ported)
    replan_check: bool = True            # committed-trajectory collision
                                         # monitor each cycle (replanCheckCB
                                         # :631-700) (ported)
    goal_mode: bool = False              # interactive-goal navigation
                                         # (usePredefinedGoal_=false): goal
                                         # stop without the 3 s gate,
                                         # invalid-goal stop, stop+replan
                                         # on a committed-trajectory hit
                                         # (ported)
    predictor_stale_hist: bool = False   # predictor reads the previous
                                         # cycle's history (ported)
    render_static_grid: bool = True      # the real detector's camera also
                                         # ray-marches the static grid
    yaw_lookahead: float = 1.0           # trajExeCB :536-553 look-ahead yaw;
                                         # <= 0 uses the velocity heading
                                         # (both ported)
    # ---- goal-mode MPC input-trajectory composition (engine/ref_builder;
    # all three modes ported) ----
    ref_mode: str = "linspace"           # "linspace": the straight segment
                                         # from the replan anchor; "minsnap":
                                         # 2-waypoint corridor min-snap
                                         # (mpcNavigation.cpp:267-289);
                                         # "global": RRT route first
                                         # (:240-265)
    ref_vel: float = 1.0                 # polyTraj desired velocity
    ref_waypoints: int = 8               # RRT-route resample count
    ref_rrt_iters: int = 512             # RRT iteration budget
    ref_rrt_step: float = 0.5            # RRT incremental_dist
    ref_rrt_shortcut: float = 3.0        # shortcutting max segment length
    ref_bounds_margin: float = 2.0       # RRT sampling box beyond start/goal
    ref_z_min: float = 0.3               # RRT sampling floor
    ref_corridor_radius: float = 0.5     # poly_traj/initial_radius
    ref_poly_iters: int = 400            # min-snap dense-ADMM iterations
    ref_angular_vel: float = 1.0         # pwl-failsafe rotation rate; keep
                                         # rotation holds shorter than the
                                         # MPC window (horizon * ts)
    vel_limit: float = 5.0               # DYNUS Linf violation limits
    acc_limit: float = 20.0
    jerk_limit: float = 100.0
    violation_tol: float = 1e-3
    # ---- goal-approach safety relaxation (opt-in; ported) ----
    goal_relax: bool = False
    goal_relax_radius: float = 4.0
    goal_relax_speed: float = 0.4
    goal_relax_grace: int = 20
    goal_relax_rate: float = 0.02
    goal_relax_floor: float = 0.5

    @property
    def num_cycles(self) -> int:
        cycle_dt = self.control_dt * self.ticks_per_cycle
        return int(round(self.timeout / cycle_dt))


@dataclass(frozen=True)
class IntentMPCConfig:
    """Top-level bundle."""

    world: WorldConfig = WorldConfig()
    detector: DetectorConfig = DetectorConfig()
    real_detector: RealDetectorConfig = RealDetectorConfig()
    predictor: PredictorConfig = PredictorConfig()
    planner: PlannerConfig = PlannerConfig()
    control: ControlConfig = ControlConfig()
    engine: EngineConfig = EngineConfig()
    start: Tuple[float, float, float] = (0.0, 0.0, 2.0)
    goal: Tuple[float, float, float] = (105.0, 0.0, 2.0)

    def replace(self, **kwargs) -> "IntentMPCConfig":
        return dataclasses.replace(self, **kwargs)


def small_config(num_obstacles: int = 8, horizon: int = 10, timeout: float = 2.0,
                 max_obstacles: int = 8, hist: int = 12) -> IntentMPCConfig:
    """A tiny config for tests and dry runs."""
    c = IntentMPCConfig()
    return c.replace(
        world=dataclasses.replace(c.world, num_obstacles=num_obstacles),
        detector=dataclasses.replace(c.detector, history_size=hist),
        predictor=dataclasses.replace(c.predictor, num_pred=horizon),
        planner=dataclasses.replace(
            c.planner, horizon=horizon, max_obstacles=max_obstacles,
            solver=dataclasses.replace(c.planner.solver, max_iter=30)),
        engine=dataclasses.replace(c.engine, timeout=timeout),
    )
