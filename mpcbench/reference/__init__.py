"""The plain reference of one closed-loop DYNUS cycle.

Plain PyTorch, float64 by default, dense matrices, no kernels, no
batching tricks: the semantics of the configuration file, written out
from the planner's definitions (world, ground-truth detector, intent
predictor, six candidate QPs, shared factor, ADMM, scoring, PID
controller and double-integrator plant). It imports nothing of the
program under test and reads only the configuration file's values and
the state it is handed.
"""
