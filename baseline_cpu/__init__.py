"""Scipy/SuperLU CPU reference pipeline.

The original reference repo could not be executed (empty mount, SURVEY.md
§0/§6), so this package provides the honest stand-in baseline: a
straightforward single-process numpy + scipy.sparse implementation of the
same collocation Gauss-Newton pipeline (the architecture SURVEY.md §1
attributes to the reference: global sparse COO/CSC assembly + SuperLU
factorization + Levenberg damping).  It serves two purposes:

  1. parity oracle — the device package's residual vector must match this
     pipeline to 1e-9 in float64 (tests/test_baseline_parity.py);
  2. performance baseline — `python -m baseline_cpu.run_baseline` measures
     Newton solve wall-time on this machine's CPU and writes
     baseline_cpu/results.json, which bench.py uses for vs_baseline.
"""
