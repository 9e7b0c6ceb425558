"""ppi_tpu_torch: Monte Carlo posterior policy iteration in PyTorch on CUDA.

The port of ``ppi_tpu`` (the JAX/TPU package, which stays the reference)
to one NVIDIA H100, slice by slice. Slice 1 is the door-v0 MPC main path:
the squared-exponential GP prior, the LBPS solver, the MPC agent and its
runner, with every rollout on a CUDA device going through a hand-written
kernel (``csrc/rollout.cu``). Slice 2 is black-box optimization: the
Gaussian family, the test functions, the solver zoo, the samplers and
``runners/run_opt.py``, with every large moment match on a CUDA device
going through a hand-written kernel (``csrc/moment_match.cu``). The package
imports torch, numpy, scipy (the Sobol tables) and the standard library
only.
"""
