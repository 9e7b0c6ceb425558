"""ppi_tpu_torch: Monte Carlo posterior policy iteration in PyTorch on CUDA.

The port of ``ppi_tpu`` (the JAX/TPU package, which stays the reference)
to one NVIDIA H100. This first slice is the door-v0 MPC main path: the
squared-exponential GP prior, the LBPS solver, the MPC agent and its
runner, with every rollout on a CUDA device going through a hand-written
kernel (``csrc/rollout.cu``). The package imports torch, numpy and the
standard library only.
"""
