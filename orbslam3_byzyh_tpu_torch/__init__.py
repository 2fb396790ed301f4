"""PyTorch / CUDA port of the visual-inertial SLAM engine.

The JAX package ``orbslam3_byzyh_tpu`` is the reference; this package mirrors
its module names. Plain tensor code is PyTorch; each Pallas kernel of the
reference is a hand-written CUDA kernel for Hopper (``csrc/``), with a plain
PyTorch version beside it that runs whenever the tensors lie on the CPU.

Nothing here imports JAX.
"""

__version__ = "0.1.0"
