"""PyTorch / CUDA port of ``mpc_for_av_at_intersection_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; each module here names the
module it ports. Layout mirrors it:

- ``core``   — plant dynamics, angle utilities, course localization
- ``models`` — vehicle geometry
- ``mpc``    — the batched controller tick (``mpc_step_batched``) and its
               plain pieces: reference, linearization, condensing, ADMM solver
- ``ops``    — hand-written CUDA kernels (sources in ``csrc/``) with their
               wrappers: K1 ``condense_qp`` and K2 ``admm``

Tensors on a CUDA device run the kernels; CPU tensors run the plain PyTorch
versions. Nothing here imports JAX.
"""

__version__ = "0.1.0"
