"""dqmc_tpu_torch — the PyTorch/CUDA port of dqmc_tpu.

Determinant quantum Monte Carlo of the attractive Hubbard model on an
NVIDIA GPU: plain torch for the glue, hand-written CUDA kernels
(``csrc/``) where the JAX package ran Pallas kernels on a TPU.  The module
names mirror ``dqmc_tpu``'s.  The package imports ``torch`` and never
``jax``; it reuses the JAX-free modules of ``dqmc_tpu`` (config, lattice,
io.h5out, analysis).

- :mod:`dqmc_tpu_torch.hsfield`  — the 4-state GHQ field
- :mod:`dqmc_tpu_torch.models`   — the attractive Hubbard model, dense kinetics
- :mod:`dqmc_tpu_torch.ops`      — LDR algebra and the CGS2 QR kernel
- :mod:`dqmc_tpu_torch.engine`   — walker state, stack rebuild, fused sweep
- :mod:`dqmc_tpu_torch.measure`  — equal-time observables and HDF5 bins
- :mod:`dqmc_tpu_torch.run`      — the ``python -m dqmc_tpu_torch`` driver
"""

__version__ = "0.1.0"
