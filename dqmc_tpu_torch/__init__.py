"""dqmc_tpu_torch — the PyTorch/CUDA port of dqmc_tpu.

Determinant quantum Monte Carlo of the attractive and repulsive Hubbard
models on an NVIDIA GPU: plain torch for the glue, hand-written CUDA kernels
(``csrc/``) where the JAX package ran Pallas kernels on a TPU.  The module
names mirror ``dqmc_tpu``'s.  The package imports ``torch`` and never
``jax``, and nothing of ``dqmc_tpu``: it keeps its own copies of the
JAX-free modules it needs (config, lattice, io.h5out).  The HDF5 bins it
writes are read by ``python -m dqmc_tpu.analysis``.

- :mod:`dqmc_tpu_torch.config`   — the ``parameters.in`` schema
- :mod:`dqmc_tpu_torch.lattice`  — lattice geometry and the ``info`` file
- :mod:`dqmc_tpu_torch.hsfield`  — the 4-state GHQ field
- :mod:`dqmc_tpu_torch.models`   — the attractive and repulsive Hubbard
  models, dense or checkerboard kinetics
- :mod:`dqmc_tpu_torch.ops`      — LDR algebra, the CGS2 QR kernel, the
  site-update kernels (delayed, submatrix, rank-1), and the multiword
  (df32, tf32) arithmetic, LDR algebra and panel-QR kernels
- :mod:`dqmc_tpu_torch.engine`   — walker state, stack rebuild, the fused
  and the per-slice sweeps, the df32 engine and the multiword measurement
  tier
- :mod:`dqmc_tpu_torch.measure`  — equal-time observables and HDF5 bins
- :mod:`dqmc_tpu_torch.io`       — the HDF5 bin writer, the spool log
  and checkpoint/resume
- :mod:`dqmc_tpu_torch.run`      — the ``python -m dqmc_tpu_torch`` driver
"""

__version__ = "0.1.0"
