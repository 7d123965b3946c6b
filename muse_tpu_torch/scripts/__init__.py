"""The port's measurement scripts, each run with ``python -m``:

  * ``kernel_ab_bench``: the field GRF's whole ``muse_step`` with the CUDA
    quadform and with its plain torch version (scripts/pallas_ab_bench.py);
  * ``bench_noise_modes``: ``grf_spectral_problem``'s ``noise="direct"``
    against ``"fft"`` (scripts/bench_noise_modes.py);
  * ``lensing_calibration_study``: θ̂ ± σ of the lensing demo's
    configuration over data realizations
    (scripts/lensing_calibration_study.py).
"""
