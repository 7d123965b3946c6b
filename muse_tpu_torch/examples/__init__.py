"""The demos of ``examples/``, on the port: each runs as
``python -m muse_tpu_torch.examples.<name>`` with the JAX demo's flags and
``--device`` (``cuda`` by default; without a card it raises rather than
taking the CPU), and prints the JAX demo's accuracy line in its words.

  * ``northstar_grf``: 512 sims × 1024² GRF amplitude, the full pipeline
    against the exact marginal MLE and Fisher σ;
  * ``lensing_demo``: CMB-lensing-style amplitude inference through VarPro;
  * ``muse_vs_hmc``: MUSE against a plain HMC on the 512-dim funnel, both
    judged against a quadrature of the exact marginal.
"""
