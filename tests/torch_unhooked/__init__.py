"""``batched_lbfgs``, ``batched_varpro`` and ``batched_newton_cg`` as they
were before their field-axis hooks, copied verbatim from
``muse_tpu_torch/ops`` (lbfgs.py, varpro.py, newton_cg.py): the oracle of
``tests/test_torch_field_hooks.py``, which holds the hook-free loops to
them bit for bit. Not collected by pytest."""
