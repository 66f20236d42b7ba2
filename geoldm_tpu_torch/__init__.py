"""PyTorch/CUDA port of geoldm-tpu.

The JAX package ``geoldm_tpu`` is the reference; every module here mirrors
its counterpart's name and layout (``geoldm_tpu/ops/com.py`` ->
``geoldm_tpu_torch/ops/com.py``) and is held against it by the
``tests/test_torch_port_*.py`` suites. This package imports ``torch`` and
numpy only, never ``jax`` and nothing of ``geoldm_tpu``.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
asking for the card on a host without one raises (``utils.device``).
"""
