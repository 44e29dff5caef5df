"""jyutvoice_tpu_torch: the JyutVoice synthesis path in PyTorch for NVIDIA Hopper.

A port of the JAX package `jyutvoice_tpu` that sits beside it. Activations keep
the JAX package's channels-last (B, T, C) layout at every public function, and
parameter names follow the JAX parameter-tree paths, so both packages run the
same weights (`weights/from_jax.py`) and their outputs compare directly.

The two kernels the JAX package wrote in Pallas are hand-written CUDA C++ for
sm_90a here (`csrc/`), built with nvcc at first use:
  * `nn/flash_attention.py` — the CFM estimator's attention;
  * `nn/resblock_stage.py` — one fused HiFT ResBlock stage (C <= 128).
Each keeps a plain PyTorch version that CPU tensors take. An int8 estimator
(`nn/quant.py`) loads wherever the parameter tree was quantized. The package
imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
