"""kzg_tpu_torch: the PyTorch/CUDA port of kzg_tpu for one NVIDIA H100.

Same module names as kzg_tpu; values are int32 tensors of 32-bit words in
Montgomery form (field/limbs.py). Kernels are hand-written CUDA for sm_90a
under csrc/, built at first use (build.py). Entry points run on "cuda"
unless the caller passes device="cpu", where every kernel wrapper runs
its plain PyTorch version. This package imports neither JAX nor kzg_tpu.
"""
