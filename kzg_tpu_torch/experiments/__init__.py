"""The field-chain experiments on the card: the counterparts of the JAX
package's TPU micro-experiments scripts/exp_montmul.py (`exp_montmul`),
scripts/exp_mxu_mul.py (`exp_mxu_mul`) and scripts/exp_addsub.py
(`exp_addsub`), each an entry point
(`python3 -m kzg_tpu_torch.experiments.exp_montmul [--device cpu]`) on the
kernels of csrc/exp_field_kernels.cu (`kernels`). No path of the library
runs them.
"""
