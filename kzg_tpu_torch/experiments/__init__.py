"""The field-chain and product-body experiments on the card: the
counterparts of the JAX package's TPU micro-experiments
scripts/exp_montmul.py (`exp_montmul`), scripts/exp_mxu_mul.py
(`exp_mxu_mul`), scripts/exp_addsub.py (`exp_addsub`),
scripts/exp_ab_mul.py (`exp_ab_mul`), scripts/exp_carry.py
(`exp_carry`), scripts/exp_truth.py (`exp_truth`) and
scripts/exp_addcost.py (`exp_addcost`), each an entry point
(`python3 -m kzg_tpu_torch.experiments.exp_montmul [--device cpu]`) on the
kernels of csrc/exp_field_kernels.cu (`kernels`). No path of the library
runs them.
"""
