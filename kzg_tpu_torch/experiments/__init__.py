"""The field-chain, product-body and point-op experiments on the card: the
counterparts of the JAX package's TPU micro-experiments
scripts/exp_montmul.py (`exp_montmul`), scripts/exp_mxu_mul.py
(`exp_mxu_mul`), scripts/exp_addsub.py (`exp_addsub`),
scripts/exp_ab_mul.py (`exp_ab_mul`), scripts/exp_carry.py
(`exp_carry`), scripts/exp_truth.py (`exp_truth`),
scripts/exp_addcost.py (`exp_addcost`), scripts/exp_calib.py
(`exp_calib`), scripts/exp_bisect.py (`exp_bisect`), scripts/exp_width.py
(`exp_width`), scripts/exp_pointops.py (`exp_pointops`) and
scripts/exp_lazyops.py (`exp_lazyops`), each an entry point
(`python3 -m kzg_tpu_torch.experiments.exp_montmul [--device cpu]`) on the
kernels of csrc/exp_field_kernels.cu (`kernels`) and
csrc/exp_point_kernels.cu (`point_kernels`). No path of the library runs
them.
"""
