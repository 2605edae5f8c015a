"""The port stands alone: importing every module of kzg_tpu_torch (the
verification modules of curve/, eth/, the persistence, the utilities and
the sharded paths of parallel/ and the field-chain, product-body and
point-op experiments of experiments/ too), the two examples of the port,
chip_smoke.py and the rank tools it and the sharded paths' checks start
loads neither JAX nor the JAX package, and builds no kernel and no host
library."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROGRAM = """
import importlib, json, pkgutil, sys
import kzg_tpu_torch
from kzg_tpu_torch import build
mods = [m.name for m in pkgutil.walk_packages(kzg_tpu_torch.__path__,
                                              "kzg_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import importlib.util
for path in ("examples/eth_blob_demo_torch.py",
             "examples/full_das_pipeline_torch.py", "chip_smoke.py",
             "kzg_tpu_torch/tools/sharded_check.py",
             "kzg_tpu_torch/tools/gloo_cuda_probe.py"):
    spec = importlib.util.spec_from_file_location(
        path.rsplit("/", 1)[-1][:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "kzg_tpu."))
             or m == "kzg_tpu")
print(json.dumps({"modules": mods, "loaded": bad,
                  "built": build.library.cache_info().currsize,
                  "host_built": build.host_library.cache_info().currsize}))
"""


def test_import_loads_no_jax_and_builds_nothing():
    # a fresh interpreter: this one has JAX loaded by the root conftest
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", PROGRAM], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.splitlines()[-1])
    assert set(seen["modules"]) >= {
        "kzg_tpu_torch.curve.msm", "kzg_tpu_torch.curve.kernels",
        "kzg_tpu_torch.field.kernels", "kzg_tpu_torch.kzg.settings",
        "kzg_tpu_torch.ntt.das", "kzg_tpu_torch.fk20.multi",
        "kzg_tpu_torch.poly", "kzg_tpu_torch.das.zero_poly",
        "kzg_tpu_torch.das.recovery", "kzg_tpu_torch.das.legacy",
        "kzg_tpu_torch.fk20.single", "kzg_tpu_torch.convert",
        "kzg_tpu_torch.curve.fp2", "kzg_tpu_torch.curve.g2",
        "kzg_tpu_torch.curve.pairing", "kzg_tpu_torch.curve.pairing_native",
        "kzg_tpu_torch.curve.serialization", "kzg_tpu_torch.curve.tower",
        "kzg_tpu_torch.curve.pairing_device",
        "kzg_tpu_torch.curve.pairing_kernels", "kzg_tpu_torch.eth",
        "kzg_tpu_torch.eth.settings", "kzg_tpu_torch.eth.api",
        "kzg_tpu_torch.kzg.persist", "kzg_tpu_torch.utils.debug",
        "kzg_tpu_torch.utils.mulcount", "kzg_tpu_torch.utils.profiling",
        "kzg_tpu_torch.utils.benchloop", "kzg_tpu_torch.parallel",
        "kzg_tpu_torch.parallel.mesh", "kzg_tpu_torch.parallel.fft_sharded",
        "kzg_tpu_torch.parallel.fft_g1_sharded",
        "kzg_tpu_torch.parallel.msm_sharded",
        "kzg_tpu_torch.parallel.fk20_sharded",
        "kzg_tpu_torch.experiments", "kzg_tpu_torch.experiments.kernels",
        "kzg_tpu_torch.experiments.exp_montmul",
        "kzg_tpu_torch.experiments.exp_mxu_mul",
        "kzg_tpu_torch.experiments.exp_addsub",
        "kzg_tpu_torch.experiments.exp_ab_mul",
        "kzg_tpu_torch.experiments.exp_carry",
        "kzg_tpu_torch.experiments.exp_truth",
        "kzg_tpu_torch.experiments.exp_addcost",
        "kzg_tpu_torch.experiments.point_kernels",
        "kzg_tpu_torch.experiments.exp_calib",
        "kzg_tpu_torch.experiments.exp_bisect",
        "kzg_tpu_torch.experiments.exp_width",
        "kzg_tpu_torch.experiments.exp_pointops",
        "kzg_tpu_torch.experiments.exp_lazyops"}
    assert len(seen["modules"]) >= 63
    assert seen["loaded"] == []
    assert seen["built"] == 0
    assert seen["host_built"] == 0
