"""The port's two examples, run small on the CPU (device="cpu": the kernel
wrappers take their plain versions): the EIP-4844 blob demo at width 4
with two blobs, and the full DAS pipeline at 4 data elements extended to
8, cells of 2 (every cell checked in one batched pairing check, one on
the host pairing, half the cells dropped and recovered byte for byte)."""

import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eth_blob_demo_small(capsys):
    example("eth_blob_demo_torch").main(["4", "--blobs", "2",
                                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "aggregate proof over 2 blobs verified" in out
    assert out.splitlines()[-1] == "ETH BLOB DEMO PASS"


def test_full_das_pipeline_small(capsys):
    example("full_das_pipeline_torch").main(["2", "2", "1",
                                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "verified all 4 cells in one batched check" in out
    assert "byte-exact reconstruction OK" in out
    assert out.splitlines()[-1] == "FULL DAS PIPELINE PASS"
