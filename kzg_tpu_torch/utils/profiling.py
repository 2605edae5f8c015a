"""Profiling helpers (kzg_tpu/utils/profiling.py): a device trace of a
block on torch.profiler, wall-clock timing, and a wait for the tensors'
devices."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Trace the enclosed block (the CPU and, where present, the CUDA
    activity); yields the profiler, and writes the trace as a Chrome
    trace, `log_dir`/trace.json, unless log_dir is None."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed(label: str, sink=print):
    """Wall-clock a block (call `block` on its outputs inside it)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree) -> None:
    """Wait until the work on every CUDA device that holds a tensor of
    `tree` (tensors in nested tuples, lists, dicts and NamedTuples) is
    done."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
