"""Timing a call as a slope (kzg_tpu/utils/benchloop.py): the time of
k + 1 calls less that of one, over k, so every fixed cost of a call's
first launch and of the wait for its end cancels. On the card the calls
are timed with CUDA events on the current stream; on the CPU with the
host clock.
"""

from __future__ import annotations

import time

import torch

from .profiling import _tensors


def _device(args):
    return next((t.device for t in _tensors(args) if t.is_cuda), None)


def _run(fn, args, calls: int, chain: bool):
    out = None
    for _ in range(calls):
        out = fn(*args)
        if chain:
            args = (out,) + tuple(args[1:])
    return out


def _time_best(fn, args, calls: int, chain: bool, windows: int, cuda):
    """(best seconds of `calls` calls over `windows` tries, their spread,
    the last output)."""
    times, out = [], None
    for _ in range(windows):
        if cuda is not None:
            torch.cuda.synchronize(cuda)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = _run(fn, args, calls, chain)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / 1e3)
        else:
            t0 = time.perf_counter()
            out = _run(fn, args, calls, chain)
            times.append(time.perf_counter() - t0)
    return min(times), max(times) - min(times), out


def device_loop(fn, args, k: int = 16, chain: bool = False,
                windows: int = 3):
    """Time fn(*args) as the slope between 1 and k + 1 calls, the best of
    `windows` tries of each. chain=True feeds each output into the next
    call's first argument (fn's output must be shaped like args[0]).
    Returns (seconds_per_op, last_output, floored): floored means the
    slope did not clear the tries' spread, so seconds_per_op is a 1 ns
    floor, not a measurement."""
    args = tuple(args)
    cuda = _device(args)
    _run(fn, args, 1, chain)                       # warm: builds, caches
    t_one, j_one, _ = _time_best(fn, args, 1, chain, windows, cuda)
    t_k, j_k, out = _time_best(fn, args, k + 1, chain, windows, cuda)
    slope = t_k - t_one
    resolvable = slope > max(5 * max(j_one, j_k), 0.02 * t_k)
    per_op = slope / k
    floored = per_op <= 1e-9 or not resolvable
    return max(per_op, 1e-9), out, floored
