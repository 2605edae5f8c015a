"""Timing a call as a slope (kzg_tpu/utils/benchloop.py): the time of
k + 1 calls less that of one, over k, so every fixed cost of a call's
first launch and of the wait for its end cancels. On the card the calls
are timed with CUDA events on the current stream; on the CPU with the
host clock. Where a call's launches take less device time than the host
takes to issue them, the events time the host; `hold=True` then keeps
the device busy on a spin while the host issues a window's calls, so
that the events time the device alone. A held window checks that the
host issued its calls before the spin ended, and lengthens the spin and
tries again where it did not.
"""

from __future__ import annotations

import time

import torch

from .profiling import _tensors

# the spin in front of a held window, a call, at first: about 100 us at
# the H100's 1.98 GHz boost clock. A window whose host issue outlasts its
# spin is tried again with twice the spin, at most HOLD_DOUBLINGS times.
HOLD_CYCLES = 200_000
HOLD_DOUBLINGS = 6


def _device(args):
    return next((t.device for t in _tensors(args) if t.is_cuda), None)


def _run(fn, args, calls: int, chain: bool):
    out = None
    for _ in range(calls):
        out = fn(*args)
        if chain:
            args = (out,) + tuple(args[1:])
    return out


def _held_window(fn, args, calls: int, chain: bool, cuda):
    """(device seconds of `calls` calls issued behind a spin, the output).
    The spin is timed with events of its own; the host's issue of the
    calls, with the host clock. Where the issue took longer than the spin,
    the device may have waited on the host inside the window, so the
    window is tried again behind twice the spin; it raises where even
    the last spin was too short."""
    cycles = HOLD_CYCLES * calls
    for _ in range(HOLD_DOUBLINGS + 1):
        torch.cuda.synchronize(cuda)
        s0, t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(cycles)
        h0 = time.perf_counter()
        t0.record()
        out = _run(fn, args, calls, chain)
        t1.record()
        issue_s = time.perf_counter() - h0
        t1.synchronize()
        if issue_s < s0.elapsed_time(t0) / 1e3:
            return t0.elapsed_time(t1) / 1e3, out
        cycles *= 2
    raise RuntimeError(
        f"device_loop: the host took {issue_s * 1e3:.3f} ms to issue "
        f"{calls} calls, longer than a spin of {cycles // 2} cycles "
        f"({s0.elapsed_time(t0):.3f} ms): the window would time the host")


def _time_best(fn, args, calls: int, chain: bool, windows: int, cuda,
               hold: bool = False):
    """(best seconds of `calls` calls over `windows` tries, their spread,
    the last output)."""
    times, out = [], None
    for _ in range(windows):
        if cuda is not None and hold:
            sec, out = _held_window(fn, args, calls, chain, cuda)
            times.append(sec)
        elif cuda is not None:
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
                windows: int = 3, hold: bool = False):
    """Time fn(*args) as the slope between 1 and k + 1 calls, the best of
    `windows` tries of each. chain=True feeds each output into the next
    call's first argument (fn's output must be shaped like args[0]).
    hold=True (on the card, for calls that never wait on the host) puts a
    spin of at least HOLD_CYCLES a call in front of each window, one
    that outlasts the host's issue of the window's calls (_held_window).
    Returns (seconds_per_op, last_output, floored): floored means the
    slope did not clear the tries' spread, so seconds_per_op is a 1 ns
    floor, not a measurement."""
    args = tuple(args)
    cuda = _device(args)
    _run(fn, args, 1, chain)                       # warm: builds, caches
    t_one, j_one, _ = _time_best(fn, args, 1, chain, windows, cuda, hold)
    t_k, j_k, out = _time_best(fn, args, k + 1, chain, windows, cuda, hold)
    slope = t_k - t_one
    resolvable = slope > max(5 * max(j_one, j_k), 0.02 * t_k)
    per_op = slope / k
    floored = per_op <= 1e-9 or not resolvable
    return max(per_op, 1e-9), out, floored
