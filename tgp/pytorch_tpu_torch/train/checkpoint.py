"""Checkpoints: the torch counterpart of the JAX package's
`train/checkpoint.py`, on `torch.save` / `torch.load` (no orbax).

A checkpoint is one file, `<path>/step_<N>`, holding {"step", "params",
"opt_state", "extra"} with their Python structure as saved (dicts, lists,
`GroupAdamState`, the L-BFGS state's named tuples, numpy values) and every
tensor copied to the host.  It is written under a temporary name beside it
and renamed, so a crash never leaves a torn `step_<N>`, and `latest_step`
skips the temporary names.  `async_save=True` returns once the tensors are
on the host and writes on a background thread; `wait_for_checkpoints()`
waits for those writes and raises the first error among them.

The format is the port's own: an orbax checkpoint of the JAX package is not
read.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading

import torch

_pending: list = []          # [(thread, [error or None])]
_lock = threading.Lock()
_tmp_count = 0


def to_device(obj, device, dtype=None):
    """`obj` with every tensor copied to `device` (floating tensors cast to
    `dtype` when given), through dicts, lists, tuples, named tuples and
    dataclasses; other values as they are."""
    if torch.is_tensor(obj):
        if dtype is not None and obj.is_floating_point():
            return obj.detach().to(device, dtype, copy=True)
        return obj.detach().to(device, copy=True)
    if isinstance(obj, dict):
        return {k: to_device(v, device, dtype) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device, dtype) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device, dtype) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device, dtype)
            for f in dataclasses.fields(obj)})
    return obj


def _write(state, final: str):
    global _tmp_count
    with _lock:
        _tmp_count += 1
        tmp = f"{final}.tmp-{os.getpid()}-{_tmp_count}"
    try:
        torch.save(state, tmp)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def wait_for_checkpoints():
    """Block until the pending asynchronous saves are on disk; raise the
    first error one of them met."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
    for thread, err in pending:
        thread.join()
    for _, err in pending:
        if err[0] is not None:
            raise err[0]


def save_checkpoint(path: str, params, step: int = 0, opt_state=None,
                    extra: dict | None = None, async_save: bool = False):
    """Write `<path>/step_<step>` atomically; returns its path.

    async_save=True returns as soon as the tensors are copied to the host
    and writes in the background (call wait_for_checkpoints() before
    reading it or exiting)."""
    state = to_device({"step": int(step), "params": params,
                       "opt_state": opt_state, "extra": extra or {}}, "cpu")
    os.makedirs(os.path.abspath(path), exist_ok=True)
    final = os.path.join(os.path.abspath(path), f"step_{int(step)}")
    if not async_save:
        _write(state, final)
        return final
    err = [None]

    def work():
        try:
            _write(state, final)
        except BaseException as e:      # handed to wait_for_checkpoints
            err[0] = e

    thread = threading.Thread(target=work, name=f"checkpoint {final}")
    with _lock:
        _pending.append((thread, err))
    thread.start()
    return final


def latest_step(path: str) -> int | None:
    """The largest N of a finished `<path>/step_<N>`; unfinished writes
    (`step_<N>.tmp-...`) do not count.  None when there is none."""
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for d in os.listdir(path)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def load_checkpoint(path: str, step: int | None = None):
    """(params, opt_state, step, extra) of `<path>/step_<step>` (the latest
    when step is None), with the structure they were saved with; tensors
    come back on the CPU, and placing them is the caller's concern."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    final = os.path.join(os.path.abspath(path), f"step_{int(step)}")
    state = torch.load(final, map_location="cpu", weights_only=False)
    return (state["params"], state["opt_state"], int(state["step"]),
            state["extra"])
