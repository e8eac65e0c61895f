"""A gloo world of CPU processes for the port's multi-device tests.

:func:`run_world` starts ``world`` processes, each of which joins a gloo
process group through a file store in ``tmpdir`` (no TCP port, so parallel
test workers cannot race for one), runs ``target`` (``"module:function"``,
imported from ``tests/``) as ``function(rank, world, tmpdir) -> dict`` and
writes the dict to ``tmpdir``.  The parent waits at most ``timeout``
seconds and kills the ranks still running, so a hung collective fails its
tests in minutes.  A child imports neither JAX nor the JAX package (its
result records whether either was loaded), and runs torch on one thread.

Workers run each check through :func:`check`, which stores ``("ok",
value)`` or ``("error", traceback)`` under the check's name, so that each
test case reads and fails on its own entry.
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def run_world(target: str, world: int, tmpdir, timeout: float = 150.0,
              multihost: bool = False):
    """Run ``target`` on ``world`` ranks; the list of their result
    dicts.  With ``multihost`` each rank joins through the port's
    ``parallel.initialize_multihost``, from the JAX package's environment
    names (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``)."""
    import torch

    tmpdir = str(tmpdir)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        code = (f"import sys; sys.path[:0] = [{HERE!r}, {REPO!r}]; "
                f"import _torch_world; _torch_world._child({target!r}, "
                f"{rank}, {world}, {tmpdir!r}, {multihost!r})")
        if multihost:
            env = dict(env, COORDINATOR_ADDRESS="file://" + os.path.join(
                tmpdir, "store"), NUM_PROCESSES=str(world),
                PROCESS_ID=str(rank))
        log = open(os.path.join(tmpdir, f"log_{rank}.txt"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-c", code],
                                      stdout=log, stderr=subprocess.STDOUT,
                                      env=env, cwd=REPO))
    deadline = time.monotonic() + timeout
    timed_out = False
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    tails = []
    for rank, log in enumerate(logs):
        log.seek(0)
        tails.append(f"--- rank {rank} (rc {procs[rank].returncode}) ---\n"
                     + log.read()[-3000:])
        log.close()
    if timed_out or any(p.returncode != 0 for p in procs):
        raise RuntimeError(("world timed out\n" if timed_out else
                            "a rank failed\n") + "\n".join(tails))
    return [torch.load(os.path.join(tmpdir, f"out_{rank}.pt"),
                       weights_only=False) for rank in range(world)]


def _child(target: str, rank: int, world: int, tmpdir: str,
           multihost: bool = False) -> None:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if multihost:
        from torchaudio_contrib_tpu_torch.parallel import \
            initialize_multihost
        initialize_multihost(device="cpu", timeout=timedelta(seconds=60))
    else:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmpdir, "store"),
            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    mod, fn = target.split(":")
    results = getattr(importlib.import_module(mod), fn)(rank, world, tmpdir)
    results["_jax_modules"] = sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.")
        or m == "torchaudio_contrib_tpu"
        or m.startswith("torchaudio_contrib_tpu."))
    torch.save(results, os.path.join(tmpdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def check(results: dict, name: str, fn, *args, **kwargs) -> None:
    """``results[name] = ("ok", fn(...))``, or the traceback."""
    try:
        results[name] = ("ok", fn(*args, **kwargs))
    except Exception:  # noqa: BLE001 — the case reads and raises it
        results[name] = ("error", traceback.format_exc())


def value(results: dict, name: str):
    """The value a check stored; fails the calling test with the rank's
    traceback if the check raised."""
    status, val = results[name]
    if status != "ok":
        raise AssertionError(f"{name} failed on a rank:\n{val}")
    return val
