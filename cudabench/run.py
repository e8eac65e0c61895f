"""Run one cell of the benchmark of ``torchaudio_contrib_tpu_torch`` on the
CUDA card of this machine and print its result as the last line:

    python3 cudabench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The kernels' build, Triton's cache and the
CUDA JIT cache go to fixed directories under ``cudabench/.cache/``, so
only the first run in a checkout builds.  Exits non-zero, printing no
result, without enough CUDA devices for the cell.
"""
import os
import sys
import time


def _process_start() -> float:
    """``time.perf_counter()`` at this process's start, from
    ``/proc/self/stat`` (clock ticks) and ``/proc/uptime``."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return now - age if 0.0 <= age < 60.0 else now
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")
os.environ["TAC_TORCH_BUILD_DIR"] = os.path.join(CACHE, "kernels")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, os.path.dirname(HERE))

from cudabench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
