"""Run one cell of ``BENCHMARK.json`` once and print the result as the last
line of standard output:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Needs CUDA and as many devices as the cell
asks for; exits with a code other than 0, printing no result, without them,
without the program, or where a module of JAX or of the JAX package is
loaded once the window has closed.
"""

import time

T0_WALL = time.time()  # set-up counts from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache at a fixed path inside the checkout, so that
# only a checkout's first run builds. The program's own kernels build into
# build/kernels and build/native there.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from portbench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0_WALL))
