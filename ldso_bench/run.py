"""The benchmark of ldso_tpu_torch: one cell, one run. See README.md."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".build", "torch_extensions")
sys.path.insert(0, ROOT)


if __name__ == "__main__":
    from ldso_bench.harness.main import run

    sys.exit(run(sys.argv[1:], T_START))
