"""Run one cell of the H100 benchmark of chap_tpu_torch once, from the root
of a checkout:

    python3 h100_bench/run.py --workload acdc_chap.train --seed 7 \
        --seconds 30 --trace 0

It makes its inputs and weights on the card from ``--seed``, warms up,
measures for ``--seconds``, checks what the timed path produced against
the plain reference under ``h100_bench/reference/``, and prints one JSON
line last on standard output (BENCHMARK.json says which metrics). It needs
one CUDA device and exits with 2 without one.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel and compile caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "h100_bench", sub)
sys.path.insert(0, ROOT)

from h100_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
