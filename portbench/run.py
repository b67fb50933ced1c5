"""Run one cell of the benchmark of gfe_mamba_torch on this machine's GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON object as the last line of standard output; everything
else goes to standard error.  Exits non-zero, with no result, when
there is no CUDA device (it never falls back to the CPU) or when JAX or
the JAX package is loaded once the window has closed.  Caches of
compiled kernels stay inside the checkout, at fixed paths:
``gfe_mamba_torch/_build`` (the program's own) and ``portbench/.cache``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PACKAGE = Path(__file__).resolve().parent
CACHE = PACKAGE / ".cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# one process with few threads: the host's thread pools do no work here
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(PACKAGE.parent))

from portbench.core.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
