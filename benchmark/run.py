"""Run one benchmark cell on the card this process is started on (see
benchmark/harness/runner.py):

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result as one JSON object.
"""
import os
import sys
from pathlib import Path

# the port's own libraries stay off JAX: transformers' optional Flax
# backend is the one that would load it
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    from benchmark.harness.runner import main

    sys.exit(main())
