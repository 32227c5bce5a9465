"""The benchmark's own tests run on the CPU:

    python -m pytest benchmark/tests -q

They check the harness (manifest, traffic, reducers, arithmetic, the
comparison that decides `correct`) at small sizes; the numbers that need
the card come only from `benchmark/run.py` on the card."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
