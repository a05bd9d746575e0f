"""The readings that the MaxxViT cell's limits of ``correct`` are set from.

    python3 benchmark/readings_maxxvit.py --seeds 1,2,3 --seconds 8 [--control 1] [--fault NAME]

``readings_maxvit.py`` on ``maxxvit-archive``, with the faults of
``faults_maxxvit.py``: one JSON line a seed.  Not part of a benchmark run.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import readings_maxvit  # noqa: E402
from benchmark.faults_maxxvit import FAULTS  # noqa: E402

if __name__ == "__main__":
    readings_maxvit.WORKLOAD = "maxxvit-archive"
    readings_maxvit.FAULTS = FAULTS
    readings_maxvit.main()
