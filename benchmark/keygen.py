#!/usr/bin/env python3
"""Make and archive one configuration's keys in a process of its own.

    python3 benchmark/keygen.py '<configuration as JSON>' <archive path>

The first run of a cell in a checkout starts this (harness.Run.setup) and
waits for it, so that its own process, whose window is measured, never
holds the setup's host state.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    config = json.loads(sys.argv[1])
    harness.prepare_environment(config)
    harness.make_keys(config, "cuda", sys.argv[2])
