"""Thin wrapper around the port's CLI (raytrace_tpu_torch/cli.py), the twin
of render_pbrt.py:

    python examples/render_pbrt_torch.py examples/cornell.pbrt -o /tmp/out.png

Renders on the CUDA device; add --cpu to render on the CPU.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace_tpu_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    main()
