"""The program's package (``src/``) on the path of the benchmark's tests,
as ``portbench/run.py`` puts it for a run; one torch thread, since these
shapes are tiny."""
import sys
from pathlib import Path

import torch

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
torch.set_num_threads(1)
