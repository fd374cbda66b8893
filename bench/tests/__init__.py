"""CPU tests of the benchmark (``python -m pytest bench/tests``); the
``gpu``-marked ones need the card. The port's sources are put on the
path here, before any test module imports them."""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
for _p in (str(_ROOT / "src"), str(_ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
