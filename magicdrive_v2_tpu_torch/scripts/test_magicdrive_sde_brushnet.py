"""The W-CODA app with the SDE-BrushNet inpainting model: ``scripts.test_magicdrive``
with ``--sde`` added.

Usage (from the repository root):
  python3 -m magicdrive_v2_tpu_torch.scripts.test_magicdrive_sde_brushnet CONFIG [options]
"""
import sys
from typing import List, Optional

from .test_magicdrive import main as test_main


def main(argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return test_main(argv if "--sde" in argv else argv + ["--sde"])


if __name__ == "__main__":
    main()
