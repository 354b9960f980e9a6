"""Entry-point alias for the reference script acc_fpr_nsga_1.py — runs the
'acc_fpr_nsga_1' preset (see core/config.py for the preset's provenance)."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main(preset="acc_fpr_nsga_1"))
