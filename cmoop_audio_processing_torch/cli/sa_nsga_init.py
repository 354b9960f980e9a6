"""Entry-point alias for the reference script sa_nsga_init.py — runs the
'sa_nsga_init' preset (see core/config.py for the preset's provenance)."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main(preset="sa_nsga_init"))
