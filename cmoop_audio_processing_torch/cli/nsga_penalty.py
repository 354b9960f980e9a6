"""Entry-point alias for the reference script nsga_penalty.py — runs the
'nsga_penalty' preset (see core/config.py for the preset's provenance)."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main(preset="nsga_penalty"))
