"""Entry-point alias for the reference script psi_init_sa_nsga.py — runs the
'psi_init_sa_nsga' preset (see core/config.py for the preset's provenance)."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main(preset="psi_init_sa_nsga"))
