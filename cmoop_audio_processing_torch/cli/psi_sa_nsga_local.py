"""Entry-point alias for the reference script psi_sa_nsga_local.py — runs the
'psi_sa_nsga_local' preset (see core/config.py for the preset's provenance)."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main(preset="psi_sa_nsga_local"))
