"""Entry-point alias for the reference script psi_mobo_2.py — runs the
'psi_mobo_2' preset (see core/config.py for the preset's provenance)."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main(preset="psi_mobo_2"))
